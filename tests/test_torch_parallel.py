"""The port's data-parallel layer on the CPU, byte for byte (tolerance 0).

Mirrors the JAX package's own tests of its parallel layer:
* sharded_seed_extend over a mesh of CPU devices equals the JAX
  seed_extend_step (tests/test_mesh.py:45);
* several TorchBackend(device="cpu") aligners through run_pipeline: SE
  equals golden_se.sam (tests/test_multihost.py:65), PE (the fixture's
  first 200 pairs at -K 20000: three chunks) equals one aligner
  (tests/test_mesh.py:64);
* run_sharded + merge_chunks, SE and PE over 2 and 3 shards, equal the
  unsharded run (tests/test_multihost.py:45);
* two local processes through init_distributed on gloo: an all_gather,
  then --shard semantics and a merge equal to the unsharded run
  (tests/test_distributed.py:57);
* the CLI's --shard / --out-dir / merge, its data-parallel branch over
  several devices and its refusals, on --device cpu;
* --resume: an SE run killed after a chunk and restarted is
  byte-identical to an uninterrupted one (tests/test_resume.py:50).
sharded_seed_extend drives each device from a thread of its own.
And the multi-device audit: every kernel wrapper asks its shape of the
backend's card, not of the calling thread's current device; each backend
counts the launches of its own chunks whichever thread runs them; and
every launcher's ctypes signature types its stream argument.
"""

import glob
import io
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bwamem2_tpu.index.fmindex import FMIndex as JaxFMIndex
from bwamem2_tpu.ops.device_index import DeviceFMIndex as JaxDFM
from bwamem2_tpu.ops.entry import seed_extend_step as jax_step
from bwamem2_tpu_torch import cli, ops
from bwamem2_tpu_torch.align.pipeline import Aligner
from bwamem2_tpu_torch.index.fmindex import FMIndex
from bwamem2_tpu_torch.io.fastq import FastxReader, read_chunk
from bwamem2_tpu_torch.ops import cuda_build
from bwamem2_tpu_torch.ops.backend import TorchBackend
from bwamem2_tpu_torch.ops.bsw_cuda import bsw_extend
from bwamem2_tpu_torch.ops.bsw_shear_cuda import bsw_shear
from bwamem2_tpu_torch.ops.device_index import DeviceFMIndex
from bwamem2_tpu_torch.ops.kswv_cuda import kswv, kswv_phase
from bwamem2_tpu_torch.ops.row_gather import row_gather
from bwamem2_tpu_torch.ops.seed import sa_resolve, smem_collect
from bwamem2_tpu_torch.ops.smem import (round1_chain, round1_compact,
                                        round1_walk, round2_backward,
                                        round2_forward, round3_replay)
from bwamem2_tpu_torch.options import MEM_F_PE, MemOptions
from bwamem2_tpu_torch.parallel.mesh import (make_mesh, merge_shards,
                                             shard_batch,
                                             sharded_seed_extend)
from bwamem2_tpu_torch.parallel.multihost import merge_chunks, run_sharded
from bwamem2_tpu_torch.runtime import run_pipeline

from conftest import DATA, FIXTURES, REPO

# one intra-op thread: the suite runs several xdist workers side by side
torch.set_num_threads(1)

PREFIX = os.path.join(FIXTURES, "ref_small.fa")
TINY = os.path.join(FIXTURES, "ref_tiny.fa")
SE = os.path.join(DATA, "reads_se.fq")
R1, R2 = os.path.join(DATA, "reads_r1.fq"), os.path.join(DATA, "reads_r2.fq")
PE_PAIRS = 200          # the PE cases' pairs: the fixture's first 200
PE_TASK = 20000         # bases per PE chunk: three chunks of 200 2x150 pairs
SE_TASK = 8000          # bases per SE chunk: four chunks of 300 reads


@pytest.fixture(scope="module")
def fm():
    return FMIndex.load(PREFIX)


def golden_body(name):
    with open(os.path.join(FIXTURES, name)) as f:
        return "".join(ln for ln in f if not ln.startswith("@"))


def body(path):
    with open(path) as f:
        return "".join(ln for ln in f if not ln.startswith("@"))


@pytest.fixture(scope="module")
def pe_files(tmp_path_factory):
    """The first PE_PAIRS pairs of the PE fixture, as two FASTQ files."""
    d = tmp_path_factory.mktemp("pe")
    out = []
    for src in (R1, R2):
        dst = str(d / os.path.basename(src))
        with open(src) as f, open(dst, "w") as g:
            g.writelines(ln for _, ln in zip(range(4 * PE_PAIRS), f))
        out.append(dst)
    return out


@pytest.fixture(scope="module")
def readers(pe_files):
    """readers(paired) -> (ks1, ks2) over the SE or the PE subset."""
    def make(paired):
        return (FastxReader(pe_files[0]), FastxReader(pe_files[1])) \
            if paired else (FastxReader(SE), None)
    return make


def options(paired):
    opt = MemOptions().finalize()
    if paired:
        opt.flag |= MEM_F_PE
    return opt


# ------------------------------------------------------------ devices
def test_resolve_devices(monkeypatch):
    assert ops.resolve_devices("cpu") == [torch.device("cpu")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        ops.resolve_devices("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 10)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert ops.resolve_devices() == [torch.device("cuda", i)
                                     for i in range(ops.MAX_CARDS)]
    assert ops.resolve_devices("cuda:3") == [torch.device("cuda", 3)]


# ------------------------------------------------------ sharded step
@pytest.fixture(scope="module")
def tiny_batch():
    fm = FMIndex.load(TINY)
    rng = np.random.default_rng(0)
    n, L = 16, 128
    enc = np.full((n, L), 4, np.int32)
    lens = np.full((n,), L, np.int32)
    for i in range(n):
        p = int(rng.integers(0, fm.l_pac - L))
        enc[i] = fm.ref_string[p:p + L]
        mut = rng.integers(0, L, 3)
        enc[i, mut] = (enc[i, mut] + 1) % 4
    want = [np.asarray(o) for o in jax_step(
        JaxDFM.from_host(JaxFMIndex.load(TINY)), jnp.asarray(enc),
        jnp.asarray(lens))]
    return DeviceFMIndex.from_host(fm, "cpu"), enc, lens, want


@pytest.mark.parametrize("n_dev", [2, 3])
def test_sharded_seed_extend_matches_jax(tiny_batch, n_dev):
    dfm, enc, lens, want = tiny_batch
    mesh = make_mesh(devices=["cpu"] * n_dev)
    assert mesh == [torch.device("cpu")] * n_dev
    encs, lenss, n = shard_batch(mesh, enc, lens)
    pad = torch.cat(lenss)[n:]
    assert n == 16 and len(encs) == n_dev and pad.numel() == (-n) % n_dev
    assert int(pad.sum()) == 0 and bool((torch.cat(encs)[n:] == 4).all())
    out = sharded_seed_extend(mesh, dfm, enc, lens)
    assert len(out) == len(want) == 5
    for g, w in zip(out, want):
        np.testing.assert_array_equal(g, w)
    assert merge_shards({2: "c\n", 0: "a\n", 1: "b\n"}) == "a\nb\nc\n"


def test_sharded_seed_extend_runs_devices_side_by_side(tiny_batch,
                                                       monkeypatch):
    """Each device's slice runs from a thread of its own: no step waits
    for another device's step to finish (the barrier needs all three
    steps in flight at once)."""
    from bwamem2_tpu_torch.ops import entry
    dfm, enc, lens, want = tiny_batch
    barrier = threading.Barrier(3, timeout=60)
    orig = entry.seed_extend_step

    def step(*args, **kw):
        barrier.wait()
        return orig(*args, **kw)

    monkeypatch.setattr(entry, "seed_extend_step", step)
    out = sharded_seed_extend(make_mesh(devices=["cpu"] * 3), dfm, enc, lens)
    for g, w in zip(out, want):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------- aligners per device
@pytest.mark.parametrize("n_al", [2, 3])
def test_round_robin_se_matches_golden(fm, n_al, monkeypatch):
    """SE through n CPU TorchBackend aligners, chunks dealt least-loaded
    first: golden_se.sam, every backend seeding a chunk."""
    seen = []
    orig = TorchBackend.collect_chunk

    def spy(self, encs, opt):
        seen.append(self)
        return orig(self, encs, opt)

    monkeypatch.setattr(TorchBackend, "collect_chunk", spy)
    opt = options(False)
    aligners = [Aligner(fm, opt, backend=TorchBackend(fm, opt, "cpu"),
                        verbose=0) for _ in range(n_al)]
    out = io.StringIO()
    n = run_pipeline(aligners, FastxReader(SE), None, SE_TASK, out, verbose=0,
                     n_workers=n_al)
    assert n == 300
    assert out.getvalue() == golden_body("golden_se.sam")
    assert {id(a.backend) for a in aligners} == {id(b) for b in seen}


@pytest.fixture(scope="module")
def unsharded(fm, readers):
    """The single run of the host aligner by `paired`, made at first use."""
    runs = {}

    def run(paired):
        if paired not in runs:
            buf = io.StringIO()
            run_pipeline(Aligner(fm, options(paired), verbose=0),
                         *readers(paired), PE_TASK if paired else SE_TASK,
                         buf, verbose=0)
            runs[paired] = buf.getvalue()
        return runs[paired]
    return run


@pytest.mark.parametrize("n_al", [2, 3])
def test_round_robin_pe_matches_one_aligner(fm, readers, unsharded, n_al):
    """PE through n CPU TorchBackend aligners equals one aligner's run at
    the same task size (the shard tests' unsharded run)."""
    opt = options(True)
    aligners = [Aligner(fm, opt, backend=TorchBackend(fm, opt, "cpu"),
                        verbose=0) for _ in range(n_al)]
    out = io.StringIO()
    run_pipeline(aligners, *readers(True), PE_TASK, out, verbose=0,
                 n_workers=n_al)
    assert out.getvalue() == unsharded(True)
    assert out.getvalue().count("\n") == 2 * PE_PAIRS


# ----------------------------------------------------------- shards
@pytest.mark.parametrize("paired", [False, True], ids=["se", "pe"])
@pytest.mark.parametrize("n_shards", [2, 3])
def test_sharded_merge_identical(fm, readers, unsharded, paired, n_shards,
                                 tmp_path):
    out_dir = str(tmp_path / "shards")
    mine = [run_sharded(Aligner(fm, options(paired), verbose=0),
                        *readers(paired), PE_TASK if paired else SE_TASK,
                        out_dir, h, n_shards,
                        verbose=0)
            for h in range(n_shards)]
    assert sum(mine) == (2 * PE_PAIRS if paired else 300)
    want = unsharded(paired)
    out = io.StringIO()
    n = merge_chunks(out, glob.glob(os.path.join(out_dir,
                                                 "part.chunk*.sam")))
    assert n == want.count("\n")
    assert out.getvalue() == want


WORKER = """
import sys
sys.path.insert(0, {repo!r})
import torch
import torch.distributed as dist
from bwamem2_tpu_torch.parallel.multihost import init_distributed
rank, world = init_distributed("cpu")
assert world == 2 and dist.get_backend() == "gloo", (world,)
got = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
dist.all_gather(got, torch.tensor([rank + 1]))
assert [int(g) for g in got] == [1, 2], got
from bwamem2_tpu_torch.align.pipeline import Aligner
from bwamem2_tpu_torch.index.fmindex import FMIndex
from bwamem2_tpu_torch.io.fastq import FastxReader
from bwamem2_tpu_torch.options import MemOptions
from bwamem2_tpu_torch.parallel.multihost import run_sharded
al = Aligner(FMIndex.load({prefix!r}), MemOptions().finalize(), verbose=0)
n = run_sharded(al, FastxReader({fq!r}), None, 16000, {outdir!r}, rank,
                world, verbose=0)
dist.barrier()
dist.destroy_process_group()
print("rank", rank, "reads", n)
"""


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def test_two_process_gloo_shard(fm, tmp_path):
    outdir = str(tmp_path / "shards")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
               WORLD_SIZE="2", OMP_NUM_THREADS="1")
    script = WORKER.format(repo=REPO, prefix=PREFIX, fq=SE, outdir=outdir)
    procs = [subprocess.Popen([sys.executable, "-c", script],
                              env={**env, "RANK": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-2000:]
    paths = glob.glob(os.path.join(outdir, "part.chunk*.sam"))
    assert len(paths) >= 2
    merged = io.StringIO()
    merge_chunks(merged, paths)
    al = Aligner(fm, options(False), verbose=0)
    want, base, ks = [], 0, FastxReader(SE)
    while reads := read_chunk(ks, None, 16000):
        for r in reads:
            r.comment = None
        al.process(reads, base)
        want.extend(r.sam for r in reads)
        base += len(reads)
    assert merged.getvalue() == "".join(want)


def test_init_distributed_without_env_is_one_process(monkeypatch):
    from bwamem2_tpu_torch.parallel.multihost import ENV_VARS, \
        init_distributed
    for v in ENV_VARS:
        monkeypatch.delenv(v, raising=False)
    assert init_distributed("cpu") == (0, 1)


def test_init_distributed_defaults_to_the_card(monkeypatch):
    """Called with no device, init_distributed runs on a card: without
    one it raises, and it never brings up gloo on the host instead."""
    import torch.distributed as dist
    from bwamem2_tpu_torch.parallel.multihost import init_distributed
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(free_port()))
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(RuntimeError, match="is_available"):
        init_distributed()
    assert not dist.is_initialized()


# -------------------------------------------------------------- CLI
def test_cli_shard_out_dir_merge(tmp_path):
    d = str(tmp_path / "parts")
    for h in range(3):
        rc = cli.main(["mem", "--device", "cpu", "-K", "8000", "-v", "1",
                       "--shard", f"{h}:3", "--out-dir", d, "-o",
                       str(tmp_path / f"hdr{h}.sam"), PREFIX, SE])
        assert rc == 0
    parts = sorted(glob.glob(os.path.join(d, "part.chunk*.sam")))
    assert len(parts) >= 3
    merged = str(tmp_path / "merged.sam")
    assert cli.main(["merge", merged, *reversed(parts)]) == 0
    assert body(merged) == golden_body("golden_se.sam")
    assert cli.main(["merge", merged]) == 1            # usage
    assert cli.main(["mem", "--device", "cpu", "--shard", "2:2", PREFIX,
                     SE]) == 1                         # h outside [0, N)


def test_cli_data_parallel_over_devices(tmp_path, monkeypatch, capfd):
    """With more than one device the CLI builds one TorchBackend per
    device; here two CPU devices stand in for two cards.  With
    BWAMEM2_TPU_SHARD_INDEX it builds one backend over both, sharded
    (tests/test_torch_shard_index.py runs that mode to the goldens);
    --resume with --shard is refused."""
    made = []
    orig = TorchBackend.__init__

    def spy(self, fm, opt, device=None, **kw):
        made.append(kw or device)
        orig(self, fm, opt, device, **kw)

    monkeypatch.setattr(TorchBackend, "__init__", spy)
    monkeypatch.setattr(ops, "resolve_devices",
                        lambda dev: [torch.device("cpu")] * 2)
    out = str(tmp_path / "dp.sam")
    assert cli.main(["mem", "--device", "cpu", "-K", "8000", "-t", "1",
                     "-o", out, PREFIX, SE]) == 0
    assert made == [torch.device("cpu")] * 2
    assert "* data-parallel over 2 cards" in capfd.readouterr().err
    assert body(out) == golden_body("golden_se.sam")
    monkeypatch.setenv("BWAMEM2_TPU_SHARD_INDEX", "1")
    made.clear()
    assert cli.main(["mem", "--device", "cpu", "-K", "8000", "-o", out,
                     PREFIX, SE]) == 0
    assert made == [dict(devices=[torch.device("cpu")] * 2, sharded=True)]
    assert "index sharded over 2 cards" in capfd.readouterr().err
    assert body(out) == golden_body("golden_se.sam")
    assert cli.main(["mem", "--device", "cpu", "--resume", "--shard", "0:2",
                     "-o", out, PREFIX, SE]) == 1
    assert "no --shard" in capfd.readouterr().err


RESUME_TASK = "16000"   # bases per chunk: two chunks of the SE fixture


def _mem_args(out, resume):
    return ["mem", "--device", "cpu", "-K", RESUME_TASK, "-o", out] \
        + (["--resume"] if resume else []) + [PREFIX, SE]


def _mem_killed(out, kill_after_chunks, timeout=300):
    """`mem --resume` into `out` in a subprocess, SIGKILLed once its
    journal holds kill_after_chunks chunks (False if it finished first)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    p = subprocess.Popen([sys.executable, "-m", "bwamem2_tpu_torch.cli",
                          *_mem_args(out, True)], stdout=subprocess.DEVNULL,
                         stderr=subprocess.DEVNULL, cwd=REPO, env=env)
    t0 = time.time()
    try:
        while time.time() - t0 < timeout:
            if p.poll() is not None:
                return False
            try:
                with open(out + ".resume") as f:
                    if sum(1 for _ in f) >= kill_after_chunks:
                        break
            except OSError:
                pass
            time.sleep(0.02)
    finally:
        p.send_signal(signal.SIGKILL)
        p.wait()
    return True


def test_resume_kill_restart_byte_identical(tmp_path):
    full, res = str(tmp_path / "full.sam"), str(tmp_path / "resumed.sam")
    assert cli.main(_mem_args(full, False)) == 0
    if _mem_killed(res, kill_after_chunks=1):
        with open(res, "a") as f:     # a torn partial chunk
            f.write("GARBAGE\tPARTIAL\tCHUNK\n")
    assert cli.main(_mem_args(res, True)) == 0
    strip = lambda p: [ln for ln in open(p)  # noqa: E731
                       if not ln.startswith("@PG")]
    assert strip(res) == strip(full)
    assert "".join(ln for ln in strip(full) if not ln.startswith("@")) \
        == golden_body("golden_se.sam")
    before = open(res).read()
    assert cli.main(_mem_args(res, True)) == 0    # a no-op when complete
    assert open(res).read() == before


# ------------------------------------------------ multi-device audit
class _CurrentDevice:
    """Stand-in for torch.cuda.device: the CUDA runtime's current device
    is per thread, so is this one's."""
    tls = threading.local()

    def __init__(self, dev):
        self.idx = torch.device(dev).index

    def __enter__(self):
        self.prev = getattr(self.tls, "idx", 0)
        self.tls.idx = self.idx

    def __exit__(self, *exc):
        self.tls.idx = self.prev


class _FakeLib:
    """A kernel library whose every C function records the calling
    thread's current device and returns 0 (no error)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def fn(*args):
            self.calls.append((name, getattr(_CurrentDevice.tls, "idx", 0)))
            return 0
        return fn


@pytest.mark.parametrize("kernel,args", [
    (bsw_extend, (4096, 255)), (bsw_shear, (256, 100)),
    (kswv, (1024, 160, True)), (smem_collect, (32, 160)),
    (sa_resolve, (1, 256, 10**6)),
], ids=["bsw_extend", "bsw_shear", "kswv", "smem_collect", "sa_resolve"])
def test_plan_asks_the_given_card(kernel, args, monkeypatch):
    """A worker thread's current device is card 0 whichever backend it
    drives: each wrapper's shape query must run on the card it names."""
    lib = _FakeLib()
    monkeypatch.setattr(kernel, "_lib", lib)
    monkeypatch.setattr(torch.cuda, "device", _CurrentDevice)
    if kernel is sa_resolve:
        monkeypatch.setattr(kernel, "_resident", {})
    kernel.plan(*args, torch.device("cuda", 1))
    assert lib.calls and all(dev == 1 for _, dev in lib.calls)


def test_launches_counted_per_backend_across_threads(monkeypatch):
    """Each thread's launches go to the card it names and to the tally its
    backend set, with several threads launching at once."""
    lib = _FakeLib()
    monkeypatch.setattr(row_gather, "_lib", lib)
    monkeypatch.setattr(torch.cuda, "device", _CurrentDevice)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 0}))
    tallies = [{}, {}, {}]
    n0 = row_gather.launches
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            cuda_build.launch_tally(tallies[i])
            for _ in range(200):
                row_gather._launch(torch.device("cuda", i), 0, 0, 0, 0, 0)
            cuda_build.launch_tally(None)

        ts = [threading.Thread(target=work, args=(i,)) for i in range(3)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(interval)
    assert tallies == [{"row_gather": 200}] * 3
    assert row_gather.launches == n0 + 600
    by_dev = {}
    for _, dev in lib.calls:
        by_dev[dev] = by_dev.get(dev, 0) + 1
    assert by_dev == {0: 200, 1: 200, 2: 200}


def test_backend_chunk_sets_its_tally(fm):
    be = TorchBackend(fm, options(False), "cpu")
    try:
        be.collect_chunk([np.zeros(30, np.uint8)], be.opt)
        assert cuda_build._tally.counts is be.launches
    finally:
        cuda_build.launch_tally(None)


@pytest.mark.parametrize("kernel", [bsw_extend, bsw_shear, kswv, kswv_phase,
                                    row_gather, smem_collect, sa_resolve,
                                    round1_walk, round1_compact,
                                    round1_chain, round2_forward,
                                    round2_backward, round3_replay],
                         ids=lambda k: k.NAME)
def test_launcher_signature_types_every_parameter(kernel):
    """Each wrapper's ctypes argtypes cover every parameter of each of its
    C launchers (SIGNATURE and ENTRIES), the stream included: ctypes
    passes an untyped Python int as a C int, so a stream handle on the
    stack would arrive with its high half undefined (and a handle past
    2^31 would not convert)."""
    import re
    with open(os.path.join(cuda_build.CSRC, kernel.SOURCES[0])) as f:
        src = f.read()
    entries = {kernel.SIGNATURE[0]: kernel.SIGNATURE[1], **kernel.ENTRIES}
    for name, argtypes in entries.items():
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
        params = [p for p in m.group(1).split(",") if p.strip()]
        assert params[-1].split()[-1] == "*stream"
        assert len(argtypes) == len(params), name
        for p, a in zip(params, argtypes):
            # pointers as pointers, int64_t as int64, int as int
            want = (cuda_build.VP if "*" in p else cuda_build.I64
                    if "int64_t" in p else cuda_build.I32)
            assert a is want, (name, p)
