"""The port end to end on the CPU: golden SAM byte for byte.

TorchBackend(device="cpu") seeds through the fused collect_chunk route
(smem_collect_ref and sa_resolve_ref, the seeding kernels' plain versions),
scores every extension rung group with bsw_desc_ref (the extension
kernel's plain version) through the flat all-native extension path, and
scores each PE chunk's mate-rescue batch through TorchBackend.rescue_batch
with kswv_two_phase_ref (the rescue kernel's plain version).  Outputs must
equal the committed goldens, also under the PE flags that change rescue
(-S, -P, -I) and in -p mode.
"""

import os

import numpy as np
import pytest
import torch

from bwamem2_tpu_torch import cli
from bwamem2_tpu_torch.align.pipeline import Aligner
from bwamem2_tpu_torch.index.fmindex import FMIndex
from bwamem2_tpu_torch.io.fastq import FastxReader, Read, read_chunk
from bwamem2_tpu_torch.ops.backend import TorchBackend
from bwamem2_tpu_torch.ops.bsw import DeviceBSW
from bwamem2_tpu_torch.ops.bsw_cuda import bsw_extend
from bwamem2_tpu_torch.ops.bsw_shear_cuda import bsw_shear
from bwamem2_tpu_torch.ops.kswv_cuda import kswv
from bwamem2_tpu_torch.ops.seed import sa_resolve, smem_collect
from bwamem2_tpu_torch.options import MEM_F_PE, MemOptions
from bwamem2_tpu_torch.utils.profiling import PROF

from conftest import DATA, FIXTURES

# one intra-op thread: the suite runs several xdist workers side by side,
# each with XLA's thread pools, and torch's OpenMP regions oversubscribed
# that way run 100x slower than on one thread
torch.set_num_threads(1)

PREFIX = os.path.join(FIXTURES, "ref_small.fa")


def golden_lines(name):
    with open(os.path.join(FIXTURES, name)) as f:
        return [ln for ln in f if not ln.startswith("@")]


@pytest.fixture(scope="module")
def fm():
    return FMIndex.load(PREFIX)


@pytest.fixture
def rescued(monkeypatch):
    """The query lengths of every TorchBackend.rescue_batch call's problems;
    on teardown, checks that no rescue SW missed its batch and ran on the
    host."""
    seen = []
    orig = TorchBackend.rescue_batch

    def spy(self, desc):
        out = orig(self, desc)
        assert out is not None      # a grid is attached: no host fallback
        seen.append(desc["qlen"])
        return out

    monkeypatch.setattr(TorchBackend, "rescue_batch", spy)
    miss0 = PROF.c["overflow.rescue_miss"]
    yield seen
    assert PROF.c["overflow.rescue_miss"] == miss0


@pytest.mark.parametrize("pe", [False, True], ids=["se", "pe"])
def test_golden_on_cpu_through_plain_kernel(fm, pe, rescued):
    opt = MemOptions().finalize()
    if pe:
        opt.flag |= MEM_F_PE
        reads = read_chunk(FastxReader(os.path.join(DATA, "reads_r1.fq")),
                           FastxReader(os.path.join(DATA, "reads_r2.fq")),
                           10**9)
    else:
        reads = read_chunk(FastxReader(os.path.join(DATA, "reads_se.fq")),
                           None, 10**9)
    backend = TorchBackend(fm, opt, device="cpu")
    n_plain, n_launch = bsw_extend.plain_calls, bsw_extend.launches
    n_kswv = (kswv.plain_calls, kswv.launches)
    seeding = (smem_collect, sa_resolve)
    n_seed = [(k.plain_calls, k.launches) for k in seeding]
    al = Aligner(fm, opt, backend=backend, verbose=0)
    al.process(reads, 0)
    # seeding took the fused collect_chunk route, on the plain versions
    for k, (p0, l0) in zip(seeding, n_seed):
        assert (k.plain_calls, k.launches) == (p0 + 1, l0)
    # the flat all-native extension path ran (DeviceBSW.run_arrays is its
    # only caller of the wrapper), scoring on the plain kernel
    assert al._flat_ext_ok([r.seq for r in reads], opt)
    assert backend.read_grid_width() > 0
    assert bsw_extend.plain_calls > n_plain
    assert bsw_extend.launches == n_launch
    # PE: the chunk's rescue batch ran on the plain version of the kernel
    if pe:
        assert sum(map(len, rescued)) > 0
        assert kswv.plain_calls > n_kswv[0]
    else:
        assert not rescued and kswv.plain_calls == n_kswv[0]
    assert kswv.launches == n_kswv[1]
    ours = "".join(r.sam for r in reads).splitlines(keepends=True)
    golden = golden_lines("golden_pe.sam" if pe else "golden_se.sam")
    assert len(ours) == len(golden)
    assert ours == golden


@pytest.mark.parametrize("flags,fastq,golden", [
    ("-S", "reads_r1.fq reads_r2.fq", "golden_pe_S.sam"),
    ("-P", "reads_r1.fq reads_r2.fq", "golden_pe_P.sam"),
    ("-I400,50", "reads_r1.fq reads_r2.fq", "golden_pe_I400_50.sam"),
    ("-p", "reads_mixed.fq", "golden_mixed_p.sam"),
], ids=["S", "P", "I400_50", "mixed_p"])
def test_pe_flag_golden_on_cpu(fm, flags, fastq, golden, rescued):
    """The PE goldens whose flags change rescue, through TorchBackend on
    the CPU with the flags parsed by the port's CLI: -S skips rescue (no
    batch), the others rescue through rescue_batch."""
    fqs = [os.path.join(DATA, f) for f in fastq.split()]
    parsed = cli.parse_mem_args(flags.split() + [PREFIX, *fqs])
    opt, mode, pes0 = parsed[0], parsed[1], parsed[9]
    opt.finalize(mode)
    if len(fqs) == 2:
        opt.flag |= MEM_F_PE
    reads = read_chunk(FastxReader(fqs[0]),
                       FastxReader(fqs[1]) if len(fqs) == 2 else None,
                       10**9)
    n_kswv = kswv.plain_calls
    Aligner(fm, opt, backend=TorchBackend(fm, opt, device="cpu"),
            verbose=0).process(reads, 0, pes0=pes0)
    if flags == "-S":
        assert not rescued and kswv.plain_calls == n_kswv
    else:
        assert sum(map(len, rescued)) > 0 and kswv.plain_calls > n_kswv
    ours = "".join(r.sam for r in reads).splitlines(keepends=True)
    assert ours == golden_lines(golden)


def test_long_read_pe_rescue_on_device_route(fm, rescued):
    """600 bp pairs (the i16 class, queries longer than the JAX package's
    512-base device cap): every rescue problem goes through rescue_batch
    to the kernel's plain version, and the SAM equals the host-native
    run's."""
    rng = np.random.default_rng(77)
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    reads = []
    for i in range(32):     # >= 10 proper pairs, so pestat succeeds
        isize = int(rng.normal(1000, 40))
        p = int(rng.integers(0, fm.l_pac - isize))
        frag = "".join("ACGTN"[c] for c in fm.ref_string[p:p + isize])
        r1 = frag[:600]
        r2 = "".join(comp.get(c, "N") for c in frag[-600:])[::-1]
        if i % 4 == 0:      # knock one mate's seeds out so rescue fires
            r2 = "".join("ACGT"[c] for c in rng.integers(0, 4, 600))
        for seq in (r1, r2):
            reads.append(Read(name=f"L{i}", comment=None, seq=seq,
                              qual="I" * 600))
    opt = MemOptions().finalize()
    opt.flag |= MEM_F_PE
    out = {}
    n_kswv = kswv.plain_calls
    for backend in (TorchBackend(fm, opt, device="cpu"), None):
        rd = [Read(name=r.name, comment=None, seq=r.seq, qual=r.qual)
              for r in reads]
        Aligner(fm, opt, backend=backend, verbose=0).process(rd, 0)
        out[backend is None] = "".join(r.sam for r in rd)
    assert max(int(q.max()) for q in rescued) == 600
    assert kswv.plain_calls > n_kswv
    assert out[False] == out[True]


@pytest.mark.parametrize("a", [1, 32, 33, 52, 127])
def test_score_matrix_is_int8(a):
    """`mem -A a` scales -B to 4a; the score matrix holds every entry as
    bwa-mem2's int8_t does (from -A33 on, -4a wraps), so numpy's int8
    conversion takes it, and mat_scores gives the kernels what the native
    ones read: match a, mismatch penalty -int8(-4a)."""
    opt = MemOptions()
    opt.set("a", a)
    opt.finalize()
    mat = np.array(opt.mat, np.int8)
    assert mat.tolist() == opt.mat and opt.b == 4 * a
    assert opt.mat_scores() == (a, -((-4 * a + 128) % 256 - 128))
    assert (opt.mat_scores()[1] == 4 * a) == (a <= 32)


def test_a52_pe_matches_host_native(fm, rescued):
    """mem -A52 PE on the golden fixtures' reads: update_a scales -B to
    208, beyond bwa-mem2's int8 score matrix, which holds a mismatch of
    +48 (options.fill_scmat).  Through TorchBackend(device="cpu"), whose
    extension and rescue kernels take a and b from that matrix, the rescue
    batch runs on the plain kernel and the SAM equals the host-native
    run's, which reads the same matrix."""
    parsed = cli.parse_mem_args(["-A52", PREFIX,
                                 os.path.join(DATA, "reads_r1.fq"),
                                 os.path.join(DATA, "reads_r2.fq")])
    opt, pes0 = parsed[0].finalize(parsed[1]), parsed[9]
    opt.flag |= MEM_F_PE
    assert (opt.a, opt.b, opt.mat[:2]) == (52, 208, [52, 48])
    out = {}
    n_kswv = kswv.plain_calls
    for backend in (TorchBackend(fm, opt, device="cpu"), None):
        reads = read_chunk(FastxReader(os.path.join(DATA, "reads_r1.fq")),
                           FastxReader(os.path.join(DATA, "reads_r2.fq")),
                           10**9)
        Aligner(fm, opt, backend=backend, verbose=0).process(reads, 0,
                                                             pes0=pes0)
        out[backend is None] = "".join(r.sam for r in reads)
    assert sum(map(len, rescued)) > 0 and kswv.plain_calls > n_kswv
    assert out[False] == out[True]


@pytest.mark.parametrize("native_rt", [True, False],
                         ids=["native_rt", "python_rt"])
def test_long_mates_off_grid_rescue_on_host(fm, monkeypatch, native_rt):
    """Reads longer than the read grid takes (GRID_MAX_READ_LEN, lowered
    to 599 here, for 600 bp first mates beside 500 bp second mates): each
    is seeded alone on the host oracle (overflow.long_read) while the
    other reads go through the seeding kernel's plain version; a rescue
    whose query is a long mate stays out of the batch and runs on the host
    (overflow.rescue_miss), the others go through rescue_batch.  The chunk
    extends on the object path: the long mates' pairs, and only those, on
    the host kernel (overflow.bsw_host_tail), the 500 bp mates' long pairs
    through bsw_shear's plain version.  The SAM equals the host-native
    run's, through the native runtime (hostrt.rescue_pre_batch) and the
    Python one (pairing.batch_rescue_pre)."""
    rng = np.random.default_rng(79)
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    reads = []
    for i in range(32):     # >= 10 proper pairs, so pestat succeeds
        isize = int(rng.normal(1000, 40))
        p = int(rng.integers(0, fm.l_pac - isize))
        frag = "".join("ACGTN"[c] for c in fm.ref_string[p:p + isize])
        r1 = frag[:600]
        r2 = "".join(comp.get(c, "N") for c in frag[-500:])[::-1]
        if i % 4 == 0:      # knock one mate's seeds out so rescue fires
            r2 = "".join("ACGT"[c] for c in rng.integers(0, 4, 500))
        if i % 4 == 1:
            r1 = "".join("ACGT"[c] for c in rng.integers(0, 4, 600))
        for seq in (r1, r2):
            reads.append(Read(name=f"M{i}", comment=None, seq=seq,
                              qual="I" * len(seq)))
    opt = MemOptions().finalize()
    opt.flag |= MEM_F_PE
    monkeypatch.setattr(TorchBackend, "GRID_MAX_READ_LEN", 599)
    seen = []
    orig = TorchBackend.rescue_batch

    def spy(self, desc):
        seen.append(desc["qlen"])
        return orig(self, desc)

    monkeypatch.setattr(TorchBackend, "rescue_batch", spy)
    # the extension pairs of the long mates, the only ones the read grid
    # does not hold, are the only ones on the host kernel
    off_grid = []
    orig_run = DeviceBSW._run

    def run_spy(self, pending, w, opt, end_bonus):
        off_grid.append(sum(len(reads[p.seqid].seq) == 600
                            for p in pending))
        assert all((self.lens[p.seqid] == 0)
                   == (len(reads[p.seqid].seq) == 600) for p in pending)
        return orig_run(self, pending, w, opt, end_bonus)

    monkeypatch.setattr(DeviceBSW, "_run", run_spy)
    out = {}
    for backend in (TorchBackend(fm, opt, device="cpu"), None):
        rd = [Read(name=r.name, comment=None, seq=r.seq, qual=r.qual)
              for r in reads]
        for k in ("overflow.long_read", "overflow.rescue_miss",
                  "overflow.bsw_host_tail"):
            PROF.c.pop(k, None)
        n0 = smem_collect.plain_calls
        n_shear = bsw_shear.plain_calls
        Aligner(fm, opt, backend=backend, verbose=0,
                native_rt=native_rt or backend is None).process(rd, 0)
        out[backend is None] = "".join(r.sam for r in rd)
        if backend is not None:
            assert PROF.c["overflow.long_read"] == 32
            assert smem_collect.plain_calls == n0 + 1
            assert backend.read_grid_width() == 504
            assert PROF.c["overflow.rescue_miss"] > 0
            # the object path: 500 bp mates' long pairs on bsw_shear
            assert bsw_shear.plain_calls > n_shear
            assert PROF.c["overflow.bsw_host_tail"] == sum(off_grid) > 0
    assert sum(map(len, seen)) > 0
    assert max(int(q.max()) for q in seen) == 500
    assert out[False] == out[True]


PACBIO_PARTS = 5


@pytest.mark.parametrize("part", range(PACBIO_PARTS))
def test_pacbio_golden_on_cpu_through_shear_plain(fm, part):
    """golden_pacbio.sam (25 reads of 2-8 kb, -x pacbio) through
    TorchBackend(device="cpu"): the chunk takes the object path, whose
    long pairs go through bsw_shear's plain version and in-cap pairs
    through bsw_extend's, none to the host kernel.  Each case runs a fifth
    of the reads as one chunk at their place in the file (an SE record
    depends only on its read and the read's index), so the cases run side
    by side; together they hold every record of the golden."""
    opt = MemOptions().finalize("pacbio")
    reads = read_chunk(FastxReader(os.path.join(DATA, "reads_pacbio.fq")),
                       None, 10**9)
    assert len(reads) == 25
    lo = part * len(reads) // PACBIO_PARTS
    hi = (part + 1) * len(reads) // PACBIO_PARTS
    sub = reads[lo:hi]
    names = {r.name for r in sub}
    n = (bsw_shear.plain_calls, bsw_shear.launches, bsw_extend.plain_calls)
    PROF.c.pop("overflow.bsw_host_tail", None)
    pairs0 = PROF.ctot["overflow.bsw_host_tail"]
    al = Aligner(fm, opt, backend=TorchBackend(fm, opt, device="cpu"),
                 verbose=0)
    al.process(sub, lo)
    assert not al._flat_ext_ok([r.seq for r in sub], opt)
    assert bsw_shear.plain_calls > n[0] and bsw_shear.launches == n[1]
    assert bsw_extend.plain_calls > n[2]
    assert PROF.c["overflow.bsw_host_tail"] == 0
    assert PROF.ctot["overflow.bsw_host_tail"] > pairs0
    ours = "".join(r.sam for r in sub).splitlines(keepends=True)
    golden = [ln for ln in golden_lines("golden_pacbio.sam")
              if ln.split("\t", 1)[0] in names]
    assert len(ours) == len(golden) >= hi - lo
    assert ours == golden


def test_cli_mem_device_cpu_pe_golden(tmp_path):
    out = tmp_path / "pe.sam"
    rc = cli.main(["mem", "--device", "cpu", "-v", "0", "-o", str(out),
                   PREFIX, os.path.join(DATA, "reads_r1.fq"),
                   os.path.join(DATA, "reads_r2.fq")])
    assert rc == 0
    with open(out) as f:
        ours = [ln for ln in f if not ln.startswith("@PG")]
    with open(os.path.join(FIXTURES, "golden_pe.sam")) as f:
        golden = [ln for ln in f if not ln.startswith("@PG")]
    assert ours == golden


def test_cli_mem_default_device_needs_cuda(tmp_path):
    """Without a GPU the default --device cuda is an error, not a silent
    host run: nothing is written."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = tmp_path / "pe.sam"
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["mem", "-o", str(out), PREFIX,
                  os.path.join(DATA, "reads_r1.fq")])
    assert not out.exists()


def test_exit_parameter_echo(tmp_path, capsys):
    """The port's `mem` ends with the reference's "Important parameter
    settings" echo (tests/test_verbose_parity.py::test_exit_parameter_echo),
    with the port's own constants under the same keys."""
    rc = cli.main(["mem", "--device", "cpu", "-v", "1", "-o",
                   str(tmp_path / "se.sam"), PREFIX,
                   os.path.join(DATA, "reads_r1.fq")])
    assert rc == 0
    err = capsys.readouterr().err
    assert "Important parameter settings:" in err
    for key in ("MAX_SEQ_LEN_REF", "MAX_SEQ_LEN_QER", "LONG_QCAP",
                "VPU_LANES", "SEED_CAND_SLOTS", "SEEDS_PER_READ",
                "SA_COORDS_PER_READ"):
        assert key in err
    assert "SEED_CAND_SLOTS (on-chip list, by grid width): 160/320" in err
