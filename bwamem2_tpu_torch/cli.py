"""Command-line interface of the port: `python -m bwamem2_tpu_torch.cli
{index,mem,version}`.

Flag-for-flag compatible with bwa-mem2's getopt surface (fastmap.cpp:643-782,
bwtindex.cpp:43-59), plus `--device {cuda,cpu}` (default cuda), `--resume`,
and the JAX package's scale-out flags `--shard h:N` / `--out-dir D` with the
`merge` subcommand.  On "cuda", `mem` runs the device stages in the CUDA
kernels, with one backend per visible card (at most 8) and chunks dealt to
the least-loaded card; with `--shard h:N` it aligns only shard h's chunks,
on one card, into chunk files that `merge` concatenates in order.  On "cpu"
the kernels' plain PyTorch versions run.  Asking for cuda without a usable
GPU is an error, never a silent fall back to the host.
"""

from __future__ import annotations

import getopt
import os
import sys
import time

from . import __version__
from .options import (MEM_F_ALL, MEM_F_KEEP_SUPP_MAPQ, MEM_F_NOPAIRING,
                      MEM_F_NO_MULTI, MEM_F_NO_RESCUE, MEM_F_PE,
                      MEM_F_PRIMARY5, MEM_F_REF_HDR, MEM_F_SMARTPE,
                      MEM_F_SOFTCLIP, MemOptions)


def usage_mem(opt: MemOptions) -> str:
    return f"""Usage: python -m bwamem2_tpu_torch.cli mem [options] <idxbase> <in1.fq> [in2.fq]

Algorithm options:
  -t INT     number of host worker threads [{opt.n_threads}]
  -k INT     minimum seed length [{opt.min_seed_len}]
  -w INT     band width for banded alignment [{opt.w}]
  -d INT     off-diagonal X-dropoff [{opt.zdrop}]
  -r FLOAT   look for internal seeds inside a seed longer than {{-k}} * FLOAT [{opt.split_factor}]
  -y INT     seed occurrence for the 3rd round seeding [{opt.max_mem_intv}]
  -c INT     skip seeds with more than INT occurrences [{opt.max_occ}]
  -D FLOAT   drop chains shorter than FLOAT fraction of the longest overlapping chain [{opt.drop_ratio}]
  -W INT     discard a chain if seeded bases shorter than INT [{opt.min_chain_weight}]
  -m INT     perform at most INT rounds of mate rescues for each read [{opt.max_matesw}]
  -S         skip mate rescue
  -P         skip pairing; mate rescue performed unless -S also in use
Scoring options:
  -A INT     score for a sequence match [{opt.a}]
  -B INT     penalty for a mismatch [{opt.b}]
  -O INT[,INT]  gap open penalties for deletions and insertions [{opt.o_del},{opt.o_ins}]
  -E INT[,INT]  gap extension penalty [{opt.e_del},{opt.e_ins}]
  -L INT[,INT]  penalty for 5'- and 3'-end clipping [{opt.pen_clip5},{opt.pen_clip3}]
  -U INT     penalty for an unpaired read pair [{opt.pen_unpaired}]
  -x STR     read type. Changes multiple parameters: pacbio, ont2d, intractg
Input/output options:
  -p         smart pairing (ignoring in2.fq)
  -R STR     read group header line such as '@RG\\tID:foo\\tSM:bar'
  -H STR/FILE  insert STR to header if it starts with @; or insert lines in FILE
  -o FILE    sam file to output results to [stdout]
  -j         treat ALT contigs as part of the primary assembly
  -5         for split alignment, take the alignment with the smallest coordinate as primary
  -q         don't modify mapQ of supplementary alignments
  -K INT     process INT input bases in each batch regardless of nThreads (for reproducibility)
  -v INT     verbosity level
  -T INT     minimum score to output [{opt.T}]
  -h INT[,INT]  if there are <INT hits with score >80% of the max score, output all in XA [{opt.max_XA_hits},{opt.max_XA_hits_alt}]
  -a         output all alignments for SE or unpaired PE
  -C         append FASTA/FASTQ comment to SAM output
  -V         output the reference FASTA header in the XR tag
  -Y         use soft clipping for supplementary alignments
  -M         mark shorter split hits as secondary
  -I FLOAT[,FLOAT[,INT[,INT]]]  specify the mean, standard deviation (10% of the mean if absent),
             max (4 sigma from the mean if absent) and min of insert size distribution
Device options:
  --device STR  cuda or cpu [cuda]; cuda without a usable GPU is an error
  --resume      restart a killed run after its last journaled chunk (needs -o,
                no --shard)
  --shard h:N   align only the chunks c with c % N == h (one card), each into
                <out-dir>/part.chunk<c>.sam; `merge` joins the shards' files
  --out-dir D   directory of the shard's chunk files [<-o or shards>.d]
"""


def parse_mem_args(argv: list[str]):
    """getopt-compatible parser for the `mem` subcommand."""
    opt = MemOptions()
    mode = None
    fixed_chunk_size = -1
    no_mt_io = False
    rg_line = None
    hdr_line = None
    out_path = None
    copy_comment = False
    ignore_alt = False
    pes0 = None
    device_backend = True
    device = "cuda"

    optlist, args = getopt.gnu_getopt(
        sys.argv[2:] if argv is None else argv,
        "51qpaMCSPVYjk:c:v:s:r:t:R:A:B:O:E:U:w:L:d:T:Q:D:m:I:N:W:x:G:h:y:K:X:H:o:f:Z:",
        ["device=", "resume", "shard=", "out-dir="])
    verbose = 3
    resume = False
    shard = None
    out_dir = None
    for c, val in optlist:
        c = c[1:]
        if c == "k":
            opt.set("min_seed_len", int(val))
        elif c == "1":
            no_mt_io = True
        elif c == "x":
            mode = val
        elif c == "w":
            opt.set("w", int(val))
        elif c == "A":
            opt.set("a", int(val))
        elif c == "B":
            opt.set("b", int(val))
        elif c == "T":
            opt.set("T", int(val))
        elif c == "U":
            opt.set("pen_unpaired", int(val))
        elif c == "t":
            opt.n_threads = max(int(val), 1)
        elif c in ("o", "f"):
            out_path = val
        elif c == "P":
            opt.flag |= MEM_F_NOPAIRING
        elif c == "a":
            opt.flag |= MEM_F_ALL
        elif c == "p":
            opt.flag |= MEM_F_PE | MEM_F_SMARTPE
        elif c == "M":
            opt.flag |= MEM_F_NO_MULTI
        elif c == "S":
            opt.flag |= MEM_F_NO_RESCUE
        elif c == "Y":
            opt.flag |= MEM_F_SOFTCLIP
        elif c == "V":
            opt.flag |= MEM_F_REF_HDR
        elif c == "5":
            opt.flag |= MEM_F_PRIMARY5 | MEM_F_KEEP_SUPP_MAPQ
        elif c == "q":
            opt.flag |= MEM_F_KEEP_SUPP_MAPQ
        elif c == "c":
            opt.set("max_occ", int(val))
        elif c == "d":
            opt.set("zdrop", int(val))
        elif c == "v":
            verbose = int(val)
            opt.verbose = verbose
        elif c == "j":
            ignore_alt = True
        elif c == "r":
            opt.set("split_factor", float(val))
        elif c == "D":
            opt.set("drop_ratio", float(val))
        elif c == "m":
            opt.set("max_matesw", int(val))
        elif c == "s":
            opt.set("split_width", int(val))
        elif c == "G":
            opt.set("max_chain_gap", int(val))
        elif c == "N":
            opt.set("max_chain_extend", int(val))
        elif c == "W":
            opt.set("min_chain_weight", int(val))
        elif c == "y":
            opt.set("max_mem_intv", int(val))
        elif c == "C":
            copy_comment = True
        elif c == "K":
            fixed_chunk_size = int(val)
        elif c == "X":
            opt.mask_level = float(val)
        elif c == "h":
            parts = val.replace(",", " ").split()
            opt.set("max_XA_hits", int(parts[0]))
            opt.set("max_XA_hits_alt",
                    int(parts[1]) if len(parts) > 1 else int(parts[0]))
        elif c == "Q":
            opt.set("mapQ_coef_len", float(val))
        elif c == "O":
            parts = val.replace(",", " ").split()
            opt.set("o_del", int(parts[0]))
            opt.set("o_ins", int(parts[1]) if len(parts) > 1 else int(parts[0]))
        elif c == "E":
            parts = val.replace(",", " ").split()
            opt.set("e_del", int(parts[0]))
            opt.set("e_ins", int(parts[1]) if len(parts) > 1 else int(parts[0]))
        elif c == "L":
            parts = val.replace(",", " ").split()
            opt.set("pen_clip5", int(parts[0]))
            opt.set("pen_clip3",
                    int(parts[1]) if len(parts) > 1 else int(parts[0]))
        elif c == "R":
            rg_line = val
        elif c == "H":
            if val.startswith("@"):
                hdr_line = (hdr_line + "\n" + val) if hdr_line else val
            else:
                with open(val) as f:
                    for ln in f:
                        ln = ln.rstrip("\n")
                        hdr_line = (hdr_line + "\n" + ln) if hdr_line else ln
        elif c == "I":
            from .align.pairing import PEStat
            pes0 = [PEStat() for _ in range(4)]
            parts = val.replace(",", " ").split()
            p = pes0[1]
            p.failed = 0
            p.avg = float(parts[0])
            p.std = float(parts[1]) if len(parts) > 1 else p.avg * 0.1
            p.high = int(p.avg + 4.0 * p.std + 0.499)
            p.low = max(int(p.avg - 4.0 * p.std + 0.499), 1)
            if len(parts) > 2:
                p.high = int(float(parts[2]) + 0.499)
            if len(parts) > 3:
                p.low = int(float(parts[3]) + 0.499)
        elif c == "Z":
            device_backend = val not in ("0", "off", "host")
        elif c == "-device":
            if val not in ("cuda", "cpu"):
                raise ValueError(f"--device must be cuda or cpu, not {val!r}")
            device = val
        elif c == "-resume":
            resume = True
        elif c == "-shard":
            h, n = (int(x) for x in val.split(":"))
            if not 0 <= h < n:
                raise ValueError(f"--shard h:N needs 0 <= h < N, not {val!r}")
            shard = (h, n)
        elif c == "-out-dir":
            out_dir = val
    return (opt, mode, fixed_chunk_size, no_mt_io, rg_line, hdr_line,
            out_path, copy_comment, ignore_alt, pes0, verbose, args,
            device_backend, device, resume, shard, out_dir)


def main_mem(argv: list[str]) -> int:
    from .align.pipeline import Aligner
    from .index.fmindex import FMIndex
    from .io.fastq import FastxReader
    from .io.sam import pg_line, sam_header
    from .runtime import run_pipeline
    from .utils.profiling import PROF

    try:
        (opt, mode, fixed_chunk_size, no_mt_io, rg_line, hdr_line, out_path,
         copy_comment, ignore_alt, pes0, verbose, args, device_backend,
         device, resume, shard, out_dir) = parse_mem_args(argv)
    except ValueError as e:
        # bad flag value: a usage error, not an internal failure
        raise getopt.GetoptError(str(e))
    if len(args) not in (2, 3):
        sys.stderr.write(usage_mem(opt))
        return 1
    opt.finalize(mode)

    devices = []
    if device_backend:
        # resolve the devices before any work: cuda without a GPU raises
        from .ops.backend import TorchBackend
        from .ops import resolve_devices
        devices = resolve_devices(device)
        if shard is not None:
            # one card per shard process, dealt by shard index
            devices = [devices[shard[0] % len(devices)]]

    prefix = args[0]
    t0 = time.time()
    sys.stderr.write(f"* loading index {prefix}\n")
    fm = FMIndex.load(prefix)
    if ignore_alt:
        for a in fm.bns.anns:
            a.is_alt = False
    sys.stderr.write(f"* index loaded in {time.time()-t0:.1f}s\n")

    rg_id = None
    if rg_line:
        rg_line = rg_line.replace("\\t", "\t")
        if not rg_line.startswith("@RG"):
            sys.stderr.write("[E] the read group line should start with @RG\n")
            return 1
        for field in rg_line.split("\t"):
            if field.startswith("ID:"):
                rg_id = field[3:]
        hdr_line = (hdr_line + "\n" + rg_line) if hdr_line else rg_line

    ks1 = FastxReader(args[1])
    ks2 = None
    if len(args) > 2:
        if opt.flag & MEM_F_PE:
            sys.stderr.write("[W] when '-p' is in use, the second query file "
                             "is ignored.\n")
        else:
            ks2 = FastxReader(args[2])
            opt.flag |= MEM_F_PE

    journal = None
    if resume:
        # chunk-granular restart: requires a seekable -o file
        if not out_path or shard is not None:
            return _fatal("--resume requires -o <file> (and no --shard)")
        from .runtime import ChunkJournal
        journal = ChunkJournal(out_path + ".resume")
        if journal.n_done and not os.path.exists(out_path):
            return _fatal(f"--resume: journal {out_path}.resume claims "
                          f"{journal.n_done} chunks but {out_path} is "
                          "missing; delete the journal to start over")
        if journal.n_done and verbose >= 3:
            sys.stderr.write(f"* resuming after {journal.n_done} chunks "
                             f"({journal.n_reads} reads)\n")
    fresh = journal is None or journal.end_offset is None \
        or not os.path.exists(out_path)
    out = open(out_path, "w" if fresh else "r+") if out_path else sys.stdout
    if fresh:
        out.write(sam_header(fm, hdr_line,
                             pg_line(["bwa-mem2-tpu"] + (argv or []),
                                     __version__)))
        if journal is not None:
            out.flush()
            journal.truncate_output(out_path, out.tell())
    else:
        # drop any partial chunk, append after the last journaled one
        out.flush()
        journal.truncate_output(out_path, 0)
        out.seek(journal.end_offset)

    task_size = (fixed_chunk_size if fixed_chunk_size > 0
                 else opt.chunk_size * opt.n_threads)

    sharded = (len(devices) > 1 and shard is None
               and bool(os.environ.get("BWAMEM2_TPU_SHARD_INDEX")))
    if sharded:
        # genome-bucket index sharding: the occ/SA tables split over all
        # the cards, one backend whose seeding kernels read every card's
        # shard (parallel/shard_index.py); for indexes too big for one
        # card.  The SAM is the replicated run's.
        aligners = [Aligner(fm, opt, backend=TorchBackend(
            fm, opt, devices=devices, sharded=True), rg_id=rg_id,
            verbose=verbose)]
    else:
        aligners = [Aligner(fm, opt, backend=TorchBackend(fm, opt,
                                                          device=d),
                            rg_id=rg_id, verbose=verbose)
                    for d in devices] \
            or [Aligner(fm, opt, backend=None, rg_id=rg_id, verbose=verbose)]
    if verbose >= 3:
        import torch
        for d in devices:
            name = (torch.cuda.get_device_name(d) if d.type == "cuda"
                    else "the CPU")
            sys.stderr.write(f"* device stages on {d} ({name})\n")
        if sharded:
            sys.stderr.write(f"* index sharded over {len(devices)} cards "
                             "(genome-bucket mode)\n")
        elif len(devices) > 1:
            sys.stderr.write(f"* data-parallel over {len(devices)} cards\n")
    # BWAMEM2_TPU_TRACE=<dir>: the alignment runs under torch.profiler
    # and its Chrome trace lands in <dir> (utils/profiling.py)
    PROF.start_trace()
    try:
        if shard is not None:
            from .parallel.multihost import run_sharded
            run_sharded(aligners[0], ks1, ks2, task_size,
                        out_dir or (out_path or "shards") + ".d", shard[0],
                        shard[1], pes0=pes0, copy_comment=copy_comment,
                        verbose=verbose)
        else:
            # -t maps to chunk-pipeline compute workers, capped at 4 (host
            # python saturates one GIL), and at least one per card; output
            # is order-identical for any count and any card count
            nw = 1 if no_mt_io else max(min(max(opt.n_threads, 1), 4),
                                        len(aligners))
            run_pipeline(aligners, ks1, ks2, task_size, out, pes0=pes0,
                         copy_comment=copy_comment,
                         pipeline_depth=1 if no_mt_io else 2,
                         verbose=verbose, n_workers=nw, resume=journal)
    finally:
        path = PROF.stop_trace()
    if path and verbose >= 3:
        sys.stderr.write(f"* trace written to {path}\n")
    if journal is not None:
        journal.close()
    if out is not sys.stdout:
        out.close()
    sys.stderr.write(f"* done in {time.time()-t0:.1f}s\n")
    _print_param_echo()
    return 0


def _print_param_echo() -> None:
    """Exit-time tuned-constant echo (main.cpp:115-125 analog), under the
    reference's keys: the port's own constants that govern kernel shapes —
    the extension tile caps, the seeding kernel's lane group widths, its
    on-chip candidate list and its per-read slot rule."""
    from .ops.bsw import LONG_QCAP, QCAP, TCAP
    from .ops.seed import LIST_CAPS, SLOTS_BASE, SLOTS_PER_BASE
    from .ops.seed_cuda import SmemCollect
    sys.stderr.write("\nImportant parameter settings: \n")
    sys.stderr.write("\tMAX_SEQ_LEN_REF (TCAP): %d\n" % TCAP)
    sys.stderr.write("\tMAX_SEQ_LEN_QER (QCAP): %d\n" % QCAP)
    sys.stderr.write("\tLONG_QCAP (sheared-band class): %d\n" % LONG_QCAP)
    sys.stderr.write("\tVPU_LANES (seeding lane group widths): %s\n"
                     % "/".join(map(str, SmemCollect.LANES)))
    sys.stderr.write("\tSEED_CAND_SLOTS (on-chip list, by grid width): "
                     "%d/%d\n" % LIST_CAPS)
    sys.stderr.write("\tSEEDS_PER_READ (slots per read): %d + len/%d\n"
                     % (SLOTS_BASE, SLOTS_PER_BASE))
    sys.stderr.write("\tSA_COORDS_PER_READ (per SMEM, no per-read cap): "
                     "min(s, max_occ)\n")


def main_index(argv: list[str]) -> int:
    from .index.build import build_index
    optlist, args = getopt.gnu_getopt(argv, "p:")
    prefix = None
    for c, val in optlist:
        if c == "-p":
            prefix = val
    if len(args) != 1:
        sys.stderr.write("Usage: python -m bwamem2_tpu_torch.cli index "
                         "[-p prefix] <in.fasta>\n")
        return 1
    build_index(args[0], prefix)
    return 0


def _fatal(msg: str) -> int:
    """err_fatal-style clean failure (utils.h:42-47): one-line message on
    stderr, nonzero exit, no traceback."""
    sys.stderr.write(f"[E::main] {msg}\n")
    return 1


def main(argv: list[str] | None = None) -> int:
    try:
        return _main(argv)
    except FileNotFoundError as e:
        return _fatal(f"fail to open file '{e.filename or e}'")
    except getopt.GetoptError as e:
        return _fatal(str(e))
    except BrokenPipeError:
        return 1
    except KeyboardInterrupt:
        return 130


def _main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        sys.stderr.write(
            "Usage: python -m bwamem2_tpu_torch.cli <command> [options]\n"
            "Commands: index    index sequences in FASTA format\n"
            "          mem      alignment (--device cuda|cpu; --shard h:N\n"
            "                   --out-dir D for deterministic sharding)\n"
            "          merge    merge sharded chunk outputs in order\n"
            "          version  print version number\n")
        return 1
    cmd, rest = argv[0], argv[1:]
    if cmd == "index":
        return main_index(rest)
    if cmd == "mem":
        return main_mem(rest)
    if cmd == "merge":
        from .parallel.multihost import merge_chunks
        if len(rest) < 2:
            sys.stderr.write("Usage: python -m bwamem2_tpu_torch.cli merge "
                             "<out.sam> <part.chunk*.sam ...>\n")
            return 1
        with open(rest[0], "w") as f:
            merge_chunks(f, rest[1:])
        return 0
    if cmd == "version":
        print(__version__)
        return 0
    sys.stderr.write(f"[main] unrecognized command '{cmd}'\n")
    return 1


if __name__ == "__main__":
    sys.exit(main())
