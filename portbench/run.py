"""The benchmark of bwamem2_tpu_torch (the PyTorch and CUDA port of the
aligner) on NVIDIA cards.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Run from the root of a checkout.  Prints one JSON line last on standard
output: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics with --trace 0, its per-layer metrics with --trace 1),
`device`, with --trace 1 `breakdown`, and `check` (each compared number
beside its limit, also the last lines on standard error).  Without the
cards the cell asks for it prints no result and exits with 3; if JAX or
the JAX package was loaded, with 4.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")
# every build and kernel cache inside the checkout, at fixed paths
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(CACHE, "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
os.environ.setdefault("USE_FLAX", "0")
# one process, few threads: PyTorch's and NumPy's host thread pools would
# otherwise put 8 threads under each of the pipeline's workers
for _v in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_v, "1")
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    from portbench.bench import run
    return run(a.workload, a.seed, a.seconds, bool(a.trace), T0)


if __name__ == "__main__":
    sys.exit(main())
