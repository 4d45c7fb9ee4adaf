"""bwamem2_tpu_torch — the PyTorch/CUDA port of bwamem2_tpu.

The same BWA-MEM seed-and-extend aligner, with SAM output byte-identical to
the JAX package's, running on one NVIDIA GPU (written for the H100, sm_90a).
Device kernels are written by hand in CUDA C++ (`csrc/`: seeding,
SA resolution, extension scoring, mate rescue and the row gather of the
gather probe),
each beside a plain PyTorch version of the same function (`ops/`); the
host runtime (chaining, extension acceptance, pairing, SAM text) is the
package's own copy of the native C++ runtime (`native/`).

Device selection: entry points run on "cuda" unless the caller passes
device="cpu" (CLI: --device cpu); asking for CUDA where there is none
raises.  On the CPU every kernel wrapper runs its plain version.

This package imports torch and never jax, and nothing of bwamem2_tpu.
"""

from .options import MemOptions  # noqa: F401

__version__ = "0.1.0"
