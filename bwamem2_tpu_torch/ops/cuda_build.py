"""Build, load and count the hand-written CUDA kernels of csrc/.

Each kernel source (`csrc/<name>.cu`, with the headers it includes) is
compiled at first use with nvcc for sm_90a into a shared library with a
plain C interface, loaded with ctypes (no PyTorch headers, so a build
takes seconds).  The library lands in the package's git-ignored build/
directory under a name keyed by the sources' hash, under a file lock, via
a per-process temp file renamed into place.

`CudaKernel` is the base of every wrapper: it owns the lazily built
library, the build log and the two counters — `launches` (kernel launches,
counted where the kernel is launched and nowhere else) and `plain_calls`
(calls on CPU tensors, which run the plain PyTorch version).  A launch is
also added to the calling thread's tally (`launch_tally`), if one is set:
a TorchBackend sets its own when a chunk starts on a thread, so that with
one backend per card each backend counts the launches of its chunks.
`launch_counts` sums both counters over every wrapper made in the process.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import weakref

import torch

from ..native import build_lock

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    for c in (os.environ.get("NVCC"), shutil.which("nvcc"),
              "/usr/local/cuda/bin/nvcc"):
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set NVCC or put the CUDA toolkit's "
                       "bin/ on PATH)")


def build_library(name: str, sources: tuple[str, ...]) -> tuple[str, str]:
    """Compile csrc/`sources[0]` (the others are the headers it includes)
    unless a library of the same sources is built; returns (library path,
    nvcc/ptxas log of this build or "")."""
    h = hashlib.sha1()
    for src in sources:
        with open(os.path.join(CSRC, src), "rb") as f:
            h.update(f.read())
    lib = os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:12]}.so")
    if os.path.exists(lib):
        return lib, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with build_lock(lib):
        if os.path.exists(lib):
            return lib, ""
        tmp = f"{lib[:-3]}.{os.getpid()}.tmp.so"
        try:
            r = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp,
                 os.path.join(CSRC, sources[0])],
                capture_output=True, text=True)
            if r.returncode:
                raise RuntimeError(f"nvcc {sources[0]} failed "
                                   f"({r.returncode}):\n{r.stdout}{r.stderr}")
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return lib, r.stdout + r.stderr


VP, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64

_tally = threading.local()
_tally_lock = threading.Lock()
_wrappers: "weakref.WeakSet[CudaKernel]" = weakref.WeakSet()


def launch_counts(plain: bool = False) -> dict:
    """{kernel name: launches} (with `plain`, calls that ran the plain
    version) summed over every kernel wrapper made in this process."""
    out: dict = {}
    for k in list(_wrappers):
        out[k.NAME] = out.get(k.NAME, 0) + (k.plain_calls if plain
                                             else k.launches)
    return out


def launch_tally(counts: dict | None) -> None:
    """Add this thread's following kernel launches to `counts` ({kernel
    name: launches}), or to no tally (None)."""
    _tally.counts = counts


def current_tally() -> dict | None:
    """The tally this thread's launches go to (launch_tally)."""
    return getattr(_tally, "counts", None)


class CudaKernel:
    """Base of a kernel wrapper.  Subclasses set NAME, SOURCES and
    SIGNATURE = (C function name, argtypes of every parameter, the stream
    last), and ENTRIES, the kernel's other launchers {C function name:
    argtypes}; a launcher returns cudaGetLastError() of its launch.
    LIBRARY names the built library (NAME unless set: two wrappers of one
    source share its library, each counting its own launches).  A
    parameter without its argtype goes as a C int, so a pointer (the
    stream) past the sixth argument would reach the launcher with its high
    half undefined."""

    NAME: str = ""
    SOURCES: tuple[str, ...] = ()
    SIGNATURE: tuple[str, list] = ("", [])
    ENTRIES: dict[str, list] = {}
    LIBRARY: str = ""

    def __init__(self):
        self.launches = 0
        self.plain_calls = 0
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()
        _wrappers.add(self)

    def lib(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                path, self.build_log = build_library(
                    self.LIBRARY or self.NAME, self.SOURCES)
                lib = ctypes.CDLL(path)
                for name, argtypes in ((self.SIGNATURE,)
                                       + tuple(self.ENTRIES.items())):
                    fn = getattr(lib, name)
                    fn.restype = I32
                    fn.argtypes = argtypes
                self._lib = lib
        return self._lib

    def _query(self, dev, name: str, argtypes: list, *args) -> int:
        """Call the library's shape or occupancy function `name` on CUDA
        device `dev`: the runtime answers for the calling thread's current
        device, and a pipeline worker's is not its backend's."""
        fn = getattr(self.lib(), name)
        fn.restype, fn.argtypes = I32, argtypes
        with torch.cuda.device(dev):
            return fn(*args)

    def _plain(self):
        with self._lock:
            self.plain_calls += 1

    def _launch(self, dev, *args, entry: str | None = None) -> None:
        """Call the C launcher (SIGNATURE's, or the entry of ENTRIES named)
        on PyTorch's current stream of `dev`, raise on a refused launch,
        count it."""
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = getattr(self.lib(), entry or self.SIGNATURE[0])(*args,
                                                                 stream)
        if err:
            raise RuntimeError(f"{self.NAME} launch failed: CUDA error {err}")
        with self._lock:     # pipeline workers launch from several threads
            self.launches += 1
        counts = getattr(_tally, "counts", None)
        if counts is not None:
            with _tally_lock:    # two workers may share a backend's tally
                counts[self.NAME] = counts.get(self.NAME, 0) + 1

    def reset(self) -> None:
        with self._lock:
            self.launches = 0
            self.plain_calls = 0


def check_tensors(kernel: str, dev, **want) -> None:
    """Raise unless each named tensor is a contiguous tensor of the given
    dtype and rank on `dev`: want = {name: (tensor, dtype, ndim)}."""
    for name, (t, dt, nd) in want.items():
        if t.device != dev or t.dtype != dt or t.dim() != nd \
                or not t.is_contiguous():
            raise ValueError(
                f"{kernel}: {name} must be a contiguous {nd}-d {dt} tensor "
                f"on {dev}, got {tuple(t.shape)} {t.dtype} on {t.device}")
