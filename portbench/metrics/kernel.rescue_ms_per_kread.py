"""kernel.rescue_ms_per_kread: device time of the rescue kernels (kswv and
its phase forms), per 1,000 reads; paired traffic only."""

from portbench.readers import kernel_ms_per_kread

PATTERNS = ("kswv",)


def read(w):
    return kernel_ms_per_kread(w, PATTERNS)
