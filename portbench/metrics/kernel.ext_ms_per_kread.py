"""kernel.ext_ms_per_kread: device time of the extension kernels
(bsw_extend, bsw_shear), per 1,000 reads."""

from portbench.readers import kernel_ms_per_kread

PATTERNS = ("bsw_extend", "bsw_shear")


def read(w):
    return kernel_ms_per_kread(w, PATTERNS)
