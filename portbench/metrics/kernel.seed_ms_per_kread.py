"""kernel.seed_ms_per_kread: device time of the seeding kernels (the
union of their intervals in the window, from the device trace), per 1,000
reads."""

from portbench.readers import kernel_ms_per_kread

PATTERNS = ("smem_collect", "sa_resolve", "round1_", "round2_", "round3_",
            "row_gather")


def read(w):
    return kernel_ms_per_kread(w, PATTERNS)
