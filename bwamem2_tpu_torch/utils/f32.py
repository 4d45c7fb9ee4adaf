"""float32 helpers.

Several mem_opt_t knobs are C `float`s (mask_level, drop_ratio,
XA_drop_ratio, mask_level_redun, frac_rep...).  Comparisons like
`score >= best * XA_drop_ratio` happen in 32-bit float in the reference
(0.8f = 0.800000011920929), which changes >=/<' outcomes at exact
thresholds.  These helpers reproduce C's float arithmetic with NumPy
float32 so thresholds match bit-for-bit.
"""

import numpy as np


def f32(x) -> np.float32:
    return np.float32(x)


def fmul(a, b) -> np.float32:
    """C: (float)a * (float)b."""
    return np.float32(np.float32(a) * np.float32(b))
