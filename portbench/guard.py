"""The import guard: the benchmark runs the port alone.

Module names are compared by their top-level part, whole: `bwamem2_tpu`
is forbidden and `bwamem2_tpu_torch` is not.
"""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "bwamem2_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """The forbidden top-level names among the loaded modules."""
    mods = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in list(mods)}
                  & set(FORBIDDEN))
