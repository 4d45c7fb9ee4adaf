"""The port stands alone: no jax, nothing of bwamem2_tpu or tools/.

An AST scan of every Python file of bwamem2_tpu_torch/ and of
chip_smoke.py finds no import of `jax`, `bwamem2_tpu` or the repo's
`tools` (absolute, or relative imports climbing out of the package), and a
fresh interpreter that imports every module of the port has none of them
in sys.modules.  (tools/gather_scale_probe.py runs its probe when
imported; the port has its own copy under bwamem2_tpu_torch/tools/.)
"""

import ast
import os
import subprocess
import sys

from conftest import REPO

PKG = os.path.join(REPO, "bwamem2_tpu_torch")
BANNED = ("jax", "jaxlib", "bwamem2_tpu", "tools")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _modules():
    mods = []
    for path in _port_files()[1:]:
        rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
        mods.append(rel[:-len(".__init__")] if rel.endswith(".__init__")
                    else rel)
    return mods


def test_no_banned_imports_in_source():
    bad = []
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        depth = os.path.relpath(path, REPO).count(os.sep)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                if node.level and node.level > depth:
                    bad.append((path, node.lineno, "relative import "
                                "leaves the package"))
                    continue
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for n in names:
                if n.split(".")[0] in BANNED:
                    bad.append((path, node.lineno, n))
    assert not bad, bad
    assert len(_port_files()) > 20


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        f"for m in {_modules()!r}:\n"
        "    __import__(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{BANNED!r})\n"
        "print(len(sys.modules), bad)\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_scan_covers_the_data_parallel_modules():
    """The scans above reach the parallel layer, the fused step, the
    per-stage seeding and the sharded index."""
    mods = set(_modules())
    for m in ("bwamem2_tpu_torch.parallel", "bwamem2_tpu_torch.parallel.mesh",
              "bwamem2_tpu_torch.parallel.multihost",
              "bwamem2_tpu_torch.ops.entry", "bwamem2_tpu_torch.ops.smem",
              "bwamem2_tpu_torch.parallel.shard_index"):
        assert m in mods, m


def test_scan_covers_the_measurement_tools():
    """The scans above reach the trace hook's module and the port's
    measurement tools (host_ceiling, prof_bench, scaling_bench,
    shard_overhead)."""
    mods = set(_modules())
    for m in ("bwamem2_tpu_torch.utils.profiling",
              "bwamem2_tpu_torch.tools.host_ceiling",
              "bwamem2_tpu_torch.tools.prof_bench",
              "bwamem2_tpu_torch.tools.scaling_bench",
              "bwamem2_tpu_torch.tools.shard_overhead"):
        assert m in mods, m
