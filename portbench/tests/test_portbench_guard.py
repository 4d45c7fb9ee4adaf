"""The import guard: names compared whole, the harness loads neither JAX
nor the JAX package, and the reference loads nothing of the program."""

import ast
import glob
import os
import subprocess
import sys

from conftest import ROOT

from portbench.guard import forbidden_modules


def test_top_level_names_compared_whole():
    assert forbidden_modules({"bwamem2_tpu_torch.ops": 1, "jaxtyping": 1,
                              "numpy": 1}) == []
    assert forbidden_modules({"bwamem2_tpu.ops.seed": 1, "jax.numpy": 1,
                              "jaxlib": 1, "flax.linen": 1}) == \
        ["bwamem2_tpu", "flax", "jax", "jaxlib"]


def loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True,
        env=dict(os.environ, PYTHONPATH=ROOT))
    return set(out.stdout.split())


def test_the_harness_loads_no_jax():
    mods = loaded_after(
        "import portbench.bench, portbench.trace, portbench.calibrate\n"
        "from bwamem2_tpu_torch.align.pipeline import Aligner\n"
        "from bwamem2_tpu_torch.ops.backend import TorchBackend\n"
        "from bwamem2_tpu_torch.runtime import run_pipeline")
    assert "bwamem2_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "bwamem2_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    mods = loaded_after("import portbench.reference.check")
    assert not mods & {"jax", "jaxlib", "flax", "bwamem2_tpu",
                       "bwamem2_tpu_torch"}
    for path in glob.glob(os.path.join(ROOT, "portbench", "reference",
                                       "*.py")):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in (
                    "bwamem2_tpu", "bwamem2_tpu_torch", "jax", "portbench"
                ), (path, n)
