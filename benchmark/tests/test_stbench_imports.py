"""The check against JAX and the JAX package compares whole top-level
names; no file of the benchmark imports them, and the reference imports
nothing of the program either."""
import ast

from benchmark import spec
from benchmark.imports import banned


def test_top_level_names_whole():
    names = ["stfem_tpu_torch", "stfem_tpu_torch.ops.kron_pair", "jaxtyping",
             "jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
             "stfem_tpu", "stfem_tpu.ops", "stfem_tpux", "numpy"]
    assert banned(names) == ["flax.linen", "jax", "jax.numpy",
                             "jaxlib.xla_client", "stfem_tpu",
                             "stfem_tpu.ops"]
    assert banned([]) == []


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_sources():
    for path in spec.HERE.rglob("*.py"):
        if "tests" in path.parts:
            continue
        tops = set(_imports(path))
        assert not tops & {"jax", "jaxlib", "flax", "stfem_tpu"}, path
        if "reference" in path.parts:
            assert tops <= {"numpy", "torch", "__future__"}, (path, tops)
