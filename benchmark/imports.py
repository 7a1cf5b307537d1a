"""The check that a run loaded neither JAX nor the JAX package: module
names are compared by their top-level part (before the first dot), whole,
since the port's own name `stfem_tpu_torch` begins with `stfem_tpu`."""
from __future__ import annotations

BANNED = ("jax", "jaxlib", "flax", "stfem_tpu")


def banned(module_names) -> list[str]:
    """The names among module_names whose top-level part is banned."""
    return sorted(n for n in module_names if n.split(".")[0] in BANNED)
