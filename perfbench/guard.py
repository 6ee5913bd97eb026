"""Keep JAX and the JAX package out of a benchmark run.

The benchmark measures the PyTorch port only.  ``install`` puts a finder in
front of ``sys.meta_path`` that refuses every module whose top-level name
(the part before the first dot) is one of ``BLOCKED``, compared whole: the
port, ``photometry_tpu_torch``, passes.  ``loaded`` names the blocked
modules that are in ``sys.modules`` anyway (loaded before ``install``).
"""

import importlib.abc
import sys

BLOCKED = ("jax", "jaxlib", "flax", "photometry_tpu")


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if top_level(name) in BLOCKED:
            raise ImportError(f"{name} is blocked in a benchmark run")
        return None


def install():
    if not any(isinstance(f, Blocker) for f in sys.meta_path):
        sys.meta_path.insert(0, Blocker())


def loaded() -> list:
    return sorted(n for n in list(sys.modules) if top_level(n) in BLOCKED)
