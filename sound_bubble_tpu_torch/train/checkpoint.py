"""Read the JAX package's single-file checkpoints without JAX or optax.

A checkpoint (`runs/*/checkpoints/{best,last}.pt`) is a pickle of
{model, optimizer, current_epoch, metric_values, statistics, scheduler} with
numpy leaves. Its optimizer state refers to optax classes
(`optax._src.base.EmptyState`, `optax._src.transform.ScaleByAdamState`), and
numpy >= 2 writes its arrays through `numpy._core`. A machine without optax,
or with numpy < 2, cannot `pickle.load` such a file. `load_checkpoint` reads it
anyway: every optax/flax/jax global becomes an inert placeholder, and
`numpy._core.*` falls back to `numpy.core.*`. Only `ckpt["model"]` is used.
"""
from __future__ import annotations

import importlib
import pickle

_FOREIGN = ("optax", "flax", "jax", "jaxlib")


class Placeholder:
    """Stands in for an object of a class from a package the port does not
    import. It accepts any constructor arguments and state, and holds them."""

    def __new__(cls, *args, **kwargs):
        obj = super().__new__(cls)
        obj.args = args
        return obj

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.state = state


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] in _FOREIGN:
            return type(name, (Placeholder,), {"__module__": module})
        if module.startswith("numpy._core"):
            try:
                importlib.import_module(module)
            except ImportError:
                module = "numpy.core" + module[len("numpy._core"):]
        return super().find_class(module, name)


def load_checkpoint(path: str) -> dict:
    with open(path, "rb") as f:
        return _Unpickler(f).load()
