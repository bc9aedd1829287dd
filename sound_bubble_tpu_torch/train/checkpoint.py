"""Single-file checkpoints, read and written without JAX or optax.

A checkpoint (`runs/*/checkpoints/{best,last}.pt`) is a pickle of
{model, optimizer, current_epoch, metric_values, statistics, scheduler} with
numpy leaves. `model` is the nested dict of the JAX parameter tree
(`weights.py:param_tree`), so a checkpoint the port writes is read unchanged
by the JAX package (`train/checkpoint.py:load_checkpoint`,
`utils.load_torch_pretrained`). The port writes `optimizer` as
{"lr": float, "state": the `torch.optim` state dict with numpy arrays}
(`train/optim.py:Optimizer.state_dict`) and `scheduler` as the scheduler's
attribute dict, the JAX package's form; neither holds a torch object, so
the file unpickles without torch.

Reading: a checkpoint of the JAX package names optax classes in its
optimizer state (`optax._src.base.EmptyState`,
`optax._src.transform.ScaleByAdamState`), and numpy >= 2 writes its arrays
through `numpy._core`. A machine without optax,
or with numpy < 2, cannot `pickle.load` such a file. `load_checkpoint` reads it
anyway: every optax/flax/jax global becomes an inert placeholder, and
`numpy._core.*` falls back to `numpy.core.*`. Of a JAX package's checkpoint
the port uses only `ckpt["model"]`.
"""
from __future__ import annotations

import importlib
import os
import pickle

import torch

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


def _numpy_tree(node):
    if isinstance(node, torch.Tensor):
        return node.detach().cpu().numpy()
    if isinstance(node, dict):
        return {k: _numpy_tree(v) for k, v in node.items()}
    return node


def save_checkpoint(path: str, state: dict) -> None:
    """Pickle `state` with every tensor as a numpy array (protocol 4, as the
    JAX package writes), through a temporary file and a rename so a reader
    never sees half a checkpoint."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        pickle.dump(_numpy_tree(state), f, protocol=4)
    os.replace(tmp, path)


def model_tree(net: torch.nn.Module) -> dict:
    """A module's weights as the JAX parameter tree of numpy arrays."""
    from sound_bubble_tpu_torch.weights import param_tree
    return _numpy_tree(param_tree(net))
