"""Weights between the JAX parameter tree and the port's modules.

The port's modules keep the JAX parameter names and layouts
(`models/tfgridnet/model.py`), so a module's `state_dict()` key is the dotted
path of the JAX tree: `block0.intra.blstm.fwd.w_hh` is
`params["block0"]["intra"]["blstm"]["fwd"]["w_hh"]`.
"""
from __future__ import annotations

import numpy as np
import torch


def from_jax_params(tree) -> dict[str, torch.Tensor]:
    """Nested dicts of arrays (a checkpoint's `model` entry, or
    `jax.tree_util.tree_map(np.asarray, params)`) -> a float32 state dict for
    `Net.load_state_dict`."""
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                out[f"{prefix}{k}"] = torch.from_numpy(
                    np.array(v, dtype=np.float32))

    walk(tree, "")
    return out


def param_tree(module: torch.nn.Module) -> dict:
    """A module's parameters as the nested dict the JAX tree has."""
    tree: dict = {}
    for key, value in module.state_dict().items():
        node = tree
        *path, leaf = key.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = value
    return tree
