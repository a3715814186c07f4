"""Carry the JAX package's ``LM.init`` parameters over to the port.

The JAX tree stacks every layer's parameters over a leading layer axis
(``stack.groups[0]``); the port keeps one dict per layer.  Leaves come in as
numpy arrays (``np.asarray`` of the JAX arrays), so nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

_LAYER_LEAVES = {
    "norm1": None, "norm2": None,
    "attn": ("wq", "wk", "wv", "wo"),
    "mlp": ("w_gate", "w_up", "w_down"),
}


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # numpy has no bf16: widen exactly
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)   # a copy: JAX buffers are read-only


def _expect_keys(tree, keys, where):
    got = sorted(tree)
    if got != sorted(keys):
        raise NotImplementedError(
            f"{where}: expected leaves {sorted(keys)}, got {got}; "
            f"only dense tied-embedding attention stacks are ported")


def params_from_jax(tree, device: DeviceLike = None) -> dict:
    """JAX ``LM.init`` params (numpy leaves) -> the port's params on ``device``."""
    dev = resolve_device(device)
    _expect_keys(tree, ("embed", "final_norm", "stack"), "params")
    stack = tree["stack"]
    if len(stack["groups"]) != 1 or len(stack["tail"]) != 0:
        raise NotImplementedError("only homogeneous stacks (one group, no tail) are ported")
    group = stack["groups"][0]
    _expect_keys(group, _LAYER_LEAVES, "stack.groups[0]")
    stacked = {}
    for name, sub in _LAYER_LEAVES.items():
        if sub is None:
            stacked[(name,)] = _tensor(group[name], dev)
        else:
            _expect_keys(group[name], sub, f"stack.groups[0].{name}")
            for leaf in sub:
                stacked[(name, leaf)] = _tensor(group[name][leaf], dev)
    n_layers = stacked[("norm1",)].shape[0]
    layers = []
    for i in range(n_layers):
        layer: dict = {}
        for path, t in stacked.items():
            node = layer
            for part in path[:-1]:
                node = node.setdefault(part, {})
            node[path[-1]] = t[i]
        layers.append(layer)
    return {"embed": _tensor(tree["embed"], dev),
            "final_norm": _tensor(tree["final_norm"], dev),
            "layers": layers}
