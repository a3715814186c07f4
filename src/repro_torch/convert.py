"""Carry the JAX package's ``LM.init`` parameters over to the port.

The JAX tree holds the stack as ``stack.groups``, one tree per slot of the
block pattern with every leaf stacked over ``n_groups``, and ``stack.tail``,
one unstacked tree per trailing layer.  The port keeps one dict per layer, in
layer order: layer ``g * len(pattern) + j`` is ``groups[j][g]``, then the
tail, as ``transformer.grouping`` of the config says.  Leaves come in as numpy arrays (``np.asarray`` of the JAX arrays), so
nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer

_MLP = ("w_gate", "w_up", "w_down")
_BLOCK_LEAVES = {
    "attn": {"norm1": None, "norm2": None,
             "attn": ("wq", "wk", "wv", "wo"), "mlp": _MLP},
    "rglru": {"norm1": None, "norm2": None,
              "rec": ("w_in_a", "w_in_b", "conv_w", "w_gate_a", "w_gate_x",
                      "lam", "w_out"),
              "mlp": _MLP},
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
            f"{where}: expected leaves {sorted(keys)}, got {got}; only attention "
            f"and RG-LRU blocks with tied embeddings are ported")


def _block(tree, kind, where, index=None) -> dict:
    """One ``kind`` layer's params from a block tree, taking ``[index]`` of
    every leaf of a stacked tree."""
    if kind not in _BLOCK_LEAVES:
        raise NotImplementedError(f"{where}: {kind} blocks are not ported")
    leaves = _BLOCK_LEAVES[kind]
    _expect_keys(tree, leaves, where)
    layer: dict = {}
    for name, sub in leaves.items():
        if sub is None:
            layer[name] = tree[name] if index is None else tree[name][index]
            continue
        _expect_keys(tree[name], sub, f"{where}.{name}")
        layer[name] = {leaf: tree[name][leaf] if index is None else tree[name][leaf][index]
                       for leaf in sub}
    return layer


def _to_device(layer: dict, device) -> dict:
    return {k: _to_device(v, device) if isinstance(v, dict) else _tensor(v, device)
            for k, v in layer.items()}


def params_from_jax(tree, cfg, device: DeviceLike = None) -> dict:
    """JAX ``LM.init`` params of ``cfg`` (numpy leaves) -> the port's params
    on ``device``.  The tree must split the stack as ``transformer.grouping``
    says."""
    dev = resolve_device(device)
    _expect_keys(tree, ("embed", "final_norm", "stack"), "params")
    pattern, n_groups, tail_kinds = transformer.grouping(cfg)
    groups, tail = tree["stack"]["groups"], tree["stack"]["tail"]
    if len(groups) != len(pattern) or len(tail) != len(tail_kinds):
        raise ValueError(f"stack has {len(groups)} group slots and {len(tail)} tail "
                         f"layers; {cfg.name} needs {len(pattern)} and {len(tail_kinds)}")
    for j, kind in enumerate(pattern):
        _block(groups[j], kind, f"stack.groups[{j}]")       # leaf names only
        stacked = np.shape(groups[j]["norm1"])[0]
        if stacked != n_groups:
            raise ValueError(f"stack.groups[{j}] stacks {stacked} layers; "
                             f"{cfg.name} has {n_groups} groups")
    layers = [_block(groups[j], kind, f"stack.groups[{j}]", g)
              for g in range(n_groups) for j, kind in enumerate(pattern)]
    layers += [_block(t, kind, f"stack.tail[{i}]")
               for i, (t, kind) in enumerate(zip(tail, tail_kinds))]
    return {"embed": _tensor(tree["embed"], dev),
            "final_norm": _tensor(tree["final_norm"], dev),
            "layers": [_to_device(layer, dev) for layer in layers]}
