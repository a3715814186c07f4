"""Carry the JAX package's ``LM.init`` parameters over to the port.

The JAX tree holds the stack as ``stack.groups``, one tree per slot of the
block pattern with every leaf stacked over ``n_groups``, and ``stack.tail``,
one unstacked tree per trailing layer.  The port keeps one dict per layer, in
layer order: layer ``g * len(pattern) + j`` is ``groups[j][g]``, then the
tail, as ``transformer.grouping`` of the config says.  An untied config also
carries the top-level ``unembed`` leaf.  Leaves come in as numpy arrays
(``np.asarray`` of the JAX arrays), so nothing here imports JAX.
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
    "rwkv": {**{name: None for name in (
                 "norm_tm", "norm_cm", "mix_r", "mix_k", "mix_v", "mix_w", "mix_g",
                 "w_bias", "w_lora_a", "w_lora_b", "bonus_u", "wr", "wk", "wv", "wg",
                 "wo", "ln_x_scale")},
             "cm": ("mix_k", "mix_r", "wk", "wv", "wr")},
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
            f"{where}: expected leaves {sorted(keys)}, got {got}; only attention, "
            f"RG-LRU and RWKV-6 blocks are ported")


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
    top = ("embed", "final_norm", "stack") + (() if cfg.tie_embeddings else ("unembed",))
    _expect_keys(tree, top, "params")
    pattern, n_groups, tail_kinds = transformer.grouping(cfg)
    groups, tail = tree["stack"]["groups"], tree["stack"]["tail"]
    if len(groups) != len(pattern) or len(tail) != len(tail_kinds):
        raise ValueError(f"stack has {len(groups)} group slots and {len(tail)} tail "
                         f"layers; {cfg.name} needs {len(pattern)} and {len(tail_kinds)}")
    for j, kind in enumerate(pattern):
        _block(groups[j], kind, f"stack.groups[{j}]")       # leaf names only
        first = next(name for name, sub in _BLOCK_LEAVES[kind].items() if sub is None)
        stacked = np.shape(groups[j][first])[0]
        if stacked != n_groups:
            raise ValueError(f"stack.groups[{j}] stacks {stacked} layers; "
                             f"{cfg.name} has {n_groups} groups")
    layers = [_block(groups[j], kind, f"stack.groups[{j}]", g)
              for g in range(n_groups) for j, kind in enumerate(pattern)]
    layers += [_block(t, kind, f"stack.tail[{i}]")
               for i, (t, kind) in enumerate(zip(tail, tail_kinds))]
    params = {name: _tensor(tree[name], dev) for name in top if name != "stack"}
    params["layers"] = [_to_device(layer, dev) for layer in layers]
    return params
