"""Decoder stack: a Python loop over attention, RG-LRU and RWKV-6 blocks.

``layer_kinds`` (from the config) is the JAX package's ``n_groups``
repetitions of the block pattern plus a tail, e.g. recurrentgemma-2b's 26
layers = 8 x (rglru, rglru, attn) + (rglru, rglru).  The JAX package scans
over per-slot stacked parameters; the port keeps one parameter dict and one
cache dict per layer, in layer order, and loops.  ``check_supported``
refuses what is not ported by name.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import attention, ffn, rglru, rwkv6
from repro_torch.models.modules import rms_norm
from repro_torch.utils.tree import ParamBuilder, zeros_init

_PORTED_KINDS = ("attn", "rglru", "rwkv")


def pattern_of(cfg):
    if cfg.block_pattern is not None:
        return tuple(cfg.block_pattern)
    return ("rwkv",) if cfg.family == "ssm" else ("attn",)


def grouping(cfg):
    """(pattern, n_groups, tail kinds) as the JAX package splits the stack."""
    pat = pattern_of(cfg)
    n_groups = cfg.n_layers // len(pat)
    tail = cfg.layer_kinds[n_groups * len(pat):]
    return pat, n_groups, tail


def kind_window(cfg, kind: str) -> Optional[int]:
    if kind != "attn":
        return None
    if cfg.family == "hybrid":
        return cfg.local_window
    return cfg.sliding_window


def check_supported(cfg, run) -> None:
    """Raise ``NotImplementedError`` naming each option this port lacks."""
    missing = []
    if run.quantize_serving:
        missing.append("RunConfig.quantize_serving (int8 serving)")
    if cfg.moe is not None:
        missing.append("MoE (ModelConfig.moe)")
    kinds = sorted(set(cfg.layer_kinds) - set(_PORTED_KINDS))
    if kinds:
        missing.append(f"{'/'.join(kinds)} blocks")
    if cfg.qk_norm:
        missing.append("qk_norm")
    if cfg.mlp_variant != "swiglu":
        missing.append(f"mlp_variant={cfg.mlp_variant!r}")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: not ported to repro_torch yet: {', '.join(missing)}")


def init_block(pb: ParamBuilder, cfg, kind: str):
    if kind == "rwkv":      # its own norm_tm and norm_cm, no mlp
        rwkv6.init_block(pb, cfg)
        return
    pb.param("norm1", (cfg.d_model,), init=zeros_init)
    pb.param("norm2", (cfg.d_model,), init=zeros_init)
    if kind == "attn":
        attention.init(pb.child("attn"), cfg)
        ffn.init_mlp(pb.child("mlp"), cfg.d_model, cfg.d_ff, cfg.mlp_variant)
    elif kind == "rglru":
        rglru.init(pb.child("rec"), cfg)
        ffn.init_mlp(pb.child("mlp"), cfg.d_model, cfg.d_ff)
    else:
        raise ValueError(kind)


def init_stack(cfg, generator: torch.Generator, dtype) -> list:
    """One parameter dict per layer, in layer order, all drawn from ``generator``."""
    layers = []
    for kind in cfg.layer_kinds:
        pb = ParamBuilder(generator, dtype)
        init_block(pb, cfg, kind)
        layers.append(pb.params)
    return layers


def block_forward(p, cfg, run, kind, x, positions, mode, cache=None, pos=None):
    """One block.  ``mode`` is "train" (no cache), "prefill" (fills ``cache``)
    or "decode" (one token at ``pos``, advances ``cache``).  Returns x."""
    if kind == "rwkv":      # norms and residuals inside the block
        if mode == "decode":
            return rwkv6.decode(p, cfg, run, x, cache)
        return rwkv6.apply(p, cfg, run, x, cache)
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if kind == "attn":
        window = kind_window(cfg, kind)
        if mode == "decode":
            a = attention.decode(p["attn"], cfg, run, h, cache, pos, window=window)
        else:
            a, k, v = attention.apply(p["attn"], cfg, run, h, positions, window=window)
            if mode == "prefill":
                attention.prefill_cache(cache, k, v, window=window)
    elif kind == "rglru":
        if mode == "decode":
            a = rglru.decode(p["rec"], cfg, run, h, cache)
        else:
            a = rglru.apply(p["rec"], cfg, run, h, cache)
    else:
        raise ValueError(kind)
    x = x + a
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + ffn.apply_mlp(p["mlp"], h)


def init_cache(cfg, batch, max_seq, dtype, device) -> list:
    """One cache dict per layer: ring or full k/v for attention, h/conv for
    RG-LRU, state and the last normed tokens for RWKV-6."""
    caches = []
    for kind in cfg.layer_kinds:
        if kind == "attn":
            caches.append(attention.init_cache(cfg, batch, max_seq, dtype, device,
                                               window=kind_window(cfg, kind)))
        elif kind == "rglru":
            caches.append(rglru.init_cache(cfg, batch, dtype, device))
        elif kind == "rwkv":
            caches.append(rwkv6.init_cache(cfg, batch, dtype, device))
        else:
            raise ValueError(kind)
    return caches


def apply_stack(layers, cfg, run, x, positions, mode="train", cache=None, pos=None):
    """Run all layers; a cache given in prefill or decode mode is updated in place."""
    for i, (p, kind) in enumerate(zip(layers, cfg.layer_kinds)):
        c = cache[i] if cache is not None else None
        x = block_forward(p, cfg, run, kind, x, positions, mode, c, pos)
    return x
