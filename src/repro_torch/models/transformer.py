"""Decoder stack: a Python loop over attention blocks.

The JAX package scans over layer-stacked parameters; the port keeps one
parameter dict per layer in a list and loops.  Only homogeneous attention
stacks (``kind == "attn"``) are ported; ``check_supported`` refuses the rest
by name.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention, ffn
from repro_torch.models.modules import rms_norm
from repro_torch.utils.tree import ParamBuilder, zeros_init


def check_supported(cfg, run) -> None:
    """Raise ``NotImplementedError`` naming each option this port lacks."""
    missing = []
    if run.quantize_serving:
        missing.append("RunConfig.quantize_serving (int8 serving)")
    if cfg.moe is not None:
        missing.append("MoE (ModelConfig.moe)")
    kinds = sorted(set(cfg.layer_kinds) - {"attn"})
    if kinds:
        missing.append(f"{'/'.join(kinds)} blocks")
    if cfg.qk_norm:
        missing.append("qk_norm")
    if cfg.sliding_window is not None:
        missing.append("sliding_window (ring KV cache)")
    if cfg.local_window is not None:
        missing.append("local_window (ring KV cache)")
    if cfg.mlp_variant != "swiglu":
        missing.append(f"mlp_variant={cfg.mlp_variant!r}")
    if not cfg.tie_embeddings:
        missing.append("untied embeddings (tie_embeddings=False)")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: not ported to repro_torch yet: {', '.join(missing)}")


def init_block(pb: ParamBuilder, cfg):
    pb.param("norm1", (cfg.d_model,), init=zeros_init)
    pb.param("norm2", (cfg.d_model,), init=zeros_init)
    attention.init(pb.child("attn"), cfg)
    ffn.init_mlp(pb.child("mlp"), cfg.d_model, cfg.d_ff, cfg.mlp_variant)


def init_stack(cfg, generator: torch.Generator, dtype) -> list:
    """One parameter dict per layer, all drawn from ``generator``."""
    layers = []
    for _ in range(cfg.n_layers):
        pb = ParamBuilder(generator, dtype)
        init_block(pb, cfg)
        layers.append(pb.params)
    return layers


def block_forward(p, cfg, run, x, positions, mode, cache_kv=None, pos=None):
    """One attention block.  ``mode`` is "train" (no cache), "prefill" (fills
    ``cache_kv``) or "decode" (one token at ``pos``).  Returns x."""
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if mode == "decode":
        a = attention.decode(p["attn"], cfg, run, h, *cache_kv, pos)
    else:
        a, k, v = attention.apply(p["attn"], cfg, run, h, positions)
        if mode == "prefill":
            attention.prefill_cache(*cache_kv, k, v)
    x = x + a
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + ffn.apply_mlp(p["mlp"], h)


def init_cache(cfg, batch, max_seq, dtype, device):
    return attention.init_cache(cfg, cfg.n_layers, batch, max_seq, dtype, device)


def apply_stack(layers, cfg, run, x, positions, mode="train", cache=None, pos=None):
    """Run all layers; a cache given in prefill or decode mode is updated in place."""
    for i, p in enumerate(layers):
        kv = (cache["k"][i], cache["v"][i]) if cache is not None else None
        x = block_forward(p, cfg, run, x, positions, mode, kv, pos)
    return x
