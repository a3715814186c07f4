"""GQA attention block with rope and a full KV cache.

  * prefill / full forward -> the CUDA flash-attention kernel when
    ``run.use_pallas`` (its plain version on a CPU tensor), else the plain
    version ``attention_ref``;
  * decode -> ``naive_attention`` over the cache (Sq == 1, linear cost).

The cache is updated in place: one preallocated buffer per layer, where the
JAX package returns an updated copy.  The ring cache of windowed archs is
not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models import modules
from repro_torch.utils.tree import ParamBuilder, fan_in_init

_FAR_FUTURE = torch.iinfo(torch.int32).max // 2   # never passes the causal mask


def init(pb: ParamBuilder, cfg):
    M, Hq, Hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    D = cfg.resolved_head_dim
    pb.param("wq", (M, Hq, D), init=fan_in_init(M))
    pb.param("wk", (M, Hkv, D), init=fan_in_init(M))
    pb.param("wv", (M, Hkv, D), init=fan_in_init(M))
    pb.param("wo", (Hq, D, M), init=fan_in_init(Hq * D))


def _proj(x, w):
    """(B, S, M) x (M, H, D) -> contiguous (B, S, H, D)."""
    M, H, D = w.shape
    return (x @ w.to(x.dtype).reshape(M, H * D)).view(*x.shape[:-1], H, D)


def _project_qkv(p, cfg, x, positions):
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    cos, sin = modules.rope_angles(positions, cfg.resolved_head_dim, cfg.rope_theta)
    return modules.apply_rope(q, cos, sin), modules.apply_rope(k, cos, sin), v


def _out(p, o):
    """(B, S, Hq, D) x (Hq, D, M) -> (B, S, M)."""
    Hq, D, M = p["wo"].shape
    return o.reshape(*o.shape[:2], Hq * D) @ p["wo"].to(o.dtype).reshape(Hq * D, M)


def apply(p, cfg, run, x, positions):
    """Full-sequence forward (prefill, logits). x: (B, S, M); positions are
    ``arange(S)``.  Returns (y, k, v) so that prefill fills the cache without
    projecting k and v a second time."""
    q, k, v = _project_qkv(p, cfg, x, positions)
    attend = flash_attention if run.use_pallas else attention_ref
    o = attend(q, k, v, causal=True)
    return _out(p, o), k, v


def init_cache(cfg, n_layers, batch, max_seq, dtype, device):
    """Full KV cache of all layers: k, v each (L, B, max_seq, Hkv, D)."""
    shape = (n_layers, batch, max_seq, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def prefill_cache(cache_k, cache_v, k, v):
    """Write a prefix's k, v (B, Sp, Hkv, D) into one layer's cache, in place."""
    Sp = k.shape[1]
    if Sp > cache_k.shape[1]:
        raise ValueError(f"prompt of {Sp} tokens does not fit a cache of "
                         f"{cache_k.shape[1]}")
    cache_k[:, :Sp] = k
    cache_v[:, :Sp] = v


def decode(p, cfg, run, x, cache_k, cache_v, pos: int):
    """One-token decode. x: (B, 1, M); ``pos`` tokens are already cached.
    Writes the new k, v into slot ``pos`` of the layer's cache in place."""
    S = cache_k.shape[1]
    if not 0 <= pos < S:
        raise ValueError(f"decode position {pos} outside a cache of {S}")
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(p, cfg, x, positions)
    cache_k[:, pos] = k_new[:, 0]
    cache_v[:, pos] = v_new[:, 0]
    idx = torch.arange(S, dtype=torch.int32, device=x.device)
    kv_positions = torch.where(idx <= pos, idx, _FAR_FUTURE)
    o = modules.naive_attention(q, cache_k, cache_v, q_positions=positions,
                                kv_positions=kv_positions, causal=True)
    return _out(p, o)
