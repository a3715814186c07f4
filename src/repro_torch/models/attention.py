"""GQA attention block with rope, an optional sliding window, and a full
or ring KV cache.

  * prefill / full forward -> the CUDA flash-attention kernel when
    ``run.use_pallas`` (its plain version on a CPU tensor), else the plain
    version ``attention_ref``;
  * decode -> ``naive_attention`` over the cache (Sq == 1, linear cost);
  * windowed layers keep a ring buffer of ``min(max_seq, window)`` slots.

The cache is updated in place: one preallocated buffer per layer, where the
JAX package returns an updated copy.
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


def apply(p, cfg, run, x, positions, window=None):
    """Full-sequence forward (prefill, logits). x: (B, S, M); positions are
    ``arange(S)``.  Returns (y, k, v) so that prefill fills the cache without
    projecting k and v a second time."""
    q, k, v = _project_qkv(p, cfg, x, positions)
    attend = flash_attention if run.use_pallas else attention_ref
    o = attend(q, k, v, causal=True, window=window)
    return _out(p, o), k, v


def cache_len(max_seq: int, window=None) -> int:
    """Slots of one layer's cache: a ring of ``window`` slots when that is
    shorter than ``max_seq``."""
    return min(max_seq, window) if window else max_seq


def init_cache(cfg, batch, max_seq, dtype, device, window=None):
    """One layer's KV cache: k, v each (B, cache_len, Hkv, D)."""
    shape = (batch, cache_len(max_seq, window), cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def prefill_cache(cache, k, v, window=None):
    """Write a prefix's k, v (B, Sp, Hkv, D) into one layer's cache, in place.

    In a ring cache (``window``) a prefix that fills it leaves its last S
    tokens, rolled so that absolute position p sits in slot ``p % S``, the
    invariant ``decode`` keeps.  A full cache refuses a prefix longer than it.
    """
    S, Sp = cache["k"].shape[1], k.shape[1]
    if not window and Sp > S:
        raise ValueError(f"prompt of {Sp} tokens does not fit a cache of {S}")
    if Sp >= S:
        k_keep, v_keep = k[:, -S:], v[:, -S:]
        if window:
            shift = Sp % S
            k_keep = torch.roll(k_keep, shift, dims=1)
            v_keep = torch.roll(v_keep, shift, dims=1)
        cache["k"].copy_(k_keep)
        cache["v"].copy_(v_keep)
    else:
        cache["k"][:, :Sp] = k
        cache["v"][:, :Sp] = v


def _ring_positions(S: int, pos: int, device) -> torch.Tensor:
    """Absolute position held by each slot of a ring of S slots once token
    ``pos`` is written at ``pos % S``; slots not written yet get a far-future
    position that the causal mask drops."""
    idx = torch.arange(S, dtype=torch.int32, device=device)
    slot, base = pos % S, (pos // S) * S
    abs_pos = idx + torch.where(idx <= slot, base, base - S)
    # before the first wrap the slots past ``pos`` come out negative
    return torch.where(abs_pos < 0, _FAR_FUTURE, abs_pos).to(torch.int32)


def decode(p, cfg, run, x, cache, pos: int, window=None):
    """One-token decode. x: (B, 1, M); ``pos`` tokens are already cached.
    Writes the new k, v into slot ``pos`` (``pos % S`` in a ring cache) of the
    layer's cache in place."""
    S = cache["k"].shape[1]
    if pos < 0 or (not window and pos >= S):
        raise ValueError(f"decode position {pos} outside a cache of {S}")
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(p, cfg, x, positions)
    slot = pos % S if window else pos
    cache["k"][:, slot] = k_new[:, 0]
    cache["v"][:, slot] = v_new[:, 0]
    if window:
        kv_positions = _ring_positions(S, pos, x.device)
    else:
        idx = torch.arange(S, dtype=torch.int32, device=x.device)
        kv_positions = torch.where(idx <= pos, idx, _FAR_FUTURE)
    o = modules.naive_attention(q, cache["k"], cache["v"], q_positions=positions,
                                kv_positions=kv_positions, causal=True,
                                window=window)
    return _out(p, o)
