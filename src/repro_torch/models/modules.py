"""Shared building blocks: RMS norm, rotary embedding, naive attention.

Plain functions on tensors with the JAX package's layouts: activations are
``(B, S, M)``, heads ``(B, S, H, D)``.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm in f32 with a ``(1 + scale)`` gain, cast back to ``x.dtype``."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """positions: int tensor (...,) -> (cos, sin) of shape (..., head_dim//2)."""
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32,
                            device=positions.device) / half
    freq = 1.0 / (theta ** exponent)
    ang = positions.float()[..., None] * freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Half-split rotary embedding.  x: (B, S, H, D); cos/sin: (S, D//2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[None, :, None, :].to(x.dtype)
    s = sin[None, :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def naive_attention(q, k, v, *, q_positions, kv_positions, causal=True,
                    window=None):
    """O(S^2)-memory GQA attention; the decode path (Sq tiny).

    q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D); positions are 1-D, shared
    across the batch.  Scores are taken in f32 as the JAX package does.
    """
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    scale = D ** -0.5
    qg = q.permute(0, 2, 1, 3).reshape(B, Hkv, G, Sq, D)
    kg = k.permute(0, 2, 1, 3)
    vg = v.permute(0, 2, 1, 3)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), kg.float()) * scale
    mask = torch.ones((Sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kv_positions[None, :] <= q_positions[:, None]
    if window is not None:
        mask &= (q_positions[:, None] - kv_positions[None, :]) < window
    bias = torch.zeros(mask.shape, dtype=torch.float32, device=q.device)
    s = s + bias.masked_fill_(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1).to(vg.dtype)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, vg)
    return o.reshape(B, Hq, Sq, D).permute(0, 2, 1, 3).to(v.dtype)
