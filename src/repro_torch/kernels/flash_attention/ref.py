"""Plain PyTorch version of the flash-attention kernel: its test oracle and
its path on CPU tensors."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal=True, window=None):
    """q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D).  Positions are aligned at
    the top left (row i is position i); everything is computed in f32."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = D ** -0.5
    qg = q.permute(0, 2, 1, 3).reshape(B, Hkv, G, Sq, D).float()
    kg = k.permute(0, 2, 1, 3).float()
    vg = v.permute(0, 2, 1, 3).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kg) * scale
    qp = torch.arange(Sq, device=q.device)
    kp = torch.arange(Skv, device=q.device)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp[None, :] <= qp[:, None]
    if window is not None:
        mask &= (qp[:, None] - kp[None, :]) < window
    s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, vg)
    return o.reshape(B, Hq, Sq, D).permute(0, 2, 1, 3).to(v.dtype)
