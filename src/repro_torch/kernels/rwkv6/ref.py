"""Plain PyTorch version of the WKV6 kernel: its test oracle and its path on
CPU tensors.

    S_t = diag(exp(logw_t)) S_{t-1} + k_t v_t^T
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
"""
from __future__ import annotations

import torch


def wkv6_ref(r, k, v, logw, u, state0):
    """r, k, v, logw: (B, H, S, N); u: (H, N); state0: (B, H, N, N).  The
    per-token recurrence in f32 from ``state0``.  Returns (y (B, H, S, N)
    f32, state (B, H, N, N) f32)."""
    r32, k32, v32 = r.float(), k.float(), v.float()
    w = torch.exp(logw.float())
    u32 = u.float()[None, :, :, None]
    state = state0.float()
    y = torch.empty_like(r32)
    for t in range(r.shape[2]):
        kv = k32[:, :, t, :, None] * v32[:, :, t, None, :]          # (B, H, N, N)
        y[:, :, t] = torch.einsum("bhi,bhin->bhn", r32[:, :, t], state + u32 * kv)
        state = w[:, :, t, :, None] * state + kv
    return y, state
