"""Plain PyTorch version of the RG-LRU scan kernel: its test oracle and its
path on CPU tensors."""
from __future__ import annotations

import torch


def linear_scan_ref(a, b, h0):
    """a, b: (B, S, D); h0: (B, D).  The sequential recurrence
    ``h_t = a_t * h_{t-1} + b_t`` in f32 from ``h0``.  Returns
    (y (B, S, D) f32, h_T (B, D) f32)."""
    a32, b32 = a.float(), b.float()
    h = h0.float()
    y = torch.empty_like(a32)
    for t in range(a.shape[1]):
        h = a32[:, t] * h + b32[:, t]
        y[:, t] = h
    return y, h
