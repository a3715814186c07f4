"""Helpers for holding the port against the JAX package: numpy <-> torch and
the tolerance table.

Arrays cross between the two frameworks as numpy arrays (``np.asarray`` of a
JAX array needs no JAX import here).  bf16 crosses as f32 values rounded to
bf16 on each side, which gives both the same bf16 inputs.
"""
from __future__ import annotations

import numpy as np
import torch

# max abs error allowed between the port and the JAX package, and why
TOL = {
    # the flash kernel bar of tests/test_kernels.py: f32 sums in another order;
    # bf16 outputs round once, at most one bf16 ulp apart
    "flash_f32": 5e-6,
    "flash_bf16": 2e-2,
    # single f32 modules: the same arithmetic up to summation order
    "module_f32": 1e-6,
    # smoke-model logits and decode steps, the tests/test_decode.py bar
    "logits_f32": 1e-4,
    # the RG-LRU scan bar of tests/test_kernels.py, on y and h_T: f32 FMAs
    # against separate multiply and add, errors damped by |a| < 1
    "rglru_f32": 1e-5,
}

# (B, Sq, Skv, Hq, Hkv, D, window, dtype) at which the CUDA kernel is held
# against its plain version on the card
KERNEL_CHECK_SHAPES = (
    # the flash shapes of tests/test_kernels.py
    (2, 64, 64, 4, 2, 16, None, "float32"),
    (1, 100, 100, 6, 2, 32, None, "float32"),
    (2, 128, 128, 4, 1, 16, 32, "float32"),
    (1, 64, 64, 4, 4, 16, None, "bfloat16"),
    (1, 48, 48, 8, 2, 8, 16, "bfloat16"),
    # the smoke config's head_dim
    (2, 21, 21, 3, 1, 20, None, "float32"),
    # smollm-360m prefill: the serving run's shape, then the slice's own shape
    (4, 256, 256, 15, 5, 64, None, "float32"),
    (4, 512, 512, 15, 5, 64, None, "float32"),
    (4, 512, 512, 15, 5, 64, 128, "float32"),
    (4, 512, 512, 15, 5, 64, None, "bfloat16"),
    (4, 512, 512, 15, 5, 64, 128, "bfloat16"),
    # Sq != Skv, with rows that have no live key; the head dims 128 and 256
    (1, 100, 37, 6, 2, 32, 16, "float32"),
    (2, 70, 130, 4, 2, 128, None, "bfloat16"),
    # head_dim 256: recurrentgemma-2b's prefill (MQA, window 2048, a prompt
    # past the window), a bf16 windowed shape, and head_dim 200 padded to 256
    # with Sq > Skv and rows that have no live key
    (4, 2112, 2112, 10, 1, 256, 2048, "float32"),
    (2, 300, 300, 10, 1, 256, 128, "bfloat16"),
    (1, 130, 70, 4, 2, 200, 32, "float32"),
)

# (B, S, D) at which the CUDA RG-LRU scan is held against its plain version
# on the card, all from a nonzero h0
RGLRU_CHECK_SHAPES = (
    # the scan shapes of tests/test_kernels.py
    (2, 37, 16),
    (1, 64, 40),
    (2, 100, 24),
    (1, 17, 8),
    # one step, and recurrentgemma-2b's prefill
    (3, 1, 2560),
    (4, 2112, 2560),
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def to_torch(a, dtype: str = "float32", device="cpu") -> torch.Tensor:
    """numpy (or array-like) -> torch tensor of ``dtype`` on ``device``."""
    a = np.asarray(a)
    if a.dtype.kind in "iu":
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    return t.to(device=device, dtype=_DTYPES[dtype])


def to_numpy(x) -> np.ndarray:
    """torch tensor or JAX/numpy array -> numpy; floats widen to f32."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.is_floating_point() else x).numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.kind == "f" or a.dtype.name == "bfloat16" else a


def attention_inputs(shape, seed: int = 0, device="cpu"):
    """Seeded q, k, v for one ``KERNEL_CHECK_SHAPES`` entry."""
    B, Sq, Skv, Hq, Hkv, D, _, dtype = shape
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, Hq, D), dtype=np.float32)
    k = rng.standard_normal((B, Skv, Hkv, D), dtype=np.float32)
    v = rng.standard_normal((B, Skv, Hkv, D), dtype=np.float32)
    return tuple(to_torch(a, dtype, device) for a in (q, k, v))


def scan_inputs(shape, seed: int = 0, device="cpu"):
    """Seeded a in (0, 1), b and a nonzero h0 (all f32) for one
    ``RGLRU_CHECK_SHAPES`` entry, drawn as tests/test_kernels.py draws them."""
    B, S, D = shape
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, D), dtype=np.float32)))
    b = rng.standard_normal((B, S, D), dtype=np.float32)
    h0 = rng.standard_normal((B, D), dtype=np.float32)
    return tuple(to_torch(x, "float32", device) for x in (a, b, h0))


def max_abs_diff(a, b) -> float:
    return float(np.max(np.abs(to_numpy(a).astype(np.float64)
                               - to_numpy(b).astype(np.float64))))
