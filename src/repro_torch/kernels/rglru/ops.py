"""Wrapper of the CUDA RG-LRU scan kernel (``csrc/rglru_scan.cu``).

On a CUDA tensor it launches the kernel or raises; on a CPU tensor it runs
the plain version, ``linear_scan_ref``.  ``linear_scan.launches`` counts
kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build as nvcc_build
from repro_torch.kernels.rglru.ref import linear_scan_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "rglru_scan.cu"
_P, _I32 = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "rglru_scan": (_I32, [_P, _P, _P, _P, _P, _I32, _I32, _I32, _P]),
    "rglru_scan_error_string": (ctypes.c_char_p, [_I32]),
}


def _check(a, b, h0):
    for name, t in (("a", a), ("b", b), ("h0", h0)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} dtype {t.dtype} not supported; the scan takes float32")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not (a.device == b.device == h0.device):
        raise ValueError(f"a, b, h0 devices differ: {a.device}, {b.device}, {h0.device}")
    if a.dim() != 3 or b.shape != a.shape or h0.shape != (a.shape[0], a.shape[2]):
        raise ValueError(f"shapes do not match: a {tuple(a.shape)}, b {tuple(b.shape)}, "
                         f"h0 {tuple(h0.shape)}; need (B, S, D), (B, S, D), (B, D)")
    if min(a.shape) < 1:
        raise ValueError(f"need non-empty shapes: a {tuple(a.shape)}")


def library() -> ctypes.CDLL:
    """The kernel's library, built from ``SOURCE`` at first use."""
    return nvcc_build.load(SOURCE, _SIGNATURES)


def linear_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """a, b: (B, S, D) f32; h0: (B, D) f32 -> (y (B, S, D), h_T (B, D)), f32.

    Same contract as the JAX package's ``linear_scan``: ``h_t = a_t h_{t-1}
    + b_t`` per channel from ``h0``; y holds every h_t.
    """
    _check(a, b, h0)
    if a.device.type == "cpu":
        return linear_scan_ref(a, b, h0)
    if a.device.type != "cuda":
        raise ValueError(f"linear_scan runs on cuda or cpu, not {a.device}")
    lib = library()
    B, S, D = a.shape
    y = torch.empty_like(a)
    hT = torch.empty_like(h0)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.rglru_scan(a.data_ptr(), b.data_ptr(), h0.data_ptr(), y.data_ptr(),
                             hT.data_ptr(), B, S, D, stream)
    if err:
        msg = lib.rglru_scan_error_string(err).decode()
        raise RuntimeError(f"rglru_scan launch failed: CUDA error {err} ({msg})")
    linear_scan.launches += 1
    return y, hT


linear_scan.launches = 0
