"""Wrapper of the CUDA flash-attention forward kernel (``csrc/flash_fwd.cu``).

On a CUDA tensor it launches the kernel or raises; on a CPU tensor it runs
the plain version, ``attention_ref``.  ``flash_attention.launches`` counts
kernel launches and nothing else.  ``variants`` and ``launch_variant`` run
the kernel's other tile shapes, for ``bench.py`` and the card tests, from a
second library built with ``-DFLASH_BENCH_VARIANTS``; the serving library
holds only the default tiles.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build as nvcc_build
from repro_torch.kernels.flash_attention.ref import attention_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_fwd.cu"
_P, _I32 = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "flash_fwd": (_I32, [_P, _P, _P, _P, _I32, _I32, _I32, _I32, _I32, _I32,
                         _I32, _I32, _I32, ctypes.c_float, _P]),
    "flash_fwd_error_string": (ctypes.c_char_p, [_I32]),
}
VARIANT_FLAGS = ("-DFLASH_BENCH_VARIANTS",)
_VARIANT_SIGNATURES = {
    **_SIGNATURES,
    "flash_fwd_variant": (_I32, [_I32, _P, _P, _P, _P, _I32, _I32, _I32, _I32, _I32,
                                 _I32, _I32, _I32, _I32, ctypes.c_float, _P]),
    "flash_fwd_variant_count": (_I32, []),
    "flash_fwd_variant_info": (_I32, [_I32, ctypes.POINTER(_I32)]),
}
_VARIANT_FIELDS = ("bf16", "dp", "warps", "bkv", "dsplit", "qsplit", "default",
                   "smem_bytes")

_DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256


def _check(q, k, v, window):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D (B, S, H, D); got {tuple(t.shape)}")
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name} dtype {t.dtype} not supported; use float32 or bfloat16")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v devices differ: {q.device}, {k.device}, {v.device}")
    B, Sq, Hq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"shapes do not match: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    Skv, Hkv = k.shape[1], k.shape[2]
    if min(B, Sq, Skv, Hkv, D) < 1 or Hq % Hkv:
        raise ValueError(f"need non-empty shapes and Hq % Hkv == 0: "
                         f"q {tuple(q.shape)}, k {tuple(k.shape)}")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {D} > {MAX_HEAD_DIM} is not supported by the kernel")
    if window is not None and (isinstance(window, bool) or not isinstance(window, int)
                               or window < 1):
        raise ValueError(f"window must be None or an int >= 1; got {window!r}")


def library() -> ctypes.CDLL:
    """The kernel's library, built from ``SOURCE`` at first use."""
    return nvcc_build.load(SOURCE, _SIGNATURES)


def variant_library() -> ctypes.CDLL:
    """The library with every tile variant, built with ``VARIANT_FLAGS``."""
    return nvcc_build.load(SOURCE, _VARIANT_SIGNATURES, VARIANT_FLAGS)


def _run(fn, lib, q, k, v, causal, window, *lead) -> torch.Tensor:
    """Launch ``fn`` (``flash_fwd`` or ``flash_fwd_variant`` with ``lead``
    arguments) on CUDA tensors checked by ``_check``; raise on its error."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*lead, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 int(q.dtype == torch.bfloat16), B, Sq, Skv, Hq, Hkv, D,
                 int(causal), window or 0, D ** -0.5, stream)
    if err:
        msg = lib.flash_fwd_error_string(err).decode()
        raise RuntimeError(f"flash_fwd launch failed: CUDA error {err} ({msg})")
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window=None) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) -> (B, Sq, Hq, D) in q's dtype.

    Same contract as the JAX package's ``flash_attention``: top-left aligned
    causal mask, optional sliding window, f32 softmax.
    """
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    lib = library()
    out = _run(lib.flash_fwd, lib, q, k, v, causal, window)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def variants() -> list:
    """Every tile variant of ``variant_library()``, as dicts of
    ``_VARIANT_FIELDS`` plus ``index``; the default of each (type, DP) is
    the one ``flash_attention`` launches."""
    lib = variant_library()
    out = []
    for i in range(lib.flash_fwd_variant_count()):
        info = (_I32 * len(_VARIANT_FIELDS))()
        if lib.flash_fwd_variant_info(i, info):
            raise RuntimeError(f"flash_fwd_variant_info({i}) failed")
        out.append({"index": i, **dict(zip(_VARIANT_FIELDS, info))})
    return out


def launch_variant(index: int, q, k, v, *, causal: bool = True, window=None):
    """Run tile variant ``index`` of ``variants()`` on CUDA tensors; it must
    be of q's type and padded head dim.  Not counted in
    ``flash_attention.launches``."""
    _check(q, k, v, window)
    if q.device.type != "cuda":
        raise ValueError(f"launch_variant runs on cuda, not {q.device}")
    lib = variant_library()
    return _run(lib.flash_fwd_variant, lib, q, k, v, causal, window, index)
