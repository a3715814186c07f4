"""Wrapper of the CUDA WKV6 kernel (``csrc/wkv6.cu``).

On a CUDA tensor it launches the kernel or raises; on a CPU tensor it runs
the plain version, ``wkv6_ref``.  ``wkv6.launches`` counts kernel launches
and nothing else.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import build as nvcc_build
from repro_torch.kernels.rwkv6.ref import wkv6_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "wkv6.cu"
_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "wkv6": (_I32, [_P, _P, _P, _P, _P, _P, _P, _P, _I32, _I32, _I32, _I32, _I32,
                    _I64, _I64, _I64, _I32, _P]),
    "wkv6_error_string": (ctypes.c_char_p, [_I32]),
}

_STREAM_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (8, 16, 32, 64)     # the kernel's templates
COL_SPLITS = {8: (1,), 16: (1,), 32: (1,), 64: (1, 2, 4)}   # blocks per head


def _strides(t):
    """(sB, sH, sS) of a (B, H, S, N) stream, in elements, with the stride of
    a size-1 dimension taken as 0; None unless the stream is a contiguous
    (B, H, S, N) or the (1, 2) transpose of a contiguous (B, S, H, N), the
    layout the model's heads have."""
    if not (t.is_contiguous() or t.transpose(1, 2).is_contiguous()):
        return None
    return tuple(st if n > 1 else 0 for st, n in zip(t.stride()[:3], t.shape[:3]))


def _check(r, k, v, logw, u, state0):
    for name, t in (("r", r), ("k", k), ("v", v)):
        if t.dtype not in _STREAM_DTYPES:
            raise TypeError(f"{name} dtype {t.dtype} not supported; use float32 or bfloat16")
    if not (r.dtype == k.dtype == v.dtype):
        raise TypeError(f"r, k, v dtypes differ: {r.dtype}, {k.dtype}, {v.dtype}")
    tensors = (("r", r), ("k", k), ("v", v), ("logw", logw), ("u", u), ("state0", state0))
    for name, t in tensors[3:]:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} dtype {t.dtype} not supported; {name} is float32")
    for name, t in tensors[:4]:
        if t.dim() == 4 and _strides(t) is None:
            raise ValueError(f"{name} must be a contiguous (B, H, S, N) or the (1, 2) "
                             f"transpose of a contiguous (B, S, H, N)")
    for name, t in tensors[4:]:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if len({t.device for _, t in tensors}) != 1:
        raise ValueError(f"devices differ: {[str(t.device) for _, t in tensors]}")
    if r.device.type not in ("cpu", "cuda"):
        raise ValueError(f"wkv6 runs on cuda or cpu, not {r.device}")
    if r.dim() != 4 or min(r.shape) < 1:
        raise ValueError(f"r must be a non-empty (B, H, S, N); got {tuple(r.shape)}")
    B, H, _, N = r.shape
    if not (k.shape == v.shape == logw.shape == r.shape) or u.shape != (H, N) \
            or state0.shape != (B, H, N, N):
        raise ValueError(f"shapes do not match: r {tuple(r.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, logw {tuple(logw.shape)}, u {tuple(u.shape)}, "
                         f"state0 {tuple(state0.shape)}; need (B, H, S, N) x 4, (H, N), "
                         f"(B, H, N, N)")
    if len({_strides(t) for _, t in tensors[:4]}) != 1:
        raise ValueError("r, k, v and logw must share one layout; got strides "
                         f"{[t.stride() for _, t in tensors[:4]]}")


def library() -> ctypes.CDLL:
    """The kernel's library, built from ``SOURCE`` at first use."""
    return nvcc_build.load(SOURCE, _SIGNATURES)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
         u: torch.Tensor, state0: torch.Tensor):
    """r, k, v: (B, H, S, N) f32 or bf16; logw: (B, H, S, N) f32; u: (H, N)
    f32; state0: (B, H, N, N) f32 -> (y (B, H, S, N), state (B, H, N, N)),
    both f32.

    Same contract as the JAX package's ``wkv6``: the RWKV-6 recurrence from
    ``state0`` with per-channel decay ``exp(logw)`` and bonus ``u``.  The four
    streams may also be the (1, 2) transpose of contiguous (B, S, H, N)
    tensors, as the model's heads are; y then comes in that layout too.
    """
    _check(r, k, v, logw, u, state0)
    if r.device.type == "cpu":
        return wkv6_ref(r, k, v, logw, u, state0)
    B, H, _, N = r.shape
    return _launch(r, k, v, logw, u, state0, col_split(B * H, N, _sms(r.device)))


def launch(r, k, v, logw, u, state0, col_split: int):
    """The kernel with ``col_split`` blocks per (b, h) instead of the split
    ``wkv6`` picks, on CUDA tensors: for timing and testing every split."""
    _check(r, k, v, logw, u, state0)
    if r.device.type != "cuda":
        raise ValueError(f"the wkv6 kernel runs on cuda, not {r.device}")
    return _launch(r, k, v, logw, u, state0, col_split)


def col_split(pairs: int, N: int, sms: int) -> int:
    """Blocks per (b, h): the largest split the kernel takes at N that puts
    at most two blocks (four warps, one per scheduler) on each of ``sms``
    SMs.  A block's time is its serial step chain, which a split shortens,
    but an SM with more than four of the kernel's warps shares a
    scheduler's issue between them and is slower than the chain."""
    fits = [cs for cs in COL_SPLITS.get(N, (1,)) if pairs * cs <= 2 * sms]
    return max(fits, default=1)


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch(r, k, v, logw, u, state0, col_split: int):
    B, H, S, N = r.shape
    if N not in HEAD_DIMS:
        raise ValueError(f"head size {N} not supported by the kernel; it takes {HEAD_DIMS}")
    if col_split not in COL_SPLITS[N]:
        raise ValueError(f"col_split {col_split} not supported at N = {N}; "
                         f"it takes {COL_SPLITS[N]}")
    for name, t in (("r", r), ("k", k), ("v", v), ("logw", logw)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for the kernel's copies")
    lib = library()
    y = torch.empty_strided(r.shape, r.stride(), dtype=torch.float32, device=r.device)
    state = torch.empty_like(state0)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.wkv6(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
                       u.data_ptr(), state0.data_ptr(), y.data_ptr(), state.data_ptr(),
                       int(r.dtype == torch.bfloat16), B, H, S, N, *_strides(r),
                       col_split, stream)
    if err:
        msg = lib.wkv6_error_string(err).decode()
        raise RuntimeError(f"wkv6 launch failed: CUDA error {err} ({msg})")
    wkv6.launches += 1
    return y, state


wkv6.launches = 0
