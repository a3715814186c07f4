"""The CUDA kernels (flash attention, RG-LRU scan, WKV6) against their plain
versions, on the card.

Needs an NVIDIA card and nvcc; skips elsewhere.  It imports no JAX, so it
runs on a machine without it:

  python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.rglru.ops import linear_scan
from repro_torch.kernels.rglru.ref import linear_scan_ref
from repro_torch.kernels.rwkv6 import ops as wkv6_ops
from repro_torch.kernels.rwkv6.ops import wkv6
from repro_torch.kernels.rwkv6.ref import wkv6_ref
from repro_torch.testing import (KERNEL_CHECK_SHAPES, RGLRU_CHECK_SHAPES, TOL,
                                 WKV6_CHECK_SHAPES, attention_inputs, scan_inputs,
                                 wkv_inputs)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("shape", KERNEL_CHECK_SHAPES, ids=str)
def test_kernel_matches_plain_version(cuda, shape):
    window, dtype = shape[6], shape[7]
    q, k, v = attention_inputs(shape, device=cuda)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = attention_ref(q, k, v, causal=True, window=window)
    assert out.dtype == q.dtype and out.shape == q.shape
    assert torch.isfinite(out.float()).all()
    err = (out.float() - ref.float()).abs().max().item()
    assert err < TOL["flash_f32" if dtype == "float32" else "flash_bf16"], err


@pytest.mark.parametrize("D", [32, 256])
@pytest.mark.parametrize("Sq,Skv", [(70, 130), (130, 70)])
@pytest.mark.parametrize("window", [None, 8])
def test_kernel_without_causal_mask_matches_plain_version(cuda, Sq, Skv, window, D):
    """(130, 70) with a window has rows with no live key."""
    q, k, v = attention_inputs((2, Sq, Skv, 4, 2, D, window, "float32"), device=cuda)
    out = flash_attention(q, k, v, causal=False, window=window)
    ref = attention_ref(q, k, v, causal=False, window=window)
    assert (out - ref).abs().max().item() < TOL["flash_f32"]


# the check shapes of every (type, padded head dim), small enough to repeat
# for each tile variant
VARIANT_SHAPES = [s for s in KERNEL_CHECK_SHAPES if s[0] * s[1] * s[2] * s[3] <= 2_000_000]


@pytest.mark.parametrize("shape", VARIANT_SHAPES, ids=str)
def test_every_tile_variant_matches_plain_version(cuda, shape):
    """Every variant the variant library holds for the shape's type and head
    dim, not only the default that flash_attention launches; none counts a
    launch."""
    window, dtype = shape[6], shape[7]
    q, k, v = attention_inputs(shape, device=cuda)
    ref = attention_ref(q, k, v, causal=True, window=window).float()
    dp = next(p for p in (32, 64, 128, 256) if shape[5] <= p)
    mine = [w for w in flash_ops.variants()
            if w["bf16"] == (dtype == "bfloat16") and w["dp"] == dp]
    assert sum(w["default"] for w in mine) == 1
    before = flash_attention.launches
    for w in mine:
        out = flash_ops.launch_variant(w["index"], q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        err = (out.float() - ref).abs().max().item()
        assert err < TOL["flash_f32" if dtype == "float32" else "flash_bf16"], (w, err)
    assert flash_attention.launches == before


def test_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = attention_inputs(KERNEL_CHECK_SHAPES[0], device=cuda)
    with pytest.raises(ValueError):
        flash_attention(q.transpose(1, 2), k, v)
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        flash_attention(q, k, v, window=0)


@pytest.mark.parametrize("shape", RGLRU_CHECK_SHAPES, ids=str)
def test_scan_kernel_matches_plain_version(cuda, shape):
    a, b, h0 = scan_inputs(shape, device=cuda)
    before = linear_scan.launches
    y, hT = linear_scan(a, b, h0)
    torch.cuda.synchronize()
    assert linear_scan.launches == before + 1
    ry, rhT = linear_scan_ref(a, b, h0)
    assert y.shape == a.shape and hT.shape == h0.shape and y.dtype == torch.float32
    assert torch.isfinite(y).all() and torch.isfinite(hT).all()
    assert (y - ry).abs().max().item() < TOL["rglru_f32"]
    assert (hT - rhT).abs().max().item() < TOL["rglru_f32"]


def test_scan_kernel_refuses_what_it_does_not_take(cuda):
    a, b, h0 = scan_inputs(RGLRU_CHECK_SHAPES[0], device=cuda)
    before = linear_scan.launches
    with pytest.raises(TypeError):
        linear_scan(a.bfloat16(), b.bfloat16(), h0.bfloat16())
    with pytest.raises(TypeError):
        linear_scan(a, b, h0.double())
    with pytest.raises(ValueError):
        linear_scan(a.transpose(1, 2), b, h0)
    with pytest.raises(ValueError):
        linear_scan(a, b, h0.cpu())
    assert linear_scan.launches == before


@pytest.mark.parametrize("shape", WKV6_CHECK_SHAPES, ids=str)
def test_wkv6_kernel_matches_plain_version(cuda, shape):
    r, k, v, logw, u, s0 = wkv_inputs(shape, device=cuda)
    before = wkv6.launches
    y, sT = wkv6(r, k, v, logw, u, s0)
    torch.cuda.synchronize()
    assert wkv6.launches == before + 1
    ry, rsT = wkv6_ref(r, k, v, logw, u, s0)
    assert y.shape == r.shape and sT.shape == s0.shape
    assert y.dtype == sT.dtype == torch.float32
    assert torch.isfinite(y).all() and torch.isfinite(sT).all()
    assert (y - ry).abs().max().item() < TOL["wkv6"]
    assert (sT - rsT).abs().max().item() < TOL["wkv6"]


@pytest.mark.parametrize("seq_major", [False, True])
@pytest.mark.parametrize("col_split", [1, 2, 4])
@pytest.mark.parametrize("shape", [WKV6_CHECK_SHAPES[4], WKV6_CHECK_SHAPES[6]], ids=str)
def test_wkv6_kernel_layouts_and_column_splits(cuda, shape, col_split, seq_major):
    """The model's (B, S, H, N) layout, and every column split the kernel
    builds at N = 64, against the plain version."""
    r, k, v, logw, u, s0 = wkv_inputs(shape, device=cuda, seq_major=seq_major)
    y, sT = wkv6_ops.launch(r, k, v, logw, u, s0, col_split=col_split)
    ry, rsT = wkv6_ref(r, k, v, logw, u, s0)
    assert y.stride() == r.stride()
    assert (y - ry).abs().max().item() < TOL["wkv6"]
    assert (sT - rsT).abs().max().item() < TOL["wkv6"]


def test_wkv6_kernel_refuses_what_it_does_not_take(cuda):
    r, k, v, logw, u, s0 = wkv_inputs(WKV6_CHECK_SHAPES[0], device=cuda)
    before = wkv6.launches
    with pytest.raises(TypeError):
        wkv6(r.half(), k.half(), v.half(), logw, u, s0)
    with pytest.raises(TypeError):
        wkv6(r, k, v, logw.bfloat16(), u, s0)
    with pytest.raises(ValueError):
        wkv6(r.transpose(2, 3), k, v, logw, u, s0)
    with pytest.raises(ValueError):
        wkv6(r, k, v, logw, u, s0.cpu())
    with pytest.raises(ValueError, match="head size"):
        n = (1, 1, 4, 12)
        z = torch.zeros(n, device=cuda)
        wkv6(z, z, z, z, torch.zeros(1, 12, device=cuda), torch.zeros(1, 1, 12, 12, device=cuda))
    assert wkv6.launches == before
