"""The port's flash-attention plain version and CPU wrapper path vs the JAX
package's Pallas kernel (interpret mode) and its oracle."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.testing import TOL, max_abs_diff, to_torch

# tests/test_kernels.py's flash shapes, plus the smoke config's head_dim 20
SHAPES = [
    (2, 64, 4, 2, 16, None, 16, 16, "float32"),
    (1, 100, 6, 2, 32, None, 32, 16, "float32"),
    (2, 128, 4, 1, 16, 32, 32, 32, "float32"),
    (1, 64, 4, 4, 16, None, 16, 16, "bfloat16"),
    (1, 48, 8, 2, 8, 16, 16, 8, "bfloat16"),
    (2, 21, 3, 1, 20, None, 8, 8, "float32"),
]


def _inputs(B, Sq, Skv, Hq, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, Hq, D), dtype=np.float32),
            rng.standard_normal((B, Skv, Hkv, D), dtype=np.float32),
            rng.standard_normal((B, Skv, Hkv, D), dtype=np.float32))


@pytest.mark.parametrize("B,S,Hq,Hkv,D,win,bq,bkv,dtype", SHAPES)
def test_attention_ref_matches_jax(B, S, Hq, Hkv, D, win, bq, bkv, dtype):
    arrays = _inputs(B, S, S, Hq, Hkv, D)
    jq, jk, jv = (jnp.asarray(a, dtype=dtype) for a in arrays)
    tq, tk, tv = (to_torch(a, dtype) for a in arrays)
    out = attention_ref(tq, tk, tv, causal=True, window=win)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    tol = TOL["flash_f32" if dtype == "float32" else "flash_bf16"]
    kernel = jax_flash(jq, jk, jv, causal=True, window=win, block_q=bq,
                       block_kv=bkv, interpret=True)
    assert max_abs_diff(out, kernel) < tol
    assert max_abs_diff(out, jax_ref(jq, jk, jv, causal=True, window=win)) < tol
    # on a CPU tensor the wrapper is the plain version, launched no kernel
    before = flash_attention.launches
    assert torch.equal(flash_attention(tq, tk, tv, causal=True, window=win), out)
    assert flash_attention.launches == before


@pytest.mark.parametrize("Sq,Skv,win,causal", [(40, 64, None, True), (100, 37, 16, True),
                                              (64, 24, 8, True), (33, 50, None, False),
                                              (33, 50, 8, False)])
def test_attention_ref_ragged_matches_jax(Sq, Skv, win, causal):
    """Sq != Skv, top-left aligned; (100, 37, 16) and (64, 24, 8) have rows
    with no live key, which take the uniform average over all keys."""
    arrays = _inputs(1, Sq, Skv, 4, 2, 16, seed=1)
    out = attention_ref(*(to_torch(a) for a in arrays), causal=causal, window=win)
    ref = jax_ref(*(jnp.asarray(a) for a in arrays), causal=causal, window=win)
    assert max_abs_diff(out, ref) < TOL["flash_f32"]


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q, k, v = (to_torch(a) for a in _inputs(1, 16, 16, 4, 2, 16))
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2), k, v)
    with pytest.raises(TypeError):
        flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(TypeError):
        flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="Hq % Hkv"):
        flash_attention(q[:, :, :3].contiguous(), k, v)
    with pytest.raises(ValueError, match="head_dim"):
        big = torch.zeros(1, 4, 2, 257)
        flash_attention(big, big, big)
    widest = torch.zeros(1, 4, 2, 256)          # the kernel's widest head dim
    assert flash_attention(widest, widest, widest).shape == widest.shape
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, k, v, window=0)
    with pytest.raises(ValueError, match="shapes"):
        flash_attention(q, k, v[:, :8].contiguous())


def test_shared_builder_names_by_source_hash_and_loads_once(tmp_path, monkeypatch):
    """The library name follows the source's bytes; ``load`` builds and binds
    a source once per process and sets each signature it is given."""
    import ctypes
    import ctypes.util

    from repro_torch.kernels import build as nvcc_build

    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    first = nvcc_build.library_path(src)
    assert first.name.startswith("k-") and first.suffix == ".so"
    src.write_text("// two\n")
    assert nvcc_build.library_path(src) != first

    libc = ctypes.util.find_library("c")
    if libc is None:
        pytest.skip("no C library to stand in for a built kernel")
    calls = []
    monkeypatch.setattr(nvcc_build, "build",
                        lambda s: calls.append(s) or nvcc_build.Built(libc, 0.0, ""))
    monkeypatch.setattr(nvcc_build, "_LOADED", {})
    sig = {"strlen": (ctypes.c_size_t, [ctypes.c_char_p])}
    lib = nvcc_build.load(src, sig)
    assert nvcc_build.load(src, sig) is lib and calls == [src]
    assert lib.strlen(b"hopper") == 6
    assert lib.strlen.argtypes == [ctypes.c_char_p]
