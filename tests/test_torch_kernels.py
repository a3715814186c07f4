"""The port's flash-attention plain version and CPU wrapper path vs the JAX
package's Pallas kernel (interpret mode) and its oracle, and a plain
emulation of the CUDA kernel's 3xTF32 arithmetic."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro_torch import testing
from repro_torch.kernels.flash_attention.ops import flash_attention, launch_variant
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.testing import (KERNEL_CHECK_SHAPES, TOL, attention_inputs,
                                 attention_split_tf32, max_abs_diff, to_torch)

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
    monkeypatch.setattr(nvcc_build, "build", lambda s, flags=():
                        calls.append((s, flags)) or nvcc_build.Built(libc, 0.0, ""))
    monkeypatch.setattr(nvcc_build, "_LOADED", {})
    sig = {"strlen": (ctypes.c_size_t, [ctypes.c_char_p])}
    lib = nvcc_build.load(src, sig)
    assert nvcc_build.load(src, sig) is lib and calls == [(src, ())]
    assert lib.strlen(b"hopper") == 6
    assert lib.strlen.argtypes == [ctypes.c_char_p]


# f32 check shapes small enough for the CPU (the serving shapes are not)
SPLIT_SHAPES = [s for s in KERNEL_CHECK_SHAPES
                if s[7] == "float32" and s[0] * s[1] * s[2] * s[3] <= 2_000_000]


@pytest.mark.parametrize("shape", SPLIT_SHAPES, ids=str)
def test_split_tf32_emulation_meets_the_f32_bar(shape):
    """The kernel's f32 route, emulated: three TF32 products (lo*hi + hi*lo +
    hi*hi) hold the f32 bar against the JAX package's Pallas kernel (where
    Sq == Skv: it pads keys past Skv as masked keys, not absent ones), its
    oracle and attention_ref; plain TF32 (one product) misses it.  The
    emulation sums the products exactly: the tensor cores' truncated
    accumulation, and the short chains the kernel keeps against it, are
    checked only by the card tests (test_torch_cuda.py)."""
    B, Sq, Skv, Hq, Hkv, D, window, _ = shape
    q, k, v = attention_inputs(shape)
    three = attention_split_tf32(q, k, v, causal=True, window=window, terms=3)
    one = attention_split_tf32(q, k, v, causal=True, window=window, terms=1)
    jq, jk, jv = (jnp.asarray(t.numpy()) for t in (q, k, v))
    oracles = [attention_ref(q, k, v, causal=True, window=window),
               jax_ref(jq, jk, jv, causal=True, window=window)]
    if Sq == Skv:
        oracles.append(jax_flash(jq, jk, jv, causal=True, window=window, interpret=True))
    for oracle in oracles:
        assert max_abs_diff(three, oracle) < TOL["flash_f32"]
    assert max_abs_diff(one, oracles[0]) > TOL["flash_f32"]


def test_tf32_round_is_round_to_nearest_on_bit_13():
    ulp = 2.0 ** -10                      # TF32's spacing in [1, 2)
    x = torch.tensor([1.0, 1 + ulp / 4, 1 + ulp / 2, 1 + 3 * ulp / 4, -(1 + ulp / 2),
                      3.0, 1e-30, -2.5e8], dtype=torch.float32)
    r = testing.tf32_round(x)
    expect = torch.tensor([1.0, 1.0, 1 + ulp, 1 + ulp, -(1 + ulp), 3.0],
                          dtype=torch.float32)
    assert torch.equal(r[:6], expect)    # ties away from zero, as cvt.rna
    bits = r.view(torch.int32)
    assert torch.equal(bits & 0x1FFF, torch.zeros_like(bits))
    rng = np.random.default_rng(3)
    y = torch.from_numpy(rng.standard_normal(4096, dtype=np.float32) * 100)
    ry = testing.tf32_round(y)
    assert bool(((ry - y).abs() <= y.abs() * 2.0 ** -11).all())
    hi, lo = testing.split_tf32(y, 3)
    assert torch.equal(testing.tf32_round(lo), lo)
    assert float(((hi.double() + lo.double()) - y.double()).abs().max()) <= \
        float(y.abs().max()) * 2.0 ** -21


def test_pv_key_order_of_the_tf32_fragments_leaves_pv_unchanged():
    """Lane t of a quad holds keys 2t and 2t + 1 of an 8-key step in P's
    accumulator fragment and feeds them as the A fragment's columns t and
    t + 4; V's B fragment reads its rows in the same order, so the product
    over the step is the same sum."""
    order = testing.tf32_pv_key_order()
    assert sorted(order) == list(range(8))
    for t in range(4):
        assert order[t] == 2 * t and order[t + 4] == 2 * t + 1
    rng = np.random.default_rng(4)
    p = torch.from_numpy(rng.random((16, 64)))
    v = torch.from_numpy(rng.standard_normal((64, 32)))
    perm = torch.tensor([8 * j + c for j in range(8) for c in order])
    assert torch.allclose(p[:, perm] @ v[perm], p @ v, rtol=0, atol=1e-12)


def test_builder_flags_name_and_load_a_library_of_their_own(tmp_path, monkeypatch):
    """A build with extra flags (the flash kernel's variant define) gets its
    own library name and its own loaded library; the flags reach nvcc."""
    import ctypes
    import ctypes.util
    import subprocess
    from pathlib import Path

    from repro_torch.kernels import build as nvcc_build
    from repro_torch.kernels.flash_attention import ops as flash_ops

    src = tmp_path / "k.cu"
    src.write_text("// k\n")
    plain = nvcc_build.library_path(src)
    flagged = nvcc_build.library_path(src, flash_ops.VARIANT_FLAGS)
    assert flagged != plain and flagged.name.startswith("k-")
    assert nvcc_build.library_path(src, flash_ops.VARIANT_FLAGS) == flagged

    monkeypatch.setattr(nvcc_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(nvcc_build, "_nvcc", lambda: "nvcc")
    runs = []

    def fake_run(cmd, **kw):
        runs.append(cmd)
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(nvcc_build.subprocess, "run", fake_run)
    nvcc_build.build(src, ("-DFOO",))
    assert "-DFOO" in runs[0] and nvcc_build.library_path(src, ("-DFOO",)).exists()
    assert not nvcc_build.library_path(src).exists()

    libc = ctypes.util.find_library("c")
    if libc is None:
        pytest.skip("no C library to stand in for a built kernel")
    monkeypatch.setattr(nvcc_build, "build", lambda s, flags=():
                        nvcc_build.Built(libc, 0.0, ""))
    monkeypatch.setattr(nvcc_build, "_LOADED", {})
    sig = {"strlen": (ctypes.c_size_t, [ctypes.c_char_p])}
    one = nvcc_build.load(src, sig)
    two = nvcc_build.load(src, sig, ("-DFOO",))
    assert nvcc_build._LOADED == {(src, ()): one, (src, ("-DFOO",)): two}


def test_builder_parses_ptxas_and_keeps_the_log(tmp_path, monkeypatch):
    """``Built.kernels`` reads registers and spills per entry function; a
    library built before is returned with the log kept beside it."""
    from repro_torch.kernels import build as nvcc_build

    log = ("ptxas info    : Compiling entry function '_Z4kernIfEv' for 'sm_90a'\n"
           "ptxas info    : Function properties for _Z4kernIfEv\n"
           "    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads\n"
           "ptxas info    : Used 255 registers, used 1 barriers\n"
           "ptxas info    : Compiling entry function '_Z4kernI6bf16Ev' for 'sm_90a'\n"
           "ptxas info    : Function properties for _Z4kernI6bf16Ev\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 96 registers, used 1 barriers\n")
    assert nvcc_build.Built(tmp_path, 0.0, log).kernels() == [
        {"name": "_Z4kernIfEv", "registers": 255, "spill_stores": 4, "spill_loads": 12},
        {"name": "_Z4kernI6bf16Ev", "registers": 96, "spill_stores": 0, "spill_loads": 0}]
    monkeypatch.setattr(nvcc_build, "BUILD_DIR", tmp_path)
    src = tmp_path / "k.cu"
    src.write_text("// k\n")
    lib = nvcc_build.library_path(src)
    lib.write_bytes(b"")
    lib.with_suffix(".log").write_text(log)
    built = nvcc_build.build(src)
    assert built.seconds == 0.0 and built.log == log and len(built.kernels()) == 2


def test_launch_variant_runs_only_on_the_card():
    q, k, v = (to_torch(a) for a in _inputs(1, 16, 16, 4, 2, 16))
    with pytest.raises(ValueError, match="cuda"):
        launch_variant(0, q, k, v)
    with pytest.raises(ValueError, match="head_dim"):
        big = torch.zeros(1, 4, 2, 257)
        launch_variant(0, big, big, big)
