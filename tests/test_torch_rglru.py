"""The port's RG-LRU: the scan's plain version and CPU wrapper path against
the JAX package's Pallas kernel (interpret mode) and its oracle, and the
recurrent block's parts (conv, gates, scan, step, apply, decode) against the
JAX package on the same numpy-seeded inputs."""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro import configs as jax_configs
from repro.configs.base import RunConfig as JaxRunConfig
from repro.kernels.rglru.ops import linear_scan as jax_linear_scan
from repro.kernels.rglru.ref import linear_scan_ref as jax_linear_scan_ref
from repro.models import rglru as jax_rglru
from repro.models import transformer as jax_transformer
from repro_torch import configs
from repro_torch.configs.base import RunConfig
from repro_torch.kernels.rglru.ops import linear_scan
from repro_torch.kernels.rglru.ref import linear_scan_ref
from repro_torch.models import rglru
from repro_torch.testing import TOL, max_abs_diff, rel_diff, scan_inputs, to_torch
from repro_torch.utils.tree import ParamBuilder

ARCH = "recurrentgemma-2b"
RUN32 = dict(param_dtype="float32", activation_dtype="float32")


def _rng(seed=0):
    return np.random.default_rng(seed)


# ------------------------------------------------------------ the scan kernel

# tests/test_kernels.py's scan shapes with its Pallas block sizes
@pytest.mark.parametrize("B,S,D,bs,bd", [
    (2, 37, 16, 8, 8),
    (1, 64, 40, 16, 16),
    (2, 100, 24, 128, 128),
    (1, 17, 8, 4, 8),
])
def test_linear_scan_matches_jax_kernel_and_oracle(B, S, D, bs, bd):
    a, b, h0 = scan_inputs((B, S, D), seed=B * S + D)
    ja, jb, jh0 = (jnp.asarray(t.numpy()) for t in (a, b, h0))
    y, hT = linear_scan_ref(a, b, h0)
    assert y.shape == (B, S, D) and hT.shape == (B, D) and y.dtype == torch.float32
    jy, jhT = jax_linear_scan(ja, jb, jh0, block_s=bs, block_d=bd, interpret=True)
    assert max_abs_diff(y, jy) < TOL["rglru_f32"]
    assert max_abs_diff(hT, jhT) < TOL["rglru_f32"]
    ry, rhT = jax_linear_scan_ref(ja, jb, jh0)
    assert max_abs_diff(y, ry) < TOL["rglru_f32"]
    assert max_abs_diff(hT, rhT) < TOL["rglru_f32"]
    # on a CPU tensor the wrapper is the plain version and launches no kernel
    before = linear_scan.launches
    wy, whT = linear_scan(a, b, h0)
    assert torch.equal(wy, y) and torch.equal(whT, hT)
    assert linear_scan.launches == before


def test_linear_scan_carries_h0_through_zero_input():
    """b = 0: h_t = (prod a) h0, the term the JAX wrapper folds in with cumprod."""
    a, _, h0 = scan_inputs((2, 9, 5), seed=3)
    y, hT = linear_scan(a, torch.zeros_like(a), h0)
    expect = torch.cumprod(a, dim=1) * h0[:, None]
    assert max_abs_diff(y, expect) < TOL["rglru_f32"]
    assert max_abs_diff(hT, expect[:, -1]) < TOL["rglru_f32"]


def test_linear_scan_refuses_what_the_kernel_does_not_take():
    a, b, h0 = scan_inputs((2, 8, 4))
    with pytest.raises(TypeError, match="float32"):
        linear_scan(a.double(), b.double(), h0.double())
    with pytest.raises(TypeError, match="float32"):
        linear_scan(a.bfloat16(), b, h0)
    with pytest.raises(ValueError, match="contiguous"):
        linear_scan(a.transpose(1, 2), b, h0)
    with pytest.raises(ValueError, match="shapes"):
        linear_scan(a, b[:, :4].contiguous(), h0)
    with pytest.raises(ValueError, match="shapes"):
        linear_scan(a, b, h0[:1].contiguous())
    with pytest.raises(ValueError, match="non-empty"):
        empty = torch.zeros(2, 0, 4)
        linear_scan(empty, empty, h0)


# ------------------------------------------------------- the recurrent block

def _params(seed=0, D=24, W=4):
    """Seeded numpy params of one recurrent block (d_model = lru width = D)."""
    rng = _rng(seed)
    return {"w_in_a": rng.standard_normal((D, D), dtype=np.float32) / np.sqrt(D),
            "w_in_b": rng.standard_normal((D, D), dtype=np.float32) / np.sqrt(D),
            "conv_w": rng.standard_normal((W, D), dtype=np.float32) * 0.3,
            "w_gate_a": rng.standard_normal((D, D), dtype=np.float32) / np.sqrt(D),
            "w_gate_x": rng.standard_normal((D, D), dtype=np.float32) / np.sqrt(D),
            "lam": rng.standard_normal(D, dtype=np.float32) * 0.5 + 1.0,
            "w_out": rng.standard_normal((D, D), dtype=np.float32) / np.sqrt(D)}


def _both(p):
    return ({k: to_torch(v) for k, v in p.items()},
            {k: jnp.asarray(v) for k, v in p.items()})


def _cfg(D=24):
    jax_cfg = jax_configs.get_smoke_config(ARCH).replace(d_model=D)
    return configs.get_smoke_config(ARCH).replace(d_model=D), jax_cfg


def test_conv1d_causal_matches_jax_with_a_carried_state():
    rng = _rng(1)
    x = rng.standard_normal((2, 7, 24), dtype=np.float32)
    w = rng.standard_normal((4, 24), dtype=np.float32)
    state = rng.standard_normal((2, 3, 24), dtype=np.float32)
    out, new = rglru._conv1d_causal(to_torch(x), to_torch(w), to_torch(state))
    jout, jnew = jax_rglru._conv1d_causal(jnp.asarray(x), jnp.asarray(w), jnp.asarray(state))
    assert max_abs_diff(out, jout) < TOL["module_f32"]
    assert max_abs_diff(new, jnew) < TOL["module_f32"]
    # shorter than the conv: the new state still holds the last W-1 inputs
    out, new = rglru._conv1d_causal(to_torch(x[:, :2]), to_torch(w), to_torch(state))
    jout, jnew = jax_rglru._conv1d_causal(jnp.asarray(x[:, :2]), jnp.asarray(w),
                                          jnp.asarray(state))
    assert max_abs_diff(out, jout) < TOL["module_f32"]
    assert max_abs_diff(new, jnew) < TOL["module_f32"]


def test_gates_match_jax():
    p, jp = _both(_params(2))
    xc = _rng(3).standard_normal((2, 9, 24), dtype=np.float32) * 2
    a, b = rglru._gates(p, to_torch(xc))
    ja, jb = jax_rglru._gates(jp, jnp.asarray(xc))
    assert a.dtype == b.dtype == torch.float32
    assert max_abs_diff(a, ja) < TOL["module_f32"]
    assert max_abs_diff(b, jb) < TOL["module_f32"]


@pytest.mark.parametrize("use_pallas", [False, True])
def test_gates_and_apply_match_jax_with_f32_params_and_bf16_activations(use_pallas):
    """JAX's einsum promotes bf16 activations against f32 gate weights to
    f32; a port that casts the weights down to bf16 is 4e-3 off in a.  The
    f32 results (a, b, the carried h) agree to summation order; the bf16
    output to the bf16 bar."""
    p, jp = _both(_params(2))
    xc = _rng(3).standard_normal((2, 9, 24), dtype=np.float32) * 2
    a, b = rglru._gates(p, to_torch(xc, "bfloat16"))
    ja, jb = jax_rglru._gates(jp, jnp.asarray(xc).astype(jnp.bfloat16))
    assert a.dtype == b.dtype == torch.float32
    assert max_abs_diff(a, ja) < TOL["module_f32"]
    assert max_abs_diff(b, jb) < TOL["module_f32"]

    cfg, jax_cfg = _cfg()
    mixed = dict(param_dtype="float32", activation_dtype="bfloat16", use_pallas=use_pallas)
    x = _rng(9).standard_normal((2, 11, 24), dtype=np.float32)
    c = _cache(10)
    cache = {"h": to_torch(c["h"]), "conv": to_torch(c["conv"], "bfloat16")}
    jy, jcache = jax_rglru.apply(
        jp, jax_cfg, JaxRunConfig(**mixed), jnp.asarray(x).astype(jnp.bfloat16),
        {"h": jnp.asarray(c["h"]), "conv": jnp.asarray(c["conv"]).astype(jnp.bfloat16)},
        use_pallas=use_pallas)
    y = rglru.apply(p, cfg, RunConfig(**mixed), to_torch(x, "bfloat16"), cache)
    assert y.dtype == torch.bfloat16 and cache["h"].dtype == torch.float32
    assert rel_diff(y, jy) < TOL["module_bf16"]
    assert max_abs_diff(cache["h"], jcache["h"]) < TOL["module_f32"]
    assert rel_diff(cache["conv"], jcache["conv"]) < TOL["module_bf16"]


@pytest.mark.parametrize("use_kernel", [False, True])
def test_rg_lru_scan_matches_jax(use_kernel):
    p, jp = _both(_params(4))
    rng = _rng(5)
    xc = rng.standard_normal((2, 13, 24), dtype=np.float32)
    h0 = rng.standard_normal((2, 24), dtype=np.float32)
    y, hT = rglru.rg_lru_scan(p, to_torch(xc), to_torch(h0), use_kernel=use_kernel)
    jy, jhT = jax_rglru.rg_lru_scan(jp, jnp.asarray(xc), jnp.asarray(h0))
    assert max_abs_diff(y, jy) < TOL["module_f32"]
    assert max_abs_diff(hT, jhT) < TOL["module_f32"]


def test_rg_lru_step_matches_jax():
    p, jp = _both(_params(6))
    rng = _rng(7)
    xc = rng.standard_normal((3, 1, 24), dtype=np.float32)
    h = rng.standard_normal((3, 24), dtype=np.float32)
    y, h_new = rglru.rg_lru_step(p, to_torch(xc), to_torch(h))
    jy, jh = jax_rglru.rg_lru_step(jp, jnp.asarray(xc), jnp.asarray(h))
    assert max_abs_diff(y, jy) < TOL["module_f32"]
    assert max_abs_diff(h_new, jh) < TOL["module_f32"]


def _cache(seed, B=2, D=24, W=4):
    rng = _rng(seed)
    return {"h": rng.standard_normal((B, D), dtype=np.float32),
            "conv": rng.standard_normal((B, W - 1, D), dtype=np.float32)}


@pytest.mark.parametrize("use_pallas", [False, True])
def test_apply_matches_jax_and_writes_the_cache_in_place(use_pallas):
    cfg, jax_cfg = _cfg()
    run = RunConfig(**RUN32, use_pallas=use_pallas)
    jax_run = JaxRunConfig(**RUN32, use_pallas=use_pallas)
    p, jp = _both(_params(8))
    x = _rng(9).standard_normal((2, 11, 24), dtype=np.float32)
    c = _cache(10)
    jy, jcache = jax_rglru.apply(jp, jax_cfg, jax_run, jnp.asarray(x),
                                 {k: jnp.asarray(v) for k, v in c.items()},
                                 use_pallas=use_pallas)
    cache = {k: to_torch(v).clone() for k, v in c.items()}
    y = rglru.apply(p, cfg, run, to_torch(x), cache)
    assert max_abs_diff(y, jy) < TOL["module_f32"]
    assert max_abs_diff(cache["h"], jcache["h"]) < TOL["module_f32"]
    assert max_abs_diff(cache["conv"], jcache["conv"]) < TOL["module_f32"]
    # without a cache: a zero state, as the JAX package's train mode
    y0 = rglru.apply(p, cfg, run, to_torch(x))
    jy0, _ = jax_rglru.apply(jp, jax_cfg, jax_run, jnp.asarray(x), use_pallas=use_pallas)
    assert max_abs_diff(y0, jy0) < TOL["module_f32"]


def test_decode_matches_jax_step_by_step_with_the_conv_state():
    cfg, jax_cfg = _cfg()
    run, jax_run = RunConfig(**RUN32), JaxRunConfig(**RUN32)
    p, jp = _both(_params(11))
    c = _cache(12)
    cache = {k: to_torch(v).clone() for k, v in c.items()}
    jcache = {k: jnp.asarray(v) for k, v in c.items()}
    rng = _rng(13)
    for i in range(6):
        x = rng.standard_normal((2, 1, 24), dtype=np.float32)
        y = rglru.decode(p, cfg, run, to_torch(x), cache)
        jy, jcache = jax_rglru.decode(jp, jax_cfg, jax_run, jnp.asarray(x), jcache)
        assert max_abs_diff(y, jy) < TOL["module_f32"], i
        assert max_abs_diff(cache["h"], jcache["h"]) < TOL["module_f32"], i
        assert max_abs_diff(cache["conv"], jcache["conv"]) < TOL["module_f32"], i


def test_decode_continues_apply():
    """S steps of decode from a state give what one apply over S gives."""
    cfg, _ = _cfg()
    run = RunConfig(**RUN32)
    p, _ = _both(_params(14))
    x = to_torch(_rng(15).standard_normal((2, 6, 24), dtype=np.float32))
    full_cache = {k: to_torch(v) for k, v in _cache(16).items()}
    step_cache = {k: v.clone() for k, v in full_cache.items()}
    full = rglru.apply(p, cfg, run, x, full_cache)
    steps = torch.cat([rglru.decode(p, cfg, run, x[:, t:t + 1], step_cache)
                       for t in range(6)], dim=1)
    assert max_abs_diff(steps, full) < TOL["module_f32"]
    assert max_abs_diff(step_cache["h"], full_cache["h"]) < TOL["module_f32"]
    assert max_abs_diff(step_cache["conv"], full_cache["conv"]) < TOL["module_f32"]


def test_init_matches_jax_names_shapes_and_values():
    cfg, jax_cfg = _cfg(D=256)
    gen = torch.Generator()
    gen.manual_seed(0)
    pb = ParamBuilder(gen, torch.float32)
    rglru.init(pb, cfg)
    ours = pb.params
    theirs, _ = jax_transformer.layer_specs(jax_cfg, "rglru", jnp.float32)
    assert {k: tuple(v.shape) for k, v in ours.items()} == \
        {k: tuple(v.shape) for k, v in theirs["rec"].items()}
    assert torch.equal(ours["lam"], torch.ones(256))
    assert abs(ours["conv_w"].std().item() - 0.1) < 0.01
    assert abs(ours["w_gate_a"].std().item() * np.sqrt(256) - 1.0) < 0.05
    cache = rglru.init_cache(cfg, 3, torch.bfloat16, "cpu")
    assert cache["h"].dtype == torch.float32 and cache["h"].shape == (3, 256)
    assert cache["conv"].dtype == torch.bfloat16 and cache["conv"].shape == (3, 3, 256)
    jax_cache = jax_rglru.cache_shape(jax_cfg, 3, jnp.bfloat16)
    assert cache["conv"].shape == jax_cache["conv"].shape


def test_gelu_is_the_tanh_form_that_jax_uses():
    """jax.nn.gelu defaults to approximate=True; the exact erf form differs
    by more than the module bar."""
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    ours = torch.nn.functional.gelu(to_torch(x), approximate="tanh")
    assert max_abs_diff(ours, jax.nn.gelu(jnp.asarray(x))) < TOL["module_f32"]
    exact = torch.nn.functional.gelu(to_torch(x))
    assert max_abs_diff(exact, jax.nn.gelu(jnp.asarray(x))) > 10 * TOL["module_f32"]
