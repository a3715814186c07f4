"""The port's WKV6: the kernel's plain version and CPU wrapper path against the
JAX package's Pallas kernel (interpret mode) and its oracle, and the RWKV-6
block's parts (projections, chunked and kernel time mix, decode, channel mix,
apply) against the JAX package on the same numpy-seeded inputs and the same
weights, with every leaf that LM.init sets to a constant perturbed."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro import configs as jax_configs
from repro.configs.base import RunConfig as JaxRunConfig
from repro.kernels.rwkv6.ops import wkv6 as jax_wkv6
from repro.kernels.rwkv6.ref import wkv6_ref as jax_wkv6_ref
from repro.models import rwkv6 as jax_rwkv6
from repro.models import transformer as jax_transformer
from repro_torch import configs
from repro_torch.configs.base import RunConfig
from repro_torch.kernels.rwkv6 import ops as wkv6_ops
from repro_torch.kernels.rwkv6.ops import wkv6
from repro_torch.kernels.rwkv6.ref import wkv6_ref
from repro_torch.models import LM, rwkv6
from repro_torch.testing import (TOL, WKV6_CHECK_SHAPES, max_abs_diff, perturb_zero_leaves,
                                 rel_diff, to_numpy, to_torch, wkv_inputs)
from repro_torch.utils.tree import ParamBuilder

ARCH = "rwkv6-3b"
RUN32 = dict(param_dtype="float32", activation_dtype="float32")


def _rng(seed=0):
    return np.random.default_rng(seed)


def _jax(tensors):
    """torch tensors -> JAX arrays of the same values (bf16 stays bf16)."""
    return tuple(jnp.asarray(to_numpy(t)).astype(jnp.bfloat16 if t.dtype == torch.bfloat16
                                                  else jnp.float32) for t in tensors)


# ------------------------------------------------------------ the kernel

# every check shape but the serving one, with the Pallas chunk of
# tests/test_kernels.py where the shape comes from there
_CONTRACT = [(shape, chunk) for shape, chunk in zip(WKV6_CHECK_SHAPES[:-1],
                                                    (16, 32, 64, 64, 64, 64, 64))]


@pytest.mark.parametrize("shape,chunk", _CONTRACT, ids=str)
def test_wkv6_matches_jax_kernel_and_oracle(shape, chunk):
    inputs = wkv_inputs(shape, seed=sum(shape[:4]))
    y, state = wkv6_ref(*inputs)
    B, H, S, N, _ = shape
    assert y.shape == (B, H, S, N) and state.shape == (B, H, N, N)
    assert y.dtype == state.dtype == torch.float32
    jy, jstate = jax_wkv6(*_jax(inputs), chunk=chunk, interpret=True)
    assert max_abs_diff(y, jy) < TOL["wkv6"]
    assert max_abs_diff(state, jstate) < TOL["wkv6"]
    ry, rstate = jax_wkv6_ref(*_jax(inputs))
    assert max_abs_diff(y, ry) < TOL["wkv6"]
    assert max_abs_diff(state, rstate) < TOL["wkv6"]
    # on a CPU tensor the wrapper is the plain version and launches no kernel
    before = wkv6.launches
    wy, wstate = wkv6(*inputs)
    assert torch.equal(wy, y) and torch.equal(wstate, state)
    assert wkv6.launches == before


def test_wkv6_carries_state0_through_zero_input():
    """k = v = 0: S_T = prod_t diag(w_t) state0 and y_t = r_t^T S_{t-1}, the
    terms the JAX wrapper folds in with a second pass."""
    r, k, v, logw, u, s0 = wkv_inputs((2, 3, 9, 8, "float32"), seed=3)
    zero = torch.zeros_like(k)
    y, state = wkv6(r, zero, zero, logw, u, s0)
    decay = torch.exp(torch.cumsum(logw, dim=2))              # (B, H, S, N)
    before = torch.cat([torch.ones_like(decay[:, :, :1]), decay[:, :, :-1]], dim=2)
    expect_y = torch.einsum("bhsi,bhij->bhsj", r * before, s0)
    assert max_abs_diff(y, expect_y) < TOL["wkv6"]
    assert max_abs_diff(state, decay[:, :, -1, :, None] * s0) < TOL["wkv6"]


@pytest.mark.parametrize("shape", [WKV6_CHECK_SHAPES[0], WKV6_CHECK_SHAPES[6]], ids=str)
def test_wkv6_takes_the_model_layout(shape):
    """Streams that are (1, 2) transposes of contiguous (B, S, H, N) tensors,
    as the model's heads are, give the same y and state, and y comes back in
    that layout."""
    y, state = wkv6(*wkv_inputs(shape, seed=4))
    sy, sstate = wkv6(*wkv_inputs(shape, seed=4, seq_major=True))
    assert sy.transpose(1, 2).is_contiguous() and not sy.is_contiguous()
    assert torch.equal(sy, y) and torch.equal(sstate, state)


@pytest.mark.parametrize("pairs,N,split", [(160, 64, 1), (132, 64, 2), (120, 64, 2),
                                            (80, 64, 2), (40, 64, 4), (40, 16, 1),
                                            (1000, 64, 1)])
def test_wkv6_splits_columns_only_while_an_sm_holds_two_blocks(pairs, N, split):
    """At 132 SMs: rwkv6-3b's 40 heads at 4 requests keep one block per
    (b, h); fewer requests split the value columns over 2 or 4 blocks."""
    assert wkv6_ops.col_split(pairs, N, 132) == split


def test_wkv6_refuses_what_the_kernel_does_not_take():
    r, k, v, logw, u, s0 = wkv_inputs((2, 3, 8, 16, "float32"))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        wkv6(r.half(), k.half(), v.half(), logw, u, s0)
    with pytest.raises(TypeError, match="differ"):
        wkv6(r.bfloat16(), k, v, logw, u, s0)
    with pytest.raises(TypeError, match="logw"):
        wkv6(r, k, v, logw.bfloat16(), u, s0)
    with pytest.raises(TypeError, match="state0"):
        wkv6(r, k, v, logw, u, s0.double())
    with pytest.raises(ValueError, match="contiguous"):
        wkv6(r.transpose(2, 3), k, v, logw, u, s0)
    with pytest.raises(ValueError, match="contiguous"):
        wkv6(r, k, v, logw, u.t().contiguous().t(), s0)
    with pytest.raises(ValueError, match="one layout"):
        wkv6(r, k.transpose(1, 2).contiguous().transpose(1, 2), v, logw, u, s0)
    with pytest.raises(ValueError, match="shapes"):
        wkv6(r, k[:, :, :4].contiguous(), v, logw, u, s0)
    with pytest.raises(ValueError, match="shapes"):
        wkv6(r, k, v, logw, u[:2].contiguous(), s0)
    with pytest.raises(ValueError, match="shapes"):
        wkv6(r, k, v, logw, u, s0[:1].contiguous())
    with pytest.raises(ValueError, match="non-empty"):
        empty = torch.zeros(2, 3, 0, 16)
        wkv6(empty, empty, empty, empty, u, s0)


# ------------------------------------------------------------ the block

def _cfg(n_layers=1):
    return (configs.get_smoke_config(ARCH).replace(n_layers=n_layers),
            jax_configs.get_smoke_config(ARCH).replace(n_layers=n_layers))


def _tree_to_jax(tree):
    return {k: _tree_to_jax(v) if isinstance(v, dict) else jnp.asarray(to_numpy(v))
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def block():
    """One rwkv layer of the smoke config, drawn by the port and perturbed,
    in both packages."""
    cfg, jax_cfg = _cfg()
    params = LM.init(cfg, RunConfig(**RUN32), seed=0, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(1)
    assert perturb_zero_leaves(params, cfg, gen) == 14
    p = params["layers"][0]
    return cfg, jax_cfg, p, _tree_to_jax(p)


def _inputs(seed, S=37, B=2):
    """x (B, S, M), x_prev (B, M), a nonzero state (B, H, N, N), as numpy."""
    rng = _rng(seed)
    x = rng.standard_normal((B, S, 64), dtype=np.float32)
    x_prev = rng.standard_normal((B, 64), dtype=np.float32)
    state = rng.standard_normal((B, 4, 16, 16), dtype=np.float32) * 0.2
    return x, x_prev, state


def test_perturbed_leaves_leave_mixes_in_the_unit_interval(block):
    *_, p, _ = block
    for leaf in ("mix_r", "mix_k", "mix_v", "mix_w", "mix_g"):
        assert 0 <= p[leaf].min() and p[leaf].max() < 1 and p[leaf].std() > 0.1
    assert 0 <= p["cm"]["mix_k"].min() and p["cm"]["mix_r"].max() < 1
    for leaf in ("w_lora_b", "bonus_u", "ln_x_scale", "norm_tm", "norm_cm"):
        assert p[leaf].abs().max() > 0
    assert p["w_bias"].std() > 0.1 and abs(p["w_bias"].mean() + 1) < 0.2


def test_projections_match_jax(block):
    cfg, jax_cfg, p, jp = block
    x, x_prev, _ = _inputs(2)
    ours = rwkv6._projections(p, cfg, to_torch(x), to_torch(x_prev))
    theirs = jax_rwkv6._projections(jp, jax_cfg, jnp.asarray(x), jnp.asarray(x_prev))
    for name, a, b in zip(("r", "k", "v", "g", "logw"), ours, theirs):
        assert max_abs_diff(a, b) < TOL["module_f32"], name
    assert ours[4].dtype == torch.float32 and bool((ours[4] < 0).all())
    # the token shift reached the projections: x_prev moves r of the first token
    moved = rwkv6._projections(p, cfg, to_torch(x), to_torch(x_prev + 1))[0]
    assert max_abs_diff(moved[:, 0], ours[0][:, 0]) > 1e-2
    assert max_abs_diff(moved[:, 1:], ours[0][:, 1:]) < TOL["module_f32"]


def test_channel_mix_matches_jax(block):
    cfg, jax_cfg, p, jp = block
    x, x_prev, _ = _inputs(3)
    y, last = rwkv6.channel_mix(p["cm"], to_torch(x), to_torch(x_prev))
    jy, jlast = jax_rwkv6.channel_mix(jp["cm"], jnp.asarray(x), jnp.asarray(x_prev))
    assert max_abs_diff(y, jy) < TOL["module_f32"]
    assert max_abs_diff(last, jlast) == 0


# The parts that run an S-step recurrence (the chunked and kernel time mix,
# apply, decode over steps) gather f32 rounding over the steps at state
# magnitudes near 5: they are held to TOL["rwkv_block_f32"]; single-step
# parts to 1e-6.
@pytest.mark.parametrize("chunk", [16, 64])
@pytest.mark.parametrize("bf16_streams", [False, True])
def test_time_mix_chunked_matches_jax(block, chunk, bf16_streams):
    """S = 37: three chunks of 16 with a padded tail, or one chunk of 37."""
    cfg, jax_cfg, p, jp = block
    x, x_prev, state = _inputs(4)
    y, last, new_state = rwkv6.time_mix_chunked(
        p, cfg, to_torch(x), to_torch(x_prev), to_torch(state), chunk=chunk,
        bf16_streams=bf16_streams)
    jy, jlast, jstate = jax_rwkv6.time_mix_chunked(
        jp, jax_cfg, jnp.asarray(x), jnp.asarray(x_prev), jnp.asarray(state), chunk=chunk,
        bf16_streams=bf16_streams)
    assert y.shape == x.shape and new_state.shape == state.shape
    assert max_abs_diff(y, jy) < TOL["rwkv_block_f32"]
    assert max_abs_diff(new_state, jstate) < TOL["rwkv_block_f32"]
    assert max_abs_diff(last, jlast) == 0


def test_time_mix_kernel_path_matches_the_plain_path(block):
    """On a CPU tensor the kernel path runs wkv6_ref on the (B, H, S, N)
    heads; it agrees with the chunked plain path."""
    cfg, _, p, _ = block
    x, x_prev, state = (to_torch(a) for a in _inputs(5))
    y, last, new_state = rwkv6.time_mix_kernel(p, cfg, x, x_prev, state)
    py, plast, pstate = rwkv6.time_mix_chunked(p, cfg, x, x_prev, state, chunk=16)
    assert max_abs_diff(y, py) < TOL["rwkv_block_f32"]
    assert max_abs_diff(new_state, pstate) < TOL["rwkv_block_f32"]
    assert torch.equal(last, plast)


def test_time_mix_decode_matches_jax(block):
    cfg, jax_cfg, p, jp = block
    x, x_prev, state = _inputs(6, S=1, B=3)
    ours = rwkv6.time_mix_decode(p, cfg, to_torch(x), to_torch(x_prev), to_torch(state))
    theirs = jax_rwkv6.time_mix_decode(jp, jax_cfg, jnp.asarray(x), jnp.asarray(x_prev),
                                       jnp.asarray(state))
    for a, b in zip(ours, theirs):
        assert max_abs_diff(a, b) < TOL["module_f32"]


def _caches(seed, dtype="float32"):
    """A nonzero layer cache (state f32, last tokens in ``dtype``) in both
    packages."""
    x, x_prev, state = _inputs(seed, S=1)
    c = {"state": state, "tm_x_prev": x_prev, "cm_x_prev": 0.5 * x[:, 0]}
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    # cloned: the port writes its cache in place, and JAX may share numpy's buffers
    cache = {k: to_torch(v, "float32" if k == "state" else dtype).clone()
             for k, v in c.items()}
    jcache = {k: jnp.asarray(v) if k == "state" else jnp.asarray(v).astype(jdt)
              for k, v in c.items()}
    return cache, jcache


@pytest.mark.parametrize("use_pallas", [False, True])
def test_apply_matches_jax_and_writes_the_cache_in_place(block, use_pallas):
    cfg, jax_cfg, p, jp = block
    run = RunConfig(**RUN32, use_pallas=use_pallas, rwkv_chunk=16)
    jax_run = JaxRunConfig(**RUN32, use_pallas=use_pallas, rwkv_chunk=16)
    x, _, _ = _inputs(7)
    cache, jcache = _caches(8)
    out = rwkv6.apply(p, cfg, run, to_torch(x), cache)
    jout, jnew = jax_rwkv6.apply(jp, jax_cfg, jax_run, jnp.asarray(x), jcache,
                                 use_pallas=use_pallas)
    assert out.shape == x.shape
    assert max_abs_diff(out, jout) < TOL["rwkv_block_f32"]
    assert max_abs_diff(cache["state"], jnew["state"]) < TOL["rwkv_block_f32"]
    # the normed last token of each half, not the block input
    assert max_abs_diff(cache["tm_x_prev"], jnew["tm_x_prev"]) < TOL["module_f32"]
    assert max_abs_diff(cache["cm_x_prev"], jnew["cm_x_prev"]) < TOL["rwkv_block_f32"]
    assert max_abs_diff(cache["tm_x_prev"], x[:, -1]) > 1e-2
    # without a cache: a zero state, as the JAX package's train mode
    out0 = rwkv6.apply(p, cfg, run, to_torch(x))
    jout0, _ = jax_rwkv6.apply(jp, jax_cfg, jax_run, jnp.asarray(x), use_pallas=use_pallas)
    assert max_abs_diff(out0, jout0) < TOL["rwkv_block_f32"]


@pytest.mark.parametrize("use_pallas", [False, True])
def test_apply_matches_jax_with_f32_params_and_bf16_activations(block, use_pallas):
    cfg, jax_cfg, p, jp = block
    mixed = dict(param_dtype="float32", activation_dtype="bfloat16", use_pallas=use_pallas)
    x, _, _ = _inputs(9)
    cache, jcache = _caches(10, "bfloat16")
    out = rwkv6.apply(p, cfg, RunConfig(**mixed), to_torch(x, "bfloat16"), cache)
    jout, jnew = jax_rwkv6.apply(jp, jax_cfg, JaxRunConfig(**mixed),
                                 jnp.asarray(x).astype(jnp.bfloat16), jcache,
                                 use_pallas=use_pallas)
    assert out.dtype == torch.bfloat16 and cache["state"].dtype == torch.float32
    assert rel_diff(out, jout) < TOL["module_bf16"]
    # the state is f32 on both sides, from the same bf16-rounded streams
    assert max_abs_diff(cache["state"], jnew["state"]) < TOL["rwkv_block_f32"]
    for name in ("tm_x_prev", "cm_x_prev"):
        assert rel_diff(cache[name], jnew[name]) < TOL["module_bf16"], name


def test_kernel_path_ignores_the_chunk_and_stream_options(block):
    """As in the JAX package, only the plain path reads rwkv_chunk and
    rwkv_bf16_streams."""
    cfg, _, p, _ = block
    x = to_torch(_inputs(11)[0])
    outs = [rwkv6.apply(p, cfg, RunConfig(**RUN32, use_pallas=True, rwkv_chunk=chunk,
                                          rwkv_bf16_streams=streams), x)
            for chunk, streams in ((64, False), (16, True))]
    assert torch.equal(*outs)
    plain = [rwkv6.apply(p, cfg, RunConfig(**RUN32, rwkv_bf16_streams=streams), x)
             for streams in (False, True)]
    assert not torch.equal(*plain)


def test_decode_matches_jax_step_by_step(block):
    cfg, jax_cfg, p, jp = block
    run, jax_run = RunConfig(**RUN32), JaxRunConfig(**RUN32)
    cache, jcache = _caches(12)
    rng = _rng(13)
    for i in range(6):
        x = rng.standard_normal((2, 1, 64), dtype=np.float32)
        out = rwkv6.decode(p, cfg, run, to_torch(x), cache)
        jout, jcache = jax_rwkv6.decode(jp, jax_cfg, jax_run, jnp.asarray(x), jcache)
        assert max_abs_diff(out, jout) < TOL["rwkv_block_f32"], i
        for name in cache:
            assert max_abs_diff(cache[name], jcache[name]) < TOL["rwkv_block_f32"], (i, name)


def test_decode_continues_apply(block):
    """S steps of decode from a cache give what one apply over S gives."""
    cfg, _, p, _ = block
    run = RunConfig(**RUN32)
    x = to_torch(_inputs(14, S=6)[0])
    full_cache, _ = _caches(15)
    step_cache = {k: v.clone() for k, v in full_cache.items()}
    full = rwkv6.apply(p, cfg, run, x, full_cache)
    steps = torch.cat([rwkv6.decode(p, cfg, run, x[:, t:t + 1], step_cache)
                       for t in range(6)], dim=1)
    assert max_abs_diff(steps, full) < TOL["rwkv_block_f32"]
    for name in full_cache:
        assert max_abs_diff(step_cache[name], full_cache[name]) < TOL["rwkv_block_f32"], name


def test_init_matches_jax_names_shapes_and_values():
    cfg, jax_cfg = _cfg()
    gen = torch.Generator()
    gen.manual_seed(0)
    pb = ParamBuilder(gen, torch.float32)
    rwkv6.init_block(pb, cfg)
    ours = pb.params
    theirs, _ = jax_transformer.layer_specs(jax_cfg, "rwkv", jnp.float32)

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape) for k, v in tree.items()}

    assert shapes(ours) == shapes(theirs)
    assert torch.equal(ours["w_bias"], torch.full((64,), -1.0))
    for leaf in ("mix_r", "mix_w", "w_lora_b", "bonus_u", "ln_x_scale", "norm_tm"):
        assert not ours[leaf].any(), leaf
    assert abs(ours["w_lora_a"].std().item() * 8 - 1.0) < 0.1     # fan-in 64
    cache = rwkv6.init_cache(cfg, 3, torch.bfloat16, "cpu")
    jax_cache = jax_rwkv6.cache_shape(jax_cfg, 3, jnp.bfloat16)
    for name, sd in jax_cache.items():
        assert tuple(cache[name].shape) == sd.shape, name
    assert cache["state"].dtype == torch.float32 and cache["tm_x_prev"].dtype == torch.bfloat16


def test_refuses_a_width_that_is_not_a_multiple_of_the_head_size():
    cfg = dataclasses.replace(_cfg()[0], d_model=72)
    pb = ParamBuilder(torch.Generator(), torch.float32)
    with pytest.raises(ValueError, match="multiple"):
        rwkv6.init(pb, cfg)
