"""The port's configs, parameter init and conversion, and its building
blocks (rms_norm, rope, naive attention, SwiGLU MLP) vs the JAX package."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro import configs as jax_configs
from repro.configs import base as jax_base
from repro.configs.base import RunConfig as JaxRunConfig
from repro.models import LM as JaxLM
from repro.models import ffn as jax_ffn
from repro.models import modules as jax_modules
from repro_torch import configs
from repro_torch.configs import base
from repro_torch.configs.base import RunConfig
from repro_torch.convert import params_from_jax
from repro_torch.models import LM, ffn, modules
from repro_torch.testing import TOL, max_abs_diff, to_torch

RUN32 = dict(param_dtype="float32", activation_dtype="float32")


def _rng(seed=0):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------- configs

@pytest.mark.parametrize("name", ["MoEConfig", "ModelConfig", "RunConfig"])
def test_config_classes_have_the_same_fields_and_defaults(name):
    def fields(cls):
        return [(f.name, f.default, f.default_factory) for f in dataclasses.fields(cls)]
    assert fields(getattr(base, name)) == fields(getattr(jax_base, name))


@pytest.mark.parametrize("getter", ["get_config", "get_smoke_config"])
def test_smollm_config_matches_jax(getter):
    ours = getattr(configs, getter)("smollm-360m")
    theirs = getattr(jax_configs, getter)("smollm-360m")
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


@pytest.mark.parametrize("arch", ["qwen3-32b", "musicgen-large", "granite-8b",
                                  "mixtral-8x22b"])
def test_registry_refuses_archs_not_yet_ported(arch):
    assert arch in jax_configs.ARCH_IDS
    with pytest.raises(KeyError, match="not yet ported"):
        configs.get_config(arch)
    with pytest.raises(KeyError, match="not yet ported"):
        configs.get_smoke_config(arch)


# ---------------------------------------------------------------- params

def _jax_params(cfg_name="smollm-360m", seed=0):
    cfg = jax_configs.get_smoke_config(cfg_name)
    params, _ = JaxLM.init(cfg, JaxRunConfig(**RUN32), jax.random.PRNGKey(seed))
    return cfg, jax.tree_util.tree_map(np.asarray, params)


def test_params_from_jax_carries_every_leaf_exactly():
    cfg, tree = _jax_params()
    ours = params_from_jax(tree, configs.get_smoke_config("smollm-360m"), device="cpu")
    seen = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
        if keys[0] == "stack":
            _, _, _, *inner = keys          # stack.groups[0].<block leaf path>
            for i in range(cfg.n_layers):
                node = ours["layers"][i]
                for key in inner:
                    node = node[key]
                assert tuple(node.shape) == leaf.shape[1:]
                assert np.array_equal(node.numpy(), leaf[i])
                seen += 1
        else:
            assert tuple(ours[keys[0]].shape) == leaf.shape
            assert np.array_equal(ours[keys[0]].numpy(), leaf)
            seen += 1
    assert seen == len(jax.tree_util.tree_leaves(ours))
    assert (sum(t.numel() for t in jax.tree_util.tree_leaves(ours))
            == sum(a.size for a in jax.tree_util.tree_leaves(tree)))


def test_params_from_jax_refuses_unported_leaves():
    _, tree = _jax_params("qwen3-32b")          # qk-norm adds q_norm / k_norm
    with pytest.raises(NotImplementedError):
        params_from_jax(tree, configs.get_smoke_config("smollm-360m"), device="cpu")


def test_init_matches_jax_names_shapes_and_fan_in_scale():
    cfg = configs.get_smoke_config("smollm-360m").replace(d_model=240, d_ff=480)
    run = RunConfig(**RUN32)
    ours = LM.init(cfg, run, seed=0, device="cpu")
    jax_cfg = jax_configs.get_smoke_config("smollm-360m").replace(d_model=240, d_ff=480)
    theirs, _ = JaxLM.init(jax_cfg, JaxRunConfig(**RUN32), abstract=True)
    assert ours["embed"].shape == theirs["embed"].shape
    group = theirs["stack"]["groups"][0]
    layer = ours["layers"][0]
    assert len(ours["layers"]) == cfg.n_layers
    for name, sub in (("attn", ("wq", "wk", "wv", "wo")),
                      ("mlp", ("w_gate", "w_up", "w_down"))):
        for leaf in sub:
            assert layer[name][leaf].shape == group[name][leaf].shape[1:]
    assert torch.count_nonzero(layer["norm1"]) == 0
    assert torch.count_nonzero(ours["final_norm"]) == 0
    # fan-in normal: std 1/sqrt(fan_in) to within sampling error
    for t, fan_in in ((layer["attn"]["wq"], cfg.d_model),
                      (layer["mlp"]["w_down"], cfg.d_ff),
                      (ours["embed"], cfg.d_model)):
        assert abs(t.std().item() * np.sqrt(fan_in) - 1.0) < 0.05
    again = LM.init(cfg, run, seed=0, device="cpu")
    assert torch.equal(again["layers"][0]["mlp"]["w_up"], layer["mlp"]["w_up"])
    assert not torch.equal(again["layers"][1]["mlp"]["w_up"], layer["mlp"]["w_up"])


# ---------------------------------------------------------------- modules

def test_rms_norm_matches_jax():
    x = _rng(1).standard_normal((2, 7, 60), dtype=np.float32) * 3
    scale = _rng(2).standard_normal(60, dtype=np.float32) * 0.1
    ours = modules.rms_norm(to_torch(x), to_torch(scale), 1e-5)
    theirs = jax_modules.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5)
    assert max_abs_diff(ours, theirs) < TOL["module_f32"]


def test_rope_matches_jax():
    x = _rng(3).standard_normal((2, 9, 3, 20), dtype=np.float32)
    pos = np.arange(9, dtype=np.int32) + 5
    cos, sin = modules.rope_angles(to_torch(pos), 20, 10_000.0)
    jcos, jsin = jax_modules.rope_angles(jnp.asarray(pos), 20, 10_000.0)
    assert max_abs_diff(cos, jcos) < TOL["module_f32"]
    ours = modules.apply_rope(to_torch(x), cos, sin)
    theirs = jax_modules.apply_rope(jnp.asarray(x), jcos, jsin)
    assert max_abs_diff(ours, theirs) < TOL["module_f32"]


@pytest.mark.parametrize("Sq,window", [(1, None), (5, None), (5, 3)])
def test_naive_attention_matches_jax(Sq, window):
    """Decode-style: a few queries at the end of a cache whose unwritten
    slots carry far-future positions."""
    rng = _rng(4)
    Skv = 16
    q = rng.standard_normal((2, Sq, 3, 20), dtype=np.float32)
    k = rng.standard_normal((2, Skv, 1, 20), dtype=np.float32)
    v = rng.standard_normal((2, Skv, 1, 20), dtype=np.float32)
    qpos = np.arange(10, 10 + Sq, dtype=np.int32)
    kvpos = np.where(np.arange(Skv) < 10 + Sq, np.arange(Skv),
                     np.iinfo(np.int32).max // 2).astype(np.int32)
    kw = dict(causal=True, window=window)
    ours = modules.naive_attention(*(to_torch(a) for a in (q, k, v)),
                                   q_positions=to_torch(qpos),
                                   kv_positions=to_torch(kvpos), **kw)
    theirs = jax_modules.naive_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                         q_positions=jnp.asarray(qpos),
                                         kv_positions=jnp.asarray(kvpos), **kw)
    assert max_abs_diff(ours, theirs) < TOL["module_f32"]


def test_swiglu_mlp_matches_jax():
    rng = _rng(5)
    p = {"w_gate": rng.standard_normal((60, 96), dtype=np.float32) / 8,
         "w_up": rng.standard_normal((60, 96), dtype=np.float32) / 8,
         "w_down": rng.standard_normal((96, 60), dtype=np.float32) / 10}
    x = rng.standard_normal((2, 7, 60), dtype=np.float32)
    ours = ffn.apply_mlp({k: to_torch(a) for k, a in p.items()}, to_torch(x))
    theirs = jax_ffn.apply_mlp({k: jnp.asarray(a) for k, a in p.items()}, jnp.asarray(x))
    assert max_abs_diff(ours, theirs) < TOL["module_f32"]
