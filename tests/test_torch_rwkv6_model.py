"""The port's rwkv6-3b (RWKV-6 blocks, untied embeddings) vs the JAX package,
on the same weights with every leaf that LM.init sets to a constant
perturbed: config, weight conversion, logits, prefill and its cache, decode
over more steps than a chunk, greedy generation, and the serving CLI."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro import configs as jax_configs
from repro.configs.base import RunConfig as JaxRunConfig
from repro.models import LM as JaxLM
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch import configs
from repro_torch.configs.base import MoEConfig, RunConfig
from repro_torch.convert import params_from_jax
from repro_torch.kernels.rwkv6.ops import wkv6
from repro_torch.launch import serve as serve_cli
from repro_torch.models import LM, transformer
from repro_torch.serve.engine import ServeEngine
from repro_torch.testing import (TOL, max_abs_diff, params_to_jax_layout, perturb_zero_leaves,
                                 perturbed_pair)

ARCH = "rwkv6-3b"
# chunks of 16, so a 37-token prompt spans three with a padded tail
JAX_RUN = JaxRunConfig(param_dtype="float32", activation_dtype="float32",
                       rwkv_chunk=16, loss_chunk=16)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


@pytest.fixture(scope="module")
def model():
    """JAX-initialised smoke weights, converted, perturbed by the port and
    carried back, so both packages hold the same perturbed weights."""
    jax_cfg, cfg = jax_configs.get_smoke_config(ARCH), configs.get_smoke_config(ARCH)
    jax_params, _ = JaxLM.init(jax_cfg, JAX_RUN, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jax_params)
    params, back = perturbed_pair(tree, cfg, 1)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    return (jax_cfg, jax.tree_util.tree_map(jnp.asarray, back), cfg,
            RunConfig(**dataclasses.asdict(JAX_RUN)), params)


@pytest.mark.parametrize("arch,per_layer", [("smollm-360m", {"attn": 2}),
                                            ("recurrentgemma-2b", {"attn": 2, "rglru": 3}),
                                            (ARCH, {"rwkv": 13})])
def test_perturbation_moves_every_constant_leaf(arch, per_layer):
    cfg = configs.get_smoke_config(arch)
    params = LM.init(cfg, RunConfig(param_dtype="float32"), seed=0, device="cpu")
    before = jax.tree_util.tree_map(torch.clone, params)
    gen = torch.Generator()
    gen.manual_seed(0)
    touched = perturb_zero_leaves(params, cfg, gen)
    assert touched == sum(per_layer[kind] for kind in cfg.layer_kinds) + 1
    moved = sum(not torch.equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(params),
                                                      jax.tree_util.tree_leaves(before)))
    assert moved == touched


def _runs(run, use_pallas):
    return (dataclasses.replace(JAX_RUN, use_pallas=use_pallas),
            dataclasses.replace(run, use_pallas=use_pallas))


# ---------------------------------------------------------------- config

@pytest.mark.parametrize("getter", ["get_config", "get_smoke_config"])
def test_config_matches_jax(getter):
    ours = getattr(configs, getter)(ARCH)
    theirs = getattr(jax_configs, getter)(ARCH)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert transformer.grouping(ours) == (("rwkv",), ours.n_layers, ())


def test_full_config_is_rwkv6_3b():
    cfg = configs.get_config(ARCH)
    assert cfg.layer_kinds == ("rwkv",) * 32
    assert (cfg.d_model, cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim) == (2560, 40, 64)
    assert (cfg.d_ff, cfg.vocab_size, cfg.tie_embeddings) == (8960, 65536, False)
    assert JaxLM.param_count(jax_configs.get_config(ARCH), JAX_RUN) == 3_073_313_280


# ---------------------------------------------------------------- params

def test_params_from_jax_carries_every_leaf_and_the_unembedding():
    jax_cfg, cfg = jax_configs.get_smoke_config(ARCH), configs.get_smoke_config(ARCH)
    jax_params, _ = JaxLM.init(jax_cfg, JAX_RUN, jax.random.PRNGKey(2))
    tree = jax.tree_util.tree_map(np.asarray, jax_params)
    ours = params_from_jax(tree, cfg, device="cpu")
    assert set(ours) == {"embed", "final_norm", "unembed", "layers"}
    assert tuple(ours["unembed"].shape) == (cfg.d_model, cfg.vocab_size)
    assert np.array_equal(ours["unembed"].numpy(), tree["unembed"])
    per_layer = len(jax.tree_util.tree_leaves(tree["stack"]["groups"][0]))
    assert per_layer == 22
    assert (len(jax.tree_util.tree_leaves(ours))
            == len(jax.tree_util.tree_leaves(tree)) + (cfg.n_layers - 1) * per_layer)
    assert (sum(t.numel() for t in jax.tree_util.tree_leaves(ours))
            == sum(a.size for a in jax.tree_util.tree_leaves(tree)))
    group = tree["stack"]["groups"][0]
    for g, layer in enumerate(ours["layers"]):
        assert np.array_equal(layer["bonus_u"].numpy(), group["bonus_u"][g])
        assert np.array_equal(layer["cm"]["wv"].numpy(), group["cm"]["wv"][g])
    # an untied tree without its unembedding is refused by name
    del tree["unembed"]
    with pytest.raises(NotImplementedError, match="unembed"):
        params_from_jax(tree, cfg, device="cpu")


def test_params_to_jax_layout_inverts_params_from_jax():
    jax_cfg, cfg = jax_configs.get_smoke_config(ARCH), configs.get_smoke_config(ARCH)
    jax_params, _ = JaxLM.init(jax_cfg, JAX_RUN, jax.random.PRNGKey(3))
    tree = jax.tree_util.tree_map(np.asarray, jax_params)
    back = params_to_jax_layout(params_from_jax(tree, cfg, device="cpu"), cfg)
    flat, ref = jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    assert all(np.array_equal(a, b) for a, b in zip(flat, ref))


def test_init_draws_the_unembedding_only_when_untied():
    cfg = configs.get_smoke_config(ARCH)
    run = RunConfig(param_dtype="float32")
    ours = LM.init(cfg, run, seed=0, device="cpu")
    assert tuple(ours["unembed"].shape) == (cfg.d_model, cfg.vocab_size)
    assert abs(ours["unembed"].std().item() * np.sqrt(cfg.d_model) - 1.0) < 0.05
    assert (sum(t.numel() for t in jax.tree_util.tree_leaves(ours))
            == JaxLM.param_count(jax_configs.get_smoke_config(ARCH), JAX_RUN))
    tied = LM.init(cfg.replace(tie_embeddings=True), run, seed=0, device="cpu")
    assert "unembed" not in tied


# ---------------------------------------------------------------- model

def _assert_cache_matches(cache, jax_cache, cfg):
    """The port's per-layer in-place caches hold what the JAX package's
    returned cache (one group slot stacked over the layers) holds."""
    src = jax_cache["groups"][0]
    assert set(src) == {"state", "tm_x_prev", "cm_x_prev"} and not jax_cache["tail"]
    for name, leaf in src.items():
        ours = torch.stack([c[name] for c in cache])
        assert tuple(ours.shape) == leaf.shape, name
        assert max_abs_diff(ours, leaf) < TOL["logits_f32"], name


@pytest.mark.parametrize("use_pallas", [False, True])
def test_logits_and_prefill_match_jax(model, use_pallas):
    jax_cfg, jax_params, cfg, run, params = model
    jax_run, run = _runs(run, use_pallas)
    toks = _tokens(3, (2, 37), cfg.vocab_size)
    ours = LM.logits(params, cfg, run, torch.from_numpy(toks))
    theirs = JaxLM.logits(jax_params, jax_cfg, jax_run, jnp.asarray(toks))
    assert ours.shape == (2, 37, cfg.vocab_size)
    assert max_abs_diff(ours, theirs) < TOL["logits_f32"]
    ours, cache = LM.prefill(params, cfg, run, torch.from_numpy(toks), max_seq=64)
    theirs, jax_cache = JaxLM.prefill(jax_params, jax_cfg, jax_run, jnp.asarray(toks),
                                      max_seq=64)
    assert ours.shape == (2, 1, cfg.vocab_size)
    assert max_abs_diff(ours, theirs) < TOL["logits_f32"]
    _assert_cache_matches(cache, jax_cache, cfg)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_decode_steps_match_jax(model, use_pallas):
    """20 steps after a 37-token prompt: more steps than one chunk of 16."""
    jax_cfg, jax_params, cfg, run, params = model
    jax_run, run = _runs(run, use_pallas)
    toks = _tokens(4, (2, 37), cfg.vocab_size)
    _, cache = LM.prefill(params, cfg, run, torch.from_numpy(toks), max_seq=64)
    _, jax_cache = JaxLM.prefill(jax_params, jax_cfg, jax_run, jnp.asarray(toks), max_seq=64)
    for i in range(20):
        nxt = _tokens(100 + i, (2, 1), cfg.vocab_size)
        pos = toks.shape[1] + i
        ours, cache = LM.decode_step(params, cfg, run, torch.from_numpy(nxt), cache, pos)
        theirs, jax_cache = JaxLM.decode_step(jax_params, jax_cfg, jax_run,
                                              jnp.asarray(nxt), jax_cache, jnp.int32(pos))
        assert max_abs_diff(ours, theirs) < TOL["logits_f32"], i
    _assert_cache_matches(cache, jax_cache, cfg)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_greedy_generate_matches_jax_token_for_token(model, use_pallas):
    jax_cfg, jax_params, cfg, run, params = model
    jax_run, run = _runs(run, use_pallas)
    prompts = _tokens(5, (2, 21), cfg.vocab_size)
    theirs = JaxServeEngine(jax_cfg, jax_run, jax_params, max_seq=48).generate(
        jnp.asarray(prompts), max_new_tokens=12)
    engine = ServeEngine(cfg, run, params, max_seq=48)
    ours = engine.generate(torch.from_numpy(prompts).long(), max_new_tokens=12)
    assert ours.shape == (2, 33)
    assert np.array_equal(ours.numpy(), np.asarray(theirs))


def test_logits_go_through_the_unembedding(model):
    *_, cfg, run, params = model
    toks = torch.from_numpy(_tokens(6, (1, 5), cfg.vocab_size)).long()
    zeroed = dict(params, unembed=torch.zeros_like(params["unembed"]))
    assert LM.logits(params, cfg, run, toks).abs().max() > 0
    assert not LM.logits(zeroed, cfg, run, toks).any()


def test_decode_state_does_not_depend_on_max_seq(model):
    """The recurrent cache holds no sequence axis: the same request gives the
    same tokens whatever max_seq the engine was given."""
    *_, cfg, run, params = model
    prompts = torch.from_numpy(_tokens(7, (2, 9), cfg.vocab_size)).long()
    outs = [ServeEngine(cfg, run, params, max_seq=m).generate(prompts, max_new_tokens=6)
            for m in (15, 200)]
    assert torch.equal(*outs)
    cache = transformer.init_cache(cfg, 2, 10_000, torch.float32, "cpu")
    assert max(t.numel() for c in cache for t in c.values()) == 2 * 4 * 16 * 16


def test_cpu_wrapper_launches_no_kernel(model):
    *_, cfg, run, params = model
    run = dataclasses.replace(run, use_pallas=True)
    before = wkv6.launches
    LM.prefill(params, cfg, run, torch.zeros((1, 5), dtype=torch.long), max_seq=8)
    assert wkv6.launches == before


@pytest.mark.parametrize("arch,change,name", [
    ("granite-8b", None, "granite-8b"),
    (ARCH, dict(moe=MoEConfig(n_experts=4, d_ff_expert=32)), "MoE"),
    (ARCH, dict(qk_norm=True), "qk_norm"),
    (ARCH, dict(mlp_variant="gelu"), "mlp_variant"),
])
def test_what_is_not_ported_is_still_refused_by_name(model, arch, change, name):
    *_, cfg, run, params = model
    if change is None:
        with pytest.raises(KeyError, match=name):
            configs.get_config(arch)
        return
    bad = cfg.replace(**change)
    with pytest.raises(NotImplementedError, match=name):
        LM.init(bad, run, device="cpu")
    with pytest.raises(NotImplementedError, match=name):
        ServeEngine(bad, run, params)


# ---------------------------------------------------------------- CLI

def test_serve_cli_runs_rwkv6_smoke_on_cpu(capsys):
    assert serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                           "--prompt-len", "20", "--new-tokens", "4"]) == 0
    out = capsys.readouterr().out
    assert "rwkv6-3b-smoke" in out and "tok/s" in out and "ms/token" in out
