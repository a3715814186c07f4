"""The port's smollm-360m smoke model end to end vs the JAX package, on the
same weights: logits, prefill, decode and greedy generation."""
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
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.launch import serve as serve_cli
from repro_torch.models import LM
from repro_torch.serve.engine import ServeEngine
from repro_torch.testing import TOL, max_abs_diff, perturbed_pair

ARCH = "smollm-360m"


@pytest.fixture(scope="module")
def model():
    """Smoke config and JAX-initialised weights, in both packages."""
    jax_run = JaxRunConfig(param_dtype="float32", activation_dtype="float32",
                           attn_block_q=8, attn_block_kv=8, loss_chunk=16)
    jax_cfg = jax_configs.get_smoke_config(ARCH)
    jax_params, _ = JaxLM.init(jax_cfg, jax_run, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params),
                             configs.get_smoke_config(ARCH), device="cpu")
    return (jax_cfg, jax_run, jax_params,
            configs.get_smoke_config(ARCH), RunConfig(**dataclasses.asdict(jax_run)),
            params)


@pytest.fixture(scope="module")
def perturbed_model(model):
    """The same weights with every leaf LM.init sets to a constant (the norm
    scales, final_norm included) given seeded noise, in both packages."""
    jax_cfg, jax_run, jax_params, cfg, run, _ = model
    params, tree = perturbed_pair(jax.tree_util.tree_map(np.asarray, jax_params), cfg, 1)
    return (jax_cfg, jax_run, jax.tree_util.tree_map(jnp.asarray, tree), cfg, run, params)


# (use_pallas, weights); the cases on the initial weights keep their ids
_WEIGHTS = [pytest.param(False, "model", id="False"),
            pytest.param(True, "model", id="True"),
            pytest.param(False, "perturbed_model", id="False-perturbed"),
            pytest.param(True, "perturbed_model", id="True-perturbed")]


def _runs(jax_run, run, use_pallas):
    return (dataclasses.replace(jax_run, use_pallas=use_pallas),
            dataclasses.replace(run, use_pallas=use_pallas))


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


@pytest.mark.parametrize("use_pallas,weights", _WEIGHTS)
def test_logits_and_prefill_match_jax(request, use_pallas, weights):
    jax_cfg, jax_run, jax_params, cfg, run, params = request.getfixturevalue(weights)
    jax_run, run = _runs(jax_run, run, use_pallas)
    toks = _tokens(3, (2, 21), cfg.vocab_size)
    ours = LM.logits(params, cfg, run, torch.from_numpy(toks))
    theirs = JaxLM.logits(jax_params, jax_cfg, jax_run, jnp.asarray(toks))
    assert ours.shape == (2, 21, cfg.vocab_size)
    assert max_abs_diff(ours, theirs) < TOL["logits_f32"]
    ours, _ = LM.prefill(params, cfg, run, torch.from_numpy(toks), max_seq=48)
    theirs, _ = JaxLM.prefill(jax_params, jax_cfg, jax_run, jnp.asarray(toks), max_seq=48)
    assert ours.shape == (2, 1, cfg.vocab_size)
    assert max_abs_diff(ours, theirs) < TOL["logits_f32"]


@pytest.mark.parametrize("use_pallas,weights", _WEIGHTS)
def test_decode_steps_match_jax(request, use_pallas, weights):
    jax_cfg, jax_run, jax_params, cfg, run, params = request.getfixturevalue(weights)
    jax_run, run = _runs(jax_run, run, use_pallas)
    toks = _tokens(4, (2, 19), cfg.vocab_size)
    _, cache = LM.prefill(params, cfg, run, torch.from_numpy(toks), max_seq=64)
    _, jax_cache = JaxLM.prefill(jax_params, jax_cfg, jax_run, jnp.asarray(toks), max_seq=64)
    for i in range(8):
        nxt = _tokens(100 + i, (2, 1), cfg.vocab_size)
        pos = toks.shape[1] + i
        ours, cache = LM.decode_step(params, cfg, run, torch.from_numpy(nxt), cache, pos)
        theirs, jax_cache = JaxLM.decode_step(jax_params, jax_cfg, jax_run,
                                              jnp.asarray(nxt), jax_cache, jnp.int32(pos))
        assert max_abs_diff(ours, theirs) < TOL["logits_f32"], i
    # the in-place cache holds what the JAX package's returned cache holds
    k_jax = np.asarray(jax_cache["groups"][0]["kv"]["k"])
    assert max_abs_diff(torch.stack([c["k"] for c in cache]), k_jax) < TOL["logits_f32"]


def test_greedy_generate_matches_jax_token_for_token(model):
    jax_cfg, jax_run, jax_params, cfg, run, params = model
    jax_run, run = _runs(jax_run, run, True)
    prompts = _tokens(5, (2, 12), cfg.vocab_size)
    theirs = JaxServeEngine(jax_cfg, jax_run, jax_params, max_seq=32).generate(
        jnp.asarray(prompts), max_new_tokens=8)
    engine = ServeEngine(cfg, run, params, max_seq=32)
    ours = engine.generate(torch.from_numpy(prompts).long(), max_new_tokens=8)
    assert ours.shape == (2, 20)
    assert np.array_equal(ours.numpy(), np.asarray(theirs))
    assert engine.stats.decode_steps == 7


def test_temperature_sampling_follows_the_generator(model):
    *_, cfg, run, params = model
    engine = ServeEngine(cfg, run, params, max_seq=32)
    prompts = torch.from_numpy(_tokens(6, (2, 12), cfg.vocab_size)).long()

    def sample(seed):
        gen = torch.Generator()
        gen.manual_seed(seed)
        return engine.generate(prompts, max_new_tokens=6, temperature=1.0, generator=gen)

    a, b = sample(7), sample(7)
    assert torch.equal(a, b)
    assert ((a >= 0) & (a < cfg.vocab_size)).all()
    with pytest.raises(ValueError, match="Generator"):
        engine.generate(prompts, max_new_tokens=2, temperature=1.0)


def test_cpu_wrapper_launches_no_kernel(model):
    *_, cfg, run, params = model
    run = dataclasses.replace(run, use_pallas=True)
    before = flash_attention.launches
    LM.logits(params, cfg, run, torch.zeros((1, 5), dtype=torch.long))
    assert flash_attention.launches == before


# rwkv blocks and untied embeddings are ported: each appears here beside an
# option that is not, which must still be named
@pytest.mark.parametrize("change,name", [
    (dict(qk_norm=True), "qk_norm"),
    (dict(sliding_window=16, moe=MoEConfig(n_experts=4, d_ff_expert=32)), "MoE"),
    (dict(family="hybrid", local_window=16, block_pattern=("rglru", "rwkv"),
          rwkv_head_dim=20, qk_norm=True), "qk_norm"),
    (dict(moe=MoEConfig(n_experts=4, d_ff_expert=32)), "MoE"),
    (dict(block_pattern=("rglru", "rglru", "attn"), qk_norm=True), "qk_norm"),
    (dict(family="ssm", rwkv_head_dim=20, moe=MoEConfig(n_experts=4, d_ff_expert=32)),
     "MoE"),
    (dict(mlp_variant="gelu"), "mlp_variant"),
    (dict(tie_embeddings=False, mlp_variant="gelu"), "mlp_variant"),
])
def test_unported_options_raise(model, change, name):
    *_, cfg, run, params = model
    bad = cfg.replace(**change)
    with pytest.raises(NotImplementedError, match=name):
        LM.init(bad, run, device="cpu")
    with pytest.raises(NotImplementedError, match=name):
        ServeEngine(bad, run, params)


@pytest.mark.parametrize("change", [
    dict(sliding_window=16),
    dict(family="hybrid", local_window=16),
    dict(family="hybrid", block_pattern=("rglru", "rglru", "attn"), local_window=16),
    dict(family="ssm", rwkv_head_dim=20),
    dict(family="hybrid", block_pattern=("rglru", "rwkv", "attn"), local_window=16,
         rwkv_head_dim=20),
    dict(tie_embeddings=False),
], ids=["sliding_window", "local_window", "rglru_blocks", "rwkv_blocks", "mixed_blocks",
        "untied"])
def test_windowed_and_rglru_options_are_ported(model, change):
    *_, cfg, run, _ = model
    cfg = cfg.replace(**change)
    params = LM.init(cfg, run, seed=0, device="cpu")
    engine = ServeEngine(cfg, run, params, max_seq=40)
    prompts = torch.from_numpy(_tokens(8, (1, 20), cfg.vocab_size)).long()
    out = engine.generate(prompts, max_new_tokens=4)
    assert out.shape == (1, 24) and ((out >= 0) & (out < cfg.vocab_size)).all()


def test_quantized_serving_and_training_raise(model):
    *_, cfg, run, params = model
    quant = dataclasses.replace(run, quantize_serving=True)
    with pytest.raises(NotImplementedError, match="quantize_serving"):
        ServeEngine(cfg, quant, params)
    with pytest.raises(NotImplementedError, match="quantize_serving"):
        LM.logits(params, cfg, quant, torch.zeros((1, 4), dtype=torch.long))
    with pytest.raises(NotImplementedError, match="training"):
        LM.loss(params, cfg, run, None, None)


def test_entry_points_default_to_cuda_and_refuse_without_it(model, monkeypatch):
    """Without device="cpu" every entry point asks for the card; where there
    is none it raises instead of running on the CPU."""
    jax_cfg, jax_run, jax_params, cfg, run, _ = model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LM.init(cfg, run)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params), cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_cli.main(["--smoke"])


def test_serve_cli_runs_the_smoke_config_on_cpu(capsys):
    assert serve_cli.main(["--smoke", "--device", "cpu", "--batch", "2",
                           "--prompt-len", "8", "--new-tokens", "4"]) == 0
    out = capsys.readouterr().out
    assert "smollm-360m-smoke" in out and "tok/s" in out and "ms/token" in out
