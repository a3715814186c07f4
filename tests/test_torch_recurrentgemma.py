"""The port's recurrentgemma-2b and its ring KV cache vs the JAX package, on
the same weights: config, weight conversion in layer order, logits, prefill,
decode past the window, greedy generation, and the serving CLI."""
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
from repro_torch.configs.base import RunConfig
from repro_torch.convert import params_from_jax
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.rglru.ops import linear_scan
from repro_torch.launch import serve as serve_cli
from repro_torch.models import LM, attention, transformer
from repro_torch.serve.engine import ServeEngine
from repro_torch.testing import TOL, max_abs_diff, perturbed_pair

ARCH = "recurrentgemma-2b"
JAX_RUN = JaxRunConfig(param_dtype="float32", activation_dtype="float32",
                       attn_block_q=8, attn_block_kv=8, loss_chunk=16)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _pair(jax_cfg, cfg, seed=0):
    """JAX-initialised weights of ``jax_cfg`` (the port's ``cfg``) in both
    packages."""
    jax_params, _ = JaxLM.init(jax_cfg, JAX_RUN, jax.random.PRNGKey(seed))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params),
                             cfg, device="cpu")
    return jax_params, params


@pytest.fixture(scope="module")
def model():
    jax_cfg, cfg = jax_configs.get_smoke_config(ARCH), configs.get_smoke_config(ARCH)
    jax_params, params = _pair(jax_cfg, cfg)
    return (jax_cfg, jax_params, cfg,
            RunConfig(**dataclasses.asdict(JAX_RUN)), params)


@pytest.fixture(scope="module")
def perturbed_model(model):
    """The same weights with every leaf LM.init sets to a constant (norm
    scales, final_norm, lam) given seeded noise, in both packages."""
    jax_cfg, jax_params, cfg, run, _ = model
    params, tree = perturbed_pair(jax.tree_util.tree_map(np.asarray, jax_params), cfg, 1)
    return jax_cfg, jax.tree_util.tree_map(jnp.asarray, tree), cfg, run, params


# (use_pallas, weights); the cases on the initial weights keep their ids
_WEIGHTS = [pytest.param(False, "model", id="False"),
            pytest.param(True, "model", id="True"),
            pytest.param(False, "perturbed_model", id="False-perturbed"),
            pytest.param(True, "perturbed_model", id="True-perturbed")]


def _runs(run, use_pallas):
    return (dataclasses.replace(JAX_RUN, use_pallas=use_pallas),
            dataclasses.replace(run, use_pallas=use_pallas))


# ---------------------------------------------------------------- config

@pytest.mark.parametrize("getter", ["get_config", "get_smoke_config"])
def test_config_matches_jax(getter):
    ours = getattr(configs, getter)(ARCH)
    theirs = getattr(jax_configs, getter)(ARCH)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert transformer.grouping(ours) == (("rglru", "rglru", "attn"),
                                          ours.n_layers // 3, ("rglru", "rglru"))


def test_full_config_is_recurrentgemma_2b():
    cfg = configs.get_config(ARCH)
    kinds = cfg.layer_kinds
    assert len(kinds) == 26 and kinds.count("attn") == 8 and kinds.count("rglru") == 18
    assert kinds[-2:] == ("rglru", "rglru")
    assert transformer.kind_window(cfg, "attn") == 2048
    assert cfg.resolved_head_dim == 256


# ---------------------------------------------------------------- params

def test_params_from_jax_takes_groups_then_tail_in_layer_order():
    jax_cfg = jax_configs.get_smoke_config(ARCH).replace(n_layers=8)   # 2 groups + 2
    jax_params, _ = JaxLM.init(jax_cfg, JAX_RUN, jax.random.PRNGKey(1))
    tree = jax.tree_util.tree_map(np.asarray, jax_params)
    ours = params_from_jax(tree, configs.get_smoke_config(ARCH).replace(n_layers=8),
                           device="cpu")
    groups, tail = tree["stack"]["groups"], tree["stack"]["tail"]
    assert len(groups) == 3 and len(tail) == 2 and len(ours["layers"]) == 8
    expect = [(groups[j], g) for g in range(2) for j in range(3)] + [(t, None) for t in tail]
    for layer, (src, g) in zip(ours["layers"], expect):
        flat = jax.tree_util.tree_flatten_with_path(src)[0]
        assert len(flat) == len(jax.tree_util.tree_leaves(layer))
        for path, leaf in flat:
            node = layer
            for p in path:
                node = node[p.key]
            assert np.array_equal(node.numpy(), leaf if g is None else leaf[g])
    assert set(ours["layers"][2]) == {"norm1", "norm2", "attn", "mlp"}
    assert set(ours["layers"][7]["rec"]) == {"w_in_a", "w_in_b", "conv_w", "w_gate_a",
                                            "w_gate_x", "lam", "w_out"}
    assert (sum(t.numel() for t in jax.tree_util.tree_leaves(ours))
            == sum(a.size for a in jax.tree_util.tree_leaves(tree)))


def _shapes(tree, drop=0):
    return {jax.tree_util.keystr(path): tuple(leaf.shape)[drop:]
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_init_gives_each_layer_its_kind():
    cfg = configs.get_smoke_config(ARCH)
    ours = LM.init(cfg, RunConfig(param_dtype="float32"), seed=0, device="cpu")
    theirs, _ = JaxLM.init(jax_configs.get_smoke_config(ARCH), JAX_RUN, abstract=True)
    assert len(ours["layers"]) == cfg.n_layers == 5
    for i, kind in enumerate(cfg.layer_kinds):
        src = (_shapes(theirs["stack"]["groups"][i], drop=1) if i < 3
               else _shapes(theirs["stack"]["tail"][i - 3]))
        assert _shapes(ours["layers"][i]) == src, i
        assert ("rec" in ours["layers"][i]) == (kind == "rglru")
    assert torch.equal(ours["layers"][0]["rec"]["lam"], torch.ones(cfg.d_model))


# ---------------------------------------------------------------- model

@pytest.mark.parametrize("use_pallas,weights", _WEIGHTS)
def test_logits_and_prefill_match_jax(request, use_pallas, weights):
    jax_cfg, jax_params, cfg, run, params = request.getfixturevalue(weights)
    jax_run, run = _runs(run, use_pallas)
    toks = _tokens(3, (2, 21), cfg.vocab_size)          # longer than the window
    ours = LM.logits(params, cfg, run, torch.from_numpy(toks))
    theirs = JaxLM.logits(jax_params, jax_cfg, jax_run, jnp.asarray(toks))
    assert ours.shape == (2, 21, cfg.vocab_size)
    assert max_abs_diff(ours, theirs) < TOL["logits_f32"]
    ours, cache = LM.prefill(params, cfg, run, torch.from_numpy(toks), max_seq=48)
    theirs, jax_cache = JaxLM.prefill(jax_params, jax_cfg, jax_run, jnp.asarray(toks),
                                      max_seq=48)
    assert ours.shape == (2, 1, cfg.vocab_size)
    assert max_abs_diff(ours, theirs) < TOL["logits_f32"]
    _assert_cache_matches(cache, jax_cache, cfg)


def _assert_cache_matches(cache, jax_cache, cfg):
    """The port's per-layer in-place caches hold what the JAX package's
    returned (groups, tail) cache holds."""
    for i, kind in enumerate(cfg.layer_kinds):
        g, j = divmod(i, 3)
        src = (jax.tree_util.tree_map(lambda a: a[g], jax_cache["groups"][j])
               if g < cfg.n_layers // 3 else jax_cache["tail"][i - 3 * (cfg.n_layers // 3)])
        src = src["kv"] if kind == "attn" else src["rec"]
        assert set(cache[i]) == set(src)
        for name, leaf in src.items():
            assert tuple(cache[i][name].shape) == leaf.shape, (i, name)
            assert max_abs_diff(cache[i][name], leaf) < TOL["logits_f32"], (i, name)


@pytest.mark.parametrize("use_pallas,weights", _WEIGHTS)
def test_decode_steps_past_the_window_match_jax(request, use_pallas, weights):
    """S0 = 19 > window 16: prefill rolls the ring and every step wraps it."""
    jax_cfg, jax_params, cfg, run, params = request.getfixturevalue(weights)
    jax_run, run = _runs(run, use_pallas)
    toks = _tokens(4, (2, 19), cfg.vocab_size)
    _, cache = LM.prefill(params, cfg, run, torch.from_numpy(toks), max_seq=64)
    _, jax_cache = JaxLM.prefill(jax_params, jax_cfg, jax_run, jnp.asarray(toks), max_seq=64)
    assert cache[2]["k"].shape[1] == cfg.local_window
    for i in range(8):
        nxt = _tokens(100 + i, (2, 1), cfg.vocab_size)
        pos = toks.shape[1] + i
        ours, cache = LM.decode_step(params, cfg, run, torch.from_numpy(nxt), cache, pos)
        theirs, jax_cache = JaxLM.decode_step(jax_params, jax_cfg, jax_run,
                                              jnp.asarray(nxt), jax_cache, jnp.int32(pos))
        assert max_abs_diff(ours, theirs) < TOL["logits_f32"], i
    _assert_cache_matches(cache, jax_cache, cfg)


@pytest.mark.parametrize("prompt_len", [12, 20])
def test_greedy_generate_matches_jax_token_for_token(model, prompt_len):
    jax_cfg, jax_params, cfg, run, params = model
    jax_run, run = _runs(run, True)
    prompts = _tokens(5, (2, prompt_len), cfg.vocab_size)
    theirs = JaxServeEngine(jax_cfg, jax_run, jax_params, max_seq=32).generate(
        jnp.asarray(prompts), max_new_tokens=10)
    engine = ServeEngine(cfg, run, params, max_seq=32)
    ours = engine.generate(torch.from_numpy(prompts).long(), max_new_tokens=10)
    assert ours.shape == (2, prompt_len + 10)
    assert np.array_equal(ours.numpy(), np.asarray(theirs))


def test_cpu_wrappers_launch_no_kernel(model):
    *_, cfg, run, params = model
    run = dataclasses.replace(run, use_pallas=True)
    flash, scan = flash_attention.launches, linear_scan.launches
    LM.prefill(params, cfg, run, torch.zeros((1, 5), dtype=torch.long), max_seq=8)
    assert (flash_attention.launches, linear_scan.launches) == (flash, scan)


def test_params_from_jax_refuses_a_tree_split_unlike_the_config():
    """smollm's single attention slot is not recurrentgemma's three slots plus
    a tail, and a group slot must stack n_groups layers."""
    jax_cfg = jax_configs.get_smoke_config("smollm-360m")
    jax_params, _ = JaxLM.init(jax_cfg, JAX_RUN, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jax_params)
    with pytest.raises(ValueError, match="group slots"):
        params_from_jax(tree, configs.get_smoke_config(ARCH), device="cpu")
    short = configs.get_smoke_config("smollm-360m").replace(n_layers=jax_cfg.n_layers + 1)
    with pytest.raises(ValueError, match="stacks"):
        params_from_jax(tree, short, device="cpu")


# ---------------------------------------------------------------- ring cache

@pytest.fixture(scope="module")
def windowed():
    """smollm-360m's smoke config with a 16-token sliding window."""
    jax_cfg = jax_configs.get_smoke_config("smollm-360m").replace(sliding_window=16)
    cfg = configs.get_smoke_config("smollm-360m").replace(sliding_window=16)
    jax_params, params = _pair(jax_cfg, cfg, seed=2)
    return jax_cfg, jax_params, cfg, RunConfig(**dataclasses.asdict(JAX_RUN)), params


@pytest.mark.parametrize("prompt_len", [10, 16, 23])
def test_ring_cache_prefill_and_decode_past_the_window_match_jax(windowed, prompt_len):
    """Sp < W, Sp = W and Sp > W, then 20 steps that wrap the ring."""
    jax_cfg, jax_params, cfg, run, params = windowed
    jax_run, run = _runs(run, True)
    toks = _tokens(6, (2, prompt_len), cfg.vocab_size)
    ours, cache = LM.prefill(params, cfg, run, torch.from_numpy(toks), max_seq=64)
    theirs, jax_cache = JaxLM.prefill(jax_params, jax_cfg, jax_run, jnp.asarray(toks),
                                      max_seq=64)
    assert max_abs_diff(ours, theirs) < TOL["logits_f32"]
    k_jax = jax_cache["groups"][0]["kv"]["k"]
    assert k_jax.shape[2] == 16 and cache[0]["k"].shape[1] == 16
    assert max_abs_diff(torch.stack([c["k"] for c in cache]), k_jax) < TOL["logits_f32"]
    for i in range(20):
        nxt = _tokens(200 + i, (2, 1), cfg.vocab_size)
        pos = prompt_len + i
        ours, cache = LM.decode_step(params, cfg, run, torch.from_numpy(nxt), cache, pos)
        theirs, jax_cache = JaxLM.decode_step(jax_params, jax_cfg, jax_run,
                                              jnp.asarray(nxt), jax_cache, jnp.int32(pos))
        assert max_abs_diff(ours, theirs) < TOL["logits_f32"], i
    assert max_abs_diff(torch.stack([c["v"] for c in cache]),
                        jax_cache["groups"][0]["kv"]["v"]) < TOL["logits_f32"]


def test_ring_positions_follow_the_slots():
    """Slot pos % S holds pos; the others hold the S-1 positions before it,
    and slots not written yet hold a far-future position."""
    dev = torch.device("cpu")
    assert attention._ring_positions(4, 2, dev).tolist()[:3] == [0, 1, 2]
    assert attention._ring_positions(4, 2, dev)[3] > 10 ** 6
    assert attention._ring_positions(4, 5, dev).tolist() == [4, 5, 2, 3]
    assert attention._ring_positions(4, 7, dev).tolist() == [4, 5, 6, 7]
    assert attention.cache_len(64, 16) == 16 and attention.cache_len(8, 16) == 8
    assert attention.cache_len(64) == 64


def test_full_cache_decode_refuses_a_position_past_it():
    cfg = configs.get_smoke_config("smollm-360m")
    p = LM.init(cfg, RunConfig(param_dtype="float32"), seed=0, device="cpu")["layers"][0]
    cache = attention.init_cache(cfg, 1, 8, torch.float32, "cpu")
    with pytest.raises(ValueError, match="outside a cache"):
        attention.decode(p["attn"], cfg, RunConfig(), torch.zeros(1, 1, cfg.d_model),
                         cache, 8)


def test_full_cache_prefill_refuses_a_prompt_past_it():
    cfg = configs.get_smoke_config("smollm-360m")
    cache = attention.init_cache(cfg, 1, 8, torch.float32, "cpu")
    kv = torch.zeros(1, 9, cfg.n_kv_heads, cfg.resolved_head_dim)
    with pytest.raises(ValueError, match="does not fit"):
        attention.prefill_cache(cache, kv, kv)
    attention.prefill_cache(cache, kv[:, :8], kv[:, :8])


# ---------------------------------------------------------------- CLI

def test_serve_cli_runs_recurrentgemma_smoke_on_cpu(capsys):
    assert serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                           "--prompt-len", "20", "--new-tokens", "4"]) == 0
    out = capsys.readouterr().out
    assert "recurrentgemma-2b-smoke" in out and "tok/s" in out and "ms/token" in out
