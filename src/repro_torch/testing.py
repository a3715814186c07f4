"""Helpers for holding the port against the JAX package: numpy <-> torch, the
tolerance table, the kernels' check shapes and seeded inputs, and the
perturbation of the leaves that ``LM.init`` sets to constants.

Arrays cross between the two frameworks as numpy arrays (``np.asarray`` of a
JAX array needs no JAX import here).  bf16 crosses as f32 values rounded to
bf16 on each side, which gives both the same bf16 inputs.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.convert import params_from_jax
from repro_torch.models import transformer

# max abs error allowed between the port and the JAX package, and why
TOL = {
    # the flash kernel bar of tests/test_kernels.py: f32 sums in another order;
    # bf16 outputs round once, at most one bf16 ulp apart
    "flash_f32": 5e-6,
    "flash_bf16": 2e-2,
    # single f32 modules: the same arithmetic up to summation order
    "module_f32": 1e-6,
    # a module run in bf16 activations, relative to its outputs' magnitude
    # (rel_diff): the two packages round f32 sums of another order to bf16,
    # so outputs sit up to two bf16 ulps (2**-8 of the value each) apart
    "module_bf16": 2.0 ** -6,
    # smoke-model logits and decode steps, the tests/test_decode.py bar
    "logits_f32": 1e-4,
    # the RG-LRU scan bar of tests/test_kernels.py, on y and h_T: f32 FMAs
    # against separate multiply and add, errors damped by |a| < 1
    "rglru_f32": 1e-5,
    # the WKV6 bar of tests/test_kernels.py, on y and the final state: sums
    # over N f32 terms in another order (and, against the JAX package's
    # chunked kernel, its exponent clamp at -60)
    "wkv6": 5e-5,
    # an RWKV-6 block part that runs an S-step recurrence (the chunked or
    # kernel time mix, apply, decode over steps) against the JAX package:
    # f32 sums of another order over the steps, at state magnitudes near 5;
    # about twice the largest error measured at the smoke config (7.0e-6)
    "rwkv_block_f32": 1.5e-5,
}

# (B, Sq, Skv, Hq, Hkv, D, window, dtype) at which the CUDA kernel is held
# against its plain version on the card
KERNEL_CHECK_SHAPES = (
    # the flash shapes of tests/test_kernels.py
    (2, 64, 64, 4, 2, 16, None, "float32"),
    (1, 100, 100, 6, 2, 32, None, "float32"),
    (2, 128, 128, 4, 1, 16, 32, "float32"),
    (1, 64, 64, 4, 4, 16, None, "bfloat16"),
    (1, 48, 48, 8, 2, 8, 16, "bfloat16"),
    # the smoke config's head_dim
    (2, 21, 21, 3, 1, 20, None, "float32"),
    # smollm-360m prefill: the serving run's shape, then the slice's own shape
    (4, 256, 256, 15, 5, 64, None, "float32"),
    (4, 512, 512, 15, 5, 64, None, "float32"),
    (4, 512, 512, 15, 5, 64, 128, "float32"),
    (4, 512, 512, 15, 5, 64, None, "bfloat16"),
    (4, 512, 512, 15, 5, 64, 128, "bfloat16"),
    # Sq != Skv, with rows that have no live key; the head dims 128 and 256
    (1, 100, 37, 6, 2, 32, 16, "float32"),
    (2, 70, 130, 4, 2, 128, None, "bfloat16"),
    # head_dim 256: recurrentgemma-2b's prefill (MQA, window 2048, a prompt
    # past the window) in f32 and bf16, a bf16 windowed shape, and head_dim
    # 200 padded to 256 with Sq > Skv and rows that have no live key
    (4, 2112, 2112, 10, 1, 256, 2048, "float32"),
    (4, 2112, 2112, 10, 1, 256, 2048, "bfloat16"),
    (2, 300, 300, 10, 1, 256, 128, "bfloat16"),
    (1, 130, 70, 4, 2, 200, 32, "float32"),
    # the tensor-core kernel's tile edges: one query and one key; lengths one
    # past the kv tiles of 32 and 64 keys (and the 16 of a D=256 variant);
    # head_dim 128 in f32; the f32 twin of the MQA (G = 10) D=256 shape; D=256
    # with Sq > Skv and rows that have no live key
    (2, 1, 1, 4, 2, 64, None, "float32"),
    (2, 33, 33, 4, 2, 64, None, "float32"),
    (1, 65, 65, 4, 1, 256, None, "float32"),
    (1, 65, 65, 4, 2, 128, None, "bfloat16"),
    (1, 17, 17, 2, 1, 256, None, "float32"),
    (2, 70, 130, 4, 2, 128, None, "float32"),
    (2, 300, 300, 10, 1, 256, 128, "float32"),
    (1, 130, 70, 4, 2, 256, 32, "float32"),
    # rows that are not 16-byte multiples (staged by plain loads, not
    # cp.async), with an odd head dim in f32
    (1, 40, 40, 4, 2, 20, None, "bfloat16"),
    (1, 50, 50, 2, 1, 33, 16, "float32"),
)

# (B, S, D) at which the CUDA RG-LRU scan is held against its plain version
# on the card, all from a nonzero h0
RGLRU_CHECK_SHAPES = (
    # the scan shapes of tests/test_kernels.py
    (2, 37, 16),
    (1, 64, 40),
    (2, 100, 24),
    (1, 17, 8),
    # one step, and recurrentgemma-2b's prefill
    (3, 1, 2560),
    (4, 2112, 2560),
)

# (B, H, S, N, dtype of r, k, v) at which the CUDA WKV6 kernel is held
# against its plain version on the card, all from a nonzero state0
WKV6_CHECK_SHAPES = (
    # the WKV6 shapes of tests/test_kernels.py
    (2, 3, 37, 16, "float32"),
    (1, 2, 64, 32, "float32"),
    (2, 2, 100, 8, "float32"),
    (1, 1, 16, 64, "float32"),
    # a tail: S not a multiple of 64 (nor of the kernel's 16-step tiles) at
    # N = 64; one step; the same tail with bf16 streams
    (2, 4, 75, 64, "float32"),
    (1, 2, 1, 16, "float32"),
    (2, 4, 75, 64, "bfloat16"),
    # rwkv6-3b's prefill in chip_smoke.py: 4 x 2100 tokens, 40 heads
    (4, 40, 2100, 64, "float32"),
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def live_pairs(Sq: int, Skv: int, window) -> int:
    """(q, k) pairs the causal (windowed) mask keeps, top-left aligned."""
    total = 0
    for i in range(Sq):
        lo = 0 if window is None else max(0, i - window + 1)
        total += max(0, min(i, Skv - 1) - lo + 1)
    return total


def flash_flops(shape) -> int:
    """The flops of causal attention at one ``KERNEL_CHECK_SHAPES`` entry:
    4 * D per live (q, k) pair and query head (Q K^T and P V)."""
    B, Sq, Skv, Hq, Hkv, D, window, dtype = shape
    return 4 * D * Hq * B * live_pairs(Sq, Skv, window)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 stored mantissa bits), ties away from
    zero: the rounding of ``cvt.rna.tf32.f32``.  Finite inputs only."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor, terms: int):
    """(hi, lo) with hi = tf32(x), lo = tf32(x - hi) for ``terms`` = 3, the
    kernel's split; lo = 0 for ``terms`` = 1 (plain TF32)."""
    hi = tf32_round(x)
    if terms == 1:
        return hi, torch.zeros_like(hi)
    if terms != 3:
        raise ValueError(f"terms must be 1 or 3, not {terms}")
    return hi, tf32_round(x.float() - hi)


def _split_product(a, b, terms: int, equation: str) -> torch.Tensor:
    """``einsum(equation, a, b)`` from the kernel's TF32 terms: each product
    of terms is exact, summed in f64 and rounded to f32 once.  The tensor
    cores do not sum so: they truncate the sums they accumulate, which the
    kernel keeps short (S in 4-k-step chunks, P V per tile).  That
    accumulation is left out here; only the card tests check it."""
    (ah, al), (bh, bl) = split_tf32(a, terms), split_tf32(b, terms)
    pairs = [(ah, bh)] if terms == 1 else [(al, bh), (ah, bl), (ah, bh)]
    return sum(torch.einsum(equation, x.double(), y.double()) for x, y in pairs).float()


def tf32_pv_key_order() -> list:
    """Which key of an 8-key step the tf32 P V fragments put at each column
    of the MMA's k index: the score fragment holds keys {2t, 2t+1} in lane t,
    fed where the A fragment expects {t, t+4}, so column c is key 2c for c < 4
    and key 2(c - 4) + 1 for c >= 4.  V's B fragment reads its rows in the
    same order."""
    return [2 * c if c < 4 else 2 * (c - 4) + 1 for c in range(8)]


def attention_split_tf32(q, k, v, causal: bool = True, window=None,
                         terms: int = 3) -> torch.Tensor:
    """Plain emulation of the flash kernel's f32 route: Q K^T and P V from
    TF32 terms (``terms`` = 3: lo*hi + hi*lo + hi*hi; 1: hi*hi), the softmax
    in f32 as ``attention_ref`` masks it, P unnormalised and split like the
    operands, divided by its row sum at the end.  The products are summed
    exactly (``_split_product``), not with the MMAs' truncated accumulation,
    so this shows how accurate the split is, not that the kernel's
    accumulation holds the bar.  q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D),
    f32; returns f32 (B, Sq, Hq, D)."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.float().permute(0, 2, 1, 3).reshape(B, Hkv, G, Sq, D)
    kg, vg = (t.float().permute(0, 2, 1, 3) for t in (k, v))
    s = _split_product(qg, kg, terms, "bhgqd,bhkd->bhgqk") * D ** -0.5
    qp, kp = torch.arange(Sq)[:, None], torch.arange(Skv)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= (qp - kp) < window
    s = torch.where(mask, s, torch.full((), -1e30))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = _split_product(p, vg, terms, "bhgqk,bhkd->bhgqd") / p.sum(-1, keepdim=True)
    return o.reshape(B, Hq, Sq, D).permute(0, 2, 1, 3)


def to_torch(a, dtype: str = "float32", device="cpu") -> torch.Tensor:
    """numpy (or array-like) -> torch tensor of ``dtype`` on ``device``."""
    a = np.asarray(a)
    if a.dtype.kind in "iu":
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    return t.to(device=device, dtype=_DTYPES[dtype])


def to_numpy(x) -> np.ndarray:
    """torch tensor or JAX/numpy array -> numpy; floats widen to f32."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.is_floating_point() else x).numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.kind == "f" or a.dtype.name == "bfloat16" else a


def attention_inputs(shape, seed: int = 0, device="cpu"):
    """Seeded q, k, v for one ``KERNEL_CHECK_SHAPES`` entry."""
    B, Sq, Skv, Hq, Hkv, D, _, dtype = shape
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, Hq, D), dtype=np.float32)
    k = rng.standard_normal((B, Skv, Hkv, D), dtype=np.float32)
    v = rng.standard_normal((B, Skv, Hkv, D), dtype=np.float32)
    return tuple(to_torch(a, dtype, device) for a in (q, k, v))


def scan_inputs(shape, seed: int = 0, device="cpu"):
    """Seeded a in (0, 1), b and a nonzero h0 (all f32) for one
    ``RGLRU_CHECK_SHAPES`` entry, drawn as tests/test_kernels.py draws them."""
    B, S, D = shape
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, D), dtype=np.float32)))
    b = rng.standard_normal((B, S, D), dtype=np.float32)
    h0 = rng.standard_normal((B, D), dtype=np.float32)
    return tuple(to_torch(x, "float32", device) for x in (a, b, h0))


def wkv_inputs(shape, seed: int = 0, device="cpu", seq_major: bool = False):
    """Seeded r, k, v (in the entry's dtype), logw, u and a nonzero state0
    (f32) for one ``WKV6_CHECK_SHAPES`` entry, at tests/test_kernels.py's
    scales: r and k x0.5, logw = -exp(0.5 n), u x0.3, state0 x0.2.  With
    ``seq_major`` the four (B, H, S, N) streams hold the same values as (1, 2)
    transposes of contiguous (B, S, H, N) tensors, the layout of the model's
    heads."""
    B, H, S, N, dtype = shape
    rng = np.random.default_rng(seed)

    def normal(*dims):
        return rng.standard_normal(dims, dtype=np.float32)

    r, k, v = normal(B, H, S, N) * 0.5, normal(B, H, S, N) * 0.5, normal(B, H, S, N)
    logw = -np.exp(normal(B, H, S, N) * 0.5)
    u, state0 = normal(H, N) * 0.3, normal(B, H, N, N) * 0.2

    def stream(a, dt):
        if seq_major:
            return to_torch(a.transpose(0, 2, 1, 3), dt, device).transpose(1, 2)
        return to_torch(a, dt, device)

    return (*(stream(a, dtype) for a in (r, k, v)), stream(logw, "float32"),
            *(to_torch(a, "float32", device) for a in (u, state0)))


# The leaves that LM.init sets to constants, by layer kind ("cm.mix_k" is
# mix_k of the child "cm"), besides the top-level final_norm.
_CONSTANT_LEAVES = {
    "attn": ("norm1", "norm2"),
    "rglru": ("norm1", "norm2", "rec.lam"),
    "rwkv": ("norm_tm", "norm_cm", "mix_r", "mix_k", "mix_v", "mix_w", "mix_g",
             "w_bias", "w_lora_b", "bonus_u", "ln_x_scale", "cm.mix_k", "cm.mix_r"),
}
# std of the normal noise perturb_zero_leaves adds to each leaf: 0.1 on the
# norm scales (gains 1 + scale), lam and the decay bias spread by 0.5, the
# bonus at the kernel tests' scale of u; every mix_* is drawn afresh from
# U[0, 1), the range of trained RWKV mixes
_NOISE_STD = {"norm1": 0.1, "norm2": 0.1, "final_norm": 0.1, "norm_tm": 0.1,
              "norm_cm": 0.1, "ln_x_scale": 0.1, "lam": 0.5, "w_bias": 0.5,
              "bonus_u": 0.3, "w_lora_b": 0.1}


def perturb_zero_leaves(params, cfg, generator: torch.Generator) -> int:
    """Give every leaf that ``LM.init`` sets to zeros, ones or another
    constant (norm scales, the RG-LRU ``lam``, RWKV-6's mixes, decay bias and
    LoRA, bonus and ``ln_x_scale``) seeded noise from ``generator``, in place,
    so that a parity test exercises them.  Normal noise of std
    ``_NOISE_STD[name]`` is added; ``mix_*`` leaves are set to U[0, 1) draws.
    Leaves are visited in layer order, then by name.  Returns the number of
    leaves touched."""
    dev = generator.device

    def perturb(leaf, name) -> None:
        if name.startswith("mix_"):
            leaf.copy_(torch.rand(leaf.shape, generator=generator, device=dev))
        else:
            noise = torch.randn(leaf.shape, generator=generator, device=dev)
            leaf.add_(noise.mul_(_NOISE_STD[name]).to(leaf.dtype))

    touched = []
    for layer, kind in zip(params["layers"], cfg.layer_kinds, strict=True):
        for path in sorted(_CONSTANT_LEAVES[kind]):
            *parents, name = path.split(".")
            node = layer
            for parent in parents:
                node = node[parent]
            touched.append((node[name], name))
    touched.append((params["final_norm"], "final_norm"))
    with torch.no_grad():
        for leaf, name in touched:
            perturb(leaf, name)
    return len(touched)


def params_to_jax_layout(params, cfg) -> dict:
    """The port's params -> a tree of f32 numpy arrays laid out as the JAX
    package's ``LM.init`` lays them out (``stack.groups`` stacked over the
    groups, then ``stack.tail``): the inverse of ``convert.params_from_jax``,
    so that both packages can run on the same perturbed weights."""
    pattern, n_groups, tail = transformer.grouping(cfg)
    layers = params["layers"]

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return np.stack([to_numpy(t) for t in trees])

    def one(tree):
        return {k: one(v) if isinstance(v, dict) else to_numpy(v) for k, v in tree.items()}

    P = len(pattern)
    tree = {k: to_numpy(v) for k, v in params.items() if k != "layers"}
    tree["stack"] = {
        "groups": tuple(stack([layers[g * P + j] for g in range(n_groups)])
                        for j in range(P)),
        "tail": tuple(one(layers[n_groups * P + i]) for i in range(len(tail))),
    }
    return tree


def perturbed_pair(tree, cfg, seed: int):
    """JAX ``LM.init`` params of ``cfg`` (numpy leaves) -> (the port's params
    on the CPU with ``perturb_zero_leaves`` applied from ``seed``, the same
    weights laid out as the JAX package's tree), for parity tests on weights
    whose norms, mixes and biases are not at their initial constants."""
    params = params_from_jax(tree, cfg, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(seed)
    perturb_zero_leaves(params, cfg, gen)
    return params, params_to_jax_layout(params, cfg)


def max_abs_diff(a, b) -> float:
    return float(np.max(np.abs(to_numpy(a).astype(np.float64)
                               - to_numpy(b).astype(np.float64))))


def rel_diff(a, b) -> float:
    """``max_abs_diff(a, b)`` over ``max(1, max |b|)``: an error measured in
    units of the reference's magnitude, for bars that scale with it."""
    return max_abs_diff(a, b) / max(1.0, float(np.max(np.abs(to_numpy(b)))))
