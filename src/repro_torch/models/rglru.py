"""RecurrentGemma / Griffin recurrent block (arXiv:2402.19427).

Block: x -> [branch_a: linear -> causal depthwise conv1d (width 4) -> RG-LRU]
            [branch_b: linear -> GeLU]
       y = out_proj(branch_a * branch_b)

RG-LRU: a_t = exp(-c * softplus(Lambda) * sigmoid(W_a x_t))        (c = 8)
        h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (sigmoid(W_x x_t) * x_t)

Prefill runs the linear recurrence through the CUDA scan kernel when
``run.use_pallas`` (its plain version on a CPU tensor), else through the plain
version ``linear_scan_ref``; decode is the exact single-step update.  The
cache (``h`` in f32, ``conv`` in the activation dtype) is updated in place,
where the JAX package returns an updated copy.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru.ops import linear_scan
from repro_torch.kernels.rglru.ref import linear_scan_ref
from repro_torch.utils.tree import ParamBuilder, fan_in_init

RG_LRU_C = 8.0


def init(pb: ParamBuilder, cfg):
    M = cfg.d_model
    D = M  # lru width = d_model
    W = cfg.rglru_conv_width

    def conv_init(gen, shape, dtype, device):
        x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return x.mul_(0.1).to(dtype)

    pb.param("w_in_a", (M, D), init=fan_in_init(M))
    pb.param("w_in_b", (M, D), init=fan_in_init(M))
    pb.param("conv_w", (W, D), init=conv_init)
    pb.param("w_gate_a", (D, D), init=fan_in_init(D))
    pb.param("w_gate_x", (D, D), init=fan_in_init(D))
    pb.param("lam", (D,), init=lambda gen, s, dtype, device: torch.ones(
        s, dtype=dtype, device=device))
    pb.param("w_out", (D, M), init=fan_in_init(D))


def _conv1d_causal(x, w, conv_state):
    """Depthwise causal conv. x: (B, S, D); w: (W, D); conv_state: (B, W-1, D).
    Tap ``W-1-i`` multiplies the input shifted by ``W-1-i`` steps, as in the
    JAX package.  Returns (out, the new conv state)."""
    W, S = w.shape[0], x.shape[1]
    xp = torch.cat([conv_state.to(x.dtype), x], dim=1)
    out = torch.zeros_like(x)
    for i in range(W):
        out = out + xp[:, i:i + S] * w[W - 1 - i].to(x.dtype)
    return out, xp[:, -(W - 1):]


def _promoted_matmul(x, w):
    """``x @ w`` in the dtype JAX's promotion gives the pair: f32 params
    against bf16 activations multiply in f32, as ``jnp.einsum`` does."""
    dtype = torch.promote_types(x.dtype, w.dtype)
    return x.to(dtype) @ w.to(dtype)


def _gates(p, xc):
    """Decay a and input b of the recurrence, both f32 (B, S, D)."""
    lam = F.softplus(p["lam"].float())
    r = torch.sigmoid(_promoted_matmul(xc, p["w_gate_a"]).float())
    log_a = -RG_LRU_C * lam * r                     # log a_t  (<= 0)
    i = torch.sigmoid(_promoted_matmul(xc, p["w_gate_x"]).float())
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - a.square(), min=1e-12))
    b = beta * i * xc.float()
    return a, b


def rg_lru_scan(p, xc, h0, use_kernel: bool = False):
    """xc: (B, S, D) conv output; h0: (B, D) f32.  Returns (y, h_final):
    the scan kernel with ``use_kernel``, else its plain version."""
    a, b = _gates(p, xc)
    y, h_final = (linear_scan if use_kernel else linear_scan_ref)(a, b, h0)
    return y.to(xc.dtype), h_final


def rg_lru_step(p, xc, h):
    """xc: (B, 1, D); h: (B, D) f32."""
    a, b = _gates(p, xc)
    h_new = a[:, 0] * h + b[:, 0]
    return h_new[:, None, :].to(xc.dtype), h_new


def init_cache(cfg, batch, dtype, device):
    """One layer's recurrent state: ``h`` (B, D) f32, ``conv`` (B, W-1, D)."""
    D, W = cfg.d_model, cfg.rglru_conv_width
    return {"h": torch.zeros((batch, D), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, W - 1, D), dtype=dtype, device=device)}


def _in_proj(p, x):
    return x @ p["w_in_a"].to(x.dtype), x @ p["w_in_b"].to(x.dtype)


def _out(p, y, xb):
    y = y * F.gelu(xb, approximate="tanh")     # jax.nn.gelu's default
    return y @ p["w_out"].to(y.dtype)


def apply(p, cfg, run, x, cache=None):
    """Full-sequence forward (prefill, logits). x: (B, S, M) -> (B, S, M).
    Starts from ``cache`` (zeros without one) and writes the final state into
    it in place."""
    if cache is None:
        cache = init_cache(cfg, x.shape[0], x.dtype, x.device)
    xa, xb = _in_proj(p, x)
    xc, conv_state = _conv1d_causal(xa, p["conv_w"], cache["conv"])
    y, h_final = rg_lru_scan(p, xc, cache["h"], use_kernel=run.use_pallas)
    cache["h"].copy_(h_final)
    cache["conv"].copy_(conv_state)
    return _out(p, y, xb)


def decode(p, cfg, run, x, cache):
    """One-token step. x: (B, 1, M); advances ``cache`` in place."""
    xa, xb = _in_proj(p, x)
    xc, conv_state = _conv1d_causal(xa, p["conv_w"], cache["conv"])
    y, h_new = rg_lru_step(p, xc, cache["h"])
    cache["h"].copy_(h_new)
    cache["conv"].copy_(conv_state)
    return _out(p, y, xb)
