"""RWKV-6 "Finch" block (arXiv:2404.05892): data-dependent decay linear
attention (time-mix) and a squared-ReLU channel-mix, both with token shift.

Prefill runs the WKV recurrence through the CUDA kernel when
``run.use_pallas`` (its plain version on a CPU tensor), else through
``time_mix_chunked``, the JAX package's chunked formulation in plain
PyTorch, which reads ``run.rwkv_chunk`` and ``run.rwkv_bf16_streams``.
Decode is the exact single-token recurrence over the (N, N) f32 state of
each head.  The block applies its own norms (``norm_tm``, ``norm_cm``) and
residuals.  The cache (``state`` in f32; ``tm_x_prev`` and ``cm_x_prev``,
the normed last token of each half, in the activation dtype) is updated in
place, where the JAX package returns an updated copy.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6.ops import wkv6
from repro_torch.models.modules import rms_norm
from repro_torch.utils.tree import ParamBuilder, fan_in_init, zeros_init

LORA_RANK = 64


def init(pb: ParamBuilder, cfg):
    M, N = cfg.d_model, cfg.rwkv_head_dim
    if M % N:
        raise ValueError(f"d_model {M} is not a multiple of rwkv_head_dim {N}")
    for z in ("r", "k", "v", "w", "g"):
        pb.param(f"mix_{z}", (M,), init=zeros_init)
    pb.param("w_bias", (M,), init=lambda gen, s, dtype, device: torch.full(
        s, -1.0, dtype=dtype, device=device))       # exp(-exp(-1)) ~ .69 decay
    pb.param("w_lora_a", (M, LORA_RANK), init=fan_in_init(M))
    pb.param("w_lora_b", (LORA_RANK, M), init=zeros_init)
    pb.param("bonus_u", (M,), init=zeros_init)
    for z in ("r", "k", "v", "g", "o"):
        pb.param(f"w{z}", (M, M), init=fan_in_init(M))
    pb.param("ln_x_scale", (M,), init=zeros_init)
    cm = pb.child("cm")
    cm.param("mix_k", (M,), init=zeros_init)
    cm.param("mix_r", (M,), init=zeros_init)
    cm.param("wk", (M, cfg.d_ff), init=fan_in_init(M))
    cm.param("wv", (cfg.d_ff, M), init=fan_in_init(cfg.d_ff))
    cm.param("wr", (M, M), init=fan_in_init(M))


def init_block(pb: ParamBuilder, cfg):
    pb.param("norm_tm", (cfg.d_model,), init=zeros_init)
    pb.param("norm_cm", (cfg.d_model,), init=zeros_init)
    init(pb, cfg)


def _token_shift(x, x_prev):
    """shift(x)_t = x_{t-1}; ``x_prev`` (B, M) is the last token before x
    (zeros at sequence start).  x: (B, S, M)."""
    return torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)


def _mix(x, sx, mu):
    return x + (sx - x) * mu.to(x.dtype)


def _projections(p, cfg, x, x_prev):
    """r, k, v, the silu gate g (all x.dtype) and the per-token per-channel
    log decay ``logw`` in f32, in (-inf, 0)."""
    sx = _token_shift(x, x_prev)
    xr, xk, xv, xw, xg = (_mix(x, sx, p[f"mix_{z}"]) for z in ("r", "k", "v", "w", "g"))
    r = xr @ p["wr"].to(x.dtype)
    k = xk @ p["wk"].to(x.dtype)
    v = xv @ p["wv"].to(x.dtype)
    g = F.silu(xg @ p["wg"].to(x.dtype))
    lora = torch.tanh(xw @ p["w_lora_a"].to(x.dtype)) @ p["w_lora_b"].to(x.dtype)
    logw = -torch.exp(torch.clamp(p["w_bias"].float() + lora.float(), -8.0, 4.0))
    return r, k, v, g, logw


def _heads(x, N):
    """(B, S, M) -> (B, H, S, N), a view."""
    B, S, M = x.shape
    return x.reshape(B, S, M // N, N).transpose(1, 2)


def _output(p, cfg, y, g, dtype):
    """y (B, S, M) of the recurrence -> the time-mix output in ``dtype``."""
    y = rms_norm(y.to(dtype), p["ln_x_scale"], cfg.norm_eps) * g
    return y @ p["wo"].to(dtype)


def time_mix_chunked(p, cfg, x, x_prev, state, *, chunk=64, bf16_streams=False):
    """The plain prefill path.  x: (B, S, M); state: (B, H, N, N).  Returns
    (y, new_x_prev, new_state).

    Within a chunk of L steps the pairwise decay exp(c_{t-1} - c_s) (c the
    inclusive cumulative log decay, s < t) is materialised directly, always
    <= 1; chunks are carried by a loop over the state.  S pads to a multiple
    of L with logw = 0 and k = v = 0, which leave the state as it is.
    """
    B, S, M = x.shape
    N = cfg.rwkv_head_dim
    H = M // N
    r, k, v, g, logw = _projections(p, cfg, x, x_prev)
    u = p["bonus_u"].float().reshape(H, N)

    L = min(chunk, S)
    Sp = -(-S // L) * L
    if Sp != S:
        pad = (0, 0, 0, Sp - S)
        r, k, v, logw = (F.pad(t, pad) for t in (r, k, v, logw))
    nC = Sp // L
    sdt = torch.bfloat16 if bf16_streams else torch.float32
    rh, kh, vh = (_heads(t, N).reshape(B, H, nC, L, N).to(sdt) for t in (r, k, v))
    wh = _heads(logw.float(), N).reshape(B, H, nC, L, N)
    tri = torch.tril(torch.ones((L, L), dtype=torch.float32, device=x.device), -1)

    S_c = state.float()
    ys = []
    for ic in range(nC):
        rc, kc, vc = (t[:, :, ic].float() for t in (rh, kh, vh))      # (B, H, L, N)
        wc = wh[:, :, ic]
        c = torch.cumsum(wc, dim=2)                   # inclusive cumulative log decay
        c_prev = c - wc                               # c_{t-1} (exclusive)
        # intra-chunk: A[t,s] = sum_i r[t,i] k[s,i] exp(c_prev[t,i] - c[s,i]), s < t
        D = torch.exp(torch.clamp(c_prev[:, :, :, None, :] - c[:, :, None, :, :],
                                  -60.0, 0.0))
        A = torch.einsum("bhti,bhsi,bhtsi->bhts", rc, kc, D) * tri
        diag = torch.einsum("hi,bhti,bhti->bht", u, rc, kc)
        y = A @ vc + diag[..., None] * vc
        # inter-chunk: y_t += (r_t * exp(c_prev_t)) @ S_in
        y = y + (rc * torch.exp(c_prev)) @ S_c
        # S_out = diag(exp(c_L)) S_in + sum_s (k_s exp(c_L - c_s)) v_s^T
        c_last = c[:, :, -1:, :]
        k_dec = kc * torch.exp(torch.clamp(c_last - c, -60.0, 0.0))
        S_c = torch.exp(c_last[:, :, 0])[..., None] * S_c \
            + torch.einsum("bhsi,bhsn->bhin", k_dec, vc)
        ys.append(y)
    y = torch.stack(ys, dim=2).reshape(B, H, Sp, N).transpose(1, 2).reshape(B, Sp, M)
    y = _output(p, cfg, y[:, :S], g, x.dtype)
    return y, x[:, -1, :], S_c.to(state.dtype)


def time_mix_kernel(p, cfg, x, x_prev, state):
    """The kernel prefill path: ``wkv6`` on the (B, H, S, N) heads, whose
    streams go in x's dtype as the JAX package hands them to its kernel.  The
    heads are views of the (B, S, M) projections, which the kernel reads in
    place, and y comes back in the same layout.  Returns (y, new_x_prev,
    new_state)."""
    B, S, M = x.shape
    N = cfg.rwkv_head_dim
    r, k, v, g, logw = _projections(p, cfg, x, x_prev)
    y, state_f = wkv6(*(_heads(t, N) for t in (r, k, v, logw)),
                      p["bonus_u"].float().reshape(-1, N), state)
    y = y.transpose(1, 2).reshape(B, S, M)      # a view: y is (B, S, H, N) in memory
    return _output(p, cfg, y, g, x.dtype), x[:, -1, :], state_f


def time_mix_decode(p, cfg, x, x_prev, state):
    """Single-token recurrence.  x: (B, 1, M); state: (B, H, N, N) f32.
    Returns (y, new_x_prev, new_state)."""
    B, _, M = x.shape
    N = cfg.rwkv_head_dim
    H = M // N
    r, k, v, g, logw = _projections(p, cfg, x, x_prev)
    rh, kh, vh = (t.reshape(B, H, N).float() for t in (r, k, v))
    wh = torch.exp(logw.reshape(B, H, N).float())
    u = p["bonus_u"].float().reshape(H, N)
    kv = kh[..., :, None] * vh[..., None, :]                       # (B, H, N, N)
    y = torch.einsum("bhi,bhin->bhn", rh, state + u[None, :, :, None] * kv)
    state = wh[..., None] * state + kv
    return _output(p, cfg, y.reshape(B, 1, M), g, x.dtype), x[:, -1, :], state


def channel_mix(p, x, x_prev):
    """Squared-ReLU channel mix with a sigmoid receptance gate.  Returns
    (y, new_x_prev)."""
    sx = _token_shift(x, x_prev)
    xk = _mix(x, sx, p["mix_k"])
    xr = _mix(x, sx, p["mix_r"])
    k = torch.square(torch.relu(xk @ p["wk"].to(x.dtype)))
    kv = k @ p["wv"].to(x.dtype)
    return torch.sigmoid(xr @ p["wr"].to(x.dtype)) * kv, x[:, -1, :]


def init_cache(cfg, batch, dtype, device):
    """One layer's state: ``state`` (B, H, N, N) f32 and the last normed
    token of each half, ``tm_x_prev`` and ``cm_x_prev`` (B, M) in ``dtype``."""
    M, N = cfg.d_model, cfg.rwkv_head_dim
    return {"state": torch.zeros((batch, M // N, N, N), dtype=torch.float32,
                                 device=device),
            "tm_x_prev": torch.zeros((batch, M), dtype=dtype, device=device),
            "cm_x_prev": torch.zeros((batch, M), dtype=dtype, device=device)}


def _finish(p, cfg, x, y, tm_prev, state, cache):
    """Time-mix residual, channel mix and its residual; writes the cache."""
    x = x + y
    h = rms_norm(x, p["norm_cm"], cfg.norm_eps)
    y, cm_prev = channel_mix(p["cm"], h, cache["cm_x_prev"])
    cache["state"].copy_(state)
    cache["tm_x_prev"].copy_(tm_prev)
    cache["cm_x_prev"].copy_(cm_prev)
    return x + y


def apply(p, cfg, run, x, cache=None):
    """Full-sequence forward (prefill, logits).  x: (B, S, M) -> (B, S, M),
    residuals included.  Starts from ``cache`` (zeros without one) and
    writes the final state into it in place."""
    if cache is None:
        cache = init_cache(cfg, x.shape[0], x.dtype, x.device)
    h = rms_norm(x, p["norm_tm"], cfg.norm_eps)
    if run.use_pallas:
        y, tm_prev, state = time_mix_kernel(p, cfg, h, cache["tm_x_prev"], cache["state"])
    else:
        y, tm_prev, state = time_mix_chunked(p, cfg, h, cache["tm_x_prev"], cache["state"],
                                             chunk=run.rwkv_chunk,
                                             bf16_streams=run.rwkv_bf16_streams)
    return _finish(p, cfg, x, y, tm_prev, state, cache)


def decode(p, cfg, run, x, cache):
    """One-token step.  x: (B, 1, M); advances ``cache`` in place."""
    h = rms_norm(x, p["norm_tm"], cfg.norm_eps)
    y, tm_prev, state = time_mix_decode(p, cfg, h, cache["tm_x_prev"], cache["state"])
    return _finish(p, cfg, x, y, tm_prev, state, cache)
