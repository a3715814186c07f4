#!/usr/bin/env python3
"""Quickest proof that the PyTorch / CUDA port runs on one NVIDIA card.

  python3 chip_smoke.py

Phases, one JSON line each:
  1. device  - the card's name and power limit (nvidia-smi) and torch's view;
  2. build   - nvcc builds every CUDA kernel of the port from this checkout;
  3. check   - each kernel against its plain PyTorch version on the card, at
               the shapes of repro_torch.testing.KERNEL_CHECK_SHAPES;
  4. time    - kernel, plain version and library yardstick (CUDA events,
               median of 30 after warm-up) beside the kernel's bound;
  5. serve   - full-width smollm-360m (fp32, seeded random weights) answers
               4 requests of 256 prompt tokens with 32 greedy new tokens
               through ServeEngine.generate, once and cold: its times are
               the first request's; the prefill must launch the flash kernel
               once per layer, and its last logits must agree with the same
               prefill on the plain attention.  The same request is then
               served again, warm, for the warm_* times.
Then the kernels' summary line, and last {"ok": true, "device": {...}}.
Any failure raises and the script exits non-zero without the last line;
so does a machine without a CUDA card.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.kernels.flash_attention import build as flash_build  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.testing import KERNEL_CHECK_SHAPES, TOL, attention_inputs  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_FLOPS = {"float32": 67e12,     # f32 on CUDA cores
              "bfloat16": 989e12}   # bf16 on tensor cores
HBM_BYTES_PER_S = 3.35e12

SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 256, 32
MAIN_SHAPE = (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 15, 5, 64, None, "float32")
SLICE_SHAPE = (4, 512, 512, 15, 5, 64, None, "float32")
# prefill last logits, kernel vs plain attention, after 32 full-width f32
# layers: the per-layer 5e-6 kernel bar grows with depth through the residual
LOGITS_TOL = 1e-3


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    """Median device time of one call, by CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def live_pairs(Sq: int, Skv: int, window) -> int:
    """(q, k) pairs the causal (windowed) mask keeps, top-left aligned."""
    total = 0
    for i in range(Sq):
        lo = 0 if window is None else max(0, i - window + 1)
        total += max(0, min(i, Skv - 1) - lo + 1)
    return total


def flash_bound(shape):
    """Least time the card could take: (ms, "bytes" | "operations")."""
    B, Sq, Skv, Hq, Hkv, D, window, dtype = shape
    flops = 4 * D * Hq * B * live_pairs(Sq, Skv, window)   # QK^T and PV
    elem = 4 if dtype == "float32" else 2
    nbytes = elem * (2 * B * Sq * Hq * D + 2 * B * Skv * Hkv * D)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    emit("device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, **device)
    return device


def phase_build() -> None:
    built = flash_build.build()
    flash_build.library()
    ptxas = [ln.strip() for ln in built.log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", kernel="flash_fwd", seconds=built.seconds,
         library=built.path.name, ptxas=ptxas)


def phase_check(dev) -> float:
    """Kernel vs plain version at every check shape; returns the main shape's error."""
    rows, bad, main_err = [], [], None
    for shape in KERNEL_CHECK_SHAPES:
        window, dtype = shape[6], shape[7]
        q, k, v = attention_inputs(shape, device=dev)
        out = flash_attention(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        ref = attention_ref(q, k, v, causal=True, window=window)
        err = (out.float() - ref.float()).abs().max().item()
        tol = TOL["flash_f32" if dtype == "float32" else "flash_bf16"]
        finite = bool(torch.isfinite(out.float()).all())
        rows.append({"shape": list(shape), "max_abs_err": err, "tol": tol})
        if not (finite and err < tol):
            bad.append(shape)
        if shape == MAIN_SHAPE:
            main_err = err
    emit("check", kernel="flash_fwd", results=rows, failed=[list(s) for s in bad])
    if bad:
        raise RuntimeError(f"flash_fwd disagrees with attention_ref at {bad}")
    return main_err


def time_flash(shape, dev) -> dict:
    q, k, v = attention_inputs(shape, device=dev)
    window = shape[6]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    lib_err = (lib.transpose(1, 2).float()
               - attention_ref(q, k, v, window=window).float()).abs().max().item()
    bound, bound_by = flash_bound(shape)
    return {
        "shape": list(shape),
        "ms": time_ms(lambda: flash_attention(q, k, v, causal=True, window=window)),
        "plain_ms": time_ms(lambda: attention_ref(q, k, v, causal=True, window=window)),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)),
        "library": "torch.nn.functional.scaled_dot_product_attention",
        "library_max_abs_err": lib_err,
        "bound_ms": bound, "bound_by": bound_by,
    }


def phase_time(dev) -> dict:
    rows = [time_flash(s, dev) for s in (MAIN_SHAPE, SLICE_SHAPE)]
    emit("time", kernel="flash_fwd", peak_flops=PEAK_FLOPS,
         hbm_bytes_per_s=HBM_BYTES_PER_S, results=rows)
    return rows[0]


def phase_serve(dev) -> int:
    cfg = configs.get_config("smollm-360m")
    run = RunConfig(param_dtype="float32", activation_dtype="float32", use_pallas=True)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = LM.init(cfg, run, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    engine = ServeEngine(cfg, run, params, max_seq=SERVE_PROMPT + SERVE_NEW)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                            generator=gen, device=dev)

    flash_attention.launches = 0
    out = engine.generate(prompts, max_new_tokens=SERVE_NEW)   # the main path, once
    launches = flash_attention.launches
    st = engine.stats

    if launches != cfg.n_layers:
        raise RuntimeError(f"prefill launched flash_fwd {launches} times, "
                           f"expected {cfg.n_layers} (one per layer)")
    if out.shape != (SERVE_BATCH, SERVE_PROMPT + SERVE_NEW) or not torch.equal(
            out[:, :SERVE_PROMPT], prompts):
        raise RuntimeError(f"generate returned {tuple(out.shape)} without the prompts")
    if not bool(((out >= 0) & (out < cfg.vocab_size)).all()):
        raise RuntimeError("generated token ids outside the vocabulary")

    with torch.inference_mode():
        kern, _ = LM.prefill(params, cfg, run, prompts, engine.max_seq)
        plain, _ = LM.prefill(params, cfg, dataclasses.replace(run, use_pallas=False),
                              prompts, engine.max_seq)
    engine.generate(prompts, max_new_tokens=SERVE_NEW)   # the same request, warm
    warm = engine.stats
    err = (kern - plain).abs().max().item()
    argmax_agree = bool(torch.equal(kern.argmax(-1), plain.argmax(-1)))
    first_token_ok = bool(torch.equal(kern[:, -1].argmax(-1), out[:, SERVE_PROMPT]))
    new_tokens = SERVE_BATCH * SERVE_NEW
    emit("serve", arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
         batch=SERVE_BATCH, prompt_len=SERVE_PROMPT, new_tokens=SERVE_NEW,
         flash_launches=launches, init_s=init_s,
         prefill_ms=1e3 * st.prefill_s,
         decode_ms_per_token=1e3 * st.decode_s / st.decode_steps,
         tok_per_s=new_tokens / (st.prefill_s + st.decode_s),
         warm_prefill_ms=1e3 * warm.prefill_s,
         warm_decode_ms_per_token=1e3 * warm.decode_s / warm.decode_steps,
         warm_tok_per_s=new_tokens / (warm.prefill_s + warm.decode_s),
         peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
         logits_finite=bool(torch.isfinite(kern).all()),
         logits_max_abs_err=err, logits_tol=LOGITS_TOL,
         argmax_agree=argmax_agree, first_token_matches_prefill=first_token_ok)
    if not (bool(torch.isfinite(kern).all()) and err < LOGITS_TOL and argmax_agree
            and first_token_ok):
        raise RuntimeError("full-width prefill through flash_fwd disagrees with "
                           "the plain attention prefill")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; needs an NVIDIA card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    device = phase_device()
    phase_build()
    main_err = phase_check(dev)
    timing = phase_time(dev)
    launches = phase_serve(dev)
    print(json.dumps({"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:73",
        "launches": launches, "max_abs_err": main_err,
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"], "shape": timing["shape"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
