#!/usr/bin/env python3
"""Quickest proof that the PyTorch / CUDA port runs on one NVIDIA card.

  python3 chip_smoke.py

Phases, one JSON line each:
  1. device  - the card's name and power limit (nvidia-smi) and torch's view;
  2. build   - nvcc builds every CUDA kernel of the port from this checkout,
               one nvcc per source, all started together; ptxas's registers
               and spills for every template;
  3. check   - each kernel against its plain PyTorch version on the card:
               flash_fwd at repro_torch.testing.KERNEL_CHECK_SHAPES,
               rglru_scan at RGLRU_CHECK_SHAPES;
  4. time    - kernel, plain version and library yardstick (CUDA events,
               median of 30 after warm-up) beside the kernel's bound, at the
               shapes the serving paths give each kernel;
  5. serve   - full-width smollm-360m (fp32, seeded random weights) answers
               4 requests of 256 prompt tokens with 32 greedy new tokens
               through ServeEngine.generate, once and cold: its times are
               the first request's; the prefill must launch the flash kernel
               once per layer, and its last logits must agree with the same
               prefill on the plain attention.  The same request is then
               served again, warm, for the warm_* times.
  6. serve   - full-width recurrentgemma-2b the same way, after smollm's
               weights are freed: 4 requests of 2112 prompt tokens (past the
               2048 window: the ring cache rolls and wraps) and 32 new ones;
               the prefill must launch flash_fwd once per attention layer (8)
               and rglru_scan once per recurrent layer (18), decode neither,
               and its logits and final recurrent states must agree with the
               plain prefill.
Then the kernels' summary line, and last {"ok": true, "device": {...}}.
Any failure raises and the script exits non-zero without the last line;
so does a machine without a CUDA card.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.kernels import build as nvcc_build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.rglru import ops as rglru_ops  # noqa: E402
from repro_torch.kernels.rglru.ops import linear_scan  # noqa: E402
from repro_torch.kernels.rglru.ref import linear_scan_ref  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.testing import (KERNEL_CHECK_SHAPES, RGLRU_CHECK_SHAPES, TOL,  # noqa: E402
                                 attention_inputs, scan_inputs)

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_FLOPS = {"float32": 67e12,     # f32 on CUDA cores
              "bfloat16": 989e12}   # bf16 on tensor cores
HBM_BYTES_PER_S = 3.35e12

# each kernel: its wrapper (whose .launches counts launches), ops module
# (SOURCE, library()), source and the TPU kernel it replaces
KERNELS = {
    "flash_fwd": dict(
        wrapper=flash_attention, ops=flash_ops, route="cuda",
        source="src/repro_torch/kernels/flash_attention/csrc/flash_fwd.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:73"),
    "rglru_scan": dict(
        wrapper=linear_scan, ops=rglru_ops, route="cuda",
        source="src/repro_torch/kernels/rglru/csrc/rglru_scan.cu",
        replaces="src/repro/kernels/rglru/kernel.py:60"),
}

SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 256, 32
# recurrentgemma-2b: a prompt past the 2048 window, so prefill rolls the ring
# cache and skips tiles before the window, and every decode step wraps it
RG_PROMPT, RG_NEW = 2112, 32
MAIN_SHAPE = (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 15, 5, 64, None, "float32")
SLICE_SHAPE = (4, 512, 512, 15, 5, 64, None, "float32")
RG_SHAPE = (SERVE_BATCH, RG_PROMPT, RG_PROMPT, 10, 1, 256, 2048, "float32")
RG_SCAN_SHAPE = (SERVE_BATCH, RG_PROMPT, 2560)
# prefill last logits, kernels vs plain versions, after 26 to 32 full-width
# f32 layers: the per-layer kernel bars (5e-6, 1e-5) grow with depth through
# the residual; the same bar holds the final recurrent states
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


def scan_bound(shape):
    """Least time the card could take for the scan: (ms, "bytes" | "operations").
    It reads a and b and h0 and writes y and h_T once; one FMA per element."""
    B, S, D = shape
    nbytes = 4 * (3 * B * S * D + 2 * B * D)
    flops = 2 * B * S * D
    t_ops, t_bytes = flops / PEAK_FLOPS["float32"], nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_build() -> None:
    """One nvcc for each kernel source, all started together."""
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        futures = {name: pool.submit(nvcc_build.build, k["ops"].SOURCE)
                   for name, k in KERNELS.items()}
        built = {name: f.result() for name, f in futures.items()}
    for name, k in KERNELS.items():
        k["ops"].library()
        emit("build", kernel=name, seconds=built[name].seconds,
             library=built[name].path.name, ptxas=built[name].ptxas_lines())


def check_flash(dev) -> dict:
    """flash_fwd vs attention_ref at every check shape; returns the max abs
    error at each shape the serving paths give the kernel."""
    rows, bad, errs = [], [], {}
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
        if shape in (MAIN_SHAPE, RG_SHAPE):
            errs[shape] = err
        del q, k, v, out, ref
    emit("check", kernel="flash_fwd", results=rows, failed=[list(s) for s in bad])
    if bad:
        raise RuntimeError(f"flash_fwd disagrees with attention_ref at {bad}")
    return errs


def check_scan(dev) -> float:
    """rglru_scan vs linear_scan_ref (y and h_T) at every check shape, from a
    nonzero h0; returns the max abs error at the serving shape."""
    rows, bad, main_err = [], [], None
    for shape in RGLRU_CHECK_SHAPES:
        a, b, h0 = scan_inputs(shape, device=dev)
        y, hT = linear_scan(a, b, h0)
        torch.cuda.synchronize()
        ry, rhT = linear_scan_ref(a, b, h0)
        err = max((y - ry).abs().max().item(), (hT - rhT).abs().max().item())
        finite = bool(torch.isfinite(y).all() and torch.isfinite(hT).all())
        rows.append({"shape": list(shape), "max_abs_err": err, "tol": TOL["rglru_f32"]})
        if not (finite and err < TOL["rglru_f32"]):
            bad.append(shape)
        if shape == RG_SCAN_SHAPE:
            main_err = err
    emit("check", kernel="rglru_scan", results=rows, failed=[list(s) for s in bad])
    if bad:
        raise RuntimeError(f"rglru_scan disagrees with linear_scan_ref at {bad}")
    return main_err


def time_flash(shape, dev) -> dict:
    q, k, v = attention_inputs(shape, device=dev)
    window = shape[6]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if window is None:
        sdpa_mask = dict(is_causal=True)
    else:     # the library has no window argument: an explicit boolean mask
        i = torch.arange(shape[1], device=dev)[:, None]
        j = torch.arange(shape[2], device=dev)[None, :]
        sdpa_mask = dict(attn_mask=(j <= i) & (i - j < window))

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **sdpa_mask)

    lib_err = (library().transpose(1, 2).float()
               - attention_ref(q, k, v, window=window).float()).abs().max().item()
    bound, bound_by = flash_bound(shape)
    return {
        "shape": list(shape),
        "ms": time_ms(lambda: flash_attention(q, k, v, causal=True, window=window)),
        "plain_ms": time_ms(lambda: attention_ref(q, k, v, causal=True, window=window)),
        "library_ms": time_ms(library),
        "library": "torch.nn.functional.scaled_dot_product_attention",
        "library_max_abs_err": lib_err,
        "bound_ms": bound, "bound_by": bound_by,
    }


def time_scan(shape, dev) -> dict:
    a, b, h0 = scan_inputs(shape, device=dev)
    bound, bound_by = scan_bound(shape)
    return {
        "shape": list(shape),
        "ms": time_ms(lambda: linear_scan(a, b, h0)),
        "plain_ms": time_ms(lambda: linear_scan_ref(a, b, h0), reps=10, warmup=2),
        "library_ms": None,    # no single PyTorch call computes this recurrence
        "bound_ms": bound, "bound_by": bound_by,
    }


def phase_time(dev) -> dict:
    """Times of each kernel at the shapes the serving paths give it."""
    flash = {s: time_flash(s, dev) for s in (MAIN_SHAPE, SLICE_SHAPE, RG_SHAPE)}
    emit("time", kernel="flash_fwd", peak_flops=PEAK_FLOPS,
         hbm_bytes_per_s=HBM_BYTES_PER_S, results=list(flash.values()))
    scan = time_scan(RG_SCAN_SHAPE, dev)
    emit("time", kernel="rglru_scan", peak_flops=PEAK_FLOPS,
         hbm_bytes_per_s=HBM_BYTES_PER_S, results=[scan])
    return {"flash_fwd": flash, "rglru_scan": scan}


def reset_launches() -> None:
    for k in KERNELS.values():
        k["wrapper"].launches = 0


def read_launches() -> dict:
    return {name: k["wrapper"].launches for name, k in KERNELS.items()}


def phase_serve(dev, arch: str, prompt_len: int, new_tokens: int) -> dict:
    """Serve ``arch`` at full width through ServeEngine.generate, cold then
    warm; returns the kernels' launches in the cold (main-path) request."""
    cfg = configs.get_config(arch)
    run = RunConfig(param_dtype="float32", activation_dtype="float32", use_pallas=True)
    kinds = cfg.layer_kinds
    expected = {"flash_fwd": kinds.count("attn"), "rglru_scan": kinds.count("rglru")}
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = LM.init(cfg, run, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    engine = ServeEngine(cfg, run, params, max_seq=prompt_len + new_tokens)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, prompt_len),
                            generator=gen, device=dev)

    reset_launches()
    out = engine.generate(prompts, max_new_tokens=new_tokens)   # the main path, once
    launches = read_launches()
    st = engine.stats

    if launches != expected:
        raise RuntimeError(f"{arch}: generate launched {launches}, expected {expected} "
                           f"(one per layer of each kind, in prefill only)")
    if out.shape != (SERVE_BATCH, prompt_len + new_tokens) or not torch.equal(
            out[:, :prompt_len], prompts):
        raise RuntimeError(f"generate returned {tuple(out.shape)} without the prompts")
    if not bool(((out >= 0) & (out < cfg.vocab_size)).all()):
        raise RuntimeError("generated token ids outside the vocabulary")

    with torch.inference_mode():
        reset_launches()
        kern, kern_cache = LM.prefill(params, cfg, run, prompts, engine.max_seq)
        prefill_launches = read_launches()
        plain, plain_cache = LM.prefill(params, cfg, dataclasses.replace(run, use_pallas=False),
                                        prompts, engine.max_seq)
    if prefill_launches != expected:     # so decode launched no kernel
        raise RuntimeError(f"{arch}: prefill alone launched {prefill_launches}, "
                           f"expected {expected}")
    h_err = max([(kc["h"] - pc["h"]).abs().max().item()
                 for kc, pc, kind in zip(kern_cache, plain_cache, kinds)
                 if kind == "rglru"], default=0.0)
    del kern_cache, plain_cache
    engine.generate(prompts, max_new_tokens=new_tokens)   # the same request, warm
    warm = engine.stats
    err = (kern - plain).abs().max().item()
    argmax_agree = bool(torch.equal(kern.argmax(-1), plain.argmax(-1)))
    first_token_ok = bool(torch.equal(kern[:, -1].argmax(-1), out[:, prompt_len]))
    n_new = SERVE_BATCH * new_tokens
    emit("serve", arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
         batch=SERVE_BATCH, prompt_len=prompt_len, new_tokens=new_tokens,
         launches=launches, flash_launches=launches["flash_fwd"], init_s=init_s,
         prefill_ms=1e3 * st.prefill_s,
         decode_ms_per_token=1e3 * st.decode_s / st.decode_steps,
         tok_per_s=n_new / (st.prefill_s + st.decode_s),
         warm_prefill_ms=1e3 * warm.prefill_s,
         warm_decode_ms_per_token=1e3 * warm.decode_s / warm.decode_steps,
         warm_tok_per_s=n_new / (warm.prefill_s + warm.decode_s),
         peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
         logits_finite=bool(torch.isfinite(kern).all()),
         logits_max_abs_err=err, logits_tol=LOGITS_TOL,
         rglru_h_max_abs_err=h_err,
         argmax_agree=argmax_agree, first_token_matches_prefill=first_token_ok)
    if not (bool(torch.isfinite(kern).all()) and err < LOGITS_TOL and h_err < LOGITS_TOL
            and argmax_agree and first_token_ok):
        raise RuntimeError(f"{arch}: full-width prefill through the kernels disagrees "
                           f"with the plain prefill")
    return launches


def free_device() -> None:
    gc.collect()
    torch.cuda.empty_cache()


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
    flash_errs = check_flash(dev)
    scan_err = check_scan(dev)
    free_device()
    timing = phase_time(dev)
    free_device()
    paths = {"smollm-360m": phase_serve(dev, "smollm-360m", SERVE_PROMPT, SERVE_NEW)}
    free_device()
    paths["recurrentgemma-2b"] = phase_serve(dev, "recurrentgemma-2b", RG_PROMPT, RG_NEW)

    def entry(name, row, err):
        return {"name": name, "route": KERNELS[name]["route"],
                "source": KERNELS[name]["source"], "replaces": KERNELS[name]["replaces"],
                "launches": sum(p[name] for p in paths.values()),
                "launches_per_path": {arch: p[name] for arch, p in paths.items()},
                "max_abs_err": err, "ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": row["library_ms"], "shape": row["shape"]}

    flash = entry("flash_fwd", timing["flash_fwd"][MAIN_SHAPE], flash_errs[MAIN_SHAPE])
    rg = timing["flash_fwd"][RG_SHAPE]
    flash["per_shape"] = [{k: rg[k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                                              "bound_by", "library_ms")}
                          | {"max_abs_err": flash_errs[RG_SHAPE]}]
    scan = entry("rglru_scan", timing["rglru_scan"], scan_err)
    print(json.dumps({"kernels": [flash, scan]}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
