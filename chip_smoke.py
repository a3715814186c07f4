#!/usr/bin/env python3
"""Quickest proof that the PyTorch / CUDA port runs on one NVIDIA card.

  python3 chip_smoke.py

Phases, one JSON line each:
  1. device  - the card's name and power limit (nvidia-smi) and torch's view;
  2. build   - nvcc builds every CUDA kernel of the port from this checkout,
               one nvcc per source, all started together; ptxas's registers
               and spills for every template (a spill in any flash_fwd_kernel
               instantiation fails the run);
  3. check   - each kernel against its plain PyTorch version on the card:
               flash_fwd at repro_torch.testing.KERNEL_CHECK_SHAPES,
               rglru_scan at RGLRU_CHECK_SHAPES, wkv6 at WKV6_CHECK_SHAPES
               (y and the final state; streams contiguous and in the
               model's (B, S, H, N) layout);
  4. time    - kernel, plain version and library yardstick (CUDA events,
               median of 30 after warm-up) beside the kernel's bound, at the
               shapes the serving paths give each kernel (flash also at
               recurrentgemma's prefill shape in bf16), with flash's achieved
               TFLOP/s and its bound on CUDA cores beside the tensor-core one;
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
  7. serve   - full-width rwkv6-3b the same way: 4 requests of 2100 prompt
               tokens (not a multiple of 64: the kernel's and the plain
               chunked path's tails run) and 32 new ones; wkv6 once per layer
               (32) in prefill and never in decode; logits, every layer's WKV
               state and its last normed tokens must agree with the plain
               prefill (time_mix_chunked).
Every serve phase first gives the leaves LM.init sets to constants seeded
noise (repro_torch.testing.perturb_zero_leaves), so the norms, mixes, decay
LoRA and bonus take part.  Then the kernels' summary line, and last
{"ok": true, "device": {...}}.
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
from repro_torch.kernels.rwkv6 import ops as wkv6_ops  # noqa: E402
from repro_torch.kernels.rwkv6.ops import wkv6  # noqa: E402
from repro_torch.kernels.rwkv6.ref import wkv6_ref  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.testing import (KERNEL_CHECK_SHAPES, RGLRU_CHECK_SHAPES, TOL,  # noqa: E402
                                 WKV6_CHECK_SHAPES, attention_inputs, flash_flops,
                                 perturb_zero_leaves, scan_inputs, wkv_inputs)

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_FLOPS = {"float32": 67e12,     # f32 on CUDA cores
              "tf32": 495e12,       # TF32 on tensor cores
              "bfloat16": 989e12}   # bf16 on tensor cores
# flash_fwd takes f32 inputs through 3xTF32: each f32 product is three TF32
# products (lo*hi + hi*lo + hi*hi), so its f32 bound is 3 x flops at the TF32 peak
FLASH_F32_TF32_TERMS = 3
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
    "wkv6": dict(
        wrapper=wkv6, ops=wkv6_ops, route="cuda",
        source="src/repro_torch/kernels/rwkv6/csrc/wkv6.cu",
        replaces="src/repro/kernels/rwkv6/kernel.py:70"),
}
# the kernel a layer of each kind launches in prefill
KERNEL_OF_KIND = {"attn": "flash_fwd", "rglru": "rglru_scan", "rwkv": "wkv6"}
# the recurrent state of a layer of each kind, held against the plain prefill
STATE_OF_KIND = {"rglru": "h", "rwkv": "state"}

SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 256, 32
# recurrentgemma-2b: a prompt past the 2048 window, so prefill rolls the ring
# cache and skips tiles before the window, and every decode step wraps it
RG_PROMPT, RG_NEW = 2112, 32
MAIN_SHAPE = (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 15, 5, 64, None, "float32")
SLICE_SHAPE = (4, 512, 512, 15, 5, 64, None, "float32")
RG_SHAPE = (SERVE_BATCH, RG_PROMPT, RG_PROMPT, 10, 1, 256, 2048, "float32")
RG_SHAPE_BF16 = RG_SHAPE[:7] + ("bfloat16",)
# the flash shapes the time phase measures (the serving paths run f32)
FLASH_TIME_SHAPES = (MAIN_SHAPE, SLICE_SHAPE, RG_SHAPE, RG_SHAPE_BF16)
RG_SCAN_SHAPE = (SERVE_BATCH, RG_PROMPT, 2560)
# rwkv6-3b: a prompt that is not a multiple of 64 (nor of the kernel's tile)
RWKV_PROMPT, RWKV_NEW = 2100, 32
WKV_SHAPE = (SERVE_BATCH, 40, RWKV_PROMPT, 64, "float32")
# prefill last logits, kernels vs plain versions, after 26 to 32 full-width
# f32 layers: the per-layer kernel bars (5e-6, 1e-5, 5e-5) grow with depth
# through the residual; the same bar holds the final recurrent states (the
# RWKV states, near 30 in magnitude, the largest) and RWKV's last tokens
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


def flash_bound(shape, cuda_cores: bool = False):
    """Least time the card could take: (ms, "bytes" | "operations").  By the
    kernel's route: f32 as FLASH_F32_TF32_TERMS TF32 products at the TF32
    peak, bf16 at the bf16 peak; with ``cuda_cores``, every dtype at the f32
    CUDA-core peak (the figure of the CUDA-core kernel before tensor cores)."""
    B, Sq, Skv, Hq, Hkv, D, window, dtype = shape
    flops = flash_flops(shape)
    elem = 4 if dtype == "float32" else 2
    nbytes = elem * (2 * B * Sq * Hq * D + 2 * B * Skv * Hkv * D)
    if cuda_cores:
        t_ops = flops / PEAK_FLOPS["float32"]
    elif dtype == "float32":
        t_ops = FLASH_F32_TF32_TERMS * flops / PEAK_FLOPS["tf32"]
    else:
        t_ops = flops / PEAK_FLOPS["bfloat16"]
    t_bytes = nbytes / HBM_BYTES_PER_S
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


def wkv_bound(shape):
    """Least time the card could take for WKV6: (ms, "bytes" | "operations").
    Bytes: r, k, v (in their dtype) and logw read once, y written once, u,
    state0 read and the final state written.  Operations per (b, h, t):
    y_t = r_t S_{t-1} is N^2 FMAs (2 N^2 flops), S_t = w_t S_{t-1} + k_t v_t^T
    a multiply and an FMA per entry (3 N^2), the bonus sum_i r u k (3 N),
    its product with v and the add (2 N) and exp(logw) (N): 5 N^2 + 6 N."""
    B, H, S, N, dtype = shape
    elem = 4 if dtype == "float32" else 2
    nbytes = (3 * elem + 4 + 4) * B * H * S * N + 4 * (H * N + 2 * B * H * N * N)
    flops = (5 * N * N + 6 * N) * B * H * S
    t_ops, t_bytes = flops / PEAK_FLOPS["float32"], nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_build() -> None:
    """One nvcc for each kernel source, all started together; fails if
    ptxas spilled any flash_fwd_kernel instantiation."""
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        futures = {name: pool.submit(nvcc_build.build, k["ops"].SOURCE)
                   for name, k in KERNELS.items()}
        built = {name: f.result() for name, f in futures.items()}
    for name, k in KERNELS.items():
        k["ops"].library()
        emit("build", kernel=name, seconds=built[name].seconds,
             library=built[name].path.name, ptxas=built[name].ptxas_lines())
    flash = [e for e in built["flash_fwd"].kernels() if "flash_fwd_kernel" in e["name"]]
    spilled = [e for e in flash if e["spill_stores"] or e["spill_loads"]]
    emit("build", kernel="flash_fwd", instantiations=flash, spilled=spilled)
    if not flash or spilled:
        raise RuntimeError(f"flash_fwd_kernel: ptxas reports spills in {spilled} "
                           f"(or no instantiation in its log: {len(flash)})")


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
        if shape in FLASH_TIME_SHAPES:
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


def check_wkv(dev) -> float:
    """wkv6 vs wkv6_ref (y and the final state) at every check shape, from a
    nonzero state0; returns the max abs error at the serving shape."""
    rows, bad, main_err = [], [], None
    for shape in WKV6_CHECK_SHAPES:
        # streams as contiguous (B, H, S, N), then as the model's heads lay
        # them out: (1, 2) transposes of contiguous (B, S, H, N)
        for seq_major in (False, True):
            r, k, v, logw, u, s0 = wkv_inputs(shape, device=dev, seq_major=seq_major)
            y, sT = wkv6(r, k, v, logw, u, s0)
            torch.cuda.synchronize()
            ry, rsT = wkv6_ref(r, k, v, logw, u, s0)
            err_y = (y - ry).abs().max().item()
            err_s = (sT - rsT).abs().max().item()
            finite = bool(torch.isfinite(y).all() and torch.isfinite(sT).all())
            rows.append({"shape": list(shape), "seq_major": seq_major,
                         "y_max_abs_err": err_y, "state_max_abs_err": err_s,
                         "state_max_abs": rsT.abs().max().item(), "tol": TOL["wkv6"]})
            if not (finite and err_y < TOL["wkv6"] and err_s < TOL["wkv6"]):
                bad.append([*shape, seq_major])
            if shape == WKV_SHAPE and seq_major:
                main_err = max(err_y, err_s)
            del r, k, v, logw, u, s0, y, sT, ry, rsT
    emit("check", kernel="wkv6", results=rows, failed=bad)
    if bad:
        raise RuntimeError(f"wkv6 disagrees with wkv6_ref at {bad}")
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
    ms = time_ms(lambda: flash_attention(q, k, v, causal=True, window=window))
    return {
        "shape": list(shape),
        "ms": ms,
        "tflops": flash_flops(shape) / (ms * 1e-3) / 1e12,
        "plain_ms": time_ms(lambda: attention_ref(q, k, v, causal=True, window=window)),
        "library_ms": time_ms(library),
        "library": "torch.nn.functional.scaled_dot_product_attention",
        "library_max_abs_err": lib_err,
        "bound_ms": bound, "bound_by": bound_by,
        "bound_cuda_cores_ms": flash_bound(shape, cuda_cores=True)[0],
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


def time_wkv(shape, dev) -> dict:
    """In the model's layout of the streams, with the column split wkv6
    picks there.  Also times the blocks of one (b, h) alone at that split: a
    block walks its S steps in order, so a full-shape time near the lone
    (b, h)'s says the step chain, not the card's throughput, sets the
    kernel's time."""
    r, k, v, logw, u, s0 = wkv_inputs(shape, device=dev, seq_major=True)
    one = wkv_inputs((1, 1) + tuple(shape[2:]), device=dev, seq_major=True)
    bound, bound_by = wkv_bound(shape)
    B, H, _, N, _ = shape
    split = wkv6_ops.col_split(B * H, N, torch.cuda.get_device_properties(dev)
                               .multi_processor_count)
    return {
        "shape": list(shape),
        "col_split": split,
        "ms": time_ms(lambda: wkv6(r, k, v, logw, u, s0)),
        "one_block_ms": time_ms(lambda: wkv6_ops.launch(*one, col_split=split)),
        "plain_ms": time_ms(lambda: wkv6_ref(r, k, v, logw, u, s0), reps=5, warmup=1),
        "library_ms": None,    # no single PyTorch call computes this recurrence
        "bound_ms": bound, "bound_by": bound_by,
    }


def phase_time(dev) -> dict:
    """Times of each kernel at the shapes the serving paths give it."""
    flash = {s: time_flash(s, dev) for s in FLASH_TIME_SHAPES}
    emit("time", kernel="flash_fwd", peak_flops=PEAK_FLOPS,
         hbm_bytes_per_s=HBM_BYTES_PER_S, results=list(flash.values()))
    scan = time_scan(RG_SCAN_SHAPE, dev)
    emit("time", kernel="rglru_scan", peak_flops=PEAK_FLOPS,
         hbm_bytes_per_s=HBM_BYTES_PER_S, results=[scan])
    wkv = time_wkv(WKV_SHAPE, dev)
    emit("time", kernel="wkv6", peak_flops=PEAK_FLOPS,
         hbm_bytes_per_s=HBM_BYTES_PER_S, results=[wkv])
    return {"flash_fwd": flash, "rglru_scan": scan, "wkv6": wkv}


def reset_launches() -> None:
    for k in KERNELS.values():
        k["wrapper"].launches = 0


def read_launches() -> dict:
    return {name: k["wrapper"].launches for name, k in KERNELS.items()}


def phase_serve(dev, arch: str, prompt_len: int, new_tokens: int) -> dict:
    """Serve ``arch`` at full width through ServeEngine.generate, cold then
    warm, on seeded weights whose constant leaves are perturbed; returns the
    kernels' launches in the cold (main-path) request."""
    cfg = configs.get_config(arch)
    run = RunConfig(param_dtype="float32", activation_dtype="float32", use_pallas=True)
    kinds = cfg.layer_kinds
    expected = {name: sum(KERNEL_OF_KIND[kind] == name for kind in kinds)
                for name in KERNELS}
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = LM.init(cfg, run, seed=0, device=dev)
    noise = torch.Generator(device=dev)
    noise.manual_seed(2)
    perturbed = perturb_zero_leaves(params, cfg, noise)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
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
    # every recurrent layer's final state, and RWKV's last normed tokens,
    # against the plain prefill's
    state_errs, state_abs, x_prev_err = [], 0.0, 0.0
    for kc, pc, kind in zip(kern_cache, plain_cache, kinds):
        if kind in STATE_OF_KIND:
            key = STATE_OF_KIND[kind]
            state_errs.append((kc[key] - pc[key]).abs().max().item())
            state_abs = max(state_abs, pc[key].abs().max().item())
        if kind == "rwkv":
            x_prev_err = max([x_prev_err] + [(kc[key] - pc[key]).abs().max().item()
                                             for key in ("tm_x_prev", "cm_x_prev")])
    # the first layer's time-mix input precedes every kernel: identical
    first_x_prev_equal = kinds[0] != "rwkv" or torch.equal(
        kern_cache[0]["tm_x_prev"], plain_cache[0]["tm_x_prev"])
    state_err = max(state_errs, default=0.0)
    del kern_cache, plain_cache
    engine.generate(prompts, max_new_tokens=new_tokens)   # the same request, warm
    warm = engine.stats
    err = (kern - plain).abs().max().item()
    argmax_agree = bool(torch.equal(kern.argmax(-1), plain.argmax(-1)))
    first_token_ok = bool(torch.equal(kern[:, -1].argmax(-1), out[:, prompt_len]))
    n_new = SERVE_BATCH * new_tokens
    emit("serve", arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
         params=n_params, perturbed_leaves=perturbed,
         batch=SERVE_BATCH, prompt_len=prompt_len, new_tokens=new_tokens,
         launches=launches, expected_launches=expected, init_s=init_s,
         prefill_ms=1e3 * st.prefill_s,
         decode_ms_per_token=1e3 * st.decode_s / st.decode_steps,
         tok_per_s=n_new / (st.prefill_s + st.decode_s),
         warm_prefill_ms=1e3 * warm.prefill_s,
         warm_decode_ms_per_token=1e3 * warm.decode_s / warm.decode_steps,
         warm_tok_per_s=n_new / (warm.prefill_s + warm.decode_s),
         peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
         logits_finite=bool(torch.isfinite(kern).all()),
         logits_max_abs_err=err, logits_tol=LOGITS_TOL,
         state_max_abs_err=state_err, state_max_abs_err_per_layer=state_errs,
         state_max_abs=state_abs, x_prev_max_abs_err=x_prev_err,
         first_x_prev_equal=first_x_prev_equal,
         argmax_agree=argmax_agree, first_token_matches_prefill=first_token_ok)
    if not (bool(torch.isfinite(kern).all()) and err < LOGITS_TOL and state_err < LOGITS_TOL
            and x_prev_err < LOGITS_TOL and first_x_prev_equal
            and argmax_agree and first_token_ok):
        raise RuntimeError(f"{arch}: full-width prefill through the kernels disagrees "
                           f"with the plain prefill")
    return launches


def _leaves(tree):
    for value in (tree.values() if isinstance(tree, dict) else tree):
        if isinstance(value, (dict, list)):
            yield from _leaves(value)
        else:
            yield value


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
    wkv_err = check_wkv(dev)
    free_device()
    timing = phase_time(dev)
    free_device()
    paths = {"smollm-360m": phase_serve(dev, "smollm-360m", SERVE_PROMPT, SERVE_NEW)}
    free_device()
    paths["recurrentgemma-2b"] = phase_serve(dev, "recurrentgemma-2b", RG_PROMPT, RG_NEW)
    free_device()
    paths["rwkv6-3b"] = phase_serve(dev, "rwkv6-3b", RWKV_PROMPT, RWKV_NEW)

    def entry(name, row, err):
        return {"name": name, "route": KERNELS[name]["route"],
                "source": KERNELS[name]["source"], "replaces": KERNELS[name]["replaces"],
                "launches": sum(p[name] for p in paths.values()),
                "launches_per_path": {arch: p[name] for arch, p in paths.items()},
                "max_abs_err": err, "ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": row["library_ms"], "shape": row["shape"]}

    flash = entry("flash_fwd", timing["flash_fwd"][MAIN_SHAPE], flash_errs[MAIN_SHAPE])
    flash["bound_cuda_cores_ms"] = timing["flash_fwd"][MAIN_SHAPE]["bound_cuda_cores_ms"]
    flash["tflops"] = timing["flash_fwd"][MAIN_SHAPE]["tflops"]
    flash["per_shape"] = [
        {k: row[k] for k in ("shape", "ms", "tflops", "plain_ms", "bound_ms", "bound_by",
                             "bound_cuda_cores_ms", "library_ms")}
        | {"max_abs_err": flash_errs[shape]}
        for shape, row in timing["flash_fwd"].items() if shape != MAIN_SHAPE]
    scan = entry("rglru_scan", timing["rglru_scan"], scan_err)
    wkv = entry("wkv6", timing["wkv6"], wkv_err)
    print(json.dumps({"kernels": [flash, scan, wkv]}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
