"""Times the flash-attention kernel's tile variants on one CUDA card.

  PYTHONPATH=src python -m repro_torch.kernels.flash_attention.bench [--out FILE]

Built with ``ops.VARIANT_FLAGS``, the kernel's library holds several tile
variants for each (type, padded head dim): warps per block, keys per kv
tile (BKV) and how many warps share a row band's head dim (the split).
``flash_attention`` launches the default of each, the only tiles of the
serving library; ``ops.launch_variant`` runs any of them.  At the three f32 shapes
of ``chip_smoke.py``'s time phase (smollm-360m's serving and 512-token
shapes, recurrentgemma-2b's prefill) and at the two serving shapes in bf16,
every variant of the shape's type and head dim is held against
``attention_ref`` (the ``testing.TOL`` bar) and then timed beside
``attention_ref``: the median of 30 CUDA-event timings of one call after 5
warm-up calls (as ``chip_smoke.py`` times), and the device time per call of
20 calls replayed from one CUDA graph (the least of 5 replays), which
leaves out the host's launch overhead that dominates a call of tens of
microseconds.
Achieved TFLOP/s count 4 * D flops per live (q, k) pair.  The package
calls no library attention, so the library yardstick at these shapes is
timed by ``chip_smoke.py``'s time phase; run both in one call to compare.
Prints one JSON object per line (and writes them to FILE); the first line is
the card's name and power limit as nvidia-smi gives them, then ptxas's
registers and spills for every template; a spill in any of them fails.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

from repro_torch.kernels import build as nvcc_build
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.testing import TOL, attention_inputs, flash_flops

# (B, Sq, Skv, Hq, Hkv, D, window, dtype), as in testing.KERNEL_CHECK_SHAPES
SHAPES = (
    (4, 256, 256, 15, 5, 64, None, "float32"),         # smollm-360m serving
    (4, 512, 512, 15, 5, 64, None, "float32"),         # smollm-360m, 512 tokens
    (4, 2112, 2112, 10, 1, 256, 2048, "float32"),      # recurrentgemma-2b prefill
    (4, 256, 256, 15, 5, 64, None, "bfloat16"),
    (4, 2112, 2112, 10, 1, 256, 2048, "bfloat16"),
)


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


def graph_ms(fn, calls: int = 20, runs: int = 5) -> float:
    """Device time per call of ``calls`` calls captured in one CUDA graph and
    replayed (the least of ``runs`` replays): no host launch between calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # warm up outside the default stream, as capture wants
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / calls)
    return best


def padded_dim(D: int) -> int:
    return next(p for p in (32, 64, 128, 256) if D <= p)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the JSON lines here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lines = []

    def emit(**fields):
        lines.append(json.dumps(fields))
        print(lines[-1], flush=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()
    emit(card=smi[0], torch=torch.__version__)
    built = nvcc_build.build(ops.SOURCE, ops.VARIANT_FLAGS)
    emit(build_seconds=built.seconds, kernels=built.kernels())
    spilled = [e for e in built.kernels() if e["spill_stores"] or e["spill_loads"]]
    if spilled:
        raise RuntimeError(f"ptxas reports spills in {spilled}")
    variants = ops.variants()
    emit(variants=variants)

    for shape in SHAPES:
        B, Sq, Skv, Hq, Hkv, D, window, dtype = shape
        q, k, v = attention_inputs(shape, device=dev)
        ref = attention_ref(q, k, v, causal=True, window=window).float()
        tol = TOL["flash_f32" if dtype == "float32" else "flash_bf16"]
        flops = flash_flops(shape)

        def plain():
            return attention_ref(q, k, v, causal=True, window=window)

        emit(shape=list(shape), plain_ms=time_ms(plain), plain_graph_ms=graph_ms(plain))
        for var in variants:
            if var["bf16"] != (dtype == "bfloat16") or var["dp"] != padded_dim(D):
                continue

            def run(index=var["index"]):
                return ops.launch_variant(index, q, k, v, causal=True, window=window)

            err = (run().float() - ref).abs().max().item()
            if not err < tol:
                raise RuntimeError(f"variant {var} disagrees at {shape}: {err}")
            ms, gms = time_ms(run), graph_ms(run)
            emit(shape=list(shape), **var, max_abs_err=err, ms=ms, graph_ms=gms,
                 tflops=flops / (gms * 1e-3) / 1e12)
        del q, k, v, ref
    if args.out:
        with open(args.out, "w") as fh:
            fh.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
