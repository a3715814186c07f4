"""Times the WKV6 kernel's variants on one CUDA card.

  PYTHONPATH=src python -m repro_torch.kernels.rwkv6.bench [--out FILE]

The kernel splits the value columns of each (b, h) over ``col_split``
blocks (1, or 2 or 4 at N = 64).  At rwkv6-3b's prefill shape (4, 40, 2100,
64), for f32 and bf16 streams and for both stream layouts (contiguous
(B, H, S, N), and the model's (B, S, H, N) read in place), each split is
held against ``wkv6_ref`` and then timed at the full shape and for one
(b, h) alone.  A sweep then times each split as the number of (b, h)
pairs grows by whole multiples of the SM count, to show how the time
grows with the blocks an SM holds, and at rwkv6-3b's prefill for 1 to 4
requests, marking the split ``wkv6`` picks.  Times are medians of 30 CUDA-event
timings after 5 warm-up calls.  Prints one JSON object per line (and
writes them to FILE); the first line is the card's name and power limit as
nvidia-smi gives them, then ptxas's registers for every template.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

from repro_torch.kernels import build as nvcc_build
from repro_torch.kernels.rwkv6 import ops
from repro_torch.kernels.rwkv6.ref import wkv6_ref
from repro_torch.testing import TOL, wkv_inputs

SHAPE = (4, 40, 2100, 64)     # rwkv6-3b's prefill: 4 x 2100 tokens, 40 heads
SPLITS = ops.COL_SPLITS[64]


def time_ms(fn, reps: int = 30, warmup: int = 5) -> float:
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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the JSON lines here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    lines = []

    def emit(**fields):
        lines.append(json.dumps(fields))
        print(lines[-1], flush=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    emit(card=smi[0], sms=sms, torch=torch.__version__)
    built = nvcc_build.build(ops.SOURCE)
    emit(build_seconds=built.seconds, ptxas=built.ptxas_lines())

    B, H, S, N = SHAPE
    for dtype in ("float32", "bfloat16"):
        ref = None
        for seq_major in (False, True):
            inputs = wkv_inputs((B, H, S, N, dtype), device=dev, seq_major=seq_major)
            one = wkv_inputs((1, 1, S, N, dtype), device=dev, seq_major=seq_major)
            if ref is None:
                ref = wkv6_ref(*inputs)
            for cs in SPLITS:
                y, state = ops.launch(*inputs, col_split=cs)
                err = max((y - ref[0]).abs().max().item(),
                          (state - ref[1]).abs().max().item())
                if not err < TOL["wkv6"]:
                    raise RuntimeError(f"col_split {cs} {dtype} disagrees: {err}")
                emit(shape=list(SHAPE), dtype=dtype, seq_major=seq_major, col_split=cs,
                     blocks=B * H * cs, max_abs_err=err,
                     ms=time_ms(lambda: ops.launch(*inputs, col_split=cs)),
                     one_block_ms=time_ms(lambda: ops.launch(*one, col_split=cs)))
        del inputs, one, ref

    for per_sm in (1, 2, 3, 4):
        inputs = wkv_inputs((per_sm, sms, S, N, "float32"), device=dev, seq_major=True)
        for cs in SPLITS:
            emit(sweep="pairs_per_sm", pairs=per_sm * sms, blocks_per_sm=per_sm * cs,
                 col_split=cs, dtype="float32",
                 ms=time_ms(lambda: ops.launch(*inputs, col_split=cs)))
    # rwkv6-3b's prefill at 1 to 4 requests, with the split the wrapper picks
    for batch in (1, 2, 3, 4):
        inputs = wkv_inputs((batch, H, S, N, "float32"), device=dev, seq_major=True)
        for cs in SPLITS:
            emit(sweep="batch", batch=batch, pairs=batch * H, col_split=cs,
                 picked=cs == ops.col_split(batch * H, N, sms), dtype="float32",
                 ms=time_ms(lambda: ops.launch(*inputs, col_split=cs)))
    if args.out:
        with open(args.out, "w") as fh:
            fh.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
