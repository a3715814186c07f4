"""Batched serving driver of the port: full config on the CUDA card by default.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
      --batch 4 --prompt-len 256 --new-tokens 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b \
      --batch 4 --prompt-len 2112 --new-tokens 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \
      --batch 4 --prompt-len 2100 --new-tokens 32
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
"""
from __future__ import annotations

import argparse
import sys

import torch

from repro_torch import configs
from repro_torch.configs.base import RunConfig
from repro_torch.device import resolve_device
from repro_torch.models import LM
from repro_torch.serve.engine import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=configs.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced CPU-test config instead of the full one")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    run = RunConfig(param_dtype="float32", activation_dtype="float32",
                    use_pallas=True)
    params = LM.init(cfg, run, seed=args.seed, device=dev)
    engine = ServeEngine(cfg, run, params,
                         max_seq=args.prompt_len + args.new_tokens + 8)

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=dev)
    out = engine.generate(prompts, max_new_tokens=args.new_tokens,
                          temperature=args.temperature, generator=gen)
    st = engine.stats
    total_new = args.batch * args.new_tokens
    total_s = st.prefill_s + st.decode_s
    decode_ms = 1e3 * st.decode_s / max(st.decode_steps, 1)
    print(f"[serve] {cfg.name} on {dev}: generated {total_new} tokens in "
          f"{total_s:.3f}s ({total_new / total_s:.1f} tok/s); prefill "
          f"{1e3 * st.prefill_s:.2f} ms, decode {decode_ms:.2f} ms/token")
    for i in range(min(2, args.batch)):
        print(f"  seq{i}: {out[i, -args.new_tokens:].tolist()[:12]}...")
    return 0


if __name__ == "__main__":
    sys.exit(main())
