"""Serving: prefill the prompt batch, then one decode step per new token.

``ServeEngine`` runs on the device its params live on.  Greedy decoding takes
the argmax; temperature sampling draws from a caller-supplied
``torch.Generator`` (it does not reproduce ``jax.random``'s draws).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.device import synchronize
from repro_torch.models import transformer
from repro_torch.models.model import LM


@dataclass(frozen=True)
class GenerateStats:
    """Host-clock times of the last ``generate``, each ending in a device sync."""
    prefill_s: float
    decode_s: float
    decode_steps: int


class ServeEngine:
    """Batched generation on one device."""

    def __init__(self, cfg, run, params, max_seq: int = 512):
        transformer.check_supported(cfg, run)
        self.cfg, self.run = cfg, run
        self.max_seq = max_seq
        self.params = params
        self.device = params["embed"].device
        self.stats: Optional[GenerateStats] = None

    @torch.inference_mode()
    def generate(self, prompts: torch.Tensor, max_new_tokens: int = 32,
                 temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """prompts: (B, S0) int on the engine's device -> (B, S0 + max_new_tokens)."""
        if prompts.device != self.device:
            raise ValueError(f"prompts on {prompts.device}, params on {self.device}")
        if temperature > 0.0 and generator is None:
            raise ValueError("temperature sampling needs a torch.Generator")
        B, S0 = prompts.shape
        if S0 + max_new_tokens - 1 > self.max_seq:
            raise ValueError(f"{S0} + {max_new_tokens} tokens exceed max_seq {self.max_seq}")
        cfg, run = self.cfg, self.run
        t0 = time.perf_counter()
        logits, cache = LM.prefill(self.params, cfg, run, prompts, self.max_seq)
        tok = self._sample(logits[:, -1], temperature, generator)
        synchronize(self.device)
        t1 = time.perf_counter()
        out = [prompts]
        for i in range(max_new_tokens):
            out.append(tok)
            if i == max_new_tokens - 1:
                break
            logits, cache = LM.decode_step(self.params, cfg, run, tok, cache, S0 + i)
            tok = self._sample(logits[:, -1], temperature, generator)
        synchronize(self.device)
        self.stats = GenerateStats(t1 - t0, time.perf_counter() - t1,
                                   max(max_new_tokens - 1, 0))
        return torch.cat(out, dim=1)

    @staticmethod
    def _sample(logits, temperature, generator):
        if temperature <= 0.0:
            return logits.argmax(dim=-1, keepdim=True)
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)
