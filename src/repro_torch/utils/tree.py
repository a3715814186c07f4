"""Parameter init: the port's ``ParamBuilder``.

Parameter trees are nested dicts of tensors with the JAX package's names and
shapes.  Values are drawn from one explicit ``torch.Generator`` that lives on
the target device, so a full-width init happens on the card.  The JAX
package's logical sharding specs have no counterpart on one card and are
dropped.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

Init = Callable[[torch.Generator, tuple, torch.dtype, torch.device], torch.Tensor]


def _normal_init(scale: float) -> Init:
    def init(gen, shape, dtype, device):
        x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return x.mul_(scale).to(dtype)
    return init


def fan_in_init(fan_in: int) -> Init:
    return _normal_init(1.0 / math.sqrt(max(fan_in, 1)))


def zeros_init(gen, shape, dtype, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=device)


class ParamBuilder:
    """Accumulates a params tree; every leaf draws from the shared generator."""

    def __init__(self, generator: torch.Generator, dtype: torch.dtype):
        self.generator = generator
        self.device = generator.device
        self.dtype = dtype
        self.params: dict = {}

    def param(self, name: str, shape, init: Init) -> torch.Tensor:
        shape = tuple(int(s) for s in shape)
        if name in self.params:
            raise ValueError(f"duplicate param {name}")
        leaf = init(self.generator, shape, self.dtype, self.device)
        self.params[name] = leaf
        return leaf

    def child(self, name: str) -> "ParamBuilder":
        if name in self.params:
            raise ValueError(f"duplicate child {name}")
        sub = ParamBuilder(self.generator, self.dtype)
        self.params[name] = sub.params
        return sub

