"""Feed-forward block: the SwiGLU MLP.  MoE is not ported yet."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.utils.tree import ParamBuilder, fan_in_init


def init_mlp(pb: ParamBuilder, d_model: int, d_ff: int, variant: str = "swiglu"):
    if variant != "swiglu":
        raise NotImplementedError(f"mlp_variant={variant!r} is not ported")
    pb.param("w_gate", (d_model, d_ff), init=fan_in_init(d_model))
    pb.param("w_up", (d_model, d_ff), init=fan_in_init(d_model))
    pb.param("w_down", (d_ff, d_model), init=fan_in_init(d_ff))


def apply_mlp(p, x: torch.Tensor) -> torch.Tensor:
    u = x @ p["w_up"].to(x.dtype)
    g = x @ p["w_gate"].to(x.dtype)
    return (F.silu(g) * u) @ p["w_down"].to(x.dtype)
