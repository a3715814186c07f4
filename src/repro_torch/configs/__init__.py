"""Architecture config registry of the port.

``get_config(arch_id)`` returns the published configuration and
``get_smoke_config(arch_id)`` its reduced CPU-test variant, for the archs the
port runs.  Every other arch of the JAX package raises ``KeyError``.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, MoEConfig, RunConfig

ARCH_IDS = ("smollm-360m", "recurrentgemma-2b", "rwkv6-3b")

_MODULES = {"smollm-360m": "smollm_360m", "recurrentgemma-2b": "recurrentgemma_2b",
            "rwkv6-3b": "rwkv6_3b"}

_NOT_YET_PORTED = (
    "mixtral-8x22b",
    "qwen2-moe-a2.7b",
    "musicgen-large",
    "qwen3-32b",
    "granite-8b",
    "command-r-plus-104b",
    "chameleon-34b",
)


def _mod(arch_id: str):
    if arch_id in _NOT_YET_PORTED:
        raise KeyError(f"arch {arch_id!r} not yet ported; ported: {list(ARCH_IDS)}")
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; ported: {list(ARCH_IDS)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _mod(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _mod(arch_id).smoke()


__all__ = ["ARCH_IDS", "ModelConfig", "MoEConfig", "RunConfig", "get_config",
           "get_smoke_config"]
