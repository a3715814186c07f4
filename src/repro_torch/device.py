"""Where the port runs: the CUDA card unless the caller asks for the CPU."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``.  A CUDA device without a usable card raises:
    the port never carries on on the CPU unless the caller passed ``"cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            f"pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}: use 'cuda' or 'cpu'")
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """``RunConfig`` dtype names ("float32", "bfloat16") -> torch dtypes."""
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if name not in dtypes:
        raise ValueError(f"unsupported dtype {name!r}; supported: {sorted(dtypes)}")
    return dtypes[name]


def synchronize(device: Optional[torch.device]) -> None:
    """Wait for the card (a no-op on the CPU), e.g. before reading a clock."""
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
