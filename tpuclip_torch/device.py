"""Device selection for the PyTorch port.

One rule: the port runs where the caller says. ``cuda`` needs a CUDA card and
raises without one; the CPU is used only when the caller names it (the tests
and ``--device cpu`` do). Nothing switches device quietly.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(name: DeviceLike = "cuda") -> torch.device:
    """``None``/``"cuda"``/``"cuda:N"`` → that CUDA device (raises when CUDA is
    absent); ``"cpu"`` → the CPU."""
    device = torch.device("cuda" if name is None else name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA was requested but torch.cuda.is_available() is False; "
                "pass device='cpu' (CLI: --device cpu) to run on the CPU."
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return device
    if device.type != "cpu":
        raise ValueError(f"Unsupported device {name!r}: use 'cuda' or 'cpu'")
    return device


def default_dtype(device: torch.device) -> torch.dtype:
    """Storage/compute dtype for weights and resident rows: bf16 on CUDA,
    fp32 on the CPU (the JAX engine's TPU/CPU split, tpuclip/engine.py)."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32
