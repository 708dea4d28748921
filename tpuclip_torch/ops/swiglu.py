"""SwiGLU's gate, ``silu(a) * b`` over the two halves of a row (kernel 11,
``tpuclip_torch/csrc/silu_mul.cu``; replaces no TPU kernel: tpuclip has no
SwiGLU tower).

:func:`silu_mul` takes the (..., 2H) output of a SwiGLU MLP's first
projection, whose first H columns are the gate ``a`` and whose last H are
``b`` (HF's ``chunk(2, -1)``), and returns the (..., H) ``silu(a) * b``,
computed in fp32 and rounded once to the input's dtype.

The wrapper dispatches on its tensor's device: CPU tensors go to the plain
version :func:`silu_mul_plain`; CUDA tensors go to the kernel, which runs or
raises, and count in ``silu_mul.launches``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpuclip_torch.ops._counters import counted


def silu_mul_plain(h: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`silu_mul`: ``silu(a) * b`` of the two halves
    in fp32 (fp64 stays fp64), rounded once to h's dtype. Autograd
    differentiates it."""
    a, b = h.to(torch.promote_types(h.dtype, torch.float32)).chunk(2, dim=-1)
    return (F.silu(a) * b).to(h.dtype)


def _check_args(h: torch.Tensor) -> None:
    """What the kernel takes, on every device: rows of width 2H with H a
    multiple of 8, contiguous, that need no gradient."""
    w = h.shape[-1] if h.dim() else 0
    if w % 16 or w == 0:
        raise ValueError(f"the kernel takes rows of width 2H, H % 8 == 0, got {tuple(h.shape)}")
    if not h.is_contiguous():
        raise ValueError("the kernel reads whole rows in order: the input must be contiguous")
    if torch.is_grad_enabled() and h.requires_grad:
        raise ValueError("the CUDA kernel has no backward: silu_mul_plain is the differentiable path")


@counted
def silu_mul(h: torch.Tensor) -> torch.Tensor:
    """``silu(h[..., :H]) * h[..., H:]``, a new contiguous (..., H) tensor in
    h's dtype; see :func:`_check_args` for what it takes. On CUDA: bf16,
    16-byte aligned; the output comes from ``torch.empty`` on the current
    stream, with no host sync, so the call can be captured in a CUDA graph."""
    _check_args(h)
    if h.device.type == "cpu":
        return silu_mul_plain(h)
    if h.device.type != "cuda":
        raise ValueError(f"unsupported device {h.device}")
    if h.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA kernel takes bf16 rows, got {h.dtype}")
    if h.data_ptr() % 16:
        raise ValueError("the CUDA kernel reads rows 16 bytes at a time: the input must be 16-byte aligned")
    from tpuclip_torch.ops._build import library

    half = h.shape[-1] // 2
    rows = h.numel() // h.shape[-1]
    if rows >= 2**31:
        raise ValueError(f"the kernel counts rows in 32 bits, got {rows}")
    out = torch.empty(h.shape[:-1] + (half,), dtype=h.dtype, device=h.device)
    if rows == 0:
        return out
    with torch.cuda.device(h.device):
        rc = library().tpuclip_silu_mul(h.data_ptr(), out.data_ptr(), rows, half,
                                        torch.cuda.current_stream(h.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"silu_mul kernel launch failed: cudaError {rc}")
    silu_mul.launches += 1
    return out
