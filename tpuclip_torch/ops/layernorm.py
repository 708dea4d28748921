"""The residual add and the LayerNorm after it, one pass (kernel 10,
``tpuclip_torch/csrc/add_layernorm.cu``; replaces no TPU kernel: tpuclip
leaves LayerNorm and the add to XLA's fusion).

:func:`add_layer_norm` takes rows of width D (x and the pending residual
``delta``) and returns ``(x + delta, LayerNorm(x + delta))``; with ``delta``
None it is a plain LayerNorm and returns ``x`` itself beside it. With a
``scale`` (a (D,) vector: DINOv2's LayerScale on the branch that left
``delta`` pending) the sum is ``x + scale * delta``, computed in fp32. The
sum is rounded once to x's dtype, and the statistics are taken in fp32 from the
rounded sum, as the towers' add then ``F.layer_norm`` compute them; the
weight and bias are rounded to x's dtype first, as the towers' LayerNorm
rounds them.

The wrapper dispatches on its tensors' device: CPU tensors go to the plain
version :func:`add_layer_norm_plain` (the towers' former add and
``F.layer_norm``); CUDA tensors go to the kernel, which runs or raises, and
count in ``add_layer_norm.launches``. On the card ``x + delta`` is
bit-equal to PyTorch's add and the LayerNorm differs from
``F.layer_norm`` only by the order of the row's sums.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from tpuclip_torch.ops._counters import counted

MAX_WIDTH = 4096  # the kernel's widest row (DINOv3-7B's width): up to 1536 a row a warp, wider a row a block


def add_layer_norm_plain(
    x: torch.Tensor, delta: Optional[torch.Tensor], weight: torch.Tensor, bias: torch.Tensor, eps: float,
    scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`add_layer_norm`: ``x + delta`` (``delta``
    None: ``x``; with ``scale``, ``x + scale * delta`` in fp32, rounded once
    to x's dtype), then ``F.layer_norm`` with the weight and bias in its
    dtype. Autograd differentiates it."""
    if scale is not None:
        if delta is None:
            raise ValueError("a scale multiplies the pending residual: delta is None")
        wide = torch.promote_types(x.dtype, torch.float32)
        x = (x.to(wide) + scale.to(wide) * delta.to(wide)).to(x.dtype)
    elif delta is not None:
        x = x + delta
    return x, F.layer_norm(x, x.shape[-1:], weight.to(x.dtype), bias.to(x.dtype), eps)


def _check_args(x, delta, weight, bias, scale=None) -> None:
    """What the kernel takes, on every device: x and delta of one dtype,
    shape and device, rows of width D (a multiple of 8, 8 to
    :data:`MAX_WIDTH`), contiguous; a (D,) weight and bias, and scale (only
    beside a delta); nothing that needs a gradient."""
    d = x.shape[-1] if x.dim() else 0
    if scale is not None and (delta is None or scale.shape != (d,)):
        raise ValueError(f"a scale must be ({d},) and come with a delta, got {tuple(scale.shape)} "
                         f"(delta given: {delta is not None})")
    if delta is not None:
        if delta.dtype != x.dtype:
            raise TypeError(f"x and delta must share a dtype, got {x.dtype} and {delta.dtype}")
        if delta.shape != x.shape or delta.device != x.device:
            raise ValueError(f"delta must be x's shape on x's device, got {tuple(delta.shape)} on {delta.device} "
                             f"beside {tuple(x.shape)} on {x.device}")
    if d % 8 or not 8 <= d <= MAX_WIDTH:
        raise ValueError(f"the kernel takes rows of width D % 8 == 0, 8 <= D <= {MAX_WIDTH}, got {tuple(x.shape)}")
    if weight.shape != (d,) or bias.shape != (d,):
        raise ValueError(f"weight and bias must be ({d},), got {tuple(weight.shape)}, {tuple(bias.shape)}")
    tensors = [t for t in (x, delta, weight, bias, scale) if t is not None]
    if any(t.device != x.device for t in tensors):
        raise ValueError("x, delta, weight, bias and scale must share one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the kernel reads whole rows in order: x, delta, weight, bias and scale must be contiguous")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError("the CUDA kernel has no backward: add_layer_norm_plain is the differentiable path")


@counted
def add_layer_norm(
    x: torch.Tensor, delta: Optional[torch.Tensor], weight: torch.Tensor, bias: torch.Tensor, eps: float,
    scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(x + delta, LayerNorm(x + delta))`` over the last dimension, both
    in x's dtype (``delta`` None: ``(x, LayerNorm(x))``; with ``scale``,
    ``x + scale * delta`` in its place); see
    :func:`_check_args` for what it takes. On CUDA: bf16 x and delta, 16-byte
    aligned; the outputs are new contiguous tensors, from ``torch.empty`` on
    the current stream, with no host sync, so the call can be captured in a
    CUDA graph."""
    _check_args(x, delta, weight, bias, scale)
    if x.device.type == "cpu":
        return add_layer_norm_plain(x, delta, weight, bias, eps, scale)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA kernel takes bf16 rows, got {x.dtype}")
    weight, bias = weight.to(x.dtype), bias.to(x.dtype)
    scale = None if scale is None else scale.to(x.dtype)
    if any(t.data_ptr() % 16 for t in (x, delta, weight, bias, scale) if t is not None):
        raise ValueError("the CUDA kernel reads rows 16 bytes at a time: every tensor must be 16-byte aligned")
    from tpuclip_torch.ops._build import library

    rows, d = x.numel() // x.shape[-1], x.shape[-1]
    if rows >= 2**31:
        raise ValueError(f"the kernel counts rows in 32 bits, got {rows}")
    x_out = x if delta is None else torch.empty(x.shape, dtype=x.dtype, device=x.device)
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if rows == 0:
        return x_out, y
    with torch.cuda.device(x.device):
        rc = library().tpuclip_add_layernorm(
            x.data_ptr(), 0 if delta is None else delta.data_ptr(), 0 if scale is None else scale.data_ptr(),
            weight.data_ptr(), bias.data_ptr(), 0 if delta is None else x_out.data_ptr(), y.data_ptr(), rows, d,
            float(eps), torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"add_layernorm kernel launch failed: cudaError {rc}")
    add_layer_norm.launches += 1
    return x_out, y
