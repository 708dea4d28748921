"""DINOv3's 2-D rotary position on the patch rows of q and k (kernel 12,
``tpuclip_torch/csrc/rope2d.cu``; replaces no TPU kernel: tpuclip's towers
add a learned position table).

:func:`rope` takes q and k as the projections leave them, (B, S, H * hd),
and the per-grid tables ``cos`` and ``sin`` of (P, hd / 2) fp32 values, P =
S - ``prefix``. Rows ``prefix`` .. S - 1 of each image (the patches) are
rotated; the first ``prefix`` rows (class and register tokens) are left as
they are. On each head, column j < hd / 2 pairs with column j + hd / 2:
``lo * c - hi * s`` and ``hi * c + lo * s``, HF's ``x * cos +
rotate_half(x) * sin`` with its tiled (P, hd) table, whose halves are
equal. Computed in fp32 from the inputs and rounded once to their dtype.

The wrapper dispatches on its tensors' device: CPU tensors go to the plain
version :func:`rope_plain`, which returns new tensors; CUDA tensors go to
the kernel, which rotates q and k in place, returns them, and counts in
``rope.launches`` (one launch for q and k together). On the card the result
is bit-equal to the plain version: both round each product and the sum to
fp32 on their own.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tpuclip_torch.ops._counters import counted


def rope_plain(
    q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, heads: int, prefix: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`rope`: new tensors, the rotation computed in
    fp32 (fp64 stays fp64) and rounded once to the inputs' dtype. Autograd
    differentiates it."""
    return _rotate_plain(q, cos, sin, heads, prefix), _rotate_plain(k, cos, sin, heads, prefix)


def _rotate_plain(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, heads: int, prefix: int) -> torch.Tensor:
    b, s, d = x.shape
    hd = d // heads
    wide = torch.promote_types(x.dtype, torch.float32)
    p = x[:, prefix:].to(wide).view(b, s - prefix, heads, hd)
    lo, hi = p[..., : hd // 2], p[..., hd // 2 :]
    c, sn = cos.to(wide)[:, None, :], sin.to(wide)[:, None, :]
    rotated = torch.cat([lo * c - hi * sn, hi * c + lo * sn], dim=-1).view(b, s - prefix, d)
    return torch.cat([x[:, :prefix], rotated.to(x.dtype)], dim=1)


def _check_args(q, k, cos, sin, heads: int, prefix: int) -> None:
    """What the kernel takes, on every device: q and k of one (B, S, D)
    shape, dtype and device, D = heads * hd with hd a multiple of 16, at
    least one patch row after ``prefix``; (S - prefix, hd / 2) fp32 tables;
    everything contiguous; nothing that needs a gradient."""
    if q.dim() != 3 or k.shape != q.shape or k.dtype != q.dtype or k.device != q.device:
        raise ValueError(f"q and k must be one (B, S, D) shape, dtype and device, got {tuple(q.shape)} "
                         f"{q.dtype} on {q.device} and {tuple(k.shape)} {k.dtype} on {k.device}")
    b, s, d = q.shape
    if heads < 1 or d % heads or (d // heads) % 16:
        raise ValueError(f"the kernel takes heads of width hd % 16 == 0, got D {d} over {heads} heads")
    if not 0 <= prefix < s:
        raise ValueError(f"prefix {prefix} leaves no patch row of {s}")
    want = (s - prefix, d // heads // 2)
    for name, t in (("cos", cos), ("sin", sin)):
        if tuple(t.shape) != want or t.dtype != torch.float32 or t.device != q.device:
            raise ValueError(f"{name} must be an fp32 {want} table on {q.device}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    if not all(t.is_contiguous() for t in (q, k, cos, sin)):
        raise ValueError("the kernel reads whole rows in order: q, k, cos and sin must be contiguous")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, cos, sin)):
        raise ValueError("the CUDA kernel has no backward: rope_plain is the differentiable path")


@counted
def rope(
    q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, heads: int, prefix: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """q and k with their patch rows rotated; see :func:`_check_args` for
    what it takes. On CUDA: bf16 q and k, 16-byte aligned, rotated in place
    on the current stream with no host sync, so the call can be captured in
    a CUDA graph; on the CPU, :func:`rope_plain`'s new tensors."""
    _check_args(q, k, cos, sin, heads, prefix)
    if q.device.type == "cpu":
        return rope_plain(q, k, cos, sin, heads, prefix)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA kernel takes bf16 rows, got {q.dtype}")
    if any(t.data_ptr() % 16 for t in (q, k, cos, sin)):
        raise ValueError("the CUDA kernel reads rows 16 bytes at a time: every tensor must be 16-byte aligned")
    b, s, d = q.shape
    if b * (s - prefix) >= 2**31:
        raise ValueError(f"the kernel counts rows in 32 bits, got {b * (s - prefix)}")
    if b == 0:
        return q, k
    from tpuclip_torch.ops._build import library

    with torch.cuda.device(q.device):
        rc = library().tpuclip_rope2d(q.data_ptr(), k.data_ptr(), cos.data_ptr(), sin.data_ptr(), b, s, prefix, d,
                                      d // heads, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rope2d kernel launch failed: cudaError {rc}")
    rope.launches += 1
    return q, k
