"""Fused patch embedding: uint8 dequantise + normalise + GEMM (PyTorch port
of ``tpuclip/ops/patch_embed.py``).

The vision tower's first op turns uint8 pixels into patch embeddings.
:func:`patch_embed_fused` does it in one kernel (kernel 8,
``tpuclip_torch/csrc/patch_embed.cu``, replaces ``_patch_embed_kernel``):
the patch rows are read once at 1 byte per pixel and dequantised to
``x = u8 * f32(1/127.5) - 1`` on the way to the tensor cores. It is a
library function, as in tpuclip: the towers keep their own GEMM
(``VisionTower.patch_embed``).

The wrapper dispatches on its tensors' device: CPU tensors go to the plain
version :func:`_patch_embed_plain` (same signature); CUDA tensors go to the
kernel, which runs or raises, and count in ``patch_embed_fused.launches``.
"""

from __future__ import annotations

import torch

from tpuclip_torch.ops._counters import counted

# float32(1 / 127.5): tpuclip's kernel multiplies by this constant.
_INV_127_5 = 1.0 / 127.5


def patches_from_images_u8(pixel_values_u8: torch.Tensor, patch_size: int) -> torch.Tensor:
    """uint8 NHWC (B, H, W, C) → (B * N, P*P*C) patch rows in (ph, pw, c)
    order, patches in row-major grid order (as ``VisionTower.patch_embed``)."""
    b, h, w, c = pixel_values_u8.shape
    ps = patch_size
    hp, wp = h // ps, w // ps
    x = pixel_values_u8.reshape(b, hp, ps, wp, ps, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * hp * wp, ps * ps * c)


def _dequantise(patches_u8: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x = float32(u8) * f32(1/127.5) - 1, each op rounded in f32, then
    rounded to ``dtype`` (tpuclip's ``x.astype(w.dtype)``)."""
    x = patches_u8.to(torch.float32)
    x = x * torch.tensor(_INV_127_5, dtype=torch.float32, device=x.device)
    x = x - torch.ones((), dtype=torch.float32, device=x.device)
    return x.to(dtype)


def _check_args(patches_u8, kernel, bias) -> None:
    if patches_u8.dtype != torch.uint8 or patches_u8.dim() != 2:
        raise TypeError(f"(R, P*P*C) uint8 patch rows required, got {patches_u8.dtype} {tuple(patches_u8.shape)}")
    if kernel.dim() != 2 or kernel.shape[0] != patches_u8.shape[1]:
        raise ValueError(f"kernel must be ({patches_u8.shape[1]}, D), got {tuple(kernel.shape)}")
    if bias.shape != (kernel.shape[1],):
        raise ValueError(f"bias must be ({kernel.shape[1]},), got {tuple(bias.shape)}")
    if not (patches_u8.device == kernel.device == bias.device):
        raise ValueError("patch rows, kernel and bias must share one device")


def _patch_embed_plain(patches_u8, kernel, bias, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version of :func:`patch_embed_fused`: x rounded to the weight
    dtype, products exact in float64 and summed there, rounded to f32, plus
    the bias in f32, then cast to ``out_dtype``."""
    _check_args(patches_u8, kernel, bias)
    x = _dequantise(patches_u8, kernel.dtype)
    acc = (x.double() @ kernel.double()).float()
    return (acc + bias.float()).to(out_dtype)


@counted
def patch_embed_fused(
    patches_u8: torch.Tensor,
    kernel: torch.Tensor,
    bias: torch.Tensor,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """(R, P*P*C) uint8 patch rows x (P*P*C, D) ``kernel`` + (D,) ``bias``
    → (R, D) ``out_dtype``: ``x = u8 * f32(1/127.5) - 1`` rounded to the
    kernel's dtype, fp32 accumulation, the bias added in fp32. On CUDA the
    kernel must be bf16, P*P*C a multiple of 4, D a multiple of 8 and
    ``out_dtype`` bf16 or f32; the kernel reads the weights as (P*P*C, D)
    row-major and the bias in f32 or bf16, so a row-major bf16 ``kernel``
    and such a ``bias`` are used as they are (another layout is copied
    once per call)."""
    _check_args(patches_u8, kernel, bias)
    if patches_u8.device.type == "cpu":
        return _patch_embed_plain(patches_u8, kernel, bias, out_dtype)
    if patches_u8.device.type != "cuda":
        raise ValueError(f"unsupported device {patches_u8.device}")
    if kernel.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA kernel takes bf16 weights, got {kernel.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the CUDA kernel writes bf16 or f32, got {out_dtype}")
    rows, k = patches_u8.shape
    d = kernel.shape[1]
    if k % 4 or d % 8:
        raise ValueError(f"the CUDA kernel takes P*P*C % 4 == 0 and D % 8 == 0, got {k}, {d}")
    from tpuclip_torch.ops._build import library

    x = patches_u8.contiguous()
    if x.data_ptr() % 16:  # a view into a larger tensor: the kernel loads 16 bytes a lane
        x = x.clone()
    w = kernel.contiguous()
    b = bias.contiguous() if bias.dtype in (torch.float32, torch.bfloat16) else bias.float()
    out = torch.empty((rows, d), dtype=out_dtype, device=x.device)
    if rows == 0:
        return out
    with torch.cuda.device(x.device):
        rc = library().tpuclip_patch_embed(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), rows, k, d,
            int(out_dtype == torch.float32), int(b.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"patch_embed kernel launch failed: cudaError {rc}")
    patch_embed_fused.launches += 1
    return out
