"""Fused multi-head attention for the towers (kernel 9; replaces no TPU
kernel: tpuclip computes attention as two einsums and leaves the fusion to
XLA). Kernel 9 has two hand-written designs with one C signature:
``tpuclip_torch/csrc/attention.cu`` (mma.sync, FlashAttention-2's form) and
``tpuclip_torch/csrc/attention_sm90.cu`` (wgmma and TMA, two consumer
warpgroups in ping-pong, FlashAttention-3's form); :func:`takes_sm90` picks
one by shape.

:func:`attention` takes the q / k / v projections' (B, S, H * hd) outputs,
head ``h`` at columns ``h * hd`` of each row, and returns the heads'
outputs (B, Sq, H * hd) before the output projection: scale 1/sqrt(hd),
fp32 logits and softmax, the weighted sum in the inputs' dtype. The
optional key mask is an additive fp32 (B, Sk) bias, the one form the
towers build.

The wrapper dispatches on its tensors' device: CPU tensors go to the plain
version :func:`attention_plain` (the towers' explicit-matmul arithmetic,
tpuclip's einsums); CUDA tensors go to one of the two kernels, which runs
or raises, and count in ``attention.launches``; the Hopper design's
launches count in ``attention_sm90.launches`` as well. On the card the kernel rounds the
unnormalised weights exp(s - m) to bf16 and divides by their fp32 sum at
the end, where the plain version rounds the normalised weights: both round
P once at bf16 precision.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from tpuclip_torch.ops._counters import counted

_MAX_HEAD_DIM = 128  # the kernel's widest instantiation

# The shape rule between the two designs, from kernel-alone times on the
# H100 (both designs in turns in one call, 16 heads of 72; PERF.md, kernel
# 9): the Hopper design where Sq fills its 128-row tiles (B 64 x S 729:
# 0.483 against 0.857 ms; B 256 x S 256: 0.315 against 0.487 ms, 0.331
# against 0.511 with NaFlex's key bias); the mma.sync design below that
# (the text tower's B 64 x S 64: 0.040 against 0.044 ms, half of each
# Hopper tile empty) and for the MAP head's Sq = 1, the tiny presets' head
# width 16, the widths the Hopper design is not built for, and key counts
# whose two key-bias rows would not fit in its shared memory.
_SM90_HEAD_DIMS = (64, 72, 96, 128)
_SM90_MIN_SQ = 128
_SM90_MAX_SK = 4096


def takes_sm90(sq: int, sk: int, hd: int) -> bool:
    """Whether a launch of Sq query rows over Sk keys at head width ``hd``
    goes to the Hopper design (else to the mma.sync one)."""
    return hd in _SM90_HEAD_DIMS and sq >= _SM90_MIN_SQ and sk <= _SM90_MAX_SK


def attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Plain version of :func:`attention`, the explicit matmuls autograd
    differentiates: ``mask`` additive, broadcastable to (B, H, Sq, Sk)."""
    b, sq, width = q.shape
    sk = k.shape[1]
    h = num_heads
    q = q.view(b, sq, h, width // h).transpose(1, 2)
    k = k.view(b, sk, h, width // h).transpose(1, 2)
    v = v.view(b, sk, h, width // h).transpose(1, 2)
    scale = 1.0 / math.sqrt(width // h)
    # fp32 logits: products of bf16 values are exact in fp32, so this is
    # the JAX tower's bf16 x bf16 -> f32 contraction (TF32 must be off).
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits + mask.float()
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.matmul(weights, v).transpose(1, 2)  # (B, Sq, H, hd)
    return out.reshape(b, sq, width)


def _check_args(q, k, v, num_heads, key_bias) -> None:
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"(B, S, H * hd) q, k, v required, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, width = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != width or k.shape[1] < 1:
        raise ValueError(f"k and v must be (B, Sk >= 1, {width}) beside q {tuple(q.shape)}, "
                         f"got {tuple(k.shape)}, {tuple(v.shape)}")
    if num_heads < 1 or width % num_heads:
        raise ValueError(f"width {width} is not a multiple of num_heads {num_heads}")
    if key_bias is not None and key_bias.shape != (b, k.shape[1]):
        raise ValueError(f"key_bias must be (B, Sk) = {(b, k.shape[1])}, got {tuple(key_bias.shape)}")
    tensors = [q, k, v] + ([key_bias] if key_bias is not None else [])
    if any(t.device != q.device for t in tensors):
        raise ValueError("q, k, v and key_bias must share one device")


def _check_cuda_args(q, k, v, num_heads, key_bias) -> None:
    """What the kernel takes: bf16 q, k, v that need no gradient, with a
    contiguous last dimension, 16-byte aligned rows (pointers and strides),
    hd a multiple of 8 up to 128; an f32 key bias with a contiguous last
    dimension."""
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"the CUDA kernel takes bf16 q, k, v, got {q.dtype}, {k.dtype}, {v.dtype}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise ValueError("the CUDA kernel has no backward: attention_plain is the differentiable path")
    hd = q.shape[2] // num_heads
    if hd % 8 or hd > _MAX_HEAD_DIM:
        raise ValueError(f"the CUDA kernel takes head_dim % 8 == 0 and <= {_MAX_HEAD_DIM}, got {hd}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(2) != 1 or t.stride(0) % 8 or t.stride(1) % 8 or t.data_ptr() % 16:
            raise ValueError(f"the CUDA kernel reads {name} rows 16 bytes at a time: last stride 1, other "
                             f"strides multiples of 8, 16-byte aligned; got strides {t.stride()}")
        if max(t.stride(0), t.stride(1)) >= 2**31:
            raise ValueError(f"{name}'s strides {t.stride()} pass 32 bits")
    if key_bias is not None:
        if key_bias.dtype != torch.float32:
            raise TypeError(f"the CUDA kernel takes an f32 key bias, got {key_bias.dtype}")
        if key_bias.stride(1) != 1 or key_bias.stride(0) >= 2**31:
            raise ValueError(f"the key bias's keys must be contiguous, got strides {key_bias.stride()}")


def _kernel_args(q, k, v, num_heads, key_bias, out):
    """The C entry points' arguments (both designs take the same)."""
    b, sq, width = q.shape
    hd = width // num_heads
    return (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), 0 if key_bias is None else key_bias.data_ptr(),
        out.data_ptr(), b, sq, k.shape[1], num_heads, hd, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), 0 if key_bias is None else key_bias.stride(0), 1.0 / math.sqrt(hd),
        torch.cuda.current_stream(q.device).cuda_stream,
    )


@counted
def attention_sm90(q, k, v, num_heads, key_bias, out) -> None:
    """Launches the Hopper design (``tpuclip_attention_sm90``) into ``out``;
    :func:`attention` checks the arguments and calls it where
    :func:`takes_sm90` says."""
    from tpuclip_torch.ops._build import library

    rc = library().tpuclip_attention_sm90(*_kernel_args(q, k, v, num_heads, key_bias, out))
    if rc != 0:
        raise RuntimeError(f"attention kernel (Hopper design) launch failed: cudaError {rc}")
    attention_sm90.launches += 1


@counted
def attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int, key_bias: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Heads of q (B, Sq, H * hd) attending over k, v (B, Sk, H * hd) →
    (B, Sq, H * hd) in q's dtype; ``key_bias`` an additive (B, Sk) key mask.
    On CUDA: bf16 q, k, v that need no gradient, read in place (see
    :func:`_check_cuda_args`), an f32 ``key_bias``; the output is a new
    contiguous tensor, from
    ``torch.empty`` on the current stream, with no host sync, so the call
    can be captured in a CUDA graph. Which of kernel 9's two designs runs
    is :func:`takes_sm90`'s rule on (Sq, Sk, hd)."""
    _check_args(q, k, v, num_heads, key_bias)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, num_heads, None if key_bias is None else key_bias[:, None, None, :])
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_cuda_args(q, k, v, num_heads, key_bias)
    from tpuclip_torch.ops._build import library

    b, sq, width = q.shape
    out = torch.empty((b, sq, width), dtype=q.dtype, device=q.device)
    if b == 0 or sq == 0:
        return out
    with torch.cuda.device(q.device):
        if takes_sm90(sq, k.shape[1], width // num_heads):
            attention_sm90(q, k, v, num_heads, key_bias, out)
        else:
            rc = library().tpuclip_attention(*_kernel_args(q, k, v, num_heads, key_bias, out))
            if rc != 0:
                raise RuntimeError(f"attention kernel launch failed: cudaError {rc}")
    attention.launches += 1
    return out
