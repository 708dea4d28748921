"""Plain fp32 DINOv3 ViT, the image embedding a library stores.

Written from the published description, DINOv3 (arXiv:2508.10104), in the
form of HF's ``DINOv3ViTModel`` (``use_gated_mlp`` true), at the served
image size:

- uint8 NHWC pixels → ``(x / 255 - mean_c) / std_c`` with the ImageNet mean
  and std of the checkpoint's preprocessor, a Conv2d patch embedding with
  stride = kernel = patch;
- ``cat(cls, registers, patches)``: no position table;
- the rotary table of the patch grid: centres ``(i + 0.5) / n`` on each
  axis, row-major, mapped to ``2c - 1``; ``inv_freq = 1 / theta **
  arange(0, 1, 4 / hd)``; angles ``2π · c · inv_freq`` for h then w, tiled
  to the head width; cos and sin of them, in fp32;
- pre-LN blocks: ``x = x + λ1 ⊙ o(attn(LN1(x)))``: q and v with a bias, k
  without; on each head of q and k, the patch rows (not the class and
  register rows) become ``x · cos + rotate_half(x) · sin``, ``rotate_half(x)
  = cat(-x[hd/2:], x[:hd/2])``; scale head_dim^-0.5, fp32 softmax; then
  ``x = x + λ2 ⊙ down(silu(gate(LN2(x))) ⊙ up(LN2(x)))``;
- the final LayerNorm over every token, and the class token
  (``pooler_output``), L2-normalised.

Departures from HF: HF's image processor resizes to 224 and normalises;
here, as in the program's scan, the input is already the square image at
the served size (the benchmark's seeded pixels). HF casts cos and sin to
the model's dtype; here everything is fp32. The mask token (masked-image
training) and the train-time shift, jitter and rescale of the patch
centres are not used. The batch runs in blocks so that it fits on the card,
and every product goes through ``prec`` (``siglip_ref``'s precision switch:
fp32 with TF32 off, or the fp8 e4m3 control); the rotation is not a
product and stays fp32. This file imports nothing of the program and
nothing of JAX.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from bench_port.reference.siglip_ref import FP32, _attention, _linear, _mm, _norm, exact_fp32

PREFIX = "embeddings"


def rope_table(shape, n_h: int, n_w: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (n_h * n_w, hd) fp32: HF's
    ``DINOv3ViTRopePositionEmbedding`` at inference."""
    hd = shape.hidden // shape.heads
    inv_freq = 1 / shape.rope_theta ** torch.arange(0, 1, 4 / hd, dtype=torch.float32, device=device)
    coords_h = torch.arange(0.5, n_h, dtype=torch.float32, device=device) / n_h
    coords_w = torch.arange(0.5, n_w, dtype=torch.float32, device=device) / n_w
    coords = torch.stack(torch.meshgrid(coords_h, coords_w, indexing="ij"), dim=-1).flatten(0, 1)
    coords = 2.0 * coords - 1.0
    angles = (2 * math.pi * coords[:, :, None] * inv_freq[None, None, :]).flatten(1, 2).tile(2)
    return torch.cos(angles), torch.sin(angles)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat((-x[..., half:], x[..., :half]), dim=-1)


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, S, D): the last P = len(cos) rows of each head turned."""
    b, s, d = x.shape
    n = cos.shape[0]
    x = x.view(b, s, heads, d // heads).transpose(1, 2)
    prefix, patches = x.split((s - n, n), dim=-2)
    patches = patches * cos + rotate_half(patches) * sin
    return torch.cat((prefix, patches), dim=-2).transpose(1, 2).reshape(b, s, d)


def _layer(x, w: Dict[str, torch.Tensor], i: int, shape, cos, sin, prec) -> torch.Tensor:
    p = f"layer.{i}"
    y = _norm(x, w, f"{p}.norm1", shape.eps)
    q = _rope(_linear(y, w, f"{p}.attention.q_proj", prec), cos, sin, shape.heads)
    k = _rope(_mm(y, w[f"{p}.attention.k_proj.weight"].t(), prec), cos, sin, shape.heads)  # no bias
    v = _linear(y, w, f"{p}.attention.v_proj", prec)
    a = _linear(_attention(q, k, v, shape.heads, None, prec), w, f"{p}.attention.o_proj", prec)
    x = x + w[f"{p}.layer_scale1.lambda1"] * a
    y = _norm(x, w, f"{p}.norm2", shape.eps)
    h = F.silu(_linear(y, w, f"{p}.mlp.gate_proj", prec)) * _linear(y, w, f"{p}.mlp.up_proj", prec)
    return x + w[f"{p}.layer_scale2.lambda1"] * _linear(h, w, f"{p}.mlp.down_proj", prec)


def embed(w: Dict[str, torch.Tensor], pixels: torch.Tensor, shape, prec=FP32()) -> torch.Tensor:
    """uint8 (B, H, W, C), H and W multiples of the patch → unit fp32 (B, D)."""
    b, h, wd = pixels.shape[:3]
    if h % shape.patch or wd % shape.patch:
        raise ValueError(f"the reference takes sides that are multiples of {shape.patch}, got {h} x {wd}")
    dev = pixels.device
    mean = torch.tensor(shape.image_mean, dtype=torch.float32, device=dev).view(1, -1, 1, 1)
    std = torch.tensor(shape.image_std, dtype=torch.float32, device=dev).view(1, -1, 1, 1)
    x = (pixels.to(torch.float32).permute(0, 3, 1, 2) / 255.0 - mean) / std
    kernel = w[f"{PREFIX}.patch_embeddings.weight"]
    x = F.conv2d(prec.tensor(x), prec.rows(kernel.flatten(1), -1).view_as(kernel),
                 w[f"{PREFIX}.patch_embeddings.bias"], stride=shape.patch)
    x = x.flatten(2).transpose(1, 2)
    d = x.shape[-1]
    x = torch.cat([w[f"{PREFIX}.cls_token"].expand(b, 1, d), w[f"{PREFIX}.register_tokens"].expand(b, -1, d), x],
                  dim=1)
    cos, sin = rope_table(shape, h // shape.patch, wd // shape.patch, dev)
    for i in range(shape.layers):
        x = _layer(x, w, i, shape, cos, sin, prec)
    return F.normalize(_norm(x, w, "norm", shape.eps)[:, 0], dim=-1)


def reference_rows(w32, pixels, rows, shape, prec=FP32(), block: int = 16) -> torch.Tensor:
    """The tower over ``rows`` of the host uint8 ``pixels``, in blocks of
    ``block`` images on the weights' device."""
    device = next(iter(w32.values())).device
    out = []
    with exact_fp32(), torch.no_grad():
        for s in range(0, len(rows), block):
            out.append(embed(w32, torch.from_numpy(pixels[rows[s : s + block]]).to(device), shape, prec))
    return torch.cat(out)
