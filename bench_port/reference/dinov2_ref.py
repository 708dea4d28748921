"""Plain fp32 DINOv2 with registers, the image embedding a library stores.

Written from the published descriptions, DINOv2 (arXiv:2304.07193) and
"Vision Transformers Need Registers" (arXiv:2309.16588), in the form of HF's
``Dinov2WithRegistersModel`` (``use_swiglu_ffn`` true), at the configured
image size:

- uint8 NHWC pixels → ``(x / 255 - mean_c) / std_c`` with the ImageNet mean
  and std of the checkpoint's preprocessor, a Conv2d patch embedding with
  stride = kernel = patch;
- the class token prepended, the (1 + patches, D) position table added as
  published (HF adds it as is where the grid is the table's), then the
  register tokens inserted after the class token, without positions;
- pre-LN blocks: ``x = x + λ1 ⊙ o(attn(LN1(x)))`` (q/k/v with bias, scale
  head_dim^-0.5, fp32 softmax), ``x = x + λ2 ⊙ W_out(silu(a) ⊙ b)`` with
  ``[a | b] = W_in(LN2(x))`` split in halves (HF's ``chunk(2, -1)``);
- the final LayerNorm over every token, and the class token
  (``pooler_output``), L2-normalised.

Departures from HF: HF's image processor resizes the shortest edge and
crops the centre; here, as in the program's scan, the input is already the
square image (the benchmark's seeded pixels). The mask token (masked-image
training) is not used. Other sizes would need HF's bicubic position
interpolation and are refused. The batch runs in blocks so that it fits on
the card, and every product goes through ``prec`` (``siglip_ref``'s
precision switch: fp32 with TF32 off, or the fp8 e4m3 control). This file
imports nothing of the program and nothing of JAX.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from bench_port.reference.siglip_ref import FP32, _attention, _linear, _norm, exact_fp32


def _layer(x, w: Dict[str, torch.Tensor], i: int, shape, prec) -> torch.Tensor:
    p = f"encoder.layer.{i}"
    y = _norm(x, w, f"{p}.norm1", shape.eps)
    q = _linear(y, w, f"{p}.attention.attention.query", prec)
    k = _linear(y, w, f"{p}.attention.attention.key", prec)
    v = _linear(y, w, f"{p}.attention.attention.value", prec)
    a = _linear(_attention(q, k, v, shape.heads, None, prec), w, f"{p}.attention.output.dense", prec)
    x = x + w[f"{p}.layer_scale1.lambda1"] * a
    gate, value = _linear(_norm(x, w, f"{p}.norm2", shape.eps), w, f"{p}.mlp.weights_in", prec).chunk(2, dim=-1)
    return x + w[f"{p}.layer_scale2.lambda1"] * _linear(F.silu(gate) * value, w, f"{p}.mlp.weights_out", prec)


def embed(w: Dict[str, torch.Tensor], pixels: torch.Tensor, shape, prec=FP32()) -> torch.Tensor:
    """uint8 (B, S, S, C) at the configured S → unit fp32 (B, D)."""
    b, s = pixels.shape[0], shape.image_size
    if tuple(pixels.shape[1:3]) != (s, s):
        raise ValueError(f"the reference takes {s} x {s} images, got {tuple(pixels.shape[1:3])}")
    dev = pixels.device
    mean = torch.tensor(shape.image_mean, dtype=torch.float32, device=dev).view(1, -1, 1, 1)
    std = torch.tensor(shape.image_std, dtype=torch.float32, device=dev).view(1, -1, 1, 1)
    x = (pixels.to(torch.float32).permute(0, 3, 1, 2) / 255.0 - mean) / std
    kernel = w["embeddings.patch_embeddings.projection.weight"]
    x = F.conv2d(prec.tensor(x), prec.rows(kernel.flatten(1), -1).view_as(kernel),
                 w["embeddings.patch_embeddings.projection.bias"], stride=shape.patch)
    x = x.flatten(2).transpose(1, 2)
    d = x.shape[-1]
    x = torch.cat([w["embeddings.cls_token"].expand(b, 1, d), x], dim=1) + w["embeddings.position_embeddings"]
    x = torch.cat([x[:, :1], w["embeddings.register_tokens"].expand(b, -1, d), x[:, 1:]], dim=1)
    for i in range(shape.layers):
        x = _layer(x, w, i, shape, prec)
    return F.normalize(_norm(x, w, "layernorm", shape.eps)[:, 0], dim=-1)


def reference_rows(w32, pixels, rows, shape, prec=FP32(), block: int = 16) -> torch.Tensor:
    """The tower over ``rows`` of the host uint8 ``pixels``, in blocks of
    ``block`` images on the weights' device."""
    device = next(iter(w32.values())).device
    out = []
    with exact_fp32(), torch.no_grad():
        for s in range(0, len(rows), block):
            out.append(embed(w32, torch.from_numpy(pixels[rows[s : s + block]]).to(device), shape, prec))
    return torch.cat(out)
