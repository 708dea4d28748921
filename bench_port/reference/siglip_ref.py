"""Plain fp32 SigLIP vision towers, fixed-resolution and SigLIP 2 NaFlex.

Written from the published descriptions: SigLIP (arXiv:2303.15343) and
SigLIP 2 (arXiv:2502.14786, NaFlex included), in the form of HF's
``SiglipVisionTransformer`` / ``Siglip2VisionTransformer``:

- fixed resolution: uint8 NHWC pixels → x/127.5 - 1 (rescale by 1/255, then
  mean = std = 0.5), a Conv2d patch embedding with stride = kernel = patch,
  plus a learned (tokens, D) position embedding;
- NaFlex: uint8 patch rows (B, L, P*P*C) → x/127.5 - 1, a Linear patch
  embedding, plus the (S, S, D) position grid resized to each image's
  (h, w) patch grid by ``F.interpolate(mode="bilinear", antialias=True,
  align_corners=False)``; slots past h*w take the resized grid's first row;
  padded keys get an additive finfo(fp32).min in every layer and in the head;
- pre-LN encoder blocks (LayerNorm eps from the configuration, attention
  with scale head_dim^-0.5 and fp32 softmax, an MLP with tanh-approximated
  GELU), a final LayerNorm, and the MAP head: a learned probe attends over
  the tokens (one multi-head attention with a packed q/k/v projection), then
  LayerNorm and a residual MLP; the probe token is the pooled output;
- the pooled output L2-normalised (the embedding a library stores).

Departures from HF: none in the arithmetic. The batch runs in blocks so that
it fits beside the program, and every product goes through ``prec`` so that
the control (:class:`FP8`) can compute the same tower in a lower precision.
This file imports nothing of the program and nothing of JAX.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch
import torch.nn.functional as F


class FP32:
    """Products in fp32 (TF32 off: see :func:`exact_fp32`)."""

    name = "fp32"

    def rows(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return x

    def tensor(self, x: torch.Tensor) -> torch.Tensor:
        return x


class FP8:
    """The control: every product's operands rounded to fp8 e4m3 with a
    scale per row of the contraction (weights per output channel,
    activations per token; the most accurate common fp8 scheme), summed in
    fp32. The step below bf16 that a faster tower would take."""

    name = "fp8_e4m3"
    MAX = 448.0

    def rows(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
        scale = amax / self.MAX
        return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale

    def tensor(self, x: torch.Tensor) -> torch.Tensor:
        scale = x.abs().amax().clamp_min(1e-12) / self.MAX
        return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


@contextlib.contextmanager
def exact_fp32():
    """fp32 matmuls and convolutions without TF32, restored afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def _mm(a: torch.Tensor, b: torch.Tensor, prec) -> torch.Tensor:
    """a @ b, contraction over a's last and b's second-to-last dim."""
    return torch.matmul(prec.rows(a, -1), prec.rows(b, -2))


def _linear(x, w: Dict[str, torch.Tensor], name: str, prec) -> torch.Tensor:
    return _mm(x, w[f"{name}.weight"].t(), prec) + w[f"{name}.bias"]


def _norm(x, w, name: str, eps: float) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], w[f"{name}.weight"], w[f"{name}.bias"], eps)


def _attention(q, k, v, heads: int, mask, prec) -> torch.Tensor:
    """(B, Sq, D) x (B, Sk, D) → (B, Sq, D): softmax(q kᵀ / sqrt(hd) + mask) v."""
    b, sq, d = q.shape
    hd = d // heads
    q = q.view(b, sq, heads, hd).transpose(1, 2)
    k = k.view(b, -1, heads, hd).transpose(1, 2)
    v = v.view(b, -1, heads, hd).transpose(1, 2)
    logits = _mm(q, k.transpose(-1, -2), prec) * (hd ** -0.5)
    if mask is not None:
        logits = logits + mask
    out = _mm(torch.softmax(logits, dim=-1), v, prec)
    return out.transpose(1, 2).reshape(b, sq, d)


def _encoder_layer(x, w, i: int, shape, mask, prec) -> torch.Tensor:
    p = f"encoder.layers.{i}"
    y = _norm(x, w, f"{p}.layer_norm1", shape.eps)
    q = _linear(y, w, f"{p}.self_attn.q_proj", prec)
    k = _linear(y, w, f"{p}.self_attn.k_proj", prec)
    v = _linear(y, w, f"{p}.self_attn.v_proj", prec)
    x = x + _linear(_attention(q, k, v, shape.heads, mask, prec), w, f"{p}.self_attn.out_proj", prec)
    y = _norm(x, w, f"{p}.layer_norm2", shape.eps)
    y = F.gelu(_linear(y, w, f"{p}.mlp.fc1", prec), approximate="tanh")
    return x + _linear(y, w, f"{p}.mlp.fc2", prec)


def _map_head(x, w, shape, mask, prec) -> torch.Tensor:
    """SiglipMultiheadAttentionPoolingHead → the pooled (B, D)."""
    b, _, d = x.shape
    probe = w["head.probe"].expand(b, 1, d)
    wi, bi = w["head.attention.in_proj_weight"], w["head.attention.in_proj_bias"]
    q = _mm(probe, wi[:d].t(), prec) + bi[:d]
    k = _mm(x, wi[d : 2 * d].t(), prec) + bi[d : 2 * d]
    v = _mm(x, wi[2 * d :].t(), prec) + bi[2 * d :]
    h = _linear(_attention(q, k, v, shape.heads, mask, prec), w, "head.attention.out_proj", prec)
    y = _norm(h, w, "head.layernorm", shape.eps)
    y = F.gelu(_linear(y, w, "head.mlp.fc1", prec), approximate="tanh")
    return (h + _linear(y, w, "head.mlp.fc2", prec))[:, 0]


def _tower(x, w, shape, mask, prec) -> torch.Tensor:
    for i in range(shape.layers):
        x = _encoder_layer(x, w, i, shape, mask, prec)
    x = _norm(x, w, "post_layernorm", shape.eps)
    return F.normalize(_map_head(x, w, shape, mask, prec), dim=-1)


def embed_fixed(w, pixels: torch.Tensor, shape, prec=FP32()) -> torch.Tensor:
    """uint8 (B, S, S, C) → unit fp32 (B, D)."""
    x = pixels.to(torch.float32).permute(0, 3, 1, 2) / 127.5 - 1.0
    kernel = w["embeddings.patch_embedding.weight"]
    x = F.conv2d(prec.tensor(x), prec.rows(kernel.flatten(1), -1).view_as(kernel),
                 w["embeddings.patch_embedding.bias"], stride=shape.patch)
    x = x.flatten(2).transpose(1, 2) + w["embeddings.position_embedding.weight"]
    return _tower(x, w, shape, None, prec)


def resized_positions(w, grids: torch.Tensor, shape) -> torch.Tensor:
    """Siglip2VisionEmbeddings.resize_positional_embeddings: (B, L, D)."""
    s, length = shape.grid_side, shape.tokens
    grid = w["embeddings.position_embedding.weight"].reshape(s, s, -1).permute(2, 0, 1)[None]
    out = torch.empty(len(grids), length, grid.shape[1], device=grid.device, dtype=torch.float32)
    resized = {}
    for i, (h, wd) in enumerate(grids.tolist()):
        if (h, wd) not in resized:
            r = F.interpolate(grid, size=(h, wd), mode="bilinear", align_corners=False, antialias=True)
            resized[(h, wd)] = r.reshape(grid.shape[1], h * wd).t()
        r = resized[(h, wd)]
        out[i, : h * wd] = r
        out[i, h * wd :] = r[0]
    return out


def embed_naflex(w, patches: torch.Tensor, masks: torch.Tensor, grids: torch.Tensor, shape,
                 prec=FP32()) -> torch.Tensor:
    """uint8 patch rows (B, L, P*P*C), masks (B, L), grids (B, 2) → unit fp32 (B, D)."""
    x = _linear(patches.to(torch.float32) / 127.5 - 1.0, w, "embeddings.patch_embedding", prec)
    x = x + resized_positions(w, grids, shape)
    keep = masks.to(torch.float32)
    mask = ((1.0 - keep) * torch.finfo(torch.float32).min)[:, None, None, :]
    return _tower(x, w, shape, mask, prec)


def fp32_weights(w: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: t.to(torch.float32) for k, t in w.items()}


def reference_rows(w32, inputs: dict, rows, shape, prec=FP32(), block: int = 32) -> torch.Tensor:
    """The tower over ``rows`` of the benchmark's pool ``inputs`` (host
    arrays), in blocks of ``block`` images on the weights' device."""
    device = next(iter(w32.values())).device
    out = []
    with exact_fp32(), torch.no_grad():
        for s in range(0, len(rows), block):
            idx = rows[s : s + block]
            if shape.naflex:
                args = [torch.from_numpy(inputs[k][idx]).to(device) for k in ("patches", "masks", "grids")]
                out.append(embed_naflex(w32, *args, shape, prec))
            else:
                out.append(embed_fixed(w32, torch.from_numpy(inputs["pixels"][idx]).to(device), shape, prec))
    return torch.cat(out)
