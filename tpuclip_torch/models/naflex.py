"""SigLIP2 NaFlex vision tower in PyTorch: native aspect, variable resolution.

Port of ``tpuclip/models/naflex.py`` with the same functions and the same
static-shape contract. A batch is

  patches        (B, L, P*P*C)  uint8, L = max_num_patches, zero-padded
  pixel_mask     (B, L)         1 = real patch
  spatial_shapes (B, 2)         each image's (h, w) patch grid, h*w <= L

and the variable resolution lives entirely in the mask and in the *values*
of ``spatial_shapes``: one CUDA graph per batch size serves every aspect
ratio. Nothing here reads a value back to the host, loops over images or
indexes with a boolean mask, so the tower can be captured in a graph.

The tower reuses :class:`~tpuclip_torch.models.siglip.VisionTower`'s
parameters under their names: ``patch`` is a ``Linear(P*P*C -> D)`` over
the patch rows (tpuclip's ``patch_kernel``), ``pos_embed`` is
``(L, D)``, read as an S x S grid with S = sqrt(L).

Position embeddings: each image needs the grid resized to its (h, w) with
antialiased bilinear weights (HF: ``F.interpolate(mode="bilinear",
antialias=True, align_corners=False)``). As in tpuclip, the full S-tap
triangle-filter weights of every output slot are computed from the grid
shapes as tensors and contracted against the grid in fp32, as one
``(L, S*S) @ (S*S, D)`` matmul per image. TF32 must be off for that
contraction to be fp32 on the card.
"""

from __future__ import annotations

import torch

from tpuclip_torch.models.siglip import add_norm, dense, normalize_pixels
from tpuclip_torch.utils.profiling import span


def _axis_weights(src: int, dst: torch.Tensor, out_idx: torch.Tensor) -> torch.Tensor:
    """Antialiased bilinear weights for resizing a length-``src`` axis to
    length ``dst`` (a tensor, broadcastable against ``out_idx``), at the
    integer output positions ``out_idx``. Returns ``out_idx.shape + (src,)``,
    each row summing to 1.

    Matches ``F.interpolate(mode="bilinear", align_corners=False,
    antialias=True)`` / PIL: source center = (o + 0.5) * scale - 0.5 with a
    triangle kernel stretched by max(scale, 1)."""
    scale = src / dst.to(torch.float32)
    center = (out_idx.to(torch.float32) + 0.5) * scale - 0.5
    support = torch.clamp_min(scale, 1.0)
    i = torch.arange(src, dtype=torch.float32, device=out_idx.device)
    w = torch.clamp_min(1.0 - (i - center[..., None]).abs() / support[..., None], 0.0)
    return w / w.sum(dim=-1, keepdim=True)


def resize_position_embeddings(
    pos_grid: torch.Tensor, spatial_shapes: torch.Tensor, max_length: int
) -> torch.Tensor:
    """(S, S, D) grid → (B, max_length, D) fp32, resized to each image's
    (h, w). Slot p of image b holds the (p // w, p % w) cell of the resized
    grid; slots past h*w repeat slot 0 (HF ``Siglip2VisionEmbeddings``;
    those keys are masked anyway)."""
    s, d = pos_grid.shape[0], pos_grid.shape[-1]
    grid = pos_grid.to(torch.float32).reshape(s * s, d)
    shapes = spatial_shapes.to(torch.int64)
    h, w = shapes[:, 0:1], shapes[:, 1:2]  # (B, 1)
    p = torch.arange(max_length, device=shapes.device)
    p_eff = torch.where(p < h * w, p, 0)  # (B, L)
    rw = _axis_weights(s, h, p_eff // w)  # (B, L, S)
    cw = _axis_weights(s, w, p_eff % w)
    weights = (rw[..., :, None] * cw[..., None, :]).reshape(*p_eff.shape, s * s)
    return torch.matmul(weights, grid)


def normalize_patches(patches: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """uint8 patch pixels → x/127.5 - 1 in ``dtype``; float passes through
    (the contract of :func:`~tpuclip_torch.models.siglip.normalize_pixels`)."""
    return normalize_pixels(patches, dtype)


def vision_forward_naflex(
    tower,
    patches: torch.Tensor,
    pixel_mask: torch.Tensor,
    spatial_shapes: torch.Tensor,
    dtype: torch.dtype,
) -> torch.Tensor:
    """NaFlex vision tower → pooled features (B, D), before normalisation.

    HF ``Siglip2VisionTransformer``: linear patch embed plus the per-image
    resized position embeddings, the encoder and the MAP head attending
    only to real patches (an additive fp32 key mask, ``finfo(f32).min`` on
    padded slots: it overflows bf16)."""
    cfg = tower.cfg
    with span("tower.patch"):
        x = dense(normalize_patches(patches, dtype), tower.patch)
        s = int(round(cfg.max_num_patches ** 0.5))
        pos_grid = tower.pos_embed.view(s, s, -1)
        x = x + resize_position_embeddings(pos_grid, spatial_shapes, cfg.max_num_patches).to(x.dtype)
        keep = pixel_mask.to(torch.float32)
        mask4d = ((1.0 - keep) * torch.finfo(torch.float32).min)[:, None, None, :]
    x, delta = tower.encoder(x, mask4d)
    with span("tower.head"):
        return tower.head(add_norm(x, delta, tower.post_ln)[1], mask4d)


def get_image_features_naflex(
    model,
    patches: torch.Tensor,
    pixel_mask: torch.Tensor,
    spatial_shapes: torch.Tensor,
) -> torch.Tensor:
    """L2-normalised fp32 NaFlex image embeddings (B, D) of ``model`` (a
    :class:`~tpuclip_torch.models.siglip.SiglipModel`) in its dtype;
    divides by max(norm, 1e-12)."""
    pooled = vision_forward_naflex(model.vision, patches, pixel_mask, spatial_shapes, model.dtype).float()
    norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
    return pooled / norm.clamp_min(1e-12)
