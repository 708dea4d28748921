"""DINOv3, an image-only embedder with rotary positions, in PyTorch.

DINOv3 (arXiv:2508.10104), in the form of HF's ``DINOv3ViTModel``: ViT-7B/16
(``facebook/dinov3-vit7b16-pretrain-lvd1689m``), the successor to DINOv2 as
the public image embedder for visual similarity and instance retrieval. It
has no text tower, so a database indexed with it is searched by image.

The forward pass of uint8 NHWC images of any side that is a multiple of the
patch (the preset's ``image_size`` is the side the scan resizes to):

- ``x = (u / 255 - mean_c) / std_c`` with ImageNet's mean and std, and the
  patch embedding, as DINOv2's (:func:`~tpuclip_torch.models.dinov2.
  normalize_imagenet`, ``VisionTower.patch_embed``);
- ``x = cat(cls, registers, patches)``: no position table;
- each layer DINOv2's (:class:`~tpuclip_torch.models.dinov2.Dinov2Layer`:
  LayerScale on both branches, SwiGLU, kernels 10 and 11), with a k
  projection without a bias and, inside the attention after the
  projections, the 2-D rotary position on the patch rows of q and k
  (:func:`rotate`, kernel 12): per head, columns j and j + hd / 2 turned
  by the angles of the patch's centre;
- the output: ``LN_final(x)[:, 0]``, the class token (HF's
  ``pooler_output``), L2-normalised.

The rotation's table (:meth:`Dinov3Tower.rope_table`): patch centres
``c_h = (i + 0.5) / n_h``, ``c_w = (j + 0.5) / n_w`` in row-major order,
mapped to ``2c - 1``; ``inv_freq = 1 / theta ** arange(0, 1, 4 / hd)``
(hd / 4 frequencies); angles ``2π · c[:, axis] · inv_freq`` for the h axis
then the w axis, (P, hd / 2). HF tiles that to (P, hd) with equal halves;
the port keeps the half. Computed in fp32 on the host as HF computes it,
built once per grid and device and kept (HF's train-time shift, jitter and
rescale are off at inference).

Numerics are SigLIP's contract (``tpuclip_torch.models.siglip``): bf16
products with fp32 accumulation on the card, fp32 statistics. The rotation
is computed in fp32 from the bf16 q and k and rounded once; HF instead casts
cos and sin to the model's dtype and rotates in it, a departure of at most a
bf16 step an element. Inference only: no remat, no training route.

HF's parameter names map onto this model in :func:`load_hf_state_dict`;
HF's separate ``gate_proj`` and ``up_proj`` are the two halves of the port's
one ``weights_in``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Dict, Mapping, Tuple

import torch
from torch import nn

from tpuclip_torch.models import dinov2
from tpuclip_torch.models.dinov2 import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    Dinov2Config,
    Dinov2Layer,
    layers_and_head,
    normalize_imagenet,
)
from tpuclip_torch.models.siglip import LayerNorm, VisionTower
from tpuclip_torch.ops.rope import rope, rope_plain
from tpuclip_torch.utils.profiling import span


@dataclass(frozen=True)
class Dinov3VisionConfig:
    hidden_size: int
    num_layers: int
    num_heads: int
    intermediate_size: int  # SwiGLU's hidden width H
    image_size: int = 512  # the side the scan resizes to; any multiple of the patch runs
    patch_size: int = 16
    num_channels: int = 3
    num_register_tokens: int = 4
    layer_norm_eps: float = 1e-5
    layerscale_value: float = 1.0
    rope_theta: float = 100.0
    image_mean: Tuple[float, float, float] = IMAGENET_MEAN
    image_std: Tuple[float, float, float] = IMAGENET_STD
    naflex: bool = False  # the engine's input format: square uint8 pixels

    @property
    def num_prefix_tokens(self) -> int:
        """The class token and the registers, which are not rotated."""
        return 1 + self.num_register_tokens

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def num_tokens(self) -> int:
        return self.num_prefix_tokens + self.num_patches

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


PRESETS: Dict[str, Dinov2Config] = {
    # DINOv3 ViT-7B/16 (the paper's 7B teacher, HF's config.json): 40
    # layers of width 4096, 32 heads of 128, SwiGLU H 8192, 4 registers,
    # RoPE base 100; served at 512 px (32 x 32 patches, 1,029 tokens).
    "facebook/dinov3-vit7b16-pretrain-lvd1689m": Dinov2Config(
        name="facebook/dinov3-vit7b16-pretrain-lvd1689m",
        vision=Dinov3VisionConfig(hidden_size=4096, num_layers=40, num_heads=32, intermediate_size=8192),
    ),
    # CPU tests: the same structure, tiny (4 heads of 32, 4 x 4 patches + 1 + 2).
    "tpuclip/test-tiny-dinov3": Dinov2Config(
        name="tpuclip/test-tiny-dinov3",
        vision=Dinov3VisionConfig(hidden_size=128, num_layers=2, num_heads=4, intermediate_size=256,
                                  image_size=64, num_register_tokens=2),
    ),
}


def get_config(name: str) -> Dinov2Config:
    if name not in PRESETS:
        raise KeyError(f"Unknown DINOv3 preset: {name!r}. Available: {sorted(PRESETS)}")
    return PRESETS[name]


def rope_angles(cfg: Dinov3VisionConfig, n_h: int, n_w: int) -> torch.Tensor:
    """The (n_h * n_w, hd / 2) fp32 angles of an n_h x n_w patch grid, on
    the host, in the order of HF's ``DINOv3ViTRopePositionEmbedding``."""
    hd = cfg.head_dim
    inv_freq = 1 / cfg.rope_theta ** torch.arange(0, 1, 4 / hd, dtype=torch.float32)
    coords_h = torch.arange(0.5, n_h, dtype=torch.float32) / n_h
    coords_w = torch.arange(0.5, n_w, dtype=torch.float32) / n_w
    coords = torch.stack(torch.meshgrid(coords_h, coords_w, indexing="ij"), dim=-1).flatten(0, 1)
    coords = 2.0 * coords - 1.0
    return (2 * math.pi * coords[:, :, None] * inv_freq[None, None, :]).flatten(1, 2)


def rotate(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, heads: int,
           prefix: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """q and k with their patch rows rotated: kernel 12
    (:func:`~tpuclip_torch.ops.rope.rope`, in place) for bf16 on the card
    with no gradient, the plain version otherwise."""
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad)
    if q.device.type != "cuda" or q.dtype != torch.bfloat16 or grad:
        return rope_plain(q, k, cos, sin, heads, prefix)
    return rope(q, k, cos, sin, heads, prefix)


class Dinov3Tower(nn.Module):
    def __init__(self, cfg: Dinov3VisionConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.patch = nn.Linear(cfg.patch_size * cfg.patch_size * cfg.num_channels, d)
        self.cls_token = nn.Parameter(torch.zeros(1, d))
        self.register_tokens = nn.Parameter(torch.zeros(cfg.num_register_tokens, d))
        # q, v, the output projection and the MLP have biases; k has none
        self.layers = nn.ModuleList(Dinov2Layer(cfg, key_bias=False) for _ in range(cfg.num_layers))
        self.final_ln = LayerNorm(d, cfg.layer_norm_eps)
        self._tables: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    patch_embed = VisionTower.patch_embed  # (ph, pw, c) patch rows, one GEMM

    def rope_table(self, n_h: int, n_w: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(cos, sin), each (n_h * n_w, hd / 2) fp32 on ``device``, built on
        the first call for this grid and device and kept. The first call
        waits for the copy, so it is made before any CUDA graph capture (the
        eager run that precedes one)."""
        key = (n_h, n_w, str(device))
        if key not in self._tables:
            angles = rope_angles(self.cfg, n_h, n_w)
            table = tuple(t.to(device) for t in (torch.cos(angles), torch.sin(angles)))
            if table[0].device.type == "cuda":
                torch.cuda.synchronize(table[0].device)
            self._tables[key] = table
        return self._tables[key]

    def forward(self, pixel_values: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """(B, H, W, C) uint8 or pre-normalised float, H and W multiples of
        the patch → the class token's final (B, D)."""
        b, h, w, _ = pixel_values.shape
        ps = self.cfg.patch_size
        if h % ps or w % ps or not h or not w:
            raise ValueError(f"this tower takes sides that are multiples of {ps}, got {h} x {w}")
        with span("tower.patch"):
            p = self.patch_embed(normalize_imagenet(pixel_values, self.cfg, dtype))
            d = p.shape[-1]
            x = torch.cat([self.cls_token.to(dtype).expand(b, 1, d),
                           self.register_tokens.to(dtype).expand(b, -1, d), p], dim=1)
            cos, sin = self.rope_table(h // ps, w // ps, p.device)
        rotation = partial(rotate, cos=cos, sin=sin, heads=self.cfg.num_heads, prefix=self.cfg.num_prefix_tokens)
        return layers_and_head(self, x, rotation)


class Dinov3Model(dinov2.Dinov2Model):
    """The image tower of a DINOv3 ViT: the engine's model object for a
    model without a text tower (DINOv2's, with this tower)."""

    tower = Dinov3Tower


def build_model(cfg: Dinov2Config, device: torch.device, dtype: torch.dtype) -> Dinov3Model:
    """Uninitialised model allocated directly on ``device`` in ``dtype``."""
    return dinov2.build_model(cfg, device, dtype, model_class=Dinov3Model)


init_params_ = dinov2.init_params_  # random init (TPUCLIP_INIT=random): DINOv2's draws


# =============================================================================
# HF's parameter names
# =============================================================================

_LAYER_NAMES = {
    "ln1.weight": "norm1.weight", "ln1.bias": "norm1.bias",
    "ln2.weight": "norm2.weight", "ln2.bias": "norm2.bias",
    "attn.q.weight": "attention.q_proj.weight", "attn.q.bias": "attention.q_proj.bias",
    "attn.k.weight": "attention.k_proj.weight",
    "attn.v.weight": "attention.v_proj.weight", "attn.v.bias": "attention.v_proj.bias",
    "attn.o.weight": "attention.o_proj.weight", "attn.o.bias": "attention.o_proj.bias",
    "gamma1": "layer_scale1.lambda1", "gamma2": "layer_scale2.lambda1",
    "mlp.weights_in.weight": ("mlp.gate_proj.weight", "mlp.up_proj.weight"),
    "mlp.weights_in.bias": ("mlp.gate_proj.bias", "mlp.up_proj.bias"),
    "mlp.weights_out.weight": "mlp.down_proj.weight", "mlp.weights_out.bias": "mlp.down_proj.bias",
}


def hf_names(cfg: Dinov3VisionConfig) -> Dict[str, object]:
    """{port parameter name (of ``model.vision``): HF ``DINOv3ViTModel``
    name, or the (gate, up) pair stacked into ``weights_in``} for every
    parameter of the tower."""
    names: Dict[str, object] = {
        "patch.weight": "embeddings.patch_embeddings.weight",
        "patch.bias": "embeddings.patch_embeddings.bias",
        "cls_token": "embeddings.cls_token",
        "register_tokens": "embeddings.register_tokens",
        "final_ln.weight": "norm.weight",
        "final_ln.bias": "norm.bias",
    }
    for i in range(cfg.num_layers):
        for port, hf in _LAYER_NAMES.items():
            names[f"layers.{i}.{port}"] = (f"layer.{i}.{hf}" if isinstance(hf, str)
                                           else tuple(f"layer.{i}.{n}" for n in hf))
    return names


@torch.no_grad()
def load_hf_state_dict(model: Dinov3Model, state: Mapping[str, object]) -> Dinov3Model:
    """Copy a ``DINOv3ViTModel`` state dict (tensors or numpy arrays, HF's
    names) into ``model``: the (D, C, P, P) Conv2d kernel becomes the
    (D, P*P*C) patch rows, ``gate_proj`` and ``up_proj`` the first and second
    halves of ``weights_in``, HF's leading singleton axes go. Every
    parameter is written once; HF's ``mask_token`` (masked-image training)
    is not used; any other name, or a missing one, raises."""
    return dinov2.copy_hf_state(model, hf_names(model.cfg.vision), state)
