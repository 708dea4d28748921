"""DINOv2 with registers, an image-only embedder, in PyTorch.

DINOv2 (arXiv:2304.07193) with the register tokens of "Vision Transformers
Need Registers" (arXiv:2309.16588), in the form of HF's
``Dinov2WithRegistersModel``: ViT-g/14 at 518 x 518 is the standard public
image embedder for visual similarity and near-duplicate search. It has no
text tower, so a database indexed with it is searched by image.

The forward pass of one square uint8 NHWC image, at the configuration's
``image_size`` only (another size would need DINOv2's bicubic position
interpolation, which this tower does not do, so it raises):

- ``x = (u / 255 - mean_c) / std_c`` with ImageNet's mean and std, on the
  device, computed in fp32 and rounded once to the compute dtype;
- the patch embedding: (ph, pw, c) patch rows and one GEMM, SigLIP's
  (:meth:`tpuclip_torch.models.siglip.VisionTower.patch_embed`);
- ``x = cat(cls, patches) + pos`` (the published (1 + patches, D) table as
  it is), then ``cat(x[:, :1], registers, x[:, 1:])``: registers get no
  position embedding;
- each layer: ``x = x + γ1 ⊙ o(attn(LN1(x)))``, ``x = x + γ2 ⊙
  W_out(silu(a) ⊙ b)`` with ``[a | b] = W_in(LN2(x))``, the first and the
  second H columns (HF's ``chunk(2, -1)``);
- the output: ``LN_final(x)[:, 0]``, the class token (HF's
  ``pooler_output``), L2-normalised by :meth:`Dinov2Model.get_image_features`
  as SigLIP's features are.

Numerics are SigLIP's contract (``tpuclip_torch.models.siglip``): bf16
products with fp32 accumulation on the card, fp32 statistics. The residual
is carried as there: each branch's output stays pending, and the next
LayerNorm adds it with its LayerScale γ (:func:`~tpuclip_torch.models.
siglip.add_norm` with a scale: kernel 10 with its scale on the card). The
gate is one hand-written pass on the card (kernel 11,
:func:`tpuclip_torch.ops.swiglu.silu_mul`) inside the ``tower.mlp.gate``
span; the attention is SigLIP's (:func:`~tpuclip_torch.models.siglip.attend`,
kernel 9). The class token is picked before the final LayerNorm, which is
taken per token. Inference only: no remat, no training route.

Presets live in :data:`PRESETS` here, not in ``models/configs.py`` (a copy
of the JAX package's SigLIP registry). HF's parameter names map onto this
model in :func:`load_hf_state_dict`. DINOv3 (``models/dinov3.py``) runs this
module's layer, head (:func:`layers_and_head`), init and HF loader
(:func:`copy_hf_state`) with its own embedding and rotary positions.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from tpuclip_torch.models.siglip import Attention, LayerNorm, VisionTower, add_norm, dense
from tpuclip_torch.ops.swiglu import silu_mul, silu_mul_plain
from tpuclip_torch.utils.profiling import span

# The checkpoint's preprocessor_config.json (HF's ``BitImageProcessor``):
# ImageNet's channel statistics.
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclass(frozen=True)
class Dinov2VisionConfig:
    hidden_size: int
    num_layers: int
    num_heads: int
    mlp_ratio: int = 4
    image_size: int = 518
    patch_size: int = 14
    num_channels: int = 3
    num_register_tokens: int = 4
    layer_norm_eps: float = 1e-6
    layerscale_value: float = 1.0
    image_mean: Tuple[float, float, float] = IMAGENET_MEAN
    image_std: Tuple[float, float, float] = IMAGENET_STD
    naflex: bool = False  # the engine's input format: square uint8 pixels

    @property
    def intermediate_size(self) -> int:
        """SwiGLU's hidden width H (HF ``Dinov2WithRegistersSwiGLUFFN``):
        2/3 of ``hidden_size * mlp_ratio``, rounded up to a multiple of 8."""
        return (int(self.hidden_size * self.mlp_ratio * 2 / 3) + 7) // 8 * 8

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def num_tokens(self) -> int:
        """The sequence: the class token, the registers, the patches."""
        return 1 + self.num_register_tokens + self.num_patches

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclass(frozen=True)
class Dinov2Config:
    name: str
    vision: Dinov2VisionConfig
    text: None = None  # no text tower

    @property
    def embedding_dim(self) -> int:
        return self.vision.hidden_size


PRESETS: Dict[str, Dinov2Config] = {
    # HF facebook/dinov2-with-registers-giant config.json: ViT-g/14, 40
    # layers of width 1536, 24 heads of 64, SwiGLU (H 4096), 4 registers.
    "facebook/dinov2-with-registers-giant": Dinov2Config(
        name="facebook/dinov2-with-registers-giant",
        vision=Dinov2VisionConfig(hidden_size=1536, num_layers=40, num_heads=24),
    ),
    # CPU tests: the same structure, tiny (H 176, 4 x 4 patches + 1 + 2).
    "tpuclip/test-tiny-dinov2": Dinov2Config(
        name="tpuclip/test-tiny-dinov2",
        vision=Dinov2VisionConfig(hidden_size=64, num_layers=2, num_heads=4, image_size=56,
                                  num_register_tokens=2),
    ),
}


def get_config(name: str) -> Dinov2Config:
    if name not in PRESETS:
        raise KeyError(f"Unknown DINOv2 preset: {name!r}. Available: {sorted(PRESETS)}")
    return PRESETS[name]


# =============================================================================
# Blocks
# =============================================================================


def gate(h: torch.Tensor) -> torch.Tensor:
    """``silu(a) * b`` of the halves of ``h`` (..., 2H) → (..., H): kernel 11
    (:func:`~tpuclip_torch.ops.swiglu.silu_mul`) for bf16 on the card with
    no gradient, the plain version otherwise."""
    grad = torch.is_grad_enabled() and h.requires_grad
    if h.device.type != "cuda" or h.dtype != torch.bfloat16 or grad:
        return silu_mul_plain(h)
    return silu_mul(h)


class SwiGLU(nn.Module):
    """HF ``Dinov2WithRegistersSwiGLUFFN``: ``weights_out(silu(a) * b)``,
    ``[a | b] = weights_in(x)``."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.weights_in = nn.Linear(dim, 2 * hidden)
        self.weights_out = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("tower.mlp"):
            h = dense(x, self.weights_in)
            with span("tower.mlp.gate"):
                g = gate(h)
            return dense(g, self.weights_out)


class Dinov2Layer(nn.Module):
    """Pre-LN block with LayerScale on both branches
    (``Dinov2WithRegistersLayer``); the MLP's scaled add is left pending.
    ``key_bias`` False: a k projection without a bias (DINOv3's block)."""

    def __init__(self, cfg: Dinov2VisionConfig, key_bias: bool = True):
        super().__init__()
        d = cfg.hidden_size
        self.ln1 = LayerNorm(d, cfg.layer_norm_eps)
        self.attn = Attention(d, cfg.num_heads, key_bias=key_bias)
        self.gamma1 = nn.Parameter(torch.ones(d))
        self.ln2 = LayerNorm(d, cfg.layer_norm_eps)
        self.mlp = SwiGLU(d, cfg.intermediate_size)
        self.gamma2 = nn.Parameter(torch.ones(d))

    def forward(
        self, x: torch.Tensor, delta: Optional[torch.Tensor], scale: Optional[torch.Tensor],
        rope: Optional[Callable] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The stream ``x``, the previous layer's pending MLP output
        ``delta`` and its γ2 ``scale`` (both None for the first layer) → the
        stream after this layer's attention and its MLP output, still to be
        added with ``self.gamma2``. ``rope``: the attention's rotation of
        the projected q and k (:func:`~tpuclip_torch.models.siglip.attend`)."""
        x, h = add_norm(x, delta, self.ln1, scale)
        x, h = add_norm(x, self.attn(h, h, rope=rope), self.ln2, self.gamma1)
        return x, self.mlp(h)


def normalize_imagenet(pixels: torch.Tensor, cfg: Dinov2VisionConfig, dtype: torch.dtype) -> torch.Tensor:
    """uint8 NHWC → ``(u / 255 - mean_c) / std_c`` in fp32 as ``u * s_c +
    t_c``, rounded once to ``dtype``; float inputs pass through. The
    constants are filled on the device (no host copy), so the tower can be
    captured in a CUDA graph."""
    if pixels.dtype != torch.uint8:
        return pixels.to(dtype)
    dev = pixels.device

    def fill(values):
        return torch.stack([torch.full((), v, dtype=torch.float32, device=dev) for v in values])

    scale = fill([1.0 / (255.0 * s) for s in cfg.image_std])
    shift = fill([-m / s for m, s in zip(cfg.image_mean, cfg.image_std)])
    return torch.addcmul(shift, pixels.to(torch.float32), scale).to(dtype)


class Dinov2Tower(nn.Module):
    def __init__(self, cfg: Dinov2VisionConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.patch = nn.Linear(cfg.patch_size * cfg.patch_size * cfg.num_channels, d)
        self.cls_token = nn.Parameter(torch.zeros(1, d))
        self.register_tokens = nn.Parameter(torch.zeros(cfg.num_register_tokens, d))
        self.pos_embed = nn.Parameter(torch.zeros(1 + cfg.num_patches, d))
        self.layers = nn.ModuleList(Dinov2Layer(cfg) for _ in range(cfg.num_layers))
        self.final_ln = LayerNorm(d, cfg.layer_norm_eps)

    patch_embed = VisionTower.patch_embed  # (ph, pw, c) patch rows, one GEMM

    def forward(self, pixel_values: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """(B, S, S, C) uint8 or pre-normalised float, S the configured size
        → the class token's final (B, D)."""
        b, h, w, _ = pixel_values.shape
        s = self.cfg.image_size
        if (h, w) != (s, s):
            raise ValueError(f"this tower takes {s} x {s} images (no position interpolation), got {h} x {w}")
        with span("tower.patch"):
            p = self.patch_embed(normalize_imagenet(pixel_values, self.cfg, dtype))
            d = p.shape[-1]
            x = torch.cat([self.cls_token.to(dtype).expand(b, 1, d), p], dim=1) + self.pos_embed.to(dtype)
            x = torch.cat([x[:, :1], self.register_tokens.to(dtype).expand(b, -1, d), x[:, 1:]], dim=1)
        return layers_and_head(self, x)


def layers_and_head(tower: nn.Module, x: torch.Tensor, rope: Optional[Callable] = None) -> torch.Tensor:
    """The embedded sequence ``x`` (class token first) through ``tower``'s
    layers, each branch's γ-scaled output left pending into the next
    LayerNorm, then the class token's final add and LayerNorm (D,) per image."""
    delta = scale = None
    for layer in tower.layers:
        x, delta = layer(x, delta, scale, rope)
        scale = layer.gamma2
    with span("tower.head"):
        return add_norm(x[:, 0].contiguous(), delta[:, 0].contiguous(), tower.final_ln, scale)[1]


class Dinov2Model(nn.Module):
    """The image tower of a DINOv2-with-registers model: the engine's model
    object for a model without a text tower."""

    tower = Dinov2Tower

    def __init__(self, cfg: Dinov2Config):
        super().__init__()
        self.cfg = cfg
        self.vision = self.tower(cfg.vision)

    @property
    def dtype(self) -> torch.dtype:
        return self.vision.cls_token.dtype

    @torch.inference_mode()
    def get_image_features(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """L2-normalised fp32 image embeddings (B, D); divides by
        max(norm, 1e-12) like F.normalize, as SigLIP's do."""
        pooled = self.vision(pixel_values, self.dtype).float()
        norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
        return pooled / norm.clamp_min(1e-12)

    def image_features(self, *inputs: torch.Tensor) -> torch.Tensor:
        """The engine's vision entry: square uint8 pixels."""
        return self.get_image_features(*inputs)

    def get_text_features(self, *inputs: torch.Tensor) -> torch.Tensor:
        from tpuclip_torch.models.loader import no_text_tower  # the loader imports this module

        raise ValueError(no_text_tower(self.cfg.name))


@torch.no_grad()
def init_params_(model: Dinov2Model, generator: torch.Generator) -> Dinov2Model:
    """Random init (``TPUCLIP_INIT=random``): linear weights N(0, 1/fan_in),
    zero biases, unit LayerNorm scales, γ at ``layerscale_value``, the class
    and register tokens and the position table N(0, 0.02²). Draws come from
    ``generator`` on its device, in fp32, then land in each parameter's
    dtype."""
    device = generator.device

    def normal_(p: torch.Tensor, std: float) -> None:
        p.copy_(torch.randn(p.shape, generator=generator, device=device, dtype=torch.float32).mul_(std))

    for module in model.modules():
        if isinstance(module, nn.Linear):
            normal_(module.weight, 1.0 / math.sqrt(module.in_features))
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
        elif isinstance(module, Dinov2Layer):
            module.gamma1.fill_(model.cfg.vision.layerscale_value)
            module.gamma2.fill_(model.cfg.vision.layerscale_value)
    for name in ("cls_token", "register_tokens", "pos_embed"):  # DINOv3 has no position table
        if hasattr(model.vision, name):
            normal_(getattr(model.vision, name), 0.02)
    return model


def build_model(cfg: Dinov2Config, device: torch.device, dtype: torch.dtype,
                model_class: type = Dinov2Model) -> Dinov2Model:
    """Uninitialised ``model_class`` allocated directly on ``device`` in ``dtype``."""
    with torch.device("meta"):
        model = model_class(cfg)
    return model.to(dtype=dtype).to_empty(device=device).eval().requires_grad_(False)


# =============================================================================
# HF's parameter names
# =============================================================================

_LAYER_NAMES = {
    "ln1": "norm1", "ln2": "norm2",
    "attn.q": "attention.attention.query", "attn.k": "attention.attention.key",
    "attn.v": "attention.attention.value", "attn.o": "attention.output.dense",
    "mlp.weights_in": "mlp.weights_in", "mlp.weights_out": "mlp.weights_out",
}


def hf_names(cfg: Dinov2VisionConfig) -> Dict[str, str]:
    """{port parameter name (of ``model.vision``): HF
    ``Dinov2WithRegistersModel`` name} for every parameter of the tower."""
    names = {
        "patch.weight": "embeddings.patch_embeddings.projection.weight",
        "patch.bias": "embeddings.patch_embeddings.projection.bias",
        "cls_token": "embeddings.cls_token",
        "register_tokens": "embeddings.register_tokens",
        "pos_embed": "embeddings.position_embeddings",
        "final_ln.weight": "layernorm.weight",
        "final_ln.bias": "layernorm.bias",
    }
    for i in range(cfg.num_layers):
        for port, hf in _LAYER_NAMES.items():
            for kind in ("weight", "bias"):
                names[f"layers.{i}.{port}.{kind}"] = f"encoder.layer.{i}.{hf}.{kind}"
        names[f"layers.{i}.gamma1"] = f"encoder.layer.{i}.layer_scale1.lambda1"
        names[f"layers.{i}.gamma2"] = f"encoder.layer.{i}.layer_scale2.lambda1"
    return names


@torch.no_grad()
def load_hf_state_dict(model: Dinov2Model, state: Mapping[str, object]) -> Dinov2Model:
    """Copy a ``Dinov2WithRegistersModel`` state dict (tensors or numpy
    arrays, HF's names) into ``model``: the (D, C, P, P) Conv2d kernel
    becomes the (D, P*P*C) patch rows, HF's leading singleton axes go. Every
    parameter is written once; HF's ``mask_token`` (masked-image training)
    is not used; any other name, or a missing one, raises."""
    return copy_hf_state(model, hf_names(model.cfg.vision), state)


def copy_hf_state(model: nn.Module, names: Mapping[str, Union[str, Tuple[str, ...]]],
                  state: Mapping[str, object]) -> nn.Module:
    """Copy ``state`` into ``model.vision`` by ``names``, {port parameter:
    HF name, or HF names whose tensors are stacked along their first axis},
    as :func:`load_hf_state_dict` describes."""
    cfg = model.cfg.vision
    wanted = {hf for v in names.values() for hf in ((v,) if isinstance(v, str) else v)}
    unknown = sorted(set(state) - wanted - {"embeddings.mask_token"})
    missing = sorted(wanted - set(state))
    if unknown or missing:
        raise ValueError(f"not a {model.cfg.name} state dict: missing {missing[:5]}, unknown {unknown[:5]}")
    params = dict(model.vision.named_parameters())
    for port, hf in names.items():
        parts = [state[n] if isinstance(state[n], torch.Tensor) else torch.from_numpy(np.array(state[n]))
                 for n in ((hf,) if isinstance(hf, str) else hf)]
        t = parts[0] if len(parts) == 1 else torch.cat([p.to(parts[0].dtype) for p in parts])
        if t.numel() != params[port].numel():
            raise ValueError(f"{hf}: {tuple(t.shape)}, the model's {port} is {tuple(params[port].shape)}")
        if port == "patch.weight":  # (D, C, P, P) → (D, P*P*C) in (ph, pw, c) order
            t = t.permute(0, 2, 3, 1).reshape(cfg.hidden_size, -1)
        params[port].copy_(t.reshape(params[port].shape))
    return model
