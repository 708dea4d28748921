"""The DINOv2-with-registers tower's sizes, operations and kernel 11's bytes,
counted from the configuration file's published widths.

Operations (for ``index_mfu``): every matrix product (2 operations per
multiply-add) over an image's 1 + registers + patches real tokens: the patch
embedding (over the patches), q/k/v and the output projection, SwiGLU's
``weights_in`` (D → 2H) and ``weights_out`` (H → D), and q kᵀ and the
weights times v. Not counted: LayerNorm, the gate, LayerScale, biases, the
residual adds, the normalisation of the pixels. At DINOv2-g (D 1536, H 4096,
40 layers, 1,374 tokens) that is 3.578 TFLOP an image.

Bytes of kernel 11 (the gate, for ``tower.gate_roofline``): each layer reads
the (tokens, 2H) bf16 output of ``weights_in`` once and writes the (tokens,
H) product once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class Dinov2Shape:
    hidden: int
    mlp: int  # SwiGLU's hidden width H
    layers: int
    heads: int
    patch: int
    channels: int
    eps: float
    registers: int
    image_size: int
    image_mean: Tuple[float, ...]
    image_std: Tuple[float, ...]
    naflex: bool = False  # the driver's input format: square uint8 pixels

    @property
    def patches(self) -> int:
        return (self.image_size // self.patch) ** 2

    @property
    def tokens(self) -> int:
        """The sequence: the class token, the registers, the patches."""
        return 1 + self.registers + self.patches

    @property
    def patch_dim(self) -> int:
        return self.patch * self.patch * self.channels


def swiglu_hidden(hidden: int, mlp_ratio: int) -> int:
    """HF ``Dinov2WithRegistersSwiGLUFFN``'s hidden width."""
    return (int(hidden * mlp_ratio * 2 / 3) + 7) // 8 * 8


def dinov2_shape(config: dict) -> Dinov2Shape:
    """The tower's sizes from a configuration file (the published
    ``vision_config`` plus what ``assumed`` lists)."""
    v, assumed = config["vision_config"], config["assumed"]
    if not v["use_swiglu_ffn"]:
        raise ValueError("only the SwiGLU DINOv2 towers are counted here")
    return Dinov2Shape(
        hidden=v["hidden_size"], mlp=swiglu_hidden(v["hidden_size"], v["mlp_ratio"]),
        layers=v["num_hidden_layers"], heads=v["num_attention_heads"], patch=v["patch_size"],
        channels=assumed["num_channels"], eps=v["layer_norm_eps"], registers=v["num_register_tokens"],
        image_size=v["image_size"], image_mean=tuple(assumed["image_mean"]), image_std=tuple(assumed["image_std"]),
    )


def image_flops(shape: Dinov2Shape) -> int:
    """One image."""
    n, d, h = shape.tokens, shape.hidden, shape.mlp
    per_layer = 4 * 2 * n * d * d + 2 * 2 * n * n * d + 2 * n * d * 2 * h + 2 * n * h * d
    return 2 * shape.patches * shape.patch_dim * d + shape.layers * per_layer


def gate_bytes(shape: Dinov2Shape) -> int:
    """Kernel 11's bytes an image: per layer, (2H + H) bf16 values a token."""
    return shape.layers * shape.tokens * (2 * shape.mlp + shape.mlp) * 2
