"""The DINOv3 ViT tower's sizes, operations and kernel 12's bytes, counted
from the configuration file's published widths.

Operations (for ``index_mfu``): every matrix product (2 operations per
multiply-add) over an image's 1 + registers + patches tokens: the patch
embedding (over the patches), q/k/v and the output projection, the SwiGLU's
``gate_proj`` and ``up_proj`` (D → H each) and ``down_proj`` (H → D), and
q kᵀ and the weights times v. Not counted: LayerNorm, the rotation, the
gate, LayerScale, biases, the residual adds, the normalisation of the
pixels. At DINOv3-7B (D 4096, H 8192, 40 layers) and 512 px (1,029 tokens)
that is 14.51 TFLOP an image, attention's products 4.8% of it.

Bytes of kernel 12 (the rotation, for ``tower.rope_roofline``): each layer
reads and writes the patch rows of q and of k once, bf16. The (P, hd / 2)
fp32 cos and sin tables (512 KB at 512 px), read by every image and head of
a launch from L2, are not counted: 0.1% of the rows' bytes at batch 16.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class Dinov3Shape:
    hidden: int
    mlp: int  # SwiGLU's hidden width H
    layers: int
    heads: int
    patch: int
    channels: int
    eps: float
    registers: int
    rope_theta: float
    image_size: int  # the side the cell serves
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

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads


def dinov3_shape(config: dict) -> Dinov3Shape:
    """The tower's sizes from a configuration file (the published
    ``vision_config`` plus what ``assumed`` lists)."""
    v, assumed = config["vision_config"], config["assumed"]
    if not v["use_gated_mlp"] or v["hidden_act"] != "silu":
        raise ValueError("only the SwiGLU DINOv3 towers are counted here")
    return Dinov3Shape(
        hidden=v["hidden_size"], mlp=v["intermediate_size"], layers=v["num_hidden_layers"],
        heads=v["num_attention_heads"], patch=v["patch_size"], channels=assumed["num_channels"],
        eps=v["layer_norm_eps"], registers=v["num_register_tokens"], rope_theta=v["rope_theta"],
        image_size=assumed["image_size"], image_mean=tuple(assumed["image_mean"]),
        image_std=tuple(assumed["image_std"]),
    )


def image_flops(shape: Dinov3Shape) -> int:
    """One image."""
    n, d, h = shape.tokens, shape.hidden, shape.mlp
    per_layer = 2 * n * (4 * d * d + 3 * d * h) + 2 * 2 * n * n * d
    return 2 * shape.patches * shape.patch_dim * d + shape.layers * per_layer


def rope_bytes(shape: Dinov3Shape) -> int:
    """Kernel 12's bytes an image: per layer, the patch rows of q and k,
    each read and written once, bf16."""
    return shape.layers * 2 * 2 * shape.patches * shape.hidden * 2
