"""The vision tower's sizes as a configuration file states them, and the
NaFlex grid rule.

``naflex_target_size`` is a frozen copy of the program's
``tpuclip_torch/io/preprocess.py`` rule (the binary search of HF's
``Siglip2ImageProcessor``), kept here so that a change to the program cannot
change the yardstick's inputs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class VisionShape:
    hidden: int
    mlp: int
    layers: int
    heads: int
    patch: int
    channels: int
    eps: float
    naflex: bool
    image_size: int  # fixed resolution: the square side in pixels
    max_patches: int  # NaFlex: the padded sequence length

    @property
    def tokens(self) -> int:
        """Sequence length the tower runs at (padded, for NaFlex)."""
        return self.max_patches if self.naflex else (self.image_size // self.patch) ** 2

    @property
    def patch_dim(self) -> int:
        return self.patch * self.patch * self.channels

    @property
    def grid_side(self) -> int:
        """Side of the square position-embedding grid."""
        side = math.isqrt(self.tokens)
        if side * side != self.tokens:
            raise ValueError(f"{self.tokens} positions are not a square grid")
        return side


def vision_shape(config: dict) -> VisionShape:
    """The vision tower's sizes from a configuration file (the published
    ``vision_config`` plus the defaults listed under ``assumed``)."""
    v, assumed = config["vision_config"], config.get("assumed", {})
    naflex = "num_patches" in v
    return VisionShape(
        hidden=v["hidden_size"],
        mlp=v["intermediate_size"],
        layers=v["num_hidden_layers"],
        heads=v["num_attention_heads"],
        patch=v["patch_size"],
        channels=v.get("num_channels", assumed.get("num_channels", 3)),
        eps=v.get("layer_norm_eps", assumed.get("layer_norm_eps", 1e-6)),
        naflex=naflex,
        image_size=0 if naflex else v["image_size"],
        max_patches=v["num_patches"] if naflex else 0,
    )


def naflex_target_size(height: int, width: int, patch_size: int, max_num_patches: int) -> tuple:
    """Largest patch-aligned (th, tw) preserving aspect with
    (th/p)*(tw/p) <= max_num_patches (HF ``Siglip2ImageProcessor``)."""

    def scaled(scale: float, size: int) -> int:
        s = math.ceil(size * scale / patch_size) * patch_size
        return int(max(patch_size, s))

    eps = 1e-5
    lo, hi = eps / 10, 100.0
    while hi - lo >= eps:
        mid = (lo + hi) / 2
        th, tw = scaled(mid, height), scaled(mid, width)
        if (th / patch_size) * (tw / patch_size) <= max_num_patches:
            lo = mid
        else:
            hi = mid
    return scaled(lo, height), scaled(lo, width)


def naflex_grid(height: int, width: int, shape: VisionShape) -> tuple:
    """The (h, w) patch grid of a ``height`` x ``width`` photo."""
    th, tw = naflex_target_size(height, width, shape.patch, shape.max_patches)
    return th // shape.patch, tw // shape.patch
