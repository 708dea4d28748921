"""Image preprocessing for the SigLIP towers.

HF's SiglipImageProcessor resizes to (size, size) with PIL bicubic, rescales
by 1/255 and normalizes with mean=std=0.5 — all on host, in serial Python,
per image (the reference's known bottleneck, SURVEY.md §3.1). TPU-native
split:

- Host does ONLY the uint8 bicubic resize (PIL's C resampler, bit-identical
  to HF since HF also resizes the uint8 image before any float math).
- The uint8 batch ships to the device (4x fewer transfer bytes than f32) and
  rescale+normalize fuse into the tower's first GEMM
  (tpuclip.models.siglip.normalize_pixels).

An optional native path (tpuclip.native) accelerates resize for very hot
scans; PIL remains the correctness reference.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
from PIL import Image

IMAGE_MEAN = 0.5
IMAGE_STD = 0.5


def resize_to_uint8(image: Image.Image, image_size: int) -> np.ndarray:
    """PIL bicubic resize to (S, S); returns uint8 (S, S, 3).

    Matches SiglipImageProcessor: resample=BICUBIC on the uint8 image.
    """
    if image.mode != "RGB":
        image = image.convert("RGB")
    if image.size != (image_size, image_size):
        image = image.resize((image_size, image_size), Image.Resampling.BICUBIC)
    return np.asarray(image, dtype=np.uint8)


def preprocess_batch(
    images: List[Optional[Image.Image]], image_size: int
) -> np.ndarray:
    """Stack decoded images into a uint8 (B, S, S, 3) batch; None slots are
    zero-filled (callers track validity separately)."""
    batch = np.zeros((len(images), image_size, image_size, 3), dtype=np.uint8)
    for i, img in enumerate(images):
        if img is not None:
            batch[i] = resize_to_uint8(img, image_size)
    return batch


def normalize_reference(batch_uint8: np.ndarray) -> np.ndarray:
    """Host-side float normalization — the exact HF arithmetic, used in tests
    to validate the fused on-device path."""
    x = batch_uint8.astype(np.float32) / 255.0
    return (x - IMAGE_MEAN) / IMAGE_STD


# =============================================================================
# NaFlex (SigLIP2 variable aspect/resolution) host-side patchify
# =============================================================================


def naflex_target_size(height: int, width: int, patch_size: int, max_num_patches: int) -> tuple:
    """Largest patch-aligned (th, tw) preserving aspect with
    (th/p)*(tw/p) <= max_num_patches — the exact binary search HF's
    Siglip2ImageProcessor runs (image_processing_siglip2.py)."""
    import math

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


def preprocess_naflex(
    image: Image.Image, patch_size: int, max_num_patches: int
) -> tuple:
    """PIL image -> (patches uint8 (L, p*p*3), pixel_mask (L,), (h, w)).

    Resize is PIL BILINEAR on uint8 (Siglip2ImageProcessor's resample);
    rescale/normalize happen on device (models/naflex.normalize_patches).
    Padding patches are zero; L = max_num_patches.
    """
    if image.mode != "RGB":
        image = image.convert("RGB")
    th, tw = naflex_target_size(image.height, image.width, patch_size, max_num_patches)
    resized = image.resize((tw, th), Image.Resampling.BILINEAR)
    arr = np.asarray(resized, dtype=np.uint8)
    h, w = th // patch_size, tw // patch_size
    patches = (
        arr.reshape(h, patch_size, w, patch_size, 3)
        .transpose(0, 2, 1, 3, 4)
        .reshape(h * w, patch_size * patch_size * 3)
    )
    out = np.zeros((max_num_patches, patch_size * patch_size * 3), np.uint8)
    out[: h * w] = patches
    mask = np.zeros((max_num_patches,), np.int32)
    mask[: h * w] = 1
    return out, mask, (h, w)
