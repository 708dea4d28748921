"""Packed sign-bit helpers (host numpy).

Copies of the numpy helpers in ``tpuclip/ops/hamming.py`` (that module
imports jax for its TPU kernels) that the duplicate filter needs;
``tests/test_torch_imports.py`` pins them to the originals. The binary
search kernels are still to be ported (ROADMAP Queue 2, kernels 5-7).
"""

from __future__ import annotations

import numpy as np


def pack_bits_to_words(bits01: np.ndarray) -> np.ndarray:
    """(N, D) uint8 {0,1} → (N, ceil(D/32)) uint32 words (np.packbits order,
    zero-padded). Queries and matrices must both come through here so the
    bit order cancels in AND+popcount."""
    packed = np.packbits(np.atleast_2d(bits01).astype(np.uint8), axis=-1)
    pad = (-packed.shape[-1]) % 4
    if pad:
        packed = np.pad(packed, ((0, 0), (0, pad)))
    return packed.view(np.uint32)


_POPCOUNT_TABLE = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(1)


def hamming_distance_packed(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Hamming distance between packed uint8 bit rows: a (..., W),
    b (..., W) → (...,) int32."""
    x = np.bitwise_xor(a, b)
    return _POPCOUNT_TABLE[x].sum(axis=-1).astype(np.int32)


def pack_bits(bits01: np.ndarray) -> np.ndarray:
    """(N, D) uint8 {0,1} → (N, D//8) packed uint8 (np.packbits bit order)."""
    return np.packbits(bits01.astype(np.uint8), axis=-1)


def sign_bits(embedding: np.ndarray) -> np.ndarray:
    """Reference sign quantization: (e >= 0)."""
    return (np.asarray(embedding) >= 0).astype(np.uint8)
