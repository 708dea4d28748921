"""Operations of the SigLIP vision tower, counted from its published widths.

Counted: every matrix product (2 operations per multiply-add) over an
image's real tokens: the patch embedding, q/k/v and the output projection,
the MLP, q kᵀ and the weights times v at the real length, the MAP head (its
probe, its keys and values over the real tokens, its output and MLP), and
for NaFlex the per-image resize of the position grid as a separable
antialiased bilinear filter (2·D per nonzero tap). Not counted: padding
tokens, LayerNorm, GELU, softmax, bias and residual adds, the
normalisation. A program that stops computing padding therefore does not
raise its share of the peak.
"""

from __future__ import annotations

from bench_port.shapes import VisionShape


def _taps(src: int, dst: int) -> int:
    """Nonzero weights of an antialiased bilinear resize of a length-``src``
    axis to ``dst`` (PIL's triangle filter, support max(src/dst, 1))."""
    scale = src / dst
    support = max(scale, 1.0)
    taps = 0
    for o in range(dst):
        center = (o + 0.5) * scale - 0.5
        taps += sum(1 for i in range(src) if 1.0 - abs(i - center) / support > 0.0)
    return taps


def encoder_flops(shape: VisionShape, n: int) -> int:
    """The encoder blocks over ``n`` real tokens."""
    d, f = shape.hidden, shape.mlp
    per_layer = 4 * 2 * n * d * d + 2 * 2 * n * d * f + 2 * 2 * n * n * d
    return shape.layers * per_layer


def head_flops(shape: VisionShape, n: int) -> int:
    """The MAP head: one probe query over ``n`` keys."""
    d, f = shape.hidden, shape.mlp
    return 2 * d * d + 2 * 2 * n * d * d + 2 * 2 * n * d + 2 * d * d + 2 * 2 * d * f


def position_resize_flops(shape: VisionShape, h: int, w: int) -> int:
    """NaFlex: the (S, S) grid to (h, w), rows first then columns."""
    s = shape.grid_side
    return 2 * shape.hidden * (s * _taps(s, w) + w * _taps(s, h))


def image_flops(shape: VisionShape, grid=None) -> int:
    """One image: fixed resolution, or NaFlex on its (h, w) patch grid."""
    if shape.naflex:
        h, w = grid
        n = h * w
        extra = position_resize_flops(shape, h, w)
    else:
        n, extra = shape.tokens, 0
    return 2 * n * shape.patch_dim * shape.hidden + extra + encoder_flops(shape, n) + head_flops(shape, n)

