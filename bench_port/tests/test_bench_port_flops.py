"""The operation count against a hand count for both configurations, the
resize taps against PyTorch's own filter, and the frozen NaFlex grid rule
against the program's over the traffic's aspect families."""

import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from conftest import ROOT

from bench_port import flops
from bench_port.shapes import naflex_grid, naflex_target_size, vision_shape

P224 = vision_shape(json.loads((ROOT / "bench_port/configs/siglip2-so400m-patch14-224.json").read_text()))
NAFLEX = vision_shape(json.loads((ROOT / "bench_port/configs/siglip2-so400m-patch16-naflex.json").read_text()))
FAMILIES = json.loads((ROOT / "bench_port/traffic/b256.json").read_text())["naflex_sources"]


def test_patch14_224_by_hand():
    d, f, n = 1152, 4304, 256
    patch = 2 * n * 588 * d
    layer = 2 * n * d * 3 * d + 2 * n * d * d + 2 * n * d * f * 2 + 2 * 2 * n * n * d
    head = 2 * d * d + 2 * 2 * n * d * d + 2 * 2 * n * d + 2 * d * d + 2 * 2 * d * f
    assert flops.image_flops(P224) == patch + 27 * layer + head
    assert abs(flops.image_flops(P224) / 1e9 - 220.35) < 0.01


@pytest.mark.parametrize("grid", [(16, 16), (14, 18), (9, 27)])
def test_naflex_by_hand(grid):
    d, f, s = 1152, 4304, 16
    n = grid[0] * grid[1]
    patch = 2 * n * 768 * d
    layer = 8 * n * d * d + 4 * n * d * f + 4 * n * n * d
    head = 4 * d * d + 4 * n * d * d + 4 * n * d + 4 * d * f
    resize = 2 * d * (s * flops._taps(s, grid[1]) + grid[1] * flops._taps(s, grid[0]))
    assert flops.image_flops(NAFLEX, grid) == patch + 27 * layer + head + resize
    assert resize < 1e-4 * flops.image_flops(NAFLEX, grid)


@pytest.mark.parametrize("dst", [1, 5, 9, 12, 14, 16, 18, 21, 27, 32])
def test_taps_are_the_filters_nonzeros(dst):
    """Nonzero weights of F.interpolate's antialiased bilinear resize of an
    identity (its weight matrix), on the CPU along one axis."""
    src = 16
    eye = torch.eye(src, dtype=torch.float64)[None, None]  # (1, 1, src, src)
    w = F.interpolate(eye, size=(src, dst), mode="bilinear", align_corners=False, antialias=True)[0, 0]
    assert flops._taps(src, dst) == int((w.abs() > 0).sum())


@pytest.mark.parametrize("family", FAMILIES, ids=[f["aspect"] for f in FAMILIES])
def test_frozen_grid_rule_is_the_programs(family):
    from tpuclip_torch.io.preprocess import naflex_target_size as programs

    h, w = family["height"], family["width"]
    for scale in (1.0, 0.5, 0.25, 0.1, 0.05):
        hh, ww = max(1, int(h * scale)), max(1, int(w * scale))
        assert naflex_target_size(hh, ww, 16, 256) == programs(hh, ww, 16, 256)
    gh, gw = naflex_grid(h, w, NAFLEX)
    assert gh * gw <= 256 and gh * gw >= 243
    assert abs(gw / gh - w / h) / (w / h) < 0.15


def test_grids_of_the_mix():
    grids = {f["aspect"]: naflex_grid(f["height"], f["width"], NAFLEX) for f in FAMILIES}
    assert grids == {"4:3": (14, 18), "3:4": (18, 14), "16:9": (12, 21), "9:16": (21, 12), "1:1": (16, 16),
                     "3:1": (9, 27)}
    share = sum(f["share"] * np.prod(grids[f["aspect"]]) for f in FAMILIES) / 256
    assert 0.97 < share < 0.99
