"""SigLIP 2 SO400M at 384 px (``google/siglip2-so400m-patch14-384``), the
benchmark's ``embed.so400m-384.b64`` configuration, on the CPU.

The preset against the configuration file; the port's vision tower at the
configuration's structure (patch 14, a 27 x 27 = 729-token grid, heads of
72, the MAP head), shrunk to 2 heads, width 144 and 2 layers, against the
benchmark's plain fp32 reference (``bench_port/reference/siglip_ref.py``)
and HF's ``SiglipVisionModel`` on the benchmark's seeded weights; the bf16
tower against the same reference, inside a bound that the fp8 control
exceeds; and the benchmark's operation count against a hand count.

A 384-px image is not a whole number of 14-px patches: HF's stride-14
Conv2d covers its first 378 rows and columns and drops the last 6. Each
tower test runs at 384 and at 378, where the two agree.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_port import flops, weights
from bench_port.reference import siglip_ref
from bench_port.shapes import VisionShape, vision_shape
from tpuclip_torch.models.configs import SiglipConfig, TextConfig, VisionConfig, get_config
from tpuclip_torch.models.siglip import build_model

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "bench_port/configs/siglip2-so400m-patch14-384.json").read_text())
PRESET = "google/siglip2-so400m-patch14-384"
SIZES = [384, 378]


def _shape(image_size: int) -> VisionShape:
    return VisionShape(hidden=144, mlp=576, layers=2, heads=2, patch=14, channels=3, eps=1e-6, naflex=False,
                       image_size=image_size, max_patches=0)


def _port(shape: VisionShape, w, dtype):
    vision = VisionConfig(hidden_size=shape.hidden, intermediate_size=shape.mlp, num_layers=shape.layers,
                          num_heads=shape.heads, image_size=shape.image_size, patch_size=shape.patch)
    text = TextConfig(vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=1, num_heads=4,
                      projection_size=shape.hidden)
    model = build_model(SiglipConfig(name="test-so400m-384-narrow", vision=vision, text=text),
                        torch.device("cpu"), dtype)
    weights.load_into_port(model, w, shape)
    return model


def _pixels(shape: VisionShape, n: int = 3, seed: int = 7) -> np.ndarray:
    s = shape.image_size
    return np.random.default_rng(seed).integers(0, 256, (n, s, s, 3), dtype=np.uint8)


def _reference(shape, w, pixels, prec=siglip_ref.FP32()) -> np.ndarray:
    return siglip_ref.reference_rows(siglip_ref.fp32_weights(w), {"pixels": pixels}, np.arange(len(pixels)),
                                     shape, prec).numpy()


def test_the_preset_is_the_configuration_file():
    shape, cfg = vision_shape(CONFIG), get_config(PRESET)
    v, t, tc = cfg.vision, cfg.text, CONFIG["text_config"]
    assert CONFIG["preset"] == PRESET and CONFIG["reduced"] == []
    assert (v.hidden_size, v.intermediate_size, v.num_layers, v.num_heads, v.image_size, v.patch_size,
            v.num_channels, v.layer_norm_eps, v.naflex) == (
        shape.hidden, shape.mlp, shape.layers, shape.heads, shape.image_size, shape.patch, shape.channels,
        shape.eps, False) == (1152, 4304, 27, 16, 384, 14, 3, 1e-6, False)
    assert v.num_patches == shape.tokens == 729 and shape.grid_side == 27 and v.head_dim == 72
    assert (t.hidden_size, t.intermediate_size, t.num_layers, t.num_heads, t.vocab_size) == (
        tc["hidden_size"], tc["intermediate_size"], tc["num_hidden_layers"], tc["num_attention_heads"],
        tc["vocab_size"])
    model = build_model(cfg, torch.device("meta"), torch.bfloat16)
    assert tuple(model.vision.pos_embed.shape) == (729, 1152)


@pytest.mark.parametrize("image_size", SIZES)
def test_the_tower_in_fp32_is_the_reference(image_size):
    """Both sides compute in fp32 on the CPU; they differ only in the order
    of their sums (a stride-14 Conv2d against the port's reshape and GEMM,
    the head's packed q/k/v against three projections), so 2e-5 on a unit
    row is some hundred fp32 roundings."""
    shape = _shape(image_size)
    w = weights.make_vision_weights(shape, 2**31 + 19, "cpu", torch.float32)
    pixels = _pixels(shape)
    got = _port(shape, w, torch.float32).get_image_features(torch.from_numpy(pixels)).numpy()
    want = _reference(shape, w, pixels)
    assert got.shape == (len(pixels), shape.hidden)
    assert np.abs(got - want).max() < 2e-5


@pytest.mark.parametrize("image_size", SIZES)
def test_the_tower_in_fp32_is_hf(image_size):
    """The same weights in HF's ``SiglipVisionModel`` (eager attention),
    its pooled output L2-normalised; the tolerance as above."""
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_FLAX", "0")
    transformers = pytest.importorskip("transformers")
    shape = _shape(image_size)
    w = weights.make_vision_weights(shape, 2**31 + 23, "cpu", torch.float32)
    hf = transformers.SiglipVisionModel(transformers.SiglipVisionConfig(
        hidden_size=shape.hidden, intermediate_size=shape.mlp, num_hidden_layers=shape.layers,
        num_attention_heads=shape.heads, image_size=shape.image_size, patch_size=shape.patch,
        layer_norm_eps=shape.eps, hidden_act="gelu_pytorch_tanh", attn_implementation="eager"))
    missing, unexpected = hf.load_state_dict({f"vision_model.{k}": v for k, v in w.items()}, strict=False)
    assert not unexpected and all("position_ids" in k for k in missing)
    pixels = _pixels(shape, seed=8)
    with torch.no_grad():
        x = torch.from_numpy(pixels).float().permute(0, 3, 1, 2) / 127.5 - 1.0
        want = torch.nn.functional.normalize(hf.eval()(pixel_values=x).pooler_output, dim=-1).numpy()
    got = _port(shape, w, torch.float32).get_image_features(torch.from_numpy(pixels)).numpy()
    assert np.abs(got - want).max() < 2e-5


def test_the_bf16_tower_is_closer_to_the_reference_than_fp8():
    """The port in bf16 (the configuration's ``compute_dtype``) against the
    fp32 reference on the benchmark's bf16 weights, and the reference with
    every product's operands in fp8 e4m3 (the benchmark's control) against
    the same: the bound lies between, so a tower that computed a step below
    bf16 would fail it. Readings at this size over five seeds: bf16
    0.017-0.030, fp8 0.080-0.090."""
    shape = _shape(384)
    w = weights.make_vision_weights(shape, 2**31 + 29, "cpu", torch.bfloat16)
    pixels = _pixels(shape, n=8, seed=9)
    want = _reference(shape, w, pixels)
    got = _port(shape, w, torch.bfloat16).get_image_features(torch.from_numpy(pixels)).numpy()
    fp8 = _reference(shape, w, pixels, siglip_ref.FP8())
    bf16_dist = np.linalg.norm(got - want, axis=1).max()
    fp8_dist = np.linalg.norm(fp8 - want, axis=1).max()
    bound = 0.05
    assert bf16_dist < bound < fp8_dist, (bf16_dist, fp8_dist)


def test_the_operation_count_by_hand():
    """729 tokens: the patch GEMM over 588-wide patch rows, 27 layers of
    q/k/v/o, the MLP and the two attention products, the MAP head."""
    d, f, n = 1152, 4304, 729
    patch = 2 * n * 588 * d
    layer = 2 * n * d * 3 * d + 2 * n * d * d + 2 * n * d * f * 2 + 2 * 2 * n * n * d
    head = 2 * d * d + 2 * 2 * n * d * d + 2 * 2 * n * d + 2 * d * d + 2 * 2 * d * f
    shape = vision_shape(CONFIG)
    assert flops.image_flops(shape) == patch + 27 * layer + head
    assert abs(flops.image_flops(shape) / 1e9 - 670.35) < 0.01
    assert abs(27 * 2 * 2 * n * n * d / 1e9 - 66.12) < 0.01  # attention's products, 9.9% of the image
