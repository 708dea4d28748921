"""The plain reference against HF's ``SiglipVisionModel`` and
``Siglip2VisionModel`` (random weights, the benchmark's own, at tiny
widths), against the program in fp32, and the trace arithmetic on a
timeline made by hand."""

import json
import os

import numpy as np
import pytest
import torch

from conftest import TINY

from bench_port import trace, weights
from bench_port.reference import siglip_ref
from bench_port.shapes import vision_shape
from bench_port.spec import load_cell

SHAPES = {name: vision_shape(json.loads((TINY.root / f"{name}.json").read_text()))
          for name in ("tiny-224", "tiny-naflex")}
TINY_TRAFFIC = json.loads((TINY.traffic_dir / "t8.json").read_text())


def _inputs(shape, seed=3):
    pool, _ = load_cell("tiny.224", TINY).driver.make_pool(shape, TINY_TRAFFIC, seed)
    return pool


def _reference(shape, w32, pool, prec=siglip_ref.FP32()):
    rows = np.arange(len(next(iter(pool.values()))))
    return siglip_ref.reference_rows(w32, pool, rows, shape, prec).numpy()


def _hf(shape, w32, pool):
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_FLAX", "0")
    transformers = pytest.importorskip("transformers")
    common = dict(hidden_size=shape.hidden, intermediate_size=shape.mlp, num_hidden_layers=shape.layers,
                  num_attention_heads=shape.heads, patch_size=shape.patch, layer_norm_eps=shape.eps,
                  hidden_act="gelu_pytorch_tanh", attn_implementation="eager")
    if shape.naflex:
        model = transformers.Siglip2VisionModel(transformers.Siglip2VisionConfig(
            num_patches=shape.max_patches, **common))
    else:
        model = transformers.SiglipVisionModel(transformers.SiglipVisionConfig(
            image_size=shape.image_size, **common))
    state = {f"vision_model.{k}": v for k, v in w32.items()}
    missing, unexpected = model.load_state_dict(state, strict=False)
    assert not unexpected and all("position_ids" in k for k in missing)
    model.eval()
    with torch.no_grad():
        if shape.naflex:
            x = torch.from_numpy(pool["patches"]).float() / 127.5 - 1.0
            out = model(pixel_values=x, pixel_attention_mask=torch.from_numpy(pool["masks"]),
                        spatial_shapes=torch.from_numpy(pool["grids"]).long()).pooler_output
        else:
            x = torch.from_numpy(pool["pixels"]).float().permute(0, 3, 1, 2) / 127.5 - 1.0
            out = model(pixel_values=x).pooler_output
    return torch.nn.functional.normalize(out, dim=-1).numpy()


@pytest.mark.parametrize("name", list(SHAPES))
def test_reference_is_hf(name):
    shape = SHAPES[name]
    w32 = siglip_ref.fp32_weights(weights.make_vision_weights(shape, 11, "cpu"))
    pool = _inputs(shape)
    ours, theirs = _reference(shape, w32, pool), _hf(shape, w32, pool)
    assert np.abs(ours - theirs).max() < 2e-5


@pytest.mark.parametrize("name", list(SHAPES))
def test_the_program_in_fp32_is_the_reference(name):
    """The port's tower in fp32 with the benchmark's weights: both sides
    agree to fp32 rounding, so the gap in a run is the program's bf16."""
    from tpuclip_torch.models.configs import get_config
    from tpuclip_torch.models.siglip import build_model

    shape = SHAPES[name]
    config = json.loads((TINY.root / f"{name}.json").read_text())
    model = build_model(get_config(config["preset"]), torch.device("cpu"), torch.float32)
    w = weights.make_vision_weights(shape, 12, "cpu", torch.float32)
    weights.load_into_port(model, w, shape)
    pool = _inputs(shape, seed=4)
    if shape.naflex:
        out = model.get_image_features_naflex(*(torch.from_numpy(pool[k]) for k in ("patches", "masks", "grids")))
    else:
        out = model.get_image_features(torch.from_numpy(pool["pixels"]))
    ref = _reference(shape, siglip_ref.fp32_weights(w), pool)
    assert np.abs(out.numpy() - ref).max() < 2e-5


@pytest.mark.parametrize("name", list(SHAPES))
def test_weights_repeat_from_the_seed(name):
    shape = SHAPES[name]
    a = weights.make_vision_weights(shape, 2**40 + 3, "cpu")
    b = weights.make_vision_weights(shape, 2**40 + 3, "cpu")
    c = weights.make_vision_weights(shape, 5, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["head.probe"], c["head.probe"])
    assert all(t.dtype == torch.bfloat16 for t in a.values())
    ln = a["encoder.layers.0.layer_norm1.weight"].float()
    assert abs(ln.mean().item() - 1.0) < 0.05 and ln.std().item() > 0.01


def test_a_missing_or_misshapen_parameter_is_refused():
    from tpuclip_torch.models.configs import get_config
    from tpuclip_torch.models.siglip import build_model

    shape = SHAPES["tiny-224"]
    model = build_model(get_config("tpuclip/test-tiny"), torch.device("cpu"), torch.float32)
    w = weights.make_vision_weights(shape, 1, "cpu", torch.float32)
    del w["encoder.layers.1.mlp.fc2.bias"]
    with pytest.raises(KeyError):
        weights.load_into_port(model, w, shape)
    narrow = SHAPES["tiny-naflex"]
    with pytest.raises(ValueError):
        weights.load_into_port(model, weights.make_vision_weights(narrow, 1, "cpu", torch.float32), narrow)


def _timeline():
    # window [0, 100); two calls [0, 40) and [50, 100); kernels and one copy
    return trace.Timeline(
        window=(0, 100), calls=[(0, 40), (50, 100)],
        kernels=[(10, 30, "gemm"), (25, 35, "softmax"), (60, 90, "gemm")],
        copies=[(2, 8, "Memcpy HtoD"), (92, 95, "Memcpy DtoH")],
        host_ops=[(0, 9, "aten::to"), (9, 40, "aten::linear"), (50, 100, "aten::linear")])


def test_trace_arithmetic():
    t = _timeline()
    assert t.busy == [(2, 8), (10, 35), (60, 90), (92, 95)]
    assert trace.covered(t.busy, 0, 100) == 6 + 25 + 30 + 3
    assert trace.gaps(t.busy, 0, 40) == [(0, 2), (8, 10), (35, 40)]
    assert trace.device_ops(t)[0] == ["gemm", 50e-9]
    gaps = dict(trace.idle_gaps(t))
    assert gaps["call/aten::to"] == pytest.approx(3e-9)  # [0, 2) and [8, 9)
    assert gaps["between_calls/python"] == pytest.approx(10e-9)  # [40, 50)
    assert sum(gaps.values()) == pytest.approx((100 - 64) * 1e-9)


def test_metric_readers_on_a_timeline():
    from bench_port.run import TraceContext

    readers = load_cell("tiny.224", TINY).readers
    ctx = TraceContext(timeline=_timeline(), images=10, flops=5e3, peak_flops=1e14)
    # idle inside the calls: (40 - 31) + (50 - 33) ns over 2 calls
    assert readers["engine.host_gap_ms_per_call"](ctx) == pytest.approx(13e-6)
    assert readers["tower.device_ms_per_image"](ctx) == pytest.approx(55 / 10 / 1e6)
    assert readers["device_idle.index"](ctx) == pytest.approx(36.0)
    assert readers["index_mfu"](ctx) == pytest.approx(100 * 5e3 / (1e14 * 100e-9))
    empty = TraceContext(timeline=trace.Timeline((0, 10), [], [], [], []), images=0, flops=0, peak_flops=None)
    assert all(r(empty) is None for r in readers.values())
