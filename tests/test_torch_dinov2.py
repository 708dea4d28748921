"""DINOv2 with registers (``tpuclip_torch/models/dinov2.py``), the benchmark's
``embed.dinov2-g-518.b32`` configuration, and its kernels: the scale of
kernel 10 (``ops/layernorm.py``) and kernel 11 (``ops/swiglu.py``).

On the CPU: the preset against the configuration file; the port's tower at
the tiny preset (width 64, 2 layers, 4 heads of 16, 2 registers, patch 14,
56 px: 1 + 2 + 16 tokens) against the benchmark's plain fp32 reference
(``bench_port/reference/dinov2_ref.py``) and HF's
``Dinov2WithRegistersModel`` on the benchmark's seeded weights; a broken
variant of each mechanism against the same reference; the bf16 tower inside
a bound that the fp8 control exceeds; an HF state dict into the port; the
loader's routing; the plain versions of both kernels and their wrappers'
CUDA branches (tensors that report a CUDA device, a recorder in place of the
library); the engine, CLI and server with a model that has no text tower.
On a CUDA card (``cuda`` marker): both kernels against their plain versions
at the cell's sizes, and the giant tower through them against the plain
route.
"""

import base64
import io
import json
import sqlite3
import urllib.error
import urllib.request
from contextlib import nullcontext
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bench_port.drivers import embed, embed_dinov2
from bench_port.flops_dinov2 import Dinov2Shape, dinov2_shape, gate_bytes, image_flops
from bench_port.reference import dinov2_ref, siglip_ref
from tpuclip_torch.models import configs, dinov2, siglip
from tpuclip_torch.models.loader import load_model
from tpuclip_torch.ops import _build
from tpuclip_torch.ops import attention as aops
from tpuclip_torch.ops import layernorm as lops
from tpuclip_torch.ops import swiglu

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "bench_port/configs/dinov2-with-registers-giant.json").read_text())
LIMITS = json.loads((ROOT / "bench_port/limits/embed.dinov2-g-518.b32.json").read_text())
GIANT = "facebook/dinov2-with-registers-giant"
TINY = "tpuclip/test-tiny-dinov2"
EPS = 1e-6


def _tiny_shape() -> Dinov2Shape:
    v = dinov2.get_config(TINY).vision
    return Dinov2Shape(hidden=v.hidden_size, mlp=v.intermediate_size, layers=v.num_layers, heads=v.num_heads,
                       patch=v.patch_size, channels=v.num_channels, eps=v.layer_norm_eps,
                       registers=v.num_register_tokens, image_size=v.image_size, image_mean=v.image_mean,
                       image_std=v.image_std)


def _port(w, dtype):
    model = dinov2.build_model(dinov2.get_config(TINY), torch.device("cpu"), dtype)
    return dinov2.load_hf_state_dict(model, w)


def _pixels(n=4, seed=7, size=56):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8)


def _reference(w, pixels, prec=siglip_ref.FP32()):
    w32 = siglip_ref.fp32_weights(w)
    return dinov2_ref.reference_rows(w32, pixels, np.arange(len(pixels)), _tiny_shape(), prec).numpy()


def _dist(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b, axis=1).max())


# ------------------------------------------------------------------ config


def test_the_preset_is_the_configuration_file():
    """The giant preset has the file's widths (the benchmark checks the same
    at set-up), 1,374 tokens and 1.136 B parameters; neither preset is in
    SigLIP's registry, whose pin to the JAX package's stays."""
    shape, v = dinov2_shape(CONFIG), dinov2.get_config(GIANT).vision
    assert CONFIG["preset"] == GIANT and CONFIG["reduced"] == [] and CONFIG["compute_dtype"] == "bfloat16"
    assert (v.hidden_size, v.intermediate_size, v.num_layers, v.num_heads, v.patch_size, v.num_channels,
            v.layer_norm_eps, v.num_register_tokens, v.image_size, v.image_mean, v.image_std) == (
        shape.hidden, shape.mlp, shape.layers, shape.heads, shape.patch, shape.channels, shape.eps,
        shape.registers, shape.image_size, shape.image_mean, shape.image_std)
    assert (shape.hidden, shape.mlp, shape.layers, shape.heads, v.head_dim) == (1536, 4096, 40, 24, 64)
    assert v.num_tokens == shape.tokens == 1374 and shape.patches == 37 * 37
    model = dinov2.build_model(dinov2.get_config(GIANT), torch.device("meta"), torch.bfloat16)
    assert sum(p.numel() for p in model.parameters()) == 1_136_485_376
    assert tuple(model.vision.layers[0].mlp.weights_in.weight.shape) == (8192, 1536)
    assert not set(dinov2.PRESETS) & set(configs.PRESETS)


def test_the_operation_count_and_the_gate_bytes_by_hand():
    """1,374 tokens: the patch GEMM over 1,369 588-wide patch rows, 40 layers
    of q/k/v/o, the SwiGLU products (D → 2H, H → D) and the two attention
    products; the gate reads 2H and writes H bf16 values a token a layer."""
    d, h, n = 1536, 4096, 1374
    layer = 2 * n * d * 4 * d + 2 * n * d * 2 * h + 2 * n * h * d + 2 * 2 * n * n * d
    shape = dinov2_shape(CONFIG)
    assert image_flops(shape) == 2 * 1369 * 588 * d + 40 * layer
    assert abs(image_flops(shape) / 1e12 - 3.578) < 0.001
    assert abs(40 * 2 * 2 * n * n * d / image_flops(shape) - 0.130) < 0.001  # attention's products
    assert gate_bytes(shape) == 40 * n * 3 * h * 2 and abs(gate_bytes(shape) / 1e9 - 1.3507) < 1e-4


# ------------------------------------------------------------------ tower


def test_the_tower_in_fp32_is_the_reference():
    """Both sides compute in fp32 on the CPU from the same weights; they
    differ in the order of their sums (a stride-14 Conv2d against the port's
    reshape and GEMM, the normalisation as one multiply-add against a
    subtract and a divide, the final LayerNorm over one token against all),
    so 2e-5 on a unit row is some hundred fp32 roundings."""
    w = embed_dinov2.make_weights(_tiny_shape(), 2**31 + 41, "cpu", torch.float32)
    pixels = _pixels()
    got = _port(w, torch.float32).get_image_features(torch.from_numpy(pixels)).numpy()
    assert got.shape == (len(pixels), 64)
    assert _dist(got, _reference(w, pixels)) < 2e-5


def _hf_model():
    import os

    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_FLAX", "0")
    transformers = pytest.importorskip("transformers")
    v = dinov2.get_config(TINY).vision
    cfg = transformers.Dinov2WithRegistersConfig(
        hidden_size=v.hidden_size, num_hidden_layers=v.num_layers, num_attention_heads=v.num_heads,
        mlp_ratio=v.mlp_ratio, image_size=v.image_size, patch_size=v.patch_size,
        num_register_tokens=v.num_register_tokens, layer_norm_eps=v.layer_norm_eps, use_swiglu_ffn=True,
        layerscale_value=1.0, qkv_bias=True, attn_implementation="eager")
    return transformers.Dinov2WithRegistersModel(cfg).eval()


def test_the_tower_and_the_reference_in_fp32_are_hf():
    """The same weights in HF's ``Dinov2WithRegistersModel`` (eager
    attention), its ``pooler_output`` L2-normalised, on pixels normalised by
    the ImageNet mean and std; the tolerance as above."""
    hf = _hf_model()
    w = embed_dinov2.make_weights(_tiny_shape(), 2**31 + 43, "cpu", torch.float32)
    missing, unexpected = hf.load_state_dict(w, strict=False)
    assert not unexpected and missing == ["embeddings.mask_token"]
    pixels = _pixels(seed=8)
    mean, std = (torch.tensor(c).view(1, 3, 1, 1) for c in (dinov2.IMAGENET_MEAN, dinov2.IMAGENET_STD))
    with torch.no_grad():
        x = (torch.from_numpy(pixels).float().permute(0, 3, 1, 2) / 255.0 - mean) / std
        want = F.normalize(hf(pixel_values=x).pooler_output, dim=-1).numpy()
    assert _dist(_reference(w, pixels), want) < 2e-5
    assert _dist(_port(w, torch.float32).get_image_features(torch.from_numpy(pixels)).numpy(), want) < 2e-5


def test_an_hf_state_dict_loads_into_the_port():
    """HF's own model's state dict (its init, under its names) loads into
    the port, whose features are then HF's; a missing or an unknown name,
    or a wrong shape, raises."""
    hf = _hf_model()
    state = hf.state_dict()
    model = _port(state, torch.float32)
    pixels = _pixels(n=2, seed=10)
    mean, std = (torch.tensor(c).view(1, 3, 1, 1) for c in (dinov2.IMAGENET_MEAN, dinov2.IMAGENET_STD))
    with torch.no_grad():
        x = (torch.from_numpy(pixels).float().permute(0, 3, 1, 2) / 255.0 - mean) / std
        want = F.normalize(hf(pixel_values=x).pooler_output, dim=-1).numpy()
    assert _dist(model.get_image_features(torch.from_numpy(pixels)).numpy(), want) < 2e-5
    fresh = dinov2.build_model(dinov2.get_config(TINY), torch.device("cpu"), torch.float32)
    for broken in ({k: v for k, v in state.items() if k != "layernorm.bias"},
                   {**state, "encoder.layer.0.extra": state["layernorm.bias"]},
                   {**state, "embeddings.cls_token": torch.zeros(1, 1, 32)}):
        with pytest.raises(ValueError):
            dinov2.load_hf_state_dict(fresh, broken)


def _register_positions(self, pixel_values, dtype):
    """The tower with the registers given the class token's position."""
    b, d = pixel_values.shape[0], self.cfg.hidden_size
    p = self.patch_embed(dinov2.normalize_imagenet(pixel_values, self.cfg, dtype))
    regs = self.register_tokens.expand(b, -1, d) + self.pos_embed[:1]
    x = torch.cat([self.cls_token.expand(b, 1, d), p], dim=1) + self.pos_embed
    x = torch.cat([x[:, :1], regs, x[:, 1:]], dim=1)
    return _layers_and_head(self, x, 0)


def _pool_token(token):
    def forward(self, pixel_values, dtype):
        b, d = pixel_values.shape[0], self.cfg.hidden_size
        p = self.patch_embed(dinov2.normalize_imagenet(pixel_values, self.cfg, dtype))
        x = torch.cat([self.cls_token.expand(b, 1, d), p], dim=1) + self.pos_embed
        x = torch.cat([x[:, :1], self.register_tokens.expand(b, -1, d), x[:, 1:]], dim=1)
        return _layers_and_head(self, x, token)
    return forward


def _layers_and_head(tower, x, token):
    delta = scale = None
    for layer in tower.layers:
        x, delta = layer(x, delta, scale)
        scale = layer.gamma2
    return siglip.add_norm(x[:, token].contiguous(), delta[:, token].contiguous(), tower.final_ln, scale)[1]


def _drop_gamma(model, monkeypatch):
    for layer in model.vision.layers:
        layer.gamma1.data.fill_(1.0)
        layer.gamma2.data.fill_(1.0)


BROKEN = {
    "gamma_dropped": _drop_gamma,
    "registers_missing": lambda model, mp: mp.setattr(
        model.vision, "register_tokens", torch.nn.Parameter(model.vision.register_tokens[:0])),
    "registers_given_positions": lambda model, mp: mp.setattr(dinov2.Dinov2Tower, "forward", _register_positions),
    "pooled_a_register": lambda model, mp: mp.setattr(dinov2.Dinov2Tower, "forward", _pool_token(1)),
    "pooled_a_patch": lambda model, mp: mp.setattr(dinov2.Dinov2Tower, "forward", _pool_token(-1)),
    "gate_halves_swapped": lambda model, mp: mp.setattr(
        dinov2, "gate", lambda h: swiglu.silu_mul_plain(torch.cat(h.chunk(2, dim=-1)[::-1], dim=-1))),
    "siglip_normalisation": lambda model, mp: mp.setattr(
        dinov2, "normalize_imagenet", lambda px, cfg, dtype: siglip.normalize_pixels(px, dtype)),
}


@pytest.mark.parametrize("broken", list(BROKEN))
def test_each_mechanism_broken_fails_the_comparison(monkeypatch, broken):
    """The fp32 port with one mechanism broken against the reference: each
    lands at least 0.01 from it on a unit row, 500 times the fp32 tolerance
    above and twice the bf16 tower's distance below (0.0044 at this size),
    so the comparison that decides ``correct`` sees it. The faithful port,
    in the same test, passes."""
    w = embed_dinov2.make_weights(_tiny_shape(), 2**31 + 47, "cpu", torch.float32)
    pixels = _pixels(seed=11)
    want = _reference(w, pixels)
    model = _port(w, torch.float32)
    assert _dist(model.get_image_features(torch.from_numpy(pixels)).numpy(), want) < 2e-5
    BROKEN[broken](model, monkeypatch)
    got = model.get_image_features(torch.from_numpy(pixels)).numpy()
    assert _dist(got, want) > 0.01, broken


def test_the_bf16_tower_is_closer_to_the_reference_than_fp8():
    """The port in bf16 (the configuration's ``compute_dtype``) against the
    fp32 reference on the benchmark's bf16 weights, and the reference with
    every product's operands in fp8 e4m3 (the benchmark's control) against
    the same: the bound lies between, so a tower that computed a step below
    bf16 would fail it. Readings at this size: bf16 0.0044, fp8 0.0105."""
    shape = _tiny_shape()
    w = embed_dinov2.make_weights(shape, 2**31 + 53, "cpu", torch.bfloat16)
    pixels = _pixels(n=8, seed=12)
    want = _reference(w, pixels)
    got = _port(w, torch.bfloat16).get_image_features(torch.from_numpy(pixels)).numpy()
    fp8 = _reference(w, pixels, siglip_ref.FP8())
    bf16_dist, fp8_dist = _dist(got, want), _dist(fp8, want)
    assert bf16_dist < 0.007 < fp8_dist, (bf16_dist, fp8_dist)


@pytest.mark.parametrize("offset, correct", [(0.0, True), ("between", False), ("past_worst", False)])
def test_the_cells_check_holds_the_worst_and_the_median_row(offset, correct):
    """The driver's ``check`` at the tiny shape: rows equal to the fp32
    reference pass; every row moved by a distance between the median's
    limit and the worst row's fails on the median alone; one row moved past
    the worst row's limit fails on it alone."""
    shape = _tiny_shape()
    state = embed.State(shape=shape, traffic={}, batch=4, pool={"pixels": _pixels(n=8, seed=13)},
                        image_flops=np.zeros(8), engine=None, entry=None, seed=2**31 + 61,
                        device=torch.device("cpu"), dtype=torch.bfloat16)
    ref = embed_dinov2.reference(state)
    moved = ref.copy()
    if offset == "between":
        step = (LIMITS["median_row_dist"] + LIMITS["max_row_dist"]) / 2
        moved[:, 0] += step
    elif offset == "past_worst":
        moved[5, 0] += 1.5 * LIMITS["max_row_dist"]
    state.outputs = [(0, moved[:4]), (4, moved[4:])]
    ok, failed, numbers = embed_dinov2.check(state, LIMITS)
    assert ok is correct and set(numbers) == {"max_row_dist", "median_row_dist", "bad_rows"}
    assert (numbers["median_row_dist"]["value"] > LIMITS["median_row_dist"]) is (offset == "between")
    assert (numbers["max_row_dist"]["value"] > LIMITS["max_row_dist"]) is (offset == "past_worst")
    assert failed == (1 if offset == "past_worst" else 0)


@pytest.mark.parametrize("ms, peak_flops", [(12.0, 989e12), (None, 989e12), (12.0, None), (12.0, 1e15)])
def test_the_gate_readers_read_the_span_and_the_runs_card(monkeypatch, ms, peak_flops):
    """``tower.gate_ms_per_image`` is the span's owned time an image;
    ``tower.gate_roofline`` is the gate's bytes an image over that time as a
    share of the HBM rate of the card whose bf16 peak the run carries, and
    None without the span, without a card or for a card ``peaks.json`` lacks."""
    from bench_port.spec import PKG, _load_module

    readers = {n: _load_module(PKG / "metrics" / f"{n}.py", n.replace(".", "_"))
               for n in ("tower.gate_ms_per_image", "tower.gate_roofline")}
    spans = []
    for module in readers.values():
        monkeypatch.setattr(module, "owned_ms_per_image", lambda ctx, name: spans.append(name) or ms)
    ctx = SimpleNamespace(peak_flops=peak_flops, images=32)
    assert readers["tower.gate_ms_per_image"].read(ctx) == ms
    got = readers["tower.gate_roofline"].read(ctx)
    assert set(spans) == {"tower.mlp.gate"}
    if ms is None or peak_flops != 989e12:
        assert got is None
    else:
        assert got == pytest.approx(100.0 * gate_bytes(dinov2_shape(CONFIG)) / (ms / 1e3) / 3.35e12)


def test_the_tower_refuses_other_sizes():
    model = dinov2.init_params_(dinov2.build_model(dinov2.get_config(TINY), torch.device("cpu"), torch.float32),
                                torch.Generator().manual_seed(1))
    with pytest.raises(ValueError, match="56 x 56"):
        model.get_image_features(torch.from_numpy(_pixels(n=1, size=70)))
    with pytest.raises(ValueError, match="no text tower"):
        model.get_text_features(torch.zeros(1, 64, dtype=torch.int64))


def test_the_loader_routes_dinov2_names(tmp_path):
    """A DINOv2 preset builds the DINOv2 model at random, or refuses without
    ``allow_random``; an HF-layout directory (config.json and
    model.safetensors under HF's names) loads its weights."""
    cfg, model = load_model(TINY, str(tmp_path), device="cpu", allow_random=True)
    assert isinstance(model, dinov2.Dinov2Model) and cfg is dinov2.get_config(TINY) and cfg.text is None
    assert all(float(layer.gamma1.mean()) == 1.0 for layer in model.vision.layers)
    with pytest.raises(FileNotFoundError):
        load_model(TINY, str(tmp_path), device="cpu", allow_random=False)
    safetensors = pytest.importorskip("safetensors.torch")
    w = embed_dinov2.make_weights(_tiny_shape(), 2**31 + 59, "cpu", torch.float32)
    local = tmp_path / TINY.replace("/", "--")
    local.mkdir()
    (local / "config.json").write_text(json.dumps({"model_type": "dinov2_with_registers"}))
    safetensors.save_file({k: v.contiguous() for k, v in w.items()}, str(local / "model.safetensors"))
    _, loaded = load_model(TINY, str(tmp_path), device="cpu", allow_random=False)
    pixels = torch.from_numpy(_pixels(n=2, seed=13))
    assert torch.equal(loaded.get_image_features(pixels), _port(w, torch.float32).get_image_features(pixels))


def test_the_image_features_entry_is_the_square_tower():
    model = dinov2.init_params_(dinov2.build_model(dinov2.get_config(TINY), torch.device("cpu"), torch.float32),
                                torch.Generator().manual_seed(2))
    pixels = torch.from_numpy(_pixels(n=3, seed=14))
    got = model.image_features(pixels)
    assert got.dtype == torch.float32 and torch.equal(got, model.get_image_features(pixels))
    assert torch.allclose(torch.linalg.vector_norm(got, dim=-1), torch.ones(3), atol=1e-6)


# ------------------------------------------------------------------ kernel 11


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_silu_mul_plain_is_silu_of_the_first_half_times_the_second(dtype):
    """fp32: ``F.silu(a) * b`` bit for bit; bf16: the same in fp32 on the
    upcast halves, rounded once; the wrapper on CPU tensors is the plain
    version and launches nothing."""
    rng = np.random.default_rng(3)
    h = torch.from_numpy(rng.standard_normal((3, 5, 2 * 176), dtype=np.float32) * 3).to(dtype)
    a, b = h.float()[..., :176], h.float()[..., 176:]
    want = (F.silu(a) * b).to(dtype)
    before = swiglu.silu_mul.launches
    for fn in (swiglu.silu_mul_plain, swiglu.silu_mul):
        got = fn(h)
        assert got.dtype == dtype and got.shape == (3, 5, 176) and torch.equal(got, want), fn.__name__
    assert swiglu.silu_mul.launches == before


def test_silu_mul_plain_is_differentiable():
    h = torch.randn(4, 32, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(swiglu.silu_mul_plain, (h,))


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports ``cuda:0``: drives the CUDA branches on a
    machine without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _fake(x):
    return x.as_subclass(_FakeCuda)


@pytest.fixture()
def recorder(monkeypatch):
    """The wrappers' CUDA branches with a recorder in place of the library:
    returns the list of (entry, arguments) the kernels were called with."""
    calls = []

    def entry(name):
        return lambda *args: calls.append((name, args)) or 0

    real_empty = torch.empty
    monkeypatch.setattr(torch.cuda, "device", lambda dev: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(torch, "empty", lambda *a, device=None, **kw: real_empty(*a, **kw))
    monkeypatch.setattr(_build, "library", lambda: SimpleNamespace(**{n: entry(n) for n in _build.SIGNATURES}))
    return calls


def test_silu_mul_is_launched_with_the_tensor_as_it_is(recorder):
    """The input in place, a new (rows, H) output, the row count, H and the
    stream; one launch counted; fp32 on CUDA refused."""
    h = _fake(torch.randn(2, 3, 64).to(torch.bfloat16))
    before = swiglu.silu_mul.launches
    out = swiglu.silu_mul(h)
    assert swiglu.silu_mul.launches == before + 1 and len(recorder) == 1
    name, args = recorder[0]
    assert name == "tpuclip_silu_mul" and args == (h.data_ptr(), out.data_ptr(), 6, 32, 7)
    assert out.shape == (2, 3, 32) and out.is_contiguous()
    with pytest.raises(TypeError):
        swiglu.silu_mul(_fake(torch.randn(2, 64)))
    assert swiglu.silu_mul.launches == before + 1


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("bad", ["width_not_2h", "h_not_multiple_of_8", "not_contiguous", "needs_grad"])
def test_silu_mul_refuses_what_the_kernel_does_not_take(recorder, device, bad):
    h = torch.randn(4, 64, dtype=torch.bfloat16)
    x = {"width_not_2h": h[:, :63].contiguous(), "h_not_multiple_of_8": h[:, :24].contiguous(),
         "not_contiguous": torch.randn(64, 4, dtype=torch.bfloat16).t(),
         "needs_grad": h.float().requires_grad_(True)}[bad]
    if device == "cuda":
        x = _fake(x)
    with pytest.raises(ValueError):
        swiglu.silu_mul(x)
    assert not recorder


def test_gate_routes_on_what_the_input_shows(monkeypatch):
    """bf16 on CUDA with no gradient goes to the kernel's wrapper; the CPU,
    fp32 and anything autograd must differentiate to the plain version."""
    calls = []
    monkeypatch.setattr(dinov2, "silu_mul", lambda h: calls.append(h) or swiglu.silu_mul_plain(h))
    h = torch.randn(2, 32, dtype=torch.bfloat16)
    with torch.no_grad():
        dinov2.gate(_fake(h))
        dinov2.gate(h)
        dinov2.gate(_fake(h.float()))
    assert len(calls) == 1
    dinov2.gate(_fake(h.clone().requires_grad_(True)))
    assert len(calls) == 1


# ------------------------------------------------------------------ kernel 10's scale


def _rows(rng, shape, dtype):
    d = shape[-1]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))  # noqa: E731
    x = t(rng.standard_normal(shape, dtype=np.float32) * 3).to(dtype)
    delta = t(rng.standard_normal(shape, dtype=np.float32) * 4).to(dtype)
    scale = t(0.1 + 0.03 * rng.standard_normal(d, dtype=np.float32)).to(dtype)
    w = t(1 + 0.1 * rng.standard_normal(d, dtype=np.float32))
    b = t(0.1 * rng.standard_normal(d, dtype=np.float32))
    return x, delta, scale, w, b


@pytest.mark.parametrize("d", [64, 1152, 1536])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scaled_plain_is_one_rounded_sum_then_layer_norm(dtype, d):
    """With a scale the plain version and the wrapper on CPU tensors return
    ``x + scale * delta`` computed in fp32 and rounded once to x's dtype,
    and ``F.layer_norm`` of it; without one, the unscaled add as before."""
    rng = np.random.default_rng(d)
    x, delta, scale, w, b = _rows(rng, (3, 7, d), dtype)
    s = (x.float() + scale.float() * delta.float()).to(dtype)
    want = F.layer_norm(s, (d,), w.to(dtype), b.to(dtype), EPS)
    for fn in (lops.add_layer_norm_plain, lops.add_layer_norm):
        x_out, y = fn(x, delta, w, b, EPS, scale)
        assert torch.equal(x_out, s) and torch.equal(y, want), fn.__name__
        x_out, y = fn(x, delta, w, b, EPS)
        assert torch.equal(x_out, x + delta), fn.__name__
    if dtype == torch.bfloat16:  # the one rounding differs from bf16 arithmetic's two
        assert not torch.equal(s, x + scale * delta)


def test_the_scaled_kernel_is_launched_with_the_tensors_as_they_are(recorder):
    """Kernel 10's one entry gets x, delta, the bf16 scale, weight and bias
    in place, new x_out and y, rows, D, eps and the stream; without a scale
    its pointer is null, as the unscaled callers pass it."""
    x, delta, scale, w, b = (_fake(t.to(torch.bfloat16)) for t in _rows(np.random.default_rng(6), (4, 6, 64),
                                                                      torch.bfloat16))
    before = lops.add_layer_norm.launches
    x_out, y = lops.add_layer_norm(x, delta, w, b, EPS, scale)
    lops.add_layer_norm(x, delta, w, b, EPS)
    assert lops.add_layer_norm.launches == before + 2
    (name, args), (other, unscaled) = recorder
    assert name == other == "tpuclip_add_layernorm"
    assert args[:5] == (x.data_ptr(), delta.data_ptr(), scale.data_ptr(), w.data_ptr(), b.data_ptr())
    assert args[5:] == (x_out.data_ptr(), y.data_ptr(), 24, 64, pytest.approx(EPS), 7)
    assert unscaled[:3] == (x.data_ptr(), delta.data_ptr(), 0)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_the_scale_is_refused_without_a_delta_or_at_another_width(recorder, device):
    x, delta, scale, w, b = _rows(np.random.default_rng(8), (2, 64), torch.bfloat16)
    if device == "cuda":
        x, delta, scale, w, b = (_fake(t) for t in (x, delta, scale, w, b))
    for args in ((x, None, w, b, EPS, scale), (x, delta, w, b, EPS, scale[:32])):
        with pytest.raises(ValueError):
            lops.add_layer_norm(*args)
    assert not recorder


def test_add_norm_passes_the_scale_and_routes_on_it(monkeypatch):
    """``add_norm`` with a scale hands it to the wrapper as its sixth
    argument on the kernel's route, and takes the plain route when the
    scale needs a gradient."""
    calls = []
    monkeypatch.setattr(siglip, "add_layer_norm", lambda *a: calls.append(a) or lops.add_layer_norm_plain(*a))
    x, delta, scale, _, _ = _rows(np.random.default_rng(9), (2, 5, 64), torch.bfloat16)
    ln = siglip.LayerNorm(64, EPS)
    with torch.no_grad():
        siglip.add_norm(_fake(x), _fake(delta), ln, _fake(scale))
    assert len(calls) == 1 and calls[0][5] is not None
    g = scale.clone().requires_grad_(True)
    siglip.add_norm(_fake(x), _fake(delta), ln, g)[1].float().sum().backward()
    assert len(calls) == 1 and g.grad is not None


# ------------------------------------------------------------------ engine, CLI, server


def _photo(seed):
    from PIL import Image

    return Image.fromarray(np.random.default_rng(seed).integers(0, 256, (80, 96, 3), dtype=np.uint8))


# The fused programs' conditions: int8 rows, the rerank copy resident, exact search.
ENV = {"TPUCLIP_SEARCH_PRECISION": "int8", "TPUCLIP_DEVICE_RERANK": "1", "TPUCLIP_SEARCH_MODE": "exact"}


@pytest.fixture()
def env(world, monkeypatch):
    monkeypatch.setenv("TPUCLIP_HOME", str(world[0] / "home"))
    for key, value in ENV.items():
        monkeypatch.setenv(key, value)
    monkeypatch.delenv("TPUCLIP_SHORTLIST", raising=False)
    return world


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A tiny-DINOv2 database of six seeded photos (and a copy of one),
    scanned on the CPU: (tmp, image root, engine)."""
    from tpuclip_torch.engine import ImageDatabase

    tmp = tmp_path_factory.mktemp("dinov2")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPUCLIP_HOME", str(tmp / "home"))
        mp.setenv("TPUCLIP_INIT", "random")
        for key, value in ENV.items():
            mp.setenv(key, value)
        mp.delenv("TPUCLIP_SHORTLIST", raising=False)
        root = tmp / "imgs"
        root.mkdir()
        for i in range(6):
            _photo(100 + i).save(root / f"img_{i}.png")
        (root / "copy_of_2.png").write_bytes((root / "img_2.png").read_bytes())
        engine = ImageDatabase(str(tmp / "one.db"), str(tmp / "models"), model_name=TINY,
                               inference_batch_size=4, device="cpu")
        engine.scan_directory(str(root), inference_batch_size=4)
        engine.index.refresh()
        yield tmp, root, engine


def test_the_engine_scans_and_searches_by_image(env):
    """No tokenizer; 64-d rows stored for every photo; a search by one of
    them returns it first, on the fused path and on embed-then-search, by
    path, by bytes (the copy hidden as a duplicate) and by PIL image."""
    tmp, root, engine = env
    assert engine.tokenizer is None and not engine.has_text_tower and engine.embedding_dim == 64
    conn = sqlite3.connect(engine.db_path)
    rows = conn.execute("SELECT i.file_path, e.vector FROM images i JOIN embeddings e ON e.image_id = i.id").fetchall()
    conn.close()
    assert len(rows) == 7 and all(len(np.frombuffer(v, np.float32)) == 64 for _, v in rows)
    query = str(root / "img_4.png")
    assert engine.search(query, k=3, is_image_path=True)[0][0] == query
    from PIL import Image

    with Image.open(query) as img:
        img = img.convert("RGB")
        assert engine.index.can_fuse_image_search(3, None)
        assert engine.search_image_pil(img, 3)[0][0] == query
        emb = engine.embed_pils([img])[0]
    assert engine.index.search(emb, 3)[0][0] == query
    found = engine.search_image_bytes((root / "img_2.png").read_bytes(), k=7)
    paths = [p for p, _ in found]
    assert len(paths) == 6 and paths[0] in (str(root / "img_2.png"), str(root / "copy_of_2.png"))


def test_text_entries_raise_the_named_error(env):
    *_, engine = env
    for call in (lambda: engine.search_texts(["a dog"], 3), lambda: engine.embed_texts(["a dog"]),
                 lambda: engine.embed_texts_cached(["a dog"]), lambda: engine.search("a dog", k=3),
                 lambda: engine._search_mixed_fused(["a dog"], [_photo(1)], 3)):
        with pytest.raises(ValueError, match=r"tpuclip/test-tiny-dinov2.*search by image"):
            call()


def test_the_cli_refuses_a_text_search(env, monkeypatch):
    tmp, root, engine = env
    from tpuclip_torch import cli

    said = []
    monkeypatch.setattr(cli, "log", lambda *a, **kw: said.append(" ".join(map(str, a))))
    with pytest.raises(SystemExit) as done:
        cli.main(["search", "a dog", "--db", engine.db_path, "--model", TINY, "--model-cache", str(tmp / "models"),
                  "--no-session", "--device", "cpu"])
    assert done.value.code == 2
    assert any("search by image" in line for line in said), said


def _post(srv, path, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{srv.port}{path}", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_the_server_serves_images_and_refuses_text(env):
    """``warm_programs`` warms the lone-image program and the batch shapes
    (4 calls); an upload search and a search by a local path find their
    image; a ``/search`` with any text part (the query, a second query or a
    negative) is a 400 that says to search by image."""
    from tpuclip_torch import serve

    tmp, root, engine = env
    assert serve.warm_programs(engine, k=3) == 4
    srv = serve.SearchServer(engine, host="127.0.0.1", port=0)
    srv.start_background()
    try:
        buf = io.BytesIO()
        _photo(103).save(buf, format="PNG")
        code, got = _post(srv, "/search", {"image_b64": base64.b64encode(buf.getvalue()).decode(), "k": 3})
        assert code == 200 and got["results"][0]["path"] == str(root / "img_3.png")
        by_path = f"image:{root / 'img_4.png'}"
        code, got = _post(srv, "/search", {"query": by_path, "k": 3})
        assert code == 200 and got["results"][0]["path"] == str(root / "img_4.png")
        for text in ({"query": "a dog"}, {"query": by_path, "query2": "a dog"},
                     {"query": by_path, "negative": "a dog"}):
            code, got = _post(srv, "/search", {**text, "k": 3})
            assert code == 400 and "search by image" in got["error"], text
    finally:
        srv.shutdown()


# ============================================================ on the card


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernels 10 and 11 have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _within_one_bf16_step(got, want):
    """Whether each value of ``got`` lies within one bf16 step (at
    ``want``'s magnitude) of ``want``, plus 1e-5 near zero; the largest
    difference, and the share bit-equal."""
    g, w = got.float(), want.float()
    _, exp = torch.frexp(w)
    step = torch.ldexp(torch.ones_like(w), exp - 8)
    err = (g - w).abs()
    return bool((err <= step + 1e-5).all()), err.max().item(), float((err == 0).float().mean())


@pytest.mark.cuda
def test_cuda_silu_mul_matches_plain(cuda_device):
    """One b32 call of the cell: M = 32 x 1,374 = 43,968 rows of 2 x 4,096;
    within one bf16 step of the plain version (the kernel's and PyTorch's
    fp32 exp and divide may differ in the last fp32 place)."""
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    h = (torch.randn((43_968, 8192), generator=gen, device=cuda_device) * 3).to(torch.bfloat16)
    before = swiglu.silu_mul.launches
    got = swiglu.silu_mul(h)
    torch.cuda.synchronize()
    assert swiglu.silu_mul.launches == before + 1 and got.shape == (43_968, 4096) and got.is_contiguous()
    ok, worst, equal = _within_one_bf16_step(got, swiglu.silu_mul_plain(h))
    print(f"[silu_mul] M 43968 H 4096: max diff {worst:.2e}, bit-equal {equal:.6f}")
    assert ok, worst


@pytest.mark.cuda
@pytest.mark.parametrize("scaled", [True, False])
def test_cuda_add_layernorm_at_width_1536(cuda_device, scaled):
    """The cell's 43,968 rows at D 1536: x_out bit-equal to the plain
    version (scaled: one fp32 multiply-add of bf16 values, exact product,
    then one rounding, on both sides), y within one bf16 step."""
    gen = torch.Generator(device=cuda_device).manual_seed(12 + scaled)
    rows, d = 43_968, 1536
    x = (torch.randn((rows, d), generator=gen, device=cuda_device) * 3).to(torch.bfloat16)
    delta = (torch.randn((rows, d), generator=gen, device=cuda_device) * 4).to(torch.bfloat16)
    scale = (0.1 + 0.03 * torch.randn(d, generator=gen, device=cuda_device)).to(torch.bfloat16) if scaled else None
    w = (1 + 0.1 * torch.randn(d, generator=gen, device=cuda_device)).to(torch.bfloat16)
    b = (0.1 * torch.randn(d, generator=gen, device=cuda_device)).to(torch.bfloat16)
    x_out, y = lops.add_layer_norm(x, delta, w, b, EPS, scale)
    want_x, want_y = lops.add_layer_norm_plain(x, delta, w, b, EPS, scale)
    torch.cuda.synchronize()
    assert torch.equal(x_out, want_x)
    ok, worst, equal = _within_one_bf16_step(y, want_y)
    print(f"[add_layernorm] D 1536 scaled {scaled}: y max diff {worst:.2e}, bit-equal {equal:.6f}")
    assert ok, worst


@pytest.mark.cuda
def test_cuda_one_giant_layer_through_the_kernels_is_the_plain_route(cuda_device, monkeypatch):
    """One layer at the cell's full size (4 images of 1,374 tokens, width
    1536, 24 heads of 64, H 4096), γ ~ N(0.1, 0.03²) on both branches and a
    scaled pending input: 2 kernel-10 launches (both scaled) and 1 of kernel
    11. Its outputs, the stream and the pending MLP output, lie within one
    bf16 step (2^-7 of each row's norm, bf16's widest relative step) of the
    plain route's: kernel 10's sums are bit-equal and its LayerNorm differs
    from F.layer_norm by the order of the row's sums (a bf16 step in about
    one value in 50,000), kernel 11 is bit-equal, and one layer's GEMMs and
    roundings carry those steps on (readings on the H100: stream 4.5e-4,
    MLP output 3.6e-3). A step below bf16 (fp8 e4m3) is 2^-3."""
    cfg = dinov2.get_config(GIANT).vision
    gen = torch.Generator(device=cuda_device).manual_seed(21)
    layer = dinov2.Dinov2Layer(cfg).to(cuda_device)
    with torch.no_grad():
        for name, p in layer.named_parameters():
            r = torch.randn(p.shape, generator=gen, device=cuda_device)
            if "gamma" in name:
                p.copy_(0.1 + 0.03 * r)
            elif name.startswith("ln"):
                p.copy_(r * 0.05 + (1.0 if name.endswith("weight") else 0.0))
            else:
                p.copy_(r / p.shape[1] ** 0.5 if p.dim() == 2 else 0.05 * r)
    layer.to(torch.bfloat16)
    shape = (4, cfg.num_tokens, cfg.hidden_size)
    x = (torch.randn(shape, generator=gen, device=cuda_device) * 2).to(torch.bfloat16)
    delta = torch.randn(shape, generator=gen, device=cuda_device).to(torch.bfloat16)
    scale = (0.1 + 0.03 * torch.randn(cfg.hidden_size, generator=gen, device=cuda_device)).to(torch.bfloat16)
    with torch.no_grad():
        ln0, gate0 = lops.add_layer_norm.launches, swiglu.silu_mul.launches
        got = layer(x, delta, scale)
        torch.cuda.synchronize()
        assert (lops.add_layer_norm.launches - ln0, swiglu.silu_mul.launches - gate0) == (2, 1)
        monkeypatch.setattr(siglip, "add_layer_norm", lops.add_layer_norm_plain)
        monkeypatch.setattr(dinov2, "silu_mul", swiglu.silu_mul_plain)
        want = layer(x, delta, scale)
    for what, g, w in zip(("stream", "mlp output"), got, want):
        rel = float((torch.linalg.vector_norm((g.float() - w.float()), dim=-1)
                     / torch.linalg.vector_norm(w.float(), dim=-1)).max())
        print(f"[dinov2] one giant layer, {what}: kernels against the plain route, worst row {rel:.2e} of its norm")
        assert rel <= 2**-7, (what, rel)


@pytest.mark.cuda
def test_cuda_giant_tower_through_the_kernels_is_inside_the_cells_limits_and_fp8_is_not(cuda_device, monkeypatch):
    """The bf16 giant tower (40 layers) on the cell's seeded weights (γ ~
    N(0.1, 0.03²)) and 4 of its 518² images: 81 kernel-10 launches a call
    (the first LN1 alone, 80 scaled), 40 of kernel 11 and 40 of kernel 9,
    all on its Hopper design (head width 64), unit-norm rows.
    Through the kernels and through the plain versions, each image's row
    lies inside the cell's limits of the fp32 reference (the worst row's and
    the median's, ``bench_port/limits``), and the fp8 control on the same
    images lies outside both. The two bf16 routes are not held to each
    other here: each sits about 0.017 from fp32 in a direction of its own
    (LayerNorm's sums in another order, carried through 40 layers), so they
    differ from each other by about as much (0.035 read on the card); the
    one-layer test above holds the kernels to the plain route."""
    shape = dinov2_shape(CONFIG)
    w = embed_dinov2.make_weights(shape, 2**31 + 77, cuda_device, torch.bfloat16)
    model = dinov2.load_hf_state_dict(dinov2.build_model(dinov2.get_config(GIANT), cuda_device, torch.bfloat16), w)
    pixels = _pixels(n=4, seed=15, size=518)
    ln0, gate0 = lops.add_layer_norm.launches, swiglu.silu_mul.launches
    attn0, sm90_0 = aops.attention.launches, aops.attention_sm90.launches
    with torch.no_grad():
        got = model.get_image_features(torch.from_numpy(pixels).to(cuda_device))
        torch.cuda.synchronize()
        assert (lops.add_layer_norm.launches - ln0, swiglu.silu_mul.launches - gate0) == (81, 40)
        assert (aops.attention.launches - attn0, aops.attention_sm90.launches - sm90_0) == (40, 40)
        assert torch.allclose(torch.linalg.vector_norm(got, dim=-1), torch.ones(4, device=cuda_device), atol=1e-5)
        monkeypatch.setattr(siglip, "add_layer_norm", lops.add_layer_norm_plain)
        monkeypatch.setattr(dinov2, "silu_mul", swiglu.silu_mul_plain)
        plain = model.get_image_features(torch.from_numpy(pixels).to(cuda_device))
    del model
    w32 = siglip_ref.fp32_weights(w)
    exact, control = (dinov2_ref.reference_rows(w32, pixels, np.arange(4), shape, prec).cpu().numpy()
                      for prec in (siglip_ref.FP32(), siglip_ref.FP8()))
    rows = {name: np.linalg.norm(r.astype(np.float64) - exact, axis=1)
            for name, r in (("kernels", got.float().cpu().numpy()), ("plain", plain.float().cpu().numpy()),
                            ("fp8", control))}
    print("[dinov2] giant tower, rows' distances to fp32: "
          + "; ".join(f"{k} {np.round(v, 4).tolist()}" for k, v in rows.items()))
    for name in ("kernels", "plain"):
        assert rows[name].max() <= LIMITS["max_row_dist"] and np.median(rows[name]) <= LIMITS["median_row_dist"], name
    assert rows["fp8"].min() > LIMITS["max_row_dist"] and np.median(rows["fp8"]) > LIMITS["median_row_dist"]
