"""DINOv3 (``tpuclip_torch/models/dinov3.py``), the benchmark's
``embed.dinov3-7b-512.b16`` configuration, and the kernels at its widths:
kernel 12 (the rotation, ``ops/rope.py``), kernel 10's wide rows and kernel
11 at H 8192.

On the CPU: the preset against the configuration file; the operation count
and kernel 12's bytes by hand; the port's tower at the tiny preset (width
128, 2 layers, 4 heads of 32, 2 registers, patch 16) at two image sides
against the benchmark's plain fp32 reference
(``bench_port/reference/dinov3_ref.py``), and the reference against HF's
``DINOv3ViTModel``, on the benchmark's seeded weights; HF's state dict into
the port; a broken variant of each mechanism against the same reference;
the bf16 tower inside a bound that the fp8 control exceeds; the per-grid
table kept; the loader's routing; ``dense`` without a bias; the cell's check
and the rotation's readers; the engine and CLI with this image-only model.
On a CUDA card (``cuda`` marker): one 7B layer through the kernels against
the plain route, and the 7B tower through them inside the cell's limits,
with every launch counted.
"""

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bench_port.drivers import embed, embed_dinov3
from bench_port.flops_dinov3 import Dinov3Shape, dinov3_shape, image_flops, rope_bytes
from bench_port.reference import dinov3_ref, siglip_ref
from tpuclip_torch.models import configs, dinov2, dinov3, siglip
from tpuclip_torch.models.loader import load_model
from tpuclip_torch.ops import attention as aops
from tpuclip_torch.ops import layernorm as lops
from tpuclip_torch.ops import rope as rops
from tpuclip_torch.ops import swiglu

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "bench_port/configs/dinov3-vit7b16-pretrain-lvd1689m.json").read_text())
LIMITS = json.loads((ROOT / "bench_port/limits/embed.dinov3-7b-512.b16.json").read_text())
BIG = "facebook/dinov3-vit7b16-pretrain-lvd1689m"
TINY = "tpuclip/test-tiny-dinov3"


def _shape(side=None) -> Dinov3Shape:
    v = dinov3.get_config(TINY).vision
    return Dinov3Shape(hidden=v.hidden_size, mlp=v.intermediate_size, layers=v.num_layers, heads=v.num_heads,
                       patch=v.patch_size, channels=v.num_channels, eps=v.layer_norm_eps,
                       registers=v.num_register_tokens, rope_theta=v.rope_theta, image_size=side or v.image_size,
                       image_mean=v.image_mean, image_std=v.image_std)


def _port(w, dtype):
    model = dinov3.build_model(dinov3.get_config(TINY), torch.device("cpu"), dtype)
    return dinov3.load_hf_state_dict(model, w)


def _pixels(n=4, seed=7, size=64):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8)


def _reference(w, pixels, prec=siglip_ref.FP32()):
    w32 = siglip_ref.fp32_weights(w)
    return dinov3_ref.reference_rows(w32, pixels, np.arange(len(pixels)), _shape(pixels.shape[1]), prec).numpy()


def _dist(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b, axis=1).max())


# ------------------------------------------------------------------ config


def test_the_preset_is_the_configuration_file():
    """The 7B preset has the file's widths (the benchmark checks the same
    at set-up), 1,029 tokens at 512 px and 6.716 B parameters; no preset is
    in SigLIP's or DINOv2's registry."""
    shape, v = dinov3_shape(CONFIG), dinov3.get_config(BIG).vision
    assert CONFIG["preset"] == BIG and CONFIG["reduced"] == [] and CONFIG["compute_dtype"] == "bfloat16"
    assert (v.hidden_size, v.intermediate_size, v.num_layers, v.num_heads, v.patch_size, v.num_channels,
            v.layer_norm_eps, v.num_register_tokens, v.rope_theta, v.image_size, v.image_mean, v.image_std) == (
        shape.hidden, shape.mlp, shape.layers, shape.heads, shape.patch, shape.channels, shape.eps,
        shape.registers, shape.rope_theta, shape.image_size, shape.image_mean, shape.image_std)
    assert (shape.hidden, shape.mlp, shape.layers, shape.heads, v.head_dim) == (4096, 8192, 40, 32, 128)
    assert CONFIG["assumed"]["key_bias"] is False and CONFIG["assumed"]["query_bias"]
    assert v.num_tokens == shape.tokens == 1029 and shape.patches == 32 * 32
    model = dinov3.build_model(dinov3.get_config(BIG), torch.device("meta"), torch.bfloat16)
    assert abs(sum(p.numel() for p in model.parameters()) / 1e9 - 6.716) < 5e-4
    layer = model.vision.layers[0]
    assert layer.attn.k.bias is None and tuple(layer.mlp.weights_in.weight.shape) == (16384, 4096)
    assert not hasattr(model.vision, "pos_embed")
    assert not set(dinov3.PRESETS) & (set(configs.PRESETS) | set(dinov2.PRESETS))


def test_the_operation_count_and_the_rotations_bytes_by_hand():
    """1,029 tokens: the patch GEMM over 1,024 768-wide patch rows, 40
    layers of q/k/v/o, the SwiGLU's three products and the two attention
    products: 14.51 TFLOP an image, attention's products 4.8% of it; the
    rotation reads and writes the patch rows of q and k: 1.342 GB an image."""
    d, h, n = 4096, 8192, 1029
    layer = 2 * n * (4 * d * d + 3 * d * h) + 4 * n * n * d
    shape = dinov3_shape(CONFIG)
    assert image_flops(shape) == 2 * 1024 * 768 * d + 40 * layer
    assert abs(image_flops(shape) / 1e12 - 14.511) < 0.001
    assert abs(40 * 4 * n * n * d / image_flops(shape) - 0.048) < 0.001
    assert rope_bytes(shape) == 40 * 2 * 2 * 1024 * d * 2 and abs(rope_bytes(shape) / 1e9 - 1.3422) < 1e-4


# ------------------------------------------------------------------ tower


@pytest.mark.parametrize("side", [64, 96])
def test_the_tower_in_fp32_is_the_reference(side):
    """Both sides compute in fp32 on the CPU from the same weights, at two
    grids (4 x 4 and 6 x 6 patches: a rotary table each); they differ in the
    order of their sums (a stride-16 Conv2d against the port's reshape and
    GEMM, the normalisation as one multiply-add, the final LayerNorm over
    one token against all): 2e-5 on a unit row is some hundred fp32
    roundings (readings 1.5e-7 to 1.9e-7)."""
    w = embed_dinov3.make_weights(_shape(), 2**31 + 41, "cpu", torch.float32)
    pixels = _pixels(size=side)
    got = _port(w, torch.float32).get_image_features(torch.from_numpy(pixels)).numpy()
    assert got.shape == (len(pixels), 128)
    assert _dist(got, _reference(w, pixels)) < 2e-5


def _hf_model():
    import os

    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_FLAX", "0")
    transformers = pytest.importorskip("transformers")
    v = dinov3.get_config(TINY).vision
    cfg = transformers.DINOv3ViTConfig(
        hidden_size=v.hidden_size, intermediate_size=v.intermediate_size, num_hidden_layers=v.num_layers,
        num_attention_heads=v.num_heads, patch_size=v.patch_size, image_size=v.image_size,
        num_register_tokens=v.num_register_tokens, use_gated_mlp=True, hidden_act="silu",
        layer_norm_eps=v.layer_norm_eps, rope_theta=v.rope_theta, attn_implementation="eager")
    return transformers.DINOv3ViTModel(cfg).eval()


def _hf_rows(hf, pixels):
    mean, std = (torch.tensor(c).view(1, 3, 1, 1) for c in (dinov2.IMAGENET_MEAN, dinov2.IMAGENET_STD))
    with torch.no_grad():
        x = (torch.from_numpy(pixels).float().permute(0, 3, 1, 2) / 255.0 - mean) / std
        return F.normalize(hf(pixel_values=x).pooler_output, dim=-1).numpy()


@pytest.mark.parametrize("side", [64, 96])
def test_the_tower_and_the_reference_in_fp32_are_hf(side):
    """The same weights in HF's ``DINOv3ViTModel`` (eager attention), its
    ``pooler_output`` L2-normalised, on pixels normalised by the ImageNet
    mean and std, at the configured side and another (HF's rotary table
    follows the input's grid too); the tolerance as above."""
    hf = _hf_model()
    w = embed_dinov3.make_weights(_shape(), 2**31 + 43, "cpu", torch.float32)
    missing, unexpected = hf.load_state_dict(w, strict=False)
    assert not unexpected and missing == ["embeddings.mask_token"]
    pixels = _pixels(seed=8, size=side)
    want = _hf_rows(hf, pixels)
    assert _dist(_reference(w, pixels), want) < 2e-5
    assert _dist(_port(w, torch.float32).get_image_features(torch.from_numpy(pixels)).numpy(), want) < 2e-5


def test_an_hf_state_dict_loads_into_the_port():
    """HF's own model's state dict (its init, under its names, k without a
    bias, gate and up apart) loads into the port, whose features are then
    HF's; a missing or an unknown name, or a wrong shape, raises."""
    hf = _hf_model()
    state = hf.state_dict()
    assert "layer.0.attention.k_proj.bias" not in state and "layer.0.mlp.gate_proj.weight" in state
    model = _port(state, torch.float32)
    pixels = _pixels(n=2, seed=10)
    assert _dist(model.get_image_features(torch.from_numpy(pixels)).numpy(), _hf_rows(hf, pixels)) < 2e-5
    fresh = dinov3.build_model(dinov3.get_config(TINY), torch.device("cpu"), torch.float32)
    for broken in ({k: v for k, v in state.items() if k != "layer.1.mlp.up_proj.bias"},
                   {**state, "layer.0.attention.k_proj.bias": state["layer.0.attention.q_proj.bias"]},
                   {**state, "embeddings.cls_token": torch.zeros(1, 1, 64)}):
        with pytest.raises(ValueError):
            dinov3.load_hf_state_dict(fresh, broken)


def _rotate_the_prefix(q, k, cos, sin, heads, prefix):
    """Every row rotated, the prefix rows by the first patches' angles."""
    return rops.rope_plain(q, k, torch.cat([cos[:prefix], cos]), torch.cat([sin[:prefix], sin]), heads, 0)


def _interleaved(q, k, cos, sin, heads, prefix):
    """Pairs (2j, 2j + 1) of a head turned, in place of (j, j + hd / 2)."""
    def one(x):
        b, s, d = x.shape
        p = x[:, prefix:].float().view(b, s - prefix, heads, d // heads // 2, 2)
        lo, hi, c, sn = p[..., 0], p[..., 1], cos[:, None, :], sin[:, None, :]
        turned = torch.stack([lo * c - hi * sn, hi * c + lo * sn], dim=-1).view(b, s - prefix, d)
        return torch.cat([x[:, :prefix], turned.to(x.dtype)], dim=1)
    return one(q), one(k)


def _axes_swapped(angles_of):
    def angles(cfg, n_h, n_w):
        a = angles_of(cfg, n_h, n_w)
        return a.view(a.shape[0], 2, -1).flip(1).reshape(a.shape[0], -1)  # (w, h) in place of (h, w)
    return angles


def _drop_gamma(model, monkeypatch):
    for layer in model.vision.layers:
        layer.gamma1.data.fill_(1.0)
        layer.gamma2.data.fill_(1.0)


def _k_bias(model, monkeypatch):
    """A k projection with a bias (the q projection's), as one that kept
    SigLIP's and DINOv2's biased k would have."""
    for layer in model.vision.layers:
        k = torch.nn.Linear(*layer.attn.k.weight.shape[::-1])
        k.weight.data.copy_(layer.attn.k.weight)
        k.bias.data.copy_(layer.attn.q.bias)
        layer.attn.k = k


BROKEN = {
    "prefix_rows_rotated": lambda model, mp: mp.setattr(dinov3, "rotate", _rotate_the_prefix),
    "h_and_w_swapped": lambda model, mp: mp.setattr(dinov3, "rope_angles", _axes_swapped(dinov3.rope_angles)),
    "interleaved_pairs": lambda model, mp: mp.setattr(dinov3, "rotate", _interleaved),
    "gamma_dropped": _drop_gamma,
}


@pytest.mark.parametrize("broken", list(BROKEN) + ["k_bias"])
def test_each_mechanism_broken_fails_the_comparison(monkeypatch, broken):
    """The fp32 port with one mechanism broken against the reference. The
    rotation's faults and γ dropped land at least 0.01 from it on a unit row
    (readings 0.069-0.078, and 1.0), twice the bf16 tower's distance below
    (0.0047 at this size), so the cell's check sees them. A k bias the size
    of the q bias moves a row by 0.0036 here, a hundred times the fp32
    tolerance above but under the bf16 tower's distance: only this
    comparison holds the port to no k bias. The faithful port, in the same
    test, passes."""
    w = embed_dinov3.make_weights(_shape(), 2**31 + 47, "cpu", torch.float32)
    pixels = _pixels(seed=11)
    want = _reference(w, pixels)
    model = _port(w, torch.float32)
    assert _dist(model.get_image_features(torch.from_numpy(pixels)).numpy(), want) < 2e-5
    (BROKEN.get(broken) or _k_bias)(model, monkeypatch)
    model.vision._tables.clear()
    got = model.get_image_features(torch.from_numpy(pixels)).numpy()
    assert _dist(got, want) > (2e-3 if broken == "k_bias" else 0.01), broken


def test_the_bf16_tower_is_closer_to_the_reference_than_fp8():
    """The port in bf16 (the configuration's ``compute_dtype``) against the
    fp32 reference on the benchmark's bf16 weights, and the reference with
    every product's operands in fp8 e4m3 (the benchmark's control) against
    the same: the bound lies between. Readings at this size: bf16 0.0047,
    fp8 0.0150."""
    w = embed_dinov3.make_weights(_shape(), 2**31 + 53, "cpu", torch.bfloat16)
    pixels = _pixels(n=8, seed=12)
    want = _reference(w, pixels)
    got = _port(w, torch.bfloat16).get_image_features(torch.from_numpy(pixels)).numpy()
    fp8 = _reference(w, pixels, siglip_ref.FP8())
    bf16_dist, fp8_dist = _dist(got, want), _dist(fp8, want)
    assert bf16_dist < 0.008 < fp8_dist, (bf16_dist, fp8_dist)


def test_the_rotary_table_is_built_once_per_grid():
    """A second call on the same grid reuses the table; another grid gets
    its own; the table is HF's angles (h then w) in fp32."""
    model = dinov3.init_params_(dinov3.build_model(dinov3.get_config(TINY), torch.device("cpu"), torch.float32),
                                torch.Generator().manual_seed(1))
    built = []
    real = dinov3.rope_angles
    for side in (64, 64, 96, 64):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(dinov3, "rope_angles", lambda *a: built.append(a[1:]) or real(*a))
            model.get_image_features(torch.from_numpy(_pixels(n=1, size=side)))
    assert built == [(4, 4), (6, 6)] and len(model.vision._tables) == 2
    cos, sin = model.vision.rope_table(4, 4, torch.device("cpu"))
    want_cos, want_sin = dinov3_ref.rope_table(_shape(), 4, 4, "cpu")
    assert cos.dtype == torch.float32 and cos.shape == (16, 16)
    assert torch.equal(cos.tile(2), want_cos) and torch.equal(sin.tile(2), want_sin)


def test_the_tower_takes_any_side_that_is_a_multiple_of_the_patch():
    model = dinov3.init_params_(dinov3.build_model(dinov3.get_config(TINY), torch.device("cpu"), torch.float32),
                                torch.Generator().manual_seed(2))
    rows = model.image_features(torch.from_numpy(np.concatenate([_pixels(n=1, size=80)] * 2)))
    assert rows.shape == (2, 128) and torch.allclose(torch.linalg.vector_norm(rows, dim=-1), torch.ones(2))
    with pytest.raises(ValueError, match="multiples of 16"):
        model.get_image_features(torch.from_numpy(_pixels(n=1, size=70)))
    with pytest.raises(ValueError, match="no text tower"):
        model.get_text_features(torch.zeros(1, 64, dtype=torch.int64))


def test_dense_takes_a_layer_without_a_bias():
    """``siglip.dense`` on a bias-free layer is ``x @ W.T`` in x's dtype
    (DINOv3's k projection); with a bias it adds it, as before."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 5, 16, generator=g)
    plain = torch.nn.Linear(16, 8, bias=False)
    biased = torch.nn.Linear(16, 8)
    for dtype in (torch.float32, torch.bfloat16):
        assert torch.equal(siglip.dense(x.to(dtype), plain), x.to(dtype) @ plain.weight.to(dtype).t())
        assert torch.equal(siglip.dense(x.to(dtype), biased),
                           F.linear(x.to(dtype), biased.weight.to(dtype), biased.bias.to(dtype)))


def test_the_loader_routes_dinov3_names(tmp_path):
    """A DINOv3 preset builds the DINOv3 model at random, or refuses without
    ``allow_random``; an HF-layout directory (config.json and
    model.safetensors under HF's names) loads its weights."""
    cfg, model = load_model(TINY, str(tmp_path), device="cpu", allow_random=True)
    assert isinstance(model, dinov3.Dinov3Model) and cfg is dinov3.get_config(TINY) and cfg.text is None
    assert model.vision.layers[0].attn.k.bias is None and model.dtype == torch.float32
    with pytest.raises(FileNotFoundError):
        load_model(TINY, str(tmp_path), device="cpu", allow_random=False)
    safetensors = pytest.importorskip("safetensors.torch")
    w = embed_dinov3.make_weights(_shape(), 2**31 + 59, "cpu", torch.float32)
    local = tmp_path / TINY.replace("/", "--")
    local.mkdir()
    (local / "config.json").write_text(json.dumps({"model_type": "dinov3_vit"}))
    safetensors.save_file({k: v.contiguous() for k, v in w.items()}, str(local / "model.safetensors"))
    _, loaded = load_model(TINY, str(tmp_path), device="cpu", allow_random=False)
    pixels = torch.from_numpy(_pixels(n=2, seed=13))
    assert torch.equal(loaded.get_image_features(pixels), _port(w, torch.float32).get_image_features(pixels))


# ------------------------------------------------------------------ the cell's check and readers


@pytest.mark.parametrize("offset, correct", [(0.0, True), ("between", False), ("past_worst", False)])
def test_the_cells_check_holds_the_worst_and_the_median_row(offset, correct):
    """The driver's ``check`` at the tiny shape: rows equal to the fp32
    reference pass; every row moved by a distance between the median's
    limit and the worst row's fails on the median alone; one row moved past
    the worst row's limit fails on it alone."""
    state = embed.State(shape=_shape(), traffic={}, batch=4, pool={"pixels": _pixels(n=8, seed=13)},
                        image_flops=np.zeros(8), engine=None, entry=None, seed=2**31 + 61,
                        device=torch.device("cpu"), dtype=torch.bfloat16)
    ref = embed_dinov3.reference(state)
    moved = ref.copy()
    if offset == "between":
        moved[:, 0] += (LIMITS["median_row_dist"] + LIMITS["max_row_dist"]) / 2
    elif offset == "past_worst":
        moved[5, 0] += 1.5 * LIMITS["max_row_dist"]
    state.outputs = [(0, moved[:4]), (4, moved[4:])]
    ok, failed, numbers = embed_dinov3.check(state, LIMITS)
    assert ok is correct and set(numbers) == {"max_row_dist", "median_row_dist", "bad_rows"}
    assert (numbers["median_row_dist"]["value"] > LIMITS["median_row_dist"]) is (offset == "between")
    assert (numbers["max_row_dist"]["value"] > LIMITS["max_row_dist"]) is (offset == "past_worst")
    assert failed == (1 if offset == "past_worst" else 0)


@pytest.mark.parametrize("ms, peak_flops", [(2.0, 989e12), (None, 989e12), (2.0, None), (2.0, 1e15)])
def test_the_rotation_readers_read_the_span_and_the_runs_card(monkeypatch, ms, peak_flops):
    """``tower.rope_ms_per_image`` is the ``tower.attn.rope`` span's owned
    time an image; ``tower.rope_roofline`` is the rotation's bytes an image
    over that time as a share of the HBM rate of the card whose bf16 peak
    the run carries, and None without the span, without a card or for a
    card ``peaks.json`` lacks."""
    from bench_port.spec import PKG, _load_module

    readers = {n: _load_module(PKG / "metrics" / f"{n}.py", n.replace(".", "_"))
               for n in ("tower.rope_ms_per_image", "tower.rope_roofline")}
    spans = []
    for module in readers.values():
        monkeypatch.setattr(module, "owned_ms_per_image", lambda ctx, name: spans.append(name) or ms)
    ctx = SimpleNamespace(peak_flops=peak_flops, images=16)
    assert readers["tower.rope_ms_per_image"].read(ctx) == ms
    got = readers["tower.rope_roofline"].read(ctx)
    assert set(spans) == {"tower.attn.rope"}
    if ms is None or peak_flops != 989e12:
        assert got is None
    else:
        assert got == pytest.approx(100.0 * rope_bytes(dinov3_shape(CONFIG)) / (ms / 1e3) / 3.35e12)


def test_the_rotation_runs_inside_its_span(monkeypatch):
    """``tower.attn.rope`` opens inside ``tower.attn`` once a layer, after
    the projections and before ``tower.attn.core``."""
    from tpuclip_torch.utils import profiling

    opened = []
    real = profiling.span

    def recording(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(siglip, "span", recording)
    model = dinov3.init_params_(dinov3.build_model(dinov3.get_config(TINY), torch.device("cpu"), torch.float32),
                                torch.Generator().manual_seed(4))
    model.get_image_features(torch.from_numpy(_pixels(n=1)))
    attn = [n for n in opened if n.startswith("tower.attn")]
    assert attn == ["tower.attn", "tower.attn.rope", "tower.attn.core"] * 2


# ------------------------------------------------------------------ engine, CLI


def _photo(seed):
    from PIL import Image

    return Image.fromarray(np.random.default_rng(seed).integers(0, 256, (70, 90, 3), dtype=np.uint8))


def test_the_engine_scans_searches_by_image_and_refuses_text(tmp_path, monkeypatch):
    """The tiny DINOv3 through the engine: no tokenizer, 128-d rows stored
    for every photo, a search by one of them returns it first, and every
    text entry (and the CLI's text search, exit 2) says to search by image."""
    from tpuclip_torch import cli
    from tpuclip_torch.engine import ImageDatabase

    monkeypatch.setenv("TPUCLIP_HOME", str(tmp_path / "home"))
    monkeypatch.setenv("TPUCLIP_INIT", "random")
    root = tmp_path / "imgs"
    root.mkdir()
    for i in range(5):
        _photo(200 + i).save(root / f"img_{i}.png")
    engine = ImageDatabase(str(tmp_path / "one.db"), str(tmp_path / "models"), model_name=TINY,
                           inference_batch_size=4, device="cpu")
    engine.scan_directory(str(root), inference_batch_size=4)
    engine.index.refresh()
    assert engine.tokenizer is None and not engine.has_text_tower and engine.embedding_dim == 128
    assert engine.image_size == 64
    query = str(root / "img_3.png")
    assert engine.search(query, k=3, is_image_path=True)[0][0] == query
    for call in (lambda: engine.search_texts(["a dog"], 3), lambda: engine.embed_texts(["a dog"]),
                 lambda: engine.search("a dog", k=3)):
        with pytest.raises(ValueError, match=r"tpuclip/test-tiny-dinov3.*search by image"):
            call()
    said = []
    monkeypatch.setattr(cli, "log", lambda *a, **kw: said.append(" ".join(map(str, a))))
    with pytest.raises(SystemExit) as done:
        cli.main(["search", "a dog", "--db", engine.db_path, "--model", TINY, "--model-cache",
                  str(tmp_path / "models"), "--no-session", "--device", "cpu"])
    assert done.value.code == 2 and any("search by image" in line for line in said), said


# ------------------------------------------------------------------ kernel 11 at H 8192


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_silu_mul_at_dinov3s_width(dtype):
    """H 8192 (DINOv3-7B's SwiGLU): the plain version and the wrapper on CPU
    tensors are ``silu(a) * b`` in fp32, rounded once."""
    h = torch.from_numpy(np.random.default_rng(8).standard_normal((3, 2 * 8192), dtype=np.float32) * 3).to(dtype)
    want = (F.silu(h.float()[:, :8192]) * h.float()[:, 8192:]).to(dtype)
    for fn in (swiglu.silu_mul_plain, swiglu.silu_mul):
        assert torch.equal(fn(h), want), fn.__name__


# ============================================================ on the card


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernels 9 to 12 have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _within_one_bf16_step(got, want):
    g, w = got.float(), want.float()
    _, exp = torch.frexp(w)
    err = (g - w).abs()
    return bool((err <= torch.ldexp(torch.ones_like(w), exp - 8) + 1e-5).all()), err.max().item()


@pytest.mark.cuda
def test_cuda_silu_mul_at_h_8192(cuda_device):
    """The cell's 16,464 rows of 2 x 8,192: within one bf16 step of the
    plain version, as at DINOv2's 4,096."""
    gen = torch.Generator(device=cuda_device).manual_seed(13)
    h = (torch.randn((16 * 1029, 2 * 8192), generator=gen, device=cuda_device) * 3).to(torch.bfloat16)
    got = swiglu.silu_mul(h)
    torch.cuda.synchronize()
    ok, worst = _within_one_bf16_step(got, swiglu.silu_mul_plain(h))
    assert ok and got.shape == (16 * 1029, 8192), worst


def _plain_route(monkeypatch):
    monkeypatch.setattr(siglip, "add_layer_norm", lops.add_layer_norm_plain)
    monkeypatch.setattr(dinov2, "silu_mul", swiglu.silu_mul_plain)
    monkeypatch.setattr(dinov3, "rope", rops.rope_plain)


def _counts():
    return (lops.add_layer_norm.launches, swiglu.silu_mul.launches, rops.rope.launches, aops.attention.launches,
            aops.attention_sm90.launches)


@pytest.mark.cuda
def test_cuda_one_7b_layer_through_the_kernels_is_the_plain_route(cuda_device, monkeypatch):
    """One layer at the cell's widths (4 images of 1,029 tokens, width 4096,
    32 heads of 128, H 8192), γ ~ N(0.1, 0.03²), a scaled pending input and
    the 32 x 32 grid's rotation: 2 kernel-10 launches on the wide design, 1
    of kernel 11, 1 of kernel 12 and 1 of kernel 9's Hopper design. Its
    outputs lie within 2^-7 of each row's norm of the plain route's
    (kernel 12 and 11 bit-equal, kernel 10's LayerNorm a bf16 step apart in
    a few values, carried through the layer's GEMMs)."""
    cfg = dinov3.get_config(BIG).vision
    gen = torch.Generator(device=cuda_device).manual_seed(31)
    layer = dinov2.Dinov2Layer(cfg, key_bias=False).to(cuda_device)
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
    angles = dinov3.rope_angles(cfg, 32, 32)
    rotation = lambda q, k: dinov3.rotate(q, k, torch.cos(angles).to(cuda_device),  # noqa: E731
                                          torch.sin(angles).to(cuda_device), cfg.num_heads, cfg.num_prefix_tokens)
    shape = (4, cfg.num_tokens, cfg.hidden_size)
    x = (torch.randn(shape, generator=gen, device=cuda_device) * 2).to(torch.bfloat16)
    delta = torch.randn(shape, generator=gen, device=cuda_device).to(torch.bfloat16)
    scale = (0.1 + 0.03 * torch.randn(cfg.hidden_size, generator=gen, device=cuda_device)).to(torch.bfloat16)
    with torch.no_grad():
        before = _counts()
        got = layer(x, delta, scale, rotation)
        torch.cuda.synchronize()
        assert tuple(a - b for a, b in zip(_counts(), before)) == (2, 1, 1, 1, 1)
        _plain_route(monkeypatch)
        want = layer(x, delta, scale, rotation)
    for what, g, w in zip(("stream", "mlp output"), got, want):
        rel = float((torch.linalg.vector_norm((g.float() - w.float()), dim=-1)
                     / torch.linalg.vector_norm(w.float(), dim=-1)).max())
        print(f"[dinov3] one 7B layer, {what}: kernels against the plain route, worst row {rel:.2e} of its norm")
        assert rel <= 2**-7, (what, rel)


@pytest.mark.cuda
def test_cuda_7b_tower_through_the_kernels_is_inside_the_cells_limits_and_fp8_is_not(cuda_device, monkeypatch):
    """The bf16 7B tower (40 layers) on the cell's seeded weights and 4 of
    its 512² images: 81 kernel-10 launches a call, 40 of kernel 11, 40 of
    kernel 12 and 40 of kernel 9, all on its Hopper design (head width
    128), unit-norm rows. Through the kernels and through the plain
    versions, each image's row lies inside the cell's limits of the fp32
    reference, and the fp8 control on the same images lies outside both."""
    shape = dinov3_shape(CONFIG)
    w = embed_dinov3.make_weights(shape, 2**31 + 77, cuda_device, torch.bfloat16)
    model = dinov3.load_hf_state_dict(dinov3.build_model(dinov3.get_config(BIG), cuda_device, torch.bfloat16), w)
    pixels = _pixels(n=4, seed=15, size=512)
    with torch.no_grad():
        before = _counts()
        got = model.get_image_features(torch.from_numpy(pixels).to(cuda_device))
        torch.cuda.synchronize()
        assert tuple(a - b for a, b in zip(_counts(), before)) == (81, 40, 40, 40, 40)
        assert torch.allclose(torch.linalg.vector_norm(got, dim=-1), torch.ones(4, device=cuda_device), atol=1e-5)
        _plain_route(monkeypatch)
        plain = model.get_image_features(torch.from_numpy(pixels).to(cuda_device))
    del model
    w32 = siglip_ref.fp32_weights(w)
    del w
    exact, control = (dinov3_ref.reference_rows(w32, pixels, np.arange(4), shape, prec).cpu().numpy()
                      for prec in (siglip_ref.FP32(), siglip_ref.FP8()))
    rows = {name: np.linalg.norm(r.astype(np.float64) - exact, axis=1)
            for name, r in (("kernels", got.float().cpu().numpy()), ("plain", plain.float().cpu().numpy()),
                            ("fp8", control))}
    print("[dinov3] 7B tower, rows' distances to fp32: "
          + "; ".join(f"{k} {np.round(v, 4).tolist()}" for k, v in rows.items()))
    for name in ("kernels", "plain"):
        assert rows[name].max() <= LIMITS["max_row_dist"] and np.median(rows[name]) <= LIMITS["median_row_dist"], name
    assert rows["fp8"].min() > LIMITS["max_row_dist"] and np.median(rows["fp8"]) > LIMITS["median_row_dist"]
