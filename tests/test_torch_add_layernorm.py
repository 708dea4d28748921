"""The residual add and the LayerNorm after it (tpuclip_torch/ops/layernorm.py,
kernel 10) and the towers that carry the pending residual into it.

On the CPU: the plain version, and the wrapper on CPU tensors, are
``x + delta`` then ``F.layer_norm`` bit for bit (fp32 and bf16; D 768, 1152,
1536, 2048 and 4096; with and without delta, and with a LayerScale at the
wide design's 2048 and 4096); the towers' new order (the MLP's output
pending into the next layer's first LayerNorm, the last one's folded into
the post-LN or the final LN) gives the former add-then-LN loop's outputs
bit for bit in the vision, NaFlex and text towers at the tiny presets, in
fp32, bf16 and the training route (gradients too); ``add_norm`` routes on
what its inputs show; the wrapper refuses what the kernel does not take,
and its CUDA branch passes the tensors as they are (tensors that report a
CUDA device, a recorder in place of the library).
On a CUDA card (``cuda`` marker): the kernel against the plain version at
the cells' row counts (x_out bit-equal, y within one bf16 step), the wide
design at D 2048 and 4096 at the DINOv3 cell's 16,464 rows, the SO400M
towers through the kernel against the forced plain route with 55 launches a
call, and a text-tower graph replay against eager."""

from contextlib import nullcontext
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tpuclip_torch.models import naflex, siglip
from tpuclip_torch.models.configs import get_config
from tpuclip_torch.ops import _build
from tpuclip_torch.ops import layernorm as lops

EPS = 1e-6


def _rows(rng, shape, dtype, delta=True):
    """x with a spread of row means and scales (a residual stream), delta,
    and a LayerNorm's fp32 weight and bias."""
    d = shape[-1]
    x = rng.standard_normal(shape, dtype=np.float32) * 3 + rng.standard_normal(shape[:-1] + (1,), dtype=np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))  # noqa: E731
    dx = t(rng.standard_normal(shape, dtype=np.float32)).to(dtype) if delta else None
    w = t(1 + 0.1 * rng.standard_normal(d, dtype=np.float32))
    b = t(0.1 * rng.standard_normal(d, dtype=np.float32))
    return t(x).to(dtype), dx, w, b


@pytest.mark.parametrize("with_delta", [True, False])
@pytest.mark.parametrize("d", [768, 1152, 1536, 2048, 4096])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_is_the_add_then_layer_norm(dtype, d, with_delta):
    """Both the plain version and the wrapper on CPU tensors return the add
    (x itself without delta) and ``F.layer_norm`` with the weight and bias
    in x's dtype, the towers' former arithmetic, bit for bit."""
    rng = np.random.default_rng(d + with_delta)
    x, delta, w, b = _rows(rng, (3, 17, d), dtype, with_delta)
    s = x + delta if with_delta else x
    want = F.layer_norm(s, (d,), w.to(dtype), b.to(dtype), EPS)
    before = lops.add_layer_norm.launches
    for fn in (lops.add_layer_norm_plain, lops.add_layer_norm):
        x_out, y = fn(x, delta, w, b, EPS)
        assert x_out.dtype == y.dtype == dtype and torch.equal(x_out, s) and torch.equal(y, want), fn.__name__
        if not with_delta:
            assert x_out is x
    assert lops.add_layer_norm.launches == before


@pytest.mark.parametrize("scaled", [True, False])
@pytest.mark.parametrize("d", [2048, 4096])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_rows_plain_is_one_rounded_sum_then_layer_norm(dtype, d, scaled):
    """At the wide design's widths, with and without a LayerScale: the
    plain version and the wrapper on CPU tensors return ``x + scale *
    delta`` in fp32 rounded once (``x + delta`` unscaled) and
    ``F.layer_norm`` of it."""
    rng = np.random.default_rng(d + scaled)
    x, delta, w, b = _rows(rng, (2, 9, d), dtype)
    scale = torch.from_numpy(0.1 + 0.03 * rng.standard_normal(d, dtype=np.float32)).to(dtype) if scaled else None
    s = (x.float() + scale.float() * delta.float()).to(dtype) if scaled else x + delta
    want = F.layer_norm(s, (d,), w.to(dtype), b.to(dtype), EPS)
    for fn in (lops.add_layer_norm_plain, lops.add_layer_norm):
        x_out, y = fn(x, delta, w, b, EPS, scale)
        assert torch.equal(x_out, s) and torch.equal(y, want), fn.__name__


# ------------------------------------------------------------------ towers


def _former_encoder(encoder, x, mask=None):
    """The encoder as the towers computed it before kernel 10, verbatim: each
    layer's LN1, attention and add, LN2, MLP and add."""
    for layer in encoder.layers:
        y = layer.ln1(x)
        x = x + layer.attn(y, y, mask)
        x = x + layer.mlp(layer.ln2(x))
    return x


def _tiny(preset, dtype, grad):
    cfg = get_config(preset)
    model = siglip.build_model(cfg, torch.device("cpu"), dtype)
    siglip.init_params_(model, torch.Generator().manual_seed(3))
    return cfg, model.requires_grad_(grad)


def _tower_run(tower, cfg, model, rng, route):
    """A closure running ``tower`` of ``model`` on seeded inputs the way
    ``route`` does: the inference entries (fp32, bf16), or the training
    route (bf16 compute on fp32 weights that require grad, remat on)."""
    b = 3
    if tower == "text":
        t = cfg.text
        ids = torch.from_numpy(rng.integers(3, t.vocab_size, (b, t.max_length)))
        keep = torch.from_numpy((np.arange(t.max_length)[None] < np.array([64, 40, 7])[:, None]).astype(np.int32))
        if route == "grad":
            return lambda: model.text(ids, torch.bfloat16, keep)
        return lambda: model.get_text_features(ids, keep)
    v = cfg.vision
    if tower == "naflex":
        p = v.patch_size
        grids = np.array([(8, 8), (6, 10), (7, 9)])
        patches = torch.from_numpy(rng.integers(0, 256, (b, v.max_num_patches, p * p * 3), dtype=np.uint8))
        keep = torch.from_numpy((np.arange(v.max_num_patches)[None] < grids.prod(1)[:, None]).astype(np.int32))
        shapes = torch.from_numpy(grids)
        if route == "grad":
            return lambda: naflex.vision_forward_naflex(model.vision, patches, keep, shapes, torch.bfloat16)
        return lambda: model.get_image_features_naflex(patches, keep, shapes)
    pixels = torch.from_numpy(rng.integers(0, 256, (b, v.image_size, v.image_size, 3), dtype=np.uint8))
    if route == "grad":
        return lambda: model.vision(pixels, torch.bfloat16)
    return lambda: model.get_image_features(pixels)


@pytest.mark.parametrize("route", ["fp32", "bf16", "grad"])
@pytest.mark.parametrize("tower", ["vision", "naflex", "text"])
def test_towers_new_order_is_the_former_loop(monkeypatch, tower, route):
    """The pending residual (each layer's MLP output added by the next
    layer's LN1, the last one's by the post-LN or the final LN) against the
    former loop (each add done at once, then a plain post-LN / final LN),
    on the same model and inputs: outputs bit for bit; on the training
    route (remat on) every parameter's gradient too. No CPU call reaches
    the library."""
    monkeypatch.setattr(_build, "library", lambda: pytest.fail("a CPU call reached the CUDA library"))
    preset = "tpuclip/test-tiny-naflex" if tower == "naflex" else "tpuclip/test-tiny"
    cfg, model = _tiny(preset, torch.bfloat16 if route == "bf16" else torch.float32, route == "grad")
    encoder = (model.text if tower == "text" else model.vision).encoder
    run = _tower_run(tower, cfg, model, np.random.default_rng(7), route)

    def outputs():
        if route != "grad":
            return run(), []
        model.zero_grad(set_to_none=True)
        with siglip.remat_scope(model):
            out = run()
        out.float().square().sum().backward()
        return out.detach(), [(n, p.grad) for n, p in model.named_parameters() if p.grad is not None]

    got, got_grads = outputs()
    monkeypatch.setattr(encoder, "forward", lambda x, mask=None: (_former_encoder(encoder, x, mask), None))
    want, want_grads = outputs()
    assert got.shape == want.shape and torch.equal(got, want)
    assert [n for n, _ in got_grads] == [n for n, _ in want_grads]
    assert (route == "grad") == bool(got_grads)
    for (name, g), (_, w) in zip(got_grads, want_grads):
        assert torch.equal(g, w), name


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports ``cuda:0``: drives the CUDA branches on a
    machine without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _fake(x):
    return x.as_subclass(_FakeCuda)


def test_add_norm_routes_on_what_the_inputs_show(monkeypatch):
    """bf16 on CUDA with no gradient goes to the wrapper; the CPU, fp32, and
    anything autograd must differentiate (the stream, the pending residual
    or the LayerNorm's weight requiring grad) to the plain version."""
    calls = []
    monkeypatch.setattr(siglip, "add_layer_norm", lambda *a: calls.append(a) or lops.add_layer_norm_plain(*a))
    rng = np.random.default_rng(4)
    ln = siglip.LayerNorm(64, EPS)
    x, delta, _, _ = _rows(rng, (2, 5, 64), torch.bfloat16)
    x32, delta32, _, _ = _rows(rng, (2, 5, 64), torch.float32)
    with torch.no_grad():
        siglip.add_norm(_fake(x), _fake(delta), ln)
        assert len(calls) == 1 and calls[0][1] is not None and calls[0][4] == EPS
        siglip.add_norm(_fake(x), None, ln)
        assert len(calls) == 2 and calls[1][1] is None
        siglip.add_norm(x, delta, ln)
        siglip.add_norm(_fake(x32), _fake(delta32), ln)
    assert len(calls) == 2
    for needs_grad in (x, delta, ln.weight):
        needs_grad.requires_grad_(True)
        x_out, y = siglip.add_norm(_fake(x), _fake(delta), ln)
        y.float().sum().backward()
        needs_grad.requires_grad_(False)
        assert len(calls) == 2 and needs_grad.grad is not None
    with torch.no_grad():
        ln.weight.requires_grad_(True)
        siglip.add_norm(_fake(x), _fake(delta), ln)  # no gradient is taken: the kernel
    assert len(calls) == 3


def _bad_inputs(rng):
    x, delta, w, b = _rows(rng, (4, 3, 64), torch.bfloat16)
    wide = _rows(rng, (2, 128), torch.bfloat16)
    return {
        "dtype_mix": (x, delta.float(), w, b, TypeError),
        "width_not_multiple_of_8": (*_rows(rng, (2, 3, 12), torch.bfloat16), ValueError),
        # the key keeps its first name; the row is past the widest the kernel takes
        "wider_than_1536": (*_rows(rng, (2, lops.MAX_WIDTH + 8), torch.bfloat16), ValueError),
        "rows_out_of_order": (x.transpose(0, 1), delta.transpose(0, 1), w, b, ValueError),
        "strided_row": (wide[0][:, ::2], wide[1][:, ::2], w, b, ValueError),
        "delta_shape": (x, delta[:2], w, b, ValueError),
        "weight_shape": (x, delta, w[:32], b, ValueError),
        "needs_grad": (x.clone().requires_grad_(True), delta, w, b, ValueError),
        "weight_needs_grad": (x, delta, w.clone().requires_grad_(True), b, ValueError),
    }


BAD = list(_bad_inputs(np.random.default_rng(0)))


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("bad", BAD)
def test_the_wrapper_refuses_what_the_kernel_does_not_take(recorder, bad, device):
    """On CPU tensors and on tensors that report a CUDA device alike: a
    dtype mix, D not a multiple of 8 or past 4096, rows out of order or not
    contiguous, a delta or weight of the wrong shape, and anything that
    needs a gradient raise before any launch."""
    x, delta, w, b, error = _bad_inputs(np.random.default_rng(0))[bad]
    if device == "cuda":
        x, delta, w, b = (_fake(t) for t in (x, delta, w, b))
    before = lops.add_layer_norm.launches
    with pytest.raises(error):
        lops.add_layer_norm(x, delta, w, b, EPS)
    assert not recorder and lops.add_layer_norm.launches == before


@pytest.fixture()
def recorder(monkeypatch):
    """The wrapper's CUDA branch with a recorder in place of the library:
    returns the list of the kernel's recorded argument tuples."""
    calls = []

    def entry(*args):
        calls.append(args)
        return 0

    real_empty = torch.empty
    monkeypatch.setattr(torch.cuda, "device", lambda dev: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(torch, "empty", lambda *a, device=None, **kw: real_empty(*a, **kw))
    monkeypatch.setattr(_build, "library", lambda: SimpleNamespace(tpuclip_add_layernorm=entry))
    return calls


def test_the_kernel_is_launched_with_the_tensors_as_they_are(recorder):
    """x, delta, a null scale and the LayerNorm's bf16 weight and bias are
    passed in place, with new x_out and y, the row count, D, eps and the
    stream, one launch counted; without delta both of its pointers are null
    and x itself is returned; fp32 rows on CUDA are refused."""
    rng = np.random.default_rng(5)
    x, delta, w, b = (_fake(t) for t in _rows(rng, (4, 6, 64), torch.bfloat16))
    w, b = w.to(torch.bfloat16), b.to(torch.bfloat16)
    before = lops.add_layer_norm.launches
    x_out, y = lops.add_layer_norm(x, delta, w, b, EPS)
    assert lops.add_layer_norm.launches == before + 1 and len(recorder) == 1
    args = recorder[0]
    assert args[:5] == (x.data_ptr(), delta.data_ptr(), 0, w.data_ptr(), b.data_ptr())
    assert args[5:] == (x_out.data_ptr(), y.data_ptr(), 24, 64, pytest.approx(EPS), 7)
    assert x_out.shape == y.shape == x.shape and x_out.data_ptr() not in (x.data_ptr(), y.data_ptr())
    x_out, y = lops.add_layer_norm(x, None, w, b, EPS)
    assert x_out is x and recorder[1][1] == recorder[1][2] == recorder[1][5] == 0 and recorder[1][6] == y.data_ptr()
    with pytest.raises(TypeError):
        lops.add_layer_norm(_fake(x.float()), _fake(delta.float()), w, b, EPS)
    assert lops.add_layer_norm.launches == before + 2 and len(recorder) == 2


@pytest.mark.parametrize("d", [2048, 4096])
def test_wide_rows_are_launched_through_the_one_entry(recorder, d):
    """Rows past 1536 go to the same C entry with their width, which picks
    the wide design itself; the scale's pointer is passed as at 1536."""
    x, delta, w, b = (_fake(t.to(torch.bfloat16)) for t in _rows(np.random.default_rng(d), (3, 5, d), torch.bfloat16))
    scale = _fake(torch.full((d,), 0.1, dtype=torch.bfloat16))
    x_out, y = lops.add_layer_norm(x, delta, w, b, EPS, scale)
    (args,) = recorder
    assert args[:3] == (x.data_ptr(), delta.data_ptr(), scale.data_ptr())
    assert args[5:] == (x_out.data_ptr(), y.data_ptr(), 15, d, pytest.approx(EPS), 7)


# ============================================================ on the card


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel 10 has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _within_one_bf16_step(got, want):
    """Whether each bf16 value of ``got`` lies within one bf16 step (at
    ``want``'s magnitude) of ``want``, plus 1e-5 for the fp32 statistics'
    other summation order where the output is near zero; and the largest
    difference, and the share bit-equal."""
    g, w = got.float(), want.float()
    _, exp = torch.frexp(w)
    step = torch.ldexp(torch.ones_like(w), exp - 8)
    err = (g - w).abs()
    return bool((err <= step + 1e-5).all()), err.max().item(), float((err == 0).float().mean())


@pytest.mark.cuda
@pytest.mark.parametrize("with_delta", [True, False])
@pytest.mark.parametrize("rows", [65_536, 46_656, 4_096])
def test_cuda_kernel_matches_plain(cuda_device, rows, with_delta):
    """The cells' row counts at D 1152 (a 224 / NaFlex call of 256 images,
    a 384 call of 64, a text call of 64): x_out bit-equal to PyTorch's bf16
    add, y within one bf16 step of ``F.layer_norm`` of it."""
    gen = torch.Generator(device=cuda_device).manual_seed(rows + with_delta)
    d = 1152
    x = (torch.randn((rows, d), generator=gen, device=cuda_device) * 3
         + torch.randn((rows, 1), generator=gen, device=cuda_device)).to(torch.bfloat16)
    delta = torch.randn((rows, d), generator=gen, device=cuda_device).to(torch.bfloat16) if with_delta else None
    w = (1 + 0.1 * torch.randn(d, generator=gen, device=cuda_device)).to(torch.bfloat16)
    b = (0.1 * torch.randn(d, generator=gen, device=cuda_device)).to(torch.bfloat16)
    before = lops.add_layer_norm.launches
    x_out, y = lops.add_layer_norm(x, delta, w, b, EPS)
    torch.cuda.synchronize()
    assert lops.add_layer_norm.launches == before + 1
    want_x, want_y = lops.add_layer_norm_plain(x, delta, w, b, EPS)
    assert torch.equal(x_out, want_x) and (with_delta or x_out is x)
    ok, worst, equal = _within_one_bf16_step(y, want_y)
    print(f"[add_layernorm] rows {rows} delta {with_delta}: y max diff {worst:.2e}, bit-equal {equal:.6f}")
    assert ok, worst


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["scaled", "delta", "alone"])
@pytest.mark.parametrize("d", [2048, 4096])
def test_cuda_wide_rows_match_plain(cuda_device, d, mode):
    """The wide design (a row a block of 4 warps) at the DINOv3 cell's
    16,464 rows (16 images of 1,029 tokens): with LayerScale's γ, with a
    plain delta and alone. x_out bit-equal to the plain sum (with γ: the
    exact product of two bf16 values, then one rounding, on both sides), y
    within one bf16 step of ``F.layer_norm`` of it (the row's sums in
    another order)."""
    gen = torch.Generator(device=cuda_device).manual_seed(d + len(mode))
    rows = 16 * 1029
    x = (torch.randn((rows, d), generator=gen, device=cuda_device) * 3
         + torch.randn((rows, 1), generator=gen, device=cuda_device)).to(torch.bfloat16)
    delta = None if mode == "alone" else (torch.randn((rows, d), generator=gen, device=cuda_device) * 4).to(
        torch.bfloat16)
    scale = (0.1 + 0.03 * torch.randn(d, generator=gen, device=cuda_device)).to(torch.bfloat16) if mode == "scaled" \
        else None
    w = (1 + 0.1 * torch.randn(d, generator=gen, device=cuda_device)).to(torch.bfloat16)
    b = (0.1 * torch.randn(d, generator=gen, device=cuda_device)).to(torch.bfloat16)
    before = lops.add_layer_norm.launches
    x_out, y = lops.add_layer_norm(x, delta, w, b, 1e-5, scale)
    torch.cuda.synchronize()
    assert lops.add_layer_norm.launches == before + 1
    want_x, want_y = lops.add_layer_norm_plain(x, delta, w, b, 1e-5, scale)
    assert torch.equal(x_out, want_x) and (delta is not None or x_out is x)
    ok, worst, equal = _within_one_bf16_step(y, want_y)
    print(f"[add_layernorm] D {d} {mode}: y max diff {worst:.2e}, bit-equal {equal:.6f}")
    assert ok, worst


@pytest.mark.cuda
@pytest.mark.parametrize("preset, tower", [
    ("google/siglip2-so400m-patch14-224", "vision"), ("google/siglip2-so400m-patch16-naflex", "vision"),
    ("google/siglip2-so400m-patch14-224", "text"),
])
def test_cuda_so400m_tower_through_the_kernel_matches_the_plain_route(cuda_device, monkeypatch, preset, tower):
    """The bf16 SO400M towers (27 layers, random weights) on 8 images or
    texts: 55 launches a call (the first LN1 alone, 54 fused), unit-norm
    features with cosine >= 0.9999 to the same towers on the plain route."""
    cfg = get_config(preset)
    model = siglip.build_model(cfg, cuda_device, torch.bfloat16)
    siglip.init_params_(model, torch.Generator(device=cuda_device).manual_seed(5))
    rng = np.random.default_rng(12)
    b, v = 8, cfg.vision
    if tower == "text":
        t = cfg.text
        ids = torch.from_numpy(rng.integers(3, t.vocab_size, (b, t.max_length))).to(cuda_device)
        keep = torch.from_numpy((np.arange(t.max_length)[None] < rng.integers(1, 65, (b, 1))).astype(np.int32))
        run = lambda: model.get_text_features(ids, keep.to(cuda_device))  # noqa: E731
    elif v.naflex:
        p = v.patch_size
        grids = np.array([(16, 16), (13, 19), (15, 17), (12, 21), (14, 18), (9, 27), (11, 23), (10, 25)])
        patches = torch.from_numpy(rng.integers(0, 256, (b, v.num_patches, p * p * 3), dtype=np.uint8)).to(cuda_device)
        keep = torch.from_numpy((np.arange(v.num_patches)[None] < grids.prod(1)[:, None]).astype(np.int32))
        shapes = torch.from_numpy(grids).to(cuda_device)
        run = lambda: model.get_image_features_naflex(patches, keep.to(cuda_device), shapes)  # noqa: E731
    else:
        side = v.image_size
        pixels = torch.from_numpy(rng.integers(0, 256, (b, side, side, 3), dtype=np.uint8)).to(cuda_device)
        run = lambda: model.get_image_features(pixels)  # noqa: E731
    before = lops.add_layer_norm.launches
    got = run()
    torch.cuda.synchronize()
    layers = cfg.text.num_layers if tower == "text" else v.num_layers
    assert lops.add_layer_norm.launches == before + 2 * layers + 1 == before + 55
    monkeypatch.setattr(siglip, "add_layer_norm", lops.add_layer_norm_plain)
    want = run()
    assert lops.add_layer_norm.launches == before + 55
    cos = F.cosine_similarity(got, want, dim=-1)
    norms = torch.linalg.vector_norm(got, dim=-1)
    print(f"[add_layernorm] {preset} {tower}: cosine to the plain route {float(cos.min()):.6f}-{float(cos.max()):.6f}")
    assert float(cos.min()) >= 0.9999
    assert torch.allclose(norms, torch.ones_like(norms), atol=1e-5)


@pytest.mark.cuda
def test_cuda_text_tower_graph_replay_equals_eager(cuda_device):
    """The bf16 text tower (SO400M, 16 texts of 1-64 tokens) as a captured
    program (``FusedGraphs``): a replay equals eager bit for bit, and
    ``add_layer_norm.launches`` counts 55 a replay (the capture's own count
    taken back through ``COUNTED``)."""
    from tpuclip_torch.ops.graphs import FusedGraphs

    cfg = get_config("google/siglip2-so400m-patch14-224")
    model = siglip.build_model(cfg, cuda_device, torch.bfloat16)
    siglip.init_params_(model, torch.Generator(device=cuda_device).manual_seed(6))
    rng = np.random.default_rng(13)
    t = cfg.text
    host = [rng.integers(3, t.vocab_size, (16, t.max_length)),
            (np.arange(t.max_length)[None] < rng.integers(1, 65, (16, 1))).astype(np.int32)]

    def program(ids, keep):
        return (model.get_text_features(ids, keep),)

    def eager():
        return program(*(torch.from_numpy(a).to(cuda_device) for a in host))[0].cpu().numpy()

    want = eager()
    graphs = FusedGraphs(cuda_device)
    before = lops.add_layer_norm.launches
    first = graphs.run("text", program, host)[0]
    assert lops.add_layer_norm.launches == before + 2 * 55  # the eager warm-up and one replay
    assert np.array_equal(first, want)
    host[0] = host[0][::-1].copy()
    second = graphs.run("text", program, host)[0]
    assert lops.add_layer_norm.launches == before + 3 * 55
    assert np.array_equal(second, eager()) and not np.array_equal(second, first)
