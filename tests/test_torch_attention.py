"""The towers' attention (tpuclip_torch/ops/attention.py, kernel 9).

On the CPU: the plain version is the towers' former ``attend`` arithmetic
bit for bit (fp32 and bf16, with and without a key mask, Sq 1 / 64 / 256,
head_dim 16 / 64 / 72); ``attend`` sends CPU tensors to it and the
launch counter stays 0; a call that autograd must differentiate takes the
explicit matmuls; the wrapper refuses the CUDA inputs the kernel does not
take (tensors that report a CUDA device, a recorder in place of the
library); the shape rule between kernel 9's two designs (``takes_sm90``):
which entry point each caller's shape reaches, with each design's counter.
On a CUDA card (``cuda`` marker): the kernel against the plain version at
the cells' launch shapes and the other shapes its callers use, within the
tolerance that rounding P once at bf16 implies, each case counted on the
design the rule gives; a CUDA-graph capture and replay against eager,
counted through ``COUNTED``; the SO400M vision tower with the kernel
against the tower with the plain version."""

import math
from contextlib import nullcontext
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch import nn

from tpuclip_torch.models import siglip
from tpuclip_torch.models.siglip import dense
from tpuclip_torch.ops import _build
from tpuclip_torch.ops import attention as aops

F32_MIN = torch.finfo(torch.float32).min


def _old_attend(q_in, kv_in, wq, wk, wv, num_heads, mask=None):
    """``attend`` as the towers computed it before kernel 9, verbatim."""
    b, sq, _ = q_in.shape
    sk = kv_in.shape[1]
    h = num_heads
    width = wq.weight.shape[0]
    q = dense(q_in, wq).view(b, sq, h, width // h).transpose(1, 2)
    k = dense(kv_in, wk).view(b, sk, h, width // h).transpose(1, 2)
    v = dense(kv_in, wv).view(b, sk, h, width // h).transpose(1, 2)
    scale = 1.0 / math.sqrt(width // h)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits + mask.float()
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.matmul(weights, v).transpose(1, 2)
    return out.reshape(b, sq, width)


def _key_mask(rng, b, sk, low):
    """An additive (B, 1, 1, Sk) fp32 mask over each row's tail: between
    ``low`` and Sk real keys a row (NaFlex's padded patches, the text
    tower's padding), ``finfo(f32).min`` past them, as the towers build it."""
    keep = np.zeros((b, sk), dtype=np.float32)
    for i, n in enumerate(rng.integers(low, sk + 1, b)):
        keep[i, :n] = 1.0
    return ((1.0 - torch.from_numpy(keep)) * F32_MIN)[:, None, None, :]


def _projections(rng, width, dtype):
    layers = []
    for _ in range(3):
        layer = nn.Linear(width, width)
        with torch.no_grad():
            w = torch.from_numpy(rng.standard_normal((width, width), dtype=np.float32))
            layer.weight.copy_(w / math.sqrt(width))
            layer.bias.copy_(torch.from_numpy(rng.standard_normal(width, dtype=np.float32)) * 0.1)
        layers.append(layer.to(dtype))
    return layers


@pytest.mark.parametrize("hd", [16, 64, 72])
@pytest.mark.parametrize("sq", [1, 64, 256])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_is_the_former_attend_bit_for_bit(dtype, masked, sq, hd):
    """Sq 1 is the MAP head's probe over 256 keys; 64 the text tower; 256
    the vision encoder. ``attend`` (on the CPU, through the wrapper for
    bf16), ``attention_plain`` on the projections and ``attention`` with
    the mask as a (B, Sk) key bias all give the former bits."""
    rng = np.random.default_rng(sq * 1000 + hd)
    b, h = 2, 2
    width, sk = h * hd, max(sq, 64) if sq > 1 else 256
    wq, wk, wv = _projections(rng, width, dtype)
    kv_in = torch.from_numpy(rng.standard_normal((b, sk, width), dtype=np.float32)).to(dtype)
    q_in = kv_in if sq == sk else torch.from_numpy(rng.standard_normal((b, sq, width), dtype=np.float32)).to(dtype)
    mask = _key_mask(rng, b, sk, sk - 13) if masked else None
    with torch.inference_mode():
        want = _old_attend(q_in, kv_in, wq, wk, wv, h, mask)
        q, k, v = dense(q_in, wq), dense(kv_in, wk), dense(kv_in, wv)
        bias = None if mask is None else mask[:, 0, 0, :]
        got = {
            "attend": siglip.attend(q_in, kv_in, wq, wk, wv, h, mask),
            "attention_plain": aops.attention_plain(q, k, v, h, mask),
            "attention": aops.attention(q, k, v, h, bias),
        }
    assert want.dtype == dtype and want.shape == (b, sq, width)
    for name, out in got.items():
        assert out.dtype == dtype and torch.equal(out, want), name


def test_cpu_takes_the_plain_version(monkeypatch):
    """``attend`` on CPU tensors, bf16 and fp32, never reaches the library,
    and the counter stays where it was."""
    monkeypatch.setattr(_build, "library", lambda: pytest.fail("a CPU call reached the CUDA library"))
    rng = np.random.default_rng(1)
    before = aops.attention.launches
    for dtype in (torch.bfloat16, torch.float32):
        wq, wk, wv = _projections(rng, 64, dtype)
        x = torch.from_numpy(rng.standard_normal((3, 64, 64), dtype=np.float32)).to(dtype)
        with torch.inference_mode():
            out = siglip.attend(x, x, wq, wk, wv, 4, _key_mask(rng, 3, 64, 1))
        assert out.shape == (3, 64, 64) and bool(torch.isfinite(out.float()).all())
    assert aops.attention.launches == before


def test_dispatch_on_what_the_inputs_show(monkeypatch):
    """bf16 projections without a gradient go to the wrapper, the 4-D key
    mask as a (B, Sk) view (a shared row expanded with batch stride 0);
    fp32 ones, and bf16 ones that autograd must differentiate, to the
    explicit matmuls, whose gradients reach every projection."""
    calls = []

    def spy(q, k, v, num_heads, key_bias=None):
        calls.append(key_bias)
        return aops.attention_plain(q, k, v, num_heads, None if key_bias is None else key_bias[:, None, None, :])

    monkeypatch.setattr(siglip, "attention", spy)
    rng = np.random.default_rng(2)
    mask = _key_mask(rng, 1, 64, 1)
    for dtype in (torch.bfloat16, torch.float32):
        wq, wk, wv = _projections(rng, 64, dtype)
        x = torch.from_numpy(rng.standard_normal((3, 64, 64), dtype=np.float32)).to(dtype)
        with torch.no_grad():
            siglip.attend(x, x, wq, wk, wv, 4, mask)
        if dtype == torch.bfloat16:
            assert len(calls) == 1 and calls[0].shape == (3, 64) and calls[0].stride() == (0, 1)
            assert torch.equal(calls[0][2], mask[0, 0, 0])
        assert len(calls) == 1
        wq.weight.requires_grad_(True)
        out = siglip.attend(x, x, wq, wk, wv, 4, mask)
        out.float().square().sum().backward()
        assert len(calls) == 1 and wq.weight.grad is not None and bool(wq.weight.grad.abs().sum() > 0)


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports ``cuda:0``: drives the wrapper's CUDA
    branch on a machine without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _fake(x):
    return x.as_subclass(_FakeCuda)


class _Calls(list):
    """The mma.sync entry's recorded argument tuples; ``sm90`` the Hopper
    design's."""

    def __init__(self):
        super().__init__()
        self.sm90 = []


@pytest.fixture()
def recorder(monkeypatch):
    """The wrapper's CUDA branch with a recorder in place of the library:
    returns the list of the mma.sync kernel's recorded argument tuples,
    with the Hopper design's as its ``sm90`` attribute."""
    calls = _Calls()

    def entry(*args):
        calls.append(args)
        return 0

    def entry_sm90(*args):
        calls.sm90.append(args)
        return 0

    real_empty = torch.empty
    monkeypatch.setattr(torch.cuda, "device", lambda dev: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(torch, "empty", lambda *a, device=None, **kw: real_empty(*a, **kw))
    monkeypatch.setattr(_build, "library", lambda: SimpleNamespace(tpuclip_attention=entry,
                                                                    tpuclip_attention_sm90=entry_sm90))
    return calls


def test_the_kernel_is_launched_with_the_tensors_as_they_are(recorder):
    """q, k, v read in place as slices of one (B, S, 3 * width) tensor (row
    stride 3 * width), a key bias shared by the batch (batch stride 0):
    the pointers, strides and scale reach the kernel, one launch counted."""
    b, s, h, hd = 2, 64, 4, 16
    width = h * hd
    qkv = torch.zeros((b, s, 3 * width), dtype=torch.bfloat16)
    q, k, v = (_fake(qkv[..., i * width:(i + 1) * width]) for i in range(3))
    bias = _fake(torch.zeros((1, s)).expand(b, s))
    before = aops.attention.launches
    out = aops.attention(q, k, v, h, bias)
    assert out.shape == (b, s, width) and out.dtype == torch.bfloat16
    assert aops.attention.launches == before + 1 and len(recorder) == 1
    args = recorder[0]
    assert args[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr()) and args[3] == bias.data_ptr()
    assert args[5:17] == (b, s, s, h, hd, s * 3 * width, 3 * width, s * 3 * width, 3 * width,
                          s * 3 * width, 3 * width, 0)
    assert args[17] == 1.0 / math.sqrt(hd) and args[18] == 7
    aops.attention(q, k, v, h)
    assert recorder[1][3] == 0 and recorder[1][16] == 0


@pytest.mark.parametrize("bad", [
    "fp32", "fp16", "hd12", "hd136", "mask_4d", "mask_bf16", "mask_strided", "q_transposed",
    "row_stride", "misaligned", "requires_grad",
])
def test_the_wrapper_refuses_cuda_inputs_it_does_not_take(recorder, bad):
    b, s, h, hd = 2, 64, 4, 16
    dtype = {"fp32": torch.float32, "fp16": torch.float16}.get(bad, torch.bfloat16)
    hd = {"hd12": 12, "hd136": 136}.get(bad, hd)
    width = h * hd
    x = torch.zeros((b, s, width), dtype=dtype)
    q, k, v = x, x.clone(), x.clone()
    bias = torch.zeros((b, s))
    if bad == "mask_4d":
        bias = bias[:, None, None, :]
    elif bad == "mask_bf16":
        bias = bias.to(torch.bfloat16)
    elif bad == "mask_strided":
        bias = torch.zeros((s, b)).t()
    elif bad == "q_transposed":
        q = torch.zeros((b, width, s), dtype=dtype).transpose(1, 2)
    elif bad == "row_stride":
        q = torch.zeros((b, s, width + 4), dtype=dtype)[..., :width]
    elif bad == "misaligned":
        q = torch.zeros(b * s * width + 4, dtype=dtype)[4:].view(b, s, width)
        assert q.data_ptr() % 16
    elif bad == "requires_grad":  # the kernel has no backward
        q = q.clone().requires_grad_(True)
    before = aops.attention.launches
    with pytest.raises((TypeError, ValueError)):
        aops.attention(_fake(q), _fake(k), _fake(v), h, _fake(bias))
    assert not recorder and aops.attention.launches == before


@pytest.mark.parametrize("bad", ["kv_shapes", "heads", "bias_batch"])
def test_the_wrapper_refuses_mismatched_shapes_anywhere(bad):
    x = torch.zeros((2, 8, 16))
    k, h, bias = x, 2, None
    if bad == "kv_shapes":
        k = torch.zeros((2, 8, 8))
    elif bad == "heads":
        h = 3
    else:
        bias = torch.zeros((3, 8))
    with pytest.raises(ValueError):
        aops.attention(x, k, x, h, bias)


# Each caller's launch: (batch, Sq, Sk, heads, head_dim, key bias, the
# design the shape rule gives). The SO400M towers at 384 px (27 layers at
# S 729 and the MAP head's Sq 1), at 224 px and NaFlex (S 256, NaFlex with
# its key bias), the text tower (S 64, padding masked), the B and L presets
# (hd 64), DINOv2-g's layer (hd 64, S 1,374), g and giant-opt at 384 px
# (hd 96, S 576), hd 128, the tiny presets (hd 16), a width the Hopper
# design is not built for, and a key count past its shared memory.
CALLERS = {
    "so400m_384_layer": (2, 729, 729, 16, 72, False, True),
    "so400m_384_map_head": (2, 1, 729, 16, 72, False, False),
    "so400m_224_layer": (2, 256, 256, 16, 72, False, True),
    "naflex_layer": (2, 256, 256, 16, 72, True, True),
    "naflex_map_head": (2, 1, 256, 16, 72, True, False),
    "text": (2, 64, 64, 16, 72, True, False),
    "hd64": (2, 196, 196, 12, 64, False, True),
    "dinov2_layer": (2, 1374, 1374, 24, 64, False, True),
    "hd96_sk576": (2, 576, 576, 16, 96, False, True),
    "hd128": (1, 128, 300, 2, 128, True, True),
    "sq127": (1, 127, 300, 2, 72, True, False),
    "tiny_hd16": (2, 64, 64, 4, 16, True, False),
    "hd80": (2, 256, 256, 2, 80, False, False),
    "sk8192": (1, 64, 8192, 1, 72, False, False),
}


@pytest.mark.parametrize("caller", list(CALLERS))
def test_each_callers_shape_reaches_its_design(recorder, caller):
    """The shape rule on what the wrapper sees: the caller's launch reaches
    the C entry of the design ``takes_sm90`` gives, with the same
    arguments either would take; ``attention.launches`` counts it, and
    ``attention_sm90.launches`` rises with the Hopper design alone."""
    b, sq, sk, h, hd, biased, sm90 = CALLERS[caller]
    assert aops.takes_sm90(sq, sk, hd) == sm90
    width = h * hd
    q = _fake(torch.zeros((b, sq, width), dtype=torch.bfloat16))
    k, v = (_fake(torch.zeros((b, sk, width), dtype=torch.bfloat16)) for _ in range(2))
    bias = _fake(torch.zeros((b, sk))) if biased else None
    before, before_sm90 = aops.attention.launches, aops.attention_sm90.launches
    out = aops.attention(q, k, v, h, bias)
    assert out.shape == (b, sq, width)
    assert aops.attention.launches == before + 1
    assert aops.attention_sm90.launches == before_sm90 + int(sm90)
    taken, other = (recorder.sm90, recorder) if sm90 else (recorder, recorder.sm90)
    assert len(taken) == 1 and not other
    args = taken[0]
    assert args[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
    assert args[3] == (0 if bias is None else bias.data_ptr())
    assert args[5:17] == (b, sq, sk, h, hd, sq * width, width, sk * width, width, sk * width, width,
                          0 if bias is None else sk)
    assert args[17] == 1.0 / math.sqrt(hd) and args[18] == 7


@pytest.mark.parametrize("sq, sk, hd, sm90", [
    (128, 128, 72, True), (127, 128, 72, False), (64, 64, 72, False), (1, 4096, 72, False), (128, 4096, 72, True),
    (128, 4097, 72, False),
    (256, 256, 64, True), (256, 256, 96, True), (256, 256, 128, True), (256, 256, 16, False),
    (256, 256, 32, False), (256, 256, 120, False),
])
def test_the_shape_rule_at_its_edges(sq, sk, hd, sm90):
    """The Hopper design from Sq 128 (its tile's rows) up, at the head
    widths it is built for (64, 72, 96, 128), up to 4096 keys."""
    assert aops.takes_sm90(sq, sk, hd) == sm90


@pytest.mark.parametrize("bad", [
    "fp16", "mask_bf16", "mask_strided", "q_transposed", "row_stride", "misaligned", "requires_grad", "hd136",
])
def test_the_wrapper_refuses_inputs_at_hopper_shapes(recorder, bad):
    """At a shape the rule gives to the Hopper design (the 384 tower's
    layer, with a key bias), the inputs the kernels do not take are
    refused before either entry is reached; no counter moves."""
    b, s, h, hd = 2, 729, 16, 72
    dtype = torch.float16 if bad == "fp16" else torch.bfloat16
    if bad == "hd136":
        h, hd = 2, 136
    width = h * hd
    x = torch.zeros((b, s, width), dtype=dtype)
    q, k, v = x, x.clone(), x.clone()
    bias = torch.zeros((b, s))
    if bad == "mask_bf16":
        bias = bias.to(torch.bfloat16)
    elif bad == "mask_strided":
        bias = torch.zeros((s, b)).t()
    elif bad == "q_transposed":
        q = torch.zeros((b, width, s), dtype=dtype).transpose(1, 2)
    elif bad == "row_stride":
        q = torch.zeros((b, s, width + 4), dtype=dtype)[..., :width]
    elif bad == "misaligned":
        q = torch.zeros(b * s * width + 4, dtype=dtype)[4:].view(b, s, width)
    elif bad == "requires_grad":
        q = q.clone().requires_grad_(True)
    before, before_sm90 = aops.attention.launches, aops.attention_sm90.launches
    with pytest.raises((TypeError, ValueError)):
        aops.attention(_fake(q), _fake(k), _fake(v), h, _fake(bias))
    assert not recorder and not recorder.sm90
    assert (aops.attention.launches, aops.attention_sm90.launches) == (before, before_sm90)


# ============================================================ on the card


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel 9 has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _within_p_rounding(got, q, k, v, h, mask):
    """Whether the kernel's ``got`` is within what rounding P once at bf16
    allows of the plain version. bf16's unit roundoff is 2^-8 (half a step
    just above a power of two). With w the fp32 softmax weights and
    A = w @ |v| per head, each side is within 2^-8 A of the exact weighted
    sum (each weight off by at most 2^-8 of itself) and is then rounded to
    bf16 (2^-8 of itself): |got - plain| <= 2^-7 (A + |plain|). 2^-12 A
    more covers the fp32 logits' other summation order and exp's last bits
    (~1e-4 of a weight at these widths). Returns
    (ok, the largest |got - plain| / A, the share of outputs bit-equal)."""
    b, sq, width = q.shape
    sk, hd = k.shape[1], width // h
    plain = aops.attention_plain(q, k, v, h, mask).float()
    heads = lambda t, s: t.reshape(b, s, h, hd).transpose(1, 2).float()  # noqa: E731
    logits = torch.matmul(heads(q, sq), heads(k, sk).transpose(-1, -2)) * (1.0 / math.sqrt(hd))
    if mask is not None:
        logits = logits + mask
    a = torch.matmul(torch.softmax(logits, dim=-1), heads(v, sk).abs()).transpose(1, 2).reshape(b, sq, width)
    del logits
    diff = (got.float() - plain).abs()
    ok = bool((diff <= 2.0**-7 * (a + plain.abs()) + 2.0**-12 * a).all())
    return ok, float((diff / a.clamp_min(1e-30)).max()), float((diff == 0).float().mean())


CASES = {
    # name: (batch, Sq, Sk, heads, head_dim, mask: None / lowest real keys of a row, fused qkv)
    "cells": (256, 256, 256, 16, 72, None, False),
    "naflex": (256, 256, 256, 16, 72, 243, True),
    "map_head": (256, 1, 256, 16, 72, 243, False),
    "map_head_224": (256, 1, 256, 16, 72, None, False),
    "text": (64, 64, 64, 16, 72, 1, True),
    "hd64": (64, 256, 256, 12, 64, None, False),
    "hd96_sk576": (16, 576, 576, 16, 96, 500, False),
    "sk576": (16, 576, 576, 16, 72, None, True),
    "sk729": (16, 729, 729, 16, 72, 700, False),
    "tiny": (4, 64, 64, 4, 16, 1, False),
    "hd128": (8, 300, 300, 8, 128, 200, False),
    "s729_cell": (64, 729, 729, 16, 72, None, False),
    "s729_fused_bias": (16, 729, 729, 16, 72, 600, True),
    "dinov2_cell": (2, 1374, 1374, 24, 64, None, False),
    "hd64_fused_bias": (4, 700, 700, 8, 64, 600, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_cuda_kernel_matches_plain(cuda_device, case):
    """The cells' launch (B 256, S 256, 16 heads of 72), NaFlex's tail masks
    (243-256 real keys, q / k / v slices of one fused tensor), the MAP
    head's Sq = 1 with and without them, the text tower's Sk = 64 with its
    padding masked (1-64 real tokens), head_dim 64 and 96, Sk 576 and 729
    (several key tiles, a ragged last one), the tiny presets' head_dim 16,
    head_dim 128 (the Hopper design's output tile in its Q buffer), the 384
    cell's launch (B 64, S 729, separate q / k / v) and S 729 from a fused
    qkv with a key bias; DINOv2's launch at head width 64 (24 heads, S
    1,374, separate q / k / v: a ragged 94-row query tile and a ragged
    94-key tile, the only one masked) and hd 64 with a key bias from a fused
    qkv over six key tiles (600-700 real keys), the bias instantiation of
    hd 64's FFMA softmax, which no cell runs. Each runs on the design
    ``takes_sm90`` gives, counted in ``attention_sm90.launches`` where that
    is the Hopper one."""
    b, sq, sk, h, hd, low, fused = CASES[case]
    rng = np.random.default_rng(len(case) * 7 + hd)
    gen = torch.Generator(device=cuda_device).manual_seed(int(rng.integers(2**31)))
    width = h * hd
    if fused:  # sq == sk
        qkv = (torch.randn((b, sk, 3 * width), generator=gen, device=cuda_device) * 1.5).to(torch.bfloat16)
        q, k, v = qkv[..., :width], qkv[..., width:2 * width], qkv[..., 2 * width:]
    else:
        q = (torch.randn((b, sq, width), generator=gen, device=cuda_device) * 1.5).to(torch.bfloat16)
        k = (torch.randn((b, sk, width), generator=gen, device=cuda_device) * 1.5).to(torch.bfloat16)
        v = torch.randn((b, sk, width), generator=gen, device=cuda_device).to(torch.bfloat16)
    mask = None if low is None else _key_mask(rng, b, sk, low).to(cuda_device)
    before, before_sm90 = aops.attention.launches, aops.attention_sm90.launches
    got = aops.attention(q, k, v, h, None if mask is None else mask[:, 0, 0, :])
    torch.cuda.synchronize()
    assert aops.attention.launches == before + 1
    assert aops.attention_sm90.launches == before_sm90 + int(aops.takes_sm90(sq, sk, hd))
    assert got.shape == (b, sq, width) and got.dtype == torch.bfloat16 and got.is_contiguous()
    ok, worst, equal = _within_p_rounding(got, q, k, v, h, mask)
    print(f"[attention] {case}: max |kernel - plain| / (w @ |v|) {worst:.3e}, bit-equal {equal:.4f}")
    assert ok, (case, worst)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["text", "naflex_layer"])
def test_cuda_graph_replay_equals_eager_and_counts(cuda_device, shape):
    """The text tower's shape (16 texts, 64 tokens, padding masked; the
    mma.sync design) and a NaFlex layer's (8 images, 256 patches, 243-256
    real; the Hopper design) as captured programs (``FusedGraphs``): a
    replay equals eager bit for bit and ``attention.launches`` counts each
    replay (the capture's own count is taken back through ``COUNTED``), as
    the query path's graphs need; ``attention_sm90.launches`` alike where
    the rule takes the Hopper design, and not at all where it does not."""
    from tpuclip_torch.ops.graphs import FusedGraphs

    rng = np.random.default_rng(9)
    b, s, h, hd, low = (16, 64, 16, 72, 1) if shape == "text" else (8, 256, 16, 72, 243)
    host = [rng.standard_normal((b, s, h * hd), dtype=np.float32) for _ in range(3)]
    host.append(_key_mask(rng, b, s, low)[:, 0, 0, :].numpy())

    def program(q, k, v, bias):  # bf16 in; the bf16 out widened to f32 exactly, for numpy
        bf = torch.bfloat16
        return (aops.attention(q.to(bf), k.to(bf), v.to(bf), h, bias).float(),)

    def eager():
        return program(*(torch.from_numpy(x).to(cuda_device) for x in host))[0].cpu().numpy()

    sm90 = int(aops.takes_sm90(s, s, hd))
    assert sm90 == (shape != "text")
    want = eager()
    graphs = FusedGraphs(cuda_device)
    before, before_sm90 = aops.attention.launches, aops.attention_sm90.launches
    first = graphs.run(shape, program, host)[0]
    assert aops.attention.launches == before + 2  # the eager warm-up and one replay
    assert aops.attention_sm90.launches == before_sm90 + 2 * sm90
    assert np.array_equal(first, want)
    host[0] = host[0][::-1].copy()
    second = graphs.run(shape, program, host)[0]
    assert aops.attention.launches == before + 3
    assert aops.attention_sm90.launches == before_sm90 + 3 * sm90
    assert np.array_equal(second, eager()) and not np.array_equal(second, first)


@pytest.mark.cuda
@pytest.mark.parametrize("preset, tower", [
    ("google/siglip2-so400m-patch14-224", "vision"), ("google/siglip2-so400m-patch16-naflex", "vision"),
    ("google/siglip2-so400m-patch14-224", "text"), ("google/siglip2-so400m-patch14-384", "vision"),
])
def test_cuda_so400m_tower_with_the_kernel_matches_the_plain_tower(cuda_device, monkeypatch, preset, tower):
    """The SO400M vision tower (27 layers, random weights) on 8 images:
    one launch a layer and one for the MAP head (28 a call), and image
    features with cosine >= 0.999 to the same tower on the plain version
    (NaFlex with 243-256 real patches an image; at 384 px, 729 tokens); the
    text tower on 8 texts of 1-64 tokens, padding masked: one launch a
    layer (27). Every vision layer's launch takes the Hopper design (27 a
    call), the MAP head's Sq = 1 and the text tower's S = 64 the mma.sync
    one."""
    from tpuclip_torch.models.configs import get_config

    cfg = get_config(preset)
    model = siglip.build_model(cfg, cuda_device, torch.bfloat16)
    siglip.init_params_(model, torch.Generator(device=cuda_device).manual_seed(5))
    rng = np.random.default_rng(11)
    b, v = 8, cfg.vision
    launches = v.num_layers + 1
    if tower == "text":
        t = cfg.text
        ids = torch.from_numpy(rng.integers(3, t.vocab_size, (b, t.max_length))).to(cuda_device)
        keep = _key_mask(rng, b, t.max_length, 1)[:, 0, 0, :] == 0
        run = lambda: model.get_text_features(ids, keep.to(torch.int32).to(cuda_device))  # noqa: E731
        launches = t.num_layers
    elif preset.endswith("naflex"):
        p = v.patch_size
        grids = np.array([(16, 16), (13, 19), (15, 17), (12, 21), (14, 18), (9, 27), (11, 23), (10, 25)])
        patches = torch.from_numpy(rng.integers(0, 256, (b, v.num_patches, p * p * 3), dtype=np.uint8)).to(cuda_device)
        real = grids.prod(axis=1)  # 243-256 real patches
        keep = torch.from_numpy((np.arange(v.num_patches)[None] < real[:, None]).astype(np.int32)).to(cuda_device)
        shapes = torch.from_numpy(grids).to(cuda_device)
        run = lambda: model.get_image_features_naflex(patches, keep, shapes)  # noqa: E731
    else:
        side = v.image_size
        pixels = torch.from_numpy(rng.integers(0, 256, (b, side, side, 3), dtype=np.uint8)).to(cuda_device)
        run = lambda: model.get_image_features(pixels)  # noqa: E731
    before, before_sm90 = aops.attention.launches, aops.attention_sm90.launches
    got = run()
    assert aops.attention.launches == before + launches
    assert aops.attention_sm90.launches == before_sm90 + (0 if tower == "text" else 27)
    monkeypatch.setattr(siglip, "attention", lambda q, k, vv, n, bias=None: aops.attention_plain(
        q, k, vv, n, None if bias is None else bias[:, None, None, :]))
    want = run()
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
    print(f"[attention] {preset} {tower}: cosine to the plain tower {float(cos.min()):.6f}-{float(cos.max()):.6f}")
    assert float(cos.min()) >= 0.999
