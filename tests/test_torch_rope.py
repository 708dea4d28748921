"""DINOv3's 2-D rotary position on the patch rows of q and k
(``tpuclip_torch/ops/rope.py``, kernel 12).

On the CPU: the plain version against a direct transcription of HF's
``apply_rotary_pos_emb`` (its tiled table, ``rotate_half``, the prefix rows
split off and put back), bit for bit in fp32 and rounded once in bf16; the
prefix rows untouched; its gradients; the wrapper on CPU tensors is the
plain version and launches nothing; the wrapper refuses what the kernel
does not take; its CUDA branch passes q and k in place with the tables and
counts one launch (tensors that report a CUDA device, a recorder in place
of the library). On a CUDA card (``cuda`` marker): the kernel bit-equal to
the plain version at the DINOv3 cell's launch and at other head widths,
the prefix rows untouched, and a graph replay.
"""

from contextlib import nullcontext
from types import SimpleNamespace

import pytest
import torch

from tpuclip_torch.models import dinov3
from tpuclip_torch.ops import _build
from tpuclip_torch.ops import rope as rops


def _table(n_h, n_w, hd):
    cfg = dinov3.Dinov3VisionConfig(hidden_size=hd, num_layers=1, num_heads=1, intermediate_size=8)
    angles = dinov3.rope_angles(cfg, n_h, n_w)
    return torch.cos(angles), torch.sin(angles)


def _qk(b, s, d, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return tuple((torch.randn((b, s, d), generator=g) * 2).to(dtype) for _ in range(2))


def _hf_rotate_half(x):
    x1 = x[..., : x.shape[-1] // 2]
    x2 = x[..., x.shape[-1] // 2 :]
    return torch.cat((-x2, x1), dim=-1)


def _hf_apply_rotary_pos_emb(q, k, cos, sin):
    """HF's ``DINOv3ViT`` ``apply_rotary_pos_emb`` as written, on (B, heads,
    S, hd) q and k and the (P, hd) tiled table."""
    num_tokens = q.shape[-2]
    num_patches = sin.shape[-2]
    num_prefix_tokens = num_tokens - num_patches
    q_prefix_tokens, q_patches = q.split((num_prefix_tokens, num_patches), dim=-2)
    k_prefix_tokens, k_patches = k.split((num_prefix_tokens, num_patches), dim=-2)
    q_patches = (q_patches * cos) + (_hf_rotate_half(q_patches) * sin)
    k_patches = (k_patches * cos) + (_hf_rotate_half(k_patches) * sin)
    q = torch.cat((q_prefix_tokens, q_patches), dim=-2)
    k = torch.cat((k_prefix_tokens, k_patches), dim=-2)
    return q, k


def _hf_route(q, k, cos, sin, heads):
    """(B, S, D) through HF's heads layout and back, in fp32."""
    b, s, d = q.shape
    split = lambda x: x.float().view(b, s, heads, d // heads).transpose(1, 2)  # noqa: E731
    hq, hk = _hf_apply_rotary_pos_emb(split(q), split(k), cos.tile(2), sin.tile(2))
    join = lambda x: x.transpose(1, 2).reshape(b, s, d)  # noqa: E731
    return join(hq), join(hk)


@pytest.mark.parametrize("heads, hd, grid, prefix", [(4, 32, (4, 4), 3), (2, 64, (3, 5), 5), (2, 128, (6, 6), 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_is_hfs_rotation(dtype, heads, hd, grid, prefix):
    """fp32: HF's form bit for bit; bf16: HF's form on the upcast values,
    rounded once (HF itself would round cos and sin to bf16 first). The
    prefix rows come back as they went in, and the wrapper on CPU tensors
    is the plain version, with no launch counted."""
    cos, sin = _table(*grid, hd)
    s = prefix + grid[0] * grid[1]
    q, k = _qk(3, s, heads * hd, dtype, seed=hd + prefix)
    want_q, want_k = (t.to(dtype) for t in _hf_route(q, k, cos, sin, heads))
    before = rops.rope.launches
    for fn in (rops.rope_plain, rops.rope):
        got_q, got_k = fn(q, k, cos, sin, heads, prefix)
        assert got_q.dtype == dtype and torch.equal(got_q, want_q) and torch.equal(got_k, want_k), fn.__name__
        assert torch.equal(got_q[:, :prefix], q[:, :prefix]) and torch.equal(got_k[:, :prefix], k[:, :prefix])
    assert rops.rope.launches == before
    assert not torch.equal(want_q[:, prefix:], q[:, prefix:])


def test_the_rotation_keeps_each_pairs_length_and_turns_by_the_table():
    """Each pair (j, j + hd/2) of a head keeps its length, and its angle
    moves by the table's: the rotation of a unit pair (1, 0) is (cos, sin)."""
    cos, sin = _table(2, 3, 32)
    q = torch.zeros(1, 1 + 6, 32, dtype=torch.float64)
    q[:, :, 0] = 1.0
    got, _ = rops.rope_plain(q, q, cos, sin, 1, 1)
    assert torch.allclose(got[0, 1:, 0], cos[:, 0].double()) and torch.allclose(got[0, 1:, 16], sin[:, 0].double())
    x, _ = _qk(2, 7, 64, torch.float64, seed=3)
    rot, _ = rops.rope_plain(x, x, cos, sin, 2, 1)
    pair = lambda t: t[:, 1:].reshape(2, 6, 2, 2, 16).pow(2).sum(dim=3)  # noqa: E731
    assert torch.allclose(pair(rot), pair(x))


def test_plain_is_differentiable():
    cos, sin = _table(2, 2, 16)
    q, k = (t.requires_grad_(True) for t in _qk(1, 6, 32, torch.float64, seed=4))
    assert torch.autograd.gradcheck(lambda a, b: rops.rope_plain(a, b, cos, sin, 2, 2), (q, k))


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports ``cuda:0``: drives the CUDA branch on a
    machine without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _fake(x):
    return x.as_subclass(_FakeCuda)


@pytest.fixture()
def recorder(monkeypatch):
    """The wrapper's CUDA branch with a recorder in place of the library."""
    calls = []
    monkeypatch.setattr(torch.cuda, "device", lambda dev: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(_build, "library", lambda: SimpleNamespace(
        tpuclip_rope2d=lambda *args: calls.append(args) or 0))
    return calls


def test_the_kernel_is_launched_on_q_and_k_in_place(recorder):
    """One launch for q and k together: their pointers, the tables', B, S,
    the prefix, D, the head width and the stream; q and k are returned
    themselves, rotated in place; fp32 on CUDA is refused."""
    cos, sin = (_fake(t) for t in _table(4, 4, 32))
    q, k = (_fake(t) for t in _qk(2, 19, 128, torch.bfloat16, seed=5))
    before = rops.rope.launches
    got_q, got_k = rops.rope(q, k, cos, sin, 4, 3)
    assert got_q is q and got_k is k and rops.rope.launches == before + 1
    assert recorder == [(q.data_ptr(), k.data_ptr(), cos.data_ptr(), sin.data_ptr(), 2, 19, 3, 128, 32, 7)]
    with pytest.raises(TypeError):
        rops.rope(_fake(q.float()), _fake(k.float()), cos, sin, 4, 3)
    assert rops.rope.launches == before + 1


def _bad(name):
    cos, sin = _table(4, 4, 32)
    q, k = _qk(2, 19, 128, torch.bfloat16, seed=6)
    args = {"q": q, "k": k, "cos": cos, "sin": sin, "heads": 4, "prefix": 3}
    change = {
        "k_shape": {"k": k[:, :18]},
        "k_dtype": {"k": k.float()},
        "head_width_not_multiple_of_16": {"heads": 16},
        "heads_do_not_divide": {"heads": 3},
        "no_patch_row": {"prefix": 19},
        "negative_prefix": {"prefix": -1},
        "table_rows": {"cos": cos[:15]},
        "table_width": {"sin": _table(4, 4, 64)[1]},
        "table_dtype": {"cos": cos.double()},
        "not_contiguous": {"q": q.transpose(0, 1).contiguous().transpose(0, 1)},
        "needs_grad": {"q": q.float().requires_grad_(True), "k": k.float()},
        "two_dims": {"q": q[0], "k": k[0]},
    }[name]
    return {**args, **change}


BAD = ["k_shape", "k_dtype", "head_width_not_multiple_of_16", "heads_do_not_divide", "no_patch_row",
       "negative_prefix", "table_rows", "table_width", "table_dtype", "not_contiguous", "needs_grad", "two_dims"]


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("bad", BAD)
def test_the_wrapper_refuses_what_the_kernel_does_not_take(recorder, device, bad):
    args = _bad(bad)
    if device == "cuda":
        args = {n: _fake(t) if isinstance(t, torch.Tensor) else t for n, t in args.items()}
    before = rops.rope.launches
    with pytest.raises(ValueError):
        rops.rope(args["q"], args["k"], args["cos"], args["sin"], args["heads"], args["prefix"])
    assert not recorder and rops.rope.launches == before


def test_the_tower_routes_the_rotation_on_what_the_inputs_show(monkeypatch):
    """bf16 on CUDA with no gradient goes to the kernel's wrapper; the CPU,
    fp32 and anything autograd must differentiate to the plain version."""
    calls = []
    monkeypatch.setattr(dinov3, "rope", lambda *a: calls.append(a) or rops.rope_plain(*a))
    cos, sin = _table(4, 4, 32)
    q, k = _qk(1, 19, 128, torch.bfloat16, seed=7)
    with torch.no_grad():
        dinov3.rotate(_fake(q), _fake(k), cos, sin, 4, 3)
        dinov3.rotate(q, k, cos, sin, 4, 3)
        dinov3.rotate(_fake(q.float()), _fake(k.float()), cos, sin, 4, 3)
    assert len(calls) == 1
    dinov3.rotate(_fake(q.clone().requires_grad_(True)), _fake(k), cos, sin, 4, 3)
    assert len(calls) == 1


# ============================================================ on the card


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel 12 has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b, heads, hd, grid, prefix", [
    (16, 32, 128, (32, 32), 5),  # the DINOv3-7B cell's launch: 16 images of 1,029 tokens
    (3, 4, 32, (4, 4), 3), (2, 4, 64, (8, 8), 5), (4, 4, 128, (3, 7), 5),
])
def test_cuda_kernel_is_bit_equal_to_plain(cuda_device, b, heads, hd, grid, prefix):
    """Both round each product and the sum to fp32 on their own and the
    result once to bf16: bit-equal. q and k are rotated in place, their
    prefix rows left as they were; one launch."""
    cos, sin = (t.to(cuda_device) for t in _table(*grid, hd))
    s = prefix + grid[0] * grid[1]
    q, k = (t.to(cuda_device) for t in _qk(b, s, heads * hd, torch.bfloat16, seed=hd + b))
    want_q, want_k = rops.rope_plain(q, k, cos, sin, heads, prefix)
    q0, k0 = q.clone(), k.clone()
    before = rops.rope.launches
    got_q, got_k = rops.rope(q, k, cos, sin, heads, prefix)
    torch.cuda.synchronize()
    assert rops.rope.launches == before + 1 and got_q is q and got_k is k
    assert torch.equal(got_q, want_q) and torch.equal(got_k, want_k)
    assert torch.equal(q[:, :prefix], q0[:, :prefix]) and torch.equal(k[:, :prefix], k0[:, :prefix])


@pytest.mark.cuda
def test_cuda_graph_replay_rotates_as_eager(cuda_device):
    cos, sin = (t.to(cuda_device) for t in _table(4, 4, 64))
    q, k = (t.to(cuda_device) for t in _qk(2, 21, 256, torch.bfloat16, seed=9))
    want_q, want_k = rops.rope_plain(q, k, cos, sin, 4, 5)
    static_q, static_k = torch.empty_like(q), torch.empty_like(k)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        rops.rope(static_q, static_k, cos, sin, 4, 5)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        rops.rope(static_q, static_k, cos, sin, 4, 5)
    static_q.copy_(q)
    static_k.copy_(k)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(static_q, want_q) and torch.equal(static_k, want_k)
