"""The port's fused patch embedding (tpuclip_torch/ops/patch_embed.py)
against tpuclip's ``patch_embed_fused`` with its Pallas kernel in interpret
mode, on the CPU: the tiny preset's f32 weights and SO400M's patch shape
(K = 588, D = 1152) in bf16, f32 and bf16 out. Inputs come from numpy
seeds. Kernel 8 is compared with its plain version on the card (skipped
without one)."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tpuclip.models import get_config, init_params
from tpuclip.ops import patch_embed as jx
from tpuclip_torch.models.siglip import normalize_pixels
from tpuclip_torch.ops import patch_embed as pt

K, D = 588, 1152  # SO400M-patch14: 14 * 14 * 3 pixels per patch, width 1152


def _bf16_ulp(x):
    """One bf16 step at each |x| (2**-7 of the power of two below it)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0**-126)))
    return 2.0 ** (e - 7)


def test_patch_rows_layout_matches_tpuclip():
    pix = np.random.default_rng(1).integers(0, 256, (2, 28, 42, 3), dtype=np.uint8)
    got = pt.patches_from_images_u8(torch.from_numpy(pix), 14)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jx.patches_from_images_u8(jnp.asarray(pix), 14)))


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_tiny_preset_matches_tpuclip(out_dtype):
    """f32 weights: x is not rounded; sums in f32 (tpuclip) against float64
    (the plain version) differ by a few f32 ulps of values below 10, and so
    by at most one bf16 step in bf16 out."""
    cfg = get_config("tpuclip/test-tiny")
    emb = jax.tree.map(np.array, init_params(jax.random.PRNGKey(0), cfg)["vision"]["embeddings"])
    pix = np.random.default_rng(0).integers(0, 256, (3, 56, 56, 3), dtype=np.uint8)
    rows = np.array(jx.patches_from_images_u8(jnp.asarray(pix), cfg.vision.patch_size))
    want = np.asarray(jx.patch_embed_fused(
        jnp.asarray(rows), jnp.asarray(emb["patch_kernel"]), jnp.asarray(emb["patch_bias"]),
        out_dtype=getattr(jnp, out_dtype), tile_rows=8, interpret=True,
    )).astype(np.float32)
    got = pt.patch_embed_fused(
        torch.from_numpy(rows), torch.from_numpy(emb["patch_kernel"]),
        torch.from_numpy(emb["patch_bias"]), out_dtype=getattr(torch, out_dtype),
    )
    assert got.dtype == getattr(torch, out_dtype) and got.shape == (rows.shape[0], cfg.vision.hidden_size)
    got = got.float().numpy()
    if out_dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        assert (np.abs(got - want) <= _bf16_ulp(want)).all()


def test_dequantise_rounds_twice():
    """x = u * f32(1/127.5) - 1 with each op rounded in f32, then to bf16.
    XLA's CPU backend (tpuclip's interpret mode) contracts the two into one
    fused multiply-add; the two forms part for one pixel value, u = 127,
    whose two-rounding x lies on a bf16 midpoint."""
    u = np.arange(256, dtype=np.uint8)
    two = (u.astype(np.float32) * np.float32(1 / 127.5) - np.float32(1)).astype(ml_dtypes.bfloat16)
    got = pt._dequantise(torch.from_numpy(u), torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got, two.astype(np.float32))
    fused = (u.astype(np.float64) * np.float64(np.float32(1 / 127.5)) - 1).astype(np.float32)
    assert np.flatnonzero(got != fused.astype(ml_dtypes.bfloat16).astype(np.float32)).tolist() == [127]


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_so400m_shape_matches_tpuclip(out_dtype):
    """bf16 weights at K = 588, D = 1152 over 40 rows: every product is
    exact in f32, so f32 out differs only by summation order (values below
    2: within 2e-6), and bf16 out by at most one bf16 step. No pixel is 127,
    the one value whose x XLA's CPU backend rounds otherwise (above)."""
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 256, (40, K), dtype=np.uint8)
    rows[rows == 127] = 128
    w = (rng.standard_normal((K, D)) * 0.02).astype(ml_dtypes.bfloat16)
    b = (rng.standard_normal(D) * 0.02).astype(ml_dtypes.bfloat16)
    want = np.asarray(jx.patch_embed_fused(
        jnp.asarray(rows), jnp.asarray(w), jnp.asarray(b), out_dtype=getattr(jnp, out_dtype),
        interpret=True,
    )).astype(np.float32)
    got = pt.patch_embed_fused(
        torch.from_numpy(rows), torch.from_numpy(w.astype(np.float32)).to(torch.bfloat16),
        torch.from_numpy(b.astype(np.float32)).to(torch.bfloat16), out_dtype=getattr(torch, out_dtype),
    ).float().numpy()
    if out_dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    else:
        assert (np.abs(got - want) <= _bf16_ulp(want)).all()
        assert np.mean(got == want) > 0.99


def test_matches_the_towers_patch_embed():
    """The tower normalises in bf16 and keeps its own GEMM: loosely equal."""
    rng = np.random.default_rng(4)
    pix = torch.from_numpy(rng.integers(0, 256, (2, 28, 28, 3), dtype=np.uint8))
    layer = torch.nn.Linear(K, 64)
    w = layer.weight.detach().t().contiguous().to(torch.bfloat16)
    b = layer.bias.detach().to(torch.bfloat16)
    got = pt.patch_embed_fused(pt.patches_from_images_u8(pix, 14), w, b, out_dtype=torch.float32)
    x = pt.patches_from_images_u8(normalize_pixels(pix, torch.bfloat16), 14)
    tower = torch.nn.functional.linear(x, w.t(), b).float()
    np.testing.assert_allclose(got.numpy(), tower.numpy(), rtol=0, atol=0.05)


def test_exported_and_cpu_takes_the_plain_version(monkeypatch):
    from tpuclip_torch.ops import _build, patch_embed_fused

    assert patch_embed_fused is pt.patch_embed_fused
    monkeypatch.setattr(_build, "library", lambda: pytest.fail("CPU call reached the CUDA library"))
    before = pt.patch_embed_fused.launches
    out = pt.patch_embed_fused(torch.zeros((3, 12), dtype=torch.uint8), torch.ones((12, 8)), torch.zeros(8))
    assert out.dtype == torch.bfloat16 and bool((out == -12).all())
    assert pt.patch_embed_fused.launches == before


@pytest.mark.parametrize("bad", ["float_rows", "k_mismatch", "bias"])
def test_rejects_bad_arguments(bad):
    rows = torch.zeros((3, 12), dtype=torch.uint8)
    w, b = torch.ones((12, 8)), torch.zeros(8)
    with pytest.raises((TypeError, ValueError)):
        if bad == "float_rows":
            pt.patch_embed_fused(rows.float(), w, b)
        elif bad == "k_mismatch":
            pt.patch_embed_fused(rows, w[:10], b)
        else:
            pt.patch_embed_fused(rows, w, b[:4])


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel 8 has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "transposed"])
@pytest.mark.parametrize("rows", [1, 127, 128, 300, 16384])
def test_cuda_kernel_matches_plain(cuda_device, rows, layout):
    """SO400M's patch shape over partial and whole 128-row blocks, with the
    weights row-major as the kernel reads them and an f32 bias, or the
    transposed view of a (D, K) tensor (the tower's layout, which the
    wrapper copies) and a bf16 bias (which the kernel reads as it is)."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.integers(0, 256, (rows, K), dtype=np.uint8)).to(cuda_device)
    w = (torch.from_numpy(rng.standard_normal((K, D)).astype(np.float32)) * 0.02).to(torch.bfloat16)
    b = (torch.from_numpy(rng.standard_normal(D).astype(np.float32)) * 0.02).to(cuda_device)
    if layout == "contiguous":
        w = w.to(cuda_device)
    else:
        w, b = w.t().contiguous().to(cuda_device).t(), b.to(torch.bfloat16)
    assert w.is_contiguous() == (layout == "contiguous")
    got32 = pt.patch_embed_fused(x, w, b, torch.float32)
    want = pt._patch_embed_plain(x, w, b, torch.float32)
    torch.testing.assert_close(got32, want, rtol=0, atol=1e-5)
    # bf16 out is the f32 out rounded: one bf16 step from the plain bf16 out,
    # plus the f32 tolerance where values near zero have a smaller step.
    got = pt.patch_embed_fused(x, w, b)
    assert torch.equal(got, got32.to(torch.bfloat16))
    got = got.float().cpu().numpy()
    want = pt._patch_embed_plain(x, w, b).float().cpu().numpy()
    assert (np.abs(got - want) <= _bf16_ulp(want) + 1e-5).all()


@pytest.mark.cuda
@pytest.mark.parametrize("k, d", [(768, 1152), (192, 1000), (12, 8)])
def test_cuda_kernel_other_patch_widths(cuda_device, k, d):
    """Patch 16 (K = 768: 64-row blocks, the 128-row block's rows no longer
    fit in shared memory), patch 8 with D = 1000 (a partial 192-column
    tile), and a tiny K and D; the patch rows a view 4 bytes into a buffer,
    which the wrapper re-aligns for the kernel's 16-byte loads."""
    rng = np.random.default_rng(8)
    buf = torch.from_numpy(rng.integers(0, 256, 300 * k + 4, dtype=np.uint8)).to(cuda_device)
    x = buf[4:].view(300, k)
    assert x.data_ptr() % 16
    w = torch.from_numpy(rng.standard_normal((k, d)).astype(np.float32) * 0.02).to(torch.bfloat16).to(cuda_device)
    b = torch.from_numpy(rng.standard_normal(d).astype(np.float32) * 0.02).to(cuda_device)
    got = pt.patch_embed_fused(x, w, b, torch.float32)
    torch.testing.assert_close(got, pt._patch_embed_plain(x, w, b, torch.float32), rtol=0, atol=1e-5)
