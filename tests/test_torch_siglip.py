"""Parity of the port's SigLIP towers (tpuclip_torch/models/siglip.py) with
tpuclip's JAX towers on the tiny preset, on the CPU. The JAX parameter tree
(numpy) is carried into the port with ``load_jax_params``; inputs come from
numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuclip.models import siglip as jx
from tpuclip.models.configs import get_config
from tpuclip_torch.models import siglip as pt
from tpuclip_torch.models.configs import get_config as pt_get_config
from tpuclip_torch.models.convert import load_jax_params

MODEL = "tpuclip/test-tiny"
CFG = get_config(MODEL)


@pytest.fixture(scope="module")
def params():
    return jax.tree.map(np.asarray, jx.init_params(jax.random.PRNGKey(0), CFG))


def _port(params, dtype):
    model = pt.build_model(pt_get_config(MODEL), torch.device("cpu"), dtype)
    return load_jax_params(model, params)


def _cast(params, dtype):
    return jax.tree.map(lambda x: jnp.asarray(x, dtype) if x.dtype == np.float32 else x, params)


def _pixels(n=3):
    s = CFG.vision.image_size
    return np.random.default_rng(1).integers(0, 256, (n, s, s, 3), dtype=np.uint8)


def _tokens(n=3):
    rng = np.random.default_rng(2)
    ids = rng.integers(1, CFG.text.vocab_size, (n, CFG.text.max_length))
    mask = np.ones_like(ids, dtype=np.int32)
    for i, length in enumerate([5, 17, 64][:n]):
        ids[i, length:] = 0
        mask[i, length:] = 0
    return ids, mask


def _cos(a, b):
    return np.sum(a * b, axis=-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def test_image_features_fp32(params):
    px = _pixels()
    want = np.asarray(jx.get_image_features(params, jnp.asarray(px), CFG))
    got = _port(params, torch.float32).get_image_features(torch.from_numpy(px)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert _cos(got, want).min() >= 0.99999
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)


def test_text_features_fp32_padded_and_masked(params):
    ids, mask = _tokens()
    want = np.asarray(jx.get_text_features(
        params, jnp.asarray(ids), CFG, attention_mask=jnp.asarray(mask)
    ))
    got = _port(params, torch.float32).get_text_features(
        torch.from_numpy(ids), torch.from_numpy(mask)
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert _cos(got, want).min() >= 0.99999
    unmasked = _port(params, torch.float32).get_text_features(torch.from_numpy(ids)).numpy()
    assert np.abs(unmasked - got).max() > 1e-3  # the mask matters


@pytest.mark.parametrize("tower", ["image", "text"])
def test_features_bf16(params, tower):
    model = _port(params, torch.bfloat16)
    pj = _cast(params, jnp.bfloat16)
    if tower == "image":
        px = _pixels()
        want = jx.get_image_features(pj, jnp.asarray(px), CFG, compute_dtype=jnp.bfloat16)
        got = model.get_image_features(torch.from_numpy(px))
    else:
        ids, mask = _tokens()
        want = jx.get_text_features(
            pj, jnp.asarray(ids), CFG, compute_dtype=jnp.bfloat16,
            attention_mask=jnp.asarray(mask),
        )
        got = model.get_text_features(torch.from_numpy(ids), torch.from_numpy(mask))
    assert got.dtype == torch.float32
    assert _cos(got.numpy(), np.asarray(want)).min() >= 0.999


def test_layer_norm(params):
    x = np.random.default_rng(3).standard_normal((2, 7, 64)).astype(np.float32)
    p = params["vision"]["post_ln"]
    scale = p["scale"] + 0.1
    want = jx.layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(p["bias"]), 1e-6)
    got = pt.layer_norm(torch.from_numpy(x), torch.tensor(scale), torch.tensor(p["bias"]), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_masked_mha(params):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    keep = np.ones((2, 9), np.float32)
    keep[0, 4:] = 0
    mask4d = ((1.0 - keep) * np.finfo(np.float32).min)[:, None, None, :]
    layer = jax.tree.map(lambda a: a[0], params["text"]["encoder"])
    want = jx.mha(jnp.asarray(x), jnp.asarray(x), layer, 4, mask=jnp.asarray(mask4d))
    attn = _port(params, torch.float32).text.encoder.layers[0].attn
    got = attn(torch.from_numpy(x), torch.from_numpy(x), torch.from_numpy(mask4d))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_map_head_and_patch_embed(params):
    rng = np.random.default_rng(5)
    hidden = rng.standard_normal((2, CFG.vision.num_patches, 64)).astype(np.float32)
    want = jx.map_head(jnp.asarray(hidden), params["vision"]["head"], CFG.vision)
    model = _port(params, torch.float32)
    got = model.vision.head(torch.from_numpy(hidden))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)

    px = _pixels(2)
    x = jx.normalize_pixels(jnp.asarray(px), jnp.float32)
    want = jx.patch_embed(x, params["vision"]["embeddings"], CFG.vision)
    got = model.vision.patch_embed(pt.normalize_pixels(torch.from_numpy(px), torch.float32))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_normalize_pixels_bf16_bit_equal():
    px = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1)
    want = jx.normalize_pixels(jnp.asarray(px), jnp.bfloat16).astype(jnp.float32)
    got = pt.normalize_pixels(torch.from_numpy(px), torch.bfloat16).float()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
