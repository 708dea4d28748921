"""The port's NaFlex towers (``tpuclip_torch/models/naflex.py``) and every
entry point that serves them, against tpuclip's, on the CPU in fp32 with the
tiny preset ``tpuclip/test-tiny-naflex`` (patch 8, 64 patches: an 8 x 8
position grid).

- ``resize_position_embeddings`` against tpuclip's and against a per-image
  antialiased ``F.interpolate`` (within 1e-6; measured 2.4e-7);
- ``get_image_features_naflex`` against tpuclip's on a mixed-aspect batch
  with pad rows (within 1e-5; measured 1.5e-7), against HF's
  ``Siglip2VisionModel`` with random init (cosine >= 0.9999), and
  invariant to the pad rows;
- ``SiglipModel.image_features`` on both tiny presets: the named entry
  of the model's format, bit for bit, and a replacement set on the
  instance;
- ``query_topk_fused`` on NaFlex image and mixed blocks against tpuclip's
  NaFlex image and mixed fused programs with ``use_pallas=False``
  (identical ids, scores within 1e-5) and bit-equal to the port's own
  two-stage route;
- a mixed-aspect tree scanned by the port into ONE database that both
  packages open: stored rows, text and image searches, the engine's fused
  entry points, ``search --image``, the session's ``image:`` line and the
  HTTP server against tpuclip's; ``warm_programs``' count, ``classify``'s
  refusal and ``_get_image_embeddings_batch`` against tpuclip's;
- on a CUDA card (``cuda`` marker): NaFlex graph replay against eager, and
  a refresh after a new row dropping the graphs."""

import base64
import dataclasses
import importlib
import json
import shutil
import sqlite3
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

import tpuclip.cli as jx_cli
import tpuclip.engine as jx_engine
import tpuclip.ops.topk_int8 as jx_ops
import tpuclip.serve as jx_serve
import tpuclip_torch.cli as pt_cli
import tpuclip_torch.engine as pt_engine
import tpuclip_torch.ops.topk_int8 as pt_ops
import tpuclip_torch.serve as pt_serve
from tpuclip.io.preprocess import preprocess_naflex
from tpuclip.models import naflex as jx_naflex
from tpuclip.models.checkpoint import save_checkpoint
from tpuclip.models.configs import get_config
from tpuclip.models.convert import params_from_state_dict as jx_params_from_state_dict
from tpuclip.models.siglip import init_params
from tpuclip.pipelines.classify import classify_image as jx_classify_image
from tpuclip_torch.models import naflex as pt_naflex
from tpuclip_torch.models.configs import config_from_hf_dict
from tpuclip_torch.models.configs import get_config as pt_get_config
from tpuclip_torch.models.convert import load_jax_params, params_from_state_dict
from tpuclip_torch.models.loader import load_model
from tpuclip_torch.models.siglip import build_model
from tpuclip_torch.pipelines.classify import classify_image as pt_classify_image

MODEL = "tpuclip/test-tiny-naflex"
CFG = get_config(MODEL)
PATCH, LENGTH = CFG.vision.patch_size, CFG.vision.max_num_patches
K = 5
TEXTS = ["a wide photo", "a tall photo", "noise", "a small square"]
ENV = {"TPUCLIP_SEARCH_PRECISION": "int8", "TPUCLIP_DEVICE_RERANK": "1", "TPUCLIP_SEARCH_MODE": "exact"}
# (height, width) of the tree's images: the six aspect families, two each.
SIZES = [(30, 90), (96, 32), (48, 48), (16, 128), (128, 16), (40, 56)] * 2


def _params(seed=3):
    return jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(seed), CFG))


def _port(params, dtype=torch.float32):
    return load_jax_params(build_model(pt_get_config(MODEL), torch.device("cpu"), dtype), params)


def _images(sizes, seed=5):
    rng = np.random.default_rng(seed)
    return [Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)) for h, w in sizes]


def _batch(images, rows):
    """tpuclip's patchify of ``images`` padded to ``rows``: pad rows keep
    slot 0 on a (1, 1) grid."""
    patches = np.zeros((rows, LENGTH, PATCH * PATCH * 3), np.uint8)
    masks = np.zeros((rows, LENGTH), np.int32)
    masks[:, 0] = 1
    shapes = np.ones((rows, 2), np.int32)
    for i, img in enumerate(images):
        patches[i], masks[i], shapes[i] = preprocess_naflex(img, PATCH, LENGTH)
    return patches, masks, shapes


def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


# ------------------------------------------------------------------ tower


def _interpolate(grid, h, w):
    """HF's resize of an (S, S, D) grid to (h, w): antialiased bilinear
    ``F.interpolate``, rows then columns. One 2-D call gives the same where
    w > 1; with w = 1 and h != S, PyTorch's CPU kernel returns one value for
    the whole column (its vertical pass over a width-1 input), so the two
    passes are the reference there."""
    x = torch.from_numpy(grid).permute(2, 0, 1)[None]
    kw = dict(mode="bilinear", align_corners=False, antialias=True)
    out = F.interpolate(F.interpolate(x, size=(h, grid.shape[1]), **kw), size=(h, w), **kw)
    if w > 1:
        torch.testing.assert_close(F.interpolate(x, size=(h, w), **kw), out, rtol=0, atol=1e-6)
    return out[0].reshape(grid.shape[2], h * w).T.numpy()


@pytest.mark.parametrize("h,w", [(1, 1), (1, 64), (64, 1), (3, 21), (8, 8), (5, 7), (12, 3)])
def test_resize_position_embeddings(h, w):
    grid = np.random.default_rng(7).standard_normal((8, 8, 16)).astype(np.float32)
    shapes = np.array([[h, w], [2, 3]], np.int32)  # a second image: the batch is one contraction
    got = pt_naflex.resize_position_embeddings(torch.from_numpy(grid), torch.from_numpy(shapes), LENGTH).numpy()
    want = np.asarray(jx_naflex.resize_position_embeddings(jnp.asarray(grid), jnp.asarray(shapes), LENGTH))
    assert got.shape == (2, LENGTH, 16) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[0, : h * w], _interpolate(grid, h, w), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[0, h * w :], np.broadcast_to(got[0, 0], (LENGTH - h * w, 16)))


def test_axis_weights_rows_sum_to_one():
    dst = torch.tensor([[1], [3], [8], [64]])
    idx = torch.arange(64).expand(4, 64) % dst
    w = pt_naflex._axis_weights(8, dst, idx)
    want = np.stack([np.asarray(jx_naflex._axis_weights(8, jnp.asarray(int(d)), jnp.asarray(i.numpy())))
                     for d, i in zip(dst[:, 0], idx)])
    assert w.shape == (4, 64, 8)
    np.testing.assert_allclose(w.numpy(), want, rtol=0, atol=1e-7)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def towers():
    params = _params(0)
    return params, _port(params)


def test_tower_matches_tpuclip_with_pad_rows(towers):
    params, model = towers
    patches, masks, shapes = _batch(_images(SIZES[:6]), 8)
    got = model.get_image_features_naflex(*map(torch.from_numpy, (patches, masks, shapes))).numpy()
    want = np.asarray(jx_naflex.get_image_features_naflex(
        params, jnp.asarray(patches), jnp.asarray(masks), jnp.asarray(shapes), CFG))
    assert got.shape == (8, CFG.embedding_dim) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)  # measured 1.5e-7
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)
    # The MAP head's mask: without it the pad slots leak into the pooled row.
    unmasked = torch.from_numpy(np.ones_like(masks))
    leaked = model.get_image_features_naflex(torch.from_numpy(patches), unmasked, torch.from_numpy(shapes))
    assert np.abs(leaked.numpy()[:6] - got[:6]).max() > 1e-3


def test_tower_bf16_matches_tpuclip_bf16(towers):
    """Both towers in bf16 (tpuclip's parameters cast to bf16, as its engine
    does): the BASELINE bar, cosine >= 0.999."""
    params, _ = towers
    patches, masks, shapes = _batch(_images(SIZES[:6]), 6)
    got = _port(params, torch.bfloat16).get_image_features_naflex(
        *map(torch.from_numpy, (patches, masks, shapes))).numpy()
    pj = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16) if x.dtype == np.float32 else x, params)
    want = np.asarray(jx_naflex.get_image_features_naflex(
        pj, jnp.asarray(patches), jnp.asarray(masks), jnp.asarray(shapes), CFG, compute_dtype=jnp.bfloat16))
    assert got.dtype == np.float32
    assert _cos(got, want).min() >= 0.999


@pytest.mark.parametrize("rows", [4, 16])
def test_tower_invariant_to_pad_rows(towers, rows):
    _, model = towers
    images = _images(SIZES[:3], seed=6)
    full = model.get_image_features_naflex(*map(torch.from_numpy, _batch(images, rows))).numpy()
    for i, img in enumerate(images):
        solo = model.get_image_features_naflex(*map(torch.from_numpy, _batch([img], 1))).numpy()
        np.testing.assert_allclose(full[i], solo[0], rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def hf_siglip2(tmp_path_factory):
    """A random-init HF ``Siglip2Model`` at the tiny preset's widths, and
    the directory it was saved to (config.json + model.safetensors)."""
    transformers = pytest.importorskip("transformers")
    pytest.importorskip("transformers.models.siglip2")
    v, t = CFG.vision, CFG.text
    hf_cfg = transformers.Siglip2Config(
        text_config=dict(vocab_size=t.vocab_size, hidden_size=t.hidden_size,
                         intermediate_size=t.intermediate_size, num_hidden_layers=t.num_layers,
                         num_attention_heads=t.num_heads, max_position_embeddings=t.max_length,
                         projection_size=t.projection_size),
        vision_config=dict(hidden_size=v.hidden_size, intermediate_size=v.intermediate_size,
                           num_hidden_layers=v.num_layers, num_attention_heads=v.num_heads,
                           patch_size=PATCH, num_patches=LENGTH),
    )
    torch.manual_seed(0)
    hf = transformers.Siglip2Model(hf_cfg).eval()
    path = tmp_path_factory.mktemp("hf_siglip2") / MODEL.replace("/", "--")
    hf.save_pretrained(str(path))
    return hf, path


def test_tower_matches_hf_siglip2(hf_siglip2):
    """The port's tower on HF's weights (through ``params_from_state_dict``)
    against HF's ``Siglip2VisionTransformer`` (what ``Siglip2VisionModel``
    wraps) on tpuclip's patchify, fed to HF normalised."""
    hf, path = hf_siglip2
    sd = {k: v.detach().float().numpy() for k, v in hf.state_dict().items()}
    cfg = config_from_hf_dict(MODEL, json.loads((path / "config.json").read_text()))
    assert cfg.vision.naflex and dataclasses.asdict(cfg.vision) == dataclasses.asdict(pt_get_config(MODEL).vision)
    params = params_from_state_dict(sd, cfg)
    model = load_jax_params(build_model(cfg, torch.device("cpu"), torch.float32), params)
    patches, masks, shapes = _batch(_images(SIZES[:6]), 6)
    with torch.no_grad():
        ref = hf.vision_model(
            pixel_values=torch.from_numpy(patches.astype(np.float32) / 127.5 - 1.0),
            attention_mask=torch.from_numpy(masks),
            spatial_shapes=torch.from_numpy(shapes).long(),
        ).pooler_output.numpy()
    got = model.get_image_features_naflex(*map(torch.from_numpy, (patches, masks, shapes))).numpy()
    assert _cos(got, ref).min() >= 0.9999
    # tpuclip's reading of the same state dict is the same tree.
    want = jx_params_from_state_dict(sd, get_config(MODEL))
    np.testing.assert_array_equal(params["vision"]["embeddings"]["patch_kernel"],
                                  want["vision"]["embeddings"]["patch_kernel"])


def test_hf_layout_directory_loads(hf_siglip2, towers):
    """``load_model`` on an HF-layout NaFlex directory: the NaFlex tower on
    HF's weights, equal to the same state dict carried in by hand."""
    hf, path = hf_siglip2
    cfg, model = load_model(MODEL, str(path.parent), device="cpu")
    assert cfg.vision.naflex
    sd = {k: v.detach().float().numpy() for k, v in hf.state_dict().items()}
    by_hand = load_jax_params(build_model(cfg, torch.device("cpu"), torch.float32), params_from_state_dict(sd, cfg))
    inputs = list(map(torch.from_numpy, _batch(_images(SIZES[:4]), 4)))
    np.testing.assert_array_equal(model.get_image_features_naflex(*inputs).numpy(),
                                  by_hand.get_image_features_naflex(*inputs).numpy())


def test_random_init_of_naflex_presets():
    """``TPUCLIP_INIT=random`` builds the NaFlex tower: a (P*P*3 -> D) patch
    Linear and an (L, D) position table, seeded."""
    cfg, a = load_model(MODEL, None, device="cpu", allow_random=True, seed=2)
    _, b = load_model(MODEL, None, device="cpu", allow_random=True, seed=2)
    assert a.vision.patch.weight.shape == (cfg.vision.hidden_size, PATCH * PATCH * 3)
    assert a.vision.pos_embed.shape == (LENGTH, cfg.vision.hidden_size)
    inputs = list(map(torch.from_numpy, _batch(_images(SIZES[:2]), 2)))
    out = a.get_image_features_naflex(*inputs)
    assert torch.equal(out, b.get_image_features_naflex(*inputs)) and torch.isfinite(out).all()


@pytest.mark.parametrize("model_name", ["tpuclip/test-tiny", MODEL])
def test_image_features_takes_the_models_format(model_name):
    """``image_features`` is the named entry of the model's input format,
    bit for bit, and calls a replacement of that entry set on the
    instance."""
    cfg, model = load_model(model_name, None, device="cpu", allow_random=True, seed=4)
    if cfg.vision.naflex:
        name, inputs = "get_image_features_naflex", _batch(_images(SIZES[:3]), 4)
    else:
        size = cfg.vision.image_size
        name = "get_image_features"
        inputs = (np.random.default_rng(6).integers(0, 256, (3, size, size, 3), dtype=np.uint8),)
    inputs = [torch.from_numpy(x) for x in inputs]
    want = getattr(model, name)(*inputs)
    assert torch.equal(model.image_features(*inputs), want) and torch.isfinite(want).all()
    calls = []
    setattr(model, name, lambda *args: calls.append(args) or want[:1])
    assert torch.equal(model.image_features(*inputs), want[:1])
    assert len(calls) == 1 and all(a is b for a, b in zip(calls[0], inputs))


# ---------------------------------------------------------------- database


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(tmp, model cache, image root, db, tpuclip engine, port engine, ref
    db): the mixed-aspect tree scanned by the PORT into ``db``, which
    tpuclip's engine opens too, and by tpuclip into ``ref db``."""
    tmp = tmp_path_factory.mktemp("naflex")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPUCLIP_HOME", str(tmp / "home"))
        for key, value in ENV.items():
            mp.setenv(key, value)
        mp.delenv("TPUCLIP_SHORTLIST", raising=False)
        cache = tmp / "models"
        save_checkpoint(str(cache / MODEL.replace("/", "--")), _params(3), CFG)
        root = tmp / "imgs"
        for i, img in enumerate(_images(SIZES, seed=21)):
            folder = root / ("a" if i < 6 else "b")
            folder.mkdir(parents=True, exist_ok=True)
            img.save(folder / f"img_{i:02d}.png")
        shutil.copyfile(root / "a" / "img_00.png", root / "b" / "copy_of_00.png")
        db, ref = str(tmp / "one.db"), str(tmp / "ref.db")
        eng_t = pt_engine.ImageDatabase(db, str(cache), model_name=MODEL, inference_batch_size=4, device="cpu")
        eng_t.scan_directory(str(root), inference_batch_size=4)
        eng_j = jx_engine.ImageDatabase(db, str(cache), model_name=MODEL, inference_batch_size=4)
        jx_engine.ImageDatabase(ref, str(cache), model_name=MODEL, inference_batch_size=4).scan_directory(
            str(root), inference_batch_size=4)
        eng_j.index.refresh()
        eng_t.index.refresh()
        yield tmp, cache, root, db, eng_j, eng_t, ref


@pytest.fixture()
def env(world, monkeypatch):
    monkeypatch.setenv("TPUCLIP_HOME", str(world[0] / "home"))
    for key, value in ENV.items():
        monkeypatch.setenv(key, value)
    monkeypatch.delenv("TPUCLIP_SHORTLIST", raising=False)
    return world


def _stored(db):
    conn = sqlite3.connect(db)
    rows = conn.execute(
        "SELECT i.file_path, e.vector FROM images i JOIN embeddings e ON e.image_id = i.id"
    ).fetchall()
    conn.close()
    return {p: np.frombuffer(blob, np.float32) for p, blob in rows}


def test_port_scan_matches_tpuclip_scan(env):
    *_, eng_t, ref = env
    got, want = _stored(env[3]), _stored(ref)
    assert sorted(got) == sorted(want) and len(got) == len(SIZES) + 1
    for path, vec in got.items():
        np.testing.assert_allclose(vec, want[path], rtol=0, atol=1e-5, err_msg=path)
        assert abs(np.linalg.norm(vec) - 1.0) <= 1e-5
    # The batch path (padded final batch of the scan's shape) against the
    # single-image path.
    solo = eng_t._get_image_embedding(str(env[2] / "a" / "img_03.png"))
    np.testing.assert_allclose(got[str(env[2] / "a" / "img_03.png")], solo, rtol=0, atol=1e-5)


def _same(got, want, tol=1e-5):
    assert len(got) == len(want) > 0
    assert [p for p, _ in got] == [p for p, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want], rtol=0, atol=tol)


def test_text_and_image_search_match_tpuclip(env):
    tmp, cache, root, db, eng_j, eng_t, _ = env
    for q in TEXTS:
        _same(eng_t.search(q, k=K), eng_j.search(q, k=K))
    query = str(root / "b" / "img_09.png")
    got = eng_t.search(query, k=K, is_image_path=True)
    _same(got, eng_j.search(query, k=K, is_image_path=True))
    assert got[0][0] == query and got[0][1] > 0.99
    imgs = [Image.open(root / "a" / f"img_0{i}.png") for i in range(4)]
    np.testing.assert_allclose(eng_t.embed_pils(imgs), eng_j.embed_pils(imgs), rtol=0, atol=1e-5)


def test_engine_fused_entry_points_match_tpuclip(env):
    tmp, cache, root, db, eng_j, eng_t, _ = env
    eng_t.index._graphs = None
    before = dict(eng_t.index.shortlist_stats)
    img = Image.open(root / "a" / "img_04.png")
    _same(eng_t.search_image_pil(img, K), eng_j.search_image_pil(img, K))
    data = (root / "b" / "img_07.png").read_bytes()
    _same(eng_t.search_image_bytes(data, K), eng_j.search_image_bytes(data, K))
    images = [Image.open(root / "a" / "img_01.png"), img, Image.open(root / "b" / "img_10.png")]
    t_got, i_got = eng_t._search_mixed_fused(TEXTS[:2], images, K)
    t_want, i_want = eng_j._search_mixed_fused(TEXTS[:2], images, K)
    assert len(t_got) == 2 and len(i_got) == 3
    for got, want in zip(t_got + i_got, t_want + i_want):
        _same(got, want)
    after = eng_t.index.shortlist_stats
    assert sum(after.get(m, 0) - before.get(m, 0) for m in ("exact_searches", "extract_searches")) == 3


# (program, text rows, image rows): the lone image, a batch of 4, mixed (1, 1), (4, 4), (1, 4).
PROGRAMS = [("image", 0, 1), ("image", 0, 4), ("mixed", 1, 1), ("mixed", 4, 4), ("mixed", 1, 4)]
PROGRAM_IDS = [f"{p}-{t}x{i}" for p, t, i in PROGRAMS]


def _inputs(eng_t, root, n_texts, n_images):
    ids, mask = eng_t._tokenize_bucketed(TEXTS[:n_texts]) if n_texts else (None, None)
    files = sorted(root.rglob("img_*.png"))[::3][:n_images]
    images = [Image.open(f) for f in files] + _images([(24, 72)], seed=11)[: max(0, n_images - len(files))]
    return ids, mask, eng_t._image_inputs(images, n_images)


def _port_fused(eng_t, ids, mask, naflex):
    """The port's one fused program on the block (texts and / or NaFlex
    images)."""
    idx = eng_t.index
    q_count = (0 if ids is None else len(ids)) + len(naflex[0])
    tail = (idx._matrix, idx._scales, idx._rows_device, K, idx._n_valid)
    method = pt_ops.resolve_shortlist_method(q_count)
    t = torch.from_numpy
    text_inputs = () if ids is None else (t(ids), t(mask))
    out = pt_ops.query_topk_fused(eng_t.model, text_inputs, tuple(map(t, naflex)), *tail, shortlist_method=method)
    return out[0].numpy(), out[1].numpy()


@pytest.mark.parametrize("program,n_texts,n_images", PROGRAMS, ids=PROGRAM_IDS)
def test_fused_naflex_programs_match_tpuclip(env, program, n_texts, n_images):
    tmp, cache, root, db, eng_j, eng_t, _ = env
    ids, mask, naflex = _inputs(eng_t, root, n_texts, n_images)
    s_t, r_t = _port_fused(eng_t, ids, mask, naflex)
    jdx = eng_j.index
    tail = (jdx._matrix, jdx._scales, jdx._rows_device, eng_j.config, K)
    kw = dict(n_valid=jdx._n_valid, compute_dtype=eng_j.compute_dtype, use_pallas=False)
    j = [jnp.asarray(x) for x in naflex]
    if program == "image":
        out = jx_ops.naflex_image_topk_fused(eng_j.params, *j, *tail, **kw)
    else:
        out = jx_ops.mixed_naflex_topk_fused(eng_j.params, jnp.asarray(ids), jnp.asarray(mask), *j, *tail, **kw)
    s_j, r_j = np.asarray(out[0]), np.asarray(out[1])
    assert s_t.shape == s_j.shape == (n_texts + n_images, K)
    assert np.isfinite(s_t).all()
    np.testing.assert_array_equal(r_t, r_j)
    np.testing.assert_allclose(s_t, s_j, rtol=0, atol=1e-5)


@pytest.mark.parametrize("program,n_texts,n_images", PROGRAMS, ids=PROGRAM_IDS)
def test_fused_naflex_programs_equal_two_stage(env, program, n_texts, n_images):
    *_, eng_t, _ = env
    ids, mask, naflex = _inputs(eng_t, env[2], n_texts, n_images)
    s_f, r_f = _port_fused(eng_t, ids, mask, naflex)
    model, idx = eng_t.model, eng_t.index
    parts = [] if ids is None else [model.get_text_features(torch.from_numpy(ids), torch.from_numpy(mask))]
    parts.append(model.get_image_features_naflex(*map(torch.from_numpy, naflex)))
    s_2, r_2 = pt_ops.topk_int8_rerank_fused_auto(
        torch.from_numpy(torch.cat(parts).numpy()), idx._matrix, idx._scales, idx._rows_device, K,
        n_valid=idx._n_valid,
    )
    np.testing.assert_array_equal(r_f, r_2.numpy())
    np.testing.assert_array_equal(s_f, s_2.numpy())


def _cli_results(monkeypatch, cli, argv):
    gallery = importlib.import_module(cli.__name__.rsplit(".", 1)[0] + ".gallery.html")
    captured = []
    monkeypatch.setattr(gallery, "generate_html_gallery", lambda r, *a, **kw: captured.append(list(r)))
    cli.main(argv)
    return captured


def test_cli_search_text_and_image_match_tpuclip(env, monkeypatch):
    """``search "..." --no-session`` and ``search --image`` through both CLIs
    on the NaFlex database (the fused single-image branch, duplicates
    filtered)."""
    tmp, cache, root, db, *_ = env
    query = str(root / "a" / "img_00.png")
    for argv in (["a tall photo"], [query, "--image"]):
        results = {}
        for name, cli in (("jax", jx_cli), ("torch", pt_cli)):
            extra = ["--device", "cpu"] if name == "torch" else []
            captured = _cli_results(monkeypatch, cli, [
                "search", *argv, "-k", str(K), "--no-session", "--db", db, "--model", MODEL,
                "--model-cache", str(cache), "--output", str(tmp / f"{name}.html"), *extra])
            assert len(captured) == 1
            results[name] = captured[0]
        _same(results["torch"], results["jax"])
    assert results["torch"][0][0] == query
    assert str(root / "b" / "copy_of_00.png") not in [p for p, _ in results["torch"]]


def test_session_image_line_matches_tpuclip(env, monkeypatch):
    """The interactive session's ``image: <path> + text`` line through both
    CLIs (scripted input), each gallery equal."""
    tmp, cache, root, db, *_ = env
    image = str(root / "b" / "img_08.png")
    results = {}
    for name, cli in (("jax", jx_cli), ("torch", pt_cli)):
        pending = [f"image:{image} + a tall photo", f"image:{image}", "quit"]
        monkeypatch.setattr("builtins.input", lambda prompt="": pending.pop(0))
        monkeypatch.setattr(cli, "is_tty", lambda: True)
        extra = ["--device", "cpu"] if name == "torch" else []
        results[name] = _cli_results(monkeypatch, cli, [
            "search", "--interactive", "--db", db, "--model", MODEL, "--model-cache", str(cache),
            "-k", str(K), *extra])
        assert not pending
    assert len(results["torch"]) == len(results["jax"]) == 2
    for got, want in zip(results["torch"], results["jax"]):
        _same(got, want)
    assert results["torch"][1][0][0] == image


def _post(srv, path, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{srv.port}{path}", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def test_server_matches_tpuclip(env):
    """Both ``SearchServer``s on the NaFlex database: an upload ``/search``,
    ``/search_batch``, ``/embed`` and ``/classify``."""
    tmp, cache, root, db, eng_j, eng_t, _ = env
    b64 = base64.b64encode((root / "a" / "img_05.png").read_bytes()).decode()
    servers = [jx_serve.SearchServer(eng_j, host="127.0.0.1", port=0),
               pt_serve.SearchServer(eng_t, host="127.0.0.1", port=0)]
    for srv in servers:
        srv.start_background()
    try:
        payloads = [("/search", {"image_b64": b64, "k": K}), ("/search_batch", {"queries": TEXTS, "k": K}),
                    ("/embed", {"texts": TEXTS[:2], "images_b64": [b64]}),
                    ("/classify", {"image_b64": b64, "labels": ["a wide photo", "a tall photo", "noise"]})]
        for path, payload in payloads:
            (code_j, want), (code_t, got) = (_post(srv, path, payload) for srv in servers)
            assert code_j == code_t == 200, path
            if path == "/search":
                _same([(r["path"], r["similarity"]) for r in got["results"]],
                      [(r["path"], r["similarity"]) for r in want["results"]])
            elif path == "/search_batch":
                for g, w in zip(got["results"], want["results"]):
                    _same([(r["path"], r["similarity"]) for r in g], [(r["path"], r["similarity"]) for r in w])
            elif path == "/embed":
                for key in ("text_embeddings", "image_b64_embeddings"):
                    np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-5)
            else:
                assert [r["label"] for r in got["labels"]] == [r["label"] for r in want["labels"]]
                np.testing.assert_allclose([r["prob"] for r in got["labels"]],
                                           [r["prob"] for r in want["labels"]], rtol=0, atol=1e-5)
    finally:
        for srv in servers:
            srv.shutdown()


def test_warm_programs_on_a_naflex_engine(env, monkeypatch):
    """24 calls: 21 fused programs (4 text, the NaFlex lone image, 16 NaFlex
    mixed) and 3 batch-search shapes; the CPU runs the programs eager."""
    *_, eng_t, _ = env
    idx = eng_t.index
    keys, original = [], idx._program
    monkeypatch.setattr(idx, "_program", lambda key, *args: (keys.append(key), original(key, *args))[1])
    assert pt_serve.warm_programs(eng_t, k=K) == 24
    assert len(keys) == len(set(keys)) == 21
    buckets = (1, 4, 16, 64)
    assert [key[:2] for key in keys] == [(t, 0) for t in buckets] + [(0, 1)] + [
        (t, i) for t in buckets for i in buckets]


def test_classify_refuses_naflex_like_tpuclip(env):
    tmp, cache, root, *_ = env
    image = str(root / "a" / "img_02.png")
    with pytest.raises(ValueError) as jx_err:
        jx_classify_image(image, ["a", "b"], MODEL, str(cache))
    with pytest.raises(ValueError) as pt_err:
        pt_classify_image(image, ["a", "b"], MODEL, str(cache), device="cpu")
    assert str(pt_err.value) == str(jx_err.value)
    assert "NaFlex" in str(pt_err.value)


@pytest.mark.parametrize("model_name", ["tpuclip/test-tiny", MODEL])
def test_image_embeddings_batch_matches_tpuclip(tmp_path, monkeypatch, model_name):
    """``_get_image_embeddings_batch`` on a tree with an unreadable file:
    None in its place, the rest equal to tpuclip's."""
    monkeypatch.setenv("TPUCLIP_HOME", str(tmp_path / "home"))
    cfg = get_config(model_name)
    cache = tmp_path / "models"
    params = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(1), cfg))
    save_checkpoint(str(cache / model_name.replace("/", "--")), params, cfg)
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    for img, name in zip(_images([(40, 40), (24, 80), (64, 32)], seed=3), ("a.png", "b.png", "c.png")):
        img.save(imgs / name)
    (imgs / "broken.jpg").write_bytes(b"not a jpeg")
    paths = [str(imgs / n) for n in ("a.png", "broken.jpg", "b.png", "missing.png", "c.png")]
    outs = []
    for module, extra in ((jx_engine, {}), (pt_engine, {"device": "cpu"})):
        eng = module.ImageDatabase(str(tmp_path / f"{module.__name__}.db"), str(cache), model_name=model_name,
                                   inference_batch_size=4, **extra)
        outs.append(eng._get_image_embeddings_batch(paths))
    want, got = outs
    assert [g is None for g in got] == [w is None for w in want] == [False, True, False, True, False]
    for g, w in zip(got, want):
        if w is not None:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


# -------------------------------------------------------------------- CUDA


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the int8 scan kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_naflex_graph_replay_equals_eager_and_refresh_drops_graphs(env, cuda_device, tmp_path):
    tmp, cache, root, db, *_ = env
    own = str(tmp_path / "own.db")  # this test adds a row: a copy of the database
    src, dst = sqlite3.connect(db), sqlite3.connect(own)
    src.backup(dst)
    src.close()
    dst.close()
    eng = pt_engine.ImageDatabase(own, str(cache), model_name=MODEL, inference_batch_size=4, device="cuda")
    assert eng.index.can_fuse_image_search(K, None)
    idx = eng.index
    tail = (idx._matrix, idx._scales, idx._rows_device, K, idx._n_valid)
    img = Image.open(root / "a" / "img_03.png")
    naflex = eng._image_inputs([img], 1)
    launches = pt_ops.int8_scores.launches
    first = eng._search_image_fused(img, K)  # captures the lone-image program
    again = eng._search_image_fused(img, K)  # replays it
    assert pt_ops.int8_scores.launches - launches == 3  # the warm-up, then two replays
    s, r = pt_ops.query_topk_fused(eng.model, (), [torch.from_numpy(x).cuda() for x in naflex], *tail,
                                   shortlist_method="exact")
    want = idx._map_batch_results(s.cpu().numpy(), r.cpu().numpy(), 1)[0]
    assert first == again == want

    images = [img, Image.open(root / "b" / "img_11.png")]
    ids, mask = eng._tokenize_bucketed(TEXTS[:1])
    got = eng._search_mixed_fused(TEXTS[:1], images, K)
    text_inputs = [torch.from_numpy(x).cuda() for x in (ids, mask)]
    image_inputs = [torch.from_numpy(x).cuda() for x in eng._image_inputs(images, 4)]
    s, r = pt_ops.query_topk_fused(eng.model, text_inputs, image_inputs, *tail, shortlist_method="extract")
    sel = [0, 1, 2]
    assert list(got[0]) + list(got[1]) == idx._map_batch_results(s.cpu().numpy()[sel], r.cpu().numpy()[sel], 3)
    assert len(idx._graphs) == 2 and idx._graphs.pool_bytes() > 0

    extra = tmp_path / "extra"
    extra.mkdir()
    Image.new("RGB", (40, 120), (250, 10, 10)).save(extra / "new.png")
    eng.scan_directory(str(extra), inference_batch_size=4)
    assert eng.index.can_fuse_image_search(K, None)
    assert eng.index._graphs is None  # the new row was uploaded: the graphs held the old tensors
    after = eng._search_image_fused(img, K)
    assert after[0][0] == str(root / "a" / "img_03.png") and len(eng.index._graphs) == 1
