"""The fused query programs (tower → int8 scan → rescore) of the port against
tpuclip's, on the CPU: the same tiny checkpoint (written by tpuclip's
``save_checkpoint``) and ONE database that both packages open, with the
rerank rows resident (``TPUCLIP_DEVICE_RERANK=1``). tpuclip runs its
programs with ``use_pallas=False``, as off the TPU.

- ``query_topk_fused`` on texts, images and mixed blocks against tpuclip's
  text, image and mixed fused programs (identical ids, scores within 1e-5:
  the two towers differ by about 1e-6) and against the port's own
  two-stage route (bit-equal);
- the engine's fused entry points and ``search --image`` against tpuclip's;
- the fusion gate against tpuclip's on the same index states;
- cascade ``search_batch`` (ladder-padded) against single searches;
- on a CUDA card (``cuda`` marker): graph replay against eager, and a
  refresh after a new row dropping the graphs."""

import importlib
import shutil
import sqlite3
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import tpuclip.cli as jx_cli
import tpuclip.engine as jx_engine
import tpuclip.ops.topk_int8 as jx_ops
import tpuclip_torch.cli as pt_cli
import tpuclip_torch.engine as pt_engine
import tpuclip_torch.ops.topk_int8 as pt_ops
from tpuclip.index.search import DeviceIndex as JxIndex
from tpuclip.models.checkpoint import save_checkpoint
from tpuclip.models.configs import get_config
from tpuclip.models.siglip import init_params
from tpuclip_torch.index.search import DeviceIndex as PtIndex

MODEL = "tpuclip/test-tiny"
K = 5
TEXTS = ["a red car", "blue sky", "two dogs on a beach", "night city", "a cat"]
ENV = {"TPUCLIP_SEARCH_PRECISION": "int8", "TPUCLIP_DEVICE_RERANK": "1", "TPUCLIP_SEARCH_MODE": "exact"}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(tmp, model cache, image root, db path, tpuclip engine, port engine)
    over one database scanned by tpuclip."""
    tmp = tmp_path_factory.mktemp("fused")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPUCLIP_HOME", str(tmp / "home"))
        for key, value in ENV.items():
            mp.setenv(key, value)
        mp.delenv("TPUCLIP_SHORTLIST", raising=False)
        cache = tmp / "models"
        params = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(3), get_config(MODEL)))
        save_checkpoint(str(cache / MODEL.replace("/", "--")), params, get_config(MODEL))
        root = tmp / "imgs"
        rng = np.random.default_rng(21)
        for i in range(12):
            folder = root / ("a" if i < 6 else "b")
            folder.mkdir(parents=True, exist_ok=True)
            Image.fromarray(rng.integers(0, 256, (40 + i, 48, 3), dtype=np.uint8)).save(
                folder / f"img_{i:02d}.png"
            )
        shutil.copyfile(root / "a" / "img_00.png", root / "b" / "copy_of_00.png")
        db = str(tmp / "one.db")
        eng_j = jx_engine.ImageDatabase(db, str(cache), model_name=MODEL, inference_batch_size=4)
        eng_j.scan_directory(str(root), inference_batch_size=4)
        eng_t = pt_engine.ImageDatabase(db, str(cache), model_name=MODEL, inference_batch_size=4, device="cpu")
        eng_j.index.refresh()
        eng_t.index.refresh()
        yield tmp, cache, root, db, eng_j, eng_t


@pytest.fixture()
def env(world, monkeypatch):
    monkeypatch.setenv("TPUCLIP_HOME", str(world[0] / "home"))
    for key, value in ENV.items():
        monkeypatch.setenv(key, value)
    monkeypatch.delenv("TPUCLIP_SHORTLIST", raising=False)
    return world


def _pixels(count, size, seed=5):
    return np.random.default_rng(seed).integers(0, 256, (count, size, size, 3), dtype=np.uint8)


# (program, text rows, image rows): buckets 1 and 4, mixed (1, 1), (4, 4), (1, 4).
PROGRAMS = [
    ("text", 1, 0), ("text", 4, 0), ("image", 0, 1), ("image", 0, 4),
    ("mixed", 1, 1), ("mixed", 4, 4), ("mixed", 1, 4),
]
PROGRAM_IDS = [f"{p}-{t}x{i}" for p, t, i in PROGRAMS]


def _inputs(eng_t, n_texts, n_images):
    ids, mask = eng_t._tokenize_bucketed(TEXTS[:n_texts]) if n_texts else (None, None)
    return ids, mask, _pixels(n_images, eng_t.image_size) if n_images else None


def _port_fused(eng_t, ids, mask, pixels):
    """The port's one fused program on the block (texts and / or pixels)."""
    idx = eng_t.index
    t = torch.from_numpy
    text_inputs = () if ids is None else (t(ids), t(mask))
    image_inputs = () if pixels is None else (t(pixels),)
    q_count = (0 if ids is None else len(ids)) + (0 if pixels is None else len(pixels))
    method = pt_ops.resolve_shortlist_method(q_count)
    tail = (idx._matrix, idx._scales, idx._rows_device, K, idx._n_valid)
    out = pt_ops.query_topk_fused(eng_t.model, text_inputs, image_inputs, *tail, shortlist_method=method)
    return out[0].numpy(), out[1].numpy()


@pytest.mark.parametrize("program,n_texts,n_images", PROGRAMS, ids=PROGRAM_IDS)
def test_fused_programs_match_tpuclip(env, program, n_texts, n_images):
    *_, eng_j, eng_t = env
    ids, mask, pixels = _inputs(eng_t, n_texts, n_images)
    s_t, r_t = _port_fused(eng_t, ids, mask, pixels)

    jdx = eng_j.index
    tail = (jdx._matrix, jdx._scales, jdx._rows_device, eng_j.config, K)
    kw = dict(n_valid=jdx._n_valid, compute_dtype=eng_j.compute_dtype, use_pallas=False)
    if program == "text":
        out = jx_ops.text_topk_fused(eng_j.params, jnp.asarray(ids), jnp.asarray(mask), *tail, **kw)
    elif program == "image":
        out = jx_ops.image_topk_fused(eng_j.params, jnp.asarray(pixels), *tail, **kw)
    else:
        out = jx_ops.mixed_topk_fused(
            eng_j.params, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(pixels), *tail, **kw
        )
    s_j, r_j = np.asarray(out[0]), np.asarray(out[1])
    assert s_t.shape == s_j.shape == (n_texts + n_images, K)
    assert np.isfinite(s_t).all()
    np.testing.assert_array_equal(r_t, r_j)
    np.testing.assert_allclose(s_t, s_j, rtol=0, atol=1e-5)


@pytest.mark.parametrize("program,n_texts,n_images", PROGRAMS, ids=PROGRAM_IDS)
def test_fused_programs_equal_two_stage(env, program, n_texts, n_images):
    """The fused program against the port's two-stage route: the towers,
    the embeddings to the host and back, then the fused int8 search."""
    *_, eng_t = env
    ids, mask, pixels = _inputs(eng_t, n_texts, n_images)
    s_f, r_f = _port_fused(eng_t, ids, mask, pixels)
    model, idx = eng_t.model, eng_t.index
    parts = []
    if ids is not None:
        parts.append(model.get_text_features(torch.from_numpy(ids), torch.from_numpy(mask)).numpy())
    if pixels is not None:
        parts.append(model.get_image_features(torch.from_numpy(pixels)).numpy())
    s_2, r_2 = pt_ops.topk_int8_rerank_fused_auto(
        torch.from_numpy(np.concatenate(parts)), idx._matrix, idx._scales, idx._rows_device, K,
        n_valid=idx._n_valid,
    )
    np.testing.assert_array_equal(r_f, r_2.numpy())
    np.testing.assert_array_equal(s_f, s_2.numpy())


def _same(got, want, tol=1e-5):
    assert len(got) == len(want) > 0
    assert [p for p, _ in got] == [p for p, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want], rtol=0, atol=tol)


def test_engine_fused_entry_points_match_tpuclip(env):
    tmp, cache, root, db, eng_j, eng_t = env
    eng_t.index._graphs = None
    before = dict(eng_t.index.shortlist_stats)

    for got, want in zip(eng_t.search_texts(TEXTS[:3], K), eng_j.search_texts(TEXTS[:3], K)):
        _same(got, want)
    img = Image.open(root / "a" / "img_03.png")
    _same(eng_t.search_image_pil(img, K), eng_j.search_image_pil(img, K))
    data = (root / "b" / "img_07.png").read_bytes()
    _same(eng_t.search_image_bytes(data, K), eng_j.search_image_bytes(data, K))
    assert eng_t.search_image_bytes(b"not an image", K) is None
    # (2 texts, 3 images): buckets (4, 4), real rows picked out by row_sel.
    images = [Image.open(root / "a" / "img_01.png"), img, Image.open(root / "b" / "img_09.png")]
    t_got, i_got = eng_t._search_mixed_fused(TEXTS[:2], images, K)
    t_want, i_want = eng_j._search_mixed_fused(TEXTS[:2], images, K)
    assert len(t_got) == 2 and len(i_got) == 3
    for got, want in zip(t_got + i_got, t_want + i_want):
        _same(got, want)
    # Every one of those went through the fused programs.
    assert eng_t.index._graphs is not None and len(eng_t.index._graphs) == 0  # the CPU runs eager
    after = eng_t.index.shortlist_stats
    runs = sum(after.get(m, 0) - before.get(m, 0) for m in ("exact_searches", "extract_searches"))
    assert runs == 4  # texts, image, image bytes, mixed


def test_cli_image_search_matches_tpuclip(env, monkeypatch):
    """``search --image <path> --no-session`` through both CLIs: the fused
    single-image branch of the search pipeline, duplicates filtered."""
    tmp, cache, root, db, *_ = env
    query = str(root / "a" / "img_00.png")
    results = {}
    for name, cli in (("jax", jx_cli), ("torch", pt_cli)):
        gallery = importlib.import_module(cli.__name__.rsplit(".", 1)[0] + ".gallery.html")
        captured = []
        monkeypatch.setattr(gallery, "generate_html_gallery", lambda r, *a, **kw: captured.append(list(r)))
        extra = ["--device", "cpu"] if name == "torch" else []
        cli.main([
            "search", query, "--image", "-k", str(K), "--no-session", "--db", db, "--model", MODEL,
            "--model-cache", str(cache), "--output", str(tmp / f"{name}.html"), *extra,
        ])
        assert len(captured) == 1
        results[name] = captured[0]
    _same(results["torch"], results["jax"])
    assert results["torch"][0][0] == query
    # The duplicate (a byte copy of the query) was filtered out.
    assert str(root / "b" / "copy_of_00.png") not in [p for p, _ in results["torch"]]


@pytest.mark.parametrize(
    "case,env_over,k,folders,want",
    [
        ("eligible", {}, K, None, True),
        ("folder-filter", {}, K, ["a"], False),
        ("bf16", {"TPUCLIP_SEARCH_PRECISION": "bf16"}, K, None, False),
        ("k-129", {}, 129, None, False),
        ("k-128", {}, 128, None, True),
        ("no-rerank-copy", {"TPUCLIP_DEVICE_RERANK": "0"}, K, None, False),
        ("cascade", {"TPUCLIP_SEARCH_MODE": "cascade"}, K, None, False),
    ],
)
def test_can_fuse_matches_tpuclip(env, monkeypatch, case, env_over, k, folders, want):
    tmp, cache, root, db, eng_j, eng_t = env
    for key, value in env_over.items():
        monkeypatch.setenv(key, value)
    folders = [str(root / f) for f in folders] if folders else None
    idx_t = PtIndex(eng_t.store, device="cpu")
    idx_j = JxIndex(eng_j.store, device=eng_j.device)
    got = idx_t.can_fuse_text_search(k, folders)
    assert got == idx_j.can_fuse_text_search(k, folders) == want
    assert idx_t.can_fuse_image_search(k, folders) == got


@pytest.mark.parametrize("q_count", [2, 5])
def test_cascade_search_batch_is_bucketed_and_equals_single_searches(env, monkeypatch, q_count):
    """Cascade ``search_batch`` pads the queries to the ladder (4 or 16
    rows) and drops the pad rows: what single ``search`` calls return."""
    *_, eng_t = env
    monkeypatch.setenv("TPUCLIP_SEARCH_MODE", "cascade")
    monkeypatch.setenv("TPUCLIP_CASCADE_DEPTH", "8")
    idx = PtIndex(eng_t.store, device="cpu")
    queries = eng_t.embed_texts(TEXTS[:q_count])
    seen = []
    original = idx._cascade_prefilter

    def spy(qwords, depth, mask):
        seen.append(qwords.shape[0])
        return original(qwords, depth, mask)

    idx._cascade_prefilter = spy
    batch = idx.search_batch(queries, K)
    assert idx._cascade and seen == [4 if q_count == 2 else 16]
    singles = [idx.search(q, K) for q in queries]
    assert len(batch) == q_count and all(len(r) == K for r in batch)
    assert batch == singles


# -------------------------------------------------------------------- CUDA


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the int8 scan kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _eager_results(eng, ids, mask, pixels, q_count, row_sel=None):
    """The fused program run eager (no graph), mapped like the index does."""
    idx = eng.index
    t = lambda x: torch.from_numpy(x).cuda()  # noqa: E731
    n = len(ids) + (0 if pixels is None else len(pixels))
    tail = (idx._matrix, idx._scales, idx._rows_device, K, idx._n_valid)
    method = pt_ops.resolve_shortlist_method(n)
    image_inputs = () if pixels is None else (t(pixels),)
    s, r = pt_ops.query_topk_fused(eng.model, (t(ids), t(mask)), image_inputs, *tail, shortlist_method=method)
    s, r = s.cpu().numpy(), r.cpu().numpy()
    sel = row_sel if row_sel is not None else list(range(q_count))
    return idx._map_batch_results(s[sel], r[sel], len(sel))


@pytest.mark.cuda
def test_cuda_graph_replay_equals_eager_and_refresh_drops_graphs(env, cuda_device, tmp_path):
    tmp, cache, root, db, _, _ = env
    own = str(tmp_path / "own.db")  # this test adds a row: a copy of the database
    src, dst = sqlite3.connect(db), sqlite3.connect(own)
    src.backup(dst)
    src.close()
    dst.close()
    eng = pt_engine.ImageDatabase(own, str(cache), model_name=MODEL, inference_batch_size=4, device="cuda")
    assert eng.index.can_fuse_text_search(K, None)  # refreshes: the rows go up
    texts = TEXTS[:3]
    ids, mask = eng._tokenize_bucketed(texts)
    launches = pt_ops.int8_candidates_packed.launches
    first = eng._search_texts_fused(texts, K)  # captures text bucket 4
    again = eng._search_texts_fused(texts, K)  # replays it
    # One launch per run of the program: the warm-up, then two replays.
    assert pt_ops.int8_candidates_packed.launches - launches == 3
    assert first == again == _eager_results(eng, ids, mask, None, 3)

    img = Image.open(root / "a" / "img_02.png")
    (pixels,) = eng._image_inputs([img], 1)
    ids1, mask1 = eng._tokenize_bucketed(TEXTS[:1])
    got = eng._search_mixed_fused(TEXTS[:1], [img], K)
    want = _eager_results(eng, ids1, mask1, pixels, 2, row_sel=[0, 1])
    assert list(got[0]) + list(got[1]) == want
    graphs = eng.index._graphs
    assert len(graphs) == 2 and graphs.pool_bytes() > 0

    extra = tmp_path / "extra"
    extra.mkdir()
    Image.new("RGB", (40, 40), (250, 10, 10)).save(extra / "new.png")
    eng.scan_directory(str(extra), inference_batch_size=4)
    assert eng.index.can_fuse_text_search(K, None)
    assert eng.index._graphs is None  # the new row was uploaded: the graphs held the old tensors
    after = eng._search_texts_fused(texts, K)
    assert after == _eager_results(eng, ids, mask, None, 3)
    assert len(eng.index._graphs) == 1


@pytest.mark.cuda
def test_cuda_graph_runner_serializes_concurrent_replays(cuda_device):
    """Threads replaying graphs of one runner at once (one shared pool, the
    runner's lock) each get the answer to their own input."""
    from tpuclip_torch.ops.graphs import FusedGraphs

    graphs = FusedGraphs(cuda_device)

    def program(x):
        y = x.float() * 3.0 + 1.0
        return (y.cumsum(dim=1), y.sum(dim=1))

    errors, done = [], []

    def worker(seed):
        rng = np.random.default_rng(seed)
        try:
            for step in range(25):
                x = rng.standard_normal((4 if step % 2 else 16, 257)).astype(np.float32)
                cum, total = graphs.run(("toy", len(x)), program, (x,))
                want = x * np.float32(3.0) + np.float32(1.0)
                np.testing.assert_allclose(cum, np.cumsum(want, axis=1), rtol=1e-5, atol=1e-4)
                np.testing.assert_allclose(total, want.sum(axis=1), rtol=1e-5, atol=1e-4)
            done.append(seed)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(seed,)) for seed in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not errors, errors[:3]
    assert sorted(done) == list(range(16)) and not any(t.is_alive() for t in threads)
    assert len(graphs) == 2
