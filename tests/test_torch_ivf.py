"""The port's IVF search (``tpuclip_torch/index/ivf.py`` and the ``ivf``
mode of its ``DeviceIndex``) against tpuclip's, on the CPU, on
``tests/test_ivf.py``'s data (8,000 clustered unit rows x 64, 32 centres).

Held against tpuclip: the host build (same seed: the same centroids,
buckets, scales and row ids, the blocks transposed), ``_kmeans`` from a
given ``init_idx``, the device build from given centroids, and
``ivf_topk_rerank`` on tpuclip's own index carried over by
``ivf_from_jax`` (ids identical, scores within 1e-6, ties planted).
tpuclip's invariants on the port's builds, then the ``DeviceIndex`` under
``TPUCLIP_SEARCH_MODE=ivf``: its routes, the retrain rule, the footprint
estimate, and the fused gate, which tpuclip leaves open under IVF (so its
engine, ``search --image`` and server scan every row) and the port closes:
every entry point of the port probes the buckets."""

import base64
import json
import sqlite3
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import tpuclip.engine as jx_engine
import tpuclip.index.ivf as jx_ivf
import tpuclip.index.search as jx_search
import tpuclip_torch.cli as pt_cli
import tpuclip_torch.engine as pt_engine
import tpuclip_torch.index.search as pt_search
import tpuclip_torch.serve as pt_serve
from tpuclip.index.store import MetadataStore
from tpuclip.models.checkpoint import save_checkpoint
from tpuclip.models.configs import get_config
from tpuclip.models.siglip import init_params
from tpuclip_torch.index import ivf as pt_ivf

MODEL = "tpuclip/test-tiny"
DIM = 64  # the tiny preset's embedding width, and tests/test_ivf.py's


def _clustered(rng, n, d, n_clusters=32, spread=0.05):
    """tests/test_ivf.py's mixture of gaussians on the sphere."""
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    which = rng.integers(0, n_clusters, n)
    x = centers[which] + spread * rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(41)
    return _clustered(rng, 8000, DIM), _clustered(rng, 8, DIM)


@pytest.fixture(scope="module")
def host_builds(data):
    rows, _ = data
    return (jx_ivf.build_ivf(rows, k_clusters=64, nprobe=8),
            pt_ivf.build_ivf(rows, k_clusters=64, nprobe=8, device="cpu"))


def _reachable_once(index, n):
    seen = index.bucket_rows.reshape(-1)
    seen = torch.cat([seen[seen >= 0], index.over_rows[index.over_rows >= 0]])
    return sorted(seen.tolist()) == list(range(n))


def _as_port_layout(jx_index):
    """tpuclip's seven arrays in the port's row-major layout, as numpy."""
    arrays = [np.asarray(a) for a in jx_index[:7]]
    arrays[1] = arrays[1].transpose(0, 2, 1)
    arrays[4] = arrays[4].T
    return arrays


# ============================================================ builds


def test_host_build_matches_tpuclip(host_builds):
    jx, pt = host_builds
    want = _as_port_layout(jx)
    np.testing.assert_allclose(pt.centroids.numpy(), want[0], rtol=0, atol=1e-5)
    for got, ref, name in zip(pt[1:7], want[1:], jx._fields[1:7]):
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=name)
    assert pt.nprobe == jx.nprobe == 8


def test_kmeans_from_init_idx_matches_tpuclip(data):
    rows, _ = data
    sample = rows[::2]
    init = np.sort(np.random.default_rng(3).choice(len(sample), 64, replace=False))
    want = np.asarray(jx_ivf._kmeans_device(jnp.asarray(sample), jnp.asarray(init), 64, 12))
    got = pt_ivf._kmeans(torch.from_numpy(sample), torch.from_numpy(init), 64, 12)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("capacity_factor", [1.5, 1.0])
def test_device_build_with_centroids_matches_tpuclip(data, host_builds, capacity_factor):
    """The jitted quantization form, the stable sort and the scatter: with
    tpuclip's centroids the device builds agree field for field (at 1.0
    most clusters spill, so the overflow sizing is held too)."""
    rows, _ = data
    cent = host_builds[0].centroids
    jx = jx_ivf.build_ivf_device(jnp.asarray(rows), k_clusters=64, centroids=cent,
                                 capacity_factor=capacity_factor)
    pt = pt_ivf.build_ivf_device(torch.from_numpy(rows), k_clusters=64,
                                 centroids=torch.from_numpy(np.array(cent)),
                                 capacity_factor=capacity_factor)
    for got, ref, name in zip(pt[:7], _as_port_layout(jx), jx._fields[:7]):
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=name)
    assert pt.nprobe == jx.nprobe


def test_device_build_is_seeded_and_reaches_every_row(data):
    rows, queries = data
    a = pt_ivf.build_ivf_device(torch.from_numpy(rows), k_clusters=64, nprobe=24, seed=5)
    b = pt_ivf.build_ivf_device(torch.from_numpy(rows), k_clusters=64, nprobe=24, seed=5)
    for x, y in zip(a[:7], b[:7]):
        assert torch.equal(x, y)
    assert _reachable_once(a, len(rows))
    _, i = pt_ivf.ivf_search(a, torch.from_numpy(rows), queries, 20)
    exact = queries @ rows.T
    recall = np.mean([len(set(np.argsort(-exact[q])[:20]) & set(i[q].tolist())) / 20
                      for q in range(len(queries))])
    assert recall >= 0.95, recall


def test_host_build_reaches_every_row(data, host_builds):
    assert _reachable_once(host_builds[1], len(data[0]))


# ============================================================ search


@pytest.fixture(scope="module")
def tied(data):
    """The rows with ties planted: eight copies of row 7 (equal int8 and
    exact scores) and a query at row 7, then tpuclip's host index."""
    rows, queries = data
    rows = rows.copy()
    rows[1000:1008] = rows[7]
    queries = queries[:4].copy()
    queries[0] = rows[7]
    return rows, queries, jx_ivf.build_ivf(rows, k_clusters=64, nprobe=8)


@pytest.mark.parametrize("q_count", [1, 4])
@pytest.mark.parametrize("k", [1, 10, 20, 128])
def test_ivf_topk_rerank_matches_tpuclip(tied, q_count, k):
    rows, queries, jx = tied
    want_s, want_i = jx_ivf.ivf_search(jx, jnp.asarray(rows), queries[:q_count], k)
    got_s, got_i = pt_ivf.ivf_search(pt_ivf.ivf_from_jax(jx), torch.from_numpy(rows), queries[:q_count], k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=0, atol=1e-6)
    if k >= 10:  # the planted copies come back in row order
        assert got_i[0, :9].tolist() == [7, *range(1000, 1008)]


@pytest.mark.parametrize("build", ["host", "device"])
def test_nprobe_all_is_exact(data, build):
    rows, queries = data
    if build == "host":
        index = pt_ivf.build_ivf(rows, k_clusters=32, nprobe=32, device="cpu")
    else:
        index = pt_ivf.build_ivf_device(torch.from_numpy(rows), k_clusters=32, nprobe=32)
    s, i = pt_ivf.ivf_search(index, torch.from_numpy(rows), queries, 15)
    exact = queries @ rows.T
    for q in range(len(queries)):
        order = np.lexsort((np.arange(len(rows)), -exact[q]))[:15]
        np.testing.assert_array_equal(i[q].numpy(), order)
        np.testing.assert_allclose(s[q].numpy(), exact[q][order], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("build", ["host", "device"])
def test_overflow_rows_always_scanned(build):
    rng = np.random.default_rng(46)
    base = rng.standard_normal(32).astype(np.float32)
    rows = base[None, :] + 0.05 * rng.standard_normal((300, 32)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    if build == "host":
        index = pt_ivf.build_ivf(rows, k_clusters=16, capacity_factor=1.0, nprobe=2, device="cpu")
    else:
        index = pt_ivf.build_ivf_device(torch.from_numpy(rows), k_clusters=16, capacity_factor=1.0, nprobe=2)
    assert int((index.over_rows >= 0).sum()) > 0
    assert _reachable_once(index, len(rows))
    q = rows[123:124] + 0.001
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    _, i = pt_ivf.ivf_search(index, torch.from_numpy(rows), q, 5)
    assert int(i[0, 0]) == int(np.argmax(rows @ q[0]))


def test_small_index_edge():
    """N below the capacity, k above N: exactly the N rows, no sentinel."""
    rng = np.random.default_rng(44)
    rows = rng.standard_normal((13, 16)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    index = pt_ivf.build_ivf(rows, k_clusters=4, nprobe=4, device="cpu")
    q = rng.standard_normal((1, 16)).astype(np.float32)
    s, i = pt_ivf.ivf_search(index, torch.from_numpy(rows), q, 20)
    valid = torch.isfinite(s[0])
    assert int(valid.sum()) == 13
    np.testing.assert_array_equal(i[0][valid].numpy(), np.lexsort((np.arange(13), -(rows @ q[0]))))


# ============================================================ DeviceIndex


@pytest.fixture()
def ivf_env(monkeypatch):
    for name in ("TPUCLIP_SHORTLIST", "TPUCLIP_INDEX_HBM_GB", "TPUCLIP_SHARDED_INDEX", "TPUCLIP_SEARCH_RERANK"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("TPUCLIP_SEARCH_PRECISION", "int8")
    monkeypatch.setenv("TPUCLIP_DEVICE_RERANK", "1")
    monkeypatch.setenv("TPUCLIP_SEARCH_MODE", "ivf")


def _store(path, vecs, start=0):
    store = MetadataStore(str(path), embedding_dim=DIM)
    store.init_schema(verbose=False)
    conn = sqlite3.connect(store.db_path)
    rows = [(f"/d/{'ab'[i % 2]}/{i:05d}.jpg", float(i), f"h{i}", vecs[i - start])
            for i in range(start, start + len(vecs))]
    store.commit_with_retry(conn.cursor(), conn, rows, save_full_embeddings=True)
    conn.close()
    return store


def _row(path):
    return int(path.rsplit("/", 1)[1].split(".")[0])


@pytest.fixture()
def clustered_store(tmp_path, ivf_env):
    rng = np.random.default_rng(45)
    vecs = _clustered(rng, 3000, DIM)
    return _store(tmp_path / "ivf.db", vecs), vecs, _clustered(rng, 5, DIM)


def test_device_index_ivf_routes(clustered_store, monkeypatch):
    store, vecs, queries = clustered_store
    index = pt_search.DeviceIndex(store, device="cpu")
    index.refresh()
    assert index._ivf is not None and index._ivf_trained_n == 3000
    exact = vecs @ queries.T
    for count in (1, 2, 5):
        batch = index.search_batch(queries[:count], 10)
        for q in range(count):
            single = index.search(queries[q], 10)
            assert single == batch[q]
            truth = set(np.argsort(-exact[:, q])[:10].tolist())
            assert len(truth & {_row(p) for p, _ in single}) / 10 >= 0.9
            for path, score in single:
                np.testing.assert_allclose(score, exact[_row(path), q], rtol=0, atol=1e-5)
    # Folder filters and k > 128 take the exact routes, as tpuclip's do.
    calls = []
    monkeypatch.setattr(pt_search, "ivf_search", lambda *a: calls.append(a))
    monkeypatch.setenv("TPUCLIP_SEARCH_MODE", "exact")
    plain = pt_search.DeviceIndex(store, device="cpu")
    assert index.search(queries[0], 10, filter_folders=["/d/a"]) == plain.search(queries[0], 10, ["/d/a"])
    assert index.search_batch(queries[:2], 200) == plain.search_batch(queries[:2], 200)
    assert calls == []


def test_device_index_matches_tpuclip_on_one_ivf(clustered_store):
    """Both indexes over one database, the port's given tpuclip's IVF index
    (the two draw their k-means initialisation from different generators):
    search and search_batch agree."""
    store, _, queries = clustered_store
    jx = jx_search.DeviceIndex(store, precision="int8")
    jx.refresh()
    pt = pt_search.DeviceIndex(store, device="cpu")
    pt.refresh()
    assert jx._ivf is not None
    pt._ivf = pt_ivf.ivf_from_jax(jx._ivf)
    for got, want in [(pt.search(queries[0], 10), jx.search(queries[0], 10)),
                      *zip(pt.search_batch(queries, 10), jx.search_batch(queries, 10))]:
        assert [p for p, _ in got] == [p for p, _ in want]
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want], rtol=0, atol=1e-6)


def test_retrain_rule(tmp_path, ivf_env):
    """Under 20% growth since the last training the centroids are reused;
    at 20% they are trained again, and the growth counts from that
    training, not from the last build."""
    rng = np.random.default_rng(48)
    vecs = _clustered(rng, 1400, DIM)
    store = _store(tmp_path / "grow.db", vecs[:1000])
    index = pt_search.DeviceIndex(store, device="cpu")
    index.refresh()
    first = index._ivf.centroids
    _store(tmp_path / "grow.db", vecs[1000:1100], start=1000)  # +10%
    index.refresh()
    assert torch.equal(index._ivf.centroids, first) and index._ivf_trained_n == 1000
    assert _reachable_once(index._ivf, 1100)
    _store(tmp_path / "grow.db", vecs[1100:1200], start=1100)  # +20% since the training
    index.refresh()
    assert index._ivf_trained_n == 1200
    assert index._ivf.centroids.shape[0] == pt_ivf.default_clusters(1200)


def test_small_database_builds_no_ivf(tmp_path, ivf_env):
    vecs = _clustered(np.random.default_rng(49), 40, DIM)
    index = pt_search.DeviceIndex(_store(tmp_path / "small.db", vecs), device="cpu")
    got = index.search(vecs[3], 5)
    assert index._ivf is None and _row(got[0][0]) == 3


@pytest.mark.parametrize("n_rows", [0, 63, 1000, 123_457, 1_000_000, 10_000_000])
def test_footprint_matches_tpuclip(n_rows):
    assert pt_search.DeviceIndex._ivf_footprint_bytes(n_rows, 1152) == \
        jx_search.DeviceIndex._ivf_footprint_bytes(n_rows, 1152)


def test_rerank_gate_counts_the_ivf_blocks(tmp_path, ivf_env, monkeypatch):
    """The auto gate on the card adds the IVF footprint, as tpuclip's on the
    TPU: 1M x 1152 bf16 rows + int8 fit 8 GB (3.456), not with IVF (+2.1)."""
    index = pt_search.DeviceIndex(_store(tmp_path / "g.db", _clustered(np.random.default_rng(1), 8, DIM)),
                                  device="cpu")
    index.device_rerank = "auto"
    index.device = torch.device("cuda")  # the gate reads only the device type
    index.matrix_dtype = torch.bfloat16
    monkeypatch.setattr(index.store, "embedding_dim", 1152)
    monkeypatch.setenv("TPUCLIP_DEVICE_RERANK_MAX_GB", "4")
    assert not index._want_device_rerank(1_000_000)
    index.search_mode = "exact"
    assert index._want_device_rerank(1_000_000)


# ============================================================ entry points


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A 300-row clustered database, a tiny checkpoint, a query image and
    both engines (tpuclip's and the port's) under the ivf mode."""
    tmp = tmp_path_factory.mktemp("torch_ivf")
    with pytest.MonkeyPatch.context() as mp:
        for key, value in {"TPUCLIP_SEARCH_PRECISION": "int8", "TPUCLIP_DEVICE_RERANK": "1",
                           "TPUCLIP_SEARCH_MODE": "ivf", "TPUCLIP_HOME": str(tmp / "home")}.items():
            mp.setenv(key, value)
        mp.delenv("TPUCLIP_SHORTLIST", raising=False)
        cache = tmp / "models"
        params = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(6), get_config(MODEL)))
        save_checkpoint(str(cache / MODEL.replace("/", "--")), params, get_config(MODEL))
        db = tmp / "w.db"
        _store(db, _clustered(np.random.default_rng(50), 300, DIM))
        image = tmp / "query.png"
        Image.fromarray(np.random.default_rng(51).integers(0, 256, (60, 50, 3), dtype=np.uint8)).save(image)
        eng_j = jx_engine.ImageDatabase(str(db), str(cache), model_name=MODEL, inference_batch_size=4)
        eng_t = pt_engine.ImageDatabase(str(db), str(cache), model_name=MODEL, inference_batch_size=4,
                                        device="cpu")
        yield tmp, cache, db, image, eng_j, eng_t


@pytest.fixture()
def counted_ivf(world, monkeypatch):
    """Env of the world; the port's and tpuclip's IVF searches counted."""
    for key, value in {"TPUCLIP_SEARCH_PRECISION": "int8", "TPUCLIP_DEVICE_RERANK": "1",
                       "TPUCLIP_SEARCH_MODE": "ivf", "TPUCLIP_HOME": str(world[0] / "home")}.items():
        monkeypatch.setenv(key, value)
    monkeypatch.delenv("TPUCLIP_SHORTLIST", raising=False)
    calls = {"port": 0, "tpuclip": 0}

    def counting(module, name):
        real = module.ivf_search

        def run(*args):
            calls[name] += 1
            return real(*args)

        monkeypatch.setattr(module, "ivf_search", run)

    counting(pt_search, "port")
    counting(jx_ivf, "tpuclip")
    return calls


def test_fused_gate_fault_is_not_copied(world, counted_ivf):
    """tpuclip's fused gate is open under IVF, so ``search_texts`` runs the
    exact fused scan and never probes; the port's is closed and its
    ``search_texts`` equals its IVF ``search_batch``."""
    *_, eng_j, eng_t = world
    texts = ["a red car", "blue sky", "a dog"]
    assert eng_j.index.can_fuse_text_search(5, None) and eng_j.index._ivf is not None
    eng_j.search_texts(texts, 5)
    assert counted_ivf["tpuclip"] == 0
    assert not eng_t.index.can_fuse_text_search(5, None) and eng_t.index._ivf is not None
    assert not eng_t.index.can_fuse_image_search(5, None)
    got = eng_t.search_texts(texts, 5)
    assert counted_ivf["port"] == 1
    assert got == eng_t.index.search_batch(eng_t.embed_texts_cached(texts), 5)
    assert all(len(r) == 5 for r in got)


def test_every_entry_point_probes_the_buckets(world, counted_ivf, monkeypatch):
    """``search`` (text and ``--image``) through the port's CLI, the
    engine's image search, ``warm_programs`` (the three ``search_batch``
    shapes, no graph) and ``serve``'s /search, /search_batch and image
    /search each run the IVF search, with the results of
    ``DeviceIndex.search`` / ``search_batch`` on the same embeddings;
    /stats reports the mode."""
    import tpuclip_torch.gallery.html as gallery

    tmp, cache, db, image, _, eng_t = world
    captured = []
    monkeypatch.setattr(gallery, "generate_html_gallery", lambda results, *a, **kw: captured.append(list(results)))
    common = ["--db", str(db), "--model", MODEL, "--model-cache", str(cache), "--device", "cpu",
              "--mode", "ivf", "--no-session", "-k", "5", "--output", str(tmp / "g.html")]
    pt_cli.main(["search", "a red car", *common])
    pt_cli.main(["search", "--image", str(image), *common])
    assert counted_ivf["port"] == 2 and len(captured) == 2 and all(len(r) == 5 for r in captured)

    img = Image.open(image)
    want = eng_t.index.search(eng_t._embed_pil(img), 5)
    assert eng_t.search_image_pil(img, 5) == want
    assert counted_ivf["port"] == 4
    assert pt_serve.warm_programs(eng_t, k=5) == 3 and counted_ivf["port"] == 7
    assert eng_t.index._graphs is None

    srv = pt_serve.SearchServer(eng_t, host="127.0.0.1", port=0)
    srv.start_background()
    try:
        def post(path, payload):
            req = urllib.request.Request(f"http://127.0.0.1:{srv.port}{path}", json.dumps(payload).encode(),
                                         {"Content-Type": "application/json"}, method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                return json.loads(r.read())

        before = counted_ivf["port"]
        text = post("/search", {"query": "a red car", "k": 5, "show_duplicates": True})["results"]
        texts = ["red", "green", "blue", "grey"]
        batch = post("/search_batch", {"queries": texts, "k": 3})["results"]
        b64 = base64.b64encode(image.read_bytes()).decode()
        by_image = post("/search", {"image_b64": b64, "k": 5, "show_duplicates": True})["results"]
        assert counted_ivf["port"] - before == 3
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/stats", timeout=60) as r:
            assert json.loads(r.read())["search_mode"] == "ivf"
    finally:
        srv.shutdown()

    def rows(results):
        return [(r["path"], r["similarity"]) for r in results]

    def close(got, ref):
        assert [p for p, _ in got] == [p for p, _ in ref]
        np.testing.assert_allclose([s for _, s in got], [s for _, s in ref], rtol=0, atol=1e-6)

    close(rows(text), eng_t.index.search_batch(eng_t.embed_texts_cached(["a red car"]), 5)[0])
    for got, ref in zip(batch, eng_t.index.search_batch(eng_t.embed_texts_cached(texts), 3)):
        close(rows(got), ref)
    close(rows(by_image), want)


# ============================================================ on the card


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel 1 has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_probe_matches_plain_route(cuda_device, data, host_builds):
    """``ivf_search`` on the card with kernel 1 against the same search with
    kernel 1's plain version on the same CUDA tensors: ids and scores
    identical, at Q = 1 and 8."""
    rows, queries = data
    cpu = host_builds[1]
    index = pt_ivf.IVFIndex(*(t.to(cuda_device) for t in cpu[:7]), cpu.nprobe)
    rows_d = torch.from_numpy(rows).to(cuda_device, torch.bfloat16)
    q = torch.from_numpy(queries).to(cuda_device)
    before = pt_ivf.int8_scores.launches
    got = [pt_ivf.ivf_search(index, rows_d, q[:n], 10) for n in (1, 8)]
    assert pt_ivf.int8_scores.launches == before + (1 + 1) + (8 + 1)
    from tpuclip_torch.ops.topk_int8 import _int8_scores_plain

    kernel = pt_ivf.int8_scores
    pt_ivf.int8_scores = _int8_scores_plain
    try:
        want = [pt_ivf.ivf_search(index, rows_d, q[:n], 10) for n in (1, 8)]
    finally:
        pt_ivf.int8_scores = kernel
    for (s, i), (s_p, i_p) in zip(got, want):
        assert torch.equal(i, i_p) and torch.equal(s, s_p)


@pytest.mark.cuda
def test_cuda_device_build_from_centroids_matches_host(cuda_device, data, host_builds):
    """The device build on the card from given centroids: field for field
    the CPU's device build from them (held to tpuclip's above), and the
    same bucket and overflow rows as the host build from them."""
    rows, _ = data
    cent = host_builds[1].centroids
    got = pt_ivf.build_ivf_device(torch.from_numpy(rows).to(cuda_device), k_clusters=64,
                                  centroids=cent.to(cuda_device))
    want = pt_ivf.build_ivf_device(torch.from_numpy(rows), k_clusters=64, centroids=cent)
    for a, b, name in zip(got[:7], want[:7], pt_ivf.IVFIndex._fields):
        assert torch.equal(a.cpu(), b), name
    host = pt_ivf.build_ivf(rows, k_clusters=64, centroids=cent.numpy(), device="cuda")
    assert torch.equal(got.bucket_rows.cpu(), host.bucket_rows.cpu())
    spilled = host.over_rows[host.over_rows >= 0].cpu()
    assert torch.equal(got.over_rows[got.over_rows >= 0].cpu(), spilled)
