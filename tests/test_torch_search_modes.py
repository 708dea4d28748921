"""The port's search modes against tpuclip's, on the CPU: bf16 precision,
binary-only databases, the binary cascade, the capacity gate, and the int8
route above k = 128, first through both ``DeviceIndex`` classes over one
SQLite database, then end to end through both CLIs and engines on the tiny
preset (the same checkpoint, written by tpuclip's ``save_checkpoint``),
folder filters included.
Where tpuclip's cascade takes its single-query scores prefilter, its binary
rows are put in the TPU's grouped layout and its Pallas kernel runs in
interpret mode."""

import importlib
import shutil
import sqlite3

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import tpuclip.cli as jax_cli
import tpuclip.engine as jax_engine
import tpuclip.index.search as jax_search
import tpuclip_torch.cli as torch_cli
import tpuclip_torch.engine as torch_engine
from tpuclip.index.store import MetadataStore
from tpuclip.models.checkpoint import save_checkpoint
from tpuclip.models.configs import get_config
from tpuclip.models.siglip import init_params
from tpuclip.ops.hamming import pad_words_grouped
from tpuclip_torch.index.search import DeviceIndex as TorchIndex

DIM = 64
MODEL = "tpuclip/test-tiny"
_ENV = (
    "TPUCLIP_SEARCH_PRECISION", "TPUCLIP_DEVICE_RERANK", "TPUCLIP_SEARCH_RERANK",
    "TPUCLIP_SEARCH_MODE", "TPUCLIP_CASCADE_DEPTH", "TPUCLIP_CASCADE_PREFILTER",
    "TPUCLIP_SHORTLIST", "TPUCLIP_INDEX_HBM_GB", "TPUCLIP_SHARDED_INDEX",
)


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    """Both packages read the search knobs from the environment; every test
    starts from tpuclip's int8 + resident-rerank configuration."""
    for name in _ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("TPUCLIP_SEARCH_PRECISION", "int8")
    monkeypatch.setenv("TPUCLIP_DEVICE_RERANK", "1")
    monkeypatch.setenv("TPUCLIP_SEARCH_MODE", "exact")  # the CLIs set it; restored afterwards


def _unit(rng, n, d=DIM):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _build_db(tmp_path, vecs, name="m.db", full=True):
    store = MetadataStore(str(tmp_path / name), embedding_dim=DIM)
    store.init_schema(verbose=False)
    conn = sqlite3.connect(store.db_path)
    batch = [(f"/img/{i:04d}.jpg", float(i), f"h{i}", vecs[i]) for i in range(len(vecs))]
    store.commit_with_retry(conn.cursor(), conn, batch, save_full_embeddings=full)
    conn.close()
    return store


def _group_binary_rows(index):
    """tpuclip's TPU layout for the binary rows (W, 8, N/8), so that its
    cascade takes the scores prefilter off the TPU too."""
    if index._bin_matrix is not None and index._bin_layout == "rows":
        wg, nv = pad_words_grouped(np.asarray(index._bin_matrix))
        index._bin_matrix = jnp.asarray(wg)
        index._bin_n_valid = jnp.asarray(nv, jnp.int32)
        index._bin_layout = "grouped"


def _grouped_refresh(monkeypatch):
    original = jax_search.DeviceIndex.refresh

    def refresh(self, force=False):
        original(self, force)
        _group_binary_rows(self)

    monkeypatch.setattr(jax_search.DeviceIndex, "refresh", refresh)


def _assert_same(got, want, atol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [p for p, _ in g] == [p for p, _ in w]
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], rtol=0, atol=atol)


def _search_both(jx, tx, queries, k):
    if len(queries) == 1:
        return [tx.search(queries[0], k)], [jx.search(queries[0], k)]
    return tx.search_batch(queries, k), jx.search_batch(queries, k)


# ============================================================ DeviceIndex


@pytest.fixture(scope="module")
def vecs():
    return _unit(np.random.default_rng(5), 1500)


@pytest.mark.parametrize("q_count", [1, 4])
def test_int8_above_k128_rescores_fp32_from_host(tmp_path, vecs, q_count):
    """Above k = 128 tpuclip rescores an int8 shortlist in fp32 from the host
    memmap; the port must too, not against the bf16 device rows."""
    store = _build_db(tmp_path, vecs)
    jx = jax_search.DeviceIndex(store, matrix_dtype=jnp.bfloat16)
    tx = TorchIndex(store, device="cpu", matrix_dtype=torch.bfloat16)
    queries = _unit(np.random.default_rng(11), q_count)
    got, want = _search_both(jx, tx, queries, 200)
    _assert_same(got, want, atol=1e-6)
    for q, results in zip(queries, got):
        assert len(results) == 200
        rows = [int(p[5:9]) for p, _ in results]
        np.testing.assert_allclose([s for _, s in results], vecs[rows] @ q, rtol=0, atol=1e-6)


@pytest.mark.parametrize("k", [10, 200])
@pytest.mark.parametrize("q_count", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bf16_precision_matches_tpuclip(tmp_path, vecs, monkeypatch, dtype, q_count, k):
    monkeypatch.setenv("TPUCLIP_SEARCH_PRECISION", "bf16")
    store = _build_db(tmp_path, vecs)
    jx = jax_search.DeviceIndex(store, matrix_dtype=getattr(jnp, dtype))
    tx = TorchIndex(store, device="cpu", matrix_dtype=getattr(torch, dtype))
    got, want = _search_both(jx, tx, _unit(np.random.default_rng(12), q_count), k)
    _assert_same(got, want, atol=1e-6 if dtype == "float32" else 1e-5)
    assert tx._matrix.dtype == getattr(torch, dtype) and tx._scales is None


@pytest.mark.parametrize("k", [5, 20, 2000])
@pytest.mark.parametrize("q_count", [1, 3])
def test_binary_only_database_matches_tpuclip(tmp_path, vecs, q_count, k):
    store = _build_db(tmp_path, vecs, full=False)
    jx = jax_search.DeviceIndex(store)
    tx = TorchIndex(store, device="cpu")
    got, want = _search_both(jx, tx, _unit(np.random.default_rng(13), q_count), k)
    _assert_same(got, want, atol=0)
    assert tx._matrix is None and tx.num_binary == len(vecs) and tx.num_full == 0


@pytest.mark.parametrize("q_count", [1, 3])
@pytest.mark.parametrize("prefilter", ["exact", "scores"])
def test_cascade_matches_tpuclip(tmp_path, monkeypatch, prefilter, q_count):
    """A shortlist smaller than the index (depth 100 over 1500 rows): both
    packages must pick the same rows and rescore them alike."""
    vecs = _unit(np.random.default_rng(6), 1500)
    store = _build_db(tmp_path, vecs)
    monkeypatch.setenv("TPUCLIP_SEARCH_MODE", "cascade")
    monkeypatch.setenv("TPUCLIP_CASCADE_DEPTH", "100")
    monkeypatch.setenv("TPUCLIP_CASCADE_PREFILTER", prefilter)
    jx = jax_search.DeviceIndex(store)
    if prefilter == "scores":
        jx.refresh()
        _group_binary_rows(jx)
    tx = TorchIndex(store, device="cpu")
    got, want = _search_both(jx, tx, _unit(np.random.default_rng(14), q_count), 10)
    _assert_same(got, want, atol=1e-6)
    assert tx._matrix is None and tx._cascade


@pytest.mark.parametrize("prefilter", ["exact", "scores"])
def test_cascade_full_depth_equals_exact(tmp_path, monkeypatch, prefilter):
    """With depth = N the prefilter passes every row, so the results are the
    exact scan's."""
    vecs = _unit(np.random.default_rng(5), 400)
    store = _build_db(tmp_path, vecs)
    exact = TorchIndex(store, device="cpu")
    monkeypatch.setenv("TPUCLIP_SEARCH_MODE", "cascade")
    monkeypatch.setenv("TPUCLIP_CASCADE_DEPTH", str(len(vecs)))
    monkeypatch.setenv("TPUCLIP_CASCADE_PREFILTER", prefilter)
    casc = TorchIndex(store, device="cpu")
    queries = _unit(np.random.default_rng(9), 3)
    for q in queries:
        _assert_same([casc.search(q, 10)], [exact.search(q, 10)], atol=1e-6)
    _assert_same(casc.search_batch(queries, 10), exact.search_batch(queries, 10), atol=1e-6)
    assert casc._matrix is None and casc._cascade


def test_cascade_batch_matches_single(tmp_path, monkeypatch):
    vecs = _unit(np.random.default_rng(5), 400)
    store = _build_db(tmp_path, vecs)
    monkeypatch.setenv("TPUCLIP_SEARCH_MODE", "cascade")
    monkeypatch.setenv("TPUCLIP_CASCADE_DEPTH", "50")
    monkeypatch.setenv("TPUCLIP_CASCADE_PREFILTER", "exact")
    casc = TorchIndex(store, device="cpu")
    queries = _unit(np.random.default_rng(1), 3)
    batched = casc.search_batch(queries, 5)
    for qi in range(3):
        assert batched[qi] == casc.search(queries[qi], 5)


def test_cascade_falls_back_when_binary_misaligned(tmp_path, monkeypatch):
    """An extra binary-only row breaks alignment: the index falls back to the
    exact scan (flat matrix built) rather than mis-map rows."""
    vecs = _unit(np.random.default_rng(5), 400)
    store = _build_db(tmp_path, vecs)
    conn = sqlite3.connect(store.db_path)
    conn.execute(
        "INSERT INTO images (file_path, last_modified, file_hash) VALUES (?, ?, ?)",
        ("/img/extra.jpg", 0.0, "hx"),
    )
    extra_id = conn.execute("SELECT id FROM images WHERE file_path = '/img/extra.jpg'").fetchone()[0]
    conn.execute(
        "INSERT INTO binary_embeddings (image_id, embedding) VALUES (?, ?)",
        (extra_id, np.ones(DIM, np.uint8).tobytes()),
    )
    conn.commit()
    conn.close()
    monkeypatch.setenv("TPUCLIP_SEARCH_MODE", "cascade")
    casc = TorchIndex(store, device="cpu")
    got = casc.search(vecs[3], 3)
    assert got[0][0] == "/img/0003.jpg"
    assert not casc._cascade and casc._matrix is not None


@pytest.mark.parametrize("depth", ["2k", "0", "-5"])
def test_cascade_malformed_depth_takes_the_default(tmp_path, monkeypatch, depth):
    vecs = _unit(np.random.default_rng(5), 1500)
    store = _build_db(tmp_path, vecs)
    monkeypatch.setenv("TPUCLIP_SEARCH_MODE", "cascade")
    monkeypatch.setenv("TPUCLIP_CASCADE_DEPTH", depth)
    casc = TorchIndex(store, device="cpu")
    assert len(casc.search(vecs[8], 5)) == 5
    assert casc._cascade_depth(5) == 512 and casc._cascade_depth(100) == 1500


@pytest.mark.parametrize("cap", ["1e-9", "not-a-number"])
def test_index_hbm_cap_matches_tpuclip(tmp_path, vecs, monkeypatch, cap):
    """Under TPUCLIP_INDEX_HBM_GB the flat matrix that exceeds it is not
    uploaded and the binary rows serve; a malformed cap is ignored."""
    monkeypatch.setenv("TPUCLIP_INDEX_HBM_GB", cap)
    store = _build_db(tmp_path, vecs)
    tx = TorchIndex(store, device="cpu")
    queries = _unit(np.random.default_rng(15), 3)
    got = tx.search_batch(queries, 10)
    assert (tx._matrix is None) == (cap == "1e-9")
    if cap == "1e-9":
        _assert_same(got, jax_search.DeviceIndex(store).search_batch(queries, 10), atol=0)
        assert all(s == int(s * DIM) / DIM for results in got for _, s in results)


def test_unknown_settings_raise(tmp_path, vecs, monkeypatch):
    """Unknown modes and precisions raise. ``ivf`` is ported: on 10 rows
    (under the 64 an IVF index needs) both packages take the exact route
    and agree. The mesh-sharded index is ported: ``TPUCLIP_SHARDED_INDEX=1``
    with one device (the CPU) builds no mesh, as tpuclip's rule, and agrees
    with tpuclip's (sharded over its 8 virtual devices)."""
    store = _build_db(tmp_path, vecs[:10])
    monkeypatch.setenv("TPUCLIP_SEARCH_MODE", "ivf")
    queries = _unit(np.random.default_rng(16), 2)
    tx = TorchIndex(store, device="cpu")
    _assert_same(tx.search_batch(queries, 5), jax_search.DeviceIndex(store).search_batch(queries, 5), atol=1e-6)
    assert tx._ivf is None
    monkeypatch.setenv("TPUCLIP_SHARDED_INDEX", "1")
    tx = TorchIndex(store, device="cpu")
    jx = jax_search.DeviceIndex(store)
    assert tx.mesh is None and jx.mesh is not None
    _assert_same(tx.search_batch(queries, 5), jx.search_batch(queries, 5), atol=1e-6)
    monkeypatch.delenv("TPUCLIP_SHARDED_INDEX")
    monkeypatch.setenv("TPUCLIP_SEARCH_MODE", "nearest")
    with pytest.raises(ValueError):
        TorchIndex(store, device="cpu")
    monkeypatch.setenv("TPUCLIP_SEARCH_MODE", "exact")
    monkeypatch.setenv("TPUCLIP_SEARCH_PRECISION", "fp8")
    with pytest.raises(ValueError):
        TorchIndex(store, device="cpu")


# ======================================================== CLIs and engines


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """One image tree scanned by both CLIs into a full and a binary-only
    database each: {name: db path}, plus the model cache."""
    tmp = tmp_path_factory.mktemp("modes")
    cache = tmp / "models"
    params = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(3), get_config(MODEL)))
    save_checkpoint(str(cache / MODEL.replace("/", "--")), params, get_config(MODEL))
    root = tmp / "imgs"
    rng = np.random.default_rng(21)
    for i in range(14):
        folder = root / ("a" if i < 7 else "b")
        folder.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (40 + i, 48, 3), dtype=np.uint8)).save(
            folder / f"img_{i:02d}.png"
        )
    shutil.copyfile(root / "a" / "img_00.png", root / "b" / "copy_of_00.png")
    dbs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPUCLIP_HOME", str(tmp / "home"))
        for name, cli, extra in (("jax", jax_cli, []), ("torch", torch_cli, ["--device", "cpu"])):
            for kind, flags in (("full", []), ("binary", ["--binary-only"])):
                db = str(tmp / f"{name}_{kind}.db")
                cli.main([
                    "scan", str(root), "--db", db, "--model", MODEL, "--model-cache", str(cache),
                    "--inference-batch-size", "4", *flags, *extra,
                ])
                dbs[name, kind] = db
    return tmp, cache, dbs


def _cli_search(cli, tmp, cache, db, extra, monkeypatch):
    # The gallery of the CLI's own package: tpuclip's, or the port's copy.
    gallery = importlib.import_module(cli.__name__.rsplit(".", 1)[0] + ".gallery.html")

    captured = []
    monkeypatch.setattr(
        gallery, "generate_html_gallery",
        lambda results, *a, **kw: captured.append(list(results)),
    )
    cli.main([
        "search", "a red car", "-k", "5", "--no-session", "--db", db, "--model", MODEL,
        "--model-cache", str(cache), "--output", str(tmp / "out.html"), *extra,
    ])
    assert len(captured) == 1
    return captured[0]


def _both_clis(world, kind, flags, monkeypatch):
    tmp, cache, dbs = world
    monkeypatch.setenv("TPUCLIP_HOME", str(tmp / "home"))
    want = _cli_search(jax_cli, tmp, cache, dbs["jax", kind], flags, monkeypatch)
    got = _cli_search(torch_cli, tmp, cache, dbs["torch", kind], [*flags, "--device", "cpu"], monkeypatch)
    assert len(got) == 5
    _assert_same([got], [want], atol=1e-5)


def _both_engines(world, kind, folders=None):
    tmp, cache, dbs = world
    texts = ["a red car", "blue sky", "two dogs on a beach"]
    kw = dict(model_name=MODEL, inference_batch_size=4)
    want = jax_engine.ImageDatabase(dbs["jax", kind], str(cache), **kw).search_texts(texts, 5, folders)
    got = torch_engine.ImageDatabase(dbs["torch", kind], str(cache), device="cpu", **kw).search_texts(
        texts, 5, folders
    )
    assert [len(r) for r in got] == [5, 5, 5]
    _assert_same(got, want, atol=1e-5)
    return got


def test_cli_bf16_precision_matches_tpuclip(world, monkeypatch):
    _both_clis(world, "full", ["--precision", "bf16"], monkeypatch)
    _both_engines(world, "full")  # the CLI left TPUCLIP_SEARCH_PRECISION=bf16


@pytest.mark.parametrize("prefilter", ["exact", "scores"])
def test_cli_cascade_matches_tpuclip(world, monkeypatch, prefilter):
    monkeypatch.setenv("TPUCLIP_CASCADE_PREFILTER", prefilter)
    if prefilter == "scores":
        _grouped_refresh(monkeypatch)
    _both_clis(world, "full", ["--mode", "cascade"], monkeypatch)
    _both_engines(world, "full")  # the CLI left TPUCLIP_SEARCH_MODE=cascade


def test_cli_binary_only_matches_tpuclip(world, monkeypatch):
    _both_clis(world, "binary", [], monkeypatch)
    _both_engines(world, "binary")


@pytest.mark.parametrize("setting", ["int8", "int8-host", "bf16", "cascade", "binary"])
def test_cli_folder_filter_matches_tpuclip(world, monkeypatch, setting):
    """``search --folder <root>/b`` and a filtered ``search_texts`` in each
    mode; ``int8-host`` is the int8 search without the rerank copy
    (TPUCLIP_DEVICE_RERANK=0)."""
    tmp, _, _ = world
    folder = str(tmp / "imgs" / "b")
    flags = {"bf16": ["--precision", "bf16"], "cascade": ["--mode", "cascade"]}.get(setting, [])
    if setting == "int8-host":
        monkeypatch.setenv("TPUCLIP_DEVICE_RERANK", "0")
    kind = "binary" if setting == "binary" else "full"
    _both_clis(world, kind, [*flags, "--folder", folder], monkeypatch)
    got = _both_engines(world, kind, [folder])
    assert all(p.startswith(folder + "/") for results in got for p, _ in results)
