"""The port's main path against tpuclip's, end to end on the CPU: the same
tiny checkpoint (written by tpuclip's ``save_checkpoint``), the same image
tree, ``scan`` then ``search --no-session`` through both CLIs, and a batch
of texts through both engines' ``search_texts``. tpuclip runs its int8
search with the resident rerank copy, the port's configuration."""

import importlib
import shutil
import sqlite3

import jax
import numpy as np
import pytest
from PIL import Image

import tpuclip.cli as jax_cli
import tpuclip_torch.cli as torch_cli
from tpuclip.models.checkpoint import save_checkpoint
from tpuclip.models.configs import get_config
from tpuclip.models.siglip import init_params

MODEL = "tpuclip/test-tiny"


@pytest.fixture()
def world(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUCLIP_HOME", str(tmp_path / "home"))
    monkeypatch.setenv("TPUCLIP_SEARCH_PRECISION", "int8")
    monkeypatch.setenv("TPUCLIP_DEVICE_RERANK", "1")
    monkeypatch.delenv("TPUCLIP_SHORTLIST", raising=False)
    cache = tmp_path / "models"
    params = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(3), get_config(MODEL)))
    save_checkpoint(str(cache / MODEL.replace("/", "--")), params, get_config(MODEL))
    root = tmp_path / "imgs"
    rng = np.random.default_rng(21)
    for i in range(12):
        folder = root / ("a" if i < 6 else "b")
        folder.mkdir(parents=True, exist_ok=True)
        arr = rng.integers(0, 256, (40 + i, 48, 3), dtype=np.uint8)
        Image.fromarray(arr).save(folder / f"img_{i:02d}.png")
    shutil.copyfile(root / "a" / "img_00.png", root / "b" / "copy_of_00.png")
    return tmp_path, cache, root


def _scan_and_search(cli, tmp_path, cache, root, name, extra, monkeypatch, search_flags=()):
    """Runs ``scan`` + ``search`` through ``cli``; returns (db path, the
    results the search handed to its gallery)."""
    # The gallery of the CLI's own package: tpuclip's, or the port's copy.
    gallery = importlib.import_module(cli.__name__.rsplit(".", 1)[0] + ".gallery.html")

    db = str(tmp_path / f"{name}.db")
    common = ["--db", db, "--model", MODEL, "--model-cache", str(cache), *extra]
    cli.main(["scan", str(root), "--inference-batch-size", "4", *common])
    captured = []
    monkeypatch.setattr(
        gallery, "generate_html_gallery",
        lambda results, *a, **kw: captured.append(list(results)),
    )
    cli.main([
        "search", "a red car", "-k", "5", "--no-session",
        "--output", str(tmp_path / f"{name}.html"), *search_flags, *common,
    ])
    assert len(captured) == 1
    return db, captured[0]


def _table(db, sql):
    conn = sqlite3.connect(db)
    try:
        return conn.execute(sql).fetchall()
    finally:
        conn.close()


def _engine(module, db, cache, **kw):
    return module.ImageDatabase(db, str(cache), model_name=MODEL, inference_batch_size=4, **kw)


def test_scan_search_slice_matches_tpuclip(world, monkeypatch):
    tmp_path, cache, root = world
    db_j, res_j = _scan_and_search(jax_cli, tmp_path, cache, root, "jax", [], monkeypatch)
    db_t, res_t = _scan_and_search(
        torch_cli, tmp_path, cache, root, "torch", ["--device", "cpu"], monkeypatch
    )

    images = "SELECT id, file_path, last_modified, file_hash FROM images ORDER BY id"
    assert _table(db_t, images) == _table(db_j, images)
    assert len(_table(db_t, images)) == 13
    binary = "SELECT image_id, embedding FROM binary_embeddings ORDER BY image_id"
    assert _table(db_t, binary) == _table(db_j, binary)
    vectors = "SELECT image_id, vector FROM embeddings ORDER BY image_id"
    vj, vt = _table(db_j, vectors), _table(db_t, vectors)
    assert [r[0] for r in vt] == [r[0] for r in vj]
    ej = np.stack([np.frombuffer(r[1], np.float32) for r in vj])
    et = np.stack([np.frombuffer(r[1], np.float32) for r in vt])
    assert np.min(np.sum(ej * et, axis=1)) >= 0.9999

    assert len(res_t) == 5
    assert [p for p, _ in res_t] == [p for p, _ in res_j]
    np.testing.assert_allclose([s for _, s in res_t], [s for _, s in res_j], rtol=0, atol=1e-5)

    import tpuclip.engine as jax_engine
    import tpuclip_torch.engine as torch_engine

    texts = ["a red car", "blue sky", "two dogs on a beach"]
    want = _engine(jax_engine, db_j, cache).search_texts(texts, 5)
    got = _engine(torch_engine, db_t, cache, device="cpu").search_texts(texts, 5)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert [p for p, _ in g] == [p for p, _ in w]
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], rtol=0, atol=1e-5)


def test_cli_refuses_what_is_not_ported(world, monkeypatch):
    tmp_path, cache, root = world
    db = str(tmp_path / "t.db")
    common = ["--db", db, "--model", MODEL, "--model-cache", str(cache), "--device", "cpu"]
    torch_cli.main(["scan", str(root / "a"), *common])
    # The session is ported: on a non-tty stdin it runs the query and returns.
    torch_cli.main(["search", "a red car", *common])
    with pytest.raises(SystemExit) as exc:  # training is not
        torch_cli.main(["train", str(root), "--output", str(tmp_path / "out")])
    assert exc.value.code == 2
    monkeypatch.setenv("TPUCLIP_SEARCH_MODE", "exact")  # the CLI sets it; restored afterwards
    with pytest.raises(NotImplementedError, match="ivf"):
        torch_cli.main(["search", "a red car", "--no-session", "--mode", "ivf", *common])


def test_cli_folder_filter_matches_tpuclip(world, monkeypatch):
    """``search --folder <root>/a`` through both CLIs: the same gallery
    results, all under ``a``. The int8 search keeps its rows resident, so
    the filtered query takes the masked route and its fp32 host rescore."""
    tmp_path, cache, root = world
    flags = ["--folder", str(root / "a")]
    _, res_j = _scan_and_search(jax_cli, tmp_path, cache, root, "jax", [], monkeypatch, flags)
    _, res_t = _scan_and_search(
        torch_cli, tmp_path, cache, root, "torch", ["--device", "cpu"], monkeypatch, flags
    )
    assert len(res_t) == 5
    assert all(p.startswith(str(root / "a") + "/") for p, _ in res_t)
    assert [p for p, _ in res_t] == [p for p, _ in res_j]
    # Each CLI scanned its own database with its own towers: 1e-5, as above.
    np.testing.assert_allclose([s for _, s in res_t], [s for _, s in res_j], rtol=0, atol=1e-5)


class _StubEngine:
    """Deterministic unit vectors per query string, for the query algebra."""

    def _vector(self, key):
        v = np.random.default_rng(sum(map(ord, key))).standard_normal(16).astype(np.float32)
        return v / np.linalg.norm(v)

    def _get_text_embedding(self, text):
        return self._vector("text:" + text)

    def _get_image_embedding(self, path):
        return self._vector("image:" + path)


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(query2="blue sky", weights=(0.7, 0.3)),
        dict(query2="blue sky", weights=(0.0, 0.0)),
        dict(negative_query="a dog", negative_weight=0.4),
        dict(negative_query="a red car", negative_weight=1.0),  # zero norm: restore the query
        dict(query2="x", negative_queries=["a dog", "night"], negative_weights=[0.2, 0.5]),
    ],
    ids=["blend", "zero-weights", "negative", "negative-cancels", "negatives-list"],
)
def test_query_algebra_matches_tpuclip(kwargs):
    import tpuclip.pipelines.search as jax_search
    import tpuclip_torch.pipelines.search as torch_search

    want = jax_search.build_query_vector(_StubEngine(), "a red car", **kwargs)
    got = torch_search.build_query_vector(_StubEngine(), "a red car", **kwargs)
    np.testing.assert_array_equal(got, want)
