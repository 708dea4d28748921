"""Folder filters, the int8 search without the resident rerank copy, and
the int8 search without a rescore, through both ``DeviceIndex`` classes over
one SQLite database on the CPU: ids identical, scores bit-equal without the
rescore, within 1e-6 with the fp32 rescore and within 1e-5 in bf16.

The database holds 1,500 64-d unit rows under five folders, one of them
named with LIKE's wildcards (``a_%b``) beside one those wildcards would
match (``axyzb``), and one (``c``) with only three rows."""

import sqlite3

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuclip.index.search as jax_search
from tpuclip.index.store import MetadataStore
from tpuclip_torch.index.search import DeviceIndex as TorchIndex
from tpuclip_torch.ops import topk_int8 as pt

DIM = 64
N = 1500
FOLDERS = ["a", "b", "a_%b", "axyzb"]
_ENV = (
    "TPUCLIP_SEARCH_PRECISION", "TPUCLIP_DEVICE_RERANK", "TPUCLIP_DEVICE_RERANK_MAX_GB",
    "TPUCLIP_SEARCH_RERANK", "TPUCLIP_SEARCH_MODE", "TPUCLIP_CASCADE_DEPTH",
    "TPUCLIP_CASCADE_PREFILTER", "TPUCLIP_SHORTLIST", "TPUCLIP_INDEX_HBM_GB",
    "TPUCLIP_SHARDED_INDEX",
)


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    """Both packages read the search knobs from the environment; every test
    starts from int8 precision, the exact mode and the ``auto`` gate."""
    for name in _ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("TPUCLIP_SEARCH_PRECISION", "int8")
    monkeypatch.setenv("TPUCLIP_SEARCH_MODE", "exact")


def _unit(rng, n, d=DIM):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _path(i):
    folder = "c" if i < 3 else FOLDERS[i % len(FOLDERS)]
    return f"/img/{folder}/{i:04d}.jpg"


def _row(path):
    return int(path[-8:-4])


@pytest.fixture(scope="module")
def vecs():
    return _unit(np.random.default_rng(5), N)


def _insert(store, vecs, start=0, full=True):
    conn = sqlite3.connect(store.db_path)
    batch = [(_path(start + i), float(i), f"h{start + i}", v) for i, v in enumerate(vecs)]
    store.commit_with_retry(conn.cursor(), conn, batch, save_full_embeddings=full)
    conn.close()


def _build_db(tmp_path, vecs, full=True):
    store = MetadataStore(str(tmp_path / "f.db"), embedding_dim=DIM)
    store.init_schema(verbose=False)
    _insert(store, vecs, full=full)
    return store


def _indexes(store, dtype="float32"):
    return (
        jax_search.DeviceIndex(store, matrix_dtype=getattr(jnp, dtype)),
        TorchIndex(store, device="cpu", matrix_dtype=getattr(torch, dtype)),
    )


def _search_both(jx, tx, queries, k, folders=None):
    if len(queries) == 1:
        return [tx.search(queries[0], k, folders)], [jx.search(queries[0], k, folders)]
    return tx.search_batch(queries, k, folders), jx.search_batch(queries, k, folders)


def _assert_same(got, want, atol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [p for p, _ in g] == [p for p, _ in w]
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], rtol=0, atol=atol)


def _assert_fp32_dots(results, queries, vecs):
    """Every score is the row's fp32 dot with its query, within 1e-6."""
    for q, res in zip(queries, results):
        rows = [_row(p) for p, _ in res]
        np.testing.assert_allclose([s for _, s in res], vecs[rows] @ q, rtol=0, atol=1e-6)


@pytest.fixture()
def kernel3_calls(monkeypatch):
    """Counts the searches that reach kernel 3's wrapper (here its plain
    version runs)."""
    calls = []
    original = pt.int8_candidates

    def spy(*args):
        calls.append(args[3])  # k_tile
        return original(*args)

    monkeypatch.setattr(pt, "int8_candidates", spy)
    return calls


# ================================================= without the rerank copy


@pytest.mark.parametrize("k", [5, 20, 32, 33, 200])
@pytest.mark.parametrize("q_count", [1, 4])
def test_host_route_matches_tpuclip(tmp_path, vecs, monkeypatch, kernel3_calls, q_count, k):
    """TPUCLIP_DEVICE_RERANK=0: only the int8 matrix (from the fp32 rows)
    and its scales are resident; a max(4k, 64) shortlist is rescored in fp32
    from the host. One query with a shortlist <= 128 takes kernel 3."""
    monkeypatch.setenv("TPUCLIP_DEVICE_RERANK", "0")
    store = _build_db(tmp_path, vecs)
    jx, tx = _indexes(store)
    queries = _unit(np.random.default_rng(11), q_count)
    got, want = _search_both(jx, tx, queries, k)
    _assert_same(got, want, atol=1e-6)
    _assert_fp32_dots(got, queries, vecs)
    assert all(len(r) == k for r in got)
    assert tx._rows_device is None and tx._matrix.dtype == torch.int8
    # int8 matrix + scales, and the packed binary rows every index keeps.
    assert tx.resident_bytes() == tx._matrix.numel() + 4 * tx._scales.numel() + 4 * tx._bin_matrix.numel()
    assert kernel3_calls == ([max(4 * k, 64)] if q_count == 1 and k <= 32 else [])


@pytest.mark.parametrize("k", [20, 200])
@pytest.mark.parametrize("q_count", [1, 4])
def test_no_rerank_matches_tpuclip(tmp_path, vecs, monkeypatch, kernel3_calls, q_count, k):
    """TPUCLIP_SEARCH_RERANK=0: the int8 scores x q_scale themselves, bit
    for bit; the host query quantizer for one query, the jitted one for a
    batch."""
    monkeypatch.setenv("TPUCLIP_SEARCH_RERANK", "0")
    monkeypatch.setenv("TPUCLIP_DEVICE_RERANK", "1")  # ignored without the rescore
    store = _build_db(tmp_path, vecs)
    jx, tx = _indexes(store)
    got, want = _search_both(jx, tx, _unit(np.random.default_rng(12), q_count), k)
    _assert_same(got, want, atol=0)
    assert all(len(r) == k for r in got) and tx._rows_device is None
    assert kernel3_calls == ([k] if q_count == 1 and k <= 128 else [])


@pytest.mark.parametrize("q_count", [1, 4])
def test_auto_on_the_cpu_matches_tpuclip(tmp_path, vecs, q_count):
    """Under ``auto`` off CUDA the port, like tpuclip off the TPU, keeps no
    rerank copy."""
    store = _build_db(tmp_path, vecs)
    jx, tx = _indexes(store)
    got, want = _search_both(jx, tx, _unit(np.random.default_rng(13), q_count), 10)
    _assert_same(got, want, atol=1e-6)
    assert tx._rows_device is None and jx._rows_device is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_device_rerank_gate_matches_tpuclip(tmp_path, vecs, monkeypatch, dtype):
    """The gate's decisions around the budget, with CUDA standing in for the
    TPU: (1 + itemsize) * N * D bytes against TPUCLIP_DEVICE_RERANK_MAX_GB."""
    store = _build_db(tmp_path, vecs[:10])
    itemsize = 4 if dtype == "float32" else 2
    per_row = (1 + itemsize) * DIM
    cases = [(env, budget, n) for env in ("auto", "1", "0") for budget in (None, 1000 * per_row / 1e9)
             for n in (1, 999, 1000, 1001, 10**9)]
    for env, budget, n in cases:
        monkeypatch.setenv("TPUCLIP_DEVICE_RERANK", env)
        if budget is None:
            monkeypatch.delenv("TPUCLIP_DEVICE_RERANK_MAX_GB", raising=False)
        else:
            monkeypatch.setenv("TPUCLIP_DEVICE_RERANK_MAX_GB", repr(budget))
        jx, tx = _indexes(store, dtype)
        assert not tx._want_device_rerank(n) or env != "0"
        if env == "auto":
            assert not tx._want_device_rerank(n)  # the CPU: never under auto
        tx.device = torch.device("cuda")
        with monkeypatch.context() as mp:
            mp.setattr(jax, "default_backend", lambda: "tpu")
            want = jx._want_device_rerank(n)
        assert tx._want_device_rerank(n) == want, (env, budget, n)
        if env == "auto" and budget is not None:
            assert want == (n <= 1000)


# ======================================================== folder filters


MODES = {
    # name: (environment, database with full vectors, matrix dtype, score tolerance)
    "int8-resident-bf16": ({"TPUCLIP_DEVICE_RERANK": "1"}, True, "bfloat16", 1e-6),
    "int8-host": ({"TPUCLIP_DEVICE_RERANK": "0"}, True, "float32", 1e-6),
    "int8-no-rerank": ({"TPUCLIP_SEARCH_RERANK": "0"}, True, "float32", 0),
    "bf16": ({"TPUCLIP_SEARCH_PRECISION": "bf16"}, True, "bfloat16", 1e-5),
    "binary": ({}, False, "float32", 0),
    "cascade": ({"TPUCLIP_SEARCH_MODE": "cascade", "TPUCLIP_CASCADE_DEPTH": "100"}, True, "float32", 1e-6),
}


@pytest.mark.parametrize("folders", [["/img/a_%b"], ["/img/b", "/img/c"]], ids=["wildcards", "two"])
@pytest.mark.parametrize("q_count", [1, 4])
@pytest.mark.parametrize("mode", list(MODES))
def test_folder_filter_matches_tpuclip(tmp_path, vecs, monkeypatch, mode, q_count, folders):
    env, full, dtype, atol = MODES[mode]
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    store = _build_db(tmp_path, vecs, full=full)
    jx, tx = _indexes(store, dtype)
    queries = _unit(np.random.default_rng(14), q_count)
    got, want = _search_both(jx, tx, queries, 10, folders)
    _assert_same(got, want, atol=atol)
    prefixes = tuple(f + "/" for f in folders)
    assert all(len(r) == 10 and all(p.startswith(prefixes) for p, _ in r) for r in got)
    if mode == "int8-resident-bf16":
        # The rows are resident in bf16, yet a masked search is rescored in
        # fp32 from the host memmap.
        assert tx._rows_device is not None and tx._rows_device.dtype == torch.bfloat16
        _assert_fp32_dots(got, queries, vecs)
    if mode == "binary":
        assert tx._matrix is None and tx.num_binary == N


@pytest.mark.parametrize("mode", list(MODES))
def test_filters_with_few_or_no_rows(tmp_path, vecs, monkeypatch, mode):
    """A folder with 3 rows gives 3 results at k = 10; a folder no row lies
    in gives none; an empty folder list filters nothing."""
    env, full, dtype, atol = MODES[mode]
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    store = _build_db(tmp_path, vecs, full=full)
    jx, tx = _indexes(store, dtype)
    queries = _unit(np.random.default_rng(15), 4)
    for folders in (["/img/c"], ["/img/nowhere"], ["/img/a_"], []):
        for q_count in (1, 4):
            got, want = _search_both(jx, tx, queries[:q_count], 10, folders)
            _assert_same(got, want, atol=atol)
            sizes = {(): 10, ("/img/c",): 3}.get(tuple(folders), 0)
            assert all(len(r) == sizes for r in got), (folders, [len(r) for r in got])


@pytest.mark.parametrize("full", [True, False], ids=["int8", "binary"])
def test_mask_cache_cleared_after_rows_are_added(tmp_path, vecs, full):
    """Rows added under the filtered folder after a filtered search show up
    in the next one: refresh() drops the cached masks."""
    store = _build_db(tmp_path, vecs[:600], full=full)
    jx, tx = _indexes(store)
    q = vecs[1000]
    before = tx.search(q, 5, ["/img/a"])
    assert tx._mask_cache and all(p.startswith("/img/a/") for p, _ in before)
    _insert(store, vecs[600:], start=600, full=full)  # row 1000 lies under /img/a
    got = tx.search(q, 5, ["/img/a"])
    assert got[0][0] == _path(1000) and got != before
    assert len(tx._mask_cache) == 1 and next(iter(tx._mask_cache))[1] == N
    _assert_same([got], [jx.search(q, 5, ["/img/a"])], atol=1e-6 if full else 0)
