"""The port's whole-database duplicate discovery
(``tpuclip_torch/pipelines/duplicates.py``) against tpuclip's on one
database with planted near-duplicates: the same clusters in the same order
(members, representatives, paths) at tolerance 0, 2 and 5, the same report,
and the same capped-bucket warning."""

import shutil
import sqlite3

import numpy as np
import pytest

import tpuclip.index.store as jx_store
import tpuclip.pipelines.duplicates as jx_dup
import tpuclip_torch.index.store as pt_store
import tpuclip_torch.pipelines.duplicates as pt_dup

DIM = 256
PACKAGES = {"port": (pt_store, pt_dup), "tpuclip": (jx_store, jx_dup)}


def _planted(seed=0):
    """24 random rows, then copies of some with k sign flips each, so their
    Hamming distance to the original is exactly k; a chain (10 -> 10' ->
    10'') joins only through union-find."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((24, DIM)).astype(np.float32)
    rows = list(base)
    for src, flips in [(0, 0), (0, 1), (1, 2), (2, 3), (3, 5), (4, 6), (5, 0), (5, 0), (7, 12)]:
        v = base[src].copy()
        idx = rng.choice(DIM, flips, replace=False)
        v[idx] = -v[idx]
        rows.append(v)
    v = base[10].copy()
    v[:2] = -v[:2]
    rows.append(v)
    w = v.copy()
    w[2:4] = -w[2:4]
    rows.append(w)
    order = rng.permutation(len(rows))  # duplicates scattered through the ids
    return np.stack(rows)[order]


def _database(path, vecs):
    store = jx_store.MetadataStore(str(path), embedding_dim=DIM)
    store.init_schema(verbose=False)
    conn = sqlite3.connect(store.db_path)
    store.commit_with_retry(
        conn.cursor(), conn, [(f"/d/{i:03d}.jpg", float(i), f"h{i}", v) for i, v in enumerate(vecs)],
        save_full_embeddings=True,
    )
    conn.close()


@pytest.fixture()
def databases(tmp_path):
    _database(tmp_path / "seed.db", _planted())
    out = {}
    for name in PACKAGES:
        (tmp_path / name).mkdir()
        shutil.copyfile(tmp_path / "seed.db", tmp_path / name / "d.db")
        out[name] = str(tmp_path / name / "d.db")
    return out


@pytest.mark.parametrize("tol", [0, 2, 5])
def test_same_clusters_as_tpuclip(databases, tol):
    got = {}
    for name, (store_mod, dup_mod) in PACKAGES.items():
        store = store_mod.MetadataStore(databases[name], embedding_dim=DIM)
        got[name] = dup_mod.find_duplicate_clusters(store, tolerance_bits=tol)
    assert got["port"] == got["tpuclip"]
    assert got["port"], "no clusters planted at this tolerance"
    sizes = [len(c) for c in got["port"]]
    assert sizes == sorted(sizes, reverse=True)
    if tol == 0:  # exact copies only: 0, 0' and 5, 5', 5''
        assert sorted(sizes) == [2, 3]


@pytest.mark.parametrize("tol", [0, 2, 5])
def test_same_report_as_tpuclip(databases, tol, capsys, monkeypatch):
    monkeypatch.delenv("TPUCLIP_QUIET", raising=False)
    printed = {}
    for name, (_, dup_mod) in PACKAGES.items():
        dup_mod.report_duplicates(databases[name], tolerance_bits=tol)
        printed[name] = capsys.readouterr().out
    assert printed["port"] == printed["tpuclip"]
    assert f"(tolerance: {tol} bits)" in printed["port"]


def test_capped_buckets_and_tiny_databases(tmp_path, capsys, monkeypatch):
    """A bucket above ``max_bucket`` is cut and warned about alike; a
    database of one row has no clusters in either."""
    monkeypatch.delenv("TPUCLIP_QUIET", raising=False)
    vecs = np.ones((12, DIM), np.float32)  # one degenerate signature
    vecs[:, 0] = np.linspace(-1, 1, 12)
    for name in PACKAGES:  # each package builds its own matrix cache
        _database(tmp_path / f"{name}_flat.db", vecs)
        _database(tmp_path / f"{name}_one.db", vecs[:1])
    for db in ("flat.db", "one.db"):
        got = {}
        for name, (store_mod, dup_mod) in PACKAGES.items():
            store = store_mod.MetadataStore(str(tmp_path / f"{name}_{db}"), embedding_dim=DIM)
            got[name] = (dup_mod.find_duplicate_clusters(store, tolerance_bits=1, max_bucket=5),
                         capsys.readouterr().out)
        assert got["port"] == got["tpuclip"]
    assert got["port"][0] == []
