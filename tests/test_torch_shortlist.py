"""The ``approx`` and ``verified`` int8 shortlists of the port
(``tpuclip_torch/ops/topk_int8.py``) against tpuclip's, on the CPU.

tpuclip builds them on ``lax.approx_max_k``, which XLA runs as a
PartialReduce on the TPU and as an exact top-k on the CPU; the port's
``approx_max_k`` folds the scores into XLA's bins on every device. So:

- the bin count equals XLA's own formula, and the bin reduction a numpy
  oracle of the fold (ties to the lowest column), and ``lax.approx_max_k``
  bit for bit where the bins keep every column;
- the count proof equals a numpy oracle of tpuclip's formula and catches a
  planted miss and a planted tie straddle;
- tpuclip's three shortlist tests (``tests/test_scores_shortlist.py``) hold
  the port to tpuclip's ``topk_int8_rerank_fused`` for ``approx``,
  ``verified`` and ``exact``: ids identical, scores within 1e-6;
- where the bins are fewer than the rows, ``verified`` with its fallback
  returns tpuclip's ids, and a planted bin collision fails the proof once
  and falls back over the resident scores without a second scan;
- ``DeviceIndex``, the engine's fused searches and ``serve`` under
  ``TPUCLIP_SHORTLIST=verified`` / ``approx``, the scores gate
  (``TPUCLIP_SCORES_HBM_MB``), and the mesh, which keeps its own
  shortlist;
- on a CUDA card (``cuda`` marker): the ``verified`` text graph against
  eager, and its fallback from the graph's device buffers."""

import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from jax._src.lib import _jax as xla_client

import tpuclip.engine as jx_engine
import tpuclip.serve as jx_serve
import tpuclip_torch.engine as pt_engine
import tpuclip_torch.serve as pt_serve
from tpuclip.models.checkpoint import save_checkpoint
from tpuclip.models.configs import get_config
from tpuclip.models.siglip import init_params
from tpuclip.ops import topk_int8 as jx
from tpuclip_torch.ops import topk_int8 as pt
from tpuclip_torch.parallel import make_mesh
from tpuclip_torch.parallel import sharded_search as pt_sh

METHODS = ["verified", "approx", "exact"]


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _both(rows, n_pad):
    """The same f32 rows as the port's (n_pad, D) int8 matrix + scales and
    tpuclip's (D, n_pad) one; n_pad a multiple of the port's 2048-row tile
    (or below it), which tpuclip's CPU route takes as it comes."""
    m, sc = pt.derive_int8_matrix(torch.from_numpy(rows), n_pad)
    mt, sc_j = jx.derive_int8_matrix_device(jnp.asarray(rows), n_pad)
    return (m, sc, torch.from_numpy(rows)), (mt, sc_j, jnp.asarray(rows))


def _port(q, index, k, n, method, **kw):
    m, sc, rows = index
    return pt.topk_int8_rerank_fused(torch.from_numpy(q), m, sc, rows, k, n_valid=n, shortlist_method=method, **kw)


def _tpuclip(q, index, k, n, method=None, **kw):
    mt, sc, rows = index
    return jx.topk_int8_rerank_fused(
        jnp.asarray(q), mt, sc, rows, k, n_valid=jnp.asarray(n, jnp.int32), use_pallas=False,
        shortlist_method=method, **kw,
    )


def _same(got, want, atol=1e-6):
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]), rtol=0, atol=atol)


# ------------------------------------------------------------ the bins


BIN_GRID = [
    (100, 20, 0.95), (128, 512, 0.95), (129, 1, 0.95), (257, 5, 0.5), (2048, 512, 0.95),
    (4096, 64, 0.95), (6144, 80, 0.9), (40_000, 512, 0.95), (40_960, 512, 0.95),
    (1_001_472, 512, 0.95), (1_001_472, 64, 0.9), (1_001_472, 512, 0.999), (1_001_472, 512, 1.0),
    (4_000_000, 20, 0.99), (5_000, 512, 0.1),
]


@pytest.mark.parametrize("n,k,recall", BIN_GRID, ids=[f"{n}-{k}-{r}" for n, k, r in BIN_GRID])
def test_bin_count_is_xlas(n, k, recall):
    want = tuple(xla_client.approx_top_k_reduction_output_size(n, 2, k, recall, False))
    assert pt.approx_reduction_size(n, k, recall) == want
    if (n, k, recall) == (1_001_472, 512, 0.95):
        assert want == (15_744, 6)
    if n == 4096 and k == 64:
        assert want[1] == 1  # a fold, not the exact top-k


def _fold_oracle(scores, k, bins):
    """numpy's version of the fold: pad to 2**r bins of width L with -inf,
    each bin's winner the lowest column among its largest, then the top-k
    of the winners by (score desc, column asc)."""
    q, n = scores.shape
    folds = -(-n // bins)
    pad = np.full((q, folds * bins), -np.inf, np.float32)
    pad[:, :n] = scores
    grid = pad.reshape(q, folds, bins)
    first = grid.argmax(axis=1)  # numpy's argmax takes the first of equal maxima
    win_s = np.take_along_axis(grid, first[:, None, :], axis=1)[:, 0, :]
    win_c = first * bins + np.arange(bins)
    out_s, out_c = [], []
    for s, c in zip(win_s, win_c):
        order = np.lexsort((c, -s))[:k]
        out_s.append(s[order])
        out_c.append(c[order])
    return np.stack(out_s), np.stack(out_c)


@pytest.mark.parametrize("n,k", [(40_000, 512), (4_096, 64), (1_000, 5)])
def test_bin_reduction_matches_the_fold(n, k):
    """Scores on a coarse grid, so that bins hold ties, and a -inf tail
    (rows past n_valid)."""
    rng = np.random.default_rng(n)
    scores = (np.round(rng.standard_normal((3, n)) * 8) / 8).astype(np.float32)
    scores[:, n - n // 7 :] = -np.inf
    bins, r = pt.approx_reduction_size(n, k, pt.APPROX_RECALL)
    assert bins < n and r > 0
    got_s, got_c = pt.approx_max_k(torch.from_numpy(scores), k)
    want_s, want_c = _fold_oracle(scores, k, bins)
    np.testing.assert_array_equal(got_c.numpy(), want_c)
    np.testing.assert_array_equal(got_s.numpy(), want_s)


def test_bin_reduction_without_a_fold_is_approx_max_k():
    """Where L = N (r = 0), ``lax.approx_max_k`` (exact on the CPU), ties
    and all, bit for bit."""
    rng = np.random.default_rng(1)
    n, k = 2048, 512
    assert pt.approx_reduction_size(n, k, pt.APPROX_RECALL) == (n, 0)
    scores = (np.round(rng.standard_normal((4, n)) * 4) / 4).astype(np.float32)
    scores[:, -100:] = -np.inf
    got_s, got_c = pt.approx_max_k(torch.from_numpy(scores), k)
    want_s, want_c = jax.lax.approx_max_k(jnp.asarray(scores), k)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))


def test_too_few_bins_select_exactly():
    """At a recall so low that the bins cannot hold k winners (XLA's L =
    384 < 512 at 5,000 columns and 0.1), the selection is the exact top-k."""
    assert pt.approx_reduction_size(5_000, 512, 0.1)[0] < 512
    scores = np.random.default_rng(2).standard_normal((2, 5_000)).astype(np.float32)
    got_s, got_c = pt.approx_max_k(torch.from_numpy(scores), 512, 0.1)
    want_c = np.argsort(-scores, axis=1, kind="stable")[:, :512]
    np.testing.assert_array_equal(got_c.numpy(), want_c)
    np.testing.assert_array_equal(got_s.numpy(), np.take_along_axis(scores, want_c, 1))


# --------------------------------------------------------- the count proof


def _proof_oracle(scores, shortlist, j):
    t = shortlist[:, j - 1 : j]
    ok = ((scores > t).sum(1) == (shortlist > t).sum(1)) & ((scores == t).sum(1) == (shortlist == t).sum(1))
    return bool(np.all(ok | np.isneginf(t[:, 0])))


@pytest.mark.parametrize("seed", range(6))
def test_count_proof_matches_tpuclips_formula(seed):
    rng = np.random.default_rng(seed)
    scores = (np.round(rng.standard_normal((2, 40_000)) * 16) / 16).astype(np.float32)
    s_a, cand, ok = pt._verified_shortlist(torch.from_numpy(scores), 512, 80, 0.95)
    assert ok.dim() == 0 and ok.dtype == torch.bool
    assert bool(ok) == _proof_oracle(scores, s_a.numpy(), 80)
    np.testing.assert_array_equal(np.take_along_axis(scores, cand.numpy(), 1), s_a.numpy())


def test_count_proof_detects_a_planted_miss_and_a_straddle(monkeypatch):
    """tpuclip's test_verified_shortlist_detects_planted_miss, through the
    port's verifier: drop the argmax from the shortlist (a miss above t),
    then keep one of two rows tied at t (a straddle)."""
    rng = np.random.default_rng(6)
    scores = rng.standard_normal((1, 4096)).astype(np.float32)
    order = np.argsort(-scores[0], kind="stable")
    s_t = torch.from_numpy(scores)
    s_a, _, ok = pt._verified_shortlist(s_t, 64, 32, 0.95)
    assert bool(ok) == _proof_oracle(scores, s_a.numpy(), 32)

    def forged(cols):
        def approx(s, k, recall):
            c = torch.from_numpy(cols)[None, :]
            return s.gather(1, c), c
        return approx

    monkeypatch.setattr(pt, "approx_max_k", forged(order[np.r_[1:64, 100]]))
    assert not bool(pt._verified_shortlist(s_t, 64, 32, 0.95)[2])
    tied = scores.copy()
    tied[0, order[40]] = tied[0, order[31]]  # the 32nd score now twice; only one listed
    monkeypatch.setattr(pt, "approx_max_k", forged(order[np.r_[0:40, 41:65]]))
    assert not bool(pt._verified_shortlist(torch.from_numpy(tied), 64, 32, 0.95)[2])
    monkeypatch.setattr(pt, "approx_max_k", forged(order[:64]))
    assert bool(pt._verified_shortlist(torch.from_numpy(tied), 64, 32, 0.95)[2])


# ----------------------------------------- tpuclip's three shortlist tests


@pytest.mark.parametrize("method", METHODS)
def test_methods_match_tpuclip(method):
    rows = _unit(np.random.default_rng(0), 1500, 96)
    pt_idx, jx_idx = _both(rows, 2048)
    q = np.random.default_rng(1).standard_normal((1, 96)).astype(np.float32)
    got, want = _port(q, pt_idx, 12, 1500, method), _tpuclip(q, jx_idx, 12, 1500, method)
    if method == "verified":
        assert bool(got[2]) and bool(np.asarray(want[2]))
    _same(got, want)
    _same(got, _tpuclip(q, jx_idx, 12, 1500))  # and tpuclip's default (extract)


@pytest.mark.parametrize("method", METHODS)
def test_batch_agreement(method):
    rows = _unit(np.random.default_rng(3), 2100, 64)
    pt_idx, jx_idx = _both(rows, 4096)
    q = np.random.default_rng(4).standard_normal((5, 64)).astype(np.float32)
    _same(_port(q, pt_idx, 7, 2100, method), _tpuclip(q, jx_idx, 7, 2100, method))


@pytest.mark.parametrize("method", METHODS)
def test_tie_contract_lowest_indices(method):
    """301 byte-identical rows, more than k: (score desc, row asc) demands
    the lowest rows."""
    n, d, dup = 3000, 64, 300
    rows = _unit(np.random.default_rng(5), n, d)
    dup_idx = np.arange(17, 17 + dup * 9, 9)
    rows[dup_idx] = rows[11]
    pt_idx, jx_idx = _both(rows, 4096)
    q = rows[11][None, :].copy()
    got, want = _port(q, pt_idx, 20, n, method), _tpuclip(q, jx_idx, 20, n, method)
    _same(got, want)
    np.testing.assert_array_equal(got[1][0].numpy(), np.sort(np.concatenate([[11], dup_idx]))[:20])


@pytest.mark.parametrize("recall", [0.9, 0.999])
def test_shortlist_recall(recall, monkeypatch):
    """tpuclip's test_shortlist_recall_static_arg: ``shortlist_recall`` (or
    TPUCLIP_SHORTLIST_RECALL) sets verified's bins, and the answer is
    tpuclip's at either target."""
    rows = _unit(np.random.default_rng(9), 1300, 64)
    pt_idx, jx_idx = _both(rows, 12_288)
    assert pt.approx_reduction_size(12_288, 512, recall) == ((6_144, 1) if recall == 0.9 else (12_288, 0))
    q = np.random.default_rng(10).standard_normal((1, 64)).astype(np.float32)
    got = _port(q, pt_idx, 9, 1300, "verified", shortlist_recall=recall)
    want = _tpuclip(q, jx_idx, 9, 1300, "verified", shortlist_recall=recall)
    assert bool(got[2]) and bool(np.asarray(want[2]))
    _same(got, want)
    monkeypatch.setenv("TPUCLIP_SHORTLIST_RECALL", str(recall))
    from_env = _port(q, pt_idx, 9, 1300, "verified")
    for a, b in zip(got, from_env):
        assert torch.equal(a, b)


# ------------------------------------------- where the bins are fewer than the rows


N_WIDE, D_WIDE, K_WIDE = 40_000, 64, 20


@pytest.fixture(scope="module")
def wide():
    """40,000 rows x 64 (padded to 40,960: 10,240 bins of four)."""
    rows = _unit(np.random.default_rng(40), N_WIDE, D_WIDE)
    pt_idx, jx_idx = _both(rows, 40_960)
    assert pt.approx_reduction_size(40_960, 512, 0.95) == (10_240, 2)
    return rows, pt_idx, jx_idx


def _auto(q, index, k, n, stats):
    m, sc, rows = index
    return pt.topk_int8_rerank_fused_auto(torch.from_numpy(q), m, sc, rows, k, n_valid=n, stats=stats)


def test_verified_with_fallback_returns_tpuclips_ids(wide, monkeypatch):
    """16 random single queries: 2 of them fail the proof (two of their
    top 80 rows share a bin) and take the fallback; every answer equals
    tpuclip's (exact on the CPU)."""
    rows, pt_idx, jx_idx = wide
    qs = _unit(np.random.default_rng(41), 16, D_WIDE)
    monkeypatch.setenv("TPUCLIP_SHORTLIST", "verified")
    stats = {}
    for q in qs:
        q = q[None, :]
        _same(_auto(q, pt_idx, K_WIDE, N_WIDE, stats), _tpuclip(q, jx_idx, K_WIDE, N_WIDE, "verified")[:2])
    assert stats == {"verified_searches": 16, "verified_queries": 16, "shortlist_fallbacks": 2}


def test_planted_bin_collision(wide, monkeypatch):
    """Rows 5 and 5 + L copy the query's nearest row, so they share bin 5:
    ``approx`` keeps row 5 only, ``verified`` says not ok, and the auto
    wrapper falls back once, over the resident scores (the program runs
    once), to tpuclip's ids."""
    rows, _, _ = wide
    bins = 10_240
    rng = np.random.default_rng(42)
    q = _unit(rng, 1, D_WIDE)
    rows = rows.copy()
    near = int(np.argmax(rows @ q[0]))
    assert near % bins != 5
    rows[[5, 5 + bins]] = rows[near]
    pt_idx, jx_idx = _both(rows, 40_960)
    want = _tpuclip(q, jx_idx, K_WIDE, N_WIDE, "approx")
    assert {near, 5, 5 + bins} <= set(np.asarray(want[1])[0, :3].tolist())

    s_a, i_a = _port(q, pt_idx, K_WIDE, N_WIDE, "approx")
    assert 5 in i_a[0].tolist() and 5 + bins not in i_a[0].tolist()
    assert not bool(_port(q, pt_idx, K_WIDE, N_WIDE, "verified")[2])

    calls = []
    real_fused, real_from_scores = pt.topk_int8_rerank_fused, pt.topk_exact_from_scores

    def spy(*args, **kwargs):
        calls.append(kwargs.get("shortlist_method"))
        return real_fused(*args, **kwargs)

    def spy_from_scores(*args, **kwargs):
        calls.append("from_scores")
        return real_from_scores(*args, **kwargs)

    monkeypatch.setattr(pt, "topk_int8_rerank_fused", spy)
    monkeypatch.setattr(pt, "topk_exact_from_scores", spy_from_scores)
    monkeypatch.setenv("TPUCLIP_SHORTLIST", "verified")
    stats = {}
    got = _auto(q, pt_idx, K_WIDE, N_WIDE, stats)
    assert calls == ["verified", "from_scores"]
    assert stats == {"verified_searches": 1, "verified_queries": 1, "shortlist_fallbacks": 1}
    _same(got, want)


def test_scores_gate_routes_to_extract(wide, monkeypatch):
    """Past TPUCLIP_SCORES_HBM_MB the scores are not materialized: verified
    takes extract, ok is True and the kept scores are (Q, 0), as in tpuclip."""
    rows, pt_idx, jx_idx = wide
    q = _unit(np.random.default_rng(43), 2, D_WIDE)
    monkeypatch.setenv("TPUCLIP_SCORES_HBM_MB", "0.1")  # 100 kB < 2 x 40,960 x 4 bytes
    monkeypatch.setattr(jx, "_SCORES_HBM_CAP_MB", 0.1)
    got = _port(q, pt_idx, K_WIDE, N_WIDE, "verified", keep_scores=True)
    want = _tpuclip(q, jx_idx, K_WIDE, N_WIDE, "verified", keep_scores=True)
    assert bool(got[2]) and bool(np.asarray(want[2]))
    assert tuple(got[3].shape) == tuple(want[3].shape) == (2, 0)
    _same(got, want)
    _same(got, _port(q, pt_idx, K_WIDE, N_WIDE, "extract"))
    monkeypatch.setenv("TPUCLIP_SCORES_HBM_MB", "1024")
    assert tuple(_port(q, pt_idx, K_WIDE, N_WIDE, "verified", keep_scores=True)[3].shape) == (2, 40_960)


def test_mesh_keeps_its_own_shortlist(monkeypatch):
    """Under TPUCLIP_SHORTLIST=verified the mesh still shortlists on kernel 1
    for one query and kernel 2 for a batch (tpuclip's mesh ignores the
    variable) and equals the unsharded exact search."""
    rng = np.random.default_rng(44)
    n, d, k = 32_768, 64, 20  # 8,192 rows a shard: kernel 2's tiles hold a shard's 512
    rows = _unit(rng, n, d)
    m, sc = pt.quantize_matrix(rows, n, "cpu")
    rows_t = torch.from_numpy(rows)
    seen = []
    real = pt_sh.rerank_at_depth

    def spy(*args):
        seen.append(args[7])
        return real(*args)

    monkeypatch.setattr(pt_sh, "rerank_at_depth", spy)
    monkeypatch.setenv("TPUCLIP_SHORTLIST", "verified")
    mesh = make_mesh(["cpu"] * 4)
    for q_count, method in ((1, "exact"), (3, "extract")):
        q = torch.from_numpy(_unit(rng, q_count, d))
        got = pt_sh.sharded_topk_int8_rerank(q, m, sc, rows_t, k, mesh, n)
        _same(got, pt.topk_int8_rerank_fused(q, m, sc, rows_t, k, n_valid=n, shortlist_method="exact"))
        assert seen == [method] * 4
        seen.clear()


# ------------------------------------------ the index, the engine and serve


MODEL = "tpuclip/test-tiny"
K = 5
TEXTS = ["a red car", "blue sky", "two dogs on a beach"]
ENV = {"TPUCLIP_SEARCH_PRECISION": "int8", "TPUCLIP_DEVICE_RERANK": "1", "TPUCLIP_SEARCH_MODE": "exact"}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(tmp, model cache, image root, db, tpuclip engine, port engine) over
    one database scanned by tpuclip."""
    tmp = tmp_path_factory.mktemp("shortlist")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPUCLIP_HOME", str(tmp / "home"))
        for key, value in ENV.items():
            mp.setenv(key, value)
        mp.delenv("TPUCLIP_SHORTLIST", raising=False)
        cache = tmp / "models"
        params = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(5), get_config(MODEL)))
        save_checkpoint(str(cache / MODEL.replace("/", "--")), params, get_config(MODEL))
        root = tmp / "imgs"
        root.mkdir()
        rng = np.random.default_rng(22)
        for i in range(10):
            Image.fromarray(rng.integers(0, 256, (40, 44 + i, 3), dtype=np.uint8)).save(root / f"img_{i:02d}.png")
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
    return world


def _same_results(got, want):
    assert [p for p, _ in got] == [p for p, _ in want] and len(got) > 0
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want], rtol=0, atol=1e-5)


PROOF_KEYS = ("verified_queries", "shortlist_fallbacks")


@pytest.mark.parametrize("method", ["verified", "approx"])
def test_index_and_engine_match_tpuclip(env, monkeypatch, method):
    """``DeviceIndex.search`` (one query), ``search_batch``, and the engine's
    fused text (buckets 1 and 4) and image programs, under the method,
    against tpuclip's; the proof counts move alike."""
    *_, root, db, eng_j, eng_t = env
    monkeypatch.setenv("TPUCLIP_SHORTLIST", method)
    before_t, before_j = dict(eng_t.index.shortlist_stats), dict(eng_j.index.shortlist_stats)
    q = _unit(np.random.default_rng(7), 4, 64)
    _same_results(eng_t.index.search(q[0], K), eng_j.index.search(q[0], K))
    for got, want in zip(eng_t.index.search_batch(q, K), eng_j.index.search_batch(q, K)):
        _same_results(got, want)
    for texts in (TEXTS[:1], TEXTS):
        for got, want in zip(eng_t.search_texts(texts, K), eng_j.search_texts(texts, K)):
            _same_results(got, want)
    img = Image.open(root / "img_03.png")
    _same_results(eng_t.search_image_pil(img, K), eng_j.search_image_pil(img, K))
    after_t, after_j = eng_t.index.shortlist_stats, eng_j.index.shortlist_stats
    runs = after_t[f"{method}_searches"] - before_t.get(f"{method}_searches", 0)
    assert runs == 5  # search, search_batch, two text blocks, one image
    for key in PROOF_KEYS:
        assert after_t[key] - before_t[key] == after_j[key] - before_j[key]
    assert after_t["verified_queries"] - before_t["verified_queries"] == (5 if method == "verified" else 0)
    assert after_t["shortlist_fallbacks"] == before_t["shortlist_fallbacks"]


def _forge_proof_miss(monkeypatch, device=None):
    """Every verified shortlist reports ok = False (its shortlist intact)."""
    real = pt._verified_shortlist

    def forged(scores, m, depth, recall):
        s, c, _ = real(scores, m, depth, recall)
        return s, c, torch.zeros((), dtype=torch.bool, device=scores.device)

    monkeypatch.setattr(pt, "_verified_shortlist", forged)


def test_fused_fallback_runs_the_tower_once(env, monkeypatch):
    """A proof miss in a fused program answers from the program's resident
    scores and embedding: the tower runs once a search, the fallback is
    counted, and the results are tpuclip's."""
    *_, root, db, eng_j, eng_t = env
    monkeypatch.setenv("TPUCLIP_SHORTLIST", "verified")
    _forge_proof_miss(monkeypatch)
    towers = []
    real = eng_t.model.get_text_features
    monkeypatch.setattr(eng_t.model, "get_text_features", lambda *a: towers.append(1) or real(*a))
    stats = eng_t.index.shortlist_stats
    before = stats["verified_queries"], stats["shortlist_fallbacks"]
    for got, want in zip(eng_t.search_texts(TEXTS, K), eng_j.search_texts(TEXTS, K)):
        _same_results(got, want)
    assert len(towers) == 1
    assert (stats["verified_queries"], stats["shortlist_fallbacks"]) == (before[0] + 1, before[1] + 1)


def _stats(srv):
    with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/stats", timeout=30) as r:
        return json.loads(r.read())


def _search(srv, query):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}/search", data=json.dumps({"query": query, "k": K}).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_serve_stats_carry_the_proof_counts(env, monkeypatch):
    """``/stats`` of both servers carries ``verified_queries`` and
    ``shortlist_fallbacks``; three verified ``/search`` requests move them
    alike and answer alike."""
    tmp, cache, root, db, *_ = env
    monkeypatch.setenv("TPUCLIP_SHORTLIST", "verified")
    eng_j = jx_engine.ImageDatabase(db, str(cache), model_name=MODEL, inference_batch_size=4)
    eng_t = pt_engine.ImageDatabase(db, str(cache), model_name=MODEL, inference_batch_size=4, device="cpu")
    servers = [jx_serve.SearchServer(eng_j, host="127.0.0.1", port=0),
               pt_serve.SearchServer(eng_t, host="127.0.0.1", port=0)]
    for srv in servers:
        srv.start_background()
    try:
        srv_j, srv_t = servers
        assert {k: _stats(srv_t)[k] for k in PROOF_KEYS} == {k: _stats(srv_j)[k] for k in PROOF_KEYS}
        for text in TEXTS:
            got, want = _search(srv_t, text), _search(srv_j, text)
            assert [r["path"] for r in got["results"]] == [r["path"] for r in want["results"]]
        s_t, s_j = _stats(srv_t), _stats(srv_j)
        assert {k: s_t[k] for k in PROOF_KEYS} == {k: s_j[k] for k in PROOF_KEYS}
        assert s_t["verified_queries"] == 3 and s_t["shortlist_fallbacks"] == 0
    finally:
        for srv in servers:
            srv.shutdown()


# -------------------------------------------------------------------- CUDA


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the int8 scan kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _eager(eng, texts):
    """The verified text program run eager on the card, mapped as the index
    maps it."""
    idx = eng.index
    ids, mask = eng._tokenize_bucketed(texts)
    s, r, ok = pt.query_topk_fused(
        eng.model, (torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda()), (), idx._matrix,
        idx._scales, idx._rows_device, K, idx._n_valid, shortlist_method="verified",
    )
    assert bool(ok)
    return idx._map_batch_results(s.cpu().numpy(), r.cpu().numpy(), len(texts))


@pytest.mark.cuda
def test_cuda_verified_graph_equals_eager(env, cuda_device, monkeypatch):
    tmp, cache, root, db, *_ = env
    monkeypatch.setenv("TPUCLIP_SHORTLIST", "verified")
    eng = pt_engine.ImageDatabase(db, str(cache), model_name=MODEL, inference_batch_size=4, device="cuda")
    assert eng.index.can_fuse_text_search(K, None)
    for texts in (TEXTS[:1], TEXTS):
        launches = pt.int8_scores.launches
        first = eng.search_texts(texts, K)  # the warm-up run and the capture's replay
        again = eng.search_texts(texts, K)
        assert pt.int8_scores.launches - launches == 3
        assert first == again == _eager(eng, texts)
    stats = eng.index.shortlist_stats
    assert stats["verified_queries"] == 4 and stats["shortlist_fallbacks"] == 0
    assert eng.index._graphs.pool_bytes() > 0 and eng.index._scores_buf.shape[0] == 4


@pytest.mark.cuda
def test_cuda_fallback_reads_the_graphs_buffers(env, cuda_device, monkeypatch):
    """A graph captured with a forged proof miss: every replay falls back
    over the resident scores and embedding it left on the card, and the
    answer is the exact route's."""
    tmp, cache, root, db, *_ = env
    monkeypatch.setenv("TPUCLIP_SHORTLIST", "verified")
    eng = pt_engine.ImageDatabase(db, str(cache), model_name=MODEL, inference_batch_size=4, device="cuda")
    _forge_proof_miss(monkeypatch)
    got = [eng.search_texts(TEXTS, K) for _ in range(3)]
    monkeypatch.setenv("TPUCLIP_SHORTLIST", "exact")
    want = eng.search_texts(TEXTS, K)
    assert got == [want] * 3
    assert eng.index.shortlist_stats["shortlist_fallbacks"] == 3
