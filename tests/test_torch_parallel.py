"""The port's mesh (``tpuclip_torch/parallel/{mesh,sharded_search,sharding,
training}.py`` and ``DeviceIndex(mesh=...)``) against tpuclip's, on the
CPU: tpuclip's functions run on the conftest's 8-device virtual CPU mesh,
the port's on ``make_mesh(["cpu"] * 8)`` (eight shards on the one CPU), on
the same numpy-seeded inputs. Each test of ``tests/test_parallel.py`` has
its counterpart here. Agreement: ids identical, scores within 1e-6 (int8)
or 1e-5 (bf16 / fp32), binary matches equal as integers, train losses
within 1e-5 relative on the first step.

Also here: the mesh itself (shapes, ``TPUCLIP_SHARDED_INDEX=1`` on one
device, ``maybe_distributed_init``'s variables), the data-parallel step
against the port's single-device step, ``DeviceIndex(mesh=...)`` in every
mode against tpuclip's mesh index, the wrappers' device-correct launches
(a recorder in place of the kernel library), and one ``cuda`` case: a
mesh of the one card named twice against the unsharded search."""

import sqlite3

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import tpuclip.index.search as jx_search
import tpuclip.parallel.sharded_search as jx_sh
import tpuclip.parallel.training as jx_train
import tpuclip_torch.parallel.sharded_search as pt_sh
import tpuclip_torch.parallel.training as pt_train
from tpuclip.index.store import MetadataStore
from tpuclip.models import get_config, init_params
from tpuclip.ops.hamming import binary_topk_packed, pack_bits_to_words, pad_words_grouped
from tpuclip.ops.topk import pad_matrix_t, topk_xla
from tpuclip.ops.topk_int8 import quantize_matrix_t, quantize_query
from tpuclip.parallel import make_mesh as jx_make_mesh
from tpuclip.parallel import param_shardings as jx_param_shardings
from tpuclip.parallel.mesh import DATA_AXIS as JX_DATA
from tpuclip_torch.index.search import DeviceIndex as TorchIndex
from tpuclip_torch.models import configs as pt_configs
from tpuclip_torch.models.convert import _HEAD_KEYS, _LAYER_KEYS, load_jax_params
from tpuclip_torch.models.siglip import build_model
from tpuclip_torch.parallel import make_mesh, maybe_distributed_init, param_shardings, shard_params
from tpuclip_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, single_device_mesh

MODEL = "tpuclip/test-tiny"
INT32_MIN = np.iinfo(np.int32).min

_ENV = (
    "TPUCLIP_SEARCH_PRECISION", "TPUCLIP_DEVICE_RERANK", "TPUCLIP_SEARCH_RERANK",
    "TPUCLIP_SEARCH_MODE", "TPUCLIP_CASCADE_DEPTH", "TPUCLIP_CASCADE_PREFILTER",
    "TPUCLIP_SHORTLIST", "TPUCLIP_INDEX_HBM_GB", "TPUCLIP_SHARDED_INDEX", "TPUCLIP_MULTIHOST",
)


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for name in _ENV:
        monkeypatch.delenv(name, raising=False)


@pytest.fixture(scope="module")
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices (virtual CPU mesh)")
    return jx_make_mesh(model_parallelism=1)


@pytest.fixture(scope="module")
def pmesh():
    return make_mesh(["cpu"] * 8)


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _same(got, want, atol, valid=None):
    (gs, gi), (ws, wi) = [tuple(map(_np, pair)) for pair in (got, want)]
    if valid is not None:
        gs, gi, ws, wi = gs[valid], gi[valid], ws[valid], wi[valid]
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gs, ws, rtol=0, atol=atol)


# =============================================================== the mesh


def test_mesh_shapes_and_refusals():
    m = make_mesh(["cpu"] * 8)
    assert m.shape == {DATA_AXIS: 8, MODEL_AXIS: 1} and m.lead == torch.device("cpu")
    assert [m.shard_index(j) for j in range(8)] == list(range(8)) and m.group is None
    m42 = make_mesh(["cpu"] * 8, model_parallelism=2)
    assert m42.shape == {DATA_AXIS: 4, MODEL_AXIS: 2} and len(m42.data_devices) == 4
    assert single_device_mesh("cpu").shape == {DATA_AXIS: 1, MODEL_AXIS: 1}
    with pytest.raises(ValueError, match="divisible"):
        make_mesh(["cpu"] * 3, model_parallelism=2)
    with pytest.raises(ValueError, match="one type"):
        Mesh([torch.device("cpu"), torch.device("cuda", 0)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh()


def test_maybe_distributed_init_variables(monkeypatch):
    """A no-op without TPUCLIP_MULTIHOST; with it, tpuclip's variables name
    the coordinator (malformed ones raise), and exported-but-empty ones fall
    through to the launcher's env:// variables, which raise when absent."""
    import torch.distributed as dist

    calls = []
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **kw: calls.append((a, kw)))
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "localhost:1234")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    monkeypatch.setenv("JAX_PROCESS_ID", "0")
    maybe_distributed_init()
    assert calls == []
    monkeypatch.setenv("TPUCLIP_MULTIHOST", "1")
    maybe_distributed_init(backend="gloo")
    (args, kw), = calls
    assert args == ("gloo",) and kw["init_method"] == "tcp://localhost:1234"
    assert kw["world_size"] == 2 and kw["rank"] == 0
    calls.clear()
    monkeypatch.setenv("JAX_PROCESS_ID", "")
    maybe_distributed_init(backend="gloo")
    assert calls[0][1]["init_method"] == "env://"
    monkeypatch.setenv("JAX_PROCESS_ID", "zero")
    with pytest.raises(ValueError):
        maybe_distributed_init(backend="gloo")


def test_maybe_distributed_init_unreachable_coordinator_raises(monkeypatch):
    """Process 1 of 2 with nobody listening at the coordinator: the init
    raises after its timeout instead of waiting forever."""
    import socket

    import torch.distributed as dist

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    monkeypatch.setenv("TPUCLIP_MULTIHOST", "1")
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", f"127.0.0.1:{port}")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    monkeypatch.setenv("JAX_PROCESS_ID", "1")
    with pytest.raises(Exception):
        maybe_distributed_init(backend="gloo", timeout_s=3)
    assert not dist.is_initialized()


# ====================================================== float / int8 scans


def test_sharded_search_matches_single_device(mesh8, pmesh):
    rng = np.random.default_rng(0)
    n, d, k = 10_000, 64, 17
    matrix = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((3, d)).astype(np.float32)
    want = jx_sh.ShardedIndex(matrix, mesh8, dtype=jnp.float32).search(queries, k)
    got = pt_sh.ShardedIndex(matrix, pmesh, dtype=torch.float32).search(queries, k)
    _same(got, want, 1e-5)
    _same(got, topk_xla(jnp.asarray(queries), jnp.asarray(matrix.T), k), 1e-5)


def test_sharded_search_negative_scores_survive_padding(mesh8, pmesh):
    """Every row scores below 0 and the zero padding fills most shards: the
    float and int8 scans must still return only real rows, as tpuclip's."""
    rng = np.random.default_rng(9)
    n, d, k = 10, 32, 5
    query = rng.standard_normal((1, d)).astype(np.float32)
    query /= np.linalg.norm(query)
    matrix = -np.abs(rng.standard_normal((n, 1))).astype(np.float32) * query
    matrix += 0.01 * rng.standard_normal((n, d)).astype(np.float32)
    mt = np.concatenate([matrix.T, np.zeros((d, (-n) % 512), np.float32)], axis=1)
    mt, _ = jx_sh.pad_for_mesh(mt, mesh8)
    rows = np.ascontiguousarray(mt.T)
    want = jx_sh.sharded_topk(jnp.asarray(query), jx_sh.shard_matrix(jnp.asarray(mt), mesh8), k, mesh8,
                              jnp.asarray(n, jnp.int32))
    got = pt_sh.sharded_topk(_t(query), pt_sh.shard_matrix(rows, pmesh), k, pmesh, n)
    assert np.isfinite(_np(got[0])).all() and (_np(got[0]) < 0).all()
    _same(got, want, 1e-5)

    mq, scales = quantize_matrix_t(mt)
    qi, qs = quantize_query(query)
    sc_dev = jax.device_put(jnp.asarray(scales), NamedSharding(mesh8, P(JX_DATA)))
    want8 = jx_sh.sharded_topk_int8(jnp.asarray(qi), jx_sh.shard_matrix(jnp.asarray(mq), mesh8), sc_dev,
                                    jnp.asarray(qs, jnp.float32), k, mesh8, jnp.asarray(n, jnp.int32))
    got8 = pt_sh.sharded_topk_int8(_t(qi), np.ascontiguousarray(mq.T), scales, float(qs), k, pmesh, n)
    assert np.isfinite(_np(got8[0])).all() and (_np(got8[0]) < 0).all()
    _same(got8, want8, 1e-6)


def test_sharded_search_per_shard_kernel_route(mesh8, pmesh):
    """tpuclip's per-shard Pallas route counterpart: ragged rows padded to
    shards of 512 (the padding tail in the last shard); every shard takes
    kernel 4's route (its plain version here), equal to tpuclip's XLA
    shards and its single-device scan."""
    rng = np.random.default_rng(5)
    n, d, k = 4100, 128, 11
    matrix = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((2, d)).astype(np.float32)
    mt = np.concatenate([matrix.T, np.zeros((d, (-n) % (512 * 8)), np.float32)], axis=1)
    want = jx_sh.sharded_topk(jnp.asarray(queries), jx_sh.shard_matrix(jnp.asarray(mt), mesh8), k, mesh8,
                              jnp.asarray(n, jnp.int32), use_pallas=False)
    padded, _ = pt_sh.pad_for_mesh(matrix, pmesh, 512)
    sharded = pt_sh.shard_matrix(padded, pmesh)
    assert sharded.rows_per_shard == 1024 and tuple(sharded.shape) == (8192, d)
    got = pt_sh.sharded_topk(_t(queries), sharded, k, pmesh, n)
    _same(got, want, 1e-5)
    _same(got, topk_xla(jnp.asarray(queries), jnp.asarray(matrix.T), k), 1e-5)


def test_sharded_search_ragged_rows(mesh8, pmesh):
    rng = np.random.default_rng(1)
    n, d, k = 1003, 32, 10
    matrix = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((1, d)).astype(np.float32)
    want = jx_sh.ShardedIndex(matrix, mesh8, dtype=jnp.float32).search(queries, k)
    got = pt_sh.ShardedIndex(matrix, pmesh, dtype=torch.float32).search(queries, k)
    _same(got, want, 1e-5)
    assert _np(got[1]).max() < n


def test_sharded_topk_k_exceeds_shard_rows(mesh8, pmesh):
    """3 rows a shard, k = 50: every path pads its local candidates; the
    valid results equal tpuclip's."""
    rng = np.random.default_rng(23)
    n, d, k = 24, 32, 50
    m = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((1, d)).astype(np.float32)
    mt = np.ascontiguousarray(m.T)
    nv = jnp.asarray(n, jnp.int32)
    want = jx_sh.sharded_topk(jnp.asarray(q), jnp.asarray(mt), k, mesh8, nv)
    got = pt_sh.sharded_topk(_t(q), m, k, pmesh, n)
    valid = np.isfinite(_np(got[0]))
    assert valid.sum() == n
    _same(got, want, 1e-5, valid)

    mq, scales = quantize_matrix_t(mt)
    qi, qs = quantize_query(q)
    want8 = jx_sh.sharded_topk_int8(jnp.asarray(qi), jnp.asarray(mq), jnp.asarray(scales),
                                    jnp.asarray(qs, jnp.float32), k, mesh8, nv)
    got8 = pt_sh.sharded_topk_int8(_t(qi), np.ascontiguousarray(mq.T), scales, float(qs), k, pmesh, n)
    valid8 = np.isfinite(_np(got8[0]))
    assert valid8.sum() == n
    _same(got8, want8, 1e-6, valid8)

    words = pack_bits_to_words(rng.integers(0, 2, (n, 64), dtype=np.uint8))
    qw = pack_bits_to_words(rng.integers(0, 2, (1, 64), dtype=np.uint8))
    wantb = jx_sh.sharded_binary_topk(jnp.asarray(qw), jnp.asarray(words), k, mesh8, nv)
    gotb = pt_sh.sharded_binary_topk(_t(qw.view(np.int32)), words.view(np.int32), k, pmesh, n)
    validb = _np(gotb[0]) > INT32_MIN
    assert validb.sum() == n
    _same(gotb, wantb, 0, validb)


def test_sharded_topk_masked_matches_tpuclip(mesh8, pmesh):
    """A folder mask over the padded width on the float and int8 scans
    (the masked per-shard routes: the chunked matmul, kernel 1's scores)."""
    rng = np.random.default_rng(31)
    n, d, k = 1000, 32, 12
    m = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((2, d)).astype(np.float32)
    mt, _ = pad_matrix_t(np.ascontiguousarray(m.T), tile_n=64 * 8)
    mask = np.where(np.arange(mt.shape[1]) % 3 == 0, 0.0, -np.inf).astype(np.float32)
    nv = jnp.asarray(n, jnp.int32)
    want = jx_sh.sharded_topk(jnp.asarray(q), jx_sh.shard_matrix(jnp.asarray(mt), mesh8), k, mesh8, nv,
                              mask=jnp.asarray(mask))
    got = pt_sh.sharded_topk(_t(q), np.ascontiguousarray(mt.T), k, pmesh, n, mask=mask)
    _same(got, want, 1e-5)
    assert (_np(got[1]) % 3 == 0).all()
    mq, scales = quantize_matrix_t(mt)
    qi, qs = quantize_query(q[:1])
    want8 = jx_sh.sharded_topk_int8(jnp.asarray(qi), jnp.asarray(mq), jnp.asarray(scales),
                                    jnp.asarray(qs, jnp.float32), k, mesh8, nv, mask=jnp.asarray(mask))
    got8 = pt_sh.sharded_topk_int8(_t(qi), np.ascontiguousarray(mq.T), scales, float(qs), k, pmesh, n,
                                   mask=mask)
    _same(got8, want8, 1e-6)


def test_sharded_int8_rerank_matches_full_precision(mesh8, pmesh):
    rng = np.random.default_rng(11)
    n, d, k = 4096, 64, 20
    rows = rng.standard_normal((n, d)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    mq, scales = quantize_matrix_t(np.ascontiguousarray(rows.T))
    q = rng.standard_normal((3, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    want = jx_sh.sharded_topk_int8_rerank(jnp.asarray(q), jnp.asarray(mq), jnp.asarray(scales),
                                          jnp.asarray(rows), k, mesh8, jnp.asarray(n, jnp.int32))
    got = pt_sh.sharded_topk_int8_rerank(_t(q), np.ascontiguousarray(mq.T), scales, rows, k, pmesh, n)
    _same(got, want, 1e-6)
    _same(got, topk_xla(jnp.asarray(q), jnp.asarray(rows.T), k), 1e-6)


def test_sharded_int8_rerank_ragged_and_k_exceeds_shard(mesh8, pmesh):
    rng = np.random.default_rng(12)
    n, d, k = 37, 32, 50
    rows = rng.standard_normal((n, d)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    mt, nv = pad_matrix_t(np.ascontiguousarray(rows.T), tile_n=8)
    mq, scales = quantize_matrix_t(mt)
    rows_pad = np.pad(rows, ((0, mt.shape[1] - n), (0, 0)))
    q = rng.standard_normal((1, d)).astype(np.float32)
    want = jx_sh.sharded_topk_int8_rerank(jnp.asarray(q), jnp.asarray(mq), jnp.asarray(scales),
                                          jnp.asarray(rows_pad), k, mesh8, jnp.asarray(nv, jnp.int32))
    got = pt_sh.sharded_topk_int8_rerank(_t(q), np.ascontiguousarray(mq.T), scales, rows_pad, k, pmesh, nv)
    valid = np.isfinite(_np(got[0]))
    assert valid.sum() == n
    _same(got, want, 1e-6, valid)


def test_sharded_int8_rerank_all_negative_scores_with_padding(mesh8, pmesh):
    """The global best row shares the last shard with 12 zero pad rows and
    the shortlist is 8 deep: pad rows score 0 > every real score, so the
    scan must mask them through the shard's n_valid."""
    rng = np.random.default_rng(21)
    n, d, k = 100, 32, 10
    rows = rng.standard_normal((n, d)).astype(np.float32) + 3.0
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    q = -np.abs(rng.standard_normal((1, d)).astype(np.float32))
    best = np.zeros(d, np.float32)
    best[int(np.argmin(np.abs(q[0])))] = 1.0
    rows[99] = best
    mt, nv = pad_matrix_t(np.ascontiguousarray(rows.T), tile_n=16)
    mq, scales = quantize_matrix_t(mt)
    rows_pad = np.pad(rows, ((0, mt.shape[1] - n), (0, 0)))
    assert mt.shape[1] == 112
    want = jx_sh.sharded_topk_int8_rerank(jnp.asarray(q), jnp.asarray(mq), jnp.asarray(scales),
                                          jnp.asarray(rows_pad), k, mesh8, jnp.asarray(nv, jnp.int32),
                                          shortlist=8)
    got = pt_sh.sharded_topk_int8_rerank(_t(q), np.ascontiguousarray(mq.T), scales, rows_pad, k, pmesh, nv,
                                         shortlist=8)
    assert np.isfinite(_np(got[0])).all() and _np(got[1])[0, 0] == 99
    _same(got, want, 1e-6)


@pytest.mark.parametrize("trial", range(6))
def test_sharded_int8_rerank_shape_boundary_fuzz(mesh8, pmesh, trial):
    """Row counts that leave shards mostly padding (n < ndev, n % ndev != 0,
    one row): tpuclip's fuzz cases, each equal to tpuclip's mesh search and
    to the fp32 oracle."""
    import random

    ndev = 8
    rng_py = random.Random(23 + trial)
    rng = np.random.default_rng(23 + trial)
    d = 64
    n = rng_py.choice([1, ndev - 1, ndev, ndev + 1, 100, 1000, 2047])
    k = min(rng_py.choice([1, 5, min(32, n), n]), 128)
    rows = rng.standard_normal((n, d)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    mt, nv = pad_matrix_t(np.ascontiguousarray(rows.T), tile_n=2048 * ndev)
    q8, scales = quantize_matrix_t(mt)
    rows_pad = np.pad(rows, ((0, mt.shape[1] - n), (0, 0)))
    queries = rng.standard_normal((2, d)).astype(np.float32)
    want = jx_sh.sharded_topk_int8_rerank(
        jnp.asarray(queries), jx_sh.shard_matrix(jnp.asarray(q8), mesh8),
        jax.device_put(jnp.asarray(scales), NamedSharding(mesh8, P(JX_DATA))),
        jax.device_put(jnp.asarray(rows_pad), NamedSharding(mesh8, P(JX_DATA, None))),
        k, mesh8, jnp.asarray(nv, jnp.int32))
    got = pt_sh.sharded_topk_int8_rerank(_t(queries), np.ascontiguousarray(q8.T), scales, rows_pad, k, pmesh, nv)
    k_eff = min(k, n)
    _same((_np(got[0])[:, :k_eff], _np(got[1])[:, :k_eff]),
          (np.asarray(want[0])[:, :k_eff], np.asarray(want[1])[:, :k_eff]), 1e-6)
    exact = queries @ rows.T
    for r in range(2):
        assert list(_np(got[1])[r, :k_eff]) == list(np.lexsort((np.arange(n), -exact[r]))[:k_eff])


# =========================================================== binary scans


def test_sharded_binary_topk_matches_single_device(mesh8, pmesh):
    rng = np.random.default_rng(11)
    n, d, k = 301, 128, 9
    words = pack_bits_to_words((rng.standard_normal((n, d)) >= 0).astype(np.uint8))
    qwords = pack_bits_to_words((rng.standard_normal((2, d)) >= 0).astype(np.uint8))
    padded = np.pad(words, ((0, (-n) % 8), (0, 0)))
    want = jx_sh.sharded_binary_topk(jnp.asarray(qwords), jnp.asarray(padded), k, mesh8, jnp.asarray(n, jnp.int32))
    got = pt_sh.sharded_binary_topk(_t(qwords.view(np.int32)), padded.view(np.int32), k, pmesh, n)
    _same(got, want, 0)
    _same(got, binary_topk_packed(jnp.asarray(qwords), jnp.asarray(words), k), 0)
    mask = np.where(np.arange(padded.shape[0]) % 2 == 0, -np.inf, 0.0).astype(np.float32)
    want_m = jx_sh.sharded_binary_topk(jnp.asarray(qwords), jnp.asarray(padded), k, mesh8,
                                       jnp.asarray(n, jnp.int32), mask=jnp.asarray(mask))
    got_m = pt_sh.sharded_binary_topk(_t(qwords.view(np.int32)), padded.view(np.int32), k, pmesh, n, mask=mask)
    _same(got_m, want_m, 0)


def test_sharded_binary_topk_tie_ordering(mesh8, pmesh):
    """Four distinct bit rows tiled 64 times: popcount ties across every
    shard resolve to the lowest global row."""
    rng = np.random.default_rng(17)
    n = 256
    words = pack_bits_to_words(np.tile(rng.integers(0, 2, (4, 64), dtype=np.uint8), (n // 4, 1)))
    qwords = pack_bits_to_words(rng.integers(0, 2, (1, 64), dtype=np.uint8))
    want = jx_sh.sharded_binary_topk(jnp.asarray(qwords), jnp.asarray(words), 16, mesh8, jnp.asarray(n, jnp.int32))
    got = pt_sh.sharded_binary_topk(_t(qwords.view(np.int32)), words.view(np.int32), 16, pmesh, n)
    _same(got, want, 0)


def test_sharded_grouped_binary_topk_matches_single_device(mesh8, pmesh):
    rng = np.random.default_rng(13)
    n, d, k = 301, 128, 9
    words = pack_bits_to_words((rng.standard_normal((n, d)) >= 0).astype(np.uint8))
    qwords = pack_bits_to_words((rng.standard_normal((2, d)) >= 0).astype(np.uint8))
    grouped, rps, nv = jx_sh.shard_words_grouped(words, mesh8, tile_n=64)
    blocks, prps, pnv = pt_sh.shard_words_grouped(words.view(np.int32), pmesh, tile_n=64)
    assert (prps, pnv) == (rps, nv) and all(b.shape == (rps, words.shape[1]) for b in blocks.shards)
    want = jx_sh.sharded_binary_topk_grouped(jnp.asarray(qwords), grouped, k, mesh8, jnp.asarray(nv, jnp.int32), rps)
    got = pt_sh.sharded_binary_topk_grouped(_t(qwords.view(np.int32)), blocks, k, pmesh, nv, prps)
    _same(got, want, 0)
    mask = np.zeros((8 * rps,), np.float32)
    mask[::2] = -np.inf
    want_m = jx_sh.sharded_binary_topk_grouped(jnp.asarray(qwords), grouped, k, mesh8,
                                               jnp.asarray(nv, jnp.int32), rps, mask=jnp.asarray(mask))
    got_m = pt_sh.sharded_binary_topk_grouped(_t(qwords.view(np.int32)), blocks, k, pmesh, nv, prps, mask=mask)
    _same(got_m, want_m, 0)


def test_sharded_binary_shortlist_matches_single_device(mesh8, pmesh):
    """At full depth the shortlist holds exactly the valid rows, ordered
    (score desc, row asc): tpuclip's mesh shortlist, its single-device one
    (both in interpret mode) and the port's agree."""
    from tpuclip.ops.hamming import binary_shortlist_q1

    rng = np.random.default_rng(14)
    n, d = 300, 128
    words = pack_bits_to_words((rng.standard_normal((n, d)) >= 0).astype(np.uint8))
    qwords = pack_bits_to_words((rng.standard_normal((1, d)) >= 0).astype(np.uint8))
    grouped, rps, nv = jx_sh.shard_words_grouped(words, mesh8, tile_n=64)
    want = jx_sh.sharded_binary_shortlist(jnp.asarray(qwords), grouped, n, mesh8, jnp.asarray(nv, jnp.int32),
                                          rps, interpret=True)
    blocks, prps, _ = pt_sh.shard_words_grouped(words.view(np.int32), pmesh, tile_n=64)
    got = pt_sh.sharded_binary_shortlist(_t(qwords.view(np.int32)), blocks, n, pmesh, nv, prps)
    _same(got, want, 0)
    wg, nv1 = pad_words_grouped(words, tile_n=64)
    single = binary_shortlist_q1(jnp.asarray(qwords), jnp.asarray(wg), n, n_valid=jnp.asarray(nv1, jnp.int32),
                                 tile_n=64, interpret=True)
    _same(got, single, 0)


# ======================================================== towers and train


def _port_model(params):
    model = build_model(pt_configs.get_config(MODEL), torch.device("cpu"), torch.float32)
    return load_jax_params(model, params)


@pytest.fixture(scope="module")
def tiny():
    cfg = get_config(MODEL)
    return cfg, jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(0), cfg))


def test_dp_inference_matches_single(mesh8, pmesh, tiny):
    """A batch of 16 split over 8 replicas (``shard_params``), each on its
    2 rows, against tpuclip's features of the data-sharded batch."""
    from tpuclip.models.siglip import get_image_features

    cfg, params = tiny
    batch = np.random.default_rng(2).integers(0, 256, size=(16, 56, 56, 3), dtype=np.uint8)
    sharded = jax.device_put(jnp.asarray(batch), NamedSharding(mesh8, P(JX_DATA, None, None, None)))
    want = np.asarray(get_image_features(jax.tree.map(jnp.asarray, params), sharded, cfg))
    replicas = shard_params(_port_model(params), pmesh)
    assert len(replicas) == 8
    got = np.concatenate([r.get_image_features(_t(batch[2 * j : 2 * j + 2])).numpy()
                          for j, r in enumerate(replicas)])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_dp_naflex_inference_matches_single(mesh8, pmesh):
    from tpuclip.models.naflex import get_image_features_naflex

    cfg = get_config("tpuclip/test-tiny-naflex")
    params = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(4)
    b, L = 16, cfg.vision.max_num_patches
    patches = rng.integers(0, 256, size=(b, L, cfg.vision.patch_size**2 * 3), dtype=np.uint8)
    masks = np.ones((b, L), np.int32)
    shapes = np.empty((b, 2), np.int32)
    for i in range(b):
        h = int(rng.integers(1, 9))
        w = min(L // h, int(rng.integers(1, 9)))
        shapes[i] = (h, w)
        masks[i, h * w :] = 0
        masks[i, 0] = 1
    sh = lambda spec: NamedSharding(mesh8, spec)  # noqa: E731
    want = np.asarray(get_image_features_naflex(
        jax.tree.map(jnp.asarray, params), jax.device_put(jnp.asarray(patches), sh(P(JX_DATA, None, None))),
        jax.device_put(jnp.asarray(masks), sh(P(JX_DATA, None))),
        jax.device_put(jnp.asarray(shapes), sh(P(JX_DATA, None))), cfg))
    model = build_model(pt_configs.get_config("tpuclip/test-tiny-naflex"), torch.device("cpu"), torch.float32)
    replicas = shard_params(load_jax_params(model, params), pmesh)
    got = np.concatenate([
        r.get_image_features_naflex(_t(patches[2 * j : 2 * j + 2]), _t(masks[2 * j : 2 * j + 2]),
                                    _t(shapes[2 * j : 2 * j + 2])).numpy()
        for j, r in enumerate(replicas)])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_tp_param_sharding_refused_forward_kept(tiny):
    """tpuclip's tensor-parallel forward on its 4 x 2 mesh equals its plain
    one, and the port's plain forward and its tensor-parallel replicas on
    ``make_mesh(["cpu"] * 8, model_parallelism=2)`` (which the port once
    refused) equal both: each replica on its rows of the batch."""
    from tpuclip.models.siglip import get_image_features
    from tpuclip.parallel import shard_params as jx_shard_params

    cfg, params = tiny
    batch = np.random.default_rng(3).integers(0, 256, size=(8, 56, 56, 3), dtype=np.uint8)
    jp = jax.tree.map(jnp.asarray, params)
    sharded = jx_shard_params(jp, jx_make_mesh(model_parallelism=2))
    assert MODEL_AXIS in str(sharded["vision"]["encoder"]["fc1_kernel"].sharding.spec)
    tp = np.asarray(get_image_features(sharded, jnp.asarray(batch), cfg))
    np.testing.assert_allclose(tp, np.asarray(get_image_features(jp, jnp.asarray(batch), cfg)), rtol=1e-4, atol=1e-5)
    model = _port_model(params)
    np.testing.assert_allclose(model.get_image_features(_t(batch)).numpy(), tp, rtol=0, atol=1e-5)
    replicas = shard_params(model, make_mesh(["cpu"] * 8, model_parallelism=2))
    assert len(replicas) == 4
    assert any(".shards.1." in name for name, _ in replicas[0].named_parameters())
    got = np.concatenate([r.get_image_features(_t(batch[2 * j : 2 * j + 2])).numpy()
                          for j, r in enumerate(replicas)])
    np.testing.assert_allclose(got, tp, rtol=1e-4, atol=1e-5)


def test_param_shardings_table_equals_tpuclip(tiny):
    """On a 4 x 2 mesh, every parameter's spec equals tpuclip's for the same
    leaf: its (in, out) kernels reversed to the port's (out, in) weights,
    its leading layer axis dropped."""
    cfg, params = tiny
    specs = jx_param_shardings(jax.tree.map(jnp.asarray, params), jx_make_mesh(model_parallelism=2))
    got = param_shardings(_port_model(params), make_mesh(["cpu"] * 8, model_parallelism=2))

    def leaf(tree, path):
        for key in path:
            tree = tree[key]
        return tree

    expected = {
        "vision.patch.weight": ("vision", "embeddings", "patch_kernel"),
        "vision.patch.bias": ("vision", "embeddings", "patch_bias"),
        "vision.pos_embed": ("vision", "embeddings", "pos_embed"),
        "vision.post_ln.weight": ("vision", "post_ln", "scale"),
        "vision.post_ln.bias": ("vision", "post_ln", "bias"),
        "text.token_embedding.weight": ("text", "token_embedding"),
        "text.pos_embed": ("text", "pos_embed"),
        "text.final_ln.weight": ("text", "final_ln", "scale"),
        "text.final_ln.bias": ("text", "final_ln", "bias"),
        "text.head.weight": ("text", "head", "kernel"),
        "text.head.bias": ("text", "head", "bias"),
        "logit_scale": ("logit_scale",),
        "logit_bias": ("logit_bias",),
    }
    for key, tk in _HEAD_KEYS.items():
        expected[f"vision.head.{tk}"] = ("vision", "head", key)
    for tower in ("vision", "text"):
        for i in range(cfg.vision.num_layers if tower == "vision" else cfg.text.num_layers):
            for key, tk in _LAYER_KEYS.items():
                expected[f"{tower}.encoder.layers.{i}.{tk}"] = (tower, "encoder", key)
    assert set(got) == set(expected)
    n_split = 0
    for name, path in expected.items():
        spec = tuple(leaf(specs, path).spec)
        spec = spec + (None,) * (np.ndim(leaf(params, path)) - len(spec))
        if "encoder" in path:
            spec = spec[1:]
        if path[-1].endswith("kernel"):
            spec = spec[::-1]
        assert got[name] == spec, (name, got[name], spec)
        n_split += MODEL_AXIS in spec
    # q, k, v (weight and bias), o's weight, fc1 (both), fc2's weight:
    # 10 a layer and 10 in the vision head.
    assert n_split == 10 * (cfg.vision.num_layers + cfg.text.num_layers + 1)


def test_train_step_matches_tpuclip(mesh8, pmesh, tiny):
    """tpuclip's data-parallel step on its 8-device mesh against the port's
    on 8 CPU replicas: AdamW at lr 1e-3, one memorised batch of 16 with an
    all-ones attention mask (tpuclip's step embeds unmasked). The first
    loss within 1e-5 relative, five losses within 1e-4, falling."""
    cfg, params = tiny
    rng = np.random.default_rng(4)
    images = rng.integers(0, 256, size=(16, 56, 56, 3), dtype=np.uint8)
    ids = rng.integers(0, 512, size=(16, 64)).astype(np.int32)
    opt = jx_train.make_optimizer(learning_rate=1e-3)
    state = jx_train.init_train_state(jx_sh_params(params, mesh8), opt)
    step = jx_train.make_train_step(cfg, opt, mesh=mesh8, compute_dtype=jnp.float32)
    want = []
    for _ in range(5):
        state, loss = step(state, jnp.asarray(images), jnp.asarray(ids))
        want.append(float(loss))

    popt = pt_train.make_optimizer(learning_rate=1e-3)
    pstate = pt_train.init_train_state(_port_model(params), popt, mesh=pmesh)
    pstep = pt_train.make_train_step(popt, compute_dtype=torch.float32, mesh=pmesh)
    got = []
    for _ in range(5):
        pstate, loss = pstep(pstate, _t(images), _t(ids), torch.ones(16, 64, dtype=torch.int32))
        got.append(float(loss))
    assert abs(got[0] - want[0]) <= 1e-5 * abs(want[0]), (got, want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert got[-1] < got[0] and pstate.step == 5
    lead = dict(pstate.model.named_parameters())
    for replica in pstate.replicas[1:]:
        for name, p in replica.named_parameters():
            assert torch.equal(p, lead[name]), name


def jx_sh_params(params, mesh):
    from tpuclip.parallel import shard_params as jx_shard_params

    return jx_shard_params(jax.tree.map(jnp.asarray, params), mesh)


def test_data_parallel_grads_equal_single_device(pmesh, tiny):
    """The port's summed replica gradients (gathered features, loss over
    the global batch) against its single-device gradients on the same
    masked batch: within 1e-5 of each leaf's largest gradient. The
    attention key biases' gradients are zero in exact arithmetic (rounding
    noise of ~1e-9 in both); a floor of 1e-7 absolute covers them."""
    cfg, params = tiny
    rng = np.random.default_rng(6)
    images = _t(rng.integers(0, 256, size=(16, 56, 56, 3), dtype=np.uint8))
    ids = _t(rng.integers(0, 512, size=(16, 64)).astype(np.int32))
    mask = _t((np.arange(64)[None, :] < rng.integers(3, 64, (16, 1))).astype(np.int32))
    single = _port_model(params).requires_grad_(True)
    loss = pt_train.sigmoid_contrastive_loss(single, images, ids, torch.float32, mask)
    loss.backward()
    state = pt_train.init_train_state(_port_model(params), pt_train.make_optimizer(), mesh=pmesh)
    dp_loss, grads = pt_train.data_parallel_value_and_grad(state, pmesh, images, ids, mask, torch.float32)
    assert abs(dp_loss.item() - loss.item()) <= 1e-6 * abs(loss.item())
    for name, p in single.named_parameters():
        tol = max(1e-5 * float(p.grad.abs().max()), 1e-7)
        np.testing.assert_allclose(grads[name].numpy(), p.grad.numpy(), rtol=0, atol=tol, err_msg=name)


def test_train_step_adafactor_matches_tpuclip(tiny):
    """tpuclip's single-device Adafactor test: six steps of the factored
    optimizer at lr 1e-3 on one batch of 8 in both packages. The first
    loss within 1e-5 relative; later steps part, because Adafactor clips
    each leaf's update at RMS 1 and tpuclip's encoder leaves stack every
    layer where the port's are one layer each. The port's loss falls and
    its state stays under 1.5x the parameters' bytes, as tpuclip's."""
    cfg = get_config(MODEL)
    params = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(1), cfg))
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, size=(8, 56, 56, 3), dtype=np.uint8)
    ids = rng.integers(0, 512, size=(8, 64)).astype(np.int32)
    opt = jx_train.make_optimizer(learning_rate=1e-3, factored=True)
    state = jx_train.init_train_state(jax.tree.map(jnp.asarray, params), opt)
    step = jx_train.make_train_step(cfg, opt, compute_dtype=jnp.float32)
    popt = pt_train.make_optimizer(learning_rate=1e-3, factored=True)
    pstate = pt_train.init_train_state(_port_model(params), popt)
    pstep = pt_train.make_train_step(popt, compute_dtype=torch.float32)
    want, got = [], []
    for _ in range(6):
        state, loss = step(state, jnp.asarray(images), jnp.asarray(ids))
        want.append(float(loss))
        pstate, ploss = pstep(pstate, _t(images), _t(ids))
        got.append(float(ploss))
    assert abs(got[0] - want[0]) <= 1e-5 * abs(want[0]), (got, want)
    assert got[-1] < got[0] and want[-1] < want[0] and pstate.step == 6
    param_bytes = sum(p.numel() * 4 for p in pstate.model.parameters())
    opt_bytes = sum(t.numel() * t.element_size() for part in ("v_row", "v_col", "v")
                    for t in pstate.opt_state[part].values())
    assert opt_bytes < 1.5 * param_bytes, (opt_bytes, param_bytes)


# ====================================================== DeviceIndex(mesh)


DIM = 64


def _db(tmp_path, n, seed, full=True, name="m.db", unit=True):
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n, DIM)).astype(np.float32)
    if unit:
        vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    store = MetadataStore(str(tmp_path / name), embedding_dim=DIM)
    store.init_schema(verbose=False)
    conn = sqlite3.connect(store.db_path)
    batch = [(f"/data/{'a' if i % 2 else 'b'}/img{i}.jpg", float(i), f"h{i}", vecs[i]) for i in range(n)]
    store.commit_with_retry(conn.cursor(), conn, batch, save_full_embeddings=full)
    conn.close()
    return store, vecs, rng


def _same_results(got, want, atol):
    assert [p for p, _ in got] == [p for p, _ in want] and got
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want], rtol=0, atol=atol)


def test_mesh_sharded_device_index(mesh8, pmesh, tmp_path, monkeypatch):
    """bf16 precision over fp32 rows (tpuclip's CPU default) through both
    packages' mesh indexes, folder filter included."""
    monkeypatch.setenv("TPUCLIP_SEARCH_PRECISION", "bf16")
    store, _, rng = _db(tmp_path, 300, 7)
    q = rng.standard_normal(DIM).astype(np.float32)
    jx = jx_search.DeviceIndex(store, mesh=mesh8, matrix_dtype=jnp.float32)
    pt = TorchIndex(store, mesh=pmesh)
    _same_results(pt.search(q, 9), jx.search(q, 9), 1e-5)
    got = pt.search(q, 9, filter_folders=["/data/a"])
    _same_results(got, jx.search(q, 9, filter_folders=["/data/a"]), 1e-5)
    assert all("/data/a/" in p for p, _ in got)


def test_mesh_sharded_int8_index(mesh8, pmesh, tmp_path, monkeypatch):
    """int8 without the rerank rows (the CPU's auto): kernel 3's route per
    shard, then the fp32 host rescore; the brute-force order."""
    monkeypatch.setenv("TPUCLIP_SEARCH_PRECISION", "int8")
    store, vecs, rng = _db(tmp_path, 500, 8)
    q = rng.standard_normal(DIM).astype(np.float32)
    pt = TorchIndex(store, mesh=pmesh)
    got = pt.search(q, 9)
    assert pt._rows_device is None
    _same_results(got, jx_search.DeviceIndex(store, mesh=mesh8, precision="int8").search(q, 9), 1e-6)
    order = np.lexsort((np.arange(500), -(vecs @ q)))[:9]
    assert [p for p, _ in got] == [f"/data/{'a' if i % 2 else 'b'}/img{i}.jpg" for i in order]


def test_mesh_sharded_int8_device_rerank_index(mesh8, pmesh, tmp_path, monkeypatch):
    monkeypatch.setenv("TPUCLIP_SEARCH_PRECISION", "int8")
    monkeypatch.setenv("TPUCLIP_DEVICE_RERANK", "1")
    store, vecs, rng = _db(tmp_path, 500, 13)
    qs = rng.standard_normal((3, DIM)).astype(np.float32)
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    jx = jx_search.DeviceIndex(store, mesh=mesh8, precision="int8", matrix_dtype=jnp.float32)
    pt = TorchIndex(store, mesh=pmesh)
    batched, want_batched = pt.search_batch(qs, 9), jx.search_batch(qs, 9)
    assert isinstance(pt._rows_device, pt_sh.ShardedTensor)
    for row in range(3):
        single = pt.search(qs[row], 9)
        _same_results(single, jx.search(qs[row], 9), 1e-6)
        _same_results(batched[row], want_batched[row], 1e-6)
        order = np.lexsort((np.arange(500), -(vecs @ qs[row])))[:9]
        assert [p for p, _ in single] == [f"/data/{'a' if i % 2 else 'b'}/img{i}.jpg" for i in order]


def test_mesh_sharded_binary_index(mesh8, pmesh, tmp_path):
    store, _, rng = _db(tmp_path, 205, 13, full=False, unit=False)
    q = rng.standard_normal(DIM).astype(np.float32)
    jx = jx_search.DeviceIndex(store, mesh=mesh8)
    pt = TorchIndex(store, mesh=pmesh)
    got = pt.search(q, 7)
    _same_results(got, jx.search(q, 7), 0)
    assert pt.num_full == 0 and pt.num_binary == 205
    _same_results(pt.search(q, 7, filter_folders=["/data/a"]), jx.search(q, 7, filter_folders=["/data/a"]), 0)


@pytest.mark.parametrize("prefilter", ["auto", "scores"])
def test_mesh_cascade_device_index(mesh8, pmesh, tmp_path, monkeypatch, prefilter):
    """Cascade under a mesh: no flat matrix resident, the binary rows in
    row blocks a shard, results equal to tpuclip's mesh cascade and to the
    exact single-device search at full depth, folder filter included."""
    monkeypatch.setenv("TPUCLIP_SEARCH_MODE", "cascade")
    store, _, rng = _db(tmp_path, 300, 15)
    q = rng.standard_normal(DIM).astype(np.float32)
    monkeypatch.setenv("TPUCLIP_CASCADE_DEPTH", "300")
    monkeypatch.setenv("TPUCLIP_CASCADE_PREFILTER", prefilter)
    pt = TorchIndex(store, mesh=pmesh)
    pt.refresh()
    assert pt._cascade and pt._matrix is None and isinstance(pt._bin_matrix, pt_sh.ShardedTensor)
    jx = jx_search.DeviceIndex(store, mesh=mesh8)
    monkeypatch.setenv("TPUCLIP_SEARCH_MODE", "exact")
    exact = jx_search.DeviceIndex(store)
    _same_results(pt.search(q, 9), jx.search(q, 9), 1e-6)
    _same_results(pt.search(q, 9), exact.search(q, 9), 1e-5)
    got = pt.search(q, 9, filter_folders=["/data/a"])
    _same_results(got, jx.search(q, 9, filter_folders=["/data/a"]), 1e-6)
    assert all("/data/a/" in p for p, _ in got)


@pytest.mark.parametrize("mode", ["int8_host", "int8_rerank", "bf16", "binary", "cascade", "ivf"])
def test_mesh_index_every_mode_matches_tpuclip(mesh8, pmesh, tmp_path, monkeypatch, mode):
    """search and search_batch (k 5 and 130, masked and not) through both
    packages' mesh indexes in every mode. ``ivf`` builds on the host with
    the same seed in both (the port's host build is tpuclip's)."""
    env = {
        "int8_host": {"TPUCLIP_SEARCH_PRECISION": "int8", "TPUCLIP_DEVICE_RERANK": "0"},
        "int8_rerank": {"TPUCLIP_SEARCH_PRECISION": "int8", "TPUCLIP_DEVICE_RERANK": "1"},
        "bf16": {"TPUCLIP_SEARCH_PRECISION": "bf16"},
        "binary": {},
        "cascade": {"TPUCLIP_SEARCH_MODE": "cascade", "TPUCLIP_SEARCH_PRECISION": "int8"},
        "ivf": {"TPUCLIP_SEARCH_MODE": "ivf", "TPUCLIP_SEARCH_PRECISION": "int8", "TPUCLIP_DEVICE_RERANK": "1"},
    }[mode]
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    store, _, rng = _db(tmp_path, 600, 21, full=mode != "binary")
    queries = rng.standard_normal((5, DIM)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    jx = jx_search.DeviceIndex(store, mesh=mesh8, matrix_dtype=jnp.float32)
    pt = TorchIndex(store, mesh=pmesh)
    pt.refresh()
    if mode == "ivf":
        assert pt._ivf_sharded is not None
        assert pt.resident_bytes() > pt._ivf_sharded.nbytes() > 0
    atol = 0 if mode == "binary" else 1e-5
    for k in (5, 130):
        for folders in (None, ["/data/a"]):
            _same_results(pt.search(queries[0], k, folders), jx.search(queries[0], k, folders), atol)
            for got, want in zip(pt.search_batch(queries, k, folders), jx.search_batch(queries, k, folders)):
                _same_results(got, want, atol)
    assert not pt.can_fuse_text_search(5, None)


def test_rerank_gate_counts_bytes_per_device(pmesh, tmp_path, monkeypatch):
    """The rerank gate under ``auto`` on CUDA (the device type set by hand
    here): the int8 matrix and the bf16 rows, (1 + 2) bytes a dimension a
    row, count per device, so eight shards hold eight times the rows under
    one budget; in the ivf mode the IVF blocks and the mesh's embedded rows
    count too, divided alike."""
    from tpuclip_torch.index.ivf import default_clusters

    store, _, _ = _db(tmp_path, 10, 1)
    monkeypatch.setenv("TPUCLIP_DEVICE_RERANK_MAX_GB", "1")
    single, meshed = TorchIndex(store, device="cpu"), TorchIndex(store, mesh=pmesh)
    for idx in (single, meshed):
        idx.device, idx.matrix_dtype = torch.device("cuda"), torch.bfloat16
    n1 = int(1e9 // (3 * DIM))
    assert single._want_device_rerank(n1) and not single._want_device_rerank(n1 + 1)
    assert meshed._want_device_rerank(8 * n1) and not meshed._want_device_rerank(8 * n1 + 8)
    meshed.search_mode = "ivf"
    n = 2_000_000
    slots = int(n * 1.5)
    per_device = (n * DIM * 3 + slots * DIM + slots * 8 + default_clusters(n) * DIM * 4 + slots * DIM * 2) / 8
    monkeypatch.setenv("TPUCLIP_DEVICE_RERANK_MAX_GB", str(per_device / 1e9 * 1.0001))
    assert meshed._want_device_rerank(n)
    monkeypatch.setenv("TPUCLIP_DEVICE_RERANK_MAX_GB", str(per_device / 1e9 * 0.9999))
    assert not meshed._want_device_rerank(n)


def test_sharded_index_env_on_one_device_serves_single_route(tmp_path, monkeypatch):
    """TPUCLIP_SHARDED_INDEX=1 with one device (the CPU here): no mesh, the
    single-device route, tpuclip's results (which shards over its 8
    virtual devices)."""
    monkeypatch.setenv("TPUCLIP_SEARCH_PRECISION", "int8")
    monkeypatch.setenv("TPUCLIP_DEVICE_RERANK", "1")
    monkeypatch.setenv("TPUCLIP_SHARDED_INDEX", "1")
    store, _, rng = _db(tmp_path, 200, 3)
    q = rng.standard_normal((2, DIM)).astype(np.float32)
    pt = TorchIndex(store, device="cpu")
    jx = jx_search.DeviceIndex(store, precision="int8", matrix_dtype=jnp.float32)
    assert pt.mesh is None and jx.mesh is not None
    for got, want in zip(pt.search_batch(q, 7), jx.search_batch(q, 7)):
        _same_results(got, want, 1e-6)


# ================================================ device-correct launches


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports ``cuda:1``: drives a wrapper's CUDA branch
    on a machine without a card."""

    @property
    def device(self):
        return torch.device("cuda", 1)


def _fake(x):
    return x.as_subclass(_FakeCuda)


@pytest.mark.parametrize("wrapper", [
    "int8_scores", "int8_candidates_packed", "int8_candidates", "topk_tiles", "binary_scores",
    "binary_topk_q1", "binary_topk_batched", "patch_embed_fused", "attention", "attention_sm90", "add_layer_norm",
    "rope",
])
def test_wrappers_launch_on_their_inputs_device(monkeypatch, wrapper):
    """Every CUDA wrapper makes its input's device current and passes that
    device's current stream, whatever device is current: with a recorder in
    place of the library, a cuda:1 input is launched on cuda:1's stream."""
    from contextlib import contextmanager
    from types import SimpleNamespace

    import tpuclip_torch.ops._build as build
    import tpuclip_torch.ops.attention as aops
    import tpuclip_torch.ops.hamming as hops
    import tpuclip_torch.ops.layernorm as lops
    import tpuclip_torch.ops.patch_embed as pops
    import tpuclip_torch.ops.rope as rops
    import tpuclip_torch.ops.topk as tops
    import tpuclip_torch.ops.topk_int8 as ops

    current, calls = [torch.device("cuda", 0)], []

    @contextmanager
    def device(dev):
        saved, current[0] = current[0], torch.device(dev)
        try:
            yield
        finally:
            current[0] = saved

    def stream(dev=None):
        dev = torch.device(dev) if dev is not None else current[0]
        return SimpleNamespace(cuda_stream=1000 + dev.index)

    def recorder(name):
        def entry(*args):
            calls.append((name, current[0], args[-1]))
            return 0
        return entry

    real_empty = torch.empty
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", stream)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: SimpleNamespace(multi_processor_count=132))
    monkeypatch.setattr(torch, "empty", lambda *a, device=None, **kw: real_empty(*a, **kw))
    monkeypatch.setattr(build, "library", lambda: SimpleNamespace(**{n: recorder(n) for n in build.SIGNATURES}))

    rng = np.random.default_rng(0)
    q8 = _fake(torch.from_numpy(rng.integers(-127, 128, (2, 32), dtype=np.int8)))
    m8 = _fake(torch.from_numpy(rng.integers(-127, 128, (256, 32), dtype=np.int8)))
    sc = _fake(torch.ones(256))
    words = _fake(torch.from_numpy(rng.integers(-(2**31), 2**31, (512, 4), dtype=np.int64).astype(np.int32)))
    qw = _fake(words[:2].clone())
    runs = {
        "int8_scores": lambda: ops.int8_scores(q8, m8, sc, 256),
        "int8_candidates_packed": lambda: ops.int8_candidates_packed(q8, m8, sc, 8, 256, 128),
        "int8_candidates": lambda: ops.int8_candidates(q8, m8, sc, 8, 256, 128),
        "topk_tiles": lambda: tops.topk_tiles(_fake(torch.randn(2, 32)),
                                              _fake(torch.randn(256, 32).to(torch.bfloat16)), 5, 256),
        "binary_scores": lambda: hops.binary_scores(qw[:1], words, 512),
        "binary_topk_q1": lambda: hops.binary_topk_q1(qw[:1], words, 5, 512),
        "binary_topk_batched": lambda: hops.binary_topk_batched(qw, words, 5, 512),
        "patch_embed_fused": lambda: pops.patch_embed_fused(
            _fake(torch.from_numpy(rng.integers(0, 256, (16, 12), dtype=np.uint8))),
            _fake(torch.randn(12, 16).to(torch.bfloat16)), _fake(torch.zeros(16))),
        "attention": lambda: aops.attention(*(_fake(torch.randn(2, 8, 32).to(torch.bfloat16)) for _ in range(3)),
                                            4, _fake(torch.zeros(2, 8))),
        # kernel 9's Hopper design: a shape its rule takes (128 rows, two heads of 72)
        "attention_sm90": lambda: aops.attention(
            *(_fake(torch.randn(2, 128, 144).to(torch.bfloat16)) for _ in range(3)), 2, _fake(torch.zeros(2, 128))),
        "add_layer_norm": lambda: lops.add_layer_norm(
            *(_fake(torch.randn(shape).to(torch.bfloat16)) for shape in ((4, 64), (4, 64), 64, 64)), 1e-6),
        "rope": lambda: rops.rope(*(_fake(torch.randn(2, 19, 128).to(torch.bfloat16)) for _ in range(2)),
                                  *(_fake(torch.randn(16, 16)) for _ in range(2)), 4, 3),
    }
    runs[wrapper]()
    assert calls and all(dev == torch.device("cuda", 1) and s == 1001 for _, dev, s in calls), calls
    assert [name for name, _, _ in calls] == [{"attention": "tpuclip_attention",
                                               "attention_sm90": "tpuclip_attention_sm90",
                                               "add_layer_norm": "tpuclip_add_layernorm"}.get(wrapper, name)
                                              for name, _, _ in calls]
    assert current[0] == torch.device("cuda", 0)


# ============================================================ on the card


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8_rerank", "int8_host", "bf16"])
def test_cuda_mesh_of_one_card_twice_equals_unsharded(mode):
    """``make_mesh(["cuda:0"] * 2)``: two shards on the one card, each
    running the kernels with its own n_valid, against the unsharded search
    on the same rows: ids identical, scores within 1e-6 (bf16: 1e-5)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import tpuclip_torch.ops.topk as tops
    import tpuclip_torch.ops.topk_int8 as ops

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    mesh = make_mesh([dev, dev])
    rng = np.random.default_rng(40)
    n, d, k = 30_000, 128, 20
    rows = torch.nn.functional.normalize(torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)), dim=1)
    q = torch.nn.functional.normalize(torch.from_numpy(rng.standard_normal((4, d), dtype=np.float32)), dim=1).to(dev)
    tile = ops.INT8_TILE_N if mode != "bf16" else tops.DEFAULT_TILE_N
    padded, _ = pt_sh.pad_for_mesh(rows, mesh, tile)
    bf = padded.to(dev, torch.bfloat16)
    if mode == "bf16":
        want = tops.cosine_topk(q, bf, k, n)
        got = pt_sh.sharded_topk(q, pt_sh.shard_matrix(bf, mesh), k, mesh, n)
        atol = 1e-5
    else:
        m8, sc = ops.derive_int8_matrix(bf, bf.shape[0])
        if mode == "int8_rerank":
            want = ops.topk_int8_rerank_fused(q, m8, sc, bf, k, n_valid=n, shortlist_method="extract")
            got = pt_sh.sharded_topk_int8_rerank(q, m8, sc, bf, k, mesh, n)
        else:
            qi, qs = ops.quantize_queries(q)
            want = ops.topk_int8_scores(qi, m8, sc, qs, k, n)
            got = pt_sh.sharded_topk_int8(qi, m8, sc, qs, k, mesh, n)
        atol = 1e-6
    np.testing.assert_array_equal(got[1].cpu().numpy(), want[1].cpu().numpy())
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(), rtol=0, atol=atol)
