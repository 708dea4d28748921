"""The port's cluster-sharded IVF (``tpuclip_torch/parallel/sharded_ivf.py``)
against tpuclip's, on the CPU: tpuclip's host build on
``tests/test_sharded_ivf.py``'s clustered data is carried over to the port
(``index.ivf.ivf_from_jax``), then sharded by each package, tpuclip's over
its 8-device virtual CPU mesh and the port's over ``make_mesh(["cpu"] *
8)``. Each test of ``tests/test_sharded_ivf.py`` has its counterpart:
ids identical to tpuclip's and scores within 1e-5 (fp32 rows) or 1e-6
(bf16 rows), duplicates planted, K not divisible by the mesh (K = 10, 11)
and a small overflow block; recall, and the exact-scan equality at
nprobe = K, also on the port alone."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuclip.index.ivf import build_ivf
from tpuclip.ops.topk import pad_matrix_t
from tpuclip.ops.topk_int8 import quantize_matrix_t, topk_int8_rerank_fused
from tpuclip.parallel import make_mesh as jx_make_mesh
from tpuclip.parallel.sharded_ivf import shard_ivf as jx_shard_ivf
from tpuclip.parallel.sharded_ivf import sharded_ivf_search as jx_sharded_ivf_search
from tpuclip_torch.index.ivf import ivf_from_jax
from tpuclip_torch.parallel import make_mesh
from tpuclip_torch.parallel.sharded_ivf import shard_ivf, sharded_ivf_search


@pytest.fixture(scope="module")
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices (virtual CPU mesh)")
    return jx_make_mesh(model_parallelism=1)


@pytest.fixture(scope="module")
def pmesh():
    return make_mesh(["cpu"] * 8)


def _clustered(n, d, modes, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((modes, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    x = centers[rng.integers(0, modes, n)] + 0.07 * rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(np.float32), centers


def _oracle(x, q, k):
    exact = q @ x.T
    order = np.stack([np.lexsort((np.arange(len(x)), -exact[r]))[:k] for r in range(len(q))])
    return np.take_along_axis(exact, order, axis=1), order


def _both(index, x, q, k, mesh8, pmesh, nprobe=None, rows=None):
    """(tpuclip's, the port's) sharded IVF results for one host build."""
    rows_j = jnp.asarray(x) if rows is None else rows
    want = jx_sharded_ivf_search(jx_shard_ivf(index, rows_j, mesh8), q, k, nprobe=nprobe)
    rows_t = torch.from_numpy(x) if rows is None else torch.from_numpy(np.asarray(rows, np.float32)).to(torch.bfloat16)
    got = sharded_ivf_search(shard_ivf(ivf_from_jax(index), rows_t, pmesh), q, k, nprobe=nprobe)
    return [np.asarray(a) for a in want], [a.float().numpy() if a.is_floating_point() else a.numpy() for a in got]


def _agree(got, want, atol):
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=atol)


def test_probe_all_equals_exact_scan_with_duplicates(mesh8, pmesh):
    n, d, k = 1536, 64, 10
    x, centers = _clustered(n, d, modes=12, seed=1)
    x[100:113] = x[99]
    x[700:705] = x[699]
    rng = np.random.default_rng(2)
    q = centers[rng.integers(0, 12, 5)] + 0.02 * rng.standard_normal((5, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[0] = x[99]
    index = build_ivf(x, k_clusters=24, nprobe=4, seed=0)
    want, got = _both(index, x, q, k, mesh8, pmesh, nprobe=24)
    _agree(got, want, 1e-5)
    ref_s, ref_i = _oracle(x, q, k)
    np.testing.assert_array_equal(got[1], ref_i)
    np.testing.assert_allclose(got[0], ref_s, rtol=2e-5, atol=2e-6)


def test_returned_scores_are_exact_dots(mesh8, pmesh):
    n, d, k = 1024, 48, 8
    x, centers = _clustered(n, d, modes=10, seed=3)
    rng = np.random.default_rng(4)
    q = centers[rng.integers(0, 10, 4)] + 0.05 * rng.standard_normal((4, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    index = build_ivf(x, k_clusters=20, nprobe=4, seed=0)
    want, got = _both(index, x, q, k, mesh8, pmesh)
    _agree(got, want, 1e-5)
    exact = q @ x.T
    for r in range(len(q)):
        np.testing.assert_allclose(got[0][r], exact[r][got[1][r]], rtol=2e-5, atol=2e-6)


def test_recall_on_clustered_data(mesh8, pmesh):
    n, d, k = 4096, 64, 20
    x, centers = _clustered(n, d, modes=32, seed=5)
    rng = np.random.default_rng(6)
    q = centers[rng.integers(0, 32, 8)] + 0.05 * rng.standard_normal((8, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    index = build_ivf(x, k_clusters=64, nprobe=16, seed=0)
    want, got = _both(index, x, q, k, mesh8, pmesh)
    _agree(got, want, 1e-5)
    _, ref_i = _oracle(x, q, k)
    recall = np.mean([len(set(got[1][r]) & set(ref_i[r])) / k for r in range(len(q))])
    assert recall >= 0.9, f"recall {recall}"


def test_uneven_cluster_and_overflow_axes(mesh8, pmesh):
    """K = 10 and a small overflow block over 8 shards: padding clusters
    and slots never surface."""
    n, d, k = 520, 32, 6
    x, centers = _clustered(n, d, modes=6, seed=7)
    q = centers[np.random.default_rng(8).integers(0, 6, 3)].astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    index = build_ivf(x, k_clusters=10, nprobe=10, capacity_factor=1.05, seed=0)
    assert (np.asarray(index.over_rows) >= 0).sum() > 0
    want, got = _both(index, x, q, k, mesh8, pmesh, nprobe=10)
    assert (got[1] >= 0).all() and (got[1] < n).all()
    _agree(got, want, 1e-5)
    ref_s, ref_i = _oracle(x, q, k)
    np.testing.assert_array_equal(got[1], ref_i)


def test_boundary_shard_cluster_alignment(mesh8, pmesh):
    """K = 11 padded to 16 over 8 shards, nprobe 8 (one bucket a shard out
    of two): every cluster stays reachable, as in tpuclip after its
    centroid-padding repair."""
    n, d, k = 2200, 48, 8
    x, _ = _clustered(n, d, modes=11, seed=13)
    index = build_ivf(x, k_clusters=11, nprobe=8, seed=0)
    q = np.array(index.centroids, np.float32, copy=True)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    want, got = _both(index, x, q, k, mesh8, pmesh, nprobe=8)
    _agree(got, want, 1e-5)
    _, ref_i = _oracle(x, q, k)
    for r in range(11):
        assert len(set(got[1][r]) & set(ref_i[r])) / k >= 0.9, r


def test_bf16_rows_match_flat_rescore_contract(mesh8, pmesh):
    """bf16 embedded rows: the rescore rounds the query to bf16, so the
    sharded IVF at nprobe = K returns tpuclip's flat fused search's ids and
    scores (within 1e-6), and tpuclip's sharded IVF's."""
    n, d, k = 768, 64, 8
    x, centers = _clustered(n, d, modes=8, seed=9)
    rng = np.random.default_rng(10)
    q = centers[rng.integers(0, 8, 3)] + 0.03 * rng.standard_normal((3, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    index = build_ivf(x, k_clusters=12, nprobe=12, seed=0)
    rows_bf16 = jnp.asarray(x, jnp.bfloat16)
    want, got = _both(index, x, q, k, mesh8, pmesh, nprobe=12, rows=rows_bf16)
    _agree(got, want, 1e-6)
    mt, nv = pad_matrix_t(x.T.copy(), tile_n=256)
    mq, scales = quantize_matrix_t(mt)
    s_flat, i_flat = topk_int8_rerank_fused(
        jnp.asarray(q), jnp.asarray(mq), jnp.asarray(scales), rows_bf16, k,
        n_valid=jnp.asarray(nv, jnp.int32), use_pallas=False,
    )
    _agree(got, [np.asarray(s_flat), np.asarray(i_flat)], 1e-6)


def test_shard_ivf_bytes_and_host_rows(pmesh):
    """The embedded rows gathered from a host fp32 array (the memmap's
    route) in a storage dtype equal those gathered from a tensor in it;
    ``nbytes`` counts each shard's blocks and one centroid replica."""
    x, _ = _clustered(600, 32, modes=5, seed=3)
    index = ivf_from_jax(build_ivf(x, k_clusters=10, nprobe=4, seed=0))
    a = shard_ivf(index, x, pmesh, dtype=torch.bfloat16)
    b = shard_ivf(index, torch.from_numpy(x).to(torch.bfloat16), pmesh)
    for sa, sb in zip(a.bucket_rows_full.shards + a.over_rows_full.shards,
                      b.bucket_rows_full.shards + b.over_rows_full.shards):
        assert sa.dtype == torch.bfloat16 and torch.equal(sa, sb)
    k_pad, cap = 16, index.buckets.shape[1]
    o_pad = -(-index.overflow.shape[0] // 128) * 128
    want = k_pad * 32 * 4 + k_pad * cap * (32 + 4 + 4 + 32 * 2) + o_pad * (32 + 4 + 4 + 32 * 2)
    assert a.nbytes() == want
