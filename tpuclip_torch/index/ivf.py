"""IVF (inverted-file) approximate search (PyTorch port of ``tpuclip/index/ivf.py``).

Spherical k-means on the device puts the rows into K balanced buckets of a
fixed capacity C (``capacity_factor`` x the mean size, rounded up to 8);
rows of a full bucket spill to one overflow block that every query scans,
so no row is ever unreachable. A query scores its ``nprobe`` nearest
buckets and the overflow block in int8 on kernel 1
(:func:`~tpuclip_torch.ops.topk_int8.int8_scores`), shortlists max(4k, 64)
candidates and rescores them exactly against the resident rows
(:func:`~tpuclip_torch.ops.topk_int8._rescore_select`): a returned score
equals the exact search's for that row, and only which rows are considered
is approximate.

Layout: row-major, as the rest of the port. The buckets are (K, C, D) int8
(tpuclip: (K, D, C)) and the overflow block (O, D) (tpuclip: (D, O)), so a
probed bucket is one contiguous (C, D) block that kernel 1 scans as it
scans the flat matrix. :func:`ivf_from_jax` carries tpuclip's arrays over.

Orders follow tpuclip's ``lax.top_k`` (the lowest position first among
ties) through unique order keys, on the CPU and on CUDA alike.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from tpuclip_torch.device import DeviceLike, resolve_device
from tpuclip_torch.ops.topk_int8 import (
    _rescore_select,
    derive_int8_matrix,
    int8_scores,
    order_keys,
    quantize_queries,
)

_NEG_INF = float("-inf")
# Rows per step of the chunked assignment and quantization: a whole (N, K)
# fp32 score block at 1M x 2000 would be 8 GB.
_CHUNK = 131_072


class IVFIndex(NamedTuple):
    centroids: torch.Tensor      # (K, D) f32 unit
    buckets: torch.Tensor        # (K, C, D) int8, row-major blocks
    bucket_scales: torch.Tensor  # (K, C) f32 per-row scales (0 for empty slots)
    bucket_rows: torch.Tensor    # (K, C) int32 global row ids (-1 empty)
    overflow: torch.Tensor       # (O, D) int8 overflow block (always scanned)
    over_scales: torch.Tensor    # (O,) f32
    over_rows: torch.Tensor      # (O,) int32 (-1 padding)
    nprobe: int

    def nbytes(self) -> int:
        """Bytes of the index's tensors on the device."""
        return sum(t.numel() * t.element_size() for t in self[:7])


def default_clusters(n: int) -> int:
    """~2 sqrt(N), at least 8, at most N // 8 (tpuclip's rule)."""
    return int(max(8, min(2 * int(np.sqrt(n)), n // 8 or 8)))


def bucket_capacity(n: int, k_clusters: int, capacity_factor: float) -> int:
    """C = ceil(N / K * capacity_factor), rounded up to a multiple of 8."""
    cap = int(-(-(n / k_clusters * capacity_factor) // 1))
    return max(8, -(-cap // 8) * 8)


# =============================================================================
# Spherical k-means
# =============================================================================


def _kmeans(sample: torch.Tensor, init_idx: torch.Tensor, k: int, iters: int) -> torch.Tensor:
    """Spherical k-means on unit rows (tpuclip's ``_kmeans_device``): cosine
    assignment (the first maximum), renormalised mean updates; an empty
    cluster keeps its previous centroid. The cluster sums are a one-hot
    matmul, as tpuclip's, so they are deterministic on CUDA. fp32 matmuls:
    the caller keeps TF32 off."""
    x = sample.float()
    cent = x[init_idx.long()]
    for _ in range(iters):
        assign = torch.argmax(x @ cent.T, dim=1)
        one_hot = torch.nn.functional.one_hot(assign, k).float()  # (M, k)
        sums = one_hot.T @ x
        counts = one_hot.sum(dim=0)[:, None]
        norms = torch.linalg.vector_norm(sums, dim=1, keepdim=True)
        keep = (counts > 0) & (norms > 1e-12)
        cent = torch.where(keep, sums / norms.clamp_min(1e-12), cent)
    return cent


def train_centroids(
    vectors: np.ndarray, k: int, iters: int = 12, sample: int = 131_072, seed: int = 0,
    device: DeviceLike = None,
) -> torch.Tensor:
    """(N, D) f32 host rows → (k, D) f32 unit centroids on ``device`` (the
    card unless the caller names the CPU). The sample and the initial
    centroids are numpy ``default_rng(seed)`` draws, tpuclip's own, so both
    packages start k-means from the same rows."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    n = len(vectors)
    take = min(n, sample)
    idx = rng.choice(n, size=take, replace=False) if take < n else np.arange(n)
    x = np.asarray(vectors[np.sort(idx)], np.float32)
    x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
    init = np.sort(rng.choice(take, size=k, replace=False))
    return _kmeans(torch.from_numpy(x).to(device), torch.from_numpy(init).to(device), k, iters)


def _assign(rows: torch.Tensor, cent: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked argmax of fp32 rows x centroids: ((N,) int64 cluster ids,
    (K,) counts, on the rows' device)."""
    n = rows.shape[0]
    assign = torch.empty(n, dtype=torch.int64, device=rows.device)
    cent_t = cent.T.contiguous()
    for s in range(0, n, _CHUNK):
        assign[s : s + _CHUNK] = torch.argmax(rows[s : s + _CHUNK].float() @ cent_t, dim=1)
    return assign, torch.bincount(assign, minlength=cent.shape[0])


# =============================================================================
# Host build (tpuclip's build_ivf)
# =============================================================================


def build_ivf(
    vectors: np.ndarray,
    k_clusters: Optional[int] = None,
    capacity_factor: float = 1.5,
    nprobe: int = 32,
    iters: int = 12,
    seed: int = 0,
    centroids: Optional[np.ndarray] = None,
    device: DeviceLike = None,
) -> IVFIndex:
    """Cluster (N, D) f32 host rows into balanced fixed-capacity buckets;
    k-means and the assignment run on ``device`` (the card unless the caller
    names the CPU), the quantization and fill in numpy, as tpuclip's host
    build (``/ 127.0``, true divisions). ``centroids`` (a previous build's)
    skips the k-means."""
    device = resolve_device(device)
    n, d = vectors.shape
    if centroids is not None:
        k_clusters = int(centroids.shape[0])
    if k_clusters is None:
        k_clusters = default_clusters(n)
    k_clusters = max(1, min(k_clusters, n))
    nprobe = max(1, min(nprobe, k_clusters))
    if centroids is not None:
        cent = torch.as_tensor(np.asarray(centroids, np.float32)).to(device)
    else:
        cent = train_centroids(vectors, k_clusters, iters=iters, seed=seed, device=device)
    x = np.asarray(vectors, np.float32)
    assign_t, _ = _assign(torch.from_numpy(np.ascontiguousarray(x)).to(device), cent)
    assign = assign_t.cpu().numpy()
    cap = bucket_capacity(n, k_clusters, capacity_factor)

    scales_all = np.abs(x).max(axis=1) / 127.0
    scales_all = np.where(scales_all == 0, 1.0, scales_all).astype(np.float32)
    q_all = np.clip(np.rint(x / scales_all[:, None]), -127, 127).astype(np.int8)

    # Rows sorted by cluster; position-in-cluster from the cumulative counts;
    # positions past the capacity spill to the overflow block.
    order = np.argsort(assign, kind="stable")
    sorted_assign = assign[order]
    counts = np.bincount(sorted_assign, minlength=k_clusters)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(n, dtype=np.int64) - starts[sorted_assign]
    in_bucket = pos < cap

    buckets = np.zeros((k_clusters, cap, d), np.int8)
    bucket_scales = np.zeros((k_clusters, cap), np.float32)
    bucket_rows = np.full((k_clusters, cap), -1, np.int32)
    bc, bp, br = sorted_assign[in_bucket], pos[in_bucket], order[in_bucket]
    buckets[bc, bp] = q_all[br]
    bucket_scales[bc, bp] = scales_all[br]
    bucket_rows[bc, bp] = br.astype(np.int32)

    ov = order[~in_bucket]
    o = len(ov)
    o_pad = max(8, -(-max(o, 1) // 128) * 128)
    overflow = np.zeros((o_pad, d), np.int8)
    over_scales = np.zeros(o_pad, np.float32)
    over_rows = np.full(o_pad, -1, np.int32)
    overflow[:o] = q_all[ov]
    over_scales[:o] = scales_all[ov]
    over_rows[:o] = ov.astype(np.int32)

    def up(a):
        return torch.from_numpy(a).to(device)

    return IVFIndex(
        cent, up(buckets), up(bucket_scales), up(bucket_rows), up(overflow), up(over_scales),
        up(over_rows), int(nprobe),
    )


# =============================================================================
# Device build (from the resident rows)
# =============================================================================


def _ivf_train_assign(rows_full, generator, k_clusters, iters, sample_cap):
    """k-means on a strided sample of the rows (initial centroids a seeded
    permutation of it), then the full assignment: (centroids, (N,)
    assignment, (K,) counts)."""
    n = rows_full.shape[0]
    stride = max(1, -(-n // sample_cap))
    sample = rows_full[::stride][:sample_cap].float()
    sample = sample / torch.linalg.vector_norm(sample, dim=1, keepdim=True).clamp_min(1e-12)
    perm = torch.randperm(sample.shape[0], generator=generator, device=rows_full.device)
    cent = _kmeans(sample, perm[:k_clusters], k_clusters, iters)
    return (cent, *_assign(rows_full, cent))


def _ivf_fill_device(rows_full, assign, counts, k_clusters, cap, o_pad):
    """Quantize (the jitted form: scale max|x| * f32(1/127), as
    :func:`derive_int8_matrix`) and scatter into the fixed blocks: rows
    sorted (stably) by cluster, position-in-cluster < cap to its bucket
    slot, the rest to the overflow block in sorted order. Spilled rows all
    write one trash slot past the blocks, which is dropped, so only its
    contents depend on the scatter's order."""
    n, d = rows_full.shape
    dev = rows_full.device
    q_all, scales = derive_int8_matrix(rows_full, n)
    order = torch.sort(assign, stable=True).indices
    sorted_assign = assign[order]
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(n, device=dev) - starts[sorted_assign]
    in_bucket = pos < cap
    trash = k_clusters * cap
    slot = torch.where(in_bucket, sorted_assign * cap + pos, trash)
    q_sorted, scales_sorted, rows_sorted = q_all[order], scales[order], order.to(torch.int32)
    del q_all

    def scatter(size, fill, dtype, where, values, shape):
        out = torch.full((size + 1, *values.shape[1:]), fill, dtype=dtype, device=dev)
        out[where] = values
        return out[:-1].view(shape)

    ov_rank = torch.cumsum((~in_bucket).long(), 0) - 1
    oslot = torch.where(in_bucket, o_pad, ov_rank.clamp_max(o_pad))
    return (
        scatter(trash, 0, torch.int8, slot, q_sorted, (k_clusters, cap, d)),
        scatter(trash, 0.0, torch.float32, slot, scales_sorted, (k_clusters, cap)),
        scatter(trash, -1, torch.int32, slot, rows_sorted, (k_clusters, cap)),
        scatter(o_pad, 0, torch.int8, oslot, q_sorted, (o_pad, d)),
        scatter(o_pad, 0.0, torch.float32, oslot, scales_sorted, (o_pad,)),
        scatter(o_pad, -1, torch.int32, oslot, rows_sorted, (o_pad,)),
    )


def build_ivf_device(
    rows_full: torch.Tensor,
    k_clusters: Optional[int] = None,
    capacity_factor: float = 1.5,
    nprobe: int = 32,
    iters: int = 12,
    seed: int = 0,
    centroids: Optional[torch.Tensor] = None,
) -> IVFIndex:
    """Build an :class:`IVFIndex` on the device from the resident (N, D)
    rows (tpuclip's ``build_ivf_device``): k-means on a strided sample of
    up to 131,072 rows, the chunked assignment, the quantization and the
    balanced scatter all stay on the rows' device. The one host sync is the
    spill count, which sizes the overflow block exactly.

    The initial centroids are a permutation drawn from a
    ``torch.Generator`` seeded with ``seed`` on the rows' device, so the
    port's centroids differ from tpuclip's (a ``jax.random`` permutation)
    for the same seed. ``centroids`` (a previous build's (K, D)) skips the
    k-means: one assignment pass against them, the incremental refresh."""
    n, d = rows_full.shape
    if k_clusters is None:
        k_clusters = default_clusters(n)
    k_clusters = max(1, min(k_clusters, n))
    nprobe = max(1, min(nprobe, k_clusters))
    cap = bucket_capacity(n, k_clusters, capacity_factor)
    if centroids is not None and tuple(centroids.shape) == (k_clusters, d):
        cent = centroids.to(device=rows_full.device, dtype=torch.float32)
        assign, counts = _assign(rows_full, cent)
    else:
        generator = torch.Generator(device=rows_full.device).manual_seed(seed)
        cent, assign, counts = _ivf_train_assign(
            rows_full, generator, k_clusters, iters, min(_CHUNK, n)
        )
    spill = int((counts - cap).clamp_min(0).sum())  # host sync: one scalar
    o_pad = max(128, -(-spill // 128) * 128)
    return IVFIndex(cent, *_ivf_fill_device(rows_full, assign, counts, k_clusters, cap, o_pad), int(nprobe))


def ivf_from_jax(arrays) -> IVFIndex:
    """tpuclip's ``IVFIndex`` (its fields as numpy arrays, in order, or the
    NamedTuple itself) → the port's row-major index on the CPU: buckets
    (K, D, C) → (K, C, D), overflow (D, O) → (O, D)."""
    cent, buckets, bscales, brows, over_t, oscales, orows, nprobe = arrays

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))

    return IVFIndex(
        t(np.asarray(cent, np.float32)), t(np.asarray(buckets).transpose(0, 2, 1)), t(bscales),
        t(brows), t(np.asarray(over_t).T), t(oscales), t(orows), int(nprobe),
    )


# =============================================================================
# Search
# =============================================================================


def _top_positions(scores: torch.Tensor, m: int) -> torch.Tensor:
    """(Q, M) positions of each row's top ``m`` scores, ordered (score desc,
    position asc): ``lax.top_k``'s order, on every device."""
    positions = torch.arange(scores.shape[1], device=scores.device).expand_as(scores)
    return torch.topk(order_keys(scores, positions), m, dim=1).indices


def ivf_topk_rerank(
    q_f32: torch.Tensor,
    centroids: torch.Tensor,
    buckets: torch.Tensor,
    bucket_scales: torch.Tensor,
    bucket_rows: torch.Tensor,
    overflow: torch.Tensor,
    over_scales: torch.Tensor,
    over_rows: torch.Tensor,
    rows_full: torch.Tensor,
    k: int,
    nprobe: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Probe the top-``nprobe`` buckets and the overflow block, int8-score
    them on kernel 1, shortlist m = min(max(4k, 64), P*C + O) candidates
    and rescore them exactly against ``rows_full``: ((Q, min(k, m)) f32
    scores, (Q, min(k, m)) int64 rows), ordered (score desc, row asc),
    invalid slots (-inf, INT32_MAX).

    Each query's P probed (C, D) blocks and their scales are gathered into
    one contiguous (P*C, D) slab, which kernel 1 scores at Q = 1; the
    overflow block takes one launch for all queries. Empty slots score 0
    and are masked to -inf by their row id -1."""
    q_count = q_f32.shape[0]
    kk, cap, d = buckets.shape
    q = q_f32.float()
    qi, _ = quantize_queries(q)
    probe = _top_positions(q @ centroids.T, min(nprobe, kk))  # (Q, P)
    p = probe.shape[1]
    bucket_s = torch.empty((q_count, p * cap), dtype=torch.float32, device=q.device)
    for i in range(q_count):
        slab = buckets[probe[i]].view(p * cap, d)
        bucket_s[i] = int8_scores(qi[i : i + 1], slab, bucket_scales[probe[i]].view(-1), p * cap)[0]
    bucket_r = bucket_rows[probe].view(q_count, p * cap)
    over_s = int8_scores(qi, overflow, over_scales, overflow.shape[0])
    cand_s = torch.cat([bucket_s, over_s], dim=1)
    cand_r = torch.cat([bucket_r, over_rows.expand(q_count, -1)], dim=1)
    cand_s = cand_s.masked_fill(cand_r < 0, _NEG_INF)
    m = min(max(4 * k, 64), cand_s.shape[1])
    pos = _top_positions(cand_s, m)
    return _rescore_select(
        cand_r.gather(1, pos), torch.isneginf(cand_s.gather(1, pos)), q, rows_full, min(k, m)
    )


def ivf_search(index: IVFIndex, rows_full: torch.Tensor, q_f32, k: int):
    """:func:`ivf_topk_rerank` with an :class:`IVFIndex`'s tensors bound;
    ``q_f32`` may be host numpy."""
    if not torch.is_tensor(q_f32):
        q_f32 = torch.from_numpy(np.ascontiguousarray(q_f32, np.float32))
    q = q_f32.to(rows_full.device).reshape(-1, index.centroids.shape[1])
    return ivf_topk_rerank(q, *index[:7], rows_full, k, index.nprobe)
