"""Mesh-sharded brute-force search (PyTorch port of
``tpuclip/parallel/sharded_search.py``).

The rows are split row-major over the mesh's data axis: global shard ``s``
holds rows [s * rps, (s + 1) * rps), on its own device, padded with zero
rows so every shard has the same ``rps`` (a multiple of the kernel tile,
``pad_for_mesh``). Each local shard runs the port's kernels on its rows
with its own ``n_valid`` (clip(n_valid - s * rps, 0, rps)), so padding
never scores; a shard with no valid row launches nothing. Its (Q, <= k)
candidates carry global rows (+ s * rps); they are padded to k, gathered
on the mesh's lead device, ``all_gather``-ed across the processes when the
mesh has a process group, and reduced to the global top-k ordered (score
desc, row asc), the single-device order. Communication is O(ndev * Q * k),
independent of N.

The routes per shard:

- :func:`sharded_topk` (bf16 / fp32 rows): ``cosine_topk``, so kernel 4
  unmasked with k <= 128, the chunked matmul masked (the single-device
  masked route);
- :func:`sharded_topk_int8`: kernel 3 (``topk_int8``) unmasked with
  k <= 128, else kernel 1's scores plus the mask (``topk_int8_scores``);
  the caller rescores on the host;
- :func:`sharded_topk_int8_rerank`: an int8 shortlist of min(max(512, k),
  rps) rows (kernel 1 for one query, kernel 2 for a batch), rescored
  exactly against the shard's own rows with the bf16-rounded query;
- :func:`sharded_binary_topk` / :func:`sharded_binary_topk_grouped`:
  kernels 6 / 7, kernel 5 under a mask; integer scores merged by
  ``_merge_int_candidates``;
- :func:`sharded_binary_shortlist`: kernel 5 plus the exact top-m.

Invalid slots come back as (-inf, INT32_MAX), binary ones as (INT32_MIN,
INT32_MAX). Binary rows stay (N, W) word rows: tpuclip's grouped layout is
the TPU's tiling, so its ``shard_words_grouped`` here returns tile-aligned
row blocks, the same layout :func:`sharded_binary_topk` takes.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from tpuclip_torch.ops.hamming import (
    BINARY_TILE_N,
    _merge_int_candidates,
    binary_shortlist_q1,
    binary_topk,
    binary_topk_masked,
)
from tpuclip_torch.ops.topk import DEFAULT_TILE_N, cosine_topk
from tpuclip_torch.ops.topk_int8 import (
    PACKED_TILE_N,
    _final_merge,
    rerank_at_depth,
    topk_int8,
    topk_int8_scores,
)
from tpuclip_torch.parallel.mesh import DATA_AXIS, Mesh

_NEG_INF = float("-inf")
_INT32_MIN = -(2**31)
_INT32_MAX = 2**31 - 1

ArrayLike = Union[torch.Tensor, np.ndarray]


class ShardedTensor:
    """This process's row shards of one (N_pad, ...) array: ``shards[j]``
    holds global shard ``mesh.shard_index(j)``'s ``rows_per_shard`` rows,
    on ``mesh.data_devices[j]``. ``shape`` is the global shape."""

    def __init__(self, shards: List[torch.Tensor], rows_per_shard: int, mesh: Mesh):
        self.shards = shards
        self.rows_per_shard = rows_per_shard
        self.mesh = mesh

    @property
    def shape(self) -> torch.Size:
        rest = self.shards[0].shape[1:]
        return torch.Size((self.rows_per_shard * self.mesh.shape[DATA_AXIS], *rest))

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def offset(self, j: int) -> int:
        """The global row of local shard ``j``'s first row."""
        return self.mesh.shard_index(j) * self.rows_per_shard

    def nbytes(self) -> int:
        """Bytes of this process's shards."""
        return sum(t.numel() * t.element_size() for t in self.shards)


def _pad_rows(rows: ArrayLike, total: int) -> Tuple[ArrayLike, int]:
    n = rows.shape[0]
    rem = total - n
    if rem > 0:
        if torch.is_tensor(rows):
            rows = torch.cat([rows, rows.new_zeros((rem, *rows.shape[1:]))])
        else:
            rows = np.concatenate([rows, np.zeros((rem, *rows.shape[1:]), rows.dtype)])
    return rows, n


def pad_for_mesh(rows: ArrayLike, mesh: Mesh, tile: int = 1) -> Tuple[ArrayLike, int]:
    """Zero rows appended up to a multiple of the data-axis size times
    ``tile`` (the kernel tile, so every shard is tile-aligned); returns
    (padded, N). tpuclip pads the columns of its feature-major matrix."""
    unit = mesh.shape[DATA_AXIS] * tile
    return _pad_rows(rows, -(-rows.shape[0] // unit) * unit)


def shard_matrix(rows: ArrayLike, mesh: Mesh, dtype: Optional[torch.dtype] = None) -> ShardedTensor:
    """(N_pad, ...) rows (N_pad a multiple of the data-axis size) → this
    process's shards, each on its device (in ``dtype`` if given). A shard
    already on its device is a view, not a copy."""
    ndev = mesh.shape[DATA_AXIS]
    if rows.shape[0] % ndev:
        raise ValueError(f"{rows.shape[0]} rows do not divide over {ndev} shards; pad_for_mesh first")
    rps = rows.shape[0] // ndev
    t = rows if torch.is_tensor(rows) else torch.from_numpy(np.ascontiguousarray(rows))
    shards = []
    for j, dev in enumerate(mesh.data_devices):
        s = mesh.shard_index(j)
        shards.append(t[s * rps : (s + 1) * rps].to(device=dev, dtype=dtype or t.dtype))
    return ShardedTensor(shards, rps, mesh)


def _as_sharded(x, mesh: Mesh) -> ShardedTensor:
    return x if isinstance(x, ShardedTensor) else shard_matrix(x, mesh)


def _local_slice(x, lo: int, hi: int, device: torch.device) -> Optional[torch.Tensor]:
    """Rows [lo, hi) of a replicated or global-width array, on ``device``."""
    if x is None:
        return None
    t = x if torch.is_tensor(x) else torch.from_numpy(np.ascontiguousarray(x))
    return t.reshape(-1)[lo:hi].to(device)


def _to(x, device: torch.device):
    return x.to(device) if torch.is_tensor(x) else x


def _local_n_valid(n_valid: int, offset: int, rps: int) -> int:
    return min(max(int(n_valid) - offset, 0), rps)


# =============================================================================
# The cross-shard merge
# =============================================================================


def _pad_local_candidates(s: torch.Tensor, i: torch.Tensor, k_eff: int, sentinel):
    """A shard's (Q, <= k_eff) candidates padded to k_eff columns with
    (``sentinel``, INT32_MAX): a shard with fewer rows than k (or none
    valid) returns fewer, and the merge takes k_eff from each."""
    pad = k_eff - s.shape[1]
    if pad > 0:
        s = torch.cat([s, s.new_full((s.shape[0], pad), sentinel)], dim=1)
        i = torch.cat([i, i.new_full((i.shape[0], pad), _INT32_MAX)], dim=1)
    return s, i


def _all_gather_columns(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """(Q, c) on the lead device → (Q, world * c), rank-major, from every
    process of the mesh's group. gloo gathers host tensors only."""
    on_host = dist.get_backend(mesh.group) != "nccl"
    t = (x.cpu() if on_host else x).contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.world_size)]
    dist.all_gather(parts, t, group=mesh.group)
    return torch.cat(parts, dim=1).to(x.device)


def _gather_candidates(mesh: Mesh, parts, k_eff: int, sentinel):
    """Every shard's candidates, padded to k_eff, as (Q, ndev * k_eff)
    scores and int64 global rows on the lead device."""
    padded = [_pad_local_candidates(s, i.long(), k_eff, sentinel) for s, i in parts]
    s = torch.cat([p[0].to(mesh.lead) for p in padded], dim=1)
    i = torch.cat([p[1].to(mesh.lead) for p in padded], dim=1)
    if mesh.group is not None:
        s, i = _all_gather_columns(mesh, s), _all_gather_columns(mesh, i)
    return s, i


def _merge_shard_candidates(parts, mesh: Mesh, k_eff: int):
    """Float candidates of every shard → the global top-``k_eff`` ordered
    (score desc, row asc): tpuclip's ``lax.top_k`` + lexsort merge."""
    s, i = _gather_candidates(mesh, parts, k_eff, _NEG_INF)
    s, i = _final_merge(s, i, k_eff)
    return s, i.masked_fill(torch.isneginf(s), _INT32_MAX)


def _merge_int_shards(parts, mesh: Mesh, k_eff: int):
    """Integer (binary) candidates → the global top-``k_eff``: popcount
    scores tie heavily across shards, so the exact (score desc, row asc)
    merge of ``_merge_int_candidates``."""
    s, i = _gather_candidates(mesh, parts, k_eff, _INT32_MIN)
    return _merge_int_candidates(s, i, k_eff)


def _empty(q_count: int, device, dtype=torch.float32):
    return (torch.zeros((q_count, 0), dtype=dtype, device=device),
            torch.zeros((q_count, 0), dtype=torch.int64, device=device))


def _invalid_to_max(s: torch.Tensor, i: torch.Tensor, offset: int, invalid: torch.Tensor):
    return s, torch.where(invalid, torch.full_like(i, _INT32_MAX), i.long() + offset)


# =============================================================================
# Dense searches
# =============================================================================


def sharded_topk(
    queries: torch.Tensor,
    matrix,
    k: int,
    mesh: Mesh,
    n_valid: int,
    mask: Optional[ArrayLike] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distributed top-k over row-sharded bf16 / fp32 rows: ``queries`` (Q,
    D) replicated, ``matrix`` a :class:`ShardedTensor` (or an (N_pad, D)
    array to shard), the optional additive 0/-inf ``mask`` over the padded
    width (folder filters). Returns ((Q, k) f32, (Q, k) int64 global rows)
    on the lead device, equal to a single-device search over the rows."""
    matrix = _as_sharded(matrix, mesh)
    rps = matrix.rows_per_shard
    k_eff = min(k, matrix.shape[0])
    parts = []
    for j, (dev, shard) in enumerate(zip(mesh.data_devices, matrix.shards)):
        base = matrix.offset(j)
        nv = _local_n_valid(n_valid, base, rps)
        if nv == 0:
            parts.append(_empty(queries.shape[0], dev))
            continue
        s, i = cosine_topk(queries.to(dev), shard, min(k_eff, rps), nv,
                           mask=_local_slice(mask, base, base + rps, dev))
        parts.append(_invalid_to_max(s, i, base, torch.isneginf(s)))
    return _merge_shard_candidates(parts, mesh, k_eff)


def _kernel3_fits(rps: int) -> bool:
    """kernel 3 scans tiles of min(2048, rps) rows, a multiple of 16."""
    tile = min(PACKED_TILE_N, rps)
    return tile % 16 == 0 and rps % tile == 0


def _extract_fits(rps: int, k_eff: int, m: int) -> bool:
    """kernel 2's packed keys take tiles of min(2048, rps) rows, a multiple
    of 32 that holds a 128-key selection, and its per-tile keys must hold
    the shortlist's ``m`` rows (a shard of few tiles takes kernel 1)."""
    tile = min(PACKED_TILE_N, rps)
    if tile % 32 or tile < 128 or rps % tile:
        return False
    tiles = rps // tile
    return tiles * min(128, max(4 * k_eff, 2 * -(-m // tiles))) >= m


def sharded_topk_int8(
    q_int8: torch.Tensor,
    matrix_int8,
    scales,
    q_scale: Union[float, torch.Tensor],
    k: int,
    mesh: Mesh,
    n_valid: int,
    mask: Optional[ArrayLike] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distributed int8 top-k: the int8 rows and their (N_pad,) scales
    row-sharded alike, the int8 queries replicated, ``q_scale`` a float or
    (Q, 1) per-query scales. Unmasked with k <= 128 each shard runs kernel 3
    (``topk_int8``), otherwise kernel 1's scores plus the mask; the scores
    times ``q_scale``, as the single-device routes. Pair with the host
    rescore (``DeviceIndex._exact_rerank_batch``)."""
    matrix_int8, scales = _as_sharded(matrix_int8, mesh), _as_sharded(scales, mesh)
    rps = matrix_int8.rows_per_shard
    k_eff = min(k, matrix_int8.shape[0])
    parts = []
    for j, dev in enumerate(mesh.data_devices):
        base = matrix_int8.offset(j)
        nv = _local_n_valid(n_valid, base, rps)
        if nv == 0:
            parts.append(_empty(q_int8.shape[0], dev))
            continue
        k_local = min(k_eff, rps)
        qi, qs = q_int8.to(dev), _to(q_scale, dev)
        m_j, sc_j = matrix_int8.shards[j], scales.shards[j]
        if mask is None and k_local <= 128 and _kernel3_fits(rps):
            s, i = topk_int8(qi, m_j, sc_j, qs, k_local, nv)
        else:
            s, i = topk_int8_scores(qi, m_j, sc_j, qs, k_local, nv, _local_slice(mask, base, base + rps, dev))
        parts.append(_invalid_to_max(s, i, base, torch.isneginf(s)))
    return _merge_shard_candidates(parts, mesh, k_eff)


def sharded_topk_int8_rerank(
    q_f32: torch.Tensor,
    matrix_int8,
    scales,
    rows_full,
    k: int,
    mesh: Mesh,
    n_valid: int,
    shortlist: int = 512,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distributed int8 scan + exact rescore (the mesh form of
    ``topk_int8_rerank_fused``): the int8 rows, their scales and the
    storage-dtype ``rows_full`` row-sharded alike, the fp32 queries
    replicated. Each shard takes a shortlist of min(max(shortlist, k), rps)
    rows (kernel 1 for one query, kernel 2 for a batch, whatever
    ``TPUCLIP_SHORTLIST`` says: tpuclip's mesh rerank ignores it too),
    rescores it against its own rows and keeps its exact top-k; the merge
    of the per-shard exact top-ks is the global exact top-k. Scores are the
    exact full-precision dots."""
    matrix_int8 = _as_sharded(matrix_int8, mesh)
    scales, rows_full = _as_sharded(scales, mesh), _as_sharded(rows_full, mesh)
    rps = matrix_int8.rows_per_shard
    k_eff = min(k, matrix_int8.shape[0])
    m_local = min(max(shortlist, k_eff), rps)
    method = "exact" if q_f32.shape[0] == 1 else "extract"
    if method == "extract" and not _extract_fits(rps, min(k_eff, m_local), m_local):
        method = "exact"
    parts = []
    for j, dev in enumerate(mesh.data_devices):
        base = matrix_int8.offset(j)
        nv = _local_n_valid(n_valid, base, rps)
        if nv == 0:
            parts.append(_empty(q_f32.shape[0], dev))
            continue
        s, i = rerank_at_depth(
            q_f32.to(dev), matrix_int8.shards[j], scales.shards[j], rows_full.shards[j],
            min(k_eff, m_local), m_local, nv, method,
        )
        parts.append(_invalid_to_max(s, i, base, torch.isneginf(s)))
    return _merge_shard_candidates(parts, mesh, k_eff)


# =============================================================================
# Binary searches
# =============================================================================


def _binary_shards(query_words, words: ShardedTensor, k_eff, mesh, n_valid, mask):
    rps = words.rows_per_shard
    parts = []
    for j, dev in enumerate(mesh.data_devices):
        base = words.offset(j)
        nv = _local_n_valid(n_valid, base, rps)
        if nv == 0:
            parts.append(_empty(query_words.shape[0], dev, torch.int32))
            continue
        qw, k_local = query_words.to(dev), min(k_eff, rps)
        if mask is None:
            s, i = binary_topk(qw, words.shards[j], k_local, nv)
        else:
            s, i = binary_topk_masked(qw, words.shards[j], k_local, nv,
                                      _local_slice(mask, base, base + rps, dev))
        parts.append(_invalid_to_max(s, i, base, s <= _INT32_MIN))
    return _merge_int_shards(parts, mesh, k_eff)


def sharded_binary_topk(
    query_words: torch.Tensor,
    matrix_words,
    k: int,
    mesh: Mesh,
    n_valid: int,
    mask: Optional[ArrayLike] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distributed packed-binary top-k: (N_pad, W) int32 / uint32 words
    row-sharded; each shard runs kernel 6 (one query) or 7 (a batch), or
    kernel 5 under the folder ``mask``. Returns ((Q, k) int32 matches, (Q,
    k) int64 global rows), integer-exact (matches desc, row asc), padded and
    masked rows as (INT32_MIN, INT32_MAX)."""
    words = _as_sharded(matrix_words, mesh)
    return _binary_shards(query_words, words, min(k, words.shape[0]), mesh, n_valid, mask)


def shard_words_grouped(words: ArrayLike, mesh: Mesh, tile_n: Optional[int] = None):
    """Host (N, W) packed words → this process's (rps, W) row blocks, rps
    tile-aligned (``BINARY_TILE_N`` by default): block ``s`` holds rows
    [s * rps, (s + 1) * rps), zero rows past N. Returns (ShardedTensor, rps,
    N); a row's global id is s * rps + its row in the block. tpuclip
    uploads TPU-grouped (W, 8, rps/8) blocks here; the port's kernels read
    word rows."""
    tile_n = tile_n or BINARY_TILE_N
    n = words.shape[0]
    ndev = mesh.shape[DATA_AXIS]
    rps = -(-max(-(-n // ndev), 1) // tile_n) * tile_n
    padded, _ = _pad_rows(words, ndev * rps)
    return shard_matrix(padded, mesh), rps, n


def sharded_binary_topk_grouped(
    query_words: torch.Tensor,
    grouped: ShardedTensor,
    k: int,
    mesh: Mesh,
    n_valid: int,
    shard_rows: int,
    mask: Optional[ArrayLike] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`sharded_binary_topk` over :func:`shard_words_grouped`'s blocks
    (the mesh cascade's resident rows): exact, ``mask`` over the global
    padded width ndev * shard_rows."""
    if grouped.rows_per_shard != shard_rows:
        raise ValueError(f"blocks of {grouped.rows_per_shard} rows, shard_rows {shard_rows}")
    return _binary_shards(query_words, grouped, min(k, grouped.shape[0]), mesh, n_valid, mask)


def sharded_binary_shortlist(
    query_words: torch.Tensor,
    grouped: ShardedTensor,
    m: int,
    mesh: Mesh,
    n_valid: int,
    shard_rows: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mesh cascade prefilter of one unmasked query: each shard runs kernel
    5 and the exact top-min(m, shard_rows) (``binary_shortlist_q1``), and
    the merge keeps the global top-m: ((1, m_eff) f32 match counts, (1,
    m_eff) int64 global rows) ordered (score desc, row asc), invalid lanes
    (-inf, INT32_MAX). tpuclip's shortlist is approximate (the TPU's
    ``approx_max_k``); this one holds every row it can."""
    if grouped.rows_per_shard != shard_rows:
        raise ValueError(f"blocks of {grouped.rows_per_shard} rows, shard_rows {shard_rows}")
    m_eff = min(m, grouped.shape[0])
    parts = []
    for j, dev in enumerate(mesh.data_devices):
        base = grouped.offset(j)
        nv = _local_n_valid(n_valid, base, shard_rows)
        if nv == 0:
            parts.append(_empty(query_words.shape[0], dev))
            continue
        s, i = binary_shortlist_q1(query_words.to(dev), grouped.shards[j], min(m_eff, shard_rows), nv)
        parts.append(_invalid_to_max(s, i, base, torch.isneginf(s)))
    return _merge_shard_candidates(parts, mesh, m_eff)


class ShardedIndex:
    """Convenience wrapper: host (N, D) rows → a mesh-resident row-sharded
    index (padded to the data axis times kernel 4's tile)."""

    def __init__(self, matrix: ArrayLike, mesh: Mesh, dtype: torch.dtype = torch.bfloat16):
        rows = torch.as_tensor(np.asarray(matrix, np.float32))
        padded, n = pad_for_mesh(rows, mesh, DEFAULT_TILE_N)
        self.mesh = mesh
        self.n_valid = n
        self.matrix = shard_matrix(padded, mesh, dtype)

    def search(self, queries: ArrayLike, k: int, mask: Optional[ArrayLike] = None):
        q = torch.as_tensor(np.asarray(queries, np.float32)).to(self.mesh.lead)
        return sharded_topk(q, self.matrix, k, self.mesh, self.n_valid, mask=mask)
