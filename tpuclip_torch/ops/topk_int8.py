"""int8 quantized search with an exact rescore (PyTorch port).

Port of the main-path pieces of ``tpuclip/ops/topk_int8.py``. The database
rows are quantized to symmetric per-row int8 (unit-norm rows, so scales
are near-uniform); a query's int8 dots against the int8 matrix build a
shortlist, and the shortlisted rows are rescored exactly against the
resident full-precision (bf16 on CUDA) rows. Results are ordered
(score desc, row asc).

Three kernels sit behind this module, in ``tpuclip_torch/csrc/int8_scan.cu``:

- :func:`int8_scores` — kernel 1, the full (Q, N) f32 score matrix
  (replaces ``_int8_scores_kernel``); the single-query ``exact`` shortlist,
  the ``approx`` and ``verified`` shortlists, and the masked and batch
  routes without the resident rows (:func:`topk_int8_scores`);
- :func:`int8_candidates_packed` — kernel 2, per-tile top-``k_tile`` packed
  keys (replaces ``_int8_packed_kernel``); the batch ``extract`` shortlist;
- :func:`int8_candidates` — kernel 3, per-tile top-``k_tile`` exact (score,
  row) pairs (replaces ``_int8_topk_kernel``); one unmasked query without
  the resident rows (:func:`topk_int8`).

The ``approx`` and ``verified`` shortlists select from kernel 1's scores with
:func:`approx_max_k`, the counterpart of ``lax.approx_max_k`` (XLA's
PartialReduce on the TPU): plain PyTorch, since tpuclip has it from XLA and
not from a Pallas kernel. ``verified`` adds tpuclip's count proof
(:func:`_verified_shortlist`) and, in :func:`topk_int8_rerank_fused_auto`
and the index, an exact selection over the resident scores when the proof
fails.

Without the resident rows the int8 matrix comes from the fp32 originals
(:func:`quantize_matrix`) and one query is quantized on the host
(:func:`quantize_query`), as tpuclip does.

:func:`query_topk_fused` puts the towers in front of
:func:`topk_int8_rerank_fused`: tpuclip's fused query programs, which the
index runs as CUDA graphs (``tpuclip_torch.ops.graphs``).

Each wrapper dispatches on its tensors' device: CPU tensors go to the plain
PyTorch version beside it (same signature, same bits); CUDA tensors go to
the kernel, which runs or raises. Each wrapper counts its kernel launches
in a plain integer attribute (``int8_scores.launches``).

Layout: the int8 matrix is row-major (N_pad, D) — the JAX package keeps it
feature-major (D, N_pad) for the TPU's MXU. Results do not depend on it.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from tpuclip_torch.ops._counters import counted

_NEG_INF = float("-inf")
_INT32_MIN = -(2**31)
_INT32_MAX = 2**31 - 1

# Row padding unit of the int8 matrix (as tpuclip's INT8_TILE_N).
INT8_TILE_N = 6144
# Tile width of the batch (extract) shortlist: per-tile top-k_tile keys.
# Divides INT8_TILE_N; a block of kernels 2 and 3 holds up to 16 queries x
# 2048 keys (128 KB) in shared memory.
PACKED_TILE_N = 2048

# Packed keys carry the tile-local lane in their low 13 bits (tiles <= 8192).
_IDX_BITS = 13
_IDX_MASK = (1 << _IDX_BITS) - 1
# Largest key a masked (-inf) lane can produce (tpuclip's _NEGINF_KEY_MAX):
# "key <= this" marks an invalid candidate.
_NEGINF_KEY_MAX = -2139095041  # int32(0x807FFFFF)

# Scales are max|x| * float32(1/127): XLA rewrites tpuclip's jitted
# ``max / 127.0`` into this multiply, and the port matches it bit for bit.
_INV_127 = 1.0 / 127.0

_CHUNK_ROWS = 65536  # bounds the transient memory of the chunked plain passes


def _u32(x: torch.Tensor) -> torch.Tensor:
    """float32/int32 tensor → its 32 bits as non-negative int64."""
    return x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _i32_from_u32(u: torch.Tensor) -> torch.Tensor:
    """Non-negative int64 < 2**32 → the int32 with those bits."""
    return torch.where(u >= 2**31, u - 2**32, u).to(torch.int32)


def order_keys(scores: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Unique int64 keys ordering (score desc, row asc): the f32 score's
    monotonic bits above the inverted row (rows in [0, 2**32)). -0.0 counts
    as +0.0."""
    u = _u32(scores.float() + 0.0)
    mono = u ^ torch.where((u >> 31) == 1, 0xFFFFFFFF, 0x80000000)
    return (mono - 2**31) * 2**32 + (0xFFFFFFFF - rows.long())


def _final_merge(scores: torch.Tensor, idx: torch.Tensor, k_eff: int):
    """Merge per-tile candidates: the exact top-``k_eff`` ordered (score
    desc, idx asc). ``idx`` must be unique per query row."""
    pos = torch.topk(order_keys(scores, idx), k_eff, dim=1).indices
    return scores.gather(1, pos), idx.long().gather(1, pos)


def round_f32_to_bf16_bits(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to the nearest bfloat16 (half to even) with integer bit
    ops, returned AS float32 (tpuclip's ``round_f32_to_bf16_bits``).
    Finite inputs only."""
    u = _u32(x.float())
    lsb = (u >> 16) & 1
    u = (u + 0x7FFF + lsb) & 0xFFFF0000
    return _i32_from_u32(u).view(torch.float32)


def _to_int8(x: torch.Tensor, scale: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 of f32 rows ``x`` by their (..., 1) ``scale`` (1.0
    where a row is all zero): ((..., D) int8, the scales used)."""
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8), scale


def quantize_queries(q_f32: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8: (Q, D) f32 → ((Q, D) int8, (Q, 1) f32 scales).
    The scale is rank-invariant, so shortlist-only callers may drop it.
    This is the jitted form (tpuclip's ``quantize_queries_device``), which
    the batch routes use; one query outside the fused search takes
    :func:`quantize_query`."""
    q = q_f32.float()
    return _to_int8(q, q.abs().amax(dim=1, keepdim=True) * _INV_127)


def quantize_query(q: np.ndarray) -> Tuple[torch.Tensor, float]:
    """Host int8 quantization of one query, tpuclip's numpy
    ``quantize_query``: scale = max|q| / 127 and q / scale, both true f32
    divisions (the jitted form multiplies by f32(1/127) and differs in the
    last bit of some scales), rint, clip, scale 1.0 for a zero query.
    Returns ((1, D) int8 CPU tensor, scale)."""
    q = np.asarray(q, np.float32).reshape(1, -1)
    scale = float(np.float32(np.abs(q).max()) / np.float32(127.0)) or 1.0
    qi = np.clip(np.rint(q / np.float32(scale)), -127, 127).astype(np.int8)
    return torch.from_numpy(qi), scale


def quantize_matrix(vectors, n_pad: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, D) fp32 host rows (the memmap) → ((n_pad, D) int8, (n_pad,) f32
    scales) on ``device``, bit-equal to tpuclip's ``quantize_matrix_t`` up
    to the transpose: per row, scale = max|x| / 127 (1.0 for a zero row)
    and round(x / scale), both true divisions; zero rows / unit scales past
    N. The rows go up in chunks and none stays resident."""
    n, d = vectors.shape
    m = torch.zeros((n_pad, d), dtype=torch.int8, device=device)
    scales = torch.ones((n_pad,), dtype=torch.float32, device=device)
    for s in range(0, n, _CHUNK_ROWS):
        mf = torch.from_numpy(np.array(vectors[s : s + _CHUNK_ROWS], np.float32)).to(device)
        top = mf.abs().amax(dim=1, keepdim=True)
        # Tensor divisors throughout: CUDA's div by a Python number
        # multiplies by its reciprocal, which is not a true division.
        m[s : s + len(mf)], sc = _to_int8(mf, top / torch.full_like(top, 127.0))
        scales[s : s + len(mf)] = sc[:, 0]
    return m, scales


def derive_int8_matrix(rows: torch.Tensor, n_pad: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, D) bf16/f32 rows → ((n_pad, D) int8, (n_pad,) f32 scales) on the
    rows' device: per-row symmetric quantization of the storage-dtype rows,
    zero rows / unit scales past N (tpuclip's ``derive_int8_matrix_device``,
    row-major)."""
    n, d = rows.shape
    m = torch.zeros((n_pad, d), dtype=torch.int8, device=rows.device)
    scales = torch.ones((n_pad,), dtype=torch.float32, device=rows.device)
    for s in range(0, n, _CHUNK_ROWS):
        mf = rows[s : s + _CHUNK_ROWS].float()
        m[s : s + len(mf)], sc = _to_int8(mf, mf.abs().amax(dim=1, keepdim=True) * _INV_127)
        scales[s : s + len(mf)] = sc[:, 0]
    return m, scales


# =============================================================================
# Kernel 1: int8 scores
# =============================================================================


def _check_scan_args(q_int8, m_int8, scales, n_valid) -> None:
    if q_int8.dtype != torch.int8 or m_int8.dtype != torch.int8:
        raise TypeError(f"int8 queries and matrix required, got {q_int8.dtype}, {m_int8.dtype}")
    if scales.dtype != torch.float32:
        raise TypeError(f"float32 scales required, got {scales.dtype}")
    if q_int8.dim() != 2 or m_int8.dim() != 2 or q_int8.shape[1] != m_int8.shape[1]:
        raise ValueError(f"shapes (Q, D) and (N, D) required, got {tuple(q_int8.shape)}, {tuple(m_int8.shape)}")
    if scales.shape != (m_int8.shape[0],):
        raise ValueError(f"scales must be ({m_int8.shape[0]},), got {tuple(scales.shape)}")
    if not 0 <= int(n_valid) <= m_int8.shape[0]:
        raise ValueError(f"n_valid {n_valid} outside [0, {m_int8.shape[0]}]")
    if not (q_int8.device == m_int8.device == scales.device):
        raise ValueError("queries, matrix and scales must share one device")


def _check_cuda_args(*tensors: torch.Tensor, dim: int) -> None:
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError("the CUDA kernels take 16-byte aligned tensors")
    if dim % 16:
        raise ValueError(f"the CUDA kernels take D % 16 == 0, got {dim}")


def _int8_scores_plain(q_int8, m_int8, scales, n_valid, out=None) -> torch.Tensor:
    """Plain version of :func:`int8_scores`: the int32 dot through float64
    (exact: |dot| < 2**25), rounded to f32 and scaled as the kernel does."""
    n = m_int8.shape[0]
    if out is None:
        out = torch.empty((q_int8.shape[0], n), dtype=torch.float32, device=q_int8.device)
    qd = q_int8.to(torch.float64)
    for s in range(0, n, _CHUNK_ROWS):
        acc = qd @ m_int8[s : s + _CHUNK_ROWS].to(torch.float64).T
        out[:, s : s + acc.shape[1]] = acc.to(torch.float32) * scales[s : s + acc.shape[1]]
    out[:, int(n_valid):] = _NEG_INF
    return out


@counted
def int8_scores(
    q_int8: torch.Tensor,
    m_int8: torch.Tensor,
    scales: torch.Tensor,
    n_valid: int,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(Q, D) int8 queries x (N_pad, D) int8 rows → (Q, N_pad) f32 scores
    ``float(int32 dot) * scales[n]``, -inf for ``n >= n_valid``. ``out``, a
    contiguous (Q, N_pad) f32 tensor on the queries' device, receives them
    in place of a new tensor (the index's resident scores buffer)."""
    _check_scan_args(q_int8, m_int8, scales, n_valid)
    q_count, d = q_int8.shape
    n = m_int8.shape[0]
    if out is not None and (
        out.shape != (q_count, n) or out.dtype != torch.float32
        or out.device != q_int8.device or not out.is_contiguous()
    ):
        raise ValueError(f"out must be a contiguous ({q_count}, {n}) float32 tensor on {q_int8.device}")
    if q_int8.device.type == "cpu":
        return _int8_scores_plain(q_int8, m_int8, scales, n_valid, out)
    if q_int8.device.type != "cuda":
        raise ValueError(f"unsupported device {q_int8.device}")
    from tpuclip_torch.ops._build import library

    _check_cuda_args(q_int8, m_int8, scales, dim=d)
    if out is None:
        out = torch.empty((q_count, n), dtype=torch.float32, device=q_int8.device)
    if q_count == 0 or n == 0:
        return out
    with torch.cuda.device(q_int8.device):
        rc = library().tpuclip_int8_scores(
            q_int8.data_ptr(), m_int8.data_ptr(), scales.data_ptr(), out.data_ptr(),
            q_count, n, d, int(n_valid), torch.cuda.current_stream(q_int8.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"int8_scores kernel launch failed: cudaError {rc}")
    int8_scores.launches += 1
    return out


# =============================================================================
# Kernel 2: per-tile packed-key candidates
# =============================================================================


def _pack_keys(scores: torch.Tensor, tile: int) -> torch.Tensor:
    """(Q, N) f32 scores → monotonic int32 keys (as int64 values) carrying
    the tile-local lane, bit for bit tpuclip's ``_pack_keys``."""
    u = _u32(scores)
    u = u ^ torch.where((u >> 31) == 1, 0xFFFFFFFF, 0x80000000)
    lane = torch.arange(scores.shape[1], device=scores.device) % tile & _IDX_MASK
    key = (u & (0xFFFFFFFF & ~_IDX_MASK)) | (_IDX_MASK - lane)
    key = key ^ 0x80000000
    return torch.where(key >= 2**31, key - 2**32, key)


def _int8_candidates_packed_plain(q_int8, m_int8, scales, k_tile, n_valid, tile) -> torch.Tensor:
    """Plain version of :func:`int8_candidates_packed`: int64 key
    arithmetic, then ``torch.topk`` per tile (keys are unique in a tile)."""
    q_count, n = q_int8.shape[0], m_int8.shape[0]
    tiles = n // tile
    k_pad = -(-k_tile // 128) * 128
    keys = _pack_keys(_int8_scores_plain(q_int8, m_int8, scales, n_valid), tile)
    top = torch.topk(keys.view(q_count, tiles, tile), k_tile, dim=-1).values
    out = torch.full((q_count, tiles, k_pad), _INT32_MIN, dtype=torch.int32, device=q_int8.device)
    out[:, :, :k_tile] = top.to(torch.int32)
    return out.view(q_count, tiles * k_pad)


@counted
def int8_candidates_packed(
    q_int8: torch.Tensor,
    m_int8: torch.Tensor,
    scales: torch.Tensor,
    k_tile: int,
    n_valid: int,
    tile: int,
) -> torch.Tensor:
    """Per-tile top-``k_tile`` packed keys, (Q, tiles * k_pad) int32 with
    k_pad = k_tile rounded up to 128 and INT32_MIN padding. The scores are
    :func:`int8_scores`'; a key is the score's order-preserving bits with
    the low 13 bits replaced by ``8191 - lane`` (ties to the lowest lane).
    Callers recover rows as ``pos // k_pad * tile + 8191 - (key & 8191)``."""
    _check_scan_args(q_int8, m_int8, scales, n_valid)
    n = m_int8.shape[0]
    if not (0 < tile <= _IDX_MASK + 1 and tile % 32 == 0 and n % tile == 0):
        raise ValueError(f"tile must divide N={n}, be a multiple of 32 and <= 8192, got {tile}")
    if not 1 <= k_tile <= tile:
        raise ValueError(f"k_tile must be in [1, {tile}], got {k_tile}")
    if q_int8.device.type == "cpu":
        return _int8_candidates_packed_plain(q_int8, m_int8, scales, k_tile, n_valid, tile)
    if q_int8.device.type != "cuda":
        raise ValueError(f"unsupported device {q_int8.device}")
    from tpuclip_torch.ops._build import library

    q_count, d = q_int8.shape
    _check_cuda_args(q_int8, m_int8, scales, dim=d)
    k_pad = -(-k_tile // 128) * 128
    out = torch.empty((q_count, (n // tile) * k_pad), dtype=torch.int32, device=q_int8.device)
    if q_count == 0:
        return out
    with torch.cuda.device(q_int8.device):
        rc = library().tpuclip_int8_candidates_packed(
            q_int8.data_ptr(), m_int8.data_ptr(), scales.data_ptr(), out.data_ptr(),
            q_count, n, d, int(n_valid), tile, k_tile, k_pad,
            torch.cuda.current_stream(q_int8.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"int8_candidates_packed kernel launch failed: cudaError {rc}")
    int8_candidates_packed.launches += 1
    return out


# =============================================================================
# Kernel 3: per-tile top-k (score, row) candidates
# =============================================================================


def _int8_candidates_plain(q_int8, m_int8, scales, k_tile, n_valid, tile):
    """Plain version of :func:`int8_candidates`: kernel 1's exact scores
    (:func:`_int8_scores_plain`), then each tile's exact top-``k_tile`` by
    unique keys (score desc, row asc)."""
    q_count, n = q_int8.shape[0], m_int8.shape[0]
    tiles = n // tile
    k_pad = -(-k_tile // 128) * 128
    scores = _int8_scores_plain(q_int8, m_int8, scales, n_valid).view(q_count, tiles, tile)
    rows = torch.arange(n, device=q_int8.device).view(1, tiles, tile).expand(q_count, -1, -1)
    pos = torch.topk(order_keys(scores, rows), k_tile, dim=-1).indices
    out_s = torch.full((q_count, tiles, k_pad), _NEG_INF, dtype=torch.float32, device=q_int8.device)
    out_i = torch.full((q_count, tiles, k_pad), _INT32_MAX, dtype=torch.int32, device=q_int8.device)
    out_s[..., :k_tile] = scores.gather(-1, pos)
    out_i[..., :k_tile] = rows.gather(-1, pos).to(torch.int32)
    return out_s.view(q_count, tiles * k_pad), out_i.view(q_count, tiles * k_pad)


@counted
def int8_candidates(
    q_int8: torch.Tensor,
    m_int8: torch.Tensor,
    scales: torch.Tensor,
    k_tile: int,
    n_valid: int,
    tile: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each ``tile``-row tile's top-``k_tile`` of :func:`int8_scores`' exact
    scores, ordered (score desc, row asc): ((Q, tiles * k_pad) f32 scores,
    (Q, tiles * k_pad) int32 global rows), k_pad = k_tile rounded up to
    128, (-inf, INT32_MAX) in the padding slots (tpuclip's
    ``_int8_candidates`` contract; rows past ``n_valid`` score -inf)."""
    _check_scan_args(q_int8, m_int8, scales, n_valid)
    n = m_int8.shape[0]
    if not (0 < tile and tile % 16 == 0 and n % tile == 0):
        raise ValueError(f"tile must divide N={n} and be a multiple of 16, got {tile}")
    if not 1 <= k_tile <= tile:
        raise ValueError(f"k_tile must be in [1, {tile}], got {k_tile}")
    if q_int8.device.type == "cpu":
        return _int8_candidates_plain(q_int8, m_int8, scales, k_tile, n_valid, tile)
    if q_int8.device.type != "cuda":
        raise ValueError(f"unsupported device {q_int8.device}")
    from tpuclip_torch.ops._build import library

    q_count, d = q_int8.shape
    _check_cuda_args(q_int8, m_int8, scales, dim=d)
    k_pad = -(-k_tile // 128) * 128
    width = (n // tile) * k_pad
    out_s = torch.empty((q_count, width), dtype=torch.float32, device=q_int8.device)
    out_i = torch.empty((q_count, width), dtype=torch.int32, device=q_int8.device)
    if q_count == 0 or n == 0:
        return out_s, out_i
    with torch.cuda.device(q_int8.device):
        rc = library().tpuclip_int8_candidates(
            q_int8.data_ptr(), m_int8.data_ptr(), scales.data_ptr(), out_s.data_ptr(),
            out_i.data_ptr(), q_count, n, d, int(n_valid), tile, k_tile, k_pad,
            torch.cuda.current_stream(q_int8.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"int8_candidates kernel launch failed: cudaError {rc}")
    int8_candidates.launches += 1
    return out_s, out_i


def _empty_topk(q_count: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    return (
        torch.zeros((q_count, 0), dtype=torch.float32, device=device),
        torch.zeros((q_count, 0), dtype=torch.int64, device=device),
    )


def topk_int8(
    q_int8: torch.Tensor,
    m_int8: torch.Tensor,
    scales: torch.Tensor,
    q_scale: Union[float, torch.Tensor],
    k: int,
    n_valid: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 top-k without a rescore (tpuclip's ``topk_int8_pallas``):
    kernel 3's per-tile candidates at k_tile = k, the exact merge, then the
    scores times ``q_scale``, last, as tpuclip rounds them. Returns ((Q, k)
    f32, (Q, k) int64 rows) ordered (score desc, row asc); slots with no
    valid row score -inf."""
    n = m_int8.shape[0]
    n_valid = n if n_valid is None else int(n_valid)
    k_eff = min(k, n)
    if k_eff <= 0:
        return _empty_topk(q_int8.shape[0], q_int8.device)
    s, i = int8_candidates(q_int8, m_int8, scales, k_eff, n_valid, min(PACKED_TILE_N, n))
    s, rows = _final_merge(s, i, k_eff)
    return s * q_scale, rows


def topk_int8_scores(
    q_int8: torch.Tensor,
    m_int8: torch.Tensor,
    scales: torch.Tensor,
    q_scale: Union[float, torch.Tensor],
    k: int,
    n_valid: Optional[int] = None,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 top-k from the full score matrix (tpuclip's ``topk_int8_xla`` and
    ``topk_int8_batch``): kernel 1's scores, plus the (N,) additive 0/-inf
    ``mask``, the exact top-k (score desc, row asc), then times ``q_scale``
    (a float, or (Q, 1) per-query scales). Any k; the masked and batch
    routes."""
    n = m_int8.shape[0]
    n_valid = n if n_valid is None else int(n_valid)
    k_eff = min(k, n)
    if k_eff <= 0:
        return _empty_topk(q_int8.shape[0], q_int8.device)
    scores = int8_scores(q_int8, m_int8, scales, n_valid)
    if mask is not None:
        scores = scores + mask[None, :]
    rows = torch.arange(n, device=scores.device).expand_as(scores)
    s, rows = _final_merge(scores, rows, k_eff)
    return s * q_scale, rows


# =============================================================================
# Shortlist → exact rescore → top-k
# =============================================================================


def _rescore_select(cand, cand_invalid, q_f32, rows_full, k_eff):
    """Exact rescore of a candidate shortlist + final (score desc, row asc)
    top-``k_eff`` (tpuclip's ``_rescore_select``).

    With bf16 rows the query is rounded to bf16 first, so every product is
    exact in f32 and the scores equal a bf16 scan's up to summation order.
    The dot is an elementwise product + row sum: identical rows get
    identical scores, so their order is decided by row id alone."""
    n_rows = rows_full.shape[0]
    cand = cand.long()
    q = q_f32.float()
    qr = round_f32_to_bf16_bits(q) if rows_full.dtype == torch.bfloat16 else q
    gathered = rows_full[cand.clamp(0, n_rows - 1)].float()  # (Q, M, D)
    exact = (gathered * qr[:, None, :]).sum(dim=-1)
    invalid = (cand < 0) | (cand >= n_rows) | cand_invalid
    exact = exact.masked_fill(invalid, _NEG_INF)
    sort_rows = cand.masked_fill(invalid, _INT32_MAX)
    # Sort by row, then stable-sort by score descending: (score desc, row asc).
    by_row = torch.argsort(sort_rows, dim=1, stable=True)
    exact, sort_rows = exact.gather(1, by_row), sort_rows.gather(1, by_row)
    order = torch.argsort(-exact, dim=1, stable=True)[:, :k_eff]
    return exact.gather(1, order), sort_rows.gather(1, order)


def topk_exact_from_scores(scores, q_f32, rows_full, k: int, m: int):
    """Exact top-``k`` from a materialized (Q, N) int8 score matrix: the
    exact top-``m`` shortlist (the strongest int8 shortlist), then the
    rescore. The ``exact`` method's tail, and the ``verified`` method's
    fallback over the scores its program kept resident."""
    k_eff = min(k, scores.shape[1])
    top_s, cand = torch.topk(scores, m, dim=1)
    return _rescore_select(cand, torch.isneginf(top_s), q_f32, rows_full, k_eff)


def fallback_shortlist_depth(k: int, n: int, shortlist: int = 512) -> int:
    """Shortlist depth of the proof-miss fallback over the resident (Q, n)
    scores: one definition for :func:`topk_int8_rerank_fused_auto` and the
    index's fused searches, as tpuclip's."""
    return min(max(shortlist, 4 * min(k, n)), n)


# =============================================================================
# The approximate top-k and its count proof
# =============================================================================

# lax.approx_max_k's default recall target, which the ``approx`` method takes.
APPROX_RECALL = 0.95
# XLA's lane tiling of a rank-2 ApproxTopK operand.
_LANE_TILING = 128


def approx_reduction_size(n: int, k: int, recall: float) -> Tuple[int, int]:
    """(L, r): the bin count and log2 of the bin size of XLA's ApproxTopK
    reduction of a rank-2 operand of width ``n`` to its top ``k`` at
    ``recall`` (taken as a float32, as XLA takes it). m0 = max((1 - k) /
    ln(recall), 128) capped at n and r = floor(log2(n // m0)); r = 0 keeps
    every column (L = n: exact), else r is capped at ceil(log2(n // 128))
    and L = ceil(ceil(n / 128) / 2**r) * 128. A top-1 folds to one tile."""
    if n <= _LANE_TILING:
        return n, 0
    tiles = -(-n // _LANE_TILING)
    if k == 1:
        return _LANE_TILING, (tiles - 1).bit_length()
    recall = float(np.float32(recall))
    if not 0.0 < recall <= 1.0:
        raise ValueError(f"recall must be in (0, 1], got {recall}")
    if recall == 1.0:
        return n, 0
    m0 = min(max(int((1.0 - k) / math.log(recall)), _LANE_TILING), n)
    r = (n // m0).bit_length() - 1
    if r == 0:
        return n, 0
    r = min(r, (n // _LANE_TILING - 1).bit_length())
    return -(-tiles // (1 << r)) * _LANE_TILING, r


def approx_max_k(scores: torch.Tensor, k: int, recall: float = APPROX_RECALL):
    """Approximate top-``k`` of each row of (Q, N) ``scores``, as
    ``lax.approx_max_k`` runs on the TPU: the columns fall into L bins
    (:func:`approx_reduction_size`), bin j holding columns j + i*L for
    i < 2**r (the fold by halves, -inf past N); each bin yields its winner,
    then the exact top-``k`` of the L winners. Both orders are (score desc,
    column asc) by :func:`order_keys`, so ties go to the lowest column on
    the CPU and on the card alike. Returns ((Q, k) f32 scores, (Q, k) int64
    columns) in that order; exact where L = N. Two of the true top-k in
    one bin cost the lower-ranked its place."""
    q, n = scores.shape
    bins, _ = approx_reduction_size(n, k, recall)
    if bins < k:  # a recall so low that the winners cannot fill k: select exactly
        bins = n
    if bins == n:
        keys = order_keys(scores, torch.arange(n, device=scores.device))
    else:
        width = -(-n // bins) * bins
        folded = torch.nn.functional.pad(scores, (0, width - n), value=_NEG_INF).view(q, -1, bins)
        keys = order_keys(folded, torch.arange(width, device=scores.device).view(1, -1, bins)).amax(dim=1)
    top = torch.topk(keys, k, dim=1).values
    rows = 0xFFFFFFFF - (top & 0xFFFFFFFF)
    return scores.gather(1, rows), rows


def _verified_shortlist(scores: torch.Tensor, m: int, verify_depth: int, recall: float):
    """:func:`approx_max_k`'s top-``m`` over the materialized scores, and a
    flag that proves its content (tpuclip's ``_verified_shortlist``). With
    t the J-th shortlist score (J = ``verify_depth``), per query

        ok ⟺ |{scores > t}| == |{shortlist > t}|
             ∧ |{scores == t}| == |{shortlist == t}|,  or t = -inf.

    When ok, the shortlist holds the true int8 top-J, ties included. ``ok``
    is one 0-d bool tensor for every query, left on the device: nothing in
    the program branches on it, so the program can be captured."""
    s_a, cand = approx_max_k(scores, m, recall)
    t = s_a[:, min(verify_depth, m) - 1, None]
    no_miss = (scores > t).sum(dim=1) == (s_a > t).sum(dim=1)
    no_straddle = (scores == t).sum(dim=1) == (s_a == t).sum(dim=1)
    ok = ((no_miss & no_straddle) | torch.isneginf(t[:, 0])).all()
    return s_a, cand, ok


SHORTLIST_METHODS = ("exact", "extract", "approx", "verified")


def _scores_fit(q_count: int, n: int) -> bool:
    """``TPUCLIP_SCORES_HBM_MB`` (default 1024): the largest (Q, N) f32
    score matrix, in MB, that ``approx`` and ``verified`` materialize; past
    it they take ``extract``. tpuclip's gate counts the rows the TPU pads Q
    to; the port's matrix has Q rows."""
    return q_count * n * 4 <= float(os.environ.get("TPUCLIP_SCORES_HBM_MB", "1024")) * 1e6


def resolve_shortlist_method(q_count: int) -> str:
    """Shortlist policy, overridable with ``TPUCLIP_SHORTLIST``: ``auto``
    gives a single query ``exact`` (kernel 1 + ``torch.topk``) and a batch
    ``extract`` (kernel 2); ``approx`` (kernel 1 + :func:`approx_max_k`)
    and ``verified`` (the same, proof-checked, with its fallback) serve any
    Q when set. tpuclip's ``auto`` gives one query ``verified`` on the
    TPU; the port keeps ``exact`` until a benchmark decides."""
    env = os.environ.get("TPUCLIP_SHORTLIST", "auto")
    if env == "auto":
        return "exact" if q_count == 1 else "extract"
    if env in SHORTLIST_METHODS:
        return env
    raise ValueError(f"TPUCLIP_SHORTLIST must be auto, {', '.join(SHORTLIST_METHODS)}; got {env!r}")


def _proof_clean(q_count: int, device, keep_scores: bool) -> tuple:
    """The ``verified`` outputs of a route with nothing to prove: ok True,
    and with ``keep_scores`` an empty (Q, 0) score matrix."""
    ok = torch.ones((), dtype=torch.bool, device=device)
    return (ok, torch.zeros((q_count, 0), device=device)) if keep_scores else (ok,)


def topk_int8_rerank_fused(
    q_f32: torch.Tensor,
    m_int8: torch.Tensor,
    scales: torch.Tensor,
    rows_full: torch.Tensor,
    k: int,
    shortlist: int = 512,
    n_valid: Optional[int] = None,
    shortlist_method: str = "extract",
    shortlist_recall: Optional[float] = None,
    keep_scores: bool = False,
    scores_out: Optional[torch.Tensor] = None,
) -> tuple:
    """int8 scan → top-``shortlist`` → gather from ``rows_full`` → exact
    rescore → (score desc, row asc) top-k. Returns ((Q, k) f32 scores,
    (Q, k) int64 rows); invalid slots are (-inf, INT32_MAX). ``verified``
    adds its proof flag, and with ``keep_scores`` the (Q, N_pad) int8
    scores it selected from (tpuclip's outputs; see :func:`rerank_at_depth`).

    ``exact``: kernel 1's full score matrix + ``torch.topk``. ``extract``:
    kernel 2's per-tile top-``k_tile`` keys, k_tile = min(128, max(4k,
    2*ceil(m/tiles))) as in tpuclip; above k = 128 the per-tile depth could
    not cover k, so ``exact`` serves instead. ``approx`` and ``verified``:
    kernel 1's scores + :func:`approx_max_k`."""
    n = m_int8.shape[0]
    k_eff = min(k, n)
    if k_eff <= 0:
        empty = torch.zeros((q_f32.shape[0], 0), device=q_f32.device)
        out = (empty, empty.long())
        if shortlist_method == "verified":
            out += _proof_clean(q_f32.shape[0], q_f32.device, keep_scores)
        return out
    return rerank_at_depth(
        q_f32, m_int8, scales, rows_full, k_eff, min(max(shortlist, 4 * k_eff), n),
        n if n_valid is None else int(n_valid), shortlist_method, shortlist_recall,
        keep_scores, scores_out,
    )


def rerank_at_depth(
    q_f32, m_int8, scales, rows_full, k_eff: int, m: int, n_valid: int, shortlist_method: str,
    shortlist_recall: Optional[float] = None, keep_scores: bool = False,
    scores_out: Optional[torch.Tensor] = None,
) -> tuple:
    """The body of :func:`topk_int8_rerank_fused` at a given shortlist depth
    ``m`` (1 <= k_eff <= m <= N): the int8 shortlist, then the exact rescore
    of its ``m`` rows. ``exact``, ``approx`` and ``verified`` select from
    kernel 1's scores (written into ``scores_out`` when given), ``extract``
    from kernel 2's keys. ``approx`` takes ``approx_max_k``'s default
    recall, ``verified`` ``shortlist_recall`` (default
    ``TPUCLIP_SHORTLIST_RECALL``, 0.95) and checks the shortlist's top
    J = min(m, max(64, 4k)) by :func:`_verified_shortlist`. Past
    ``TPUCLIP_SCORES_HBM_MB`` both take ``extract``.

    Returns (s, i); under ``verified`` also ``ok``, a 0-d bool device
    tensor, then with ``keep_scores`` the (Q, N) scores (empty (Q, 0), and
    ok True, where a gate took another route). The mesh's per-shard search
    takes tpuclip's depth, min(max(shortlist, k), shard rows), through
    here."""
    if shortlist_method not in SHORTLIST_METHODS:
        raise ValueError(f"unknown shortlist method {shortlist_method!r}")
    n, q_count = m_int8.shape[0], q_f32.shape[0]
    method = shortlist_method
    if method in ("approx", "verified") and not _scores_fit(q_count, n):
        method = "extract"
    if method == "extract" and k_eff > 128:
        method = "exact"
    qi, _ = quantize_queries(q_f32)
    ok = None
    if method == "extract":
        tile = min(PACKED_TILE_N, n)
        k_tile = min(128, max(4 * k_eff, 2 * (-(-m // (n // tile)))))
        keys = int8_candidates_packed(qi, m_int8, scales, k_tile, n_valid, tile)
        k_pad = -(-k_tile // 128) * 128
        top_keys, pos = torch.topk(keys, min(m, keys.shape[1]), dim=1)
        u = _u32(top_keys) ^ 0x80000000
        cand = (pos // k_pad) * tile + (_IDX_MASK - (u & _IDX_MASK))
        out = _rescore_select(cand, top_keys <= _NEGINF_KEY_MAX, q_f32, rows_full, k_eff)
    else:
        scores = int8_scores(qi, m_int8, scales, n_valid, out=scores_out)
        if method == "exact":
            top_s, cand = torch.topk(scores, m, dim=1)
        elif method == "approx":
            top_s, cand = approx_max_k(scores, m, APPROX_RECALL)
        else:
            if shortlist_recall is None:
                shortlist_recall = float(os.environ.get("TPUCLIP_SHORTLIST_RECALL", "0.95"))
            top_s, cand, ok = _verified_shortlist(scores, m, min(m, max(64, 4 * k_eff)), shortlist_recall)
        out = _rescore_select(cand, torch.isneginf(top_s), q_f32, rows_full, k_eff)
    if shortlist_method != "verified":
        return out
    if ok is None:
        return out + _proof_clean(q_count, q_f32.device, keep_scores)
    return out + ((ok, scores) if keep_scores else (ok,))


def _count(stats: Optional[Dict[str, int]], key: str) -> None:
    if stats is not None:
        stats[key] = stats.get(key, 0) + 1


def topk_int8_rerank_fused_auto(
    q_f32: torch.Tensor,
    m_int8: torch.Tensor,
    scales: torch.Tensor,
    rows_full: torch.Tensor,
    k: int,
    shortlist: int = 512,
    n_valid: Optional[int] = None,
    stats: Optional[Dict[str, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`topk_int8_rerank_fused` under :func:`resolve_shortlist_method`.
    Under ``verified`` the program keeps its score matrix, and when the
    proof fails the exact selection over it (:func:`topk_exact_from_scores`)
    answers: no second scan. ``stats`` counts searches per method
    (``exact_searches``, ...) and, as tpuclip's, ``verified_queries`` and
    ``shortlist_fallbacks``."""
    method = resolve_shortlist_method(int(q_f32.shape[0]))
    _count(stats, f"{method}_searches")
    if method != "verified":
        return topk_int8_rerank_fused(
            q_f32, m_int8, scales, rows_full, k, shortlist=shortlist, n_valid=n_valid,
            shortlist_method=method,
        )
    s, i, ok, scores = topk_int8_rerank_fused(
        q_f32, m_int8, scales, rows_full, k, shortlist=shortlist, n_valid=n_valid,
        shortlist_method="verified", keep_scores=True,
    )
    _count(stats, "verified_queries")
    if bool(ok):
        return s, i
    _count(stats, "shortlist_fallbacks")
    # ok is False only where the scores route ran: the matrix is not empty.
    m = fallback_shortlist_depth(k, scores.shape[1], shortlist)
    return topk_exact_from_scores(scores, q_f32, rows_full, k, m)


# =============================================================================
# Tower → scan → rescore program
# =============================================================================


@torch.inference_mode()
def query_topk_fused(
    model,
    text_inputs: Sequence[torch.Tensor],
    image_inputs: Sequence[torch.Tensor],
    m_int8: torch.Tensor,
    scales: torch.Tensor,
    rows_full: torch.Tensor,
    k: int,
    n_valid: Optional[int] = None,
    shortlist: int = 512,
    shortlist_method: str = "extract",
    keep_scores: bool = False,
    scores_out: Optional[torch.Tensor] = None,
) -> tuple:
    """The towers, then ONE :func:`topk_int8_rerank_fused` over the query
    block: ((Q, k) f32 scores, (Q, k) int64 rows). ``text_inputs`` is ()
    or (token ids (Tb, 64), mask); ``image_inputs`` is () or the vision
    tower's Ib rows in the model's format (``model.image_features``). The
    block holds the texts at [0, Tb) and the images at [Tb, Tb + Ib), so a
    mixed serve window reads the int8 matrix once. tpuclip's fused query
    programs jit this into one XLA program; here it is eager on the CPU
    and, on CUDA, captured once per shape as a CUDA graph
    (``tpuclip_torch.ops.graphs``). The embedding never leaves the device;
    results equal embed-then-search on the same block. Under ``verified``
    the proof flag follows, and with ``keep_scores`` the resident (Q, N)
    scores and the fp32 embedding, so that a proof miss re-runs neither
    the tower nor the scan; ``scores_out`` is the index's buffer that
    kernel 1 writes the scores into, shared by every captured program."""
    parts = []
    if text_inputs:
        parts.append(model.get_text_features(*text_inputs))
    if image_inputs:
        parts.append(model.image_features(*image_inputs))
    emb = parts[0] if len(parts) == 1 else torch.cat(parts)
    out = topk_int8_rerank_fused(
        emb, m_int8, scales, rows_full, k, shortlist=shortlist, n_valid=n_valid,
        shortlist_method=shortlist_method, keep_scores=keep_scores, scores_out=scores_out,
    )
    if keep_scores and shortlist_method == "verified":
        return out + (emb.float(),)
    return out
