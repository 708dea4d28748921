"""Matmul + exact top-k over a device-resident embedding matrix (PyTorch
port of ``tpuclip/ops/topk.py``): the bf16 precision path.

The matrix is row-major (N_pad, D), zero rows past ``n_valid`` (the JAX
package keeps it feature-major (D, N) for the TPU's MXU; results do not
depend on it). Queries are cast to the matrix dtype before the dot, so
against bf16 rows the query is rounded to bf16; the dots accumulate in fp32.
Results are ordered (score desc, row asc); slots with no valid row are
(-inf, INT32_MAX).

- :func:`topk_tiles` — kernel 4 (``tpuclip_torch/csrc/topk_bf16.cu``,
  replaces ``_iterative_topk_kernel``): per-tile top-k in the kernel, then
  :func:`_final_merge`; k <= 128.
- :func:`topk_plain` — the counterpart of ``topk_xla``: every score from a
  chunked fp32 matmul, plus an optional folder mask, then the exact
  selection; any k.
- :func:`cosine_topk` — the dispatch: unmasked k <= 128 takes
  :func:`topk_tiles`, larger k and masked searches :func:`topk_plain`.

:func:`topk_tiles` dispatches on its tensors' device: CPU tensors go to the
plain version (:func:`_topk_tiles_plain`); CUDA tensors go to the kernel,
which runs or raises, and count in ``topk_tiles.launches``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpuclip_torch.ops._counters import counted
from tpuclip_torch.ops.topk_int8 import _INT32_MAX, _NEG_INF, _check_cuda_args, _final_merge

DEFAULT_TILE_N = 2048
# Largest k of the tile top-k (tpuclip's bound); larger k takes topk_plain.
MAX_TILE_K = 128

_CHUNK_ROWS = 65536  # bounds the transient memory of the chunked plain scores


def pad_matrix(rows: torch.Tensor, tile_n: int = DEFAULT_TILE_N) -> Tuple[torch.Tensor, int]:
    """(N, D) rows → ((N_pad, D) with zero rows up to a multiple of
    ``tile_n``, N). Padding once at upload keeps the per-query path copy-free
    (tpuclip's ``pad_matrix_t``, row-major)."""
    n = rows.shape[0]
    rem = (-n) % tile_n
    if rem:
        rows = torch.cat([rows, rows.new_zeros((rem, rows.shape[1]))])
    return rows, n


def _invalid_to_sentinel(scores: torch.Tensor, rows: torch.Tensor):
    return scores, rows.masked_fill(torch.isneginf(scores), _INT32_MAX)


def _check_topk_args(queries, matrix, k, n_valid) -> None:
    if not queries.is_floating_point() or matrix.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"float queries and bf16/f32 rows required, got {queries.dtype}, {matrix.dtype}")
    if queries.dim() != 2 or matrix.dim() != 2 or queries.shape[1] != matrix.shape[1]:
        raise ValueError(f"shapes (Q, D) and (N, D) required, got {tuple(queries.shape)}, {tuple(matrix.shape)}")
    if not 0 <= int(n_valid) <= matrix.shape[0]:
        raise ValueError(f"n_valid {n_valid} outside [0, {matrix.shape[0]}]")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if queries.device != matrix.device:
        raise ValueError("queries and matrix must share one device")


def _chunked_scores(queries, matrix, n_valid, dtype) -> torch.Tensor:
    """(Q, N) f32: the matrix-dtype query's products with each row, summed
    in ``dtype`` chunk by chunk and rounded to f32; -inf past ``n_valid``."""
    n = matrix.shape[0]
    q = queries.to(matrix.dtype).to(dtype)
    out = torch.empty((q.shape[0], n), dtype=torch.float32, device=q.device)
    for s in range(0, n, _CHUNK_ROWS):
        chunk = matrix[s : s + _CHUNK_ROWS].to(dtype)
        out[:, s : s + len(chunk)] = (q @ chunk.T).float()
    out[:, int(n_valid):] = _NEG_INF
    return out


def _scores_plain(queries, matrix, n_valid) -> torch.Tensor:
    """Kernel 4's reference scores: the exact products summed in float64."""
    return _chunked_scores(queries, matrix, n_valid, torch.float64)


def _select(scores: torch.Tensor, k: int):
    rows = torch.arange(scores.shape[1], device=scores.device).expand_as(scores)
    return _invalid_to_sentinel(*_final_merge(scores, rows, min(k, scores.shape[1])))


def topk_plain(
    queries: torch.Tensor,
    matrix: torch.Tensor,
    k: int,
    n_valid: Optional[int] = None,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The counterpart of ``topk_xla`` for k > 128 and masked searches, where
    tpuclip too scores outside any kernel: a matmul per chunk of rows, plus
    the (N,) additive 0/-inf ``mask``, then the exact (score desc, row asc)
    top-k: ((Q, k) f32, (Q, k) int64). On CUDA the matmul is fp32 (bf16
    products are exact in fp32; TF32 must be off), as XLA's dot on a GPU.
    On the CPU the sums are float64, rounded once to f32: that agrees with
    XLA's CPU dot where an fp32 sum in torch's order can swap rows that tie
    to the last bit."""
    n_valid = matrix.shape[0] if n_valid is None else int(n_valid)
    _check_topk_args(queries, matrix, k, n_valid)
    acc = torch.float32 if queries.device.type == "cuda" else torch.float64
    scores = _chunked_scores(queries, matrix, n_valid, acc)
    if mask is not None:
        scores = scores + mask[None, :]
    return _select(scores, k)


def _topk_tiles_plain(
    queries: torch.Tensor, matrix: torch.Tensor, k: int, n_valid: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`topk_tiles`: every score in float64
    (:func:`_scores_plain`), then the same exact selection."""
    n_valid = matrix.shape[0] if n_valid is None else int(n_valid)
    _check_topk_args(queries, matrix, k, n_valid)
    return _select(_scores_plain(queries, matrix, n_valid), k)


@counted
def topk_tiles(
    queries: torch.Tensor, matrix: torch.Tensor, k: int, n_valid: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k (k <= 128) of (Q, D) queries against (N_pad, D) rows:
    ((Q, k) f32 scores, (Q, k) int64 rows), ordered (score desc, row asc),
    rows at or past ``n_valid`` never returned (their slots are (-inf,
    INT32_MAX)). On CUDA the rows must be bf16: kernel 4 scores each
    ``DEFAULT_TILE_N``-row tile and keeps its top k, and
    :func:`_final_merge` merges the tiles."""
    n = matrix.shape[0]
    n_valid = n if n_valid is None else int(n_valid)
    _check_topk_args(queries, matrix, k, n_valid)
    if k > MAX_TILE_K:
        raise ValueError(f"topk_tiles takes k <= {MAX_TILE_K}, got {k}; use topk_plain")
    if queries.device.type == "cpu":
        return _topk_tiles_plain(queries, matrix, k, n_valid)
    if queries.device.type != "cuda":
        raise ValueError(f"unsupported device {queries.device}")
    if matrix.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA kernel takes bf16 rows, got {matrix.dtype}")
    from tpuclip_torch.ops._build import library

    q = queries.to(torch.bfloat16).contiguous()
    q_count, d = q.shape
    _check_cuda_args(q, matrix, dim=d)
    k_eff = min(k, n)
    tiles = -(-n // DEFAULT_TILE_N)
    cand_s = torch.empty((q_count, tiles * k_eff), dtype=torch.float32, device=q.device)
    cand_i = torch.empty((q_count, tiles * k_eff), dtype=torch.int32, device=q.device)
    if q_count == 0:
        return cand_s[:, :k_eff], cand_i[:, :k_eff].long()
    with torch.cuda.device(q.device):
        rc = library().tpuclip_topk_tiles(
            q.data_ptr(), matrix.data_ptr(), cand_s.data_ptr(), cand_i.data_ptr(),
            q_count, n, d, n_valid, DEFAULT_TILE_N, k_eff,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"topk_tiles kernel launch failed: cudaError {rc}")
    topk_tiles.launches += 1
    return _invalid_to_sentinel(*_final_merge(cand_s, cand_i, k_eff))


def cosine_topk(
    queries: torch.Tensor,
    matrix: torch.Tensor,
    k: int,
    n_valid: Optional[int] = None,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k dispatch (tpuclip's ``cosine_topk`` and
    ``cosine_topk_single_fetch`` in one): unmasked k <= 128 takes
    :func:`topk_tiles` (kernel 4 on CUDA); larger k and every masked search
    take :func:`topk_plain`, as tpuclip's ``topk_xla``."""
    k_eff = min(k, matrix.shape[0])
    if k_eff <= 0:
        empty = torch.zeros((queries.shape[0], 0), device=queries.device)
        return empty, empty.long()
    if mask is None and k_eff <= MAX_TILE_K:
        return topk_tiles(queries, matrix, k_eff, n_valid)
    return topk_plain(queries, matrix, k_eff, n_valid, mask=mask)
