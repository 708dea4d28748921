"""Packed sign-bit search (PyTorch port of ``tpuclip/ops/hamming.py``).

A binary embedding is D sign bits packed into W = D/32 uint32 words; a
row's score against a query is popcount(query AND row), the reference's
binary dot (``image_database.py:1621``), and similarity is score / D.
Results are ordered (score desc, row asc).

Three kernels sit behind this module, in ``tpuclip_torch/csrc/binary_scan.cu``:

- :func:`binary_scores` — kernel 5, every row's score for one query as f32
  (replaces ``_binary_scores_kernel``); the cascade's single-query prefilter
  (:func:`binary_shortlist_q1`) and every folder-filtered binary search
  (:func:`binary_topk_masked`);
- :func:`binary_topk_q1` — kernel 6, the exact top-k of one query
  (replaces ``_binary_topk_q1_kernel``);
- :func:`binary_topk_batched` — kernel 7, the same for a batch (replaces
  ``_binary_topk_kernel``).

:func:`binary_topk` sends one query to kernel 6 and a batch to kernel 7.
On the card kernels 6 and 7 serve every k up to N, with a transient
scratch of about 2 bytes per (query, row) (``SCRATCH_MAX_BYTES``, below).
Each wrapper dispatches on its tensors' device: CPU tensors go to the plain
PyTorch version beside it (same signature, same results); CUDA tensors go
to the kernel, which runs or raises, and count in the wrapper's
``launches``. Words are (N, W) int32 or uint32 tensors, row-major (the
TPU's (W, 8, N/8) sublane grouping is not carried over); rows at or past
``n_valid`` are padding.

The numpy helpers at the end are copies of tpuclip's (that module imports
jax); ``tests/test_torch_imports.py`` pins them to the originals.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tpuclip_torch.ops._counters import counted
from tpuclip_torch.ops.topk import _final_merge

# Rows a kernel block stages at once, and the unit rows are padded to.
BINARY_TILE_N = 256
# The kernels' histogram has 32W + 2 bins in shared memory: W <= 64.
MAX_WORDS = 64
_INT32_MIN = -(2**31)
_NEG_INF = float("-inf")
_CHUNK_BYTES = 1 << 24  # bounds the transient memory of the plain popcounts
_BLOCKS_PER_SM = 4  # row chunks of kernels 6 and 7 per SM
# The kernels count a chunk's rows in 16-bit counters: at most 255 sub-tiles.
_MAX_CHUNK_ROWS = 255 * BINARY_TILE_N
# Scratch of one call of kernels 6 / 7 (the (Q, N_pad) uint16 bins and the
# histograms: 22.5 MB a query at 10M rows). A batch whose scratch would pass
# it is taken in groups of queries, one kernel call each.
SCRATCH_MAX_BYTES = 2 << 30


def pad_words(words: torch.Tensor, tile_n: int = BINARY_TILE_N) -> Tuple[torch.Tensor, int]:
    """(N, W) packed words → ((N_pad, W) with zero rows up to a multiple of
    ``tile_n``, N)."""
    n = words.shape[0]
    rem = (-n) % tile_n
    if rem:
        words = torch.cat([words, words.new_zeros((rem, words.shape[1]))])
    return words, n


def _as_int32(words: torch.Tensor) -> torch.Tensor:
    if words.dtype == torch.uint32:
        return words.view(torch.int32)
    if words.dtype != torch.int32:
        raise TypeError(f"packed words must be int32 or uint32, got {words.dtype}")
    return words


def _check_binary_args(qwords, words, n_valid) -> None:
    if qwords.dim() != 2 or words.dim() != 2 or qwords.shape[1] != words.shape[1]:
        raise ValueError(f"shapes (Q, W) and (N, W) required, got {tuple(qwords.shape)}, {tuple(words.shape)}")
    if not 0 <= int(n_valid) <= words.shape[0]:
        raise ValueError(f"n_valid {n_valid} outside [0, {words.shape[0]}]")
    if qwords.device != words.device:
        raise ValueError("queries and words must share one device")


def _check_cuda_binary(qwords, words) -> None:
    if not (qwords.is_contiguous() and words.is_contiguous()):
        raise ValueError("the CUDA kernels take contiguous tensors")
    if words.data_ptr() % 16:
        raise ValueError("the CUDA kernels take 16-byte aligned words")
    if not 1 <= words.shape[1] <= MAX_WORDS:
        raise ValueError(f"the CUDA kernels take 1 <= W <= {MAX_WORDS}, got {words.shape[1]}")


def _popcount_and(qwords: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """(Q, N) int32 popcount(query AND row), bytewise through uint8 views
    (AND is bytewise, so byte order does not matter), chunked over rows."""
    qb = qwords.contiguous().view(torch.uint8)
    wb = words.contiguous().view(torch.uint8)
    q_count, n = qb.shape[0], wb.shape[0]
    out = torch.empty((q_count, n), dtype=torch.int32, device=wb.device)
    step = max(1, _CHUNK_BYTES // max(1, q_count * wb.shape[1]))
    for s in range(0, n, step):
        x = qb[:, None, :] & wb[None, s : s + step, :]
        x = x - ((x >> 1) & 0x55)
        x = (x & 0x33) + ((x >> 2) & 0x33)
        x = (x + (x >> 4)) & 0x0F
        out[:, s : s + x.shape[1]] = x.sum(dim=-1, dtype=torch.int32)
    return out


def _merge_int_candidates(scores: torch.Tensor, idx: torch.Tensor, k_eff: int):
    """Exact (score desc, idx asc) top-``k_eff`` of INTEGER-scored
    candidates (tpuclip's ``_merge_int_candidates``). The INT32_MIN sentinel
    is clamped to -1 for the order, never negated (its negation wraps)."""
    sort_scores = torch.clamp(scores.long(), min=-1)
    keys = (sort_scores + 1) * 2**32 + (0xFFFFFFFF - idx.long())
    pos = torch.topk(keys, k_eff, dim=1).indices
    return scores.gather(1, pos), idx.long().gather(1, pos)


# =============================================================================
# Kernel 5: single-query scores
# =============================================================================


def _binary_scores_plain(qwords, words, n_valid) -> torch.Tensor:
    """Plain version of :func:`binary_scores`."""
    out = _popcount_and(_as_int32(qwords), _as_int32(words)).float()
    out[:, int(n_valid):] = _NEG_INF
    return out


@counted
def binary_scores(qwords: torch.Tensor, words: torch.Tensor, n_valid: Optional[int] = None) -> torch.Tensor:
    """(1, W) packed query x (N_pad, W) words → (1, N_pad) f32 match counts,
    -inf for rows at or past ``n_valid``."""
    n_valid = words.shape[0] if n_valid is None else int(n_valid)
    _check_binary_args(qwords, words, n_valid)
    if qwords.shape[0] != 1:
        raise ValueError(f"binary_scores takes one query, got {qwords.shape[0]}")
    if qwords.device.type == "cpu":
        return _binary_scores_plain(qwords, words, n_valid)
    if qwords.device.type != "cuda":
        raise ValueError(f"unsupported device {qwords.device}")
    from tpuclip_torch.ops._build import library

    q, w = _as_int32(qwords).contiguous(), _as_int32(words)
    _check_cuda_binary(q, w)
    n, w_words = w.shape
    out = torch.empty((1, n), dtype=torch.float32, device=w.device)
    if n == 0:
        return out
    with torch.cuda.device(w.device):
        rc = library().tpuclip_binary_scores(
            q.data_ptr(), w.data_ptr(), out.data_ptr(), n, w_words, n_valid,
            torch.cuda.current_stream(w.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"binary_scores kernel launch failed: cudaError {rc}")
    binary_scores.launches += 1
    return out


def binary_shortlist_q1(
    qwords: torch.Tensor, words: torch.Tensor, m: int, n_valid: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``m`` binary shortlist of one query: kernel 5's scores, then the
    exact top-m ordered (score desc, row asc) — ((1, m) f32 match counts,
    (1, m) int64 rows), padding rows (-inf) last. tpuclip takes the TPU's
    ``lax.approx_max_k`` here; an exact top-m holds every row it can find."""
    scores = binary_scores(qwords, words, n_valid)
    rows = torch.arange(scores.shape[1], device=scores.device).expand_as(scores)
    return _final_merge(scores, rows, min(m, scores.shape[1]))


# =============================================================================
# Kernels 6 and 7: exact top-k
# =============================================================================


def _binary_topk_plain(qwords, words, k, n_valid):
    """Plain version of :func:`binary_topk_q1` / :func:`binary_topk_batched`:
    every score, then :func:`_merge_int_candidates` over all rows."""
    scores = _popcount_and(_as_int32(qwords), _as_int32(words))
    scores[:, int(n_valid):] = _INT32_MIN
    rows = torch.arange(scores.shape[1], device=scores.device).expand_as(scores)
    return _merge_int_candidates(scores, rows, min(k, scores.shape[1]))


def _scratch_bytes(q_count: int, n: int, w: int, n_chunks: int) -> int:
    """Bytes of the scratch of kernels 6 / 7 for ``q_count`` queries
    (``binary_scan.cu``'s header): int32 histograms (per chunk, totals, the
    threshold), then the uint16 bins at a 16-byte boundary."""
    bins = 32 * w + 2
    ints = q_count * (bins * (n_chunks + 1) + bins + 4)
    return -(-ints * 4 // 16) * 16 + q_count * (-(-n // 8) * 8) * 2


def _binary_plan(q_count: int, n: int, w: int, sms: int) -> Tuple[int, int, int]:
    """(chunk_rows, queries per kernel call, scratch bytes of one call) for
    kernels 6 / 7 over ``n`` rows of ``w`` words on ``sms`` SMs: about
    ``_BLOCKS_PER_SM`` chunks of whole sub-tiles per SM, at most
    ``_MAX_CHUNK_ROWS`` rows each; every query in one call while their
    scratch fits ``SCRATCH_MAX_BYTES``, else as many as fit (a multiple of
    16, pass 1's group, when 16 or more do), and at least one."""
    sub_tiles = -(-n // BINARY_TILE_N)
    chunk_rows = min(_MAX_CHUNK_ROWS, -(-sub_tiles // (_BLOCKS_PER_SM * sms)) * BINARY_TILE_N)
    n_chunks = -(-n // chunk_rows)
    group = q_count
    if _scratch_bytes(q_count, n, w, n_chunks) > SCRATCH_MAX_BYTES:
        group = SCRATCH_MAX_BYTES // _scratch_bytes(1, n, w, n_chunks)
        group = max(1, group - group % 16 if group >= 16 else group)
    return chunk_rows, group, _scratch_bytes(group, n, w, n_chunks)


def _binary_topk_cuda(entry: str, qwords, words, k, n_valid):
    from tpuclip_torch.ops._build import library

    q, w = _as_int32(qwords).contiguous(), _as_int32(words)
    _check_cuda_binary(q, w)
    q_count = q.shape[0]
    n, w_words = w.shape
    k_eff = min(k, n)
    out_m = torch.empty((q_count, k_eff), dtype=torch.int32, device=w.device)
    out_r = torch.empty((q_count, k_eff), dtype=torch.int64, device=w.device)
    if q_count == 0 or k_eff == 0:
        return out_m, out_r
    sms = torch.cuda.get_device_properties(w.device).multi_processor_count
    chunk_rows, group, n_bytes = _binary_plan(q_count, n, w_words, sms)
    scratch = torch.empty(n_bytes, dtype=torch.uint8, device=w.device)
    fn = getattr(library(), entry)
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        for g0 in range(0, q_count, group):
            g = min(group, q_count - g0)
            args = [q[g0].data_ptr(), w.data_ptr(), scratch.data_ptr(), out_m[g0].data_ptr(),
                    out_r[g0].data_ptr()]
            if entry == "tpuclip_binary_topk":
                args.append(g)
            rc = fn(*args, n, w_words, n_valid, k_eff, chunk_rows, stream)
            if rc != 0:
                raise RuntimeError(f"{entry} kernel launch failed: cudaError {rc}")
    return out_m, out_r


@counted
def binary_topk_q1(
    qwords: torch.Tensor, words: torch.Tensor, k: int, n_valid: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 6: :func:`binary_topk` for one (1, W) query. On the card: one
    read of the words scores every row on the binary tensor cores, keeping
    its uint16 score bin and a histogram; a collect reads the bins back."""
    n_valid = words.shape[0] if n_valid is None else int(n_valid)
    _check_binary_args(qwords, words, n_valid)
    if qwords.shape[0] != 1:
        raise ValueError(f"binary_topk_q1 takes one query, got {qwords.shape[0]}")
    if qwords.device.type == "cpu":
        return _binary_topk_plain(qwords, words, k, n_valid)
    if qwords.device.type != "cuda":
        raise ValueError(f"unsupported device {qwords.device}")
    out = _binary_topk_cuda("tpuclip_binary_topk_q1", qwords, words, k, n_valid)
    binary_topk_q1.launches += 1
    return out


@counted
def binary_topk_batched(
    qwords: torch.Tensor, words: torch.Tensor, k: int, n_valid: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 7: :func:`binary_topk` for (Q, W) queries. On the card: as
    kernel 6, one read of the words per 16 queries, in groups of queries when
    the (Q, N_pad) uint16 scratch would pass ``SCRATCH_MAX_BYTES``."""
    n_valid = words.shape[0] if n_valid is None else int(n_valid)
    _check_binary_args(qwords, words, n_valid)
    if qwords.device.type == "cpu":
        return _binary_topk_plain(qwords, words, k, n_valid)
    if qwords.device.type != "cuda":
        raise ValueError(f"unsupported device {qwords.device}")
    out = _binary_topk_cuda("tpuclip_binary_topk", qwords, words, k, n_valid)
    binary_topk_batched.launches += 1
    return out


def binary_topk(
    qwords: torch.Tensor, words: torch.Tensor, k: int, n_valid: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of (Q, W) packed queries over (N_pad, W) words: ((Q, k)
    int32 match counts, (Q, k) int64 rows) ordered (matches desc, row asc),
    k up to N_pad; rows at or past ``n_valid`` score INT32_MIN. One query
    runs kernel 6, a batch kernel 7 (as ``binary_topk_packed_pallas``)."""
    if qwords.shape[0] == 1:
        return binary_topk_q1(qwords, words, k, n_valid)
    return binary_topk_batched(qwords, words, k, n_valid)


def binary_topk_masked(
    qwords: torch.Tensor, words: torch.Tensor, k: int, n_valid: int, mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`binary_topk` under the (N_pad,) additive 0/-inf folder
    ``mask`` (tpuclip's masked ``binary_topk_packed``): kernel 5's match
    counts, one query at a time; masked rows and rows past ``n_valid``
    score INT32_MIN; then the exact (matches desc, row asc) top-k."""
    _check_binary_args(qwords, words, n_valid)
    if mask.shape != (words.shape[0],):
        raise ValueError(f"mask must be ({words.shape[0]},), got {tuple(mask.shape)}")
    k_eff = min(k, words.shape[0])
    rows = torch.arange(words.shape[0], device=words.device)[None]
    out_m, out_r = [], []
    for q in qwords.split(1):
        scores = binary_scores(q, words, n_valid)
        masked = torch.isneginf(scores) | (mask[None, :] < 0)
        matches = scores.masked_fill(masked, 0.0).to(torch.int32).masked_fill(masked, _INT32_MIN)
        m, r = _merge_int_candidates(matches, rows, k_eff)
        out_m.append(m)
        out_r.append(r)
    return torch.cat(out_m), torch.cat(out_r)


# =============================================================================
# Host numpy helpers
# =============================================================================


def pack_bits_to_words(bits01: np.ndarray) -> np.ndarray:
    """(N, D) uint8 {0,1} → (N, ceil(D/32)) uint32 words (np.packbits order,
    zero-padded). Queries and matrices must both come through here so the
    bit order cancels in AND+popcount."""
    packed = np.packbits(np.atleast_2d(bits01).astype(np.uint8), axis=-1)
    pad = (-packed.shape[-1]) % 4
    if pad:
        packed = np.pad(packed, ((0, 0), (0, pad)))
    return packed.view(np.uint32)


_POPCOUNT_TABLE = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(1)


def hamming_distance_packed(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Hamming distance between packed uint8 bit rows: a (..., W),
    b (..., W) → (...,) int32."""
    x = np.bitwise_xor(a, b)
    return _POPCOUNT_TABLE[x].sum(axis=-1).astype(np.int32)


def pack_bits(bits01: np.ndarray) -> np.ndarray:
    """(N, D) uint8 {0,1} → (N, D//8) packed uint8 (np.packbits bit order)."""
    return np.packbits(bits01.astype(np.uint8), axis=-1)


def sign_bits(embedding: np.ndarray) -> np.ndarray:
    """Reference sign quantization: (e >= 0)."""
    return (np.asarray(embedding) >= 0).astype(np.uint8)
