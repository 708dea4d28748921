"""Device-resident search index (PyTorch port of ``tpuclip/index/search.py``).

``refresh`` reads the packed matrix caches (tpuclip's ``MatrixCache``,
reused) once per change of the database and uploads what the search mode
needs; every search then runs on the device. What is ported:

- **int8 precision** (the default): the rows are uploaded once in the
  storage dtype (bf16 on CUDA, fp32 on the CPU) and the int8 matrix + per-row
  scales are derived from them on the device. k <= 128 runs
  :func:`~tpuclip_torch.ops.topk_int8.topk_int8_rerank_fused_auto` (int8
  shortlist, CUDA kernels 1 and 2, exact rescore against the resident rows);
  larger k takes a ``max(4k, 64)`` int8 shortlist (kernel 1) rescored in
  fp32 from the host memmap, as tpuclip does.
- **bf16 precision** (``TPUCLIP_SEARCH_PRECISION=bf16``): the padded
  matrix is resident in ``matrix_dtype`` and every search is
  :func:`~tpuclip_torch.ops.topk.cosine_topk` (kernel 4 for k <= 128).
- **binary-only databases**: the packed sign bits are resident (1 bit per
  dimension) and searched with :func:`~tpuclip_torch.ops.hamming.binary_topk`
  (kernels 6 and 7); similarity is matches / D.
- **cascade** (``TPUCLIP_SEARCH_MODE=cascade``): no flat matrix is uploaded;
  a packed-binary prefilter (kernel 5, 6 or 7) picks a shortlist that is
  rescored in fp32 from the host memmap.
- ``TPUCLIP_INDEX_HBM_GB`` caps the flat matrix, as tpuclip does off the TPU.

Not ported yet, each raising ``NotImplementedError`` instead of running a
slower path: folder filters and the int8 search without the resident rows
(``TPUCLIP_DEVICE_RERANK=0``; ROADMAP Queue 1 item 4), the ``ivf`` mode
(item 8) and mesh sharding (item 10).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpuclip.index.cache import MatrixCache
from tpuclip.index.store import MetadataStore
from tpuclip.utils.bucketing import batch_bucket
from tpuclip.utils.logging import log
from tpuclip_torch.device import DeviceLike, default_dtype, resolve_device
from tpuclip_torch.ops.hamming import (
    BINARY_TILE_N,
    binary_shortlist_q1,
    binary_topk,
    pack_bits_to_words,
    pad_words,
)
from tpuclip_torch.ops.topk import DEFAULT_TILE_N, _final_merge, cosine_topk
from tpuclip_torch.ops.topk_int8 import (
    INT8_TILE_N,
    derive_int8_matrix,
    int8_scores,
    quantize_queries,
    topk_int8_rerank_fused_auto,
)

_UPLOAD_ROWS = 65536  # host rows converted + copied per upload step
_INT32_MIN = -(2**31)
# Largest k the fused int8 search serves; above it the host rescore does.
_FUSED_MAX_K = 128


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to tpuclip_torch yet ({item})")


class DeviceIndex:
    """Device-resident brute-force index over one database."""

    def __init__(
        self,
        store: MetadataStore,
        device: DeviceLike = None,
        matrix_dtype: Optional[torch.dtype] = None,
    ):
        self.store = store
        self.cache = MatrixCache(store)
        self.device = resolve_device(device)
        self.matrix_dtype = matrix_dtype or default_dtype(self.device)
        self.precision = os.environ.get("TPUCLIP_SEARCH_PRECISION", "int8")
        if self.precision not in ("int8", "bf16"):
            raise ValueError(f"TPUCLIP_SEARCH_PRECISION must be int8 or bf16, got {self.precision!r}")
        if self.precision == "bf16" and self.device.type == "cuda" and self.matrix_dtype != torch.bfloat16:
            raise ValueError(f"the CUDA bf16 scan takes bf16 rows, got matrix_dtype {self.matrix_dtype}")
        if self.precision == "int8" and (
            os.environ.get("TPUCLIP_SEARCH_RERANK", "1") == "0"
            or os.environ.get("TPUCLIP_DEVICE_RERANK", "auto") == "0"
        ):
            raise _not_ported("int8 search without the device rerank copy", "ROADMAP Queue 1 item 4")
        self.search_mode = os.environ.get("TPUCLIP_SEARCH_MODE", "exact")
        if self.search_mode == "ivf":
            raise _not_ported("search mode 'ivf'", "ROADMAP Queue 1 item 8")
        if self.search_mode not in ("exact", "cascade"):
            raise ValueError(f"TPUCLIP_SEARCH_MODE must be exact, ivf or cascade, got {self.search_mode!r}")
        if os.environ.get("TPUCLIP_SHARDED_INDEX") == "1":
            raise _not_ported("the mesh-sharded index", "ROADMAP Queue 1 item 10")
        self._cascade = False
        self._ids: Optional[np.ndarray] = None  # row -> image_id
        self._host_vectors = None  # fp32 memmap, row-aligned with _ids
        self._rows_device: Optional[torch.Tensor] = None  # (N, D) storage dtype, int8 mode
        self._matrix: Optional[torch.Tensor] = None  # (N_pad, D) int8 or matrix_dtype
        self._scales: Optional[torch.Tensor] = None  # (N_pad,) f32, int8 mode
        self._n_valid = 0
        self._bin_ids: Optional[np.ndarray] = None  # binary row -> image_id
        self._bin_matrix: Optional[torch.Tensor] = None  # (N_pad, W) int32 packed words
        self._fingerprint: Optional[Tuple[int, ...]] = None
        # Searches per shortlist method (exact_searches / extract_searches).
        self.shortlist_stats: dict = {}

    # ---------------------------------------------------------------- loading

    def _current_fingerprint(self) -> Tuple[int, ...]:
        """(count, max_id, sum_id) of embeddings then of binary_embeddings."""
        return self.store.embeddings_fingerprint() + self.store.binary_fingerprint()

    def _upload(self, vectors, n_pad: int) -> torch.Tensor:
        """Host fp32 rows → (n_pad, D) ``matrix_dtype`` on the device, zero
        rows past N, converted and copied in steps."""
        n, d = vectors.shape
        rows = torch.zeros((n_pad, d), dtype=self.matrix_dtype, device=self.device)
        for s in range(0, n, _UPLOAD_ROWS):
            chunk = np.array(vectors[s : s + _UPLOAD_ROWS], np.float32)  # writable copy
            rows[s : s + len(chunk)] = torch.from_numpy(chunk).to(self.device)
        return rows

    def refresh(self, force: bool = False) -> None:
        fp = self._current_fingerprint()
        if not force and fp == self._fingerprint:
            return
        self.cache.refresh(full_fp=fp[:3], bin_fp=fp[3:])
        ids, vectors = self.cache.load(refresh=False)
        bin_ids, packed = self.cache.load_binary(refresh=False)
        self._ids = ids
        self._host_vectors = vectors if len(ids) else None
        self._rows_device = self._matrix = self._scales = self._bin_matrix = None
        self._n_valid = 0
        # Cascade gate: the binary rows must be exactly the full rows (both
        # caches are image_id-ordered); then no flat matrix is uploaded.
        self._cascade = False
        if self.search_mode == "cascade" and len(ids):
            if len(bin_ids) == len(ids) and np.array_equal(bin_ids, ids):
                self._cascade = True
            else:
                log(
                    "  [WARNING] cascade search mode needs binary rows aligned "
                    "with full rows; falling back to the exact scan"
                )
        if len(ids) and not self._cascade:
            if not self._flat_matrix_fits(len(ids)):
                fallback = (
                    "serving from the binary index"
                    if len(bin_ids)
                    else "NO binary rows exist either — searches will return nothing"
                )
                log(
                    f"  [WARNING] index too large for the device "
                    f"({len(ids):,} x {self.store.embedding_dim} {self.precision} exceeds "
                    f"TPUCLIP_INDEX_HBM_GB) — {fallback}. Use TPUCLIP_SEARCH_MODE=cascade "
                    f"(exact-rescored, ~N/8 bytes resident)."
                )
            elif self.precision == "int8":
                n_pad = -(-len(ids) // INT8_TILE_N) * INT8_TILE_N
                self._rows_device = self._upload(vectors, len(ids))
                self._matrix, self._scales = derive_int8_matrix(self._rows_device, n_pad)
                self._n_valid = len(ids)
            else:
                n_pad = -(-len(ids) // DEFAULT_TILE_N) * DEFAULT_TILE_N
                self._matrix = self._upload(vectors, n_pad)
                self._n_valid = len(ids)
        self._bin_ids = bin_ids
        if len(bin_ids):
            # Packed words stay packed on the device: 1 bit per dimension.
            words = np.array(packed)  # writable host copy of the memmap
            pad = (-words.shape[-1]) % 4
            if pad:
                words = np.pad(words, ((0, 0), (0, pad)))
            padded, _ = pad_words(torch.from_numpy(words.view(np.int32)), BINARY_TILE_N)
            self._bin_matrix = padded.to(self.device)
        self._fingerprint = fp
        if len(ids) or len(bin_ids):
            log(
                f"  Index resident on {self.device}: {len(ids):,} full vectors, "
                f"{len(bin_ids):,} binary rows"
            )

    def _flat_matrix_fits(self, n_rows: int) -> bool:
        """Capacity gate for the flat matrix, applied when
        ``TPUCLIP_INDEX_HBM_GB`` is set (as tpuclip does off the TPU). The
        cap covers the scan matrix itself; a default tied to the card waits
        for a measurement."""
        env = os.environ.get("TPUCLIP_INDEX_HBM_GB")
        if env is None:
            return True
        try:
            cap = float(env)
        except ValueError:
            log(f"  [WARNING] ignoring malformed TPUCLIP_INDEX_HBM_GB={env!r}")
            return True
        itemsize = 1 if self.precision == "int8" else torch.finfo(self.matrix_dtype).bits // 8
        return n_rows * self.store.embedding_dim * itemsize / 1e9 <= cap

    @property
    def num_full(self) -> int:
        return 0 if self._ids is None else len(self._ids)

    @property
    def num_binary(self) -> int:
        return 0 if self._bin_ids is None else len(self._bin_ids)

    # ---------------------------------------------------------------- search

    def _refuse_filters(self, filter_folders) -> None:
        if filter_folders:
            raise _not_ported("folder filters", "ROADMAP Queue 1 item 4")

    def search(
        self,
        query: np.ndarray,
        k: int,
        filter_folders: Optional[Sequence[str]] = None,
    ) -> List[Tuple[str, float]]:
        """Top-k over the index: [(file_path, similarity)] descending. Full
        vectors when resident, else the binary rows (the reference's
        preference order, image_database.py:1532-1556)."""
        self.refresh()
        self._refuse_filters(filter_folders)
        q2d = np.asarray(query, np.float32).reshape(1, -1)
        if self._cascade_ready():
            return self._search_cascade(q2d, k)[0]
        if self._matrix is not None:
            return self._search_dense(q2d, k)[0]
        if self._bin_matrix is not None:
            return self._search_binary(q2d, k)[0]
        return []

    def search_batch(
        self,
        queries: np.ndarray,
        k: int,
        filter_folders: Optional[Sequence[str]] = None,
    ) -> List[List[Tuple[str, float]]]:
        """Top-k for Q queries in one pass over the matrix. On the flat
        matrix the query count is padded to the {1, 4, 16, 64} ladder with
        zero rows, sliced off before result mapping."""
        self.refresh()
        if len(queries) == 0:
            return []
        self._refuse_filters(filter_folders)
        q_real = len(queries)
        q_host = np.asarray(queries, np.float32).reshape(q_real, -1)
        if self._cascade_ready():
            return self._search_cascade(q_host, k)
        if self._matrix is None:
            if self._bin_matrix is not None:
                return self._search_binary(q_host, k)
            return [[] for _ in range(q_real)]
        bucket = batch_bucket(q_real)
        if bucket > q_real:
            q_host = np.concatenate(
                [q_host, np.zeros((bucket - q_real, q_host.shape[1]), np.float32)]
            )
        return self._search_dense(q_host, k)[:q_real]

    def _search_dense(self, q_host: np.ndarray, k: int) -> List[List[Tuple[str, float]]]:
        """(Q, D) queries over the flat matrix: the int8 fused search (k <=
        128), the int8 shortlist with the host rescore (larger k), or the
        bf16 scan."""
        q = torch.from_numpy(q_host).to(self.device)
        if self.precision == "bf16":
            scores, rows = cosine_topk(q, self._matrix, k, n_valid=self._n_valid)
        elif k <= _FUSED_MAX_K:
            scores, rows = topk_int8_rerank_fused_auto(
                q, self._matrix, self._scales, self._rows_device, k,
                n_valid=self._n_valid, stats=self.shortlist_stats,
            )
        else:
            # tpuclip's route above k = 128: an int8 shortlist of depth
            # max(4k, 64), rescored in fp32 from the host memmap.
            s, r = self._int8_shortlist(q, max(4 * k, 64))
            scores, rows = self._exact_rerank_batch(q_host, s, r, k)
            return self._map_batch_results(scores, rows, len(q_host))
        return self._map_batch_results(scores.cpu().numpy(), rows.cpu().numpy(), len(q_host))

    def _int8_shortlist(self, q: torch.Tensor, m: int):
        """Kernel 1's int8 scores, then the exact top-m ordered (score desc,
        row asc): ((Q, m) f32, (Q, m) rows) on the host."""
        qi, _ = quantize_queries(q)
        scores = int8_scores(qi, self._matrix, self._scales, self._n_valid)
        rows = torch.arange(scores.shape[1], device=scores.device).expand_as(scores)
        s, r = _final_merge(scores, rows, min(m, scores.shape[1]))
        return s.cpu().numpy(), r.cpu().numpy()

    def _exact_rerank_batch(self, qn, scores, rows, k):
        """Exact fp32 rescoring of (Q, m) shortlists from the memmapped
        vectors: one stacked gather + einsum, ordered (score desc, row asc).
        Invalid slots come back as (-inf, len(self._ids)), a row past every
        valid one that the result mapping drops."""
        n_ids = len(self._ids)
        valid = np.isfinite(scores) & (rows >= 0) & (rows < n_ids)
        safe = np.where(valid, rows, 0)
        gathered = np.asarray(self._host_vectors[safe], np.float32)  # (Q, m, D)
        exact = np.einsum("qkd,qd->qk", gathered, qn)
        exact = np.where(valid, exact, -np.inf)
        # The sentinel must survive the rows' dtype: n_ids is above every
        # valid row and representable (tpuclip's int32-wrap fix).
        sort_rows = np.where(valid, rows, n_ids)
        order = np.lexsort((sort_rows, -exact), axis=-1)[:, :k]
        out_s = np.take_along_axis(exact, order, axis=1)
        out_r = np.take_along_axis(sort_rows, order, axis=1)
        out_r = np.where(np.isfinite(out_s), out_r, n_ids)
        return out_s, out_r

    def _map_batch_results(self, scores, rows, q_count):
        """(Q, k) host scores/rows → per-query [(path, similarity)] lists."""
        out = []
        for qi_row in range(q_count):
            valid = np.isfinite(scores[qi_row]) & (rows[qi_row] < len(self._ids))
            image_ids = self._ids[rows[qi_row][valid]]
            paths = self.store.fetch_paths_for_ids(image_ids)
            out.append(
                [
                    (paths[int(i)], float(s))
                    for i, s in zip(image_ids, scores[qi_row][valid])
                    if int(i) in paths
                ]
            )
        return out

    # ---------------------------------------------------------------- binary

    def _query_words(self, queries_2d: np.ndarray) -> torch.Tensor:
        """Sign-pack (Q, D) queries into (Q, W) int32 words on the device."""
        words = pack_bits_to_words((queries_2d >= 0).astype(np.uint8)).view(np.int32)
        return torch.from_numpy(np.ascontiguousarray(words)).to(self.device)

    def _search_binary(self, queries_2d: np.ndarray, k: int) -> List[List[Tuple[str, float]]]:
        """Binary-only search: one :func:`binary_topk` call for the whole
        batch (tpuclip loops over the queries); similarity = matches / D."""
        matches, rows = binary_topk(
            self._query_words(queries_2d), self._bin_matrix, k, len(self._bin_ids)
        )
        matches, rows = matches.cpu().numpy(), rows.cpu().numpy()
        dim = self.store.embedding_dim
        out = []
        for qm, qr in zip(matches, rows):
            valid = qm > _INT32_MIN
            image_ids = self._bin_ids[qr[valid]]
            paths = self.store.fetch_paths_for_ids(image_ids)
            out.append(
                [
                    (paths[int(i)], float(m) / dim)
                    for i, m in zip(image_ids, qm[valid])
                    if int(i) in paths
                ]
            )
        return out

    # --------------------------------------------------------------- cascade

    def _cascade_ready(self) -> bool:
        return self._cascade and self._bin_matrix is not None and self._host_vectors is not None

    def _cascade_depth(self, k: int) -> int:
        env = os.environ.get("TPUCLIP_CASCADE_DEPTH")
        depth = 0
        if env:
            # Parsed defensively: this runs on the query path, where a
            # malformed value must not fail every search.
            try:
                depth = int(env)
            except ValueError:
                log(f"  [WARNING] invalid TPUCLIP_CASCADE_DEPTH={env!r}; using the default")
        if depth <= 0:
            depth = max(32 * k, 512)
        return max(k, min(depth, len(self._ids)))

    def _cascade_prefilter(self, qwords: torch.Tensor, depth: int):
        """The packed-binary prefilter: ((Q, m) f32 matches with -inf
        invalid, (Q, m) rows) on the host.

        One query takes the scores route (kernel 5, then the exact top
        min(2 * depth, N)) under TPUCLIP_CASCADE_PREFILTER=scores, and under
        auto on CUDA (tpuclip's TPU rule); every other case takes
        :func:`binary_topk` at ``depth`` (kernel 6 or 7)."""
        mode = os.environ.get("TPUCLIP_CASCADE_PREFILTER", "auto")
        eligible = qwords.shape[0] == 1 and (
            mode == "scores" or (mode == "auto" and self.device.type == "cuda")
        )
        n_valid = len(self._bin_ids)
        if eligible:
            s, i = binary_shortlist_q1(qwords, self._bin_matrix, min(2 * depth, n_valid), n_valid)
            return s.cpu().numpy(), i.cpu().numpy()
        matches, rows = binary_topk(qwords, self._bin_matrix, depth, n_valid)
        matches = matches.cpu().numpy().astype(np.float32)
        # INT32_MIN marks rows past n_valid: -inf for the rescore.
        matches[matches <= _INT32_MIN + 1] = -np.inf
        return matches, rows.cpu().numpy()

    def _search_cascade(self, queries_2d: np.ndarray, k: int) -> List[List[Tuple[str, float]]]:
        """Packed-binary prefilter + exact fp32 rescore from the host memmap,
        (Q, k) results."""
        matches, rows = self._cascade_prefilter(
            self._query_words(queries_2d), self._cascade_depth(k)
        )
        scores, out_rows = self._exact_rerank_batch(queries_2d, matches, rows, k)
        return self._map_batch_results(scores, out_rows, len(queries_2d))
