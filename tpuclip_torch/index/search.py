"""Device-resident search index (PyTorch port of ``tpuclip/index/search.py``).

Ported: the int8 path with the resident rerank copy — tpuclip's default on
TPU and this port's default everywhere. ``refresh`` reads the packed
matrix cache (tpuclip's ``MatrixCache``, reused), uploads the rows once in
the storage dtype (bf16 on CUDA, fp32 on the CPU) and derives the int8
matrix + per-row scales from them on the device. Every search is
:func:`~tpuclip_torch.ops.topk_int8.topk_int8_rerank_fused_auto`: int8
shortlist (CUDA kernels 1 and 2) + exact rescore against the resident rows.

Not ported yet, each raising ``NotImplementedError`` instead of running a
slower path: folder filters, binary-only databases, bf16 precision, host
re-rank (``TPUCLIP_DEVICE_RERANK=0``), the ``ivf``/``cascade`` modes and
mesh sharding (ROADMAP Queue 1).
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
from tpuclip_torch.ops.topk_int8 import (
    INT8_TILE_N,
    derive_int8_matrix,
    topk_int8_rerank_fused_auto,
)

_UPLOAD_ROWS = 65536  # host rows converted + copied per upload step


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to tpuclip_torch yet ({item})")


class DeviceIndex:
    """Device-resident brute-force index over one database."""

    def __init__(self, store: MetadataStore, device: DeviceLike = None):
        self.store = store
        self.cache = MatrixCache(store)
        self.device = resolve_device(device)
        self.matrix_dtype = default_dtype(self.device)
        self.precision = os.environ.get("TPUCLIP_SEARCH_PRECISION", "int8")
        if self.precision != "int8":
            raise _not_ported(f"search precision {self.precision!r}", "ROADMAP Queue 1 item 5")
        if os.environ.get("TPUCLIP_SEARCH_RERANK", "1") == "0" or (
            os.environ.get("TPUCLIP_DEVICE_RERANK", "auto") == "0"
        ):
            raise _not_ported("int8 search without the device rerank copy", "ROADMAP Queue 1 item 4")
        self.search_mode = os.environ.get("TPUCLIP_SEARCH_MODE", "exact")
        if self.search_mode != "exact":
            raise _not_ported(f"search mode {self.search_mode!r}", "ROADMAP Queue 1 items 5, 8")
        if os.environ.get("TPUCLIP_SHARDED_INDEX") == "1":
            raise _not_ported("the mesh-sharded index", "ROADMAP Queue 1 item 10")
        self._ids: Optional[np.ndarray] = None  # row -> image_id
        self._rows_device: Optional[torch.Tensor] = None  # (N, D) storage dtype
        self._matrix: Optional[torch.Tensor] = None  # (N_pad, D) int8
        self._scales: Optional[torch.Tensor] = None  # (N_pad,) f32
        self._n_valid = 0
        self._num_binary = 0
        self._fingerprint: Optional[Tuple[int, ...]] = None
        # Searches per shortlist method (exact_searches / extract_searches).
        self.shortlist_stats: dict = {}

    # ---------------------------------------------------------------- loading

    def _current_fingerprint(self) -> Tuple[int, ...]:
        """(count, max_id, sum_id) of embeddings then of binary_embeddings."""
        return self.store.embeddings_fingerprint() + self.store.binary_fingerprint()

    def refresh(self, force: bool = False) -> None:
        fp = self._current_fingerprint()
        if not force and fp == self._fingerprint:
            return
        self.cache.refresh(full_fp=fp[:3], bin_fp=fp[3:])
        ids, vectors = self.cache.load(refresh=False)
        self._ids = ids
        self._num_binary = fp[3]
        self._rows_device = self._matrix = self._scales = None
        self._n_valid = len(ids)
        if len(ids):
            rows = torch.empty(
                (len(ids), vectors.shape[1]), dtype=self.matrix_dtype, device=self.device
            )
            for s in range(0, len(ids), _UPLOAD_ROWS):
                chunk = np.array(vectors[s : s + _UPLOAD_ROWS], np.float32)  # writable copy
                rows[s : s + len(chunk)] = torch.from_numpy(chunk).to(self.device)
            n_pad = -(-len(ids) // INT8_TILE_N) * INT8_TILE_N
            self._rows_device = rows
            self._matrix, self._scales = derive_int8_matrix(rows, n_pad)
            log(
                f"  Index resident on {self.device}: {len(ids):,} full vectors, "
                f"{self._num_binary:,} binary rows"
            )
        self._fingerprint = fp

    @property
    def num_full(self) -> int:
        return 0 if self._ids is None else len(self._ids)

    @property
    def num_binary(self) -> int:
        return self._num_binary

    # ---------------------------------------------------------------- search

    def _check_searchable(self, filter_folders) -> bool:
        """True when full vectors are resident; raises for what is not ported."""
        if filter_folders:
            raise _not_ported("folder filters", "ROADMAP Queue 1 item 4")
        if self._matrix is None and self._num_binary:
            raise _not_ported("search over binary-only databases", "ROADMAP Queue 1 item 5")
        return self._matrix is not None

    def search(
        self,
        query: np.ndarray,
        k: int,
        filter_folders: Optional[Sequence[str]] = None,
    ) -> List[Tuple[str, float]]:
        """Top-k over the index: [(file_path, similarity)] descending."""
        self.refresh()
        if not self._check_searchable(filter_folders):
            return []
        q = torch.from_numpy(np.asarray(query, np.float32).reshape(1, -1)).to(self.device)
        scores, rows = topk_int8_rerank_fused_auto(
            q, self._matrix, self._scales, self._rows_device, k,
            n_valid=self._n_valid, stats=self.shortlist_stats,
        )
        return self._map_batch_results(scores.cpu().numpy(), rows.cpu().numpy(), 1)[0]

    def search_batch(
        self,
        queries: np.ndarray,
        k: int,
        filter_folders: Optional[Sequence[str]] = None,
    ) -> List[List[Tuple[str, float]]]:
        """Top-k for Q queries in one pass over the matrix. The query count is
        padded to the {1, 4, 16, 64} ladder with zero rows, sliced off
        before result mapping."""
        self.refresh()
        if len(queries) == 0:
            return []
        if not self._check_searchable(filter_folders):
            return [[] for _ in range(len(queries))]
        q_real = len(queries)
        q_host = np.asarray(queries, np.float32).reshape(q_real, -1)
        bucket = batch_bucket(q_real)
        if bucket > q_real:
            q_host = np.concatenate(
                [q_host, np.zeros((bucket - q_real, q_host.shape[1]), np.float32)]
            )
        scores, rows = topk_int8_rerank_fused_auto(
            torch.from_numpy(q_host).to(self.device), self._matrix, self._scales,
            self._rows_device, k, n_valid=self._n_valid, stats=self.shortlist_stats,
        )
        scores, rows = scores[:q_real].cpu().numpy(), rows[:q_real].cpu().numpy()
        return self._map_batch_results(scores, rows, q_real)

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
