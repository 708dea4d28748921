"""Device-resident search index (PyTorch port of ``tpuclip/index/search.py``).

``refresh`` reads the packed matrix caches (tpuclip's ``MatrixCache``,
reused) once per change of the database and uploads what the search mode
needs; every search then runs on the device. What is ported:

- **int8 precision** (the default). The resident rerank copy is kept under
  tpuclip's gate: ``TPUCLIP_DEVICE_RERANK=1`` or ``0`` forces it; ``auto``
  keeps it on CUDA while the int8 matrix plus the storage-dtype rows,
  ``(1 + itemsize) * N * D`` bytes, fit ``TPUCLIP_DEVICE_RERANK_MAX_GB``
  (default 8), and never on the CPU. With it the rows are uploaded once
  and the int8 matrix + scales derived from them on the device, and an
  unmasked search with k <= 128 is
  :func:`~tpuclip_torch.ops.topk_int8.topk_int8_rerank_fused_auto` (CUDA
  kernels 1 and 2, exact rescore against the resident rows). Without it
  only the int8 matrix and its scales, quantized from the fp32 originals,
  are on the device. Every other int8 search takes a shortlist of depth
  ``max(4k, 64)`` rescored in fp32 from the host memmap: one unmasked query
  with a shortlist <= 128 from kernel 3
  (:func:`~tpuclip_torch.ops.topk_int8.topk_int8`), the rest from kernel 1's
  scores (:func:`~tpuclip_torch.ops.topk_int8.topk_int8_scores`).
  ``TPUCLIP_SEARCH_RERANK=0`` returns the int8 scores themselves, at depth k.
- **bf16 precision** (``TPUCLIP_SEARCH_PRECISION=bf16``): the padded
  matrix is resident in ``matrix_dtype`` and every search is
  :func:`~tpuclip_torch.ops.topk.cosine_topk` (kernel 4 for unmasked k <= 128).
- **binary-only databases**: the packed sign bits are resident (1 bit per
  dimension) and searched with :func:`~tpuclip_torch.ops.hamming.binary_topk`
  (kernels 6 and 7); similarity is matches / D.
- **cascade** (``TPUCLIP_SEARCH_MODE=cascade``): no flat matrix is uploaded;
  a packed-binary prefilter (kernel 5, 6 or 7) picks a shortlist that is
  rescored in fp32 from the host memmap.
- **folder filters** (``filter_folders``) in every mode: an additive 0/-inf
  mask over the padded rows from the store's LIKE-prefix folder query,
  cached until the next refresh. Masked searches take tpuclip's routes:
  kernel 1's scores for int8, the chunked matmul for bf16, kernel 5's
  popcounts for binary rows and the cascade (an exact prefilter at depth).
- **ivf** (``TPUCLIP_SEARCH_MODE=ivf``): with the int8 rerank rows
  resident and at least 64 rows, ``refresh`` builds an IVF index on the
  device (:func:`~tpuclip_torch.index.ivf.build_ivf_device`; k-means is
  retrained once the rows grew 20% since the last training, else the
  previous centroids are reused), and every unmasked int8 search with
  k <= 128, single or batch, probes it
  (:func:`~tpuclip_torch.index.ivf.ivf_search`: kernel 1 on the probed
  buckets and the overflow block, exact rescore). Folder filters, k > 128
  and an index without the rerank rows take the exact routes. The fused
  gate is closed while an IVF index is built, so the engine's and the
  server's text and image searches reach IVF too (tpuclip's gate ignores
  IVF and serves them the exact scan).
- ``TPUCLIP_INDEX_HBM_GB`` caps the flat matrix: on CUDA always (12 GB by
  default, as tpuclip on the TPU), on the CPU only when it is set; an index
  over the cap serves from its binary rows.
- **fused query programs** (:meth:`DeviceIndex.search_fused`): token ids
  and / or the vision tower's inputs (pixels, or NaFlex's patches, masks
  and patch grids) go through the towers and the fused int8 search
  without the embedding leaving the device, under
  :meth:`~DeviceIndex.can_fuse_text_search`. On CUDA each program shape
  is one captured CUDA graph
  (:class:`~tpuclip_torch.ops.graphs.FusedGraphs`), dropped whenever
  ``refresh`` re-uploads; on the CPU they run eager.
- **shortlist methods** (``TPUCLIP_SHORTLIST``): the int8 searches with the
  rerank rows take ``exact`` for one query and ``extract`` for a batch
  unless it names ``approx`` or ``verified``. A ``verified`` search that
  fails its proof answers from the exact selection over the scores its
  program kept resident, with no second scan and, in a fused program, no
  second tower; ``shortlist_stats`` counts ``verified_queries`` and
  ``shortlist_fallbacks`` as tpuclip's, and searches per method. Every
  captured ``verified`` program writes its scores into one buffer of the
  index's.

- **mesh** (``DeviceIndex(mesh=...)``, or ``TPUCLIP_SHARDED_INDEX=1``,
  which builds ``make_mesh()`` over every local CUDA device when there is
  more than one, times the world size of an initialized process group):
  every resident array is row-sharded over the mesh's data axis, each
  shard's rows padded to the kernel tile (``tpuclip_torch.parallel``). The
  int8 matrix is quantized from the fp32 originals, as tpuclip's mesh path
  does, and the rerank rows are uploaded beside it under the gate, which
  counts per-device bytes (÷ ndev). Unmasked int8 searches with k <= 128
  take ``sharded_topk_int8_rerank`` (or ``sharded_ivf_search`` over a
  cluster-sharded IVF index built on the host, under ``ivf``), the rest
  ``sharded_topk_int8`` and the host rescore; bf16 takes
  ``sharded_topk``; binary rows and the cascade take
  ``sharded_binary_topk`` / ``sharded_binary_shortlist``. The fused gate
  stays closed, so no CUDA graph holds a sharded tensor.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tpuclip_torch.index.cache import MatrixCache
from tpuclip_torch.index.ivf import build_ivf, build_ivf_device, default_clusters, ivf_search
from tpuclip_torch.index.store import MetadataStore
from tpuclip_torch.utils.bucketing import batch_bucket
from tpuclip_torch.utils.logging import log
from tpuclip_torch.device import DeviceLike, default_dtype, resolve_device
from tpuclip_torch.ops.hamming import (
    BINARY_TILE_N,
    binary_shortlist_q1,
    binary_topk,
    binary_topk_masked,
    pack_bits_to_words,
    pad_words,
)
from tpuclip_torch.ops.graphs import FusedGraphs
from tpuclip_torch.ops.topk import DEFAULT_TILE_N, cosine_topk
from tpuclip_torch.parallel.mesh import DATA_AXIS, Mesh, make_mesh
from tpuclip_torch.parallel.sharded_ivf import shard_ivf, sharded_ivf_search
from tpuclip_torch.parallel.sharded_search import (
    ShardedTensor,
    shard_words_grouped,
    sharded_binary_shortlist,
    sharded_binary_topk,
    sharded_topk,
    sharded_topk_int8,
    sharded_topk_int8_rerank,
)
from tpuclip_torch.ops.topk_int8 import (
    INT8_TILE_N,
    derive_int8_matrix,
    fallback_shortlist_depth,
    quantize_matrix,
    quantize_queries,
    quantize_query,
    query_topk_fused,
    resolve_shortlist_method,
    topk_exact_from_scores,
    topk_int8,
    topk_int8_rerank_fused_auto,
    topk_int8_scores,
)

_UPLOAD_ROWS = 65536  # host rows converted + copied per upload step
_INT32_MIN = -(2**31)
# Largest k the fused int8 search serves, and largest shortlist kernel 3
# serves; above them the scores route does.
_FUSED_MAX_K = 128
# TPUCLIP_INDEX_HBM_GB's default on CUDA, in GB (tpuclip's on the TPU).
_INDEX_HBM_GB_DEFAULT = 12.0


def _auto_mesh(device: DeviceLike):
    """``TPUCLIP_SHARDED_INDEX=1``: tpuclip's rule, a mesh over every device
    only when there is more than one (the local CUDA devices times the
    world size of an initialized process group); the CPU is one device."""
    if resolve_device(device).type != "cuda":
        return None
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    return make_mesh() if torch.cuda.device_count() * world > 1 else None


class DeviceIndex:
    """Device-resident brute-force index over one database."""

    def __init__(
        self,
        store: MetadataStore,
        device: DeviceLike = None,
        matrix_dtype: Optional[torch.dtype] = None,
        mesh: Optional[Mesh] = None,
    ):
        self.store = store
        self.cache = MatrixCache(store)
        # Mesh-sharded index: opt-in with mesh= or TPUCLIP_SHARDED_INDEX=1;
        # the single-device behaviour is unchanged without one.
        if mesh is None and os.environ.get("TPUCLIP_SHARDED_INDEX") == "1":
            mesh = _auto_mesh(device)
        self.mesh = mesh
        self.device = mesh.lead if mesh is not None else resolve_device(device)
        self.matrix_dtype = matrix_dtype or default_dtype(self.device)
        self.precision = os.environ.get("TPUCLIP_SEARCH_PRECISION", "int8")
        if self.precision not in ("int8", "bf16"):
            raise ValueError(f"TPUCLIP_SEARCH_PRECISION must be int8 or bf16, got {self.precision!r}")
        if self.precision == "bf16" and self.device.type == "cuda" and self.matrix_dtype != torch.bfloat16:
            raise ValueError(f"the CUDA bf16 scan takes bf16 rows, got matrix_dtype {self.matrix_dtype}")
        # The int8 searches rescore their shortlist exactly unless this is 0.
        self.rerank = os.environ.get("TPUCLIP_SEARCH_RERANK", "1") != "0"
        # Resident rerank copy: 1 / 0 force it, auto decides in refresh().
        self.device_rerank = os.environ.get("TPUCLIP_DEVICE_RERANK", "auto")
        self.search_mode = os.environ.get("TPUCLIP_SEARCH_MODE", "exact")
        if self.search_mode not in ("exact", "ivf", "cascade"):
            raise ValueError(f"TPUCLIP_SEARCH_MODE must be exact, ivf or cascade, got {self.search_mode!r}")
        self._cascade = False
        self._ivf = None  # IVFIndex over _rows_device, ivf mode
        self._ivf_trained_n = 0  # rows at the last k-means training
        self._ivf_sharded = None  # the mesh's cluster-sharded IVF index
        self._ivf_sharded_trained_n = 0
        self._ids: Optional[np.ndarray] = None  # row -> image_id
        self._host_vectors = None  # fp32 memmap, row-aligned with _ids
        # Under a mesh each of these is a ShardedTensor of the same global shape.
        self._rows_device: Optional[torch.Tensor] = None  # (N, D) storage dtype, int8 mode (mesh: N_pad)
        self._matrix: Optional[torch.Tensor] = None  # (N_pad, D) int8 or matrix_dtype
        self._scales: Optional[torch.Tensor] = None  # (N_pad,) f32, int8 mode
        self._n_valid = 0
        self._bin_ids: Optional[np.ndarray] = None  # binary row -> image_id
        self._bin_matrix: Optional[torch.Tensor] = None  # (N_pad, W) int32 packed words
        self._fingerprint: Optional[Tuple[int, ...]] = None
        # Folder masks by (sorted folders, rows, padded rows); cleared by refresh().
        self._mask_cache: Dict[tuple, torch.Tensor] = {}
        # tpuclip's verified-shortlist counts, then searches per method
        # (exact_searches, extract_searches, ...) as they come.
        self.shortlist_stats: dict = {"verified_queries": 0, "shortlist_fallbacks": 0}
        # The fused programs' CUDA graphs; made at first use, dropped by refresh().
        self._graphs: Optional[FusedGraphs] = None
        # The resident scores the captured verified programs write (CUDA).
        self._scores_buf: Optional[torch.Tensor] = None

    # ---------------------------------------------------------------- loading

    def _current_fingerprint(self) -> Tuple[int, ...]:
        """(count, max_id, sum_id) of embeddings then of binary_embeddings."""
        return self.store.embeddings_fingerprint() + self.store.binary_fingerprint()

    def _upload(self, vectors, n_pad: int, device: Optional[torch.device] = None) -> torch.Tensor:
        """Host fp32 rows → (n_pad, D) ``matrix_dtype`` on ``device`` (the
        index's by default), zero rows past N, converted and copied in steps."""
        device = device or self.device
        n, d = vectors.shape
        rows = torch.zeros((n_pad, d), dtype=self.matrix_dtype, device=device)
        for s in range(0, n, _UPLOAD_ROWS):
            chunk = np.array(vectors[s : s + _UPLOAD_ROWS], np.float32)  # writable copy
            rows[s : s + len(chunk)] = torch.from_numpy(chunk).to(device)
        return rows

    def _per_shard(self, vectors, tile: int, make):
        """(rows per shard, [``make(the shard's host rows, rows per shard,
        its device)`` for each local shard]), the rows padded to the data
        axis times ``tile``: each shard gets only its own rows."""
        mesh = self.mesh
        unit = mesh.shape[DATA_AXIS] * tile
        rps = -(-len(vectors) // unit) * unit // mesh.shape[DATA_AXIS]
        starts = [mesh.shard_index(j) * rps for j in range(len(mesh.data_devices))]
        return rps, [make(vectors[lo : lo + rps], rps, dev) for lo, dev in zip(starts, mesh.data_devices)]

    def _refresh_sharded(self, vectors, n: int, prev_sharded) -> None:
        """The mesh's dense upload (tpuclip's mesh branch of ``refresh``):
        int8 quantized from the fp32 originals per shard, and the rerank
        rows beside it under the gate; then, under ``ivf``, the host IVF
        build (centroids reused under the growth threshold) resharded by
        cluster with the rows embedded; bf16 rows otherwise."""
        mesh = self.mesh
        if self.precision != "int8":
            rps, rows = self._per_shard(vectors, DEFAULT_TILE_N, self._upload)
            self._matrix = ShardedTensor(rows, rps, mesh)
            return
        rps, int8 = self._per_shard(vectors, INT8_TILE_N, quantize_matrix)
        self._matrix = ShardedTensor([m for m, _ in int8], rps, mesh)
        self._scales = ShardedTensor([sc for _, sc in int8], rps, mesh)
        if not (self.rerank and self._want_device_rerank(n)):
            return
        self._rows_device = ShardedTensor(self._per_shard(vectors, INT8_TILE_N, self._upload)[1], rps, mesh)
        if self.search_mode != "ivf" or n < 64:
            return
        trained = self._ivf_sharded_trained_n
        prev_cent = None
        if (prev_sharded is not None and trained and n >= trained
                and (n - trained) / trained < self._IVF_RETRAIN_GROWTH):
            prev_cent = prev_sharded.centroids[0][: prev_sharded.k_real].cpu().numpy()
        ivf_host = build_ivf(np.asarray(vectors, np.float32), centroids=prev_cent, device=self.device)
        self._ivf_sharded = shard_ivf(ivf_host, vectors, self.mesh, dtype=self.matrix_dtype)
        if prev_cent is None:
            self._ivf_sharded_trained_n = n
        log(
            f"  sharded IVF index built: {ivf_host.centroids.shape[0]} buckets over "
            f"{self.mesh.shape[DATA_AXIS]} devices, nprobe {ivf_host.nprobe}"
        )

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
        # No path out of here may keep an IVF index over the previous rows'
        # numbering; the previous one is kept only to reuse its centroids.
        prev_ivf, self._ivf = self._ivf, None
        prev_sharded, self._ivf_sharded = self._ivf_sharded, None
        # The graphs hold the old tensors' pointers and n_valid, so each
        # program shape is captured again at its next call (tpuclip passes
        # both to its jitted programs as arguments and recompiles nothing).
        if self._graphs:
            log(f"  [index] re-upload dropped {len(self._graphs)} CUDA graphs")
        self._graphs = self._scores_buf = None
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
        if len(ids) and not self._cascade and self.mesh is not None:
            self._refresh_sharded(vectors, len(ids), prev_sharded)
            self._n_valid = len(ids)
        elif len(ids) and not self._cascade:
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
                if self.rerank and self._want_device_rerank(len(ids)):
                    self._rows_device = self._upload(vectors, len(ids))
                    self._matrix, self._scales = derive_int8_matrix(self._rows_device, n_pad)
                else:
                    # The host route: the int8 matrix from the fp32 originals.
                    self._matrix, self._scales = quantize_matrix(vectors, n_pad, self.device)
                self._n_valid = len(ids)
                if self._rows_device is not None and self.search_mode == "ivf" and len(ids) >= 64:
                    self._ivf = self._build_ivf_resident(prev_ivf, len(ids))
                    log(
                        f"  IVF index built: {self._ivf.centroids.shape[0]} buckets, nprobe "
                        f"{self._ivf.nprobe}, overflow {int((self._ivf.over_rows >= 0).sum()):,} rows"
                    )
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
            if self.mesh is not None:
                # Row blocks of a tile-aligned size, one a shard: binary
                # search and the cascade share them (tpuclip keeps two layouts).
                self._bin_matrix, _, _ = shard_words_grouped(words.view(np.int32), self.mesh)
            else:
                padded, _ = pad_words(torch.from_numpy(words.view(np.int32)), BINARY_TILE_N)
                self._bin_matrix = padded.to(self.device)
        self._fingerprint = fp
        self._mask_cache.clear()
        if len(ids) or len(bin_ids):
            log(
                f"  Index resident on {self.device}: {len(ids):,} full vectors, "
                f"{len(bin_ids):,} binary rows"
            )

    # The centroids are retrained once the rows grew by this fraction since
    # the last training; below it a rebuild reuses them (one assignment pass).
    _IVF_RETRAIN_GROWTH = 0.2

    def _build_ivf_resident(self, prev_ivf, n_rows: int):
        """Build the IVF index from the resident rows, reusing
        ``prev_ivf``'s centroids while the rows grew less than
        ``_IVF_RETRAIN_GROWTH`` since the last training (not the last build,
        so steady growth below the threshold cannot compound forever)."""
        trained = self._ivf_trained_n
        reuse = bool(
            prev_ivf is not None and trained and n_rows >= trained
            and (n_rows - trained) / trained < self._IVF_RETRAIN_GROWTH
        )
        centroids = prev_ivf.centroids if reuse else None
        ivf = build_ivf_device(
            self._rows_device,
            k_clusters=centroids.shape[0] if reuse else None,
            centroids=centroids,
        )
        if not reuse:
            self._ivf_trained_n = n_rows
        return ivf

    @staticmethod
    def _ivf_footprint_bytes(n_rows: int, d: int, capacity_factor: float = 1.5) -> int:
        """tpuclip's estimate of an IVF build's resident bytes: int8 buckets
        at ``capacity_factor`` x the flat int8 matrix, a scale and a row id
        per slot, and the centroids."""
        slots = int(n_rows * capacity_factor)
        return slots * d + slots * 8 + default_clusters(max(n_rows, 1)) * d * 4

    def _flat_matrix_fits(self, n_rows: int) -> bool:
        """tpuclip's capacity gate for the flat matrix, with CUDA in the
        TPU's place: on CUDA it always applies, with a 12 GB default (a
        default sized to the 80 GB card waits for a measurement); on the CPU
        only when ``TPUCLIP_INDEX_HBM_GB`` is set. A malformed value logs a
        warning and takes the default. The cap covers the scan matrix
        itself."""
        env = os.environ.get("TPUCLIP_INDEX_HBM_GB")
        if env is None and self.device.type != "cuda":
            return True
        try:
            cap = float(env) if env is not None else _INDEX_HBM_GB_DEFAULT
        except ValueError:
            log(f"  [WARNING] ignoring malformed TPUCLIP_INDEX_HBM_GB={env!r}")
            cap = _INDEX_HBM_GB_DEFAULT
        itemsize = 1 if self.precision == "int8" else torch.finfo(self.matrix_dtype).bits // 8
        return n_rows * self.store.embedding_dim * itemsize / 1e9 <= cap

    def _want_device_rerank(self, n_rows: int) -> bool:
        """tpuclip's device-rerank gate: TPUCLIP_DEVICE_RERANK=1 / 0 force
        it; under auto, CUDA (tpuclip's TPU) and the int8 matrix plus the
        storage-dtype rows, plus the IVF blocks in the ivf mode, under
        TPUCLIP_DEVICE_RERANK_MAX_GB (default 8, as tpuclip's; a default
        sized to the card waits for a measurement)."""
        if self.device_rerank == "0":
            return False
        if self.device_rerank == "1":
            return True
        if self.device.type != "cuda":
            return False
        itemsize = torch.finfo(self.matrix_dtype).bits // 8
        d = self.store.embedding_dim
        ndev = self.mesh.shape[DATA_AXIS] if self.mesh is not None else 1
        # Per-device bytes: under a mesh the matrix and the rows shard.
        total_bytes = n_rows * d * (1 + itemsize) / ndev
        if self.search_mode == "ivf":
            # The IVF blocks live beside the int8 matrix and the rows; the
            # mesh's embeds a storage-dtype row per bucket slot besides.
            extra = self._ivf_footprint_bytes(n_rows, d)
            if self.mesh is not None:
                extra += int(n_rows * 1.5) * d * itemsize
            total_bytes += extra / ndev
        budget = float(os.environ.get("TPUCLIP_DEVICE_RERANK_MAX_GB", "8"))
        return total_bytes / 1e9 <= budget

    @property
    def num_full(self) -> int:
        return 0 if self._ids is None else len(self._ids)

    @property
    def num_binary(self) -> int:
        return 0 if self._bin_ids is None else len(self._bin_ids)

    def resident_bytes(self) -> int:
        """Bytes of the index's tensors on the device (masks aside); under a
        mesh, of every local shard."""
        tensors = (self._rows_device, self._matrix, self._scales, self._bin_matrix)
        ivf = sum(x.nbytes() for x in (self._ivf, self._ivf_sharded) if x is not None)
        return ivf + sum(
            t.nbytes() if isinstance(t, ShardedTensor) else t.numel() * t.element_size()
            for t in tensors if t is not None
        )

    # ----------------------------------------------------------------- masks

    def _folder_mask(
        self, filter_folders: Sequence[str], row_ids: np.ndarray, padded_n: int
    ) -> torch.Tensor:
        """(padded_n,) f32 additive mask on the device: 0 for the rows whose
        image lies under one of ``filter_folders``, -inf for every other
        row and the padding."""
        key = tuple(sorted(filter_folders)) + (len(row_ids), padded_n)
        cached = self._mask_cache.get(key)
        if cached is not None:
            return cached
        allowed = self.store.folder_filter_ids(filter_folders)
        allowed_arr = np.fromiter(allowed, dtype=np.int64, count=len(allowed))
        keep = np.zeros((padded_n,), bool)
        keep[: len(row_ids)] = np.isin(row_ids, allowed_arr)
        mask = torch.from_numpy(np.where(keep, 0.0, -np.inf).astype(np.float32)).to(self.device)
        self._mask_cache[key] = mask
        return mask

    # ---------------------------------------------------------------- search

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
        q2d = np.asarray(query, np.float32).reshape(1, -1)
        if self._cascade_ready():
            return self._search_cascade(q2d, k, filter_folders)[0]
        if self._matrix is not None:
            return self._map_batch_results(*self._search_dense(q2d, k, filter_folders, single=True), 1)[0]
        if self._bin_matrix is not None:
            return self._search_binary(q2d, k, filter_folders)[0]
        return []

    def search_batch(
        self,
        queries: np.ndarray,
        k: int,
        filter_folders: Optional[Sequence[str]] = None,
    ) -> List[List[Tuple[str, float]]]:
        """Top-k for Q queries in one pass over the matrix. On the flat
        matrix and in the cascade the query count is padded to the {1, 4,
        16, 64} ladder with zero rows, sliced off before result mapping
        (tpuclip's cascade returns ahead of its bucketing)."""
        self.refresh()
        if len(queries) == 0:
            return []
        q_real = len(queries)
        q_host = np.asarray(queries, np.float32).reshape(q_real, -1)
        cascade = self._cascade_ready()
        if self._matrix is None and not cascade:
            if self._bin_matrix is not None:
                return self._search_binary(q_host, k, filter_folders)
            return [[] for _ in range(q_real)]
        bucket = batch_bucket(q_real)
        if bucket > q_real:
            q_host = np.concatenate(
                [q_host, np.zeros((bucket - q_real, q_host.shape[1]), np.float32)]
            )
        if cascade:
            return self._search_cascade(q_host, k, filter_folders, q_real)
        scores, rows = self._search_dense(q_host, k, filter_folders)
        return self._map_batch_results(scores[:q_real], rows[:q_real], q_real)

    def _search_dense(self, q_host: np.ndarray, k: int, filter_folders, single: bool = False):
        """(Q, D) queries over the flat matrix → host ((Q, k) scores, (Q, k)
        rows), by tpuclip's branches (``_search_full`` for one query,
        ``search_batch`` for a batch):

        - bf16: :func:`cosine_topk` with the mask;
        - int8 with an IVF index, no mask, k <= 128: :func:`ivf_search`;
        - int8 with the resident rows, no mask, k <= 128: the fused search;
        - otherwise an int8 shortlist of ``k_short`` = max(4k, 64) rows (k
          without the rescore): for one unmasked query with k_short <= 128
          kernel 3, host-quantized; else kernel 1's scores with the mask;
          then the fp32 rescore from the host memmap, even with the rows
          resident."""
        mask = (
            self._folder_mask(filter_folders, self._ids, self._matrix.shape[0])
            if filter_folders
            else None
        )
        q = torch.from_numpy(q_host).to(self.device)
        if self.mesh is not None:
            return self._search_dense_mesh(q_host, q, k, mask, single)
        if self.precision == "bf16":
            s, r = cosine_topk(q, self._matrix, k, n_valid=self._n_valid, mask=mask)
            return s.cpu().numpy(), r.cpu().numpy()
        if mask is None and self._ivf is not None and k <= _FUSED_MAX_K:
            s, r = ivf_search(self._ivf, self._rows_device, q, k)
            return s.cpu().numpy(), r.cpu().numpy()
        if mask is None and self._rows_device is not None and k <= _FUSED_MAX_K:
            s, r = topk_int8_rerank_fused_auto(
                q, self._matrix, self._scales, self._rows_device, k,
                n_valid=self._n_valid, stats=self.shortlist_stats,
            )
            return s.cpu().numpy(), r.cpu().numpy()
        k_short = max(4 * k, 64) if self.rerank else k
        if single:
            qi, qs = quantize_query(q_host)
            qi = qi.to(self.device)
            if mask is None and k_short <= _FUSED_MAX_K:
                s, r = topk_int8(qi, self._matrix, self._scales, qs, k_short, self._n_valid)
            else:
                s, r = topk_int8_scores(qi, self._matrix, self._scales, qs, k_short, self._n_valid, mask)
        else:
            qi, qs = quantize_queries(q)
            s, r = topk_int8_scores(qi, self._matrix, self._scales, qs, k_short, self._n_valid, mask)
        s, r = s.cpu().numpy(), r.cpu().numpy()
        if self.rerank:
            return self._exact_rerank_batch(q_host, s, r, k)
        return s, r

    def _search_dense_mesh(self, q_host: np.ndarray, q: torch.Tensor, k: int, mask, single: bool):
        """:meth:`_search_dense` under a mesh, by tpuclip's mesh branches:
        bf16 ``sharded_topk``; int8 unmasked with k <= 128 the sharded IVF
        or ``sharded_topk_int8_rerank``; the rest ``sharded_topk_int8`` at
        depth max(4k, 64) (one query host-quantized, a batch on the device)
        and the fp32 rescore from the host memmap."""
        mesh, n_valid = self.mesh, self._n_valid
        if self.precision == "bf16":
            s, r = sharded_topk(q, self._matrix, k, mesh, n_valid, mask=mask)
        elif mask is None and self._ivf_sharded is not None and k <= _FUSED_MAX_K:
            s, r = sharded_ivf_search(self._ivf_sharded, q, k)
        elif mask is None and self._rows_device is not None and k <= _FUSED_MAX_K:
            s, r = sharded_topk_int8_rerank(q, self._matrix, self._scales, self._rows_device, k, mesh, n_valid)
        else:
            do_rerank = self.rerank and self._host_vectors is not None
            k_short = max(4 * k, 64) if do_rerank else k
            qi, qs = quantize_query(q_host) if single else quantize_queries(q)
            s, r = sharded_topk_int8(qi, self._matrix, self._scales, qs, k_short, mesh, n_valid, mask=mask)
            if do_rerank:
                return self._exact_rerank_batch(q_host, s.cpu().numpy(), r.cpu().numpy(), k)
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

    # ----------------------------------------------------------------- fused

    def can_fuse_text_search(self, k: int, filter_folders, assume_fresh: bool = False) -> bool:
        """True when tower → int8 scan → exact rescore can run as one fused
        program for this index state: int8 precision, the int8 matrix and
        the rerank rows resident, no IVF index, no folder filter, k <= 128.
        This is tpuclip's gate with one difference: tpuclip's ignores IVF,
        so under ``--mode ivf`` its fused entry points scan every row while
        its ``search`` probes the buckets; here every entry point probes
        them. ``assume_fresh`` skips the implicit refresh, for a caller
        that just refreshed under the same lock."""
        if not assume_fresh:
            self.refresh()
        return (
            not filter_folders
            and self.precision == "int8"
            and self._matrix is not None
            and self._rows_device is not None
            and self._ivf is None
            and self.mesh is None
            and k <= _FUSED_MAX_K
        )

    # Fusion is a property of the index state, not of the tower feeding it.
    can_fuse_image_search = can_fuse_text_search

    def _program(self, key: tuple, program, host_inputs, tail=None):
        """Runs one fused program through the index's CUDA graphs (eager on
        the CPU): host arrays in, host ((Q, k) scores, (Q, k) rows) out, or
        what ``tail`` makes of the device outputs."""
        if self._graphs is None:
            self._graphs = FusedGraphs(self.device)
        return self._graphs.run(key, program, host_inputs, tail)

    def _scores_buffer(self, q_count: int) -> Optional[torch.Tensor]:
        """A (q_count, N_pad) f32 view of the resident scores buffer that the
        captured ``verified`` programs write kernel 1's scores into, one for
        every graph of the index (None on the CPU, where each eager run
        makes its own). It grows to the next power of two of the largest
        block asked for; a graph captured before keeps its smaller buffer
        alive, so all of them together stay under twice the largest."""
        if self.device.type != "cuda":
            return None
        if self._scores_buf is None or self._scores_buf.shape[0] < q_count:
            rows = 1 << (q_count - 1).bit_length()
            self._scores_buf = torch.empty(
                (rows, self._matrix.shape[0]), dtype=torch.float32, device=self.device
            )
        return self._scores_buf[:q_count]

    def search_fused(self, model, text_inputs, image_inputs, k: int, n_texts: int, n_images: int):
        """A block of queries through ONE fused program
        (:func:`~tpuclip_torch.ops.topk_int8.query_topk_fused`): host
        ``text_inputs`` () or (ids, mask) of Tb ladder-padded texts, and
        ``image_inputs`` () or the vision tower's Ib rows in ``model``'s
        format, as the graph ``(Tb, Ib, k, method)``. Results for the real
        queries only, texts first, then images (a mixed block pads each span
        to its bucket). The shortlist method is the block's
        (:func:`~tpuclip_torch.ops.topk_int8.resolve_shortlist_method`) and
        the resident tensors are bound at call time. Under ``verified`` the
        program keeps its scores and query embedding on the device, and when
        its proof fails the exact selection over those scores answers
        (tpuclip's fallback), read under the graph runner's lock before
        another replay can overwrite them; only the results come to the
        host. Caller must have checked :meth:`can_fuse_text_search`."""
        tb = len(text_inputs[0]) if text_inputs else 0
        ib = len(image_inputs[0]) if image_inputs else 0
        n_text_arrays = len(text_inputs)
        method = resolve_shortlist_method(tb + ib)
        stats = self.shortlist_stats
        stats[f"{method}_searches"] = stats.get(f"{method}_searches", 0) + 1
        m, sc, rows, n_valid = self._matrix, self._scales, self._rows_device, self._n_valid
        verified = method == "verified"
        buf = self._scores_buffer(tb + ib) if verified else None

        def fallback_tail(outputs):
            s, r, ok, scores, emb = outputs
            if not bool(ok):
                stats["shortlist_fallbacks"] += 1
                depth = fallback_shortlist_depth(k, scores.shape[1])
                s, r = topk_exact_from_scores(scores, emb, rows, k, depth)
            return s.cpu().numpy(), r.cpu().numpy()

        if verified:
            stats["verified_queries"] += 1
        scores, found = self._program(
            (tb, ib, k, method),
            lambda *x: query_topk_fused(
                model, x[:n_text_arrays], x[n_text_arrays:], m, sc, rows, k, n_valid,
                shortlist_method=method, keep_scores=verified, scores_out=buf,
            ),
            (*text_inputs, *image_inputs),
            fallback_tail if verified else None,
        )
        row_sel = list(range(n_texts)) + list(range(tb, tb + n_images))
        return self._map_batch_results(scores[row_sel], found[row_sel], len(row_sel))

    # ---------------------------------------------------------------- binary

    def _query_words(self, queries_2d: np.ndarray) -> torch.Tensor:
        """Sign-pack (Q, D) queries into (Q, W) int32 words on the device."""
        words = pack_bits_to_words((queries_2d >= 0).astype(np.uint8)).view(np.int32)
        return torch.from_numpy(np.ascontiguousarray(words)).to(self.device)

    def _binary_mask(self, filter_folders) -> Optional[torch.Tensor]:
        if not filter_folders:
            return None
        return self._folder_mask(filter_folders, self._bin_ids, self._bin_matrix.shape[0])

    def _search_binary(self, queries_2d: np.ndarray, k: int, filter_folders) -> List[List[Tuple[str, float]]]:
        """Binary-only search: one :func:`binary_topk` call for the whole
        batch (tpuclip loops over the queries), or
        :func:`binary_topk_masked` under a folder filter; similarity =
        matches / D."""
        qwords = self._query_words(queries_2d)
        mask = self._binary_mask(filter_folders)
        matches, rows = self._binary_topk_any(qwords, k, mask)
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

    def _binary_topk_any(self, qwords: torch.Tensor, k: int, mask: Optional[torch.Tensor]):
        """Exact binary top-k on the resident words: kernels 6 / 7 (5 under
        a mask), per shard under a mesh."""
        n_valid = len(self._bin_ids)
        if self.mesh is not None:
            return sharded_binary_topk(qwords, self._bin_matrix, k, self.mesh, n_valid, mask=mask)
        if mask is None:
            return binary_topk(qwords, self._bin_matrix, k, n_valid)
        return binary_topk_masked(qwords, self._bin_matrix, k, n_valid, mask)

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

    def _cascade_prefilter(self, qwords: torch.Tensor, depth: int, mask: Optional[torch.Tensor]):
        """The packed-binary prefilter: ((Q, m) f32 matches with -inf
        invalid, (Q, m) rows) on the host.

        One unmasked query takes the scores route (kernel 5, then the exact
        top min(2 * depth, N)) under TPUCLIP_CASCADE_PREFILTER=scores, and
        under auto on CUDA (tpuclip's TPU rule); a masked search takes
        :func:`binary_topk_masked` at ``depth``, and every other case
        :func:`binary_topk` at ``depth`` (kernel 6 or 7)."""
        mode = os.environ.get("TPUCLIP_CASCADE_PREFILTER", "auto")
        eligible = mask is None and qwords.shape[0] == 1 and (
            mode == "scores" or (mode == "auto" and self.device.type == "cuda")
        )
        n_valid = len(self._bin_ids)
        if eligible:
            m = min(2 * depth, n_valid)
            if self.mesh is not None:
                s, i = sharded_binary_shortlist(
                    qwords, self._bin_matrix, m, self.mesh, n_valid, self._bin_matrix.rows_per_shard
                )
            else:
                s, i = binary_shortlist_q1(qwords, self._bin_matrix, m, n_valid)
            return s.cpu().numpy(), i.cpu().numpy()
        matches, rows = self._binary_topk_any(qwords, depth, mask)
        matches = matches.cpu().numpy().astype(np.float32)
        # INT32_MIN marks rows past n_valid and masked rows: -inf for the rescore.
        matches[matches <= _INT32_MIN + 1] = -np.inf
        return matches, rows.cpu().numpy()

    def _search_cascade(
        self, queries_2d: np.ndarray, k: int, filter_folders, q_count: Optional[int] = None
    ) -> List[List[Tuple[str, float]]]:
        """Packed-binary prefilter + exact fp32 rescore from the host memmap:
        results for the first ``q_count`` queries (all by default; the rest
        are ladder pad rows, dropped before the rescore)."""
        q_count = len(queries_2d) if q_count is None else q_count
        matches, rows = self._cascade_prefilter(
            self._query_words(queries_2d), self._cascade_depth(k), self._binary_mask(filter_folders)
        )
        scores, out_rows = self._exact_rerank_batch(
            queries_2d[:q_count], matches[:q_count], rows[:q_count], k
        )
        return self._map_batch_results(scores, out_rows, q_count)
