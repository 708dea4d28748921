"""Packed embedding-matrix cache.

sqlite-vec re-scans BLOB rows inside SQLite on every query
(image_database.py:1564-1574). TPU-native replacement: embeddings live in a
packed on-disk matrix that memory-maps instantly and uploads to device HBM
once per session; queries are then a single fused matmul+top-k on device.

Layout, per database ``<db>.cache/``:
    vectors.f32   raw little-endian float32, shape (n, dim), image_id order
    ids.i64       raw int64 image_ids, ascending
    bits.u8       packed sign bits, shape (n, ceil(dim / 8)) (np.packbits)
    manifest.json {"count": n, "max_image_id": m, "dim": d, "version": 1}

The cache is append-only-refreshable: new rows committed since the manifest
stamp are appended from SQLite; any other mismatch — including data files
whose SIZE disagrees with the manifest (a crash between append and manifest
write) — triggers a full rebuild. Refresh holds an flock on
``refresh.lock`` so concurrent PROCESSES (serve + CLI on one DB) cannot
interleave appends.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from tpuclip_torch.index.store import MetadataStore
from tpuclip_torch.utils.logging import log

_VERSION = 1


class MatrixCache:
    def __init__(self, store: MetadataStore, cache_dir: Optional[str] = None):
        self.store = store
        self.cache_dir = Path(cache_dir) if cache_dir else Path(str(store.db_path) + ".cache")

    # ----------------------------------------------------------------- paths

    @property
    def _manifest_path(self) -> Path:
        return self.cache_dir / "manifest.json"

    def _read_manifest(self) -> Optional[dict]:
        try:
            with open(self._manifest_path, "r", encoding="utf-8") as f:
                m = json.load(f)
            if m.get("version") != _VERSION:
                return None
            return m
        except (OSError, json.JSONDecodeError):
            return None

    def _write_manifest(self, dim: int, full_fp, bin_fp) -> None:
        tmp = self._manifest_path.with_suffix(".tmp")
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(
                {
                    "version": _VERSION,
                    "dim": dim,
                    "count": full_fp[0],
                    "max_image_id": full_fp[1],
                    "sum_image_id": full_fp[2],
                    "bin_count": bin_fp[0],
                    "bin_max_image_id": bin_fp[1],
                    "bin_sum_image_id": bin_fp[2],
                },
                f,
            )
        os.replace(tmp, self._manifest_path)

    # ------------------------------------------------------------------ load

    def load(self, refresh: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        """Return (ids[int64, n], vectors[float32 memmap, (n, dim)]),
        refreshing the cache from SQLite if stale (pass ``refresh=False``
        when the caller already ran :meth:`refresh` this round — the
        staleness check is two full-table aggregate scans)."""
        if refresh:
            self.refresh()
        m = self._read_manifest()
        if m is None or m["count"] == 0:
            dim = self.store.embedding_dim
            return np.empty((0,), np.int64), np.empty((0, dim), np.float32)
        n, dim = m["count"], m["dim"]
        ids = np.fromfile(self.cache_dir / "ids.i64", dtype=np.int64, count=n)
        vectors = np.memmap(
            self.cache_dir / "vectors.f32", dtype=np.float32, mode="r", shape=(n, dim)
        )
        return ids, vectors

    def load_binary(self, refresh: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        """Return (ids[int64, n], packed_bits[uint8 memmap, (n, ceil(dim/8))])."""
        if refresh:
            self.refresh()
        m = self._read_manifest()
        dim = self.store.embedding_dim
        if m is None or m.get("bin_count", 0) == 0:
            return np.empty((0,), np.int64), np.empty((0, -(-dim // 8)), np.uint8)
        n = m["bin_count"]
        dim = m["dim"]
        ids = np.fromfile(self.cache_dir / "bin_ids.i64", dtype=np.int64, count=n)
        # ceil(dim/8): np.packbits pads the last byte — dim//8 would map a
        # PREFIX of each longer row and shift every row after the first.
        bits = np.memmap(
            self.cache_dir / "bits.u8", dtype=np.uint8, mode="r",
            shape=(n, -(-dim // 8)),
        )
        return ids, bits

    # --------------------------------------------------------------- refresh

    def _files_match(self, m: Optional[dict]) -> bool:
        """True when every data file's SIZE equals what the manifest
        implies. Existence alone is not enough: a crash between the tail
        append and the manifest write leaves files LONGER than the stamp,
        and appending onto them would permanently scramble the row
        mapping (the next manifest would then match the DB fingerprint, so
        nothing downstream could ever detect it)."""
        if m is None:
            return False
        row_bytes = -(-m["dim"] // 8)
        expected = {
            "vectors.f32": m["count"] * m["dim"] * 4,
            "ids.i64": m["count"] * 8,
            "bits.u8": m.get("bin_count", 0) * row_bytes,
            "bin_ids.i64": m.get("bin_count", 0) * 8,
        }
        try:
            return all(
                (self.cache_dir / name).stat().st_size == size
                for name, size in expected.items()
            )
        except OSError:
            return False

    def _is_fresh(self, full_fp, bin_fp, m: Optional[dict], dim: int) -> bool:
        return (
            m is not None
            and self._files_match(m)
            and m["dim"] == dim
            and (m["count"], m["max_image_id"], m.get("sum_image_id")) == full_fp
            and (m.get("bin_count"), m.get("bin_max_image_id"), m.get("bin_sum_image_id"))
            == bin_fp
        )

    def refresh(self, full_fp=None, bin_fp=None) -> bool:
        """Bring the cache up to date with SQLite. ``full_fp``/``bin_fp``
        accept precomputed table fingerprints so a caller that already
        scanned them (DeviceIndex.refresh) doesn't pay the aggregates
        again. Returns True iff this call wrote the data files (appended
        or rebuilt) — False when the cache was already fresh, including
        the case where a concurrent process did the work while we waited
        on the refresh lock."""
        if full_fp is None:
            full_fp = self.store.embeddings_fingerprint()  # (count, max, sum)
        if bin_fp is None:
            bin_fp = self.store.binary_fingerprint()
        m = self._read_manifest()
        dim = self.store.embedding_dim
        if self._is_fresh(full_fp, bin_fp, m, dim):
            return False

        self.cache_dir.mkdir(parents=True, exist_ok=True)
        # Cross-PROCESS exclusion: a serve and a CLI refreshing one cache
        # concurrently would interleave their appends across the data files
        # and scramble the id<->vector pairing. flock is advisory but both
        # writers are tpuclip.
        lock_file = open(self.cache_dir / "refresh.lock", "w")
        try:
            try:
                import fcntl

                fcntl.flock(lock_file, fcntl.LOCK_EX)
            except (ImportError, OSError):
                pass  # non-POSIX: in-process callers still serialize upstream
            # Re-check under the lock: the process we waited on may have
            # done this exact refresh.
            m = self._read_manifest()
            if self._is_fresh(full_fp, bin_fp, m, dim):
                return False
            self._refresh_locked(full_fp, bin_fp, m, dim)
            return True
        finally:
            lock_file.close()

    def _refresh_locked(self, full_fp, bin_fp, m, dim) -> None:
        # Append-only refresh is valid only if every change since the manifest
        # is strictly new rows past the old max id — proven by comparing the
        # tail (count, id-sum) against the fingerprint deltas. A modified file
        # deletes+reinserts (id churn), which fails this check and forces a
        # full rebuild.
        appendable = False
        start_id = bin_start_id = 0
        if (
            m is not None
            and m["dim"] == dim
            and m.get("sum_image_id") is not None
            and self._files_match(m)
        ):
            start_id = m["max_image_id"]
            bin_start_id = m.get("bin_max_image_id", 0)
            tail_c, tail_s = self.store.tail_fingerprint("embeddings", start_id)
            btail_c, btail_s = self.store.tail_fingerprint("binary_embeddings", bin_start_id)
            appendable = (
                m["count"] + tail_c == full_fp[0]
                and m["sum_image_id"] + tail_s == full_fp[2]
                and m.get("bin_count", 0) + btail_c == bin_fp[0]
                and m.get("bin_sum_image_id", 0) + btail_s == bin_fp[2]
            )

        if appendable:
            mode = "ab"
        else:
            start_id = bin_start_id = 0
            mode = "wb"
            for name in ("vectors.f32", "ids.i64", "bits.u8", "bin_ids.i64"):
                p = self.cache_dir / name
                if p.exists():
                    p.unlink()

        # The manifest must describe what the files actually contain, so the
        # fingerprint is accumulated from the rows written — not the pre-scan
        # table fingerprint. Rows committed while we stream would otherwise
        # land in the files but not in the manifest, and the next append-only
        # refresh would write them a second time (latent duplication that
        # corrupts the id/vector pairing once further rows are appended).
        new_rows, new_sum, new_max = 0, 0, start_id
        with open(self.cache_dir / "vectors.f32", mode) as vf, open(
            self.cache_dir / "ids.i64", mode
        ) as idf:
            for ids, vecs in self.store.iter_embeddings(min_image_id=start_id):
                vf.write(np.ascontiguousarray(vecs, dtype=np.float32).tobytes())
                idf.write(ids.tobytes())
                new_rows += len(ids)
                new_sum += int(ids.sum())
                new_max = max(new_max, int(ids.max()))

        bin_rows, bin_sum, bin_max = 0, 0, bin_start_id
        with open(self.cache_dir / "bits.u8", mode) as bf, open(
            self.cache_dir / "bin_ids.i64", mode
        ) as bidf:
            for ids, bits in self.store.iter_binary_embeddings(min_image_id=bin_start_id):
                packed = np.packbits(bits.astype(np.uint8), axis=1)
                bf.write(np.ascontiguousarray(packed).tobytes())
                bidf.write(ids.tobytes())
                bin_rows += len(ids)
                bin_sum += int(ids.sum())
                bin_max = max(bin_max, int(ids.max()))

        if appendable:
            prior = (m["count"], m["sum_image_id"])
            bin_prior = (m.get("bin_count", 0), m.get("bin_sum_image_id", 0))
        else:
            prior = bin_prior = (0, 0)
        full_stamp = (prior[0] + new_rows, new_max, prior[1] + new_sum)
        bin_stamp = (bin_prior[0] + bin_rows, bin_max, bin_prior[1] + bin_sum)

        if new_rows or bin_rows or m is None:
            log(
                f"  Matrix cache refreshed: +{new_rows} vectors, +{bin_rows} binary rows "
                f"({full_stamp[0]:,} total)"
            )
        self._write_manifest(dim, full_stamp, bin_stamp)
