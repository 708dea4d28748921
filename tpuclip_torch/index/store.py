"""SQLite metadata store.

The reference keeps everything in SQLite: metadata in ``images``, float vectors
in the sqlite-vec ``vec0`` virtual table, and sign bits in
``binary_embeddings`` (image_database.py:245-344). TPU-native redesign:

- ``images`` keeps the exact reference schema (image_database.py:275-283) so
  resume semantics and external tooling carry over unchanged.
- Float embeddings live in a plain ``embeddings`` BLOB table (no C extension
  needed) and are *served* from a packed matrix cache uploaded to device HBM
  (see tpuclip.index.cache / tpuclip.index.search) — SQLite never scans
  vectors at query time.
- ``binary_embeddings`` keeps the reference's on-disk format: one byte per
  bit, ``(e >= 0).astype(uint8)`` (image_database.py:1189-1198), so databases
  stay interchangeable at the blob level.

The DB *is* the checkpoint: commits are idempotent (INSERT OR REPLACE plus
per-row existence checks, image_database.py:1108-1148), batched, and retried
on lock with linear backoff (image_database.py:1084-1096). WAL mode allows a
reader during a scan (image_database.py:253).
"""

from __future__ import annotations

import os
import sqlite3
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np

from tpuclip_torch.utils.logging import log, safe_print_path

EMBEDDING_DIM = 1152  # SigLIP2 SO400M (image_database.py:235)


def _quantize_int8_blob(vec: np.ndarray) -> bytes:
    """Per-vector symmetric int8 blob: dim int8 values + one trailing fp32
    scale (little-endian), dim+4 bytes total.

    The formula MUST match ops/topk_int8.quantize_matrix_t (scale =
    max|v|/127, zero vectors get scale 1.0) so that a database stored int8
    produces bit-identical device scan matrices to one stored fp32 and
    quantized at load time (asserted by tests/test_storage_features.py).
    Kept inline so the store never imports jax."""
    v = np.asarray(vec, np.float32).reshape(-1)
    scale = np.float32(np.abs(v).max() / 127.0)
    if scale == 0:
        scale = np.float32(1.0)
    q = np.clip(np.rint(v / scale), -127, 127).astype(np.int8)
    return q.tobytes() + scale.tobytes()


def connect(
    db_path: str, timeout: float = 30.0, check_same_thread: bool = True
) -> sqlite3.Connection:
    """Open a connection with WAL enabled (image_database.py:248-253).

    ``check_same_thread=False`` is for connections used by exactly one thread
    but *closed* from another (e.g. a generator's finally clause running at
    GC time) — not a license for concurrent cross-thread use.
    """
    conn = sqlite3.connect(
        db_path, timeout=timeout, check_same_thread=check_same_thread
    )
    conn.execute("PRAGMA journal_mode=WAL")
    return conn


class MetadataStore:
    """Schema management + read/write paths for one image database."""

    def __init__(
        self,
        db_path: str,
        embedding_dim: int = EMBEDDING_DIM,
        vector_dtype: Optional[str] = None,
    ):
        self.db_path = str(db_path)
        self.embedding_dim = embedding_dim
        # "fp32" (default, reference-compatible), "fp16" (half the DB size),
        # or "int8" (quarter: per-vector symmetric int8 + a trailing fp32
        # scale, dim+4 bytes/row — the same quantization the TPU search path
        # derives on device, so int8-stored and fp32-stored databases search
        # identically under the default int8 scan). Readers detect per-row by
        # blob length, so mixed DBs stay valid.
        self.vector_dtype = (
            vector_dtype or os.environ.get("TPUCLIP_VECTOR_DTYPE", "fp32")
        ).lower()
        if self.vector_dtype not in ("fp32", "fp16", "int8"):
            raise ValueError(
                f"vector_dtype must be fp32, fp16, or int8, got {self.vector_dtype}"
            )
        if self.vector_dtype == "int8" and embedding_dim == 4:
            # The only dim where the int8 blob length (d+4) collides with
            # the fp16 length (2d), breaking per-row dtype detection.
            raise ValueError("int8 vector storage requires embedding_dim != 4")

    # ------------------------------------------------------------------ init

    def init_schema(self, verbose: bool = True) -> None:
        """Idempotent schema creation (CREATE IF NOT EXISTS everywhere),
        mirroring _init_database (image_database.py:245-344)."""
        Path(self.db_path).parent.mkdir(parents=True, exist_ok=True)
        conn = connect(self.db_path)
        try:
            cursor = conn.cursor()
            cursor.execute(
                """
                CREATE TABLE IF NOT EXISTS images (
                    id INTEGER PRIMARY KEY AUTOINCREMENT,
                    file_path TEXT UNIQUE NOT NULL,
                    last_modified REAL NOT NULL,
                    file_hash TEXT,
                    created_at TIMESTAMP DEFAULT CURRENT_TIMESTAMP
                )
                """
            )
            # Float vectors: plain BLOB keyed by image_id. Replaces vec0
            # (image_database.py:290-294); scanning happens on-device instead.
            cursor.execute(
                """
                CREATE TABLE IF NOT EXISTS embeddings (
                    image_id INTEGER PRIMARY KEY,
                    vector BLOB NOT NULL,
                    FOREIGN KEY (image_id) REFERENCES images(id)
                )
                """
            )
            cursor.execute(
                """
                CREATE TABLE IF NOT EXISTS binary_embeddings (
                    rowid INTEGER PRIMARY KEY AUTOINCREMENT,
                    image_id INTEGER UNIQUE NOT NULL,
                    embedding BLOB NOT NULL,
                    FOREIGN KEY (image_id) REFERENCES images(id)
                )
                """
            )
            cursor.execute(
                """
                CREATE INDEX IF NOT EXISTS idx_binary_embeddings_image_id
                ON binary_embeddings(image_id)
                """
            )
            # Covering index for embeddings_fingerprint(): image_id is the
            # rowid PK, so its aggregates otherwise SCAN the blob b-tree
            # (~350 MB at 100k rows — measured 123 ms/refresh vs 16 ms with
            # the index). The serve micro-batcher fingerprints every
            # window; the r5 load bench surfaced this as ~10% of window
            # time. ~1 MB at 100k rows.
            cursor.execute(
                """
                CREATE INDEX IF NOT EXISTS idx_embeddings_image_id
                ON embeddings(image_id)
                """
            )
            cursor.execute(
                """
                CREATE TABLE IF NOT EXISTS meta (
                    key TEXT PRIMARY KEY,
                    value TEXT
                )
                """
            )
            cursor.execute(
                "INSERT OR IGNORE INTO meta (key, value) VALUES ('embedding_dim', ?)",
                (str(self.embedding_dim),),
            )
            cursor.execute("SELECT COUNT(*) FROM images")
            existing = cursor.fetchone()[0]
            if existing > 0 and verbose:
                log(f"  Database contains {existing:,} existing images")
            conn.commit()
        finally:
            conn.close()

    def stored_embedding_dim(self) -> Optional[int]:
        conn = connect(self.db_path)
        try:
            cur = conn.execute("SELECT value FROM meta WHERE key = 'embedding_dim'")
            row = cur.fetchone()
            return int(row[0]) if row else None
        except sqlite3.OperationalError:
            return None
        finally:
            conn.close()

    # ------------------------------------------------------------ resume path

    @staticmethod
    def batch_check_processed(
        cursor: sqlite3.Cursor, file_metadata: Sequence[Tuple[str, float]]
    ) -> Set[str]:
        """Which (file_path, last_modified) pairs are already fully processed.

        Same contract as the reference (image_database.py:692-720): chunked at
        400 bind variables, and a file only counts as done if a full *or*
        binary embedding row exists.
        """
        if not file_metadata:
            return set()
        processed: Set[str] = set()
        chunk_size = 200  # (path, mtime) pairs per statement = 400 bind vars
        for i in range(0, len(file_metadata), chunk_size):
            chunk = file_metadata[i : i + chunk_size]
            placeholders = ",".join(["(?, ?)"] * len(chunk))
            values = [item for pair in chunk for item in pair]
            cursor.execute(
                f"""
                SELECT i.file_path
                FROM images i
                WHERE (i.file_path, i.last_modified) IN (VALUES {placeholders})
                AND (
                    EXISTS (SELECT 1 FROM embeddings e WHERE e.image_id = i.id)
                    OR EXISTS (SELECT 1 FROM binary_embeddings be WHERE be.image_id = i.id)
                )
                """,
                values,
            )
            processed.update(row[0] for row in cursor.fetchall())
        return processed

    # ----------------------------------------------------------------- writes

    def commit_with_retry(
        self,
        cursor: sqlite3.Cursor,
        conn: sqlite3.Connection,
        db_batch: List[Tuple[str, float, str, np.ndarray]],
        save_full_embeddings: bool,
        max_retries: int = 5,
        thumbnailer=None,
    ) -> bool:
        """Commit with lock-retry and linear backoff (image_database.py:1084-1096)."""
        for attempt in range(max_retries):
            try:
                self.commit_batch(cursor, db_batch, save_full_embeddings, thumbnailer)
                conn.commit()
                return True
            except sqlite3.OperationalError as e:
                if "locked" in str(e).lower() and attempt < max_retries - 1:
                    time.sleep(0.1 * (attempt + 1))
                    continue
                raise
        raise AssertionError("unreachable: last attempt returns or raises")

    def commit_batch(
        self,
        cursor: sqlite3.Cursor,
        batch: List[Tuple[str, float, str, np.ndarray]],
        save_full_embeddings: bool = True,
        thumbnailer=None,
    ) -> None:
        """Idempotent per-row commit (image_database.py:1098-1205).

        batch rows: (file_path, last_modified, file_hash, embedding[float32])
        — optionally with a 5th element: a pre-built binary blob (one uint8
        per bit) to store verbatim instead of deriving sign bits from the
        embedding. Scan-time reuse passes the SOURCE row's blob so a
        byte-identical copy stays within the duplicate filter's Hamming
        tolerance even when the stored vector is quantized (int8 dequant
        flips near-zero signs).
        """
        for row in batch:
            file_path, last_modified, file_hash, embedding = row[:4]
            given_binary = row[4] if len(row) > 4 else None
            try:
                cursor.execute(
                    "SELECT id FROM images WHERE file_path = ? AND last_modified = ?",
                    (file_path, last_modified),
                )
                existing_row = cursor.fetchone()
                if existing_row:
                    image_id = existing_row[0]
                    table = "embeddings" if save_full_embeddings else "binary_embeddings"
                    cursor.execute(
                        f"SELECT 1 FROM {table} WHERE image_id = ?", (image_id,)
                    )
                    if cursor.fetchone():
                        continue  # already processed in the requested mode

                if thumbnailer is not None:
                    # Reuse the scan's hash — thumbnails are content-hash
                    # named, and recomputing SHA-256 re-reads the whole file.
                    thumbnailer(file_path, file_hash)

                # A modified file (same path, new mtime) is re-inserted via
                # INSERT OR REPLACE, which assigns a NEW id — capture the old
                # id so its embedding rows can be dropped instead of orphaned
                # (orphans would occupy top-k slots; the reference's SQL JOIN
                # hid them, a post-top-k path filter would not).
                cursor.execute("SELECT id FROM images WHERE file_path = ?", (file_path,))
                stale = cursor.fetchone()
                stale_id = stale[0] if stale else None

                cursor.execute(
                    """
                    INSERT OR REPLACE INTO images (file_path, last_modified, file_hash)
                    VALUES (?, ?, ?)
                    """,
                    (file_path, last_modified, file_hash),
                )
                if cursor.lastrowid == 0:
                    cursor.execute("SELECT id FROM images WHERE file_path = ?", (file_path,))
                    row = cursor.fetchone()
                    image_id = row[0] if row else None
                else:
                    image_id = cursor.lastrowid
                if image_id is None:
                    continue
                if stale_id is not None and stale_id != image_id:
                    cursor.execute("DELETE FROM embeddings WHERE image_id = ?", (stale_id,))
                    cursor.execute(
                        "DELETE FROM binary_embeddings WHERE image_id = ?", (stale_id,)
                    )

                vec = np.asarray(embedding, dtype=np.float32).reshape(-1)
                if save_full_embeddings:
                    if self.vector_dtype == "fp16":
                        blob = vec.astype(np.float16).tobytes()
                    elif self.vector_dtype == "int8":
                        blob = _quantize_int8_blob(vec)
                    else:
                        blob = vec.tobytes()
                    cursor.execute(
                        """
                        INSERT OR REPLACE INTO embeddings (image_id, vector)
                        VALUES (?, ?)
                        """,
                        (image_id, blob),
                    )

                # Binary embedding always saved if absent; same on-disk format
                # as the reference: one uint8 per bit (image_database.py:1189).
                cursor.execute(
                    "SELECT 1 FROM binary_embeddings WHERE image_id = ?", (image_id,)
                )
                if not cursor.fetchone():
                    binary_blob = (
                        bytes(given_binary)
                        if given_binary is not None
                        else (vec >= 0).astype(np.uint8).tobytes()
                    )
                    cursor.execute(
                        """
                        INSERT INTO binary_embeddings (image_id, embedding)
                        VALUES (?, ?)
                        """,
                        (image_id, binary_blob),
                    )
            except sqlite3.IntegrityError:
                continue  # skip duplicates (image_database.py:1200)
            except sqlite3.OperationalError as e:
                if "locked" in str(e).lower() or "busy" in str(e).lower():
                    # Must reach commit_with_retry's backoff loop — swallowing
                    # it here would silently drop the row under contention.
                    raise
                safe_print_path("Error committing ", file_path, e)
                continue
            except Exception as e:  # noqa: BLE001 - containment, keep scanning
                safe_print_path("Error committing ", file_path, e)
                continue

    # ------------------------------------------------------------------ reads

    def count_images(self) -> int:
        conn = connect(self.db_path)
        try:
            return conn.execute("SELECT COUNT(*) FROM images").fetchone()[0]
        finally:
            conn.close()

    def count_embeddings(self) -> Tuple[int, int]:
        """Return (full_count, binary_count)."""
        conn = connect(self.db_path)
        try:
            full = conn.execute("SELECT COUNT(*) FROM embeddings").fetchone()[0]
            binary = conn.execute("SELECT COUNT(*) FROM binary_embeddings").fetchone()[0]
            return full, binary
        finally:
            conn.close()

    def lookup_image(
        self, file_path: str
    ) -> Optional[Tuple[int, float, Optional[str]]]:
        """(id, last_modified, file_hash) for an exact ``file_path`` match,
        or None. The serving UI's /image endpoint uses this as its access
        gate: only rows in this table are ever read from disk."""
        conn = connect(self.db_path)
        try:
            row = conn.execute(
                "SELECT id, last_modified, file_hash FROM images "
                "WHERE file_path = ?",
                (file_path,),
            ).fetchone()
            return None if row is None else (row[0], row[1], row[2])
        finally:
            conn.close()

    def fetch_paths_for_ids(self, image_ids: Sequence[int]) -> Dict[int, str]:
        if not len(image_ids):
            return {}
        out: Dict[int, str] = {}
        conn = connect(self.db_path)
        try:
            cur = conn.cursor()
            ids = [int(i) for i in image_ids]
            for i in range(0, len(ids), 900):
                chunk = ids[i : i + 900]
                placeholders = ",".join(["?"] * len(chunk))
                cur.execute(
                    f"SELECT id, file_path FROM images WHERE id IN ({placeholders})",
                    chunk,
                )
                out.update(dict(cur.fetchall()))
            return out
        finally:
            conn.close()

    def fetch_binary_for_paths(
        self, file_paths: Iterable[str]
    ) -> Dict[str, np.ndarray]:
        """Binary (0/1 uint8) embeddings for the given paths, for the
        duplicate filter (image_database.py:1232-1253)."""
        paths = list(file_paths)
        if not paths:
            return {}
        conn = connect(self.db_path)
        try:
            cur = conn.cursor()
            out: Dict[str, np.ndarray] = {}
            for i in range(0, len(paths), 900):
                chunk = paths[i : i + 900]
                placeholders = ",".join(["?"] * len(chunk))
                cur.execute(
                    f"""
                    SELECT i.file_path, be.embedding
                    FROM binary_embeddings be
                    JOIN images i ON be.image_id = i.id
                    WHERE i.file_path IN ({placeholders})
                    """,
                    chunk,
                )
                for file_path, blob in cur.fetchall():
                    out[file_path] = np.frombuffer(blob, dtype=np.uint8)
            return out
        finally:
            conn.close()

    def folder_filter_ids(self, filter_folders: Sequence[str]) -> Set[int]:
        """image_ids whose file_path falls under any of the given folders,
        using the reference's escaped LIKE-prefix semantics
        (image_database.py:1513-1529, 1576-1579)."""
        if not filter_folders:
            return set()
        conditions = []
        params: List[str] = []
        for folder in filter_folders:
            folder_abs = os.path.abspath(folder)
            if not folder_abs.endswith(os.sep):
                folder_abs += os.sep
            escaped = (
                folder_abs.replace("\\", "\\\\").replace("%", "\\%").replace("_", "\\_")
            )
            conditions.append("file_path LIKE ? ESCAPE '\\'")
            params.append(escaped + "%")
        conn = connect(self.db_path)
        try:
            cur = conn.execute(
                f"SELECT id FROM images WHERE ({' OR '.join(conditions)})", params
            )
            return {row[0] for row in cur.fetchall()}
        finally:
            conn.close()

    def embeddings_fingerprint(self) -> Tuple[int, int, int]:
        """(row_count, max_image_id, sum_image_id) of the embeddings table —
        the staleness stamp for the packed matrix cache. The id-sum term
        catches replace-style changes (modified files delete the stale id and
        insert a new one, leaving the count unchanged)."""
        conn = connect(self.db_path)
        try:
            row = conn.execute(
                "SELECT COUNT(*), COALESCE(MAX(image_id), 0), "
                "COALESCE(SUM(image_id), 0) FROM embeddings"
            ).fetchone()
            return int(row[0]), int(row[1]), int(row[2])
        finally:
            conn.close()

    def binary_fingerprint(self) -> Tuple[int, int, int]:
        conn = connect(self.db_path)
        try:
            row = conn.execute(
                "SELECT COUNT(*), COALESCE(MAX(image_id), 0), "
                "COALESCE(SUM(image_id), 0) FROM binary_embeddings"
            ).fetchone()
            return int(row[0]), int(row[1]), int(row[2])
        finally:
            conn.close()

    def tail_fingerprint(self, table: str, min_image_id: int) -> Tuple[int, int]:
        """(count, sum_image_id) of rows with image_id > min_image_id —
        used to prove a cache refresh can be append-only."""
        assert table in ("embeddings", "binary_embeddings")
        conn = connect(self.db_path)
        try:
            row = conn.execute(
                f"SELECT COUNT(*), COALESCE(SUM(image_id), 0) FROM {table} "
                "WHERE image_id > ?",
                (min_image_id,),
            ).fetchone()
            return int(row[0]), int(row[1])
        finally:
            conn.close()

    def _decode_vector_rows(self, blobs: List[bytes]) -> np.ndarray:
        """Decode same-length vector blobs to fp32 (n, D). Per-row dtype by
        blob length: dim*4 = fp32, dim*2 = fp16, dim+4 = int8 values followed
        by one fp32 scale (see _quantize_int8_blob)."""
        d = self.embedding_dim
        n_bytes = len(blobs[0])
        raw = b"".join(blobs)
        # At d == 4 the int8 length (d+4) collides with fp16 (2d); int8
        # WRITING is blocked for that dim (__init__ guard), so an 8-byte
        # blob there can only be fp16 — prefer the float interpretation.
        if n_bytes == d + 4 and n_bytes != 2 * d:
            rows = np.frombuffer(raw, dtype=np.uint8).reshape(len(blobs), d + 4)
            q = rows[:, :d].view(np.int8).astype(np.float32)
            scales = rows[:, d:].copy().view(np.float32)
            return q * scales
        dt = np.float16 if n_bytes == 2 * d else np.float32
        return np.frombuffer(raw, dtype=dt).astype(np.float32).reshape(len(blobs), -1)

    def ensure_hash_index(self, conn: sqlite3.Connection) -> None:
        """Content-hash index backing fetch_embedding_by_hash. Created
        lazily by the reuse setup (scan --reuse-embeddings) rather than in
        init_schema: every database would otherwise pay the one-time build
        stall plus per-insert maintenance for a feature most scans never
        use."""
        conn.execute(
            "CREATE INDEX IF NOT EXISTS idx_images_file_hash ON images(file_hash)"
        )
        conn.commit()

    def fetch_embedding_by_hash(
        self, cursor, file_hash: str
    ) -> Optional[Tuple[np.ndarray, Optional[bytes]]]:
        """(full embedding, binary blob) of any already-indexed file with
        this content hash, or None. Backs scan-time reuse (byte-identical
        files decode+embed once); only full rows qualify — binary-only rows
        can't seed a full embedding for the new path. The source's binary
        blob rides along so the copy's blob is IDENTICAL (deriving signs
        from a dequantized int8 vector flips near-zero bits, pushing exact
        copies past the duplicate filter's Hamming tolerance)."""
        row = cursor.execute(
            "SELECT e.vector, be.embedding FROM images i "
            "JOIN embeddings e ON e.image_id = i.id "
            "LEFT JOIN binary_embeddings be ON be.image_id = i.id "
            "WHERE i.file_hash = ? LIMIT 1",
            (file_hash,),
        ).fetchone()
        if row is None:
            return None
        return self._decode_vector_rows([row[0]])[0], row[1]

    def iter_embeddings(
        self, min_image_id: int = 0, batch_rows: int = 8192
    ) -> Iterable[Tuple[np.ndarray, np.ndarray]]:
        """Yield (image_ids[int64], vectors[float32, (n, D)]) in image_id order,
        starting after min_image_id. Streams in batches to bound memory."""
        # check_same_thread=False: an abandoned half-consumed generator is
        # finalized by whichever thread runs GC, and its finally-close would
        # raise on a thread-bound connection (see connect()'s docstring).
        conn = connect(self.db_path, check_same_thread=False)
        try:
            cur = conn.cursor()
            cur.execute(
                "SELECT image_id, vector FROM embeddings WHERE image_id > ? ORDER BY image_id",
                (min_image_id,),
            )
            while True:
                rows = cur.fetchmany(batch_rows)
                if not rows:
                    break
                ids = np.array([r[0] for r in rows], dtype=np.int64)
                # Per-row dtype detection by blob length (_decode_vector_rows).
                # Rows within one fetch usually share a dtype, so decode
                # same-length runs in bulk; mixed batches decode row by row.
                lens = {len(r[1]) for r in rows}
                if len(lens) == 1:
                    yield ids, self._decode_vector_rows([r[1] for r in rows])
                else:
                    yield ids, np.concatenate([
                        self._decode_vector_rows([r[1]]) for r in rows
                    ])
        finally:
            conn.close()

    def iter_binary_embeddings(
        self, min_image_id: int = 0, batch_rows: int = 8192
    ) -> Iterable[Tuple[np.ndarray, np.ndarray]]:
        """Yield (image_ids[int64], bits[uint8 0/1, (n, D)]) in image_id order."""
        # check_same_thread=False: same GC-time finally-close rationale as
        # iter_embeddings.
        conn = connect(self.db_path, check_same_thread=False)
        try:
            cur = conn.cursor()
            cur.execute(
                "SELECT image_id, embedding FROM binary_embeddings "
                "WHERE image_id > ? ORDER BY image_id",
                (min_image_id,),
            )
            while True:
                rows = cur.fetchmany(batch_rows)
                if not rows:
                    break
                ids = np.array([r[0] for r in rows], dtype=np.int64)
                bits = np.frombuffer(b"".join(r[1] for r in rows), dtype=np.uint8)
                yield ids, bits.reshape(len(rows), -1)
        finally:
            conn.close()
