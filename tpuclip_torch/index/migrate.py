"""Migrate a reference-built database into tpuclip's embedding layout.

A database created by the reference stores full-precision vectors inside the
sqlite-vec ``vec0`` virtual table (image_database.py:290-294, inserts at
:1153-1181, reads at :1559-1589). tpuclip reads its own ``embeddings`` BLOB
table (index/store.py), so without migration an existing user DB would fall
back to binary-only search and silently lose its full-precision index.

The migration needs NO sqlite-vec extension: a vec0 virtual table persists
its data in plain shadow tables that sqlite reads like any other table
(the virtual-table *module* is only needed to query through the ``vec0``
facade). sqlite-vec's vec0 layout (v0.1.x):

  <name>_chunks          (chunk_id PK, size, validity BLOB, rowids BLOB)
  <name>_rowids          (rowid PK, id, chunk_id, chunk_offset)
  <name>_vector_chunks00 (rowid = chunk_id, vectors BLOB)

Each chunk holds ``size`` fixed-width slots; ``vectors`` concatenates
``size`` float32 vectors (the reference's ``serialize_float32``);
``validity`` is an LSB-first bitmap of live slots; ``<name>_rowids`` maps
every LIVE vec0 rowid to its (chunk_id, chunk_offset) — the authoritative
live-row listing, which is what we iterate (deleted rows simply don't
appear). The reference links vec0 rowids to images via its
``image_embeddings`` (rowid, image_id) mapping table (image_database.py:
:308-314, :1177-1181).

Migration is in-place and idempotent: the tpuclip ``embeddings``/``meta``
tables are added next to the reference tables (``images`` and
``binary_embeddings`` DDL are already identical), existing rows are left
untouched, and re-running migrates only what's missing.
"""

from __future__ import annotations

import re
import sqlite3
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np

from tpuclip_torch.utils.logging import log


def _table_exists(conn: sqlite3.Connection, name: str) -> bool:
    row = conn.execute(
        "SELECT 1 FROM sqlite_master WHERE name = ?", (name,)
    ).fetchone()
    return row is not None


def detect_vec0(conn: sqlite3.Connection, table: str = "vec0") -> bool:
    """True when the DB carries vec0 shadow tables to migrate from."""
    return _table_exists(conn, f"{table}_rowids") and _table_exists(
        conn, f"{table}_vector_chunks00"
    )


def vec0_dim(conn: sqlite3.Connection, table: str = "vec0") -> Optional[int]:
    """Vector dimension: parse the virtual table's DDL (``float[1152]``),
    else infer from chunk byte widths."""
    row = conn.execute(
        "SELECT sql FROM sqlite_master WHERE name = ? AND type = 'table'", (table,)
    ).fetchone()
    if row and row[0]:
        m = re.search(r"float\s*\[\s*(\d+)\s*\]", row[0])
        if m:
            return int(m.group(1))
    # Fallback: bytes-per-chunk / (slots * 4)
    r = conn.execute(
        f'SELECT c.size, length(v.vectors) FROM "{table}_chunks" c '
        f'JOIN "{table}_vector_chunks00" v ON v.rowid = c.chunk_id LIMIT 1'
    ).fetchone()
    if r and r[0]:
        size, nbytes = r
        if nbytes % (size * 4) == 0:
            return nbytes // (size * 4)
    return None


def iter_vec0_vectors(
    conn: sqlite3.Connection, table: str = "vec0"
) -> Iterator[Tuple[int, np.ndarray]]:
    """Yield (vec0_rowid, float32 vector) for every live row.

    Iterates ``<table>_rowids`` chunk-by-chunk so each chunk's vector BLOB is
    fetched once, and cross-checks the validity bitmap (a live rowids entry
    whose validity bit is clear means a layout we don't understand — fail
    loudly rather than emit garbage vectors).
    """
    d = vec0_dim(conn, table)
    if d is None:
        raise ValueError(f"cannot determine vector dimension of '{table}'")
    chunk_rows = conn.execute(
        f'SELECT chunk_id, size, validity FROM "{table}_chunks" ORDER BY chunk_id'
    ).fetchall()
    for chunk_id, size, validity in chunk_rows:
        entries = conn.execute(
            f'SELECT rowid, chunk_offset FROM "{table}_rowids" '
            f"WHERE chunk_id = ? ORDER BY chunk_offset",
            (chunk_id,),
        ).fetchall()
        if not entries:
            continue
        blob = conn.execute(
            f'SELECT vectors FROM "{table}_vector_chunks00" WHERE rowid = ?',
            (chunk_id,),
        ).fetchone()
        if blob is None or blob[0] is None:
            raise ValueError(f"vec0 chunk {chunk_id} has no vector blob")
        vectors = np.frombuffer(blob[0], dtype=np.float32)
        if len(vectors) < size * d:
            raise ValueError(
                f"vec0 chunk {chunk_id}: blob holds {len(vectors)} floats, "
                f"expected {size}x{d}"
            )
        val = bytes(validity) if validity is not None else None
        for vec_rowid, offset in entries:
            if offset is None or not (0 <= offset < size):
                raise ValueError(
                    f"vec0 rowid {vec_rowid}: bad chunk_offset {offset}"
                )
            if val is not None and not (val[offset >> 3] >> (offset & 7)) & 1:
                raise ValueError(
                    f"vec0 rowid {vec_rowid}: slot {offset} of chunk "
                    f"{chunk_id} is marked invalid but listed live"
                )
            yield int(vec_rowid), vectors[offset * d : (offset + 1) * d].copy()


@dataclass
class MigrationReport:
    migrated: int = 0
    skipped_existing: int = 0
    unmapped: int = 0
    dim: int = 0


def migrate_reference_db(
    db_path: str,
    table: str = "vec0",
    dry_run: bool = False,
    batch: int = 2000,
    verbose: bool = True,
) -> MigrationReport:
    """Copy every live vec0 vector into the tpuclip ``embeddings`` table.

    In place and idempotent. After migration the DB searches under tpuclip
    with full precision (verified top-k-identical in tests/test_migrate.py);
    ``images`` and ``binary_embeddings`` were already compatible.
    """
    from tpuclip_torch.index.store import MetadataStore

    conn = sqlite3.connect(db_path)
    report = MigrationReport()
    try:
        if not _table_exists(conn, "images"):
            raise ValueError(f"{db_path}: not an image database (no 'images' table)")
        if not detect_vec0(conn, table):
            raise ValueError(
                f"{db_path}: no sqlite-vec '{table}' shadow tables found — "
                "nothing to migrate (binary-only databases work unmigrated)"
            )
        if not _table_exists(conn, "image_embeddings"):
            raise ValueError(
                f"{db_path}: missing 'image_embeddings' rowid mapping table"
            )
        report.dim = vec0_dim(conn, table) or 0
        if report.dim <= 0:
            # Validate BEFORE any write: stamping meta embedding_dim=0 and
            # creating the embeddings table on a DB we then fail on would
            # leave a corrupted schema behind (INSERT OR IGNORE means a
            # later correct migration could not fix the meta row).
            raise ValueError(
                f"{db_path}: could not determine the vec0 vector dimension "
                f"(no '{table}' DDL in sqlite_master and no chunk rows) — "
                "the database appears to contain no migratable vectors"
            )

        if not dry_run:
            conn.close()
            store = MetadataStore(db_path, embedding_dim=report.dim)
            store.init_schema(verbose=False)  # adds embeddings/meta, idempotent
            conn = sqlite3.connect(db_path)

        mapping = dict(
            conn.execute("SELECT rowid, image_id FROM image_embeddings").fetchall()
        )
        have = {
            r[0]
            for r in (
                conn.execute("SELECT image_id FROM embeddings").fetchall()
                if _table_exists(conn, "embeddings")
                else ()
            )
        }
        pending = []
        for vec_rowid, vec in iter_vec0_vectors(conn, table):
            image_id = mapping.get(vec_rowid)
            if image_id is None:
                report.unmapped += 1
                continue
            if image_id in have:
                report.skipped_existing += 1
                continue
            report.migrated += 1
            if dry_run:
                continue
            pending.append((image_id, vec.tobytes()))
            if len(pending) >= batch:
                conn.executemany(
                    "INSERT OR REPLACE INTO embeddings (image_id, vector) VALUES (?, ?)",
                    pending,
                )
                conn.commit()
                pending.clear()
        if pending:
            conn.executemany(
                "INSERT OR REPLACE INTO embeddings (image_id, vector) VALUES (?, ?)",
                pending,
            )
            conn.commit()
        if verbose:
            prefix = "[dry-run] would migrate" if dry_run else "Migrated"
            log(
                f"  {prefix} {report.migrated:,} vectors "
                f"({report.dim}-d) from '{table}'; "
                f"{report.skipped_existing:,} already present, "
                f"{report.unmapped:,} unmapped vec0 rows"
            )
        return report
    finally:
        conn.close()
