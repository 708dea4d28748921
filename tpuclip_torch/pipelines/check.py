"""Database integrity verification (`tpuclip check`).

The reference trusts its DB blindly — the only pre-flight anywhere is "does
an images table exist" before search (image_database.py:2004-2016). tpuclip
has more writers (scan shards + merge, migrate, prune, concurrent
scan/serve), so a verifier that proves cross-table consistency earns its
keep. Checks, cheapest first:

1. SQLite structural integrity (PRAGMA integrity_check).
2. meta.embedding_dim parseable.
3. Orphaned embedding rows (embeddings / binary_embeddings whose image_id
   has no images row — a crashed merge can leave these).
4. Vector blob lengths decodable for the declared dim (fp32 d*4 / fp16 d*2 /
   int8 d+4 — store._decode_vector_rows contract); binary blobs exactly
   d bytes (one uint8 per sign bit, image_database.py:1189-1198).
5. Non-finite or zero-norm vectors (would poison every cosine scan).
6. Images with neither a full nor a binary embedding row — informational:
   the resume check re-embeds them on the next scan.

``fix=True`` deletes what a rescan can rebuild (orphans, undecodable or
non-finite embedding rows) and never touches the images table, so a
follow-up ``tpuclip scan`` restores the deleted embeddings from disk.
"""

from __future__ import annotations

import sqlite3
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from tpuclip_torch.index.store import MetadataStore, connect
from tpuclip_torch.utils.logging import log


@dataclass
class CheckResult:
    ok: bool
    problems: Dict[str, int] = field(default_factory=dict)
    incomplete_images: int = 0  # informational, not a failure
    fixed: int = 0


def _sample(ids: List[int], limit: int = 5) -> str:
    shown = ", ".join(str(i) for i in ids[:limit])
    return shown + (f", … (+{len(ids) - limit:,})" if len(ids) > limit else "")


def check_database(db_path: str, fix: bool = False, verbose: bool = True) -> CheckResult:
    store = MetadataStore(db_path)
    result = CheckResult(ok=True)
    to_delete: Dict[str, List[int]] = {"embeddings": [], "binary_embeddings": []}

    def vlog(msg: str) -> None:
        if verbose:
            log(msg)

    def problem(name: str, count: int, detail: str) -> None:
        if count:
            result.ok = False
            result.problems[name] = count
            vlog(f"  [FAIL] {detail}")
        else:
            vlog(f"  [ OK ] {name}")

    try:
        conn = connect(db_path)
        dim = store.stored_embedding_dim() or store.embedding_dim
    except sqlite3.DatabaseError as e:
        result.ok = False
        result.problems["sqlite_error"] = 1
        vlog(f"  [FAIL] {e}")
        vlog(f"Database has problems: {result.problems}")
        return result
    try:
        cur = conn.cursor()

        row = cur.execute("PRAGMA integrity_check").fetchone()
        problem(
            "sqlite_integrity",
            0 if row and row[0] == "ok" else 1,
            f"SQLite integrity: {row[0] if row else 'no response'}",
        )

        meta_dim = cur.execute(
            "SELECT value FROM meta WHERE key='embedding_dim'"
        ).fetchone()
        bad_meta = 0
        if meta_dim is not None:
            try:
                dim = int(meta_dim[0])
            except (TypeError, ValueError):
                bad_meta = 1
        problem("meta_embedding_dim", bad_meta, f"meta.embedding_dim unparseable: {meta_dim}")

        for table, col in (("embeddings", "image_id"), ("binary_embeddings", "image_id")):
            orphans = [
                r[0]
                for r in cur.execute(
                    f"SELECT t.{col} FROM {table} t "
                    f"LEFT JOIN images i ON t.{col} = i.id WHERE i.id IS NULL"
                )
            ]
            problem(
                f"orphaned_{table}",
                len(orphans),
                f"{len(orphans):,} {table} rows reference missing images rows "
                f"(image_ids {_sample(orphans)})",
            )
            to_delete[table].extend(orphans)

        valid_lens = {dim * 4, dim * 2} | ({dim + 4} if dim != 4 else set())
        bad_vec = [
            r[0]
            for r in cur.execute("SELECT image_id, LENGTH(vector) FROM embeddings")
            if r[1] not in valid_lens
        ]
        problem(
            "undecodable_vector_blobs",
            len(bad_vec),
            f"{len(bad_vec):,} vector blobs have lengths outside "
            f"{sorted(valid_lens)} for dim {dim} (image_ids {_sample(bad_vec)})",
        )
        to_delete["embeddings"].extend(bad_vec)

        bad_bin = [
            r[0]
            for r in cur.execute(
                "SELECT image_id, LENGTH(embedding) FROM binary_embeddings"
            )
            if r[1] != dim
        ]
        problem(
            "bad_binary_blobs",
            len(bad_bin),
            f"{len(bad_bin):,} binary blobs are not exactly {dim} bytes "
            f"(image_ids {_sample(bad_bin)})",
        )
        to_delete["binary_embeddings"].extend(bad_bin)

        # Vector content: stream-decode only the rows that passed the length
        # check (iter_embeddings would choke on undecodable blobs) and flag
        # non-finite / zero-norm vectors.
        bad_values: List[int] = []
        content_cur = conn.execute(
            "SELECT image_id, vector FROM embeddings ORDER BY image_id"
        )
        while True:
            rows = content_cur.fetchmany(4096)
            if not rows:
                break
            for image_id, blob in rows:
                if len(blob) not in valid_lens:
                    continue
                vec = store._decode_vector_rows([blob])[0]
                if not np.isfinite(vec).all() or np.linalg.norm(vec) < 1e-12:
                    bad_values.append(int(image_id))
        problem(
            "nonfinite_or_zero_vectors",
            len(bad_values),
            f"{len(bad_values):,} vectors are non-finite or zero-norm "
            f"(image_ids {_sample(bad_values)})",
        )
        to_delete["embeddings"].extend(bad_values)

        result.incomplete_images = cur.execute(
            "SELECT COUNT(*) FROM images i "
            "LEFT JOIN embeddings e ON e.image_id = i.id "
            "LEFT JOIN binary_embeddings b ON b.image_id = i.id "
            "WHERE e.image_id IS NULL AND b.image_id IS NULL"
        ).fetchone()[0]
        if result.incomplete_images:
            vlog(
                f"  [info] {result.incomplete_images:,} images have no embedding "
                "yet (a rescan picks them up)"
            )

        if fix and not result.ok:
            for table, ids in to_delete.items():
                ids = sorted(set(ids))
                for i in range(0, len(ids), 900):
                    chunk = ids[i : i + 900]
                    placeholders = ",".join(["?"] * len(chunk))
                    cur.execute(
                        f"DELETE FROM {table} WHERE image_id IN ({placeholders})",
                        chunk,
                    )
                result.fixed += len(ids)
            conn.commit()
            vlog(
                f"  Fixed: deleted {result.fixed:,} embedding rows "
                "(rescan re-embeds the affected images)"
            )
    except sqlite3.DatabaseError as e:
        # Not a SQLite file at all, or corrupted beyond PRAGMA reach.
        result.ok = False
        result.problems["sqlite_error"] = 1
        vlog(f"  [FAIL] {e}")
    finally:
        conn.close()

    vlog(
        "Database OK" if result.ok
        else f"Database has problems: {result.problems}"
    )
    return result
