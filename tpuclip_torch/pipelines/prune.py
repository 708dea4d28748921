"""Remove database rows for files that no longer exist on disk.

The reference treats the DB as an append-only checkpoint (SURVEY.md §5):
nothing ever deletes a row, so files removed from disk keep surfacing in
every search as dead ``file:///`` results forever. ``tpuclip prune`` closes
the index lifecycle: stream the images table, ``stat`` each path, and drop
the ``images`` / ``embeddings`` / ``binary_embeddings`` rows whose file
vanished. The embedding-count fingerprint changes, so the HBM-resident
index and the packed matrix sidecar rebuild without the pruned rows on the
next refresh.

No model load — this is pure host/SQL work, same tier as ``info`` and
``gc``. Orphaned thumbnails left behind by pruned PDF/TIF/BMP rows are
``tpuclip gc``'s job (content-hash-named thumbnails may be shared by
surviving duplicates, so prune never touches them).
"""

from __future__ import annotations

import os
import sqlite3
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

from tpuclip_torch.index.store import MetadataStore, connect
from tpuclip_torch.utils.logging import log


@dataclass
class PruneResult:
    checked: int
    missing: int
    removed: int
    dry_run: bool


def _delete_ids(conn: sqlite3.Connection, ids: List[int], max_retries: int = 5) -> None:
    """Delete one chunk of image ids from all three tables in one
    transaction, with the scan committer's lock-retry semantics
    (image_database.py:1084-1096) so prune can run beside a live scanner."""
    placeholders = ",".join(["?"] * len(ids))
    for attempt in range(max_retries):
        try:
            cur = conn.cursor()
            cur.execute(f"DELETE FROM embeddings WHERE image_id IN ({placeholders})", ids)
            cur.execute(
                f"DELETE FROM binary_embeddings WHERE image_id IN ({placeholders})", ids
            )
            cur.execute(f"DELETE FROM images WHERE id IN ({placeholders})", ids)
            conn.commit()
            return
        except sqlite3.OperationalError as e:
            if "locked" in str(e).lower() and attempt < max_retries - 1:
                time.sleep(0.1 * (attempt + 1))
                continue
            raise


def prune_missing(
    db_path: str,
    folders: Optional[Sequence[str]] = None,
    dry_run: bool = False,
    verbose: bool = True,
    delete_chunk: int = 900,
) -> PruneResult:
    """Drop rows whose ``file_path`` no longer exists on disk.

    ``folders`` limits the check to paths under the given directories (the
    reference's escaped LIKE-prefix semantics via
    ``MetadataStore.folder_filter_ids``) — prune a relocated subtree without
    stat-ing a million untouched rows.
    """
    store = MetadataStore(db_path)
    scope_ids = store.folder_filter_ids(list(folders)) if folders else None

    checked = 0
    missing_ids: List[int] = []
    conn = connect(db_path)
    try:
        cur = conn.cursor()
        cur.execute("SELECT id, file_path FROM images ORDER BY id")
        while True:
            rows = cur.fetchmany(4096)
            if not rows:
                break
            for image_id, file_path in rows:
                if scope_ids is not None and image_id not in scope_ids:
                    continue
                checked += 1
                if not os.path.exists(file_path):
                    missing_ids.append(image_id)

        if verbose:
            log(
                f"Checked {checked:,} database rows: "
                f"{len(missing_ids):,} files no longer exist"
            )
        if not missing_ids:
            return PruneResult(checked, 0, 0, dry_run)
        if dry_run:
            sample = store.fetch_paths_for_ids(missing_ids[:10])
            for image_id in missing_ids[:10]:
                log(f"  would remove: {sample.get(image_id, image_id)}")
            if len(missing_ids) > 10:
                log(f"  ... and {len(missing_ids) - 10:,} more")
            return PruneResult(checked, len(missing_ids), 0, dry_run)

        for i in range(0, len(missing_ids), delete_chunk):
            _delete_ids(conn, missing_ids[i : i + delete_chunk])
        if verbose:
            log(
                f"Removed {len(missing_ids):,} rows "
                "(run 'tpuclip gc' to drop any orphaned thumbnails)"
            )
        return PruneResult(checked, len(missing_ids), len(missing_ids), dry_run)
    finally:
        conn.close()
