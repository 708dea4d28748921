"""Merge shard databases into one.

Multi-host indexing story: each worker scans its folder shard
(``scan --num-shards N --shard-index i``) into its own DB; this merges them.
Rows are keyed by file_path — an existing destination row with the same
(path, mtime) is kept (idempotent re-merge); a newer mtime replaces it along
with its embedding rows. Vector/binary blobs copy verbatim; the destination's
matrix cache rebuilds lazily on next search.
"""

from __future__ import annotations

from typing import List

from tpuclip_torch.index.store import MetadataStore, connect
from tpuclip_torch.utils.logging import log


def merge_databases(dst_path: str, src_paths: List[str], embedding_dim: int = 1152) -> None:
    # Infer embedding dim from the sources; mixed dims would silently corrupt
    # the destination (search reshapes every vector blob to one dim).
    src_dims = {
        dim for src in src_paths if (dim := MetadataStore(src).stored_embedding_dim())
    }
    if len(src_dims) > 1:
        raise ValueError(
            f"Source databases record mismatched embedding dims {sorted(src_dims)}; "
            "refusing to merge"
        )
    dst_dim = MetadataStore(dst_path).stored_embedding_dim()
    if src_dims:
        embedding_dim = src_dims.pop()
        if dst_dim and dst_dim != embedding_dim:
            raise ValueError(
                f"Destination records embedding dim {dst_dim} but sources use "
                f"{embedding_dim}; refusing to merge"
            )
    elif dst_dim:
        embedding_dim = dst_dim
    dst_store = MetadataStore(dst_path, embedding_dim=embedding_dim)
    dst_store.init_schema(verbose=False)

    dst = connect(dst_path)
    dcur = dst.cursor()
    total_new = total_updated = total_skipped = 0

    for src_path in src_paths:
        src = connect(src_path)
        scur = src.cursor()
        new = updated = skipped = 0
        scur.execute(
            """
            SELECT i.id, i.file_path, i.last_modified, i.file_hash,
                   e.vector, be.embedding
            FROM images i
            LEFT JOIN embeddings e ON e.image_id = i.id
            LEFT JOIN binary_embeddings be ON be.image_id = i.id
            """
        )
        while True:
            rows = scur.fetchmany(2048)
            if not rows:
                break
            for _sid, path, mtime, fhash, vector, binary in rows:
                drow = dcur.execute(
                    "SELECT id, last_modified FROM images WHERE file_path = ?",
                    (path,),
                ).fetchone()
                if drow is not None:
                    if drow[1] >= mtime:
                        skipped += 1
                        continue
                    # newer source row wins; clear stale embedding rows
                    dcur.execute("DELETE FROM embeddings WHERE image_id = ?", (drow[0],))
                    dcur.execute(
                        "DELETE FROM binary_embeddings WHERE image_id = ?", (drow[0],)
                    )
                    dcur.execute("DELETE FROM images WHERE id = ?", (drow[0],))
                    updated += 1
                else:
                    new += 1
                dcur.execute(
                    "INSERT INTO images (file_path, last_modified, file_hash) VALUES (?, ?, ?)",
                    (path, mtime, fhash),
                )
                new_id = dcur.lastrowid
                if vector is not None:
                    dcur.execute(
                        "INSERT INTO embeddings (image_id, vector) VALUES (?, ?)",
                        (new_id, vector),
                    )
                if binary is not None:
                    dcur.execute(
                        "INSERT INTO binary_embeddings (image_id, embedding) VALUES (?, ?)",
                        (new_id, binary),
                    )
            dst.commit()
        src.close()
        log(f"  {src_path}: +{new} new, {updated} updated, {skipped} skipped")
        total_new += new
        total_updated += updated
        total_skipped += skipped

    dst.commit()
    dst.close()
    log(
        f"Merge complete: {total_new} new, {total_updated} updated, "
        f"{total_skipped} skipped → {dst_path}"
    )
