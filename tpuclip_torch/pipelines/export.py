"""Export a database's embeddings to open formats.

The reference locks vectors inside sqlite-vec; tpuclip stores plain BLOBs
but external tooling (faiss, numpy analysis, spreadsheet joins) wants files.
Formats:

- ``npz`` (default): one compressed archive with ``image_ids`` (int64),
  ``file_paths`` (unicode), ``vectors`` (float32 (n, D)), and — when
  requested — ``binary`` (uint8 0/1 (n, D)).
- ``npy``: bare float32 matrix in image_id order, plus ``<out>.ids.npy``
  and ``<out>.paths.txt`` sidecars (for mmap-style consumers).
- ``jsonl``: one ``{"image_id", "file_path", "vector"}`` object per line
  (human-greppable; large).

Streaming: rows are pulled in image_id-ordered batches
(store.iter_embeddings), so memory stays bounded for jsonl; the numpy
formats accumulate the matrix (an export necessarily materializes it).
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np

from tpuclip_torch.index.store import MetadataStore, connect
from tpuclip_torch.utils.logging import log

FORMATS = ("npz", "npy", "jsonl")


def _paths_for_ids(store: MetadataStore, ids: np.ndarray) -> list:
    by_id = store.fetch_paths_for_ids([int(i) for i in ids])
    return [by_id.get(int(i), "") for i in ids]


def export_embeddings(
    db_path: str,
    output: str,
    fmt: str = "npz",
    include_binary: bool = False,
    embedding_dim: Optional[int] = None,
) -> int:
    """Write the database's full embeddings to ``output``; returns row count."""
    if fmt not in FORMATS:
        raise ValueError(f"format must be one of {FORMATS}, got {fmt}")
    if embedding_dim is None:
        # The store decodes fp16/int8 blobs by length relative to the dim, so
        # the DB's true dim matters: the recorded meta value first, else a
        # binary row's blob length (one uint8 per bit; every full row has a
        # binary sibling — covers pre-meta or externally-created DBs).
        embedding_dim = MetadataStore(db_path).stored_embedding_dim()
        if embedding_dim is None:
            conn = connect(db_path)
            try:
                row = conn.execute(
                    "SELECT LENGTH(embedding) FROM binary_embeddings LIMIT 1"
                ).fetchone()
            finally:
                conn.close()
            if row is not None:
                embedding_dim = int(row[0])
    store = (
        MetadataStore(db_path, embedding_dim=embedding_dim)
        if embedding_dim
        else MetadataStore(db_path)
    )

    if fmt == "jsonl":
        n = 0
        with open(output, "w", encoding="utf-8") as f:
            for ids, vecs in store.iter_embeddings():
                paths = _paths_for_ids(store, ids)
                for i in range(len(ids)):
                    f.write(
                        json.dumps(
                            {
                                "image_id": int(ids[i]),
                                "file_path": paths[i],
                                "vector": [round(float(x), 7) for x in vecs[i]],
                            }
                        )
                        + "\n"
                    )
                n += len(ids)
        log(f"Exported {n:,} embeddings to {output} (jsonl)")
        return n

    id_parts, vec_parts = [], []
    for ids, vecs in store.iter_embeddings():
        id_parts.append(ids)
        vec_parts.append(vecs)
    if id_parts:
        all_ids = np.concatenate(id_parts)
        all_vecs = np.concatenate(vec_parts).astype(np.float32)
    else:
        all_ids = np.zeros((0,), np.int64)
        all_vecs = np.zeros((0, store.embedding_dim), np.float32)
    paths = np.asarray(_paths_for_ids(store, all_ids))

    if fmt == "npy":
        # np.save appends ".npy" when absent — normalize first so the logged
        # path and the sidecar names match the file actually written.
        out_path = output if output.endswith(".npy") else output + ".npy"
        np.save(out_path, all_vecs)
        base = out_path[:-4]
        np.save(base + ".ids.npy", all_ids)
        with open(base + ".paths.txt", "w", encoding="utf-8") as f:
            f.write("\n".join(paths.tolist()))
        log(f"Exported {len(all_ids):,} embeddings to {out_path} (+ .ids.npy, .paths.txt)")
        return len(all_ids)

    arrays = {"image_ids": all_ids, "file_paths": paths, "vectors": all_vecs}
    if include_binary:
        bid_parts, bit_parts = [], []
        for ids, bits in store.iter_binary_embeddings():
            bid_parts.append(ids)
            bit_parts.append(bits)
        if bid_parts:
            arrays["binary_image_ids"] = np.concatenate(bid_parts)
            arrays["binary"] = np.concatenate(bit_parts)
    # np.savez_compressed appends ".npz" when absent — normalize so the
    # logged path matches the file actually written (same as the npy branch).
    out_path = output if output.endswith(".npz") else output + ".npz"
    np.savez_compressed(out_path, **arrays)
    log(f"Exported {len(all_ids):,} embeddings to {out_path} (npz)")
    return len(all_ids)
