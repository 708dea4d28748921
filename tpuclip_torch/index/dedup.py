"""Search-result duplicate filtering.

A copy of ``tpuclip/index/dedup.py`` (which imports jax through
``tpuclip.ops.hamming``), pinned to the original by
``tests/test_torch_imports.py``. Champion clustering runs in numpy here
(:func:`dedup_champions`, the pass structure of
``tpuclip.native.dedup_champions``), whose own fallback imports jax.

Same semantics as ``_filter_duplicates`` (image_database.py:1207-1306):
default-on at search time, compares binary (sign) embeddings of the result
set pairwise, treats rows within ``tolerance_bits`` Hamming distance as
duplicates, keeps the higher-similarity member, and re-sorts. Results without
binary rows are always kept. The pairwise work is O(k²) over at most a few
hundred rows — vectorized numpy popcount on packed bits.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from tpuclip_torch.index.store import MetadataStore
from tpuclip_torch.ops.hamming import hamming_distance_packed, pack_bits
from tpuclip_torch.utils.logging import log

DEFAULT_TOLERANCE_BITS = 2


def filter_duplicates(
    store: MetadataStore,
    results: List[Tuple[str, float]],
    tolerance_bits: int = DEFAULT_TOLERANCE_BITS,
) -> List[Tuple[str, float]]:
    if len(results) == 0:
        return results
    binaries = store.fetch_binary_for_paths([fp for fp, _ in results])
    return _filter_with_binaries(results, binaries, tolerance_bits)


def filter_duplicates_many(
    store: MetadataStore,
    results_lists: List[List[Tuple[str, float]]],
    tolerance_bits: int = DEFAULT_TOLERANCE_BITS,
) -> List[List[Tuple[str, float]]]:
    """Batched variant for the serve micro-batcher: ONE binary fetch (one
    connection, one chunked query) over the union of paths, then per-list
    champion clustering. The per-request version cost a connection + query
    per request inside the engine-locked window — ~30% of window time at
    c=64 in the r5 load bench."""
    union: List[str] = []
    seen = set()
    for results in results_lists:
        for fp, _ in results:
            if fp not in seen:
                seen.add(fp)
                union.append(fp)
    binaries = store.fetch_binary_for_paths(union) if union else {}
    return [
        _filter_with_binaries(results, binaries, tolerance_bits)
        if results else results
        for results in results_lists
    ]


def _filter_with_binaries(
    results: List[Tuple[str, float]],
    binaries,
    tolerance_bits: int,
) -> List[Tuple[str, float]]:
    kept: List[Tuple[str, float]] = []  # results that had no binary row
    packed_rows: List[np.ndarray] = []
    packed_items: List[Tuple[str, float]] = []
    for file_path, similarity in results:
        bits = binaries.get(file_path)
        if bits is None:
            kept.append((file_path, similarity))
        else:
            packed_rows.append(pack_bits(bits))
            packed_items.append((file_path, similarity))

    if packed_items:
        rows = np.stack(packed_rows)
        sims = np.array([s for _, s in packed_items], np.float32)
        champions = dedup_champions(rows, sims, tolerance_bits)
        champion_order = list(dict.fromkeys(int(c) for c in champions))
        duplicates_removed = len(packed_items) - len(champion_order)
        filtered = kept + [packed_items[i] for i in champion_order]
    else:
        duplicates_removed = 0
        filtered = kept
    if duplicates_removed > 0:
        log(f"Filtered out {duplicates_removed} duplicate(s) (tolerance: {tolerance_bits} bits)")
    filtered.sort(key=lambda x: x[1], reverse=True)
    return filtered


def dedup_champions(
    packed_rows: np.ndarray, similarities: np.ndarray, tolerance_bits: int
) -> np.ndarray:
    """Reference duplicate clustering: rows join the first champion within
    ``tolerance_bits``; a higher-similarity member becomes the champion.
    Returns, per row, the index of its cluster's final champion."""
    n = packed_rows.shape[0]
    champs: List[int] = []
    cluster_of = np.zeros(n, np.int64)
    for i in range(n):
        found = -1
        for ci, ch in enumerate(champs):
            if hamming_distance_packed(packed_rows[i], packed_rows[ch]) <= tolerance_bits:
                found = ci
                break
        if found < 0:
            cluster_of[i] = len(champs)
            champs.append(i)
        else:
            cluster_of[i] = found
            if similarities[i] > similarities[champs[found]]:
                champs[found] = i
    return np.array([champs[c] for c in cluster_of], np.int64)
