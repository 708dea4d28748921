"""Whole-database duplicate discovery.

The reference only filters duplicates within one search's result set
(image_database.py:1207-1306). This pipeline finds ALL near-duplicate
clusters in a database from the stored sign-bit embeddings, scaling past the
O(n²) pairwise approach with the standard banding trick:

For Hamming tolerance t over D bits, split each signature into (t + 1)
bands — two signatures within t differing bits must agree EXACTLY on at
least one band (pigeonhole). Bucket rows by each band's bytes, then verify
candidate pairs with a real popcount. Exact (no false negatives) unless a
degenerate bucket exceeds ``max_bucket`` — capped buckets trade completeness
for bounded work and are reported with a warning. Verification work
collapses to within-bucket pairs.

Cluster representative = lowest image_id (stable across runs); union-find
merges overlapping pairs.

PyTorch port of ``tpuclip/pipelines/duplicates.py``: the same bands,
union-find and cluster order, on the host in numpy; the popcount is the
port's numpy ``hamming_distance_packed`` (tpuclip's module imports jax).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

from tpuclip_torch.index.cache import MatrixCache
from tpuclip_torch.index.store import MetadataStore
from tpuclip_torch.ops.hamming import hamming_distance_packed
from tpuclip_torch.utils.logging import log


class _UnionFind:
    def __init__(self, n: int):
        self.parent = np.arange(n, dtype=np.int64)

    def find(self, x: int) -> int:
        root = x
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[x] != root:
            self.parent[x], x = root, self.parent[x]
        return root

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[max(ra, rb)] = min(ra, rb)


def find_duplicate_clusters(
    store: MetadataStore, tolerance_bits: int = 2, max_bucket: int = 2000
) -> List[List[Tuple[int, str]]]:
    """All duplicate clusters (size >= 2) as [(image_id, path), ...] lists,
    ordered largest-first. ``tolerance_bits`` matches the search-time filter
    default (image_database.py:1214)."""
    cache = MatrixCache(store)
    ids, packed = cache.load_binary()
    n = len(ids)
    if n < 2:
        return []
    packed = np.asarray(packed)

    bands = tolerance_bits + 1
    nbytes = packed.shape[1]
    band_edges = np.linspace(0, nbytes, bands + 1, dtype=int)

    uf = _UnionFind(n)
    verified_pairs = 0
    candidate_pairs = 0
    for b in range(bands):
        lo, hi = band_edges[b], band_edges[b + 1]
        buckets: Dict[bytes, List[int]] = defaultdict(list)
        band_bytes = packed[:, lo:hi]
        for i in range(n):
            buckets[band_bytes[i].tobytes()].append(i)
        for members in buckets.values():
            if len(members) < 2:
                continue
            if len(members) > max_bucket:
                log(
                    f"  [WARNING] band {b}: bucket of {len(members)} rows capped at "
                    f"{max_bucket} (degenerate signatures?)"
                )
                members = members[:max_bucket]
            arr = np.array(members)
            # verify pairs within the bucket (skip already-merged)
            for ai in range(len(arr)):
                i = arr[ai]
                rest = arr[ai + 1 :]
                if len(rest) == 0:
                    continue
                candidate_pairs += len(rest)
                d = hamming_distance_packed(
                    np.broadcast_to(packed[i], (len(rest), nbytes)), packed[rest]
                )
                for j in rest[np.asarray(d) <= tolerance_bits]:
                    uf.union(int(i), int(j))
                    verified_pairs += 1

    clusters: Dict[int, List[int]] = defaultdict(list)
    for i in range(n):
        clusters[uf.find(i)].append(i)
    dup_clusters = [v for v in clusters.values() if len(v) >= 2]
    dup_clusters.sort(key=len, reverse=True)

    all_ids = [int(ids[i]) for cluster in dup_clusters for i in cluster]
    paths = store.fetch_paths_for_ids(all_ids)
    out = [
        [(int(ids[i]), paths.get(int(ids[i]), "<missing>")) for i in cluster]
        for cluster in dup_clusters
    ]
    log(
        f"  Checked {candidate_pairs:,} candidate pairs "
        f"({verified_pairs:,} within tolerance) across {bands} bands"
    )
    return out


def report_duplicates(db_path: str, tolerance_bits: int = 2) -> None:
    store = MetadataStore(db_path)
    dim = store.stored_embedding_dim()
    if dim:
        store.embedding_dim = dim
    clusters = find_duplicate_clusters(store, tolerance_bits)
    total_rows = sum(len(c) for c in clusters)
    log(
        f"\nFound {len(clusters)} duplicate cluster(s) covering {total_rows} images "
        f"(tolerance: {tolerance_bits} bits)"
    )
    for idx, cluster in enumerate(clusters, 1):
        log(f"\nCluster {idx} ({len(cluster)} images):")
        for image_id, path in cluster:
            log(f"  [{image_id}] {path}")
    if clusters:
        redundant = total_rows - len(clusters)
        log(f"\n{redundant} image(s) could be removed keeping one per cluster.")
