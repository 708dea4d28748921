"""Search pipeline: query algebra + device top-k + duplicate filtering.

PyTorch port of ``tpuclip/pipelines/search.py``; the query algebra is
unchanged. A plain single-image query on an eligible index takes the fused
vision tower + scan program (``engine._search_image_fused``), as in tpuclip.

Mirrors ``ImageDatabase.search`` (image_database.py:1308-1658):
- first/second query embeddings (text or image), weighted blend with weight
  normalization and zero-norm fallback to query 1 (:1379-1396),
- single and multiple negative prompts, subtracted then re-normalized, with
  zero-norm restore of the original blend (:545-604),
- folder filters (LIKE-prefix semantics) (:1513-1529),
- full-precision search preferred, binary fallback (:1532-1629) — both now a
  single on-device top-k (tpuclip.index.search),
- duplicate filtering default-on (:1644-1646),
- opt-in per-step timing report (:1649-1656).
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from tpuclip_torch.index.dedup import filter_duplicates
from tpuclip_torch.utils.logging import log
from tpuclip_torch.utils.profiling import Timings


def _normalize(v: np.ndarray) -> np.ndarray:
    norm = np.linalg.norm(v)
    return v / norm if norm > 0 else v


def apply_negative_embeddings(
    embedding: np.ndarray,
    negative_embs: List[np.ndarray],
    negative_weights: List[float],
    embedding1: np.ndarray,
    embedding2: Optional[np.ndarray],
    weights: Tuple[float, float],
) -> np.ndarray:
    """``e - Σ wᵢ·negᵢ`` then re-normalize; zero-norm restores the original
    blend (image_database.py:545-604)."""
    for neg_emb, neg_weight in zip(negative_embs, negative_weights):
        embedding = embedding - neg_weight * neg_emb
    norm = np.linalg.norm(embedding)
    if norm > 0:
        return embedding / norm
    log("Warning: Embedding became zero after negative subtraction, using original")
    if embedding2 is None:
        return embedding1
    # Re-derive the original blend through combine_embeddings so the
    # zero-total-weight guard applies here too (a hand-rolled copy divided
    # by zero when weights == (0, 0)).
    return combine_embeddings(embedding1, embedding2, weights)


def combine_embeddings(
    embedding1: np.ndarray,
    embedding2: np.ndarray,
    weights: Tuple[float, float],
) -> np.ndarray:
    """Weighted positive blend with re-normalization; zero-norm falls back to
    query 1 (image_database.py:1379-1396)."""
    total = weights[0] + weights[1]
    if total == 0:
        weights = (0.5, 0.5)
        total = 1.0
    w1, w2 = weights[0] / total, weights[1] / total
    embedding = w1 * embedding1 + w2 * embedding2
    norm = np.linalg.norm(embedding)
    if norm > 0:
        return embedding / norm
    log("Warning: Combined embedding has zero norm, using first query only")
    return embedding1


def build_query_vector(
    engine,
    query: str,
    is_image_path: bool = False,
    query2: Optional[str] = None,
    is_image_path2: bool = False,
    weights: Tuple[float, float] = (0.5, 0.5),
    negative_query: Optional[str] = None,
    negative_is_image: bool = False,
    negative_weight: float = 0.5,
    negative_queries: Optional[List[str]] = None,
    negative_is_images: Optional[List[bool]] = None,
    negative_weights: Optional[List[float]] = None,
    timings: Optional[Timings] = None,
) -> Optional[np.ndarray]:
    """Assemble the final query vector; None on unrecoverable input errors."""
    t = timings if timings is not None else Timings()

    # --- first query ---------------------------------------------------------
    if is_image_path:
        if not os.path.exists(query):
            log(f"Error: Image file {query} does not exist")
            return None
        log(f"Processing image query: {query}")
        with t.track("embedding1_image"):
            embedding1 = engine._get_image_embedding(query)
        if embedding1 is None:
            log("Error: Failed to generate embedding from image")
            return None
    else:
        log(f"Processing text query: {query}")
        with t.track("embedding1_text"):
            embedding1 = engine._get_text_embedding(query)

    # --- optional second query, weighted blend -------------------------------
    embedding2 = None
    if query2 is not None:
        if is_image_path2:
            if not os.path.exists(query2):
                log(f"Error: Image file {query2} does not exist")
                return None
            log(f"Processing second image query: {query2}")
            with t.track("embedding2_image"):
                embedding2 = engine._get_image_embedding(query2)
            if embedding2 is None:
                log("Error: Failed to generate embedding from second image")
                return None
        else:
            log(f"Processing second text query: {query2}")
            with t.track("embedding2_text"):
                embedding2 = engine._get_text_embedding(query2)
        with t.track("combine_embeddings"):
            embedding = combine_embeddings(embedding1, embedding2, weights)
    else:
        embedding = embedding1

    # --- negatives ------------------------------------------------------------
    negative_embs_list: List[np.ndarray] = []
    negative_weights_list: List[float] = []

    if negative_query is not None:
        if negative_is_image:
            if not os.path.exists(negative_query):
                log(
                    f"Warning: Negative image file {negative_query} does not exist, "
                    "ignoring negative prompt"
                )
            else:
                log(f"Processing negative image: {negative_query}")
                with t.track("negative_embedding_image"):
                    neg = engine._get_image_embedding(negative_query)
                if neg is not None:
                    negative_embs_list.append(neg)
                    negative_weights_list.append(negative_weight)
        else:
            log(f"Processing negative text: {negative_query}")
            with t.track("negative_embedding_text"):
                neg = engine._get_text_embedding(negative_query)
            if neg is not None:
                negative_embs_list.append(neg)
                negative_weights_list.append(negative_weight)

    if negative_queries is not None:
        for i, neg_q in enumerate(negative_queries):
            neg_is_img = (
                negative_is_images[i]
                if negative_is_images and i < len(negative_is_images)
                else False
            )
            neg_w = (
                negative_weights[i]
                if negative_weights and i < len(negative_weights)
                else negative_weight
            )
            if neg_is_img:
                if not os.path.exists(neg_q):
                    log(f"Warning: Negative image file {neg_q} does not exist, skipping")
                    continue
                log(f"Processing negative image {i + 1}: {neg_q}")
                with t.track(f"negative_embedding_image_{i}"):
                    neg = engine._get_image_embedding(neg_q)
            else:
                log(f"Processing negative text {i + 1}: {neg_q}")
                with t.track(f"negative_embedding_text_{i}"):
                    neg = engine._get_text_embedding(neg_q)
            if neg is not None:
                negative_embs_list.append(neg)
                negative_weights_list.append(neg_w)

    if negative_embs_list:
        if len(negative_embs_list) == 1:
            log(f"Applying negative prompt (weight: {negative_weights_list[0]})...")
        else:
            joined = ", ".join(f"{w:.2f}" for w in negative_weights_list)
            log(f"Applying {len(negative_embs_list)} negative prompts (weights: {joined})...")
        with t.track("apply_negative"):
            embedding = apply_negative_embeddings(
                embedding, negative_embs_list, negative_weights_list,
                embedding1, embedding2, weights,
            )

    return embedding


def search(
    engine,
    query: str,
    k: int = 10,
    is_image_path: bool = False,
    query2: Optional[str] = None,
    is_image_path2: bool = False,
    weights: Tuple[float, float] = (0.5, 0.5),
    negative_query: Optional[str] = None,
    negative_is_image: bool = False,
    negative_weight: float = 0.5,
    negative_queries: Optional[List[str]] = None,
    negative_is_images: Optional[List[bool]] = None,
    negative_weights: Optional[List[float]] = None,
    filter_folders: Optional[List[str]] = None,
    profile: bool = False,
    show_duplicates: bool = False,
) -> List[Tuple[str, float]]:
    """Full search: returns [(file_path, similarity)] descending."""
    timings = Timings()

    # Plain single-image query (no blend, no negatives) on an eligible
    # index: decode → ONE fused vision tower + scan + rescore program.
    # Query algebra stays two-stage (it mixes host-side vectors).
    if (
        is_image_path
        and query2 is None
        and negative_query is None
        and not negative_queries
        and engine.index.can_fuse_image_search(k, filter_folders)
    ):
        if not os.path.exists(query):
            log(f"Error: Image file {query} does not exist")
            return []
        log(f"Processing image query: {query}")
        from tpuclip_torch.io.decode import load_image

        with timings.track("fused_image_search"):
            img = load_image(query)
            if img is None:
                log(f"Error: Could not decode image file {query}")
                return []
            try:
                results = engine._search_image_fused(img, k)
            except NotImplementedError:
                raise  # a mode the port lacks must not read as "no results"
            except Exception as e:  # noqa: BLE001 - same containment as below
                log(f"Error during search: {e}")
                return []
        if not show_duplicates and results:
            with timings.track("filter_duplicates"):
                results = filter_duplicates(engine.store, results)
        if profile:
            timings.report()
        return results

    embedding = build_query_vector(
        engine, query, is_image_path, query2, is_image_path2, weights,
        negative_query, negative_is_image, negative_weight,
        negative_queries, negative_is_images, negative_weights,
        timings=timings,
    )
    if embedding is None:
        return []

    results = search_by_embedding(
        engine, embedding, k,
        filter_folders=filter_folders,
        show_duplicates=show_duplicates,
        timings=timings,
    )
    if profile:
        timings.report()
    return results


def search_by_embedding(
    engine,
    embedding: np.ndarray,
    k: int = 10,
    filter_folders: Optional[List[str]] = None,
    show_duplicates: bool = False,
    timings: Optional["Timings"] = None,
) -> List[Tuple[str, float]]:
    """Index scan + duplicate filter for an already-built query vector
    (the second half of ``search``; also the entry point for callers that
    bring their own embedding, e.g. serve's base64 image queries)."""
    timings = timings or Timings()
    full_count, binary_count = engine.store.count_embeddings()
    if full_count == 0 and binary_count == 0:
        log("Error: Database has no embeddings. Please run scan first.")
        return []

    log(f"Searching database for top {k} results...")
    if filter_folders:
        log(f"Filtering to {len(filter_folders)} folder(s):")
        for folder in filter_folders:
            log(f"  - {folder}")

    try:
        with timings.track("index_refresh"):
            engine.index.refresh()
        with timings.track("db_query"):
            results = engine.index.search(embedding, k, filter_folders=filter_folders)
    except NotImplementedError:
        raise  # a mode the port lacks must not read as "no results"
    except Exception as e:  # noqa: BLE001
        log(f"Error during search: {e}")
        return []

    if not show_duplicates and len(results) > 0:
        with timings.track("filter_duplicates"):
            results = filter_duplicates(engine.store, results)
    return results
