"""The resident engine: model + database + device index (PyTorch port).

Port of ``tpuclip/engine.py``'s ``ImageDatabase``: the SigLIP towers live
on the device (bf16 on CUDA, fp32 on the CPU), batches are padded to fixed
shapes (one image or ``inference_batch_size`` images; texts on the
{1, 4, 16, 64} ladder), and the SQLite store, matrix cache, tokenizer and
thumbnailer are tpuclip's own. NaFlex models (SigLIP2's variable-aspect
towers) take uint8 patches, masks and patch grids in place of square
pixels, with the same two shapes. Text, single-image and mixed searches take
the fused tower + scan programs when the index allows them (int8, rerank
rows resident, no IVF index, no folder filter, k <= 128): one CUDA graph
per ladder bucket on the card (``tpuclip_torch.ops.graphs``), eager on the
CPU; otherwise embed, then search (under ``--mode ivf``, the IVF probe).
An image-only model (DINOv2, ``tpuclip_torch.models.dinov2``) loads no
tokenizer: its scans, image searches and dedup run as any other model's,
and every text entry raises a ``ValueError`` that says to search by image.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from tpuclip_torch.config import default_paths
from tpuclip_torch.index.store import MetadataStore
from tpuclip_torch.io.preprocess import preprocess_batch
from tpuclip_torch.io.thumbnails import Thumbnailer
from tpuclip_torch.text.tokenizer import build_prompt, load_tokenizer
from tpuclip_torch.utils.bucketing import batch_bucket
from tpuclip_torch.utils.logging import banner, log, safe_print_path
from tpuclip_torch.utils.profiling import span
from tpuclip_torch.device import DeviceLike, default_dtype, resolve_device
from tpuclip_torch.index.search import DeviceIndex
from tpuclip_torch.models.configs import DEFAULT_MODEL
from tpuclip_torch.models.loader import find_local_checkpoint, load_model, no_text_tower


class ImageDatabase:
    """Searchable image database: SigLIP embeddings + on-device retrieval."""

    def __init__(
        self,
        db_path: Optional[str] = None,
        model_cache_dir: Optional[str] = None,
        model_name: str = DEFAULT_MODEL,
        inference_batch_size: int = 16,
        compute_dtype: Optional[torch.dtype] = None,
        device: DeviceLike = None,
    ):
        banner("Initializing Image Database")
        paths = default_paths()
        self.db_path = db_path or paths.db_path
        self.model_cache_dir = model_cache_dir if model_cache_dir is not None else paths.model_cache_dir
        self.thumbnails_dir = paths.thumbnails_dir
        self.results_dir = paths.results_dir
        log(f"Database path: {self.db_path}")
        log(f"Model cache directory: {self.model_cache_dir}")

        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype or default_dtype(self.device)
        log(f"\nCompute device: {self.device}")
        log(f"  [OK] Data type: {self.compute_dtype}")

        log(f"\nLoading SigLIP 2 model...\n  Model: {model_name}")
        self.model_name = model_name
        self.config, self.model = load_model(
            model_name, self.model_cache_dir, device=self.device, dtype=self.compute_dtype
        )
        self.embedding_dim = self.config.embedding_dim
        self.image_size = self.config.vision.image_size
        self.inference_batch_size = int(inference_batch_size)
        log(f"  Embedding dimension: {self.embedding_dim}")

        self.tokenizer = None
        if self.has_text_tower:
            ckpt_dir = find_local_checkpoint(model_name, self.model_cache_dir)
            self.tokenizer = load_tokenizer(
                model_name,
                str(ckpt_dir) if ckpt_dir else None,
                vocab_size=self.config.text.vocab_size,
            )
        self._text_cache: dict = {}

        log("\nInitializing database...")
        self.store = MetadataStore(self.db_path, embedding_dim=self.embedding_dim)
        self.store.init_schema()
        stored_dim = self.store.stored_embedding_dim()
        if stored_dim and stored_dim != self.embedding_dim:
            log(
                f"  [WARNING] Database was built with {stored_dim}-d embeddings "
                f"but model '{model_name}' produces {self.embedding_dim}-d — "
                "searches will return no results. Use the model the database "
                "was scanned with (or a new --db)."
            )
        self.index = DeviceIndex(self.store, device=self.device)
        self.thumbnailer = Thumbnailer(self.thumbnails_dir)
        banner("Initialization complete!")

    @property
    def is_naflex(self) -> bool:
        return self.config.vision.naflex

    @property
    def has_text_tower(self) -> bool:
        return self.config.text is not None

    def _require_text_tower(self) -> None:
        """Raises the named ``ValueError`` for a model without a text tower."""
        if not self.has_text_tower:
            raise ValueError(no_text_tower(self.model_name))

    # ------------------------------------------------------------- embeddings

    def _embed_two_shapes(self, arrays) -> np.ndarray:
        """The vision tower (``model.image_features``) on its row-aligned
        host inputs: a single row runs at batch 1; anything else pads (with
        :meth:`_image_inputs`' pad row) or chunks to the inference batch.
        The real rows' L2-normalized fp32, on the host."""
        b, step = len(arrays[0]), self.inference_batch_size
        if b > step:
            return np.concatenate([
                self._embed_two_shapes([a[i : i + step] for a in arrays]) for i in range(0, b, step)
            ])
        with span("engine.stage"):
            target = 1 if b == 1 else step
            if target > b:
                pad_rows = self._image_inputs([], target - b)
                arrays = [np.concatenate([a, p]) for a, p in zip(arrays, pad_rows)]
            inputs = [torch.from_numpy(np.ascontiguousarray(a)).to(self.device) for a in arrays]
        with span("engine.forward"):
            out = self.model.image_features(*inputs)
        with span("engine.fetch"):
            return out[:b].cpu().numpy()

    def embed_images_uint8(self, batch_uint8: np.ndarray) -> np.ndarray:
        """uint8 (B, S, S, 3) → L2-normalized fp32 (B, D). A single image runs
        at batch 1; anything else pads (or chunks) to the inference batch."""
        return self._embed_two_shapes([batch_uint8])

    def embed_patches_naflex(self, patches: np.ndarray, masks: np.ndarray, shapes: np.ndarray) -> np.ndarray:
        """NaFlex: uint8 patches (B, L, P*P*C) + masks (B, L) + patch grids
        (B, 2) → L2-normalized fp32 (B, D), under the two-shape policy of
        :meth:`embed_images_uint8`."""
        return self._embed_two_shapes([patches, masks, shapes])

    def _tokenize_bucketed(self, texts: List[str]):
        """Prompt + tokenize, padded to the ladder batch size; pad rows are
        all-zero (masked out) and sliced off by the caller."""
        self._require_text_tower()
        b = len(texts)
        ids, mask = self.tokenizer.encode_batch_with_mask([build_prompt(t) for t in texts])
        bucket = batch_bucket(b)
        if bucket > b:
            pad = bucket - b
            ids = np.concatenate([ids, np.zeros((pad, ids.shape[1]), ids.dtype)])
            mask = np.concatenate([mask, np.zeros((pad, mask.shape[1]), mask.dtype)])
        return ids, mask

    def embed_texts(self, texts: List[str]) -> np.ndarray:
        """Prompted, tokenized, L2-normalized text embeddings (fp32)."""
        b = len(texts)
        if b == 0:
            return np.zeros((0, self.embedding_dim), np.float32)
        ids, mask = self._tokenize_bucketed(texts)
        out = self.model.get_text_features(
            torch.from_numpy(ids).to(self.device), torch.from_numpy(mask).to(self.device)
        )
        return out[:b].cpu().numpy()

    def embed_texts_cached(self, texts: List[str]) -> np.ndarray:
        """Batch text embedding through the session LRU (256 entries):
        hits skip the tower, misses embed in one pass."""
        self._require_text_tower()
        out = np.empty((len(texts), self.embedding_dim), np.float32)
        misses = []
        for i, t in enumerate(texts):
            cached = self._text_cache.get(t)
            if cached is not None:
                out[i] = cached
                self._text_cache[t] = self._text_cache.pop(t)  # refresh recency
            else:
                misses.append(i)
        if misses:
            fresh = self.embed_texts([texts[i] for i in misses])
            for j, i in enumerate(misses):
                out[i] = fresh[j]
                if len(self._text_cache) >= 256:
                    self._text_cache.pop(next(iter(self._text_cache)))
                self._text_cache[texts[i]] = fresh[j].copy()
        return out

    def search_texts(self, texts: List[str], k: int, filter_folders=None) -> List[List[tuple]]:
        """Batch text search: tokenize → text tower → int8 scan → rescore as
        one fused program when the index is eligible; embed (cached) + one
        ``search_batch`` pass otherwise."""
        if not texts:
            return []
        self._require_text_tower()
        if self.index.can_fuse_text_search(k, filter_folders):
            return self._search_texts_fused(texts, k)
        vecs = self.embed_texts_cached(texts)
        return self.index.search_batch(vecs, k, filter_folders=filter_folders)

    def _search_texts_fused(self, texts: List[str], k: int) -> List[List[tuple]]:
        """Fused body of :meth:`search_texts`; the caller has checked
        ``can_fuse_text_search`` (the serve micro-batcher decides it once
        per group)."""
        return self.index.search_fused(self.model, self._tokenize_bucketed(texts), (), k, len(texts), 0)

    def _image_inputs(self, images, rows: int) -> tuple:
        """Decoded images → the vision tower's host inputs for ``rows`` rows,
        images first: square models take (uint8 pixels (rows, S, S, 3),)
        with zero pad rows; NaFlex models take (uint8 patches (rows, L,
        P*P*C), int32 masks (rows, L), int32 patch grids (rows, 2)), whose
        pad rows keep slot 0 on a (1, 1) grid."""
        v = self.config.vision
        if not v.naflex:
            return (preprocess_batch(list(images) + [None] * (rows - len(images)), self.image_size),)
        from tpuclip_torch.io.preprocess import preprocess_naflex

        length = v.max_num_patches
        patches = np.zeros((rows, length, v.patch_size**2 * v.num_channels), np.uint8)
        masks = np.zeros((rows, length), np.int32)
        masks[:, 0] = 1
        shapes = np.ones((rows, 2), np.int32)
        for i, img in enumerate(images):
            patches[i], masks[i], shapes[i] = preprocess_naflex(img, v.patch_size, length)
        return patches, masks, shapes

    def _search_mixed_fused(self, texts: List[str], images: List, k: int):
        """Texts and images through both towers and ONE shared int8 scan, one
        program per (text bucket, image bucket); returns (text results,
        image results) aligned to the inputs. The caller has checked
        ``can_fuse_text_search``."""
        res = self.index.search_fused(
            self.model, self._tokenize_bucketed(texts), self._image_inputs(images, batch_bucket(len(images))), k,
            len(texts), len(images),
        )
        return res[: len(texts)], res[len(texts):]

    def search_image_pil(self, img, k: int, filter_folders=None) -> List[tuple]:
        """Single decoded-image search: vision tower → scan → rescore as one
        fused program when the index is eligible; embed + ``index.search``
        otherwise."""
        if self.index.can_fuse_image_search(k, filter_folders):
            return self._search_image_fused(img, k)
        return self.index.search(self._embed_pil(img), k, filter_folders=filter_folders)

    def _search_image_fused(self, img, k: int) -> List[tuple]:
        """Fused body of :meth:`search_image_pil` (one image, batch 1); the
        caller has checked ``can_fuse_image_search``."""
        return self.index.search_fused(self.model, (), self._image_inputs([img], 1), k, 0, 1)[0]

    def _embed_pil(self, img) -> np.ndarray:
        """Decoded PIL image → L2-normalized embedding; the embed path of
        path- and bytes-based image queries."""
        return self.embed_pils([img])[0].flatten()

    def _get_image_embedding(self, image_path: str) -> Optional[np.ndarray]:
        try:
            from tpuclip_torch.io.decode import load_image

            img = load_image(image_path)
            if img is None:
                return None
            return self._embed_pil(img)
        except Exception as e:  # noqa: BLE001 - containment, as in tpuclip
            safe_print_path("Error processing ", image_path, e)
            return None

    def embed_pils(self, images) -> np.ndarray:
        """L2-normalized embeddings for decoded PIL images, one batched pass."""
        return self._embed_two_shapes(self._image_inputs(images, len(images)))

    def _get_image_embeddings_batch(self, image_paths: List[str]) -> List[Optional[np.ndarray]]:
        """Embeddings of image files in one :meth:`embed_pils` pass, aligned
        to ``image_paths``: None where a file does not decode, and None for
        every file when the pass fails."""
        from tpuclip_torch.io.decode import load_image

        images = [load_image(p) for p in image_paths]
        valid = [i for i, img in enumerate(images) if img is not None]
        if not valid:
            return [None] * len(image_paths)
        try:
            embeddings = self.embed_pils([images[i] for i in valid])
            out: List[Optional[np.ndarray]] = [None] * len(image_paths)
            for j, i in enumerate(valid):
                out[i] = embeddings[j].flatten()
            return out
        except Exception as e:  # noqa: BLE001 - containment, as in tpuclip
            log(f"Error processing batch: {e}")
            return [None] * len(image_paths)

    def _get_text_embedding(self, text: str) -> np.ndarray:
        """Lowercase + template + 64-token pad contract, through the LRU."""
        return self.embed_texts_cached([text])[0]

    # ------------------------------------------------------------- pipelines

    def scan_directory(self, root_dir: str, **kwargs):
        from tpuclip_torch.pipelines.scan import scan_directory

        return scan_directory(self, root_dir, **kwargs)

    def search(self, query: str, **kwargs):
        from tpuclip_torch.pipelines.search import search

        return search(self, query, **kwargs)

    def search_by_embedding(self, embedding: np.ndarray, k: int = 10, **kwargs):
        from tpuclip_torch.pipelines.search import search_by_embedding

        return search_by_embedding(self, embedding, k, **kwargs)

    def embed_image_bytes(self, data: bytes) -> Optional[np.ndarray]:
        """L2-normalized embedding of in-memory raster bytes; None when they
        do not decode (the containment of path decodes)."""
        try:
            from tpuclip_torch.io.decode import load_image_bytes

            img = load_image_bytes(data, "<bytes>")
            if img is None:
                return None
            return self._embed_pil(img)
        except Exception as e:  # noqa: BLE001 - containment, as in tpuclip
            safe_print_path("Error processing ", "<image bytes>", e)
            return None

    def search_image_bytes(self, data: bytes, k: int = 10, filter_folders=None, show_duplicates: bool = False):
        """Decode, then the fused single-image program when the index is
        eligible (embed + search otherwise). None when the bytes do not
        decode to an image."""
        from tpuclip_torch.io.decode import load_image_bytes

        img = load_image_bytes(data, "<bytes>")
        if img is None:
            return None
        if self.index.can_fuse_image_search(k, filter_folders):
            results = self._search_image_fused(img, k)
            if not show_duplicates and results:
                from tpuclip_torch.index.dedup import filter_duplicates

                results = filter_duplicates(self.store, results)
            return results
        return self.search_by_embedding(
            self._embed_pil(img), k, filter_folders=filter_folders, show_duplicates=show_duplicates
        )

    def generate_html_gallery(self, results, output_file="results.html", query=None):
        from tpuclip_torch.gallery.html import generate_html_gallery

        generate_html_gallery(results, output_file, query=query, thumbnailer=self.thumbnailer)
