"""Zero-shot classification (PyTorch port of ``tpuclip/pipelines/classify.py``).

SigLIP is a classifier by construction: per-label sigmoid probabilities from
``logit_scale * cos(image, text) + logit_bias`` (the training objective),
plus a softmax view for forced-choice ranking. Same prompt template and
preprocessing contracts as search, no database required.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from tpuclip_torch.device import DeviceLike, default_dtype, resolve_device
from tpuclip_torch.utils.logging import log


def classify_image(
    image_path: str,
    labels: List[str],
    model_name: str,
    model_cache_dir: Optional[str] = None,
    device: DeviceLike = None,
) -> List[Tuple[str, float, float]]:
    """Returns [(label, sigmoid_prob, softmax_prob)] sorted descending. The
    towers run on ``device`` (the card unless the caller names the CPU)."""
    from tpuclip_torch.io.prefetch import decode_single
    from tpuclip_torch.models.loader import find_local_checkpoint, load_model
    from tpuclip_torch.text.tokenizer import build_prompt, load_tokenizer

    device = resolve_device(device)
    cfg, model = load_model(model_name, model_cache_dir, device=device, dtype=default_dtype(device))
    if cfg.vision.naflex:
        # The square decode below does not fit NaFlex's patch inputs
        # (tpuclip refuses the same).
        raise ValueError(
            f"{model_name} is a NaFlex model, which classify does not support yet; "
            "use a fixed-resolution preset"
        )
    if cfg.text is None:  # an image-only model: no labels to score against
        from tpuclip_torch.models.loader import no_text_tower

        raise ValueError(no_text_tower(model_name))
    ckpt = find_local_checkpoint(model_name, model_cache_dir)
    tokenizer = load_tokenizer(model_name, str(ckpt) if ckpt else None, vocab_size=cfg.text.vocab_size)

    pixels = decode_single(image_path, cfg.vision.image_size)
    if pixels is None:
        raise ValueError(f"Could not decode image: {image_path}")
    img = model.get_image_features(torch.from_numpy(np.array(pixels[None])).to(device))[0].cpu().numpy()

    ids, mask = tokenizer.encode_batch_with_mask([build_prompt(t) for t in labels])
    txt = model.get_text_features(
        torch.from_numpy(ids).to(device), torch.from_numpy(mask).to(device)
    ).cpu().numpy()
    return score_labels(labels, txt, img, model)


def score_labels(labels: List[str], txt: np.ndarray, img: np.ndarray, model) -> List[Tuple[str, float, float]]:
    """SigLIP head over unit-norm embeddings: per-label sigmoid probability
    (``logit_scale * cos + logit_bias``) plus a softmax view for forced
    choice, with the model's own scale and bias. Returns [(label, sigmoid,
    softmax)] sorted by sigmoid descending."""
    cos = txt @ img
    scale = float(np.exp(np.float32(model.logit_scale.float().item())))
    bias = float(np.float32(model.logit_bias.float().item()))
    logits = scale * cos + bias
    sigmoid = 1.0 / (1.0 + np.exp(-logits))
    z = logits - logits.max()
    softmax = np.exp(z) / np.exp(z).sum()

    ranked = sorted(zip(labels, sigmoid, softmax), key=lambda x: x[1], reverse=True)
    return [(l, float(p), float(sm)) for l, p, sm in ranked]


def classify_pil(engine, img, labels: List[str]) -> List[Tuple[str, float, float]]:
    """Zero-shot classification against a resident engine (serve's
    /classify): its loaded towers and its text-embedding LRU, no model load
    per call."""
    img_emb = engine._embed_pil(img)
    txt = engine.embed_texts_cached(list(labels))
    return score_labels(list(labels), txt, img_emb, engine.model)


def run_classify(image_path: str, labels: List[str], model_name: str, model_cache_dir, device: DeviceLike = None) -> None:
    results = classify_image(image_path, labels, model_name, model_cache_dir, device=device)
    log(f"\nZero-shot classification of {image_path}:")
    for label, prob, sm in results:
        log(f"  {prob * 100:6.2f}%  (rel {sm * 100:5.1f}%)  {label}")
