"""Checkpoint discovery and loading for the PyTorch port.

Port of ``tpuclip/models/loader.py``: the local model cache is probed first
(a tpuclip-native checkpoint or an HF-layout directory with config.json +
safetensors); otherwise ``TPUCLIP_INIT=random`` (or ``allow_random=True``)
builds a deterministic random init with the distributions of tpuclip's
``init_params``, drawn on the target device from a seeded
``torch.Generator``. Weights land on ``device`` in ``dtype`` either way.

DINOv2-with-registers and DINOv3 names (:data:`tpuclip_torch.models.dinov2.
PRESETS`, :data:`tpuclip_torch.models.dinov3.PRESETS`) build that image-only
model instead: from an HF-layout directory's safetensors under
``Dinov2WithRegistersModel``'s or ``DINOv3ViTModel``'s names, or at random.

Accepted layouts under ``model_cache_dir`` (same as tpuclip):
  1. ``<cache>/google--siglip2-so400m-patch14-224/``
  2. ``<cache>/models--google--siglip2-so400m-patch14-224/snapshots/<rev>/``
  3. ``<cache>/<name with '/' kept>/``
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

from tpuclip_torch.device import DeviceLike, resolve_device
from tpuclip_torch.utils.logging import log
from tpuclip_torch.models import convert, dinov2, dinov3
from tpuclip_torch.models.configs import (
    DEFAULT_MODEL,
    PRESETS,
    SiglipConfig,
    config_from_hf_dict,
    get_config,
)
from tpuclip_torch.models.siglip import SiglipModel, build_model, init_params_


def find_local_checkpoint(model_name: str, model_cache_dir: Optional[str]) -> Optional[Path]:
    """Locate a local checkpoint directory for model_name, or None."""
    if not model_cache_dir:
        return None
    cache = Path(model_cache_dir)
    flat = model_name.replace("/", "--")
    candidates = [cache / flat, cache / model_name]
    hub = cache / f"models--{flat}" / "snapshots"
    if hub.is_dir():
        snapshots = sorted(hub.iterdir(), key=lambda p: p.stat().st_mtime, reverse=True)
        candidates.extend(snapshots)
    for c in candidates:
        if c.is_dir() and ((c / "config.json").exists() or (c / "tpuclip.json").exists()):
            return c
    return None


def load_checkpoint_dir(
    model_dir: str, model_name: Optional[str] = None
) -> Tuple[SiglipConfig, Dict[str, Any]]:
    """(config, JAX-layout numpy params) from a tpuclip-native or HF-layout
    directory."""
    from tpuclip_torch.models.checkpoint import is_tpuclip_checkpoint, load_checkpoint

    if is_tpuclip_checkpoint(model_dir):
        return load_checkpoint(model_dir)
    with open(Path(model_dir) / "config.json", "r", encoding="utf-8") as f:
        hf_cfg = json.load(f)
    name = model_name or hf_cfg.get("_name_or_path") or str(model_dir)
    cfg = config_from_hf_dict(name, hf_cfg)
    params = convert.params_from_state_dict(convert.read_checkpoint_dir(model_dir), cfg)
    return cfg, params


def load_model(
    model_name: str = DEFAULT_MODEL,
    model_cache_dir: Optional[str] = None,
    device: DeviceLike = None,
    dtype: torch.dtype = torch.float32,
    allow_random: Optional[bool] = None,
    seed: int = 0,
) -> Tuple[SiglipConfig, SiglipModel]:
    """Resolve and load a model onto ``device`` (``resolve_device``: the
    card unless the caller names the CPU) in ``dtype``: local cache first,
    then error (or random init)."""
    device = resolve_device(device)
    for image_only in (dinov2, dinov3):
        if model_name in image_only.PRESETS:
            return _load_image_only(image_only, model_name, model_cache_dir, device, dtype, allow_random, seed)
    local = find_local_checkpoint(model_name, model_cache_dir)
    if local is not None:
        log(f"  Loading from local cache: {local}")
        cfg, params = load_checkpoint_dir(str(local), model_name)
        model = convert.load_jax_params(build_model(cfg, device, dtype), params)
        log("  [OK] Model weights loaded")
        return cfg, model

    if _allow_random(allow_random):
        log(
            f"  [WARNING] No local checkpoint for {model_name}; using deterministic "
            "random initialization (TPUCLIP_INIT=random). Embeddings will NOT match "
            "the pretrained model."
        )
        cfg = get_config(model_name) if model_name in PRESETS else get_config(DEFAULT_MODEL)
        generator = torch.Generator(device=device).manual_seed(seed)
        return cfg, init_params_(build_model(cfg, device, dtype), generator)

    raise _no_checkpoint(model_name, model_cache_dir)


def no_text_tower(name: str) -> str:
    """The refusal a text query gets from a model without a text tower."""
    return (f"model {name!r} embeds images only (it has no text tower): search by image "
            "(search --image PATH, an image:<path> query, or an image upload)")


def _allow_random(allow_random: Optional[bool]) -> bool:
    return os.environ.get("TPUCLIP_INIT", "") == "random" if allow_random is None else allow_random


def _load_image_only(module, model_name: str, model_cache_dir: Optional[str], device, dtype, allow_random,
                     seed: int):
    """A preset of an image-only model ``module`` (``dinov2`` or ``dinov3``):
    the local HF checkpoint's weights, or the random init."""
    local = find_local_checkpoint(model_name, model_cache_dir)
    cfg = module.get_config(model_name)
    model = module.build_model(cfg, device, dtype)
    if local is not None:
        log(f"  Loading from local cache: {local}")
        module.load_hf_state_dict(model, convert.read_checkpoint_dir(str(local)))
        log("  [OK] Model weights loaded")
        return cfg, model
    if not _allow_random(allow_random):
        raise _no_checkpoint(model_name, model_cache_dir)
    log(f"  [WARNING] No local checkpoint for {model_name}; using deterministic random "
        "initialization (TPUCLIP_INIT=random). Embeddings will NOT match the pretrained model.")
    return cfg, module.init_params_(model, torch.Generator(device=device).manual_seed(seed))


def _no_checkpoint(model_name: str, model_cache_dir: Optional[str]) -> FileNotFoundError:
    return FileNotFoundError(
        f"No local checkpoint found for {model_name!r} under "
        f"{model_cache_dir!r}, and network download is not available in this "
        "build. Place the HF checkpoint (config.json + model.safetensors) at "
        f"<model_cache>/{model_name.replace('/', '--')}/ or set "
        "TPUCLIP_INIT=random for a random-weight smoke mode."
    )
