"""Reading tpuclip-native checkpoints.

The read side of ``tpuclip/models/checkpoint.py`` (that module imports the
jax side through ``tpuclip.models``), so a checkpoint written by tpuclip's
``save_checkpoint`` loads in the port:

    <dir>/tpuclip.json          config + format version
    <dir>/model.safetensors     flat '/'-joined tree keys, stacked layers,
                                (in, out) kernel layout
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np

from tpuclip_torch.models.configs import SiglipConfig, TextConfig, VisionConfig
from tpuclip_torch.models.convert import read_safetensors

_FORMAT_VERSION = 1


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def is_tpuclip_checkpoint(directory: str) -> bool:
    return (Path(directory) / "tpuclip.json").exists()


def load_checkpoint(directory: str) -> Tuple[SiglipConfig, Dict[str, Any]]:
    d = Path(directory)
    with open(d / "tpuclip.json", "r", encoding="utf-8") as f:
        meta = json.load(f)
    if meta.get("format_version") != _FORMAT_VERSION:
        raise ValueError(f"Unsupported tpuclip checkpoint version: {meta.get('format_version')}")
    cfg = SiglipConfig(
        name=meta["name"],
        vision=VisionConfig(**meta["vision"]),
        text=TextConfig(**meta["text"]),
    )
    flat = read_safetensors(str(d / "model.safetensors"))
    return cfg, _unflatten(flat)
