"""tpuclip-native checkpoints, read and written.

A copy of ``tpuclip/models/checkpoint.py`` (that module imports the jax side
through ``tpuclip.models``): a checkpoint written by either package's
``save_checkpoint`` loads in the other with equal parameters.

    <dir>/tpuclip.json          config + format version
    <dir>/model.safetensors     flat '/'-joined tree keys, stacked layers,
                                (in, out) kernel layout
"""

from __future__ import annotations

import json
import struct
from dataclasses import asdict
from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np

from tpuclip_torch.models.configs import SiglipConfig, TextConfig, VisionConfig
from tpuclip_torch.models.convert import read_safetensors

_FORMAT_VERSION = 1

_NP_TO_ST = {
    np.dtype(np.float64): "F64",
    np.dtype(np.float32): "F32",
    np.dtype(np.float16): "F16",
    np.dtype(np.int64): "I64",
    np.dtype(np.int32): "I32",
    np.dtype(np.int8): "I8",
    np.dtype(np.uint8): "U8",
    np.dtype(np.bool_): "BOOL",
}


def _st_dtype_name(arr: np.ndarray) -> str:
    # Compare by name: np.dtype("bfloat16") raises TypeError unless ml_dtypes
    # has registered the type, which would break writing even plain f32 arrays.
    if str(arr.dtype) == "bfloat16":
        return "BF16"
    try:
        return _NP_TO_ST[arr.dtype]
    except KeyError as e:
        raise ValueError(f"Unsupported dtype for safetensors: {arr.dtype}") from e


def write_safetensors(path: str, tensors: Dict[str, np.ndarray]) -> None:
    """Write a .safetensors file (header-json + raw little-endian data)."""
    header: Dict[str, Any] = {}
    offset = 0
    blobs = []
    for name in sorted(tensors):
        arr = np.asarray(tensors[name])
        if not arr.flags["C_CONTIGUOUS"]:
            # Not unconditional: np.ascontiguousarray promotes 0-d arrays to
            # shape (1,), which would corrupt scalar leaves (logit_bias).
            arr = np.ascontiguousarray(arr)
        data = arr.tobytes()
        header[name] = {
            "dtype": _st_dtype_name(arr),
            "shape": list(arr.shape),
            "data_offsets": [offset, offset + len(data)],
        }
        offset += len(data)
        blobs.append(data)
    header_bytes = json.dumps(header, separators=(",", ":")).encode("utf-8")
    # pad header to 8 bytes like the upstream writer
    pad = (-len(header_bytes)) % 8
    header_bytes += b" " * pad
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(header_bytes)))
        f.write(header_bytes)
        for b in blobs:
            f.write(b)


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def save_checkpoint(directory: str, params: Any, cfg: SiglipConfig) -> None:
    """Write ``params`` (the JAX-layout numpy tree, as
    ``loader.load_checkpoint_dir`` returns it) and ``cfg`` as a
    tpuclip-native checkpoint."""
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    meta = {
        "format_version": _FORMAT_VERSION,
        "name": cfg.name,
        "vision": asdict(cfg.vision),
        "text": asdict(cfg.text),
    }
    with open(d / "tpuclip.json", "w", encoding="utf-8") as f:
        json.dump(meta, f, indent=2)
    write_safetensors(str(d / "model.safetensors"), _flatten(params))


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
