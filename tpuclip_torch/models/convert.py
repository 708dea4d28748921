"""Checkpoint conversion for the PyTorch port.

``read_safetensors``, ``read_checkpoint_dir`` and ``params_from_state_dict``
are copies of ``tpuclip/models/convert.py`` (that module imports the jax
side through ``tpuclip.models``); ``tests/test_torch_imports.py`` pins them
to the originals. They produce the JAX package's parameter tree as numpy:
(in, out) kernels, per-layer tensors stacked on a leading layer axis.
:func:`load_jax_params` carries such a tree into a
:class:`~tpuclip_torch.models.siglip.SiglipModel`, and
:func:`model_to_jax_params` takes it back out (a trained model goes to
tpuclip's checkpoint format that way).

One difference from the original reader: BF16 tensors are widened to fp32
with integer bit ops, so reading needs no ``ml_dtypes``.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Any, Dict, Mapping

import numpy as np
import torch

from tpuclip_torch.models.configs import SiglipConfig

__all__ = [
    "read_safetensors", "read_checkpoint_dir", "params_from_state_dict",
    "load_jax_params", "model_to_jax_params",
]


# =============================================================================
# Minimal safetensors reader (format: u64 header_len | JSON header | raw data)
# =============================================================================

_ST_DTYPES = {
    "F64": np.float64,
    "F32": np.float32,
    "F16": np.float16,
    "I64": np.int64,
    "I32": np.int32,
    "I16": np.int16,
    "I8": np.int8,
    "U8": np.uint8,
    "BOOL": np.bool_,
}


def _st_dtype(name: str):
    if name == "BF16":
        return np.dtype(np.uint16)  # widened to fp32 in read_safetensors
    try:
        return np.dtype(_ST_DTYPES[name])
    except KeyError as e:
        raise ValueError(f"Unsupported safetensors dtype: {name}") from e


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Read a .safetensors file into a dict of numpy arrays."""
    with open(path, "rb") as f:
        (header_len,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(header_len))
        data = f.read()
    out: Dict[str, np.ndarray] = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        dtype = _st_dtype(meta["dtype"])
        shape = meta["shape"]
        start, end = meta["data_offsets"]
        arr = np.frombuffer(data[start:end], dtype=dtype)
        if meta["dtype"] == "BF16":
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        out[name] = arr.reshape(shape)
    return out


def read_checkpoint_dir(model_dir: str) -> Dict[str, np.ndarray]:
    """Read all weights from an HF-layout model directory (single or sharded
    safetensors; falls back to pytorch_model.bin via torch)."""
    d = Path(model_dir)
    index = d / "model.safetensors.index.json"
    if index.exists():
        with open(index, "r", encoding="utf-8") as f:
            weight_map: Mapping[str, str] = json.load(f)["weight_map"]
        tensors: Dict[str, np.ndarray] = {}
        for shard in sorted(set(weight_map.values())):
            tensors.update(read_safetensors(str(d / shard)))
        return tensors
    single = d / "model.safetensors"
    if single.exists():
        return read_safetensors(str(single))
    torch_bin = d / "pytorch_model.bin"
    if torch_bin.exists():
        import torch

        sd = torch.load(str(torch_bin), map_location="cpu", weights_only=True)
        return {k: v.float().numpy() for k, v in sd.items()}
    raise FileNotFoundError(
        f"No model weights found in {model_dir} "
        "(looked for model.safetensors[.index.json], pytorch_model.bin)"
    )


# =============================================================================
# State-dict → pytree
# =============================================================================


def _f32(x: np.ndarray) -> np.ndarray:
    return np.asarray(x, dtype=np.float32) if x.dtype != np.float32 else x


def _t(x: np.ndarray) -> np.ndarray:
    """torch Linear weight (out, in) → (in, out)."""
    return _f32(x).T.copy()


def _encoder_stack(sd: Mapping[str, np.ndarray], prefix: str, num_layers: int) -> Dict[str, np.ndarray]:
    def stack(fmt: str, transform) -> np.ndarray:
        return np.stack([transform(np.asarray(sd[fmt.format(i=i)])) for i in range(num_layers)])

    p = prefix
    return {
        "ln1_scale": stack(p + ".layers.{i}.layer_norm1.weight", _f32),
        "ln1_bias": stack(p + ".layers.{i}.layer_norm1.bias", _f32),
        "q_kernel": stack(p + ".layers.{i}.self_attn.q_proj.weight", _t),
        "q_bias": stack(p + ".layers.{i}.self_attn.q_proj.bias", _f32),
        "k_kernel": stack(p + ".layers.{i}.self_attn.k_proj.weight", _t),
        "k_bias": stack(p + ".layers.{i}.self_attn.k_proj.bias", _f32),
        "v_kernel": stack(p + ".layers.{i}.self_attn.v_proj.weight", _t),
        "v_bias": stack(p + ".layers.{i}.self_attn.v_proj.bias", _f32),
        "o_kernel": stack(p + ".layers.{i}.self_attn.out_proj.weight", _t),
        "o_bias": stack(p + ".layers.{i}.self_attn.out_proj.bias", _f32),
        "ln2_scale": stack(p + ".layers.{i}.layer_norm2.weight", _f32),
        "ln2_bias": stack(p + ".layers.{i}.layer_norm2.bias", _f32),
        "fc1_kernel": stack(p + ".layers.{i}.mlp.fc1.weight", _t),
        "fc1_bias": stack(p + ".layers.{i}.mlp.fc1.bias", _f32),
        "fc2_kernel": stack(p + ".layers.{i}.mlp.fc2.weight", _t),
        "fc2_bias": stack(p + ".layers.{i}.mlp.fc2.bias", _f32),
    }


def params_from_state_dict(sd: Mapping[str, np.ndarray], cfg: SiglipConfig) -> Dict[str, Any]:
    """Map an HF SiglipModel state dict (numpy values) to a tpuclip pytree."""
    sd = {k.removeprefix("model."): v for k, v in sd.items()}
    v, t = cfg.vision, cfg.text

    # ---- vision embeddings -------------------------------------------------
    patch_w = _f32(np.asarray(sd["vision_model.embeddings.patch_embedding.weight"]))
    if v.naflex:
        # NaFlex (Siglip2VisionEmbeddings): patch embed is nn.Linear over
        # already-patchified pixels — (D, P*P*C) → (P*P*C, D).
        patch_kernel = patch_w.T.copy()
    else:
        # Fixed-res conv: (D, C, P, P) → (P, P, C, D) → (P*P*C, D)
        patch_kernel = patch_w.transpose(2, 3, 1, 0).reshape(
            v.patch_size * v.patch_size * v.num_channels, v.hidden_size
        ).copy()

    # ---- MAP head (torch nn.MultiheadAttention packing) --------------------
    in_proj_w = _f32(np.asarray(sd["vision_model.head.attention.in_proj_weight"]))
    in_proj_b = _f32(np.asarray(sd["vision_model.head.attention.in_proj_bias"]))
    d = v.hidden_size
    head = {
        "probe": _f32(np.asarray(sd["vision_model.head.probe"])).reshape(1, d),
        "q_kernel": in_proj_w[:d].T.copy(),
        "q_bias": in_proj_b[:d].copy(),
        "k_kernel": in_proj_w[d : 2 * d].T.copy(),
        "k_bias": in_proj_b[d : 2 * d].copy(),
        "v_kernel": in_proj_w[2 * d :].T.copy(),
        "v_bias": in_proj_b[2 * d :].copy(),
        "o_kernel": _t(np.asarray(sd["vision_model.head.attention.out_proj.weight"])),
        "o_bias": _f32(np.asarray(sd["vision_model.head.attention.out_proj.bias"])),
        "ln_scale": _f32(np.asarray(sd["vision_model.head.layernorm.weight"])),
        "ln_bias": _f32(np.asarray(sd["vision_model.head.layernorm.bias"])),
        "fc1_kernel": _t(np.asarray(sd["vision_model.head.mlp.fc1.weight"])),
        "fc1_bias": _f32(np.asarray(sd["vision_model.head.mlp.fc1.bias"])),
        "fc2_kernel": _t(np.asarray(sd["vision_model.head.mlp.fc2.weight"])),
        "fc2_bias": _f32(np.asarray(sd["vision_model.head.mlp.fc2.bias"])),
    }

    vision = {
        "embeddings": {
            "patch_kernel": patch_kernel,
            "patch_bias": _f32(np.asarray(sd["vision_model.embeddings.patch_embedding.bias"])),
            "pos_embed": _f32(np.asarray(sd["vision_model.embeddings.position_embedding.weight"])),
        },
        "encoder": _encoder_stack(sd, "vision_model.encoder", v.num_layers),
        "post_ln": {
            "scale": _f32(np.asarray(sd["vision_model.post_layernorm.weight"])),
            "bias": _f32(np.asarray(sd["vision_model.post_layernorm.bias"])),
        },
        "head": head,
    }

    text = {
        "token_embedding": _f32(np.asarray(sd["text_model.embeddings.token_embedding.weight"])),
        "pos_embed": _f32(np.asarray(sd["text_model.embeddings.position_embedding.weight"])),
        "encoder": _encoder_stack(sd, "text_model.encoder", t.num_layers),
        "final_ln": {
            "scale": _f32(np.asarray(sd["text_model.final_layer_norm.weight"])),
            "bias": _f32(np.asarray(sd["text_model.final_layer_norm.bias"])),
        },
        "head": {
            "kernel": _t(np.asarray(sd["text_model.head.weight"])),
            "bias": _f32(np.asarray(sd["text_model.head.bias"])),
        },
    }

    params: Dict[str, Any] = {"vision": vision, "text": text}
    if "logit_scale" in sd:
        params["logit_scale"] = _f32(np.asarray(sd["logit_scale"])).reshape(())
    if "logit_bias" in sd:
        params["logit_bias"] = _f32(np.asarray(sd["logit_bias"])).reshape(())
    return params


# =============================================================================
# JAX parameter tree → SiglipModel
# =============================================================================

_LAYER_KEYS = {
    "ln1_scale": "ln1.weight", "ln1_bias": "ln1.bias",
    "ln2_scale": "ln2.weight", "ln2_bias": "ln2.bias",
    "q_kernel": "attn.q.weight", "q_bias": "attn.q.bias",
    "k_kernel": "attn.k.weight", "k_bias": "attn.k.bias",
    "v_kernel": "attn.v.weight", "v_bias": "attn.v.bias",
    "o_kernel": "attn.o.weight", "o_bias": "attn.o.bias",
    "fc1_kernel": "mlp.fc1.weight", "fc1_bias": "mlp.fc1.bias",
    "fc2_kernel": "mlp.fc2.weight", "fc2_bias": "mlp.fc2.bias",
}

_HEAD_KEYS = {
    "probe": "probe", "ln_scale": "ln.weight", "ln_bias": "ln.bias",
    **{k: v for k, v in _LAYER_KEYS.items() if k[:2] in ("q_", "k_", "v_", "o_", "fc")},
}


def _weight(name: str, value: np.ndarray) -> np.ndarray:
    """(in, out) kernels → torch's (out, in); everything else as is."""
    return value.T if name.endswith("kernel") else value


def _encoder_entries(prefix: str, stacked: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    out = {}
    for key, torch_key in _LAYER_KEYS.items():
        for i, layer_value in enumerate(np.asarray(stacked[key])):
            out[f"{prefix}.layers.{i}.{torch_key}"] = _weight(key, layer_value)
    return out


def jax_params_to_state_dict(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The JAX package's parameter tree (numpy leaves, ``siglip.init_params``
    layout) → a ``SiglipModel`` state dict of numpy arrays."""
    v, t = params["vision"], params["text"]
    emb = v["embeddings"]
    sd = {
        "vision.patch.weight": np.asarray(emb["patch_kernel"]).T,
        "vision.patch.bias": emb["patch_bias"],
        "vision.pos_embed": emb["pos_embed"],
        "vision.post_ln.weight": v["post_ln"]["scale"],
        "vision.post_ln.bias": v["post_ln"]["bias"],
        "text.token_embedding.weight": t["token_embedding"],
        "text.pos_embed": t["pos_embed"],
        "text.final_ln.weight": t["final_ln"]["scale"],
        "text.final_ln.bias": t["final_ln"]["bias"],
        "text.head.weight": np.asarray(t["head"]["kernel"]).T,
        "text.head.bias": t["head"]["bias"],
        "logit_scale": params.get("logit_scale", np.float32(np.log(10.0))),
        "logit_bias": params.get("logit_bias", np.float32(-10.0)),
    }
    for key, torch_key in _HEAD_KEYS.items():
        sd[f"vision.head.{torch_key}"] = _weight(key, np.asarray(v["head"][key]))
    sd.update(_encoder_entries("vision.encoder", v["encoder"]))
    sd.update(_encoder_entries("text.encoder", t["encoder"]))
    return {k: np.asarray(val) for k, val in sd.items()}


@torch.no_grad()
def load_jax_params(module: torch.nn.Module, params_np: Mapping[str, Any]) -> torch.nn.Module:
    """Copy a JAX-layout parameter tree (numpy leaves) into ``module``'s
    parameters, keeping their device and dtype. Every parameter must be
    covered (strict load)."""
    state = {
        k: torch.from_numpy(np.array(val, dtype=np.float32))  # writable copy
        for k, val in jax_params_to_state_dict(params_np).items()
    }
    module.load_state_dict(state, strict=True)
    return module


def model_to_jax_params(module: torch.nn.Module) -> Dict[str, Any]:
    """The inverse of :func:`load_jax_params`: a ``SiglipModel``'s
    parameters as the JAX package's tree of fp32 numpy arrays, the layout
    ``models.checkpoint.save_checkpoint`` writes."""
    sd = {k: v.detach().float().cpu().numpy() for k, v in module.state_dict().items()}

    def encoder(prefix: str, n: int) -> Dict[str, np.ndarray]:
        return {
            key: np.stack([_weight(key, sd[f"{prefix}.layers.{i}.{tk}"]) for i in range(n)])
            for key, tk in _LAYER_KEYS.items()
        }

    return {
        "vision": {
            "embeddings": {
                "patch_kernel": sd["vision.patch.weight"].T.copy(),
                "patch_bias": sd["vision.patch.bias"],
                "pos_embed": sd["vision.pos_embed"],
            },
            "encoder": encoder("vision.encoder", len(module.vision.encoder.layers)),
            "post_ln": {"scale": sd["vision.post_ln.weight"], "bias": sd["vision.post_ln.bias"]},
            "head": {key: _weight(key, sd[f"vision.head.{tk}"]).copy() for key, tk in _HEAD_KEYS.items()},
        },
        "text": {
            "token_embedding": sd["text.token_embedding.weight"],
            "pos_embed": sd["text.pos_embed"],
            "encoder": encoder("text.encoder", len(module.text.encoder.layers)),
            "final_ln": {"scale": sd["text.final_ln.weight"], "bias": sd["text.final_ln.bias"]},
            "head": {"kernel": sd["text.head.weight"].T.copy(), "bias": sd["text.head.bias"]},
        },
        "logit_scale": sd["logit_scale"],
        "logit_bias": sd["logit_bias"],
    }
