"""Seeded vision-tower weights, made on the device in the served type.

The benchmark makes the weights itself and hands the same tensors to the
program (copied into its model in memory) and to the plain reference
(upcast to fp32). Names and layouts are HF's ``SiglipVisionModel`` /
``Siglip2VisionModel`` ones; :func:`load_into_port` is the one place that
knows the program's parameter names.

Every parameter is drawn, biases and LayerNorm affines too, so that a path
that drops one shows in the comparison: linear and patch weights
N(0, 1/fan_in), biases and LayerNorm shifts N(0, 0.05^2), LayerNorm scales
1 + N(0, 0.05^2), position embeddings N(0, 0.5^2) (the size of a patch
embedding of uniform pixels, so a wrong resize shows), the pooling probe
N(0, 1). All draws come from one ``torch.Generator`` call.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from bench_port.shapes import VisionShape

AFFINE_STD = 0.05
POS_STD = 0.5


def _param_specs(v: VisionShape) -> List[Tuple[str, tuple, float, float]]:
    """(name, shape, std, mean) of every vision parameter, HF's names."""
    d, f = v.hidden, v.mlp
    specs: List[Tuple[str, tuple, float, float]] = []

    def linear(name, n_out, n_in):
        specs.append((f"{name}.weight", (n_out, n_in), 1.0 / math.sqrt(n_in), 0.0))
        specs.append((f"{name}.bias", (n_out,), AFFINE_STD, 0.0))

    def norm(name):
        specs.append((f"{name}.weight", (d,), AFFINE_STD, 1.0))
        specs.append((f"{name}.bias", (d,), AFFINE_STD, 0.0))

    if v.naflex:  # Siglip2VisionEmbeddings: a Linear over (ph, pw, c) patch rows
        linear("embeddings.patch_embedding", d, v.patch_dim)
    else:  # SiglipVisionEmbeddings: a Conv2d with stride = kernel = patch
        specs.append(("embeddings.patch_embedding.weight", (d, v.channels, v.patch, v.patch),
                      1.0 / math.sqrt(v.patch_dim), 0.0))
        specs.append(("embeddings.patch_embedding.bias", (d,), AFFINE_STD, 0.0))
    specs.append(("embeddings.position_embedding.weight", (v.tokens, d), POS_STD, 0.0))
    for i in range(v.layers):
        p = f"encoder.layers.{i}"
        norm(f"{p}.layer_norm1")
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            linear(f"{p}.self_attn.{proj}", d, d)
        norm(f"{p}.layer_norm2")
        linear(f"{p}.mlp.fc1", f, d)
        linear(f"{p}.mlp.fc2", d, f)
    norm("post_layernorm")
    specs.append(("head.probe", (1, 1, d), 1.0, 0.0))
    specs.append(("head.attention.in_proj_weight", (3 * d, d), 1.0 / math.sqrt(d), 0.0))
    specs.append(("head.attention.in_proj_bias", (3 * d,), AFFINE_STD, 0.0))
    linear("head.attention.out_proj", d, d)
    norm("head.layernorm")
    linear("head.mlp.fc1", f, d)
    linear("head.mlp.fc2", d, f)
    return specs


def torch_seed(seed: int) -> int:
    """Any whole number → a seed ``torch.Generator`` and numpy both take."""
    return int(seed) % (1 << 63)


def make_vision_weights(
    v: VisionShape, seed: int, device, dtype: torch.dtype = torch.bfloat16
) -> Dict[str, torch.Tensor]:
    """Every vision parameter, as views of one flat tensor drawn on
    ``device`` in ``dtype`` from ``seed``; the same seed gives the same bits."""
    specs = _param_specs(v)
    total = sum(math.prod(shape) for _, shape, _, _ in specs)
    gen = torch.Generator(device=device).manual_seed(torch_seed(seed))
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out, offset = {}, 0
    for name, shape, std, mean in specs:
        n = math.prod(shape)
        t = flat[offset : offset + n].view(shape).mul_(std)
        if mean:
            t.add_(mean)
        out[name] = t
        offset += n
    return out


def load_into_port(model, w: Dict[str, torch.Tensor], v: VisionShape) -> None:
    """Copy ``w`` into ``model.vision`` (a ``tpuclip_torch`` ``SiglipModel``);
    every vision parameter is written exactly once, or this raises."""
    d = v.hidden
    patch_w = w["embeddings.patch_embedding.weight"]
    if not v.naflex:  # (D, C, P, P) → the port's (D, P*P*C) rows in (ph, pw, c) order
        patch_w = patch_w.permute(0, 2, 3, 1).reshape(d, v.patch_dim)
    src = {
        "patch.weight": patch_w,
        "patch.bias": w["embeddings.patch_embedding.bias"],
        "pos_embed": w["embeddings.position_embedding.weight"],
        "post_ln.weight": w["post_layernorm.weight"],
        "post_ln.bias": w["post_layernorm.bias"],
        "head.probe": w["head.probe"].reshape(1, d),
        "head.ln.weight": w["head.layernorm.weight"],
        "head.ln.bias": w["head.layernorm.bias"],
        "head.attn.o.weight": w["head.attention.out_proj.weight"],
        "head.attn.o.bias": w["head.attention.out_proj.bias"],
    }
    for j, name in enumerate("qkv"):
        src[f"head.attn.{name}.weight"] = w["head.attention.in_proj_weight"][j * d : (j + 1) * d]
        src[f"head.attn.{name}.bias"] = w["head.attention.in_proj_bias"][j * d : (j + 1) * d]
    for fc in ("fc1", "fc2"):
        for kind in ("weight", "bias"):
            src[f"head.mlp.{fc}.{kind}"] = w[f"head.mlp.{fc}.{kind}"]
    names = {"ln1": "layer_norm1", "ln2": "layer_norm2", "attn.q": "self_attn.q_proj",
             "attn.k": "self_attn.k_proj", "attn.v": "self_attn.v_proj", "attn.o": "self_attn.out_proj",
             "mlp.fc1": "mlp.fc1", "mlp.fc2": "mlp.fc2"}
    for i in range(v.layers):
        for port, hf in names.items():
            for kind in ("weight", "bias"):
                src[f"encoder.layers.{i}.{port}.{kind}"] = w[f"encoder.layers.{i}.{hf}.{kind}"]
    params = dict(model.vision.named_parameters())
    if set(params) != set(src):
        raise ValueError(
            "the program's vision parameters differ from the benchmark's: "
            f"missing {sorted(set(params) - set(src))[:5]}, unknown {sorted(set(src) - set(params))[:5]}"
        )
    with torch.no_grad():
        for name, p in params.items():
            if tuple(p.shape) != tuple(src[name].shape):
                raise ValueError(f"{name}: program {tuple(p.shape)}, benchmark {tuple(src[name].shape)}")
            p.copy_(src[name])
