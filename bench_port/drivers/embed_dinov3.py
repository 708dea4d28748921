"""The DINOv3 embedding cell: the scan's inference stage with an image-only
model whose positions are rotary, closed loop.

As the ``embed`` and ``embed_dinov2`` drivers (whose window, calls and row
distances it reuses): one caller sends batches of seeded square uint8
images to ``ImageDatabase.embed_images_uint8`` back to back, at the engine's
``inference_batch_size``, cycling a pool in host memory so that every call
copies fresh bytes to the card. What differs is the model: its own seeded
weights under HF's ``DINOv3ViTModel`` names, its operation count
(``bench_port/flops_dinov3.py``) and its plain fp32 reference
(``bench_port/reference/dinov3_ref.py``), which decides ``correct`` over
every row that a call in the window returned: the worst row's distance and
the median row's, each under its limit (``limits/<workload>.json``), as the
DINOv2 cell's check does.

Weights: linear and patch weights N(0, 1/fan_in), biases and LayerNorm
shifts N(0, 0.05²), LayerNorm scales 1 + N(0, 0.05²), the class and
register tokens N(0, 0.5²), and every LayerScale γ N(0.1, 0.03²), away from
1, so that a path that drops or misplaces γ fails the comparison (the DINOv2
driver's draws). The k projection has no bias, as the model has none. All
come from one ``torch.Generator`` call on the card, in the served type.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from bench_port import weights
from bench_port.drivers import embed, embed_dinov2
from bench_port.flops_dinov3 import Dinov3Shape, dinov3_shape, image_flops
from bench_port.reference import dinov3_ref, siglip_ref

# The window, its calls and the distances are the embed cell's.
call, window_flops, end_to_end, release, row_distances = (
    embed.call, embed.window_flops, embed.end_to_end, embed.release, embed.row_distances)


def _param_specs(v: Dinov3Shape) -> List[Tuple[str, tuple, float, float]]:
    """(name, shape, std, mean) of every parameter, HF's names."""
    d, h = v.hidden, v.mlp
    specs: List[Tuple[str, tuple, float, float]] = []

    def linear(name, n_out, n_in, bias=True):
        specs.append((f"{name}.weight", (n_out, n_in), 1.0 / math.sqrt(n_in), 0.0))
        if bias:
            specs.append((f"{name}.bias", (n_out,), weights.AFFINE_STD, 0.0))

    def norm(name):
        specs.append((f"{name}.weight", (d,), weights.AFFINE_STD, 1.0))
        specs.append((f"{name}.bias", (d,), weights.AFFINE_STD, 0.0))

    gamma = (embed_dinov2.GAMMA_STD, embed_dinov2.GAMMA_MEAN)
    specs.append(("embeddings.cls_token", (1, 1, d), embed_dinov2.TOKEN_STD, 0.0))
    specs.append(("embeddings.register_tokens", (1, v.registers, d), embed_dinov2.TOKEN_STD, 0.0))
    specs.append(("embeddings.patch_embeddings.weight", (d, v.channels, v.patch, v.patch),
                  1.0 / math.sqrt(v.patch_dim), 0.0))
    specs.append(("embeddings.patch_embeddings.bias", (d,), weights.AFFINE_STD, 0.0))
    for i in range(v.layers):
        p = f"layer.{i}"
        norm(f"{p}.norm1")
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            linear(f"{p}.attention.{proj}", d, d, bias=proj != "k_proj")
        specs.append((f"{p}.layer_scale1.lambda1", (d,), *gamma))
        norm(f"{p}.norm2")
        linear(f"{p}.mlp.gate_proj", h, d)
        linear(f"{p}.mlp.up_proj", h, d)
        linear(f"{p}.mlp.down_proj", d, h)
        specs.append((f"{p}.layer_scale2.lambda1", (d,), *gamma))
    norm("norm")
    return specs


def make_weights(v: Dinov3Shape, seed: int, device, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Every parameter, as views of one flat tensor drawn on ``device`` in
    ``dtype`` from ``seed``; the same seed gives the same bits."""
    specs = _param_specs(v)
    total = sum(math.prod(shape) for _, shape, _, _ in specs)
    gen = torch.Generator(device=device).manual_seed(weights.torch_seed(seed))
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


def make_pool(shape: Dinov3Shape, traffic: dict, seed: int) -> Tuple[dict, np.ndarray]:
    """The seeded pool of square uint8 images (host) and each one's operations."""
    n = traffic["pool_images"]
    if n % traffic["batch"]:
        raise ValueError(f"pool_images {n} is not a multiple of the batch {traffic['batch']}")
    rng = np.random.default_rng([weights.torch_seed(seed), 1])
    s = shape.image_size
    pixels = rng.integers(0, 256, (n, s, s, shape.channels), dtype=np.uint8)
    return {"pixels": pixels}, np.full(n, image_flops(shape), dtype=np.float64)


def _check_program_config(engine, shape: Dinov3Shape) -> None:
    """The program's preset has to be the configuration file's model."""
    v = engine.config.vision
    got = (v.hidden_size, v.intermediate_size, v.num_layers, v.num_heads, v.patch_size, v.num_channels,
           v.layer_norm_eps, v.num_register_tokens, v.rope_theta, v.image_size, tuple(v.image_mean),
           tuple(v.image_std), v.naflex)
    want = (shape.hidden, shape.mlp, shape.layers, shape.heads, shape.patch, shape.channels, shape.eps,
            shape.registers, shape.rope_theta, shape.image_size, shape.image_mean, shape.image_std, False)
    if got != want or engine.config.text is not None:
        raise ValueError(f"the program's model is not the configuration's: {got} against {want}")


def load_into_port(model, w: Dict[str, torch.Tensor]) -> None:
    """Copy ``w`` (HF's names) into the program's model through its own HF
    name map, which raises unless every parameter is written once."""
    from tpuclip_torch.models.dinov3 import load_hf_state_dict

    load_hf_state_dict(model, w)


def setup(cell, seed: int, device: torch.device, workdir: str, timer) -> embed.State:
    shape = dinov3_shape(cell.config)
    traffic = cell.traffic
    dtype = embed.DTYPES[cell.config["compute_dtype"]]
    from tpuclip_torch.engine import ImageDatabase

    timer.lap("import_program")
    engine = ImageDatabase(
        db_path=os.path.join(workdir, "bench.db"),
        model_cache_dir=os.path.join(workdir, "models"),
        model_name=cell.config["preset"],
        inference_batch_size=traffic["inference_batch_size"],
        compute_dtype=dtype,
        device=device,
    )
    _check_program_config(engine, shape)
    timer.lap("engine")
    w = make_weights(shape, seed, device, dtype)
    load_into_port(engine.model, w)
    del w
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    timer.lap("weights")
    pool, flops = make_pool(shape, traffic, seed)
    timer.lap("pool")
    state = embed.State(shape=shape, traffic=traffic, batch=traffic["batch"], pool=pool, image_flops=flops,
                        engine=engine, entry=engine.embed_images_uint8, seed=seed, device=device, dtype=dtype)
    for i in range(2):  # the one batch shape the window uses
        embed._run(state, i)
    timer.lap("warmup")
    return state


def reseed(state: embed.State, seed: int) -> None:
    """Give the same engine the weights and inputs of another seed (for
    reading many seeds in one process)."""
    w = make_weights(state.shape, seed, state.device, state.dtype)
    load_into_port(state.engine.model, w)
    del w
    state.pool, state.image_flops = make_pool(state.shape, state.traffic, seed)
    state.seed, state.outputs = seed, []


def reference(state: embed.State, prec=siglip_ref.FP32()) -> np.ndarray:
    """The plain reference's row of every pool image, on the host."""
    w32 = siglip_ref.fp32_weights(make_weights(state.shape, state.seed, state.device, state.dtype))
    out = dinov3_ref.reference_rows(w32, state.pool["pixels"], np.arange(state.pool_size), state.shape, prec)
    return out.cpu().numpy()


def check(state: embed.State, limits: dict) -> Tuple[bool, int, dict]:
    """(correct, rows failed, {number: {value, limit}}) of the window's rows:
    the worst row and the median row, each under its limit, and no row of
    the wrong shape (the DINOv2 cell's check)."""
    d = row_distances(state, reference(state))
    finite = np.isfinite(d)
    worst = float(d[finite].max()) if finite.any() else float("nan")
    median = float(np.median(d[finite])) if finite.any() else float("nan")
    limit, median_limit = float(limits["max_row_dist"]), float(limits["median_row_dist"])
    bad = int((~finite).sum())
    failed = int(bad + (d[finite] > limit).sum())
    numbers = {"max_row_dist": {"value": worst, "limit": limit},
               "median_row_dist": {"value": median, "limit": median_limit},
               "bad_rows": {"value": bad, "limit": 0}}
    return len(d) > 0 and bad == 0 and worst <= limit and median <= median_limit, failed, numbers
