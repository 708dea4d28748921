"""The embedding cells: the scan's inference stage, closed loop.

One caller sends batches of decoded images to the engine's image-embedding
entry back to back: ``ImageDatabase.embed_images_uint8`` for a
fixed-resolution model, ``embed_patches_naflex`` for a NaFlex one, each from
host uint8 arrays to L2-normalised fp32 rows on the host, at the engine's
``inference_batch_size``. The inputs are a pool of seeded images in host
memory, cycled call by call, so every call copies fresh bytes to the card.

``correct``: every row that a call in the window returned is compared with
the plain fp32 reference (``bench_port/reference``) of its image, computed
after the window over each image of the pool once, from weights and inputs
the benchmark made itself.
"""

from __future__ import annotations

import gc
import os
from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np
import torch

from bench_port import weights
from bench_port.flops import image_flops
from bench_port.reference import siglip_ref
from bench_port.shapes import VisionShape, naflex_grid, vision_shape

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass
class State:
    shape: VisionShape
    traffic: dict
    batch: int
    pool: dict  # host arrays: pixels, or patches + masks + grids
    image_flops: np.ndarray  # operations of each pool image (flops.py)
    engine: object
    entry: object
    seed: int
    device: torch.device
    dtype: torch.dtype  # the served type, which the weights are drawn in
    outputs: List[Tuple[int, np.ndarray]] = field(default_factory=list)  # (first pool row, rows)

    @property
    def pool_size(self) -> int:
        return len(self.image_flops)

    def rows_of(self, call: int) -> int:
        return (call * self.batch) % self.pool_size


def _shares(sources: list, n: int) -> List[int]:
    """Images per source family, the mix's shares of ``n`` by largest
    remainder, so every seed gets the same set of sizes."""
    exact = [s["share"] * n for s in sources]
    counts = [int(x) for x in exact]
    order = sorted(range(len(exact)), key=lambda i: -(exact[i] - counts[i]))
    for i in order[: n - sum(counts)]:
        counts[i] += 1
    return counts


def make_pool(shape: VisionShape, traffic: dict, seed: int) -> Tuple[dict, np.ndarray]:
    """The seeded input pool (host uint8) and each image's operations."""
    n = traffic["pool_images"]
    if n % traffic["batch"]:
        raise ValueError(f"pool_images {n} is not a multiple of the batch {traffic['batch']}")
    rng = np.random.default_rng([weights.torch_seed(seed), 1])
    if not shape.naflex:
        s = shape.image_size
        pool = {"pixels": rng.integers(0, 256, (n, s, s, shape.channels), dtype=np.uint8)}
        return pool, np.full(n, image_flops(shape), dtype=np.float64)
    sources = traffic["naflex_sources"]
    family = [naflex_grid(src["height"], src["width"], shape) for src in sources]
    grids = np.array([g for g, c in zip(family, _shares(sources, n)) for _ in range(c)], np.int32)
    grids = grids[rng.permutation(n)]
    length = shape.max_patches
    masks = (np.arange(length)[None, :] < (grids[:, 0] * grids[:, 1])[:, None]).astype(np.int32)
    patches = rng.integers(0, 256, (n, length, shape.patch_dim), dtype=np.uint8)
    patches *= masks[:, :, None].astype(np.uint8)  # padded slots are zero, as the scan pads them
    flops = {tuple(g): image_flops(shape, tuple(g)) for g in family}
    return {"patches": patches, "masks": masks, "grids": grids}, np.array(
        [flops[tuple(g)] for g in grids.tolist()], dtype=np.float64)


def _check_program_config(engine, shape: VisionShape) -> None:
    """The program's preset has to be the configuration file's model."""
    v = engine.config.vision
    want = {"hidden_size": shape.hidden, "intermediate_size": shape.mlp, "num_layers": shape.layers,
            "num_heads": shape.heads, "patch_size": shape.patch, "num_channels": shape.channels,
            "layer_norm_eps": shape.eps, "naflex": shape.naflex}
    want.update({"max_num_patches": shape.max_patches} if shape.naflex else {"image_size": shape.image_size})
    got = {k: getattr(v, k) for k in want}
    if got != want:
        raise ValueError(f"the program's model is not the configuration's: {got} against {want}")


def setup(cell, seed: int, device: torch.device, workdir: str, timer) -> State:
    shape = vision_shape(cell.config)
    traffic = cell.traffic
    dtype = DTYPES[cell.config["compute_dtype"]]
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
    w = weights.make_vision_weights(shape, seed, device, dtype)
    weights.load_into_port(engine.model, w, shape)
    del w
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    timer.lap("weights")
    pool, flops = make_pool(shape, traffic, seed)
    timer.lap("pool")
    entry = engine.embed_patches_naflex if shape.naflex else engine.embed_images_uint8
    state = State(shape=shape, traffic=traffic, batch=traffic["batch"], pool=pool, image_flops=flops, engine=engine,
                  entry=entry, seed=seed, device=device, dtype=dtype)
    for i in range(2):  # the one batch shape the window uses
        _run(state, i)
    timer.lap("warmup")
    return state


def reseed(state: State, seed: int) -> None:
    """Give the same engine the weights and inputs of another seed (for
    reading many seeds in one process)."""
    w = weights.make_vision_weights(state.shape, seed, state.device, state.dtype)
    weights.load_into_port(state.engine.model, w, state.shape)
    del w
    state.pool, state.image_flops = make_pool(state.shape, state.traffic, seed)
    state.seed, state.outputs = seed, []


def _run(state: State, call: int) -> np.ndarray:
    s, b = state.rows_of(call), state.batch
    if state.shape.naflex:
        p = state.pool
        return state.entry(p["patches"][s : s + b], p["masks"][s : s + b], p["grids"][s : s + b])
    return state.entry(state.pool["pixels"][s : s + b])


def call(state: State, i: int) -> int:
    """One call of the window; returns the images it embedded."""
    state.outputs.append((state.rows_of(i), _run(state, i)))
    return state.batch


def window_flops(state: State, calls: int) -> float:
    per_batch = [state.image_flops[state.rows_of(i) : state.rows_of(i) + state.batch].sum()
                 for i in range(state.pool_size // state.batch)]
    return float(sum(per_batch[i % len(per_batch)] for i in range(calls)))


def end_to_end(state: State, window) -> dict:
    return {"index_images_per_s": window.items / window.seconds}


def release(state: State) -> None:
    """Free the program's state before the reference runs."""
    state.engine = state.entry = None
    gc.collect()
    if state.device.type == "cuda":
        torch.cuda.empty_cache()


def reference(state: State, prec=siglip_ref.FP32()) -> np.ndarray:
    """The plain reference's row of every pool image, on the host."""
    w = weights.make_vision_weights(state.shape, state.seed, state.device, state.dtype)
    w32 = siglip_ref.fp32_weights(w)
    del w
    out = siglip_ref.reference_rows(w32, state.pool, np.arange(state.pool_size), state.shape, prec)
    return out.cpu().numpy()


def row_distances(state: State, ref_rows: np.ndarray) -> np.ndarray:
    """L2 distance of every returned row to its image's reference row; NaN
    for each row of a call that returned the wrong shape."""
    dists = []
    for s, out in state.outputs:
        want = ref_rows[s : s + state.batch]
        if not isinstance(out, np.ndarray) or out.shape != want.shape:
            dists.append(np.full(state.batch, np.nan))
        else:
            dists.append(np.linalg.norm(out.astype(np.float64) - want, axis=1))
    return np.concatenate(dists) if dists else np.zeros(0)


def check(state: State, limits: dict) -> Tuple[bool, int, dict]:
    """(correct, rows failed, {number: {value, limit}}) of the window's rows."""
    d = row_distances(state, reference(state))
    finite = np.isfinite(d)
    worst = float(d[finite].max()) if finite.any() else float("nan")
    limit = float(limits["max_row_dist"])
    bad = int((~finite).sum())
    failed = int(bad + (d[finite] > limit).sum())
    numbers = {
        "max_row_dist": {"value": worst, "limit": limit},
        "bad_rows": {"value": bad, "limit": 0},
    }
    correct = len(d) > 0 and bad == 0 and worst <= limit
    return correct, failed, numbers
