"""Contrastive fine-tuning pipeline (PyTorch port of ``tpuclip/pipelines/train.py``).

Dataset convention: a directory of images with sidecar captions,
``photo.jpg`` + ``photo.txt`` (one caption). Pairs go through the scan's
threaded decode prefetcher (the copied ``io/prefetch.py``) into the SigLIP
sigmoid loss (``tpuclip_torch.parallel.training``), the captions with the
attention mask search embeds them with: bf16 compute on CUDA, fp32 on the
CPU, fp32 parameters either way. As tpuclip's ``train``, it runs data
parallel over the largest count of the local CUDA devices (times the
process group's world size, when one is initialized) that divides the
batch, and on one device when that count is 1.

Outputs: the model in tpuclip's checkpoint format (``<output>/model``,
which both packages load) and the port's train state for an exact resume
(``<output>/train_state``, ``torch.save``).
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from tpuclip_torch.device import DeviceLike, resolve_device
from tpuclip_torch.io.walker import census
from tpuclip_torch.utils.logging import banner, log

# The AdamW state is three fp32 copies of the parameters besides the
# parameters themselves; above this many bytes in all, ``auto`` takes
# Adafactor (tpuclip's single-chip threshold, a 16 GB TPU).
_ADAMW_MAX_BYTES = 10e9


def find_pairs(data_dir: str) -> List[Tuple[str, str]]:
    """(image_path, caption) pairs from sidecar .txt files."""
    images, _ = census(data_dir)
    pairs = []
    for img in sorted(images):
        sidecar = img.with_suffix(".txt")
        if sidecar.exists():
            caption = sidecar.read_text(encoding="utf-8").strip()
            if caption:
                pairs.append((str(img), caption))
    return pairs


def _batches(
    pairs: List[Tuple[str, str]],
    batch_size: int,
    image_size: int,
    tokenizer,
    steps: int,
    seed: int,
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Shuffled epochs (``random.Random(seed)``, tpuclip's order) →
    ``steps`` batches of (uint8 images (B, S, S, 3), ids (B, 64), the ids'
    1/0 attention mask (B, 64)); a batch with a decode failure is skipped,
    and two epochs' worth of failed batches in a row raise."""
    from tpuclip_torch.io.prefetch import prefetch_batches

    rng = random.Random(seed)

    def path_stream():
        epoch = list(pairs)
        while True:
            rng.shuffle(epoch)
            for p, _ in epoch:
                yield p, 0.0

    caption_of = dict(pairs)
    produced = 0
    consecutive_skips = 0
    max_consecutive_skips = max(10, 2 * (len(pairs) // batch_size + 1))
    for batch in prefetch_batches(path_stream(), batch_size, image_size, with_hash=False):
        if not batch.valid.all():
            consecutive_skips += 1
            if consecutive_skips >= max_consecutive_skips:
                raise RuntimeError(
                    f"{consecutive_skips} consecutive batches contained decode "
                    "failures; check the dataset for corrupt/unreadable images"
                )
            continue  # pairs must stay aligned
        consecutive_skips = 0
        ids, mask = tokenizer.encode_batch_with_mask([caption_of[item.path].lower() for item in batch.items])
        yield batch.pixels, ids, mask
        produced += 1
        if produced >= steps:
            return


def _train_mesh(device: torch.device, batch_size: int):
    """tpuclip's rule: the largest count of devices that divides the batch
    (the local CUDA devices, ``device`` first, times the world size of an
    initialized process group); None when that count is 1."""
    import torch.distributed as dist

    from tpuclip_torch.parallel.mesh import make_mesh

    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    local = [device]
    if device.type == "cuda":
        local += [torch.device("cuda", i) for i in range(torch.cuda.device_count()) if i != device.index]
    usable = next((d for d in range(min(len(local), batch_size), 0, -1) if batch_size % (d * world) == 0), 0)
    if usable == 0:
        raise ValueError(f"a batch of {batch_size} does not split over {world} processes")
    return make_mesh(local[:usable]) if usable * world > 1 else None


@dataclass
class TrainReport:
    """What one ``train`` run did: the optimizer, each step's loss and its
    seconds (the step and the loss's read-back, which waits for the
    device), and the run's seconds from the first batch to the last step."""

    optimizer: str = ""
    losses: List[float] = field(default_factory=list)
    step_seconds: List[float] = field(default_factory=list)
    seconds: float = 0.0
    final_step: int = 0


def train(
    data_dir: str,
    model_name: str,
    model_cache_dir: Optional[str],
    output_dir: str,
    steps: int = 100,
    batch_size: int = 16,
    learning_rate: float = 1e-5,
    resume: Optional[str] = None,
    seed: int = 0,
    log_every: int = 10,
    optimizer: str = "auto",
    device: DeviceLike = None,
) -> Optional[TrainReport]:
    """Fine-tune ``model_name`` on the pairs under ``data_dir`` for
    ``steps`` steps and save the model and the train state under
    ``output_dir``; returns the run's :class:`TrainReport` (None when the
    run is refused: too few pairs, or a NaFlex model)."""
    from tpuclip_torch.models.checkpoint import save_checkpoint
    from tpuclip_torch.models.convert import model_to_jax_params
    from tpuclip_torch.models.loader import find_local_checkpoint, load_model
    from tpuclip_torch.parallel.checkpoint import restore_train_state, save_train_state
    from tpuclip_torch.parallel.training import init_train_state, make_optimizer, make_train_step
    from tpuclip_torch.text.tokenizer import load_tokenizer

    banner("Contrastive fine-tuning")
    pairs = find_pairs(data_dir)
    if len(pairs) < batch_size:
        log(f"[X] Need at least {batch_size} (image, caption) pairs; found {len(pairs)}")
        return None
    log(f"Dataset: {len(pairs)} image/caption pairs from {data_dir}")

    device = resolve_device(device)
    cfg, model = load_model(model_name, model_cache_dir, device=device, dtype=torch.float32)
    if cfg.vision.naflex:
        # The square-pixel prefetcher and the fixed-resolution vision tower
        # do not take NaFlex's patchified inputs.
        log(f"[X] {model_name} is a NaFlex model; training does not support NaFlex yet")
        return None
    if cfg.text is None:  # contrastive training needs both towers
        log(f"[X] {model_name} embeds images only (no text tower); contrastive training needs both")
        return None
    ckpt_dir = find_local_checkpoint(model_name, model_cache_dir)
    tokenizer = load_tokenizer(
        model_name, str(ckpt_dir) if ckpt_dir else None, vocab_size=cfg.text.vocab_size
    )
    compute_dtype = torch.bfloat16 if device.type == "cuda" else torch.float32

    # Data parallel over the largest device count that divides the batch.
    mesh = _train_mesh(device, batch_size)
    if mesh is not None:
        log(f"Mesh: {mesh.shape}")

    if optimizer == "auto":
        param_bytes = sum(p.numel() * 4 for p in model.parameters())
        # params + grads + two moments, fp32; a mesh keeps AdamW
        factored = mesh is None and device.type == "cuda" and param_bytes * 4 > _ADAMW_MAX_BYTES
    else:
        factored = optimizer == "adafactor"
    if factored:
        log("Optimizer: adafactor (AdamW state would exceed single-chip HBM)"
            if optimizer == "auto" else "Optimizer: adafactor")
    opt = make_optimizer(
        learning_rate=learning_rate,
        warmup_steps=min(100, max(1, steps // 10)),
        total_steps=steps,
        factored=factored,
    )
    state = init_train_state(model, opt, mesh=mesh)
    if resume:
        state = restore_train_state(resume, state)
        log(f"Resumed from {resume} at step {state.step}")
    step_fn = make_train_step(opt, compute_dtype=compute_dtype, mesh=mesh)

    report = TrainReport(optimizer="adafactor" if factored else "adamw")
    t0 = time.time()
    for i, batch in enumerate(
        _batches(pairs, batch_size, cfg.vision.image_size, tokenizer, steps, seed)
    ):
        t_step = time.perf_counter()
        state, loss = step_fn(state, *(torch.from_numpy(a).to(device) for a in batch))
        report.losses.append(float(loss))
        report.step_seconds.append(time.perf_counter() - t_step)
        if (i + 1) % log_every == 0 or i == 0:
            rate = batch_size * (i + 1) / (time.time() - t0)
            log(
                f"  step {state.step:5d}  loss {np.mean(report.losses[-log_every:]):.4f}  "
                f"{rate:.1f} img/s"
            )
    report.seconds = time.time() - t0
    report.final_step = state.step

    out = Path(output_dir)
    save_checkpoint(str(out / "model"), model_to_jax_params(state.model), cfg)
    save_train_state(str(out / "train_state"), state)
    log(f"\nSaved fine-tuned model to {out / 'model'} (tpuclip format)")
    log(f"Saved train state to {out / 'train_state'} (torch.save)")
    banner("Training complete")
    return report
