"""SigLIP sigmoid-contrastive training (PyTorch port of ``tpuclip/parallel/training.py``).

The loss is SigLIP's pairwise sigmoid (Zhai et al. 2023) over a batch of
(image, caption) pairs. The optimizers are optax's, written out as plain
functions on tensors so both packages take the same steps:

- AdamW (b1 0.9, b2 0.999, eps 1e-8) with decoupled weight decay on the
  parameters of two or more dimensions (weights and embeddings; biases,
  LayerNorm and ``logit_scale`` / ``logit_bias`` are excluded);
- Adafactor as ``optax.adafactor(multiply_by_parameter_scale=False)``:
  factored second moments for dimensions >= 128, decay rate 0.8, eps
  1e-30, update clipping at block RMS 1.0, weight decay added after the
  learning rate;
- both after ``clip_by_global_norm(1.0)``, with a linear warmup then a
  cosine decay, evaluated at the step count before the update.

The weight-decay mask is taken on the port's per-layer tensors. tpuclip's
is taken on its stacked (layers, ...) arrays, where an encoder layer's
biases and LayerNorm scales are two-dimensional and so are decayed, against
its own rule; the port does not copy that.

The text tower takes the captions' attention mask when one is given, as
search embeds them. tpuclip's loss embeds its captions unmasked, so it
fits other text features than its search uses; the port does not copy
that (ROADMAP Queue 3).

With a mesh (``parallel/mesh.py``) the step is data parallel: one replica
of the model per data shard (``sharding.shard_params``), the global batch
split over them. SigLIP's loss couples every pair of the global batch, so
the replicas' unit features are gathered on the lead device (and across
the processes of the mesh's group) before the loss; the replicas'
gradients are summed there, clipped and applied once, and the updated
parameters copied back to every replica. The gradients equal the
single-device step's on the same batch.

With a model axis above 1 each replica is tensor parallel over its mesh
row (``tensor_parallel.py``) and the step is data x model parallel: a
shard's gradient is summed over the rows on that shard's device, its
optimizer state lives there, and each update is the one-device update of
the logical tensor: the global norm counts every logical parameter once,
and Adafactor takes its factored dims, its statistics' means and its RMS
clip over the logical tensor, summing across the ranks where a mean runs
over the split dim. A sum over devices adds each device's partial on its
own device first and moves only the partials; the all_reduce across
processes runs once a rank of the row, on that rank's device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from tpuclip_torch.models.siglip import SiglipModel, remat_scope
from tpuclip_torch.parallel.mesh import DATA_AXIS, Mesh
from tpuclip_torch.parallel.tensor_parallel import Shard, shard_layout, sum_on

Params = Dict[str, torch.Tensor]
Layout = Dict[str, Shard]
# optax's adamw defaults.
_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


def _features(model: SiglipModel, images, input_ids, attention_mask, compute_dtype):
    """Unit fp32 image and text features (divided by max(norm, 1e-12))."""
    img = _unit(model.vision(images, compute_dtype).float())
    txt = _unit(model.text(input_ids, compute_dtype, attention_mask).float())
    return img, txt


def _pair_loss(img: torch.Tensor, txt: torch.Tensor, model: SiglipModel) -> torch.Tensor:
    logits = txt @ img.T
    logits = logits * model.logit_scale.float().exp() + model.logit_bias.float()
    z = 2.0 * torch.eye(logits.shape[0], device=logits.device) - 1.0
    return -F.logsigmoid(z * logits).sum(dim=-1).mean()


def sigmoid_contrastive_loss(
    model: SiglipModel,
    images: torch.Tensor,
    input_ids: torch.Tensor,
    compute_dtype: torch.dtype = torch.bfloat16,
    attention_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """SigLIP loss: -mean_i sum_j log sigmoid(z_ij (scale sim_ij + bias)),
    z = 2I - 1, over unit features. ``attention_mask`` (B, S) of 1/0 masks
    the captions' padding keys in the text tower, as search's embedding
    does; without it the tower runs unmasked, as tpuclip's train step."""
    return _pair_loss(*_features(model, images, input_ids, attention_mask, compute_dtype), model)


# =============================================================================
# Optimizers
# =============================================================================


def make_schedule(
    learning_rate: float, warmup_steps: int = 0, total_steps: Optional[int] = None
) -> Callable[[int], float]:
    """tpuclip's schedule choice: ``warmup_cosine_decay_schedule`` (0 →
    peak over max(1, warmup) steps, then a cosine to 0 at ``total_steps``),
    ``linear_schedule`` when ``total_steps <= warmup_steps``, else constant.
    Returns the f32 learning rate at a step count."""
    if warmup_steps <= 0 and total_steps is None:
        return lambda count: float(np.float32(learning_rate))
    warm = max(1, warmup_steps)
    cosine = total_steps is not None and total_steps > warmup_steps
    decay_steps = (total_steps - warm) if cosine else 0
    if cosine and decay_steps <= 0:
        raise ValueError(f"the cosine decay needs total_steps > warmup, got {total_steps} <= {warm}")

    def schedule(count: int) -> float:
        if not cosine or count < warm:
            frac = 1.0 - min(max(count, 0), warm) / warm
            return float(np.float32(-learning_rate * frac + learning_rate))
        c = min(count - warm, decay_steps)
        return float(np.float32(learning_rate * 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))))

    return schedule


def _factored_dims(shape) -> Optional[Tuple[int, int]]:
    """optax's rule: the two largest axes, if the smaller is >= 128."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < 128:
        return None
    return int(order[-2]), int(order[-1])


def _reduced(split: Optional[int], removed: int) -> Optional[int]:
    """The split dim of a statistic that reduces dim ``removed`` of a tensor
    split along ``split``: None (whole on every rank) when the reduction
    runs over the split dim."""
    if split is None or split == removed:
        return None
    return split - 1 if split > removed else split


def state_split_dim(part: str, shard: Shard, shape) -> Optional[int]:
    """The dim along which a parameter's optimizer state ``part`` (``mu``,
    ``nu``, ``v``, ``v_row``, ``v_col``) holds its rank's slice of the
    logical state, given the parameter's ``shard`` and its own ``shape``;
    None: each rank holds the whole."""
    if part in ("mu", "nu", "v"):
        return shard.dim
    d1, d0 = _factored_dims(shard.logical_shape(shape))
    return _reduced(shard.dim, d0 if part == "v_row" else d1)


def _split_mean(xs: List[torch.Tensor], dim: int, split: Optional[int], extent: int,
                keepdim: bool = False) -> List[torch.Tensor]:
    """Each rank's share of the mean over ``dim`` of the logical tensor whose
    rank slices are ``xs`` (split along ``split``, ``extent`` long in
    ``dim``): over the split dim, the ranks' sums added on the first rank's
    device, divided, and copied back to every rank; else each slice's own."""
    if dim != split:
        return [x.mean(dim=dim, keepdim=keepdim) for x in xs]
    total = sum_on([x.sum(dim=dim, keepdim=keepdim) for x in xs], xs[0].device) / extent
    return [total.to(x.device) for x in xs]


def global_norm(grads: Params) -> torch.Tensor:
    """sqrt of the sum of every gradient's squares, on the first gradient's
    device: each device's squares summed on that device, in order, and only
    the devices' sums moved."""
    sums: Dict[torch.device, torch.Tensor] = {}
    for g in grads.values():
        s = (g * g).sum()
        sums[g.device] = sums[g.device] + s if g.device in sums else s
    return torch.sqrt(sum_on(list(sums.values()), next(iter(sums))))


def _whole(params: Params, layout: Optional[Layout]) -> Layout:
    """``layout``, or where none is given each parameter its own logical
    one, held whole."""
    return layout if layout is not None else {n: Shard(n) for n in params}


def _groups(names, layout: Layout) -> List[List[str]]:
    """The names grouped by logical parameter, each group in rank order."""
    groups: Dict[str, List[str]] = {}
    for n in names:
        groups.setdefault(layout[n].logical, []).append(n)
    return [sorted(g, key=lambda n: layout[n].rank) for g in groups.values()]


@dataclass
class Optimizer:
    """AdamW or Adafactor (``factored``) with global-norm clipping and a
    schedule, as :func:`make_optimizer` builds it. ``init`` makes the state
    of a ``{name: parameter}`` dict; ``update`` turns gradients into the
    updates to add, advancing the state in place. Both take the model's
    ``layout`` (``tensor_parallel.shard_layout``; without one each
    parameter is whole): a tensor-parallel model's state is kept per
    shard, on the shard's device, and each update is the logical
    tensor's."""

    schedule: Callable[[int], float]
    weight_decay: float = 1e-4
    grad_clip_norm: Optional[float] = 1.0
    factored: bool = False

    @staticmethod
    def decays(p: torch.Tensor) -> bool:
        return p.dim() >= 2

    def init(self, params: Params, layout: Optional[Layout] = None) -> dict:
        state: dict = {"count": 0}
        layout = _whole(params, layout)
        if not self.factored:
            state["mu"] = {n: torch.zeros_like(p) for n, p in params.items()}
            state["nu"] = {n: torch.zeros_like(p) for n, p in params.items()}
            return state
        state["v_row"], state["v_col"], state["v"] = {}, {}, {}
        for n, p in params.items():
            # A shard's statistics drop the logical tensor's factored dims
            # from its own shape: a whole vector where the dropped dim is
            # the split one, else the rank's slice.
            dims = _factored_dims(layout[n].logical_shape(p.shape))
            if dims is None:
                state["v"][n] = torch.zeros_like(p)
            else:
                d1, d0 = dims
                state["v_row"][n] = p.new_zeros([s for i, s in enumerate(p.shape) if i != d0])
                state["v_col"][n] = p.new_zeros([s for i, s in enumerate(p.shape) if i != d1])
        return state

    @torch.no_grad()
    def update(self, grads: Params, state: dict, params: Params, layout: Optional[Layout] = None) -> Params:
        count = state["count"]
        if self.grad_clip_norm is not None:
            # No host sync: optax's select between the gradient and its
            # clipped value, per element.
            g_norm = global_norm(grads)
            keep = g_norm < self.grad_clip_norm
            grads = {
                n: torch.where(keep.to(g.device), g, (g / g_norm.to(g.device)) * self.grad_clip_norm)
                for n, g in grads.items()
            }
        lr = self.schedule(count)
        t = np.float32(count + 1)
        if self.factored:
            decay = float(np.float32(1.0) - t ** np.float32(-0.8))
            layout = _whole(grads, layout)
            updates = {}
            for names in _groups(grads, layout):
                updates.update(self._adafactor(names, grads, params, state, decay, lr, layout))
        else:
            # Bias corrections 1 - b**t in f32, as optax computes them.
            c1 = float(np.float32(1.0) - np.float32(_B1) ** t)
            c2 = float(np.float32(1.0) - np.float32(_B2) ** t)
            updates = {n: self._adamw(n, g, params[n], state, c1, c2, lr) for n, g in grads.items()}
        state["count"] = count + 1
        return updates

    def _adamw(self, name, g, p, state, c1, c2, lr):
        mu = (1 - _B1) * g + _B1 * state["mu"][name]
        nu = (1 - _B2) * (g * g) + _B2 * state["nu"][name]
        state["mu"][name], state["nu"][name] = mu, nu
        u = (mu / c1) / (torch.sqrt(nu / c2) + _EPS)
        if self.decays(p):
            u = u + self.weight_decay * p
        return u * -lr

    def _adafactor(self, names, grads, params, state, decay, lr, layout) -> Params:
        """The updates of one logical parameter held as ``names``' slices (in
        rank order; a single name where it is whole): the factored dims of
        the logical shape, each statistic's mean over the logical tensor,
        the RMS clip over the logical update."""
        split = layout[names[0]].dim
        shape = layout[names[0]].logical_shape(grads[names[0]].shape)
        gs = [grads[n] for n in names]
        g2s = [g * g + 1e-30 for g in gs]
        dims = _factored_dims(shape)
        us = []
        if dims is None:
            for n, g, g2 in zip(names, gs, g2s):
                v = decay * state["v"][n] + (1.0 - decay) * g2
                state["v"][n] = v
                us.append(g * v ** -0.5)
        else:
            d1, d0 = dims
            rows = _split_mean(g2s, d0, split, shape[d0])
            cols = _split_mean(g2s, d1, split, shape[d1])
            for n, row, col in zip(names, rows, cols):
                state["v_row"][n] = decay * state["v_row"][n] + (1.0 - decay) * row
                state["v_col"][n] = decay * state["v_col"][n] + (1.0 - decay) * col
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            v_rows = [state["v_row"][n] for n in names]
            row_means = _split_mean(v_rows, reduced_d1, _reduced(split, d0), shape[d1], keepdim=True)
            for n, g, v_row, row_mean in zip(names, gs, v_rows, row_means):
                row_factor = (v_row / row_mean) ** -0.5
                us.append(g * row_factor.unsqueeze(d0) * (state["v_col"][n] ** -0.5).unsqueeze(d1))
        squares = sum_on([(u * u).sum() for u in us], us[0].device)
        clip = torch.clamp(torch.sqrt(squares / math.prod(shape)), min=1.0)
        updates = {}
        for n, u in zip(names, us):
            u = u / clip.to(u.device) * lr
            if self.weight_decay and self.decays(params[n]):
                u = u + self.weight_decay * params[n]
            updates[n] = -u
        return updates


def make_optimizer(
    learning_rate: float = 1e-5,
    weight_decay: float = 1e-4,
    warmup_steps: int = 0,
    total_steps: Optional[int] = None,
    grad_clip_norm: Optional[float] = 1.0,
    factored: bool = False,
) -> Optimizer:
    """AdamW (or Adafactor with ``factored``: no first moment and a few
    statistics per matrix, where AdamW's two fp32 moments would not fit)
    with global-norm clipping and the warmup + cosine schedule, tpuclip's
    fine-tuning recipe."""
    return Optimizer(
        make_schedule(learning_rate, warmup_steps, total_steps),
        weight_decay=weight_decay, grad_clip_norm=grad_clip_norm, factored=factored,
    )


def apply_updates(params: Params, updates: Params) -> None:
    """``p += u`` for every parameter, in place."""
    with torch.no_grad():
        for n, p in params.items():
            p.add_(updates[n])


# =============================================================================
# Train step
# =============================================================================


@dataclass
class TrainState:
    model: SiglipModel  # fp32 parameters that require grad (the lead replica under a mesh)
    opt_state: dict
    step: int = 0
    # Under a mesh: every replica, ``model`` first, one per local data shard.
    replicas: Optional[List[SiglipModel]] = None
    # Each parameter's place in the logical model (each its own, whole, on
    # one device or a model axis of 1).
    layout: Layout = field(init=False)

    def __post_init__(self):
        self.layout = shard_layout(self.model)

    def params(self) -> Params:
        return dict(self.model.named_parameters())

    @torch.no_grad()
    def sync_replicas(self) -> None:
        """Copy the lead replica's parameters into the others (each shard
        into the same rank of the other rows)."""
        lead = self.params()
        for replica in (self.replicas or [])[1:]:
            for name, p in replica.named_parameters():
                p.copy_(lead[name])


def init_train_state(model: SiglipModel, optimizer: Optimizer, mesh: Optional[Mesh] = None) -> TrainState:
    """The state of ``model`` (and, with a mesh, its replicas: one per local
    data shard, ``sharding.shard_params``); the optimizer's state lives with
    the lead replica, per shard on the shard's device where the replicas
    are tensor parallel."""
    model.requires_grad_(True)
    replicas = None
    if mesh is not None:
        from tpuclip_torch.parallel.sharding import shard_params

        replicas = shard_params(model, mesh)
        model = replicas[0]
    return TrainState(model, optimizer.init(dict(model.named_parameters()), shard_layout(model)), 0, replicas)


def _all_gather_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """(b, D) → (world * b, D), rank-major, differentiable: the backward of
    ``torch.distributed.nn``'s all_gather sums each slice's gradient over
    the processes (gloo on host tensors)."""
    from torch.distributed.nn.functional import all_gather

    on_host = dist.get_backend(mesh.group) != "nccl"
    parts = all_gather(x.cpu() if on_host else x, group=mesh.group)
    return torch.cat(parts).to(x.device)


def data_parallel_value_and_grad(
    state: TrainState,
    mesh: Mesh,
    images: torch.Tensor,
    input_ids: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> Tuple[torch.Tensor, Params]:
    """The loss over the global batch and its gradients, summed over the
    replicas (and the processes), each on its parameter's device in the
    lead replica; equal to the single-device loss and gradients on the same
    batch.

    Global shard ``s`` takes rows [s * b, (s + 1) * b) of the batch (b =
    B / ndev). Each replica's unit features go to the lead device (and
    through an all_gather over the group); every process computes the same
    loss, and backpropagates it divided by the world size, since the
    all_gather's backward sums the processes' gradients of each slice. The
    replicas' checkpointed layers recompute in the backward pass."""
    ndev = mesh.shape[DATA_AXIS]
    batch = images.shape[0]
    if batch % ndev:
        raise ValueError(f"a batch of {batch} does not split over {ndev} data shards")
    b = batch // ndev
    lead = mesh.lead
    for replica in state.replicas:
        replica.zero_grad(set_to_none=True)
    imgs, txts = [], []
    for j, (replica, dev) in enumerate(zip(state.replicas, mesh.data_devices)):
        rows = slice(mesh.shard_index(j) * b, (mesh.shard_index(j) + 1) * b)
        mask = None if attention_mask is None else attention_mask[rows].to(dev)
        with remat_scope(replica):
            img, txt = _features(replica, images[rows].to(dev), input_ids[rows].to(dev), mask, compute_dtype)
        imgs.append(img.to(lead))
        txts.append(txt.to(lead))
    img, txt = torch.cat(imgs), torch.cat(txts)
    if mesh.group is not None:
        img, txt = _all_gather_rows(mesh, img), _all_gather_rows(mesh, txt)
    loss = _pair_loss(img, txt, state.model)
    (loss / mesh.world_size).backward()
    grads = {}
    for name, p in state.model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        for replica in state.replicas[1:]:
            other = replica.get_parameter(name).grad
            if other is not None:
                g = g + other.to(g.device)
        grads[name] = g
    if mesh.group is not None:
        # One all_reduce a rank of the row, over the gradients on that
        # rank's device flattened there and put back: no device holds more
        # than its own shards' gradients.
        on_host = dist.get_backend(mesh.group) != "nccl"
        by_rank: Dict[int, List[str]] = {}
        for n in grads:
            by_rank.setdefault(state.layout[n].rank, []).append(n)
        for names in by_rank.values():
            flat = torch.cat([grads[n].reshape(-1) for n in names])
            buf = flat.cpu() if on_host else flat
            dist.all_reduce(buf, group=mesh.group)
            flat = buf.to(flat.device)
            offset = 0
            for n in names:
                size = grads[n].numel()
                grads[n] = flat[offset : offset + size].view_as(grads[n])
                offset += size
    for replica in state.replicas:
        replica.zero_grad(set_to_none=True)
    return loss.detach(), grads


def make_train_step(
    optimizer: Optimizer, compute_dtype: torch.dtype = torch.bfloat16, mesh: Optional[Mesh] = None
):
    """``step(state, images, input_ids, attention_mask=None) -> (state,
    loss)``: the loss and its gradients with each encoder layer checkpointed
    (recomputed in the backward pass, tpuclip's ``remat_scope``), then one
    optimizer update of the parameters in place. With a mesh, the state
    must come from ``init_train_state(..., mesh)``: the gradients are
    :func:`data_parallel_value_and_grad`'s, and the update is copied to
    every replica."""

    def step(state: TrainState, images: torch.Tensor, input_ids: torch.Tensor,
             attention_mask: Optional[torch.Tensor] = None):
        params = state.params()
        if mesh is not None:
            loss, grads = data_parallel_value_and_grad(
                state, mesh, images, input_ids, attention_mask, compute_dtype
            )
            apply_updates(params, optimizer.update(grads, state.opt_state, params, state.layout))
            state.sync_replicas()
        else:
            for p in params.values():
                p.grad = None
            with remat_scope(state.model):
                loss = sigmoid_contrastive_loss(state.model, images, input_ids, compute_dtype, attention_mask)
            loss.backward()
            grads = {n: p.grad for n, p in params.items()}
            apply_updates(params, optimizer.update(grads, state.opt_state, params, state.layout))
            for p in params.values():
                p.grad = None
            loss = loss.detach()
        state.step += 1
        return state, loss

    return step


@torch.no_grad()
def eval_retrieval_at_1(
    model: SiglipModel, images: torch.Tensor, input_ids: torch.Tensor,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> float:
    """Text → image retrieval@1 on a batch (a sanity metric for fine-tuning)."""
    img = _unit(model.vision(images, compute_dtype).float())
    txt = _unit(model.text(input_ids, compute_dtype).float())
    pred = torch.argmax(txt @ img.T, dim=-1)
    return float((pred == torch.arange(len(pred), device=pred.device)).float().mean())
