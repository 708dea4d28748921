"""Tensor-parallel towers over the mesh's ``model`` axis.

tpuclip annotates its parameters with the rule table of
``parallel/sharding.py`` and lets XLA split the towers and insert the
reduces. The port does the same split by hand, on the port's
single-controller mesh (``parallel/mesh.py``): a mesh row (``model``
devices of one data shard) always lies within one process, so tensor
parallelism needs no collective across processes, only copies between
this process's devices.

:func:`to_tensor_parallel` turns a ``SiglipModel`` into one replica over a
row's devices. Every encoder layer's and the vision head's ``attn`` and
``mlp`` become :class:`TensorParallelAttention` / :class:`TensorParallelMLP`:

- rank ``i`` holds rows ``[i*D/mp, (i+1)*D/mp)`` of q / k / v (their heads
  ``[i*H/mp, (i+1)*H/mp)``: ``view(b, s, h, hd)`` keeps a head's columns
  together) and the same columns of o; rows of fc1 (with its bias) and the
  same columns of fc2: the rule table's split
  (``sharding.param_shardings``);
- everything else stays on the row's first device: the embeddings, every
  LayerNorm, the residual stream, the MAP probe, the text head, the logit
  scale and bias, and the o / fc2 biases;
- a split block copies its input to each rank's device, runs that rank's
  heads (or hidden slice) there, copies each rank's partial output (o or
  fc2 without its bias) to the first device, and sums the partials there
  in rank order. The copies are ``Tensor.to``, which autograd carries
  back, so training needs no backward of its own.

Numerics: each partial comes out of its GEMM in the compute dtype (its
fp32 accumulator rounded once, as one device's GEMM rounds), and the
partials are summed in fp32 with the bias and rounded once more. In fp32
this is one device's sum in another order; in bf16 it adds one rounding a
rank, as a bf16 all-reduce would (tpuclip's XLA sums its f32 dot outputs
before the bias and the cast).

A shard's parameter is named as the logical parameter with ``shards.<rank>``
before its last part (``...attn.shards.1.q.weight`` is rank 1's slice of
``...attn.q.weight``); a replicated bias keeps its logical name
(``...attn.o.bias``). :func:`shard_layout` maps each name back to its
logical name, split dim and rank, for the optimizer and the checkpoint.

The devices of a row may repeat (``["cuda:0"] * 2``): then every copy is a
no-op and a placement fault cannot show; the tests hold placement on the
CPU with a recorder of every tensor's device.
"""

from __future__ import annotations

import copy
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tpuclip_torch.models.siglip import MLP, Attention, SiglipModel, attend, dense, gelu_tanh
from tpuclip_torch.parallel.sharding import MODEL_AXIS, _spec_for


def _slice(p: torch.Tensor, dim: int, rank: int, ranks: int, device: torch.device) -> nn.Parameter:
    """Rank ``rank``'s contiguous slice of ``p`` along ``dim``, copied to
    ``device`` (never a view of ``p``)."""
    n = p.shape[dim] // ranks
    part = p.detach().narrow(dim, rank * n, n)
    return nn.Parameter(part.to(device, memory_format=torch.contiguous_format, copy=True),
                        requires_grad=p.requires_grad)


def _whole(p: torch.Tensor, device: torch.device) -> nn.Parameter:
    return nn.Parameter(p.detach().to(device, copy=True), requires_grad=p.requires_grad)


class _Part(nn.Module):
    """A linear layer's ``weight`` and ``bias``, either of which may be None:
    one rank's slice of it, or the bias it keeps whole."""

    def __init__(self, weight: Optional[nn.Parameter] = None, bias: Optional[nn.Parameter] = None):
        super().__init__()
        self.register_parameter("weight", weight)
        self.register_parameter("bias", bias)


def sum_on(parts: List[torch.Tensor], device: torch.device) -> torch.Tensor:
    """``parts`` (one per device) added in order on ``device``."""
    total = parts[0].to(device)
    for part in parts[1:]:
        total = total + part.to(device)
    return total


def _reduce(parts: List[torch.Tensor], bias: torch.Tensor) -> torch.Tensor:
    """The ranks' partial outputs (on the first device) summed in rank order
    in fp32, plus the bias, rounded once to the partials' dtype."""
    return (sum_on([part.float() for part in parts], parts[0].device) + bias.float()).to(parts[0].dtype)


class TensorParallelAttention(nn.Module):
    """:class:`~tpuclip_torch.models.siglip.Attention` with its heads split
    over ``devices`` (their count divides the heads); the output is on
    ``devices[0]``."""

    def __init__(self, attn: Attention, devices: Sequence[torch.device]):
        super().__init__()
        ranks = len(devices)
        self.devices = tuple(devices)
        self.num_heads = attn.num_heads // ranks  # each rank's heads
        self.shards = nn.ModuleList(
            nn.ModuleDict({
                **{name: _Part(_slice(getattr(attn, name).weight, 0, i, ranks, dev),
                               _slice(getattr(attn, name).bias, 0, i, ranks, dev)) for name in ("q", "k", "v")},
                "o": _Part(_slice(attn.o.weight, 1, i, ranks, dev)),
            })
            for i, dev in enumerate(self.devices)
        )
        self.o = _Part(bias=_whole(attn.o.bias, self.devices[0]))

    def forward(
        self, q_in: torch.Tensor, kv_in: torch.Tensor, mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        parts = []
        for shard, dev in zip(self.shards, self.devices):
            x_q = q_in.to(dev)
            x_kv = x_q if kv_in is q_in else kv_in.to(dev)
            # An additive key mask broadcasts over the rank's heads as over all.
            m = None if mask is None else mask.to(dev)
            heads = attend(x_q, x_kv, shard["q"], shard["k"], shard["v"], self.num_heads, m)
            parts.append(F.linear(heads, shard["o"].weight.to(heads.dtype)).to(self.devices[0]))
        return _reduce(parts, self.o.bias)


class TensorParallelMLP(nn.Module):
    """:class:`~tpuclip_torch.models.siglip.MLP` with its hidden dimension
    split over ``devices`` (their count divides it); the output is on
    ``devices[0]``."""

    def __init__(self, mlp: MLP, devices: Sequence[torch.device]):
        super().__init__()
        ranks = len(devices)
        self.devices = tuple(devices)
        self.shards = nn.ModuleList(
            nn.ModuleDict({
                "fc1": _Part(_slice(mlp.fc1.weight, 0, i, ranks, dev), _slice(mlp.fc1.bias, 0, i, ranks, dev)),
                "fc2": _Part(_slice(mlp.fc2.weight, 1, i, ranks, dev)),
            })
            for i, dev in enumerate(self.devices)
        )
        self.fc2 = _Part(bias=_whole(mlp.fc2.bias, self.devices[0]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        parts = []
        for shard, dev in zip(self.shards, self.devices):
            hidden = gelu_tanh(dense(x.to(dev), shard["fc1"]))
            parts.append(F.linear(hidden, shard["fc2"].weight.to(hidden.dtype)).to(self.devices[0]))
        return _reduce(parts, self.fc2.bias)


def to_tensor_parallel(model: SiglipModel, devices: Sequence[torch.device]) -> SiglipModel:
    """One tensor-parallel replica of ``model`` over ``devices`` (a mesh row):
    a copy of ``model`` on ``devices[0]`` whose attention and MLP blocks are
    split over ``devices``. ``model`` itself is left as it is. A count of
    devices that does not divide the heads and the MLP width raises
    ``ValueError``."""
    devices = tuple(torch.device(d) for d in devices)
    for tower in (model.cfg.vision, model.cfg.text):
        for what, n in (("num_heads", tower.num_heads), ("intermediate_size", tower.intermediate_size)):
            if n % len(devices):
                raise ValueError(f"model_parallelism={len(devices)} does not divide {what}={n}")
    # The blocks the rule table splits: every encoder layer's and the
    # vision head's attention and MLP.
    blocks = [(name, m) for name, m in model.named_modules() if isinstance(m, (Attention, MLP))]
    # Copy everything but the blocks (the memo stands None in for each),
    # then build each block's shards straight from the source's tensors.
    replica = copy.deepcopy(model, {id(m): None for _, m in blocks}).to(devices[0])
    for name, block in blocks:
        parent, _, child = name.rpartition(".")
        split = TensorParallelAttention if isinstance(block, Attention) else TensorParallelMLP
        setattr(replica.get_submodule(parent), child, split(block, devices))
    return replica


@dataclass(frozen=True)
class Shard:
    """Where a parameter of a (possibly tensor-parallel) model sits in the
    one-device model: its ``logical`` name, the ``dim`` it is split along
    (None: held whole) and its ``rank`` of ``ranks`` slices."""

    logical: str
    dim: Optional[int] = None
    rank: int = 0
    ranks: int = 1

    def logical_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        shape = list(shape)
        if self.dim is not None:
            shape[self.dim] *= self.ranks
        return tuple(shape)


_SHARD_PART = re.compile(r"\.shards\.(\d+)\.")


def shard_layout(model: SiglipModel) -> Dict[str, Shard]:
    """{parameter name: :class:`Shard`} for every parameter of ``model``;
    on a one-device model every parameter is its own logical one, whole."""
    layout = {}
    for name, p in model.named_parameters():
        found = _SHARD_PART.search(name)
        if found is None:
            layout[name] = Shard(name)
            continue
        logical = name[: found.start()] + "." + name[found.end():]
        spec = _spec_for(logical, p)
        ranks = len(model.get_submodule(name[: found.start()]).shards)
        layout[name] = Shard(logical, spec.index(MODEL_AXIS), int(found.group(1)), ranks)
    return layout


def gather_logical(
    tensors: Dict[str, torch.Tensor], layout: Dict[str, Shard], split_dim: Optional[Dict[str, Optional[int]]] = None
) -> Dict[str, torch.Tensor]:
    """{logical name: the whole tensor on the CPU} from the ranks' tensors
    ``tensors`` (keyed as ``layout``), each a slice along its parameter's
    split dim, or along ``split_dim[name]`` where given (None: each rank
    holds the whole, and rank 0's is taken)."""
    ranked: Dict[str, List[Tuple[int, str]]] = {}
    for name in tensors:
        ranked.setdefault(layout[name].logical, []).append((layout[name].rank, name))
    out = {}
    for logical, members in ranked.items():
        names = [name for _, name in sorted(members)]
        dim = layout[names[0]].dim if split_dim is None else split_dim[names[0]]
        parts = [tensors[n].detach().cpu() for n in names]
        out[logical] = parts[0] if dim is None else torch.cat(parts, dim=dim)
    return out


def logical_slice(
    whole: torch.Tensor, name: str, layout: Dict[str, Shard], split_dim: Optional[Dict[str, Optional[int]]] = None
) -> torch.Tensor:
    """Parameter ``name``'s rank's slice of the logical tensor ``whole`` (a
    view), the inverse of :func:`gather_logical`."""
    shard = layout[name]
    dim = shard.dim if split_dim is None else split_dim[name]
    if dim is None:
        return whole
    n = whole.shape[dim] // shard.ranks
    return whole.narrow(dim, shard.rank * n, n)
