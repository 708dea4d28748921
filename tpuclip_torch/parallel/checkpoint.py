"""Train-state checkpoint and resume (PyTorch port of ``tpuclip/parallel/checkpoint.py``).

tpuclip writes its ``TrainState`` with orbax, which the port may not
import. The port writes the same three parts (parameters, optimizer state,
step) with ``torch.save`` into one file, ``<dir>/train_state.pt``, and
refuses a directory that tpuclip's orbax wrote. The model itself is saved
apart, in tpuclip's checkpoint format (``models.checkpoint``), which both
packages load.

The file holds logical tensors, as tpuclip's orbax checkpoints are free
of layout: a tensor-parallel state's shards (parameters and optimizer
state) are gathered into the one-device model's tensors on save, and
sliced back into whichever template restores them, tensor parallel or not.
"""

from __future__ import annotations

from pathlib import Path

import torch

from tpuclip_torch.parallel.tensor_parallel import gather_logical, logical_slice
from tpuclip_torch.parallel.training import TrainState, state_split_dim

STATE_FILE = "train_state.pt"
_FORMAT = "tpuclip_torch.train_state/1"
# Files an orbax PyTree checkpoint directory holds.
_ORBAX_MARKERS = ("_METADATA", "_CHECKPOINT_METADATA", "manifest.ocdbt", "_sharding", "checkpoint")


class TrainStateError(ValueError):
    """A --resume directory that holds no train state this port can load."""


def _state_dims(state: TrainState):
    """For each per-parameter part of the optimizer state, the split dim of
    each tensor (a parameter's own is its layout's)."""
    params = dict(state.model.named_parameters())
    return {
        part: {n: state_split_dim(part, state.layout[n], params[n].shape) for n in tree}
        for part, tree in state.opt_state.items() if isinstance(tree, dict)
    }


def save_train_state(directory: str, state: TrainState) -> None:
    """Parameters, optimizer state and step of ``state`` into
    ``<directory>/train_state.pt`` as logical tensors on the CPU."""
    path = Path(directory)
    path.mkdir(parents=True, exist_ok=True)
    dims = _state_dims(state)
    opt_state = {
        part: gather_logical(tree, state.layout, dims[part]) if isinstance(tree, dict) else tree
        for part, tree in state.opt_state.items()
    }
    blob = {
        "format": _FORMAT,
        "params": gather_logical(dict(state.model.named_parameters()), state.layout),
        "opt_state": opt_state,
        "step": int(state.step),
    }
    torch.save(blob, path / STATE_FILE)


def restore_train_state(directory: str, template: TrainState) -> TrainState:
    """Load a train state written by :func:`save_train_state` into
    ``template`` (its model and optimizer state, each tensor sliced for its
    shard and put on its parameter's device). A directory written by
    tpuclip (orbax), a missing file and a state of another model or
    optimizer raise :class:`TrainStateError`."""
    path = Path(directory)
    state_file = path / STATE_FILE
    if not state_file.is_file():
        if path.is_dir() and any((path / m).exists() for m in _ORBAX_MARKERS):
            raise TrainStateError(
                f"{directory} is an orbax train state written by tpuclip; tpuclip_torch "
                f"resumes only its own ({STATE_FILE}, torch.save). Start from the model "
                "checkpoint instead (--model-cache with the saved model/ directory)."
            )
        raise TrainStateError(f"no tpuclip_torch train state at {state_file}")
    blob = torch.load(state_file, map_location="cpu", weights_only=True)
    if blob.get("format") != _FORMAT:
        raise TrainStateError(f"{state_file} is not a {_FORMAT} train state")
    params = dict(template.model.named_parameters())
    layout, dims = template.layout, _state_dims(template)

    def logical(names):
        return {layout[n].logical for n in names}

    if set(blob["params"]) != logical(params):
        raise TrainStateError(f"{state_file} holds parameters of another model")
    if set(blob["opt_state"]) != set(template.opt_state) or any(
        set(blob["opt_state"][part]) != logical(tree)
        for part, tree in template.opt_state.items() if isinstance(tree, dict)
    ):
        raise TrainStateError(f"{state_file} holds the state of another optimizer")

    def shard(whole, name, split_dim=None):
        return logical_slice(whole[layout[name].logical], name, layout, split_dim).to(params[name].device)

    with torch.no_grad():
        for name, p in params.items():
            p.copy_(shard(blob["params"], name))
    template.opt_state = {
        part: {n: shard(blob["opt_state"][part], n, dims[part]) for n in tree} if isinstance(tree, dict)
        else blob["opt_state"][part]
        for part, tree in template.opt_state.items()
    }
    template.step = int(blob["step"])
    template.sync_replicas()
    return template
