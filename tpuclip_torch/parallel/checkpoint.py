"""Train-state checkpoint and resume (PyTorch port of ``tpuclip/parallel/checkpoint.py``).

tpuclip writes its ``TrainState`` with orbax, which the port may not
import. The port writes the same three parts (parameters, optimizer state,
step) with ``torch.save`` into one file, ``<dir>/train_state.pt``, and
refuses a directory that tpuclip's orbax wrote. The model itself is saved
apart, in tpuclip's checkpoint format (``models.checkpoint``), which both
packages load.
"""

from __future__ import annotations

from pathlib import Path

import torch

from tpuclip_torch.parallel.training import TrainState

STATE_FILE = "train_state.pt"
_FORMAT = "tpuclip_torch.train_state/1"
# Files an orbax PyTree checkpoint directory holds.
_ORBAX_MARKERS = ("_METADATA", "_CHECKPOINT_METADATA", "manifest.ocdbt", "_sharding", "checkpoint")


class TrainStateError(ValueError):
    """A --resume directory that holds no train state this port can load."""


def save_train_state(directory: str, state: TrainState) -> None:
    """Parameters, optimizer state and step of ``state`` into
    ``<directory>/train_state.pt`` (tensors moved to the CPU)."""
    path = Path(directory)
    path.mkdir(parents=True, exist_ok=True)

    def cpu(tree):
        if isinstance(tree, dict):
            return {k: cpu(v) for k, v in tree.items()}
        return tree.detach().cpu() if torch.is_tensor(tree) else tree

    blob = {
        "format": _FORMAT,
        "params": cpu(dict(state.model.named_parameters())),
        "opt_state": cpu(state.opt_state),
        "step": int(state.step),
    }
    torch.save(blob, path / STATE_FILE)


def restore_train_state(directory: str, template: TrainState) -> TrainState:
    """Load a train state written by :func:`save_train_state` into
    ``template`` (its model and optimizer state, on their device). A
    directory written by tpuclip (orbax), a missing file and a state of
    another model or optimizer raise :class:`TrainStateError`."""
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
    if set(blob["params"]) != set(params):
        raise TrainStateError(f"{state_file} holds parameters of another model")
    if set(blob["opt_state"]) != set(template.opt_state):
        raise TrainStateError(f"{state_file} holds the state of another optimizer")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(blob["params"][name])
    device = next(iter(params.values())).device

    def load(tree):
        if isinstance(tree, dict):
            return {k: load(v) for k, v in tree.items()}
        return tree.to(device) if torch.is_tensor(tree) else tree

    template.opt_state = load(blob["opt_state"])
    template.step = int(blob["step"])
    template.sync_replicas()
    return template
