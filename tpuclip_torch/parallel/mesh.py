"""Device mesh (PyTorch port of ``tpuclip/parallel/mesh.py``).

tpuclip's mesh is single-controller: one process builds ``make_mesh()``
over every device it sees and drives all of them, and only a multi-host
run starts several processes (``maybe_distributed_init``). The port keeps
that shape:

- a :class:`Mesh` is an ordered tuple of this process's local
  ``torch.device``\\ s, reshaped (data, model) as tpuclip's device array,
  plus the ``torch.distributed`` process group when one is initialized;
- the data axis spans the local devices times the group's world size, and
  global data shard ``rank * local_shards + j`` lives on this process's
  ``j``-th data device (the first device of each model row);
- the row-sharded searches (``sharded_search.py``, ``sharded_ivf.py``) run
  each local shard on its own device, concatenate the shards' candidates
  on the lead device and, with a group, ``all_gather`` them across the
  processes; the data-parallel train step (``training.py``) does the same
  with the towers' features.

The devices may repeat: ``make_mesh(["cuda:0"] * 4)`` holds four real
shards on one card, as tpuclip's tests run an 8-device mesh on one CPU.
A mesh never mixes the CPU and CUDA devices.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from tpuclip_torch.device import DeviceLike, resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"

# Seconds a process waits for the others in maybe_distributed_init.
_INIT_TIMEOUT_S = 300


class Mesh:
    """This process's devices as a (data, model) grid, and the process
    group that joins it to the other processes' meshes (None: one process)."""

    def __init__(
        self,
        devices: Sequence[torch.device],
        model_parallelism: int = 1,
        group: Optional[dist.ProcessGroup] = None,
    ):
        devices = tuple(torch.device(d) for d in devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devices}) != 1:
            raise ValueError(f"a mesh takes devices of one type, got {[str(d) for d in devices]}")
        if len(devices) % model_parallelism:
            raise ValueError(f"{len(devices)} devices not divisible by model_parallelism={model_parallelism}")
        self.devices = devices
        self.model_parallelism = model_parallelism
        self.group = group
        self.rank = dist.get_rank(group) if group is not None else 0
        self.world_size = dist.get_world_size(group) if group is not None else 1

    @property
    def data_devices(self) -> Tuple[torch.device, ...]:
        """One device per local data shard: the first of each model row."""
        return self.devices[:: self.model_parallelism]

    @property
    def shape(self) -> Dict[str, int]:
        """Axis sizes, as tpuclip's ``mesh.shape``: the data axis counts the
        shards of every process."""
        return {DATA_AXIS: len(self.data_devices) * self.world_size, MODEL_AXIS: self.model_parallelism}

    @property
    def lead(self) -> torch.device:
        """The device that holds merged results and replicated inputs."""
        return self.devices[0]

    def shard_index(self, j: int) -> int:
        """The global data-shard index of this process's ``j``-th shard."""
        return self.rank * len(self.data_devices) + j

    def __repr__(self) -> str:
        return (f"Mesh({DATA_AXIS}={self.shape[DATA_AXIS]}, {MODEL_AXIS}={self.model_parallelism}, "
                f"local={[str(d) for d in self.devices]}, rank={self.rank}/{self.world_size})")


def _default_group() -> Optional[dist.ProcessGroup]:
    return dist.group.WORLD if dist.is_available() and dist.is_initialized() else None


def make_mesh(
    devices: Optional[Sequence[Union[str, torch.device]]] = None,
    model_parallelism: int = 1,
) -> Mesh:
    """Mesh of shape (data, model) over ``devices`` (default: every local
    CUDA device), joined to the default process group when
    ``torch.distributed`` is initialized (data axis = local data devices x
    world size)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() takes every local CUDA device, and torch.cuda.is_available() is False; "
                "pass devices=['cpu', ...] for a CPU mesh."
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return Mesh(devices, model_parallelism, _default_group())


def single_device_mesh(device: DeviceLike = None) -> Mesh:
    """A 1 x 1 mesh on ``device`` (the card unless the caller names the CPU),
    outside any process group."""
    return Mesh([resolve_device(device)])


def maybe_distributed_init(backend: Optional[str] = None, timeout_s: float = _INIT_TIMEOUT_S) -> None:
    """Multi-host bootstrap: a no-op unless ``TPUCLIP_MULTIHOST`` is ``1``
    or ``true``, and when ``torch.distributed`` is already initialized.

    With it, initializes the default process group over ``backend`` (NCCL
    when CUDA is available, gloo otherwise; two processes sharing one card
    must take gloo). tpuclip's launcher variables name the coordinator:
    ``JAX_COORDINATOR_ADDRESS`` (host:port, where process 0 listens),
    ``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``. As in tpuclip, they are
    tested for truthiness: exported-but-empty variables fall through to the
    launcher's own environment (``torchrun``'s ``MASTER_ADDR`` /
    ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``), and process id ``"0"``
    is a non-empty string, so process 0 takes the explicit path. A
    coordinator that cannot be reached within ``timeout_s`` raises."""
    if os.environ.get("TPUCLIP_MULTIHOST", "") not in ("1", "true"):
        return
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    timeout = datetime.timedelta(seconds=timeout_s)
    addr = os.environ.get("JAX_COORDINATOR_ADDRESS")
    nproc = os.environ.get("JAX_NUM_PROCESSES")
    pid = os.environ.get("JAX_PROCESS_ID")
    if addr and nproc and pid:
        dist.init_process_group(
            backend, init_method=f"tcp://{addr}", world_size=int(nproc), rank=int(pid), timeout=timeout
        )
    else:
        dist.init_process_group(backend, init_method="env://", timeout=timeout)
