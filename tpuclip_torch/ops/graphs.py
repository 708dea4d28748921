"""CUDA graphs for the fused query programs.

tpuclip answers a serving request with one jitted XLA program per ladder
bucket: tower, int8 scan and rescore compiled together. Eager PyTorch
instead launches each of a tower's hundreds of kernels from Python, one at a
time. The port's counterpart of one compiled program is one captured
``torch.cuda.CUDAGraph``: :class:`FusedGraphs` keeps one per (text bucket,
image bucket, k, shortlist method), which the index builds as the key, and
launches the whole program with one replay.

- Static inputs live on the device (token ids and mask ``(B, 64)``, pixels
  ``(B, S, S, 3)`` uint8), and so do the static outputs (``(Q, k)`` scores
  and rows). A call copies the host inputs in, replays, and copies the
  outputs out, or hands them to the caller's ``tail``, which runs on the
  device outputs under the runner's lock and copies out what it returns: a
  ``verified`` program's fallback reads its resident scores and embedding
  there, before any other replay can overwrite them.
- Each capture is preceded by one eager run on a side stream, as
  ``torch.cuda.graph`` requires: first-launch set-up (the kernels' shared
  memory attributes, cuBLAS handles) stays out of the graph.
- Every graph allocates from one memory pool (``graph_pool_handle``).
  Graphs that share a pool may overwrite each other's intermediates, so
  replays are serialized by a lock of the runner's own, held until the
  outputs are on the host; no caller's lock is relied on.
- A graph holds the pointers of the tensors it read at capture (the index's
  int8 matrix, scales and rows) and their ``n_valid``; the entry keeps the
  program's closure, and so those tensors, alive. The index drops its runner
  whenever it re-uploads.
- The kernel wrappers' launch counters (``ops._counters.COUNTED``) move
  while a program is captured, though capture launches nothing. The runner
  takes those counts back and adds them again at every replay, which is
  when the kernels run.

On the CPU the same programs run eager. On CUDA a capture or replay error
raises; nothing falls back to eager.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Hashable, Optional, Sequence, Tuple

import numpy as np
import torch

from tpuclip_torch.ops._counters import COUNTED


class _Graph:
    __slots__ = ("graph", "inputs", "outputs", "program", "launches")

    def __init__(self, graph, inputs, outputs, program, launches):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.program = program  # keeps the tensors the graph reads alive
        self.launches = launches  # ((wrapper, launches per replay), ...)


class FusedGraphs:
    """The captured programs of one index, on ``device``."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._graphs: Dict[Hashable, _Graph] = {}
        self._lock = threading.Lock()
        self._pool = torch.cuda.graph_pool_handle() if self.device.type == "cuda" else None
        self.capture_seconds = 0.0

    @staticmethod
    def _to_host(outputs: Sequence[torch.Tensor]) -> Tuple[np.ndarray, ...]:
        return tuple(o.cpu().numpy() for o in outputs)

    def __len__(self) -> int:
        return len(self._graphs)

    def run(
        self,
        key: Hashable,
        program: Callable[..., Sequence[torch.Tensor]],
        host_inputs: Sequence[np.ndarray],
        tail: Optional[Callable[[Sequence[torch.Tensor]], Any]] = None,
    ) -> Any:
        """``program(*inputs)`` on ``host_inputs`` → its outputs on the host,
        or ``tail(outputs)`` on the device outputs, run under the runner's
        lock. On CUDA the graph under ``key`` is captured at its first call
        and replayed from then on; ``program`` must compute the same function
        for every call with the same key."""
        tail = tail or self._to_host
        host_inputs = [np.ascontiguousarray(x) for x in host_inputs]
        if self.device.type != "cuda":
            return tail(program(*map(torch.from_numpy, host_inputs)))
        with self._lock:
            entry = self._graphs.get(key)
            if entry is None:
                entry = self._graphs[key] = self._capture(program, host_inputs)
            else:
                for buf, x in zip(entry.inputs, map(torch.from_numpy, host_inputs)):
                    if x.shape != buf.shape or x.dtype != buf.dtype:
                        raise ValueError(
                            f"graph {key!r} takes {tuple(buf.shape)} {buf.dtype}, "
                            f"got {tuple(x.shape)} {x.dtype}"
                        )
                    buf.copy_(x)
            entry.graph.replay()
            for wrapper, n in entry.launches:
                wrapper.launches += n
            return tail(entry.outputs)

    def _capture(self, program, host_inputs) -> _Graph:
        t0 = time.perf_counter()
        inputs = tuple(torch.from_numpy(x).to(self.device) for x in host_inputs)
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            program(*inputs)
        current.wait_stream(side)
        before = {wrapper: wrapper.launches for wrapper in COUNTED}
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local"):
            outputs = tuple(program(*inputs))
        launches = []
        for wrapper, count in before.items():
            if wrapper.launches != count:
                launches.append((wrapper, wrapper.launches - count))
                wrapper.launches = count
        self.capture_seconds += time.perf_counter() - t0
        return _Graph(graph, inputs, outputs, program, tuple(launches))

    def pool_bytes(self) -> int:
        """Device bytes the shared pool holds (its reserved segments)."""
        if self._pool is None:
            return 0
        pool = tuple(self._pool)
        return sum(
            seg["total_size"]
            for seg in torch.cuda.memory_snapshot()
            if tuple(seg.get("segment_pool_id", ())) == pool
        )
