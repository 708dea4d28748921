"""Opt-in profiling, preserving the reference's report formats.

Scan-side per-op accumulating timers with total/avg/%/throughput report
(image_database.py:869-871, 1070-1080) and search-side per-step timings dict
with a sorted ms report (image_database.py:1338, 1649-1656), on the host's
``time.perf_counter()``. Device work is queued asynchronously, so a timed
device section means something only where it ends waiting for the card:
the pipelines end each one with a host copy (``.cpu()``) of its result.

:func:`span` names a region of the program on the ``torch.profiler``
clock, the clock of the device trace; each :class:`StepTimers` ``track(op)``
opens ``span("scan.<op>")``, so the trace that ``scan --profile`` writes
under ``TPUCLIP_TRACE_DIR`` holds the timed steps beside the kernels.
:class:`Timings` opens none: no trace is taken around a search.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from typing import ContextManager, Dict, Iterator

import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast

from tpuclip_torch.utils.logging import log

_OFF = nullcontext()


def span(name: str) -> ContextManager:
    """A named region of the program in a ``torch.profiler`` trace: while a
    profiler records, a host event ``name`` around the block, which the
    profiler links to every kernel launched inside it; otherwise one shared
    no-op context, at the cost of one flag check. No device sync, tensor op
    or allocation either way. The flag is the process's, not the thread's:
    a profiler records the events of the thread that started it, or of
    every thread with ``profile_all_threads``.

    The event is recorded in the profiler's function scope, as an operator
    is, not as a ``record_function`` user annotation: a user annotation
    also leaves a copy of itself on the card's timeline, spanning the
    kernels it launched, which a reader of the trace would take for device
    work. Names are ``<layer>.<step>``: ``engine.*``, ``tower.*``,
    ``scan.*``."""
    return _RecordFunctionFast(name) if _autograd_profiler._is_profiler_enabled else _OFF


class StepTimers:
    """Accumulating per-operation timers (scan profile)."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextmanager
    def track(self, op: str, count: int = 1) -> Iterator[None]:
        start = time.perf_counter()
        try:
            with span("scan." + op):
                yield
        finally:
            self.totals[op] += time.perf_counter() - start
            self.counts[op] += count

    def report(self, processed: int = 0) -> None:
        if not self.totals:
            return
        log("\n=== Performance Profile ===")
        total_time = sum(self.totals.values())
        for operation, total in self.totals.items():
            count = self.counts.get(operation, 1)
            avg = total / count if count > 0 else 0.0
            pct = (total / total_time * 100) if total_time > 0 else 0.0
            log(
                f"  {operation:15s}: {total:8.2f}s total, {avg * 1000:6.1f}ms avg, "
                f"{pct:5.1f}% of time ({count} ops)"
            )
        log(f"  {'TOTAL':15s}: {total_time:8.2f}s")
        if processed > 0 and total_time > 0:
            log(f"  Throughput: {processed / total_time:.1f} images/second")


class Timings:
    """Per-step one-shot timings (search profile)."""

    def __init__(self) -> None:
        self.timings: Dict[str, float] = {}

    @contextmanager
    def track(self, op: str) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            self.timings[op] = time.perf_counter() - start

    def __setitem__(self, op: str, seconds: float) -> None:
        self.timings[op] = seconds

    def report(self) -> None:
        if not self.timings:
            return
        log("\n=== Search Performance Profile ===")
        total_time = sum(self.timings.values())
        for operation, duration in sorted(self.timings.items(), key=lambda x: x[1], reverse=True):
            pct = (duration / total_time * 100) if total_time > 0 else 0.0
            log(f"  {operation:25s}: {duration * 1000:7.2f}ms ({pct:5.1f}%)")
        log(f"  {'TOTAL':25s}: {total_time * 1000:7.2f}ms")
        log("=" * 40 + "\n")
