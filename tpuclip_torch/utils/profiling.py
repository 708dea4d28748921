"""Opt-in profiling, preserving the reference's report formats.

Scan-side per-op accumulating timers with total/avg/%/throughput report
(image_database.py:869-871, 1070-1080) and search-side per-step timings dict
with a sorted ms report (image_database.py:1338, 1649-1656). Device work is
dispatched asynchronously by JAX, so timed device sections must block on the
result (``jax.block_until_ready``) for the numbers to mean anything; the
pipelines do that when profiling is enabled.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, Iterator

from tpuclip_torch.utils.logging import log


class StepTimers:
    """Accumulating per-operation timers (scan profile)."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextmanager
    def track(self, op: str, count: int = 1) -> Iterator[None]:
        start = time.time()
        try:
            yield
        finally:
            self.totals[op] += time.time() - start
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
        start = time.time()
        try:
            yield
        finally:
            self.timings[op] = time.time() - start

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
