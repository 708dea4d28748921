"""From a ``torch.profiler`` trace to a timeline the metric readers read.

The profiler records the benchmark's own spans (``record_function``: the
window, each call), the host's operators and the card's kernels, copies and
sets on one clock. The raw events are read without building the profiler's
event tree, which is slow at a million events.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from torch.autograd import DeviceType

WINDOW_SPAN = "bench.window"
CALL_SPAN = "bench.call"
SPANS = (WINDOW_SPAN, CALL_SPAN)
COPY_PREFIXES = ("Memcpy", "Memset")

Interval = Tuple[int, int]  # [start, end) in ns


@dataclass
class Timeline:
    window: Interval
    calls: List[Interval]
    kernels: List[Tuple[int, int, str]]  # compute kernels: start, end, name
    copies: List[Tuple[int, int, str]]  # memcpy and memset
    host_ops: List[Tuple[int, int, str]]  # outermost host operators, main thread
    busy: List[Interval] = field(default_factory=list)  # union of kernels and copies

    def __post_init__(self):
        self.busy = union([(s, e) for s, e, _ in self.kernels + self.copies])

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_ns(self, a: int, b: int, intervals: Optional[List[Interval]] = None) -> int:
        return covered(self.busy if intervals is None else intervals, a, b)


def union(intervals: List[Interval]) -> List[Interval]:
    """Sorted, disjoint union."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(merged: List[Interval], a: int, b: int) -> int:
    """Length of ``merged`` (sorted, disjoint) inside [a, b)."""
    i = max(bisect.bisect_right(merged, (a, a)) - 1, 0)
    total = 0
    while i < len(merged) and merged[i][0] < b:
        s, e = merged[i]
        total += max(0, min(e, b) - max(s, a))
        i += 1
    return total


def gaps(merged: List[Interval], a: int, b: int) -> List[Interval]:
    """The parts of [a, b) that ``merged`` leaves uncovered."""
    out, t = [], a
    for s, e in merged:
        if e <= a:
            continue
        if s >= b:
            break
        if s > t:
            out.append((t, min(s, b)))
        t = max(t, e)
    if t < b:
        out.append((t, b))
    return out


def from_profiler(prof) -> Timeline:
    """The timeline of a finished ``torch.profiler.profile``. Events are
    told apart by device and name alone (some PyTorch builds give a raw
    event no activity type): on the host, the benchmark's spans by their
    names and every other event as a host operator; on the card, copies and
    sets by their names (``Memcpy ...``, ``Memset ...``) and every other
    event as a kernel, but for the card-side copies of the spans."""
    spans: Dict[str, List[Interval]] = defaultdict(list)
    kernels, copies, ops = [], [], []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        s = ev.start_ns()
        e = s + ev.duration_ns()
        on_card = ev.device_type() != DeviceType.CPU
        if name in SPANS:
            if not on_card:
                spans[name].append((s, e, ev.start_thread_id()))
        elif on_card:
            (copies if name.startswith(COPY_PREFIXES) else kernels).append((s, e, name))
        else:
            ops.append((s, e, name, ev.start_thread_id()))
    if not spans.get(WINDOW_SPAN):
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN!r} span")
    a, b, main_thread = spans[WINDOW_SPAN][0]
    window = (a, b)
    outer, end = [], -1
    for s, e, name, thread in sorted(op for op in ops if op[3] == main_thread):
        if s >= end:
            outer.append((s, e, name))
            end = e
    inside = lambda xs: [x for x in xs if x[0] < window[1] and x[1] > window[0]]  # noqa: E731
    calls = sorted((s, e) for s, e, _ in inside(spans[CALL_SPAN]))
    return Timeline(window=window, calls=calls, kernels=inside(kernels), copies=inside(copies),
                    host_ops=inside(outer))


def device_ops(t: Timeline, top: int = 10) -> List[list]:
    """The device operations that took most time in the window: [name, s]."""
    by_name: Dict[str, int] = defaultdict(int)
    a, b = t.window
    for s, e, name in t.kernels + t.copies:
        by_name[name] += max(0, min(e, b) - max(s, a))
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return [[name[:120], ns / 1e9] for name, ns in ranked]


def idle_gaps(t: Timeline, top: int = 10) -> List[list]:
    """Device-idle time in the window by what the host was doing:
    ``<span>/<outermost host operator>``, the span being a call or
    ``between_calls``, the operator ``python`` where none ran."""
    by_label: Dict[str, int] = defaultdict(int)
    calls = union(t.calls)
    call_starts = [s for s, _ in calls]
    op_starts = [s for s, _, _ in t.host_ops]
    for a, b in gaps(t.busy, *t.window):
        # cut the gap at call and operator boundaries, then label each piece
        cuts = {a, b}
        i = max(bisect.bisect_right(call_starts, a) - 1, 0)
        while i < len(calls) and calls[i][0] < b:
            cuts.update(x for x in calls[i] if a < x < b)
            i += 1
        i = max(bisect.bisect_right(op_starts, a) - 1, 0)
        while i < len(t.host_ops) and t.host_ops[i][0] < b:
            s, e, _ = t.host_ops[i]
            cuts.update(x for x in (s, e) if a < x < b)
            i += 1
        edges = sorted(cuts)
        for x, y in zip(edges, edges[1:]):
            mid = (x + y) // 2
            span = "call" if covered(calls, mid, mid + 1) else "between_calls"
            j = bisect.bisect_right(op_starts, mid) - 1
            op = t.host_ops[j][2] if j >= 0 and t.host_ops[j][1] > mid else "python"
            by_label[f"{span}/{op}"] += y - x
    ranked = sorted(by_label.items(), key=lambda kv: -kv[1])[:top]
    return [[label[:120], ns / 1e9] for label, ns in ranked]
