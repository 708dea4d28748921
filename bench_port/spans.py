"""The program's own spans in a traced window, and the span that launched
each kernel.

The port names its layers with ``tpuclip_torch.utils.profiling.span``: host
events named ``engine.*``, ``tower.*``, ``scan.*`` or ``search.*`` on the
profiler's clock. They are recorded in the profiler's function scope, not
as user annotations, so the card's timeline holds no copy of them and
:mod:`bench_port.trace` reads the same kernels, copies and calls with them
as without; there each is a host operator, the outermost of those it
encloses, so ``trace.idle_gaps`` labels a gap inside one by its name
(``call/engine.stage``).

A kernel's owner is the innermost program span open on the main thread
when the host launched it, the launch being the runtime or driver call
(``cudaLaunchKernel``, ``cuLaunchKernelEx``, ...) that carries the kernel's
correlation id.

``trace.Timeline`` keeps neither the nested spans nor the launches. A
reader gets them from :func:`program_trace`, which parses the run's
profile once per traced window, and raises rather than read nothing where
the timeline shows program spans that it cannot reach.
"""

from __future__ import annotations

import bisect
import sys
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

from torch.autograd import DeviceType

from bench_port.trace import COPY_PREFIXES, SPANS, WINDOW_SPAN, Interval, covered, union

PROGRAM_PREFIXES = ("engine.", "tower.", "scan.", "search.")
LAUNCH_PREFIX = "cu"  # the CUDA runtime's and driver's calls


def classify(name: str, on_card: bool) -> str:
    """What one raw profiler event is. On the host: ``bench`` (the
    benchmark's own spans), ``span`` (the program's) or ``op``. On the
    card: ``annotation`` (a card-side copy of a span, which a
    ``record_function`` leaves), ``copy`` (memcpy, memset) or ``kernel``."""
    is_span = name in SPANS or name.startswith(PROGRAM_PREFIXES)
    if on_card:
        if is_span:
            return "annotation"
        return "copy" if name.startswith(COPY_PREFIXES) else "kernel"
    if name in SPANS:
        return "bench"
    return "span" if is_span else "op"


@dataclass
class ProgramTrace:
    spans: List[Tuple[int, int, str, int]]  # main thread, in start order: start, end, name, depth
    kernels: List[Tuple[int, int, str, Optional[int]]]  # start, end, name, host launch (None: not found)
    _times: List[int] = field(init=False, default_factory=list, repr=False)
    _owners: List[Optional[str]] = field(init=False, default_factory=list, repr=False)

    def __post_init__(self):
        # the innermost open span after each span boundary, in time order
        stack: List[Tuple[int, str]] = []
        for s, e, name, _ in self.spans:
            while stack and stack[-1][0] <= s:
                self._close(stack)
            stack.append((e, name))
            self._times.append(s)
            self._owners.append(name)
        while stack:
            self._close(stack)

    def _close(self, stack) -> None:
        end, _ = stack.pop()
        self._times.append(end)
        self._owners.append(stack[-1][1] if stack else None)

    @property
    def names(self) -> set:
        return {name for _, _, name, _ in self.spans}

    def owner(self, launch: Optional[int]) -> Optional[str]:
        """The innermost program span open at host time ``launch``."""
        if launch is None:
            return None
        i = bisect.bisect_right(self._times, launch) - 1
        return self._owners[i] if i >= 0 else None

    def kernel_ns_by_owner(self, window: Interval) -> Dict[Optional[str], int]:
        """Compute-kernel time inside ``window`` by owner (None: launched
        outside every program span, or no launch found)."""
        by_owner: Dict[Optional[str], List[Interval]] = defaultdict(list)
        for s, e, _, launch in self.kernels:
            by_owner[self.owner(launch)].append((s, e))
        return {owner: covered(union(iv), *window) for owner, iv in by_owner.items()}

    def open_intervals(self, name: str, window: Interval) -> List[Interval]:
        """The union of the spans named ``name``, cut to ``window``."""
        a, b = window
        return union([(max(s, a), min(e, b)) for s, e, n, _ in self.spans if n == name and s < b and e > a])


def from_events(events: Iterable) -> Optional[ProgramTrace]:
    """The program trace of a profile's raw events (each with ``name``,
    ``start_ns``, ``duration_ns``, ``device_type``, ``start_thread_id`` and
    ``correlation_id``): the spans on the thread of the benchmark's window
    and the compute kernels that overlap the window. None where the trace
    holds no window or no program span."""
    window = None
    spans, kernels = [], []
    launches: Dict[int, Tuple[int, int]] = {}  # correlation id: (start, thread)
    for ev in events:
        name = ev.name()
        s = ev.start_ns()
        e = s + ev.duration_ns()
        kind = classify(name, ev.device_type() != DeviceType.CPU)
        if kind == "bench":
            if name == WINDOW_SPAN and window is None:
                window = (s, e, ev.start_thread_id())
        elif kind == "span":
            spans.append((s, e, name, ev.start_thread_id()))
        elif kind == "kernel":
            kernels.append((s, e, name, ev.correlation_id()))
        elif kind == "op" and name.startswith(LAUNCH_PREFIX):
            launches[ev.correlation_id()] = (s, ev.start_thread_id())
    if window is None:
        return None
    a, b, main = window
    nested, stack = [], []
    for s, e, name, _ in sorted((x for x in spans if x[3] == main), key=lambda x: (x[0], -x[1])):
        while stack and stack[-1] <= s:
            stack.pop()
        nested.append((s, e, name, len(stack)))
        stack.append(e)
    if not nested:
        return None
    owned = []
    for s, e, name, corr in kernels:
        if s < b and e > a:
            start, thread = launches.get(corr, (None, None))
            owned.append((s, e, name, start if thread == main else None))
    return ProgramTrace(spans=nested, kernels=owned)


def _profile_on_stack():
    """The ``torch.profiler.profile`` that a caller holds: the run's, a
    local of ``run._per_layer`` while it calls the readers."""
    from torch.profiler import profile

    frame = sys._getframe(1)
    while frame is not None:
        for value in frame.f_locals.values():
            if isinstance(value, profile):
                return value
        frame = frame.f_back
    return None


def program_trace(ctx) -> Optional[ProgramTrace]:
    """The reader context's program trace: ``ctx.program`` where set, else
    parsed from the run's profile and kept there for the next reader. The
    run hands the readers only ``trace.py``'s timeline, so the profile is
    found on the stack. None where the run has no program span (a program
    without spans). Raises where the timeline's host operators hold program
    spans but no profile, or none of its spans, was found: the run's
    profile has moved out of reach, and the readers would otherwise fall
    silent."""
    if not hasattr(ctx, "program"):
        prof = _profile_on_stack()
        ctx.program = None if prof is None else from_events(prof.profiler.kineto_results.events())
        if ctx.program is None:
            named = sorted({n for _, _, n in ctx.timeline.host_ops if n.startswith(PROGRAM_PREFIXES)})
            if named:
                raise RuntimeError(f"the timeline's host operators hold program spans ({', '.join(named[:4])}) but "
                                   f"{'no profile was found on the stack' if prof is None else 'its profile holds none'}")
    return ctx.program


def owned_ms_per_image(ctx, name: str) -> Optional[float]:
    """Device time of the window's compute kernels owned by span ``name``,
    per image, in ms; None where the program has no such span or the trace
    no kernel (a CPU run)."""
    p = program_trace(ctx)
    if p is None or name not in p.names or not p.kernels or not ctx.images:
        return None
    return p.kernel_ns_by_owner(ctx.timeline.window).get(name, 0) / ctx.images / 1e6
