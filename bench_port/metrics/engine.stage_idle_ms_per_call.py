"""Device-idle time while the program's ``engine.stage`` span is open (the
engine padding a batch and copying it to the card, ``bench_port/spans.py``),
per call of the window, in ms: the part of ``engine.host_gap_ms_per_call``
that the copy in takes."""

from bench_port.spans import program_trace


def read(ctx):
    t = ctx.timeline
    p = program_trace(ctx)
    if p is None or not t.calls or not t.busy:
        return None
    stage = p.open_intervals("engine.stage", t.window)
    if not stage:
        return None
    idle = sum((e - s) - t.busy_ns(s, e) for s, e in stage)
    return idle / len(t.calls) / 1e6
