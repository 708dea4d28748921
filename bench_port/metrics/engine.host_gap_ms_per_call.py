"""Device-idle time inside the benchmark's span around each call of the
engine's embedding entry, per call, in ms: the pageable host-to-device copy,
padding, the dispatch lead before the first kernel and the copy back."""


def read(ctx):
    t = ctx.timeline
    if not t.calls or not t.busy:
        return None
    idle = sum((e - s) - t.busy_ns(s, e) for s, e in t.calls)
    return idle / len(t.calls) / 1e6
