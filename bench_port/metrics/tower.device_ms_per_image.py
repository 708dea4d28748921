"""Device time of the compute kernels (copies left out) in the traced
window, per image embedded, in ms: the vision tower's own cost."""

from bench_port.trace import union


def read(ctx):
    t = ctx.timeline
    if not t.kernels or not ctx.images:
        return None
    a, b = t.window
    kernel_ns = t.busy_ns(a, b, union([(s, e) for s, e, _ in t.kernels]))
    return kernel_ns / ctx.images / 1e6
