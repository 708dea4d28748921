"""Share of the traced window in which no kernel, copy or set runs on the
card (the union of device intervals), in %."""


def read(ctx):
    t = ctx.timeline
    if not t.busy:
        return None
    a, b = t.window
    return 100.0 * (1.0 - t.busy_ns(a, b) / (b - a))
