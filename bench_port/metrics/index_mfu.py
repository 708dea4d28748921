"""The tower's operations over the traced window (the benchmark's own count
at the published widths, real tokens only: ``bench_port/flops.py``) as a
share of the card's dense bf16 peak (``bench_port/peaks.json``), in %."""


def read(ctx):
    if not ctx.flops or not ctx.peak_flops or not ctx.timeline.busy:
        return None
    return 100.0 * ctx.flops / (ctx.peak_flops * ctx.timeline.window_s)
