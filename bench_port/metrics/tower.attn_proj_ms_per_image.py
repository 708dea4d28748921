"""Device time of the compute kernels in the traced window that the program
launched inside its ``tower.attn`` span and outside the ``tower.attn.core``
span within it (``bench_port/spans.py``), per image embedded, in ms: the
q, k, v and output projections of every layer and the MAP head."""

from bench_port.spans import owned_ms_per_image


def read(ctx):
    return owned_ms_per_image(ctx, "tower.attn")
