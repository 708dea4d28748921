"""Device time of the compute kernels in the traced window that the program
launched inside its ``tower.mlp`` span (``bench_port/spans.py``), per image
embedded, in ms: fc1, gelu and fc2 of every layer and the MAP head."""

from bench_port.spans import owned_ms_per_image


def read(ctx):
    return owned_ms_per_image(ctx, "tower.mlp")
