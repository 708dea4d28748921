"""Device time of the compute kernels in the traced window that the program
launched inside its ``tower.mlp.gate`` span (``bench_port/spans.py``), per
image embedded, in ms: SwiGLU's gate, ``silu(a) * b``, in every layer
(kernel 11 on the card). None where the program has no such span."""

from bench_port.spans import owned_ms_per_image


def read(ctx):
    return owned_ms_per_image(ctx, "tower.mlp.gate")
