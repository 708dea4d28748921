"""Device time of the compute kernels in the traced window that the program
launched inside its ``tower.attn.rope`` span (``bench_port/spans.py``), per
image embedded, in ms: the rotary position on the patch rows of q and k in
every layer (kernel 12 on the card). None where the program has no such
span."""

from bench_port.spans import owned_ms_per_image


def read(ctx):
    return owned_ms_per_image(ctx, "tower.attn.rope")
