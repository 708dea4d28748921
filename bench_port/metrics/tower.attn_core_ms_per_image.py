"""Device time of the compute kernels in the traced window that the program
launched inside its ``tower.attn.core`` span (the innermost span open at the
launch, ``bench_port/spans.py``), per image embedded, in ms: the attention
core's fp32 upcasts, logits GEMM, scale, key-mask add, softmax, cast back
and weighted sum, in every layer and the MAP head."""

from bench_port.spans import owned_ms_per_image


def read(ctx):
    return owned_ms_per_image(ctx, "tower.attn.core")
