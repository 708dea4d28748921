"""SwiGLU's gate (kernel 11, owned by the program's ``tower.mlp.gate`` span)
as a share of its byte bound, in %: the gate's bytes an image
(``bench_port/flops_dinov2.py``'s ``gate_bytes``: per layer and token, the
2H bf16 values read and the H written, at the widths of the DINOv2
configuration's file) over its owned device time an image, against the
``hbm_bytes_per_s`` of the card the run measured (its entry in
``bench_port/peaks.json``, found by the bf16 peak that the run's context
carries). None where the span is absent or the card has no entry there."""

import json

from bench_port.flops_dinov2 import dinov2_shape, gate_bytes
from bench_port.spans import owned_ms_per_image
from bench_port.spec import PKG

CONFIG = PKG / "configs" / "dinov2-with-registers-giant.json"


def read(ctx):
    ms = owned_ms_per_image(ctx, "tower.mlp.gate")
    if not ms or not ctx.peak_flops:
        return None
    cards = [v for v in json.loads((PKG / "peaks.json").read_text()).values() if isinstance(v, dict)]
    peak = next((c.get("hbm_bytes_per_s") for c in cards if c.get("bf16_flops_per_s") == ctx.peak_flops), None)
    if not peak:
        return None
    return 100.0 * gate_bytes(dinov2_shape(json.loads(CONFIG.read_text()))) / (ms / 1e3) / peak
