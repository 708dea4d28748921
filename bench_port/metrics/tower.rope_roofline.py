"""The rotary position (kernel 12, owned by the program's ``tower.attn.rope``
span) as a share of its byte bound, in %: the rotation's bytes an image
(``bench_port/flops_dinov3.py``'s ``rope_bytes``: per layer, the patch rows
of q and k read and written once in bf16, at the widths and served size of
the DINOv3 configuration's file) over its owned device time an image,
against the ``hbm_bytes_per_s`` of the card the run measured (its entry in
``bench_port/peaks.json``, found by the bf16 peak that the run's context
carries). None where the span is absent or the card has no entry there."""

import json

from bench_port.flops_dinov3 import dinov3_shape, rope_bytes
from bench_port.spans import owned_ms_per_image
from bench_port.spec import PKG

CONFIG = PKG / "configs" / "dinov3-vit7b16-pretrain-lvd1689m.json"


def read(ctx):
    ms = owned_ms_per_image(ctx, "tower.attn.rope")
    if not ms or not ctx.peak_flops:
        return None
    cards = [v for v in json.loads((PKG / "peaks.json").read_text()).values() if isinstance(v, dict)]
    peak = next((c.get("hbm_bytes_per_s") for c in cards if c.get("bf16_flops_per_s") == ctx.peak_flops), None)
    if not peak:
        return None
    return 100.0 * rope_bytes(dinov3_shape(json.loads(CONFIG.read_text()))) / (ms / 1e3) / peak
