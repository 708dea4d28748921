"""Request-batch size ladder for compiled tower/search programs.

Power-of-two bucketing compiled 7 text programs and a 7x4 mixed
(text-bucket, image-bucket) matrix per shortlist method; batch search
compiled per exact query count. The r5 serve load bench measured cold
windows stalling 8-17 s behind remote compiles of combos the warm-up
missed. A coarse {1,4,16,64} ladder bounds the program matrix (4 text,
4x4 mixed, 4 batch-search shapes); the extra pad rows cost ~ms of tower
time per window (pad rows are masked and sliced off by callers).
"""

from __future__ import annotations

BATCH_BUCKETS = (1, 4, 16, 64)


def batch_bucket(n: int) -> int:
    """Smallest ladder size >= n; beyond the ladder, multiples of the max."""
    for b in BATCH_BUCKETS:
        if n <= b:
            return b
    return -(-n // BATCH_BUCKETS[-1]) * BATCH_BUCKETS[-1]
