"""The log2 latency-bucket discipline (copy of ``N_BUCKETS``,
``bucket_index`` and ``percentile_ms_from`` from
``bifromq_tpu/obs/window.py``; its sliding windows are not ported).

Bucket i counts samples whose microsecond value has bit_length i (the
[2^(i-1), 2^i) range), topping out around 2 minutes; percentile
extraction returns the bucket's upper edge (conservative).
"""

from __future__ import annotations

N_BUCKETS = 28      # 2^27 µs ≈ 134 s


def bucket_index(seconds: float) -> int:
    us = int(seconds * 1e6)
    i = us.bit_length() if us > 0 else 0
    return i if i < N_BUCKETS else N_BUCKETS - 1


def percentile_ms_from(buckets, p: float) -> float:
    """Upper edge (ms) of the bucket containing the p-th percentile."""
    total = sum(buckets)
    if total == 0:
        return 0.0
    target = max(1, int(total * p / 100.0 + 0.5))
    acc = 0
    for i, c in enumerate(buckets):
        acc += c
        if acc >= target:
            return (1 << i) / 1000.0
    return (1 << (N_BUCKETS - 1)) / 1000.0
