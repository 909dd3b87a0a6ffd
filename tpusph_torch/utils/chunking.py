"""Static chunk-size selection for the blocked tile passes. Counterpart of
`tpusph/utils/chunking.py`."""

from __future__ import annotations


def pick_chunk(n: int, target: int) -> int:
    """Largest divisor of n that is ≤ target (≥ 1)."""
    if n <= target:
        return n
    best = 1
    d = 1
    while d * d <= n:
        if n % d == 0:
            if d <= target:
                best = max(best, d)
            q = n // d
            if q <= target:
                best = max(best, q)
        d += 1
    return best
