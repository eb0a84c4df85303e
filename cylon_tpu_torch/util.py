"""Small shared helpers: the capacity-rounding policies (cylon_tpu.util
plus cylon_tpu.benchutils.bucket_cap)."""
from __future__ import annotations

# bucket_cap's small-value floor: every capacity below it shares one
# bucket, so output shapes match the JAX package's at every size
BUCKET_FLOOR = 512


def pow2(n: int) -> int:
    """Round up to a power of two (>= 1)."""
    return 1 if n <= 1 else 1 << (int(n) - 1).bit_length()


def pow2_floor(n: int) -> int:
    """Round down to a power of two (>= 1)."""
    return 1 << (max(int(n), 1).bit_length() - 1)


def capacity(n: int) -> int:
    """Static-capacity rounding with a 4-bit mantissa: the smallest
    s * 2^e >= n with s in [17, 32] (overshoot <= 6.25%)."""
    n = max(int(n), 1)
    if n <= 16:
        return pow2(n)
    e = max((n - 1).bit_length() - 5, 0)
    s = -(-n // (1 << e))
    return s << e


def bucket_cap(n: int, floor: int = BUCKET_FLOOR) -> int:
    """Next power of two with a small-value floor: the capacity policy of
    the distributed and stream join materializations."""
    return max(pow2(max(int(n), 1)), int(floor))
