"""Host-side hashing and partitioning in numpy (counterpart of the numpy
versions in cylon_tpu.native; the port builds no host library).

Placement computed here is bit-identical to the device's
``ops.hash.partition_targets``: varbytes keys hash their bytes exactly
as the device content hash h1 does (``np_varbytes_hash``), so a host
partition of string keys agrees with a device one.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

_NULL_TAG = np.uint32(0x9E3779B9)
# content-hash scheme 1 of data/strings.py
_VB_G1 = np.uint32(31)
_VB_S1 = np.uint32(0x2545F491)


def np_ordered_bits(x: np.ndarray) -> np.ndarray:
    """Order-preserving unsigned bits of a host array (ops/order.py's
    ordered bits, as numpy unsigned values)."""
    x = np.asarray(x)
    dt = x.dtype
    if dt == np.bool_:
        return x.astype(np.uint32)
    if dt.kind == "u":
        return x
    if dt.kind in ("M", "m"):
        x = x.view(np.int64)
        dt = x.dtype
    u = np.dtype(f"u{dt.itemsize}")
    if dt.kind == "i":
        return x.view(u) ^ np.array(1 << (8 * dt.itemsize - 1), u)
    if dt.kind == "f":
        xz = np.ascontiguousarray(np.where(x == 0, np.zeros((), dt), x))
        bits = xz.view(u)
        sign = (bits >> (8 * dt.itemsize - 1)).astype(bool)
        allones = np.array(~np.uint64(0) >> np.uint64(64 - 8 * dt.itemsize),
                           u)
        signbit = np.array(np.uint64(1) << np.uint64(8 * dt.itemsize - 1), u)
        return np.where(sign, ~bits & allones, bits ^ signbit)
    raise TypeError(f"unorderable dtype {dt}")


def _fmix32(h: np.ndarray) -> np.ndarray:
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x85EBCA6B)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(0xC2B2AE35)
    return h ^ (h >> np.uint32(16))


def _fmix64(h: np.ndarray) -> np.ndarray:
    h = h ^ (h >> np.uint64(33))
    h = h * np.uint64(0xFF51AFD7ED558CCD)
    h = h ^ (h >> np.uint64(33))
    h = h * np.uint64(0xC4CEB9FE1A85EC53)
    return h ^ (h >> np.uint64(33))


def np_varbytes_hash(values: Sequence) -> np.ndarray:
    """Per-row uint32 content hash of host str/bytes values: the numpy
    mirror of the device identity h1 (data/strings.py, scheme 1). None and
    NaN rows hash as empty; callers overlay the null tag."""
    enc: List[bytes] = []
    for v in values:
        if v is None or (isinstance(v, float) and v != v):
            enc.append(b"")
        elif isinstance(v, bytes):
            enc.append(v)
        else:
            enc.append(str(v).encode("utf-8"))
    n = len(enc)
    if n == 0:
        return np.zeros(0, np.uint32)
    lengths = np.fromiter((len(b) for b in enc), np.int64, n)
    nw = (lengths + 3) // 4
    starts = np.concatenate([[0], np.cumsum(nw)])
    total = int(starts[-1])
    buf = np.zeros(max(total, 1) * 4, np.uint8)
    if total:
        src = np.frombuffer(b"".join(enc), np.uint8)
        src_starts = np.concatenate([[0], np.cumsum(lengths)])[:-1]
        p = np.arange(int(lengths.sum())) - np.repeat(src_starts, lengths)
        buf[np.repeat(starts[:-1] * 4, lengths) + p] = src
    words = buf.view("<u4")
    with np.errstate(over="ignore"):  # uint32 wrap is the arithmetic
        h = words ^ _VB_S1
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(0x85EBCA6B)
        h = h ^ (h >> np.uint32(13))
        e = (np.arange(total, dtype=np.int64)
             - np.repeat(starts[:-1], nw)).astype(np.uint64)
        gp = np.ones(total, np.uint32)
        acc = np.full(1, _VB_G1)
        for b in range(max(int(nw.max()).bit_length(), 1)):
            gp = np.where((e >> np.uint64(b)) & np.uint64(1) == 1, gp * acc,
                          gp)
            acc = acc * acc
        P = np.cumsum(h[:total] * gp, dtype=np.uint32) if total \
            else np.zeros(0, np.uint32)
        end = np.clip(starts[1:] - 1, 0, max(total - 1, 0))
        prev = np.clip(starts[:-1] - 1, 0, max(total - 1, 0))
        hi = P[end] if total else np.zeros(n, np.uint32)
        lo = np.where(starts[:-1] > 0, P[prev] if total else np.uint32(0),
                      np.uint32(0))
        out = np.where(nw > 0, hi - lo, np.uint32(0)).astype(np.uint32)
        out = out ^ (lengths.astype(np.uint32) * np.uint32(0x9E3779B1)) \
            ^ _VB_S1
        out = out ^ (out >> np.uint32(16))
        out = out * np.uint32(0x7FEB352D)
        out = out ^ (out >> np.uint32(15))
        out = out * np.uint32(0x846CA68B)
        return out ^ (out >> np.uint32(16))


def row_hash(cols: Sequence[np.ndarray],
             valids: Sequence[Optional[np.ndarray]],
             is_string: Optional[Sequence[bool]] = None,
             prehashed: Optional[Sequence[bool]] = None) -> np.ndarray:
    """Combined per-row uint32 hash of host columns, the value
    ops/hash.hash_columns computes on the device. Dictionary strings pass
    their codes with ``is_string``; ``prehashed`` columns carry finalized
    uint32 row hashes (np_varbytes_hash) that enter the combine as they
    are."""
    n = len(cols[0])
    flags = is_string or [False] * len(cols)
    pre = prehashed or [False] * len(cols)
    h = np.zeros(n, np.uint32)
    with np.errstate(over="ignore"):
        for c, s, v, p in zip(cols, flags, valids, pre):
            if p:
                hc = np.asarray(c, dtype=np.uint32)
            else:
                bits = np.asarray(c).astype(np.uint32) if s \
                    else np_ordered_bits(c)
                if bits.dtype.itemsize == 8:
                    m = _fmix64(bits.view(np.uint64))
                    hc = (m ^ (m >> np.uint64(32))).astype(np.uint32)
                else:
                    hc = _fmix32(bits.astype(np.uint32))
            if v is not None:
                hc = np.where(np.asarray(v, dtype=bool), hc, _NULL_TAG)
            h = h * np.uint32(31) + hc
        return _fmix32(h)


def hash_partition(cols: Sequence[np.ndarray],
                   valids: Sequence[Optional[np.ndarray]],
                   world: int, is_string: Optional[Sequence[bool]] = None,
                   prehashed: Optional[Sequence[bool]] = None
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(targets int32 [n], counts int64 [world], order int64 [n]): the
    stable row permutation grouping rows by target, whose split at
    cumsum(counts) gives each target's rows."""
    h = row_hash(cols, valids, is_string, prehashed)
    targets = (h % np.uint32(world)).astype(np.int32)
    counts = np.bincount(targets, minlength=world).astype(np.int64)
    order = np.argsort(targets, kind="stable").astype(np.int64)
    return targets, counts, order
