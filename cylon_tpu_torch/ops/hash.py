"""Row hashing for partitioning — vectorized murmur-style finalizers
(counterpart of cylon_tpu.ops.hash, bit-identical to it).

Reference: cpp/src/cylon/arrow/arrow_partition_kernels.hpp:29-226. torch
has no ``+``, ``>>`` or ``%`` for uint32/uint64 on the CPU, so 32-bit
hashes are computed in int64 holding values in [0, 2^32) and masked after
every multiply, and 64-bit ones as wrapping int64 multiplies with masked
logical shifts. Hash streams leave this module as int32 tensors carrying
the uint32 bits (``as_i32``).
"""
from __future__ import annotations

from typing import Sequence

import torch

from .order import ordered_bits, unsigned

M32 = 0xFFFFFFFF
NULL_TAG = 0x9E3779B9


def _s64(c: int) -> int:
    """A 64-bit constant as the int64 with the same bits."""
    return c - (1 << 64) if c >= (1 << 63) else c


_C64_1 = _s64(0xFF51AFD7ED558CCD)
_C64_2 = _s64(0xC4CEB9FE1A85EC53)


def u32(x: torch.Tensor) -> torch.Tensor:
    """uint32 bits (int32, or any <= 4-byte container) -> int64 value."""
    if x.dtype == torch.int64:
        return x & M32
    return unsigned(x)


def as_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 value in [0, 2^32) (or any int64, wrapped) -> int32 bits."""
    x = x & M32
    return (x - ((x & 0x80000000) << 1)).to(torch.int32)


def _lsr64(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bits."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 32-bit finalizer on int64 values in [0, 2^32)."""
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & M32
    return h ^ (h >> 16)


def fmix32b(h: torch.Tensor) -> torch.Tensor:
    """The second, independent 32-bit avalanche ("lowbias32")."""
    h = h ^ (h >> 16)
    h = (h * 0x7FEB352D) & M32
    h = h ^ (h >> 15)
    h = (h * 0x846CA68B) & M32
    return h ^ (h >> 16)


def fmix64(h: torch.Tensor) -> torch.Tensor:
    """murmur3/splitmix 64-bit finalizer on int64 bits (wrapping)."""
    h = h ^ _lsr64(h, 33)
    h = h * _C64_1
    h = h ^ _lsr64(h, 33)
    h = h * _C64_2
    return h ^ _lsr64(h, 33)


def hash_column(col) -> torch.Tensor:
    """Per-row uint32 hash of one column, as int32 bits. Equal values hash
    equal (floats use the -0.0-normalized ordered bits, dictionary
    strings their codes); nulls hash to a fixed tag. Varbytes strings hash
    their whole byte content (the content hash h1)."""
    if getattr(col, "is_varbytes", False):
        h1 = col.varbytes.raw_hashes()[0]
        if col.validity is not None:
            h1 = torch.where(col.validity, h1, NULL_TAG - (1 << 32))
        return h1
    bits = ordered_bits(col)
    if bits.element_size() == 8:
        h = fmix64(bits.to(torch.int64))
        h32 = (h ^ _lsr64(h, 32)) & M32
    else:
        h32 = fmix32(unsigned(bits))
    if col.validity is not None:
        h32 = torch.where(col.validity, h32, NULL_TAG)
    return as_i32(h32)


def combine_hashes(hs: Sequence[torch.Tensor]) -> torch.Tensor:
    """fmix32 of the reference's ``31*h + h_col`` combine, starting from
    the first column's hash (parallel/dist_ops._targets_from_hashes)."""
    h = None
    for hc in hs:
        h = u32(hc) if h is None else (h * 31 + u32(hc)) & M32
    return fmix32(h)


def hash_columns(cols: Sequence) -> torch.Tensor:
    """Combined row hash over several columns (reference combine scheme,
    arrow_partition_kernels.cpp:90-99), as int32 bits."""
    h = torch.zeros(len(cols[0]), dtype=torch.int64,
                    device=cols[0].data.device)
    for c in cols:
        h = (h * 31 + u32(hash_column(c))) & M32
    return as_i32(fmix32(h))


def hash2_streams(lanes: Sequence[torch.Tensor], live: torch.Tensor):
    """The 2x32-bit row-hash pair of the hash-sorted stream path: combine
    u32 lanes with the 31/33 schemes over independent avalanches, dead
    rows forced to all-ones. Returns int64 values in [0, 2^32)."""
    h1 = torch.zeros(lanes[0].shape, dtype=torch.int64,
                     device=lanes[0].device)
    h2 = torch.full(lanes[0].shape, NULL_TAG, dtype=torch.int64,
                    device=lanes[0].device)
    for kl in lanes:
        v = u32(kl)
        h1 = (h1 * 31 + fmix32(v)) & M32
        h2 = (h2 * 33 + fmix32b(v)) & M32
    h1 = torch.where(live, fmix32(h1), M32)
    h2 = torch.where(live, fmix32b(h2), M32)
    return h1, h2


def partition_targets(cols: Sequence, world_size: int) -> torch.Tensor:
    """Per-row target partition in [0, world_size) (reference
    HashPartitionArray modulo placement)."""
    return (u32(hash_columns(cols)) % world_size).to(torch.int32)
