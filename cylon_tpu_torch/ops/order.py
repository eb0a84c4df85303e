"""Ordering primitives: order-preserving key bits and lexicographic
argsort (counterpart of cylon_tpu.ops.order).

Every comparable column maps to "ordered bits": an unsigned integer whose
natural order is the column's value order. torch has no unsigned
arithmetic or sort for 16/32/64-bit values on every device, so the port
carries those bits in a same-width container (``dtypes.bits_container``:
uint8, int16, int32, int64) and reads them as unsigned where it compares
them (``sortable``). Tests compare them with the JAX package's arrays
through ``numpy.view`` of the unsigned type of the same width.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from ..dtypes import bits_container
from ..status import Code, CylonError

_I64_MIN = -(1 << 63)


def _sign_bit(container: torch.dtype) -> int:
    """The sign-bit pattern of a container, as the container's value."""
    if container == torch.uint8:
        return 0x80
    return {torch.int16: -(1 << 15), torch.int32: -(1 << 31),
            torch.int64: _I64_MIN}[container]


def all_ones(container: torch.dtype) -> int:
    """The all-ones bit pattern (the unsigned maximum) of a container."""
    return 0xFF if container == torch.uint8 else -1


def ordered_bits(col) -> torch.Tensor:
    """Column wrapper over `ordered_bits_raw`."""
    return ordered_bits_raw(col.data)


def ordered_bits_raw(x: torch.Tensor) -> torch.Tensor:
    """Map values to order-preserving unsigned bits:

    * unsigned ints: identity
    * signed ints: flip the sign bit
    * floats: IEEE total-order trick (flip all bits for negatives, the
      sign bit for positives); -0.0 is normalized to +0.0 first so
      equality matches IEEE semantics
    * bool: widen to uint8

    Nulls are not handled here: callers combine with the validity mask.
    """
    dt = x.dtype
    if dt == torch.bool:
        out = x.to(torch.uint8)
    elif dt.is_floating_point:
        c = bits_container(dt)
        xz = torch.where(x == 0, torch.zeros((), dtype=dt, device=x.device),
                         x)
        bits = xz.view(c)
        out = torch.where(bits < 0, ~bits, bits ^ _sign_bit(c))
    elif dt in (torch.uint8, torch.uint16, torch.uint32, torch.uint64):
        out = x.view(bits_container(dt))
    elif dt in (torch.int8, torch.int16, torch.int32, torch.int64):
        c = bits_container(dt)
        out = x.view(c) ^ _sign_bit(c)
    else:
        raise CylonError(Code.TypeError, f"unorderable dtype {dt}")
    return out


def sort_keys(cols: Sequence) -> List[torch.Tensor]:
    """Per-column ordered bits with nulls pushed to the all-ones end."""
    out = []
    for c in cols:
        k = ordered_bits(c)
        if c.validity is not None:
            k = torch.where(c.validity, k,
                            torch.full((), all_ones(k.dtype), dtype=k.dtype,
                                       device=k.device))
        out.append(k)
    return out


def sortable(bits: torch.Tensor) -> torch.Tensor:
    """int64 whose signed order is the unsigned order of ``bits``."""
    if bits.element_size() == 8:
        return bits.to(torch.int64) ^ _I64_MIN
    return unsigned(bits)


def unsigned(bits: torch.Tensor) -> torch.Tensor:
    """The unsigned value of <= 4-byte bits, as int64."""
    w = bits.element_size()
    if w > 4:
        raise TypeError("8-byte bits have no int64 unsigned value")
    return bits.to(torch.int64) & ((1 << (8 * w)) - 1)


def lexsort_indices(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable argsort along the last dimension by keys[0] (primary), then
    keys[1], ... — stable sorts from the least significant key up, the
    torch form of one multi-operand ``lax.sort``."""
    perm = None
    for k in reversed(keys):
        s = sortable(k)
        if perm is not None:
            s = s.gather(-1, perm)
        p = torch.sort(s, dim=-1, stable=True).indices
        perm = p if perm is None else perm.gather(-1, p)
    return perm


def dense_ranks_two(keys_l: Sequence[torch.Tensor],
                    keys_r: Sequence[torch.Tensor]):
    """Dense ranks over the union of two key sets along the last
    dimension: 1-D keys, or ``[W, n]`` keys ranked per shard (what
    ``shard_map`` gives the JAX package). Returns (gid_l, gid_r) on a
    shared id space, so cross-table equality is integer equality."""
    nl = keys_l[0].shape[-1]
    cat = [torch.cat([a, b], -1) for a, b in zip(keys_l, keys_r)]
    perm = lexsort_indices(cat)
    neq = torch.zeros(perm.shape, dtype=torch.bool, device=perm.device)
    if perm.shape[-1]:
        neq[..., 0] = True
    for k in cat:
        ks = k.gather(-1, perm)
        neq[..., 1:] |= ks[..., 1:] != ks[..., :-1]
    gid_sorted = torch.cumsum(neq.to(torch.int64), -1) - 1
    gid = torch.empty_like(gid_sorted).scatter_(-1, perm, gid_sorted)
    return gid[..., :nl], gid[..., nl:]
