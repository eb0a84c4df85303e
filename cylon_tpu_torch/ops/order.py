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

from typing import List, Optional, Sequence, Tuple

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


def ordered_bits(col, descending: bool = False) -> torch.Tensor:
    """Column wrapper over `ordered_bits_raw`. Dictionary strings are
    their codes (the vocabulary is sorted, so codes are rank-preserving);
    a varbytes column has no single ordered-bits array."""
    if getattr(col, "is_varbytes", False):
        raise CylonError(Code.TypeError,
                         "varbytes columns need sort_prefix_keys/hash_keys, "
                         "not ordered_bits")
    if getattr(col, "dictionary", None) is not None:
        return ~col.data if descending else col.data
    return ordered_bits_raw(col.data, descending)


def ordered_bits_raw(x: torch.Tensor, descending: bool = False
                     ) -> torch.Tensor:
    """Map values to order-preserving unsigned bits:

    * unsigned ints: identity
    * signed ints: flip the sign bit
    * floats: IEEE total-order trick (flip all bits for negatives, the
      sign bit for positives); -0.0 is normalized to +0.0 first so
      equality matches IEEE semantics
    * bool: widen to uint8

    ``descending`` flips every bit, reversing the order. Nulls are not
    handled here: callers combine with the validity mask.
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
    return ~out if descending else out


def sort_keys(cols: Sequence, ascending: Optional[Sequence[bool]] = None,
              nulls_last: bool = True) -> List[torch.Tensor]:
    """Per-column ordered bits (``ascending[i]`` False: descending) with
    nulls pushed to the all-ones end, or to zero when not
    ``nulls_last``."""
    out = []
    for i, c in enumerate(cols):
        desc = ascending is not None and not ascending[i]
        k = ordered_bits(c, descending=desc)
        if c.validity is not None:
            extreme = all_ones(k.dtype) if nulls_last else 0
            k = torch.where(c.validity, k,
                            torch.full((), extreme, dtype=k.dtype,
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


def _packed_sort_keys(keys: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """int64 sort keys, primary first, whose lexicographic order is the
    unsigned order of ``keys``: consecutive keys of <= 4 bytes share one
    int64 while their widths sum to at most 63 bits (the order of the
    packed value is the order of the tuple), so a two-key sort such as
    (dead flag, int32 key) is one sort."""
    out: List[torch.Tensor] = []
    acc, width = None, 0
    for k in keys:
        w = 8 * k.element_size()
        if w > 32:
            if acc is not None:
                out.append(acc)
                acc, width = None, 0
            out.append(sortable(k))
            continue
        if acc is not None and width + w <= 63:
            acc = (acc << w) | unsigned(k)
            width += w
        else:
            if acc is not None:
                out.append(acc)
            acc, width = unsigned(k), w
    if acc is not None:
        out.append(acc)
    return out


def lexsort_indices(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable argsort along the last dimension by keys[0] (primary), then
    keys[1], ... — stable sorts of the packed keys from the least
    significant up, the torch form of one multi-operand ``lax.sort``."""
    perm = None
    for s in reversed(_packed_sort_keys(keys)):
        if perm is not None:
            s = s.gather(-1, perm)
        p = torch.sort(s, dim=-1, stable=True).indices
        perm = p if perm is None else perm.gather(-1, p)
    return perm


def cumsum_rows(x: torch.Tensor) -> torch.Tensor:
    """int64 cumsum along the last dimension of ``[n]`` or ``[W, n]``.
    A ``[W, n]`` tensor is scanned flat, as one long row, and each row's
    start taken off: torch's scan along the innermost dimension of a few
    long rows is slow on the card (30.7 ms for [4, 16,777,216] int64 on an
    H100, scripts/profile_port_groupby.py)."""
    x = x.to(torch.int64)
    if x.dim() == 1 or x.shape[0] == 1 or x.shape[-1] == 0:
        return torch.cumsum(x, -1)
    flat = torch.cumsum(x.reshape(-1), 0).view(x.shape)
    # row w's start is the total of rows < w: its last flat value less its
    # own sum
    return flat - (flat[:, -1:] - x.sum(-1, keepdim=True))


def row_neq_sorted(sorted_keys: Sequence[torch.Tensor],
                   sorted_valid: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Along the last dimension: row i differs from row i-1 on some key
    (or on ``sorted_valid``); row 0 is True."""
    k0 = sorted_keys[0]
    neq = torch.zeros(k0.shape, dtype=torch.bool, device=k0.device)
    if k0.shape[-1]:
        neq[..., 0] = True
    for k in list(sorted_keys) + ([] if sorted_valid is None
                                  else [sorted_valid]):
        neq[..., 1:] |= k[..., 1:] != k[..., :-1]
    return neq


def dense_ranks(keys: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gid, perm): gid[i] the 0-based rank of row i's key among the
    distinct keys (in key order), perm the stable lexsort permutation;
    along the last dimension."""
    perm = lexsort_indices(keys)
    neq = row_neq_sorted([k.gather(-1, perm) for k in keys])
    gid_sorted = cumsum_rows(neq) - 1
    gid = torch.empty_like(gid_sorted).scatter_(-1, perm, gid_sorted)
    return gid, perm


def dense_ranks_two(keys_l: Sequence[torch.Tensor],
                    keys_r: Sequence[torch.Tensor]):
    """Dense ranks over the union of two key sets along the last
    dimension: 1-D keys, or ``[W, n]`` keys ranked per shard (what
    ``shard_map`` gives the JAX package). Returns (gid_l, gid_r) on a
    shared id space, so cross-table equality is integer equality."""
    nl = keys_l[0].shape[-1]
    gid, _perm = dense_ranks([torch.cat([a, b], -1)
                              for a, b in zip(keys_l, keys_r)])
    return gid[..., :nl], gid[..., nl:]
