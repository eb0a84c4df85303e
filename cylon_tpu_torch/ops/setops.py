"""Set operations (distinct union / subtract / intersect) on full-row keys
(counterpart of cylon_tpu.ops.setops).

Reference: cpp/src/cylon/table.cpp:39-942, a hash set of (table, row)
pairs under a row comparator. Two routes, as in the JAX package:

* dense ranks: both tables' rows map to shared integer ids (one sort of
  the concatenated ordered bits), membership is ``torch.isin`` on the ids
  and dedup a first-occurrence mask. The output rows are the emitted
  rows in table order. Every function of this route takes ``[W, n]``
  batches, one row per shard (W = 1 on the local path);
* the stream route: one sort of the rows by a 2x32-bit full-row hash,
  the row payload riding along as 32-bit lanes, then kernel K5
  (``setop_stream``, whose compaction is kernel K6 ``stream_compact``).
  The tag, the lanes and the hash come from the columns in one pass of
  kernel K9 (``setop_hash_rows``).
  The lanes double as hash-verify lanes: a collision sends the op back to
  the dense-ranks route, so the result is exact.

Set semantics match the reference: results are DISTINCT rows; null
components compare equal to each other (validity is part of the key).
"""
from __future__ import annotations

import enum
from typing import Optional, Sequence

import torch

from ..util import capacity as _capacity
from ..util import pow2
from . import hash as _hash
from . import kernels as _k
from .join import _SIGN64, _masked_indices, stream_block_rows


class SetOp(enum.IntEnum):
    UNION = 0
    SUBTRACT = 1
    INTERSECT = 2


_COUNT_KEYS = {SetOp.UNION: "n_union", SetOp.SUBTRACT: "n_subtract",
               SetOp.INTERSECT: "n_intersect"}

# ---------------------------------------------------------------------------
# dense-ranks route
# ---------------------------------------------------------------------------


def _first_occurrence(g: torch.Tensor) -> torch.Tensor:
    """[W, n] bool: True at the first row (in table order) of each
    distinct id of its shard."""
    w, n = g.shape
    if n == 0:
        return torch.zeros(w, 0, dtype=torch.bool, device=g.device)
    perm = torch.sort(g, dim=1, stable=True).indices
    gs = g.gather(1, perm)
    neq = torch.ones(w, n, dtype=torch.bool, device=g.device)
    neq[:, 1:] = gs[:, 1:] != gs[:, :-1]
    return torch.zeros_like(neq).scatter_(1, perm, neq)


def _isin(g: torch.Tensor, other: torch.Tensor) -> torch.Tensor:
    """[W, na] bool: membership of each id of ``g`` among its shard's ids
    in ``other``. Ids lie in [-2, na + nb); the callers give non-emitted
    rows side-distinct negative sentinels, so those never match."""
    w, na = g.shape
    nb = other.shape[1]
    if na == 0 or nb == 0:
        return torch.zeros(w, na, dtype=torch.bool, device=g.device)
    # shift every shard into its own id range: one isin covers all shards
    off = torch.arange(w, device=g.device).unsqueeze(1) * (na + nb + 2) + 2
    return torch.isin((g + off).reshape(-1),
                      (other + off).reshape(-1)).view(w, na)


def _masks(gl, gr, lemit, remit):
    gl_eff = torch.where(lemit, gl, -1)
    gr_eff = torch.where(remit, gr, -2)
    return gl_eff, gr_eff, _first_occurrence(gl_eff) & lemit


def setop_counts(gl, gr, lemit, remit) -> dict:
    """Per-shard counts of all three ops: dict of int64 [W] tensors
    n_union, n_subtract, n_intersect. ``gl``/``gr`` are [W, n] dense row
    ids on a shared space (full-row keys)."""
    gl_eff, gr_eff, first_l = _masks(gl, gr, lemit, remit)
    in_r = _isin(gl_eff, gr_eff)
    first_r = _first_occurrence(gr_eff) & remit
    in_l = _isin(gr_eff, gl_eff)
    # union: distinct(left) + the distinct right rows unseen in left
    return {"n_union": first_l.sum(1) + (first_r & ~in_l).sum(1),
            "n_subtract": (first_l & ~in_r).sum(1),
            "n_intersect": (first_l & in_r).sum(1)}


def setop_indices(gl, gr, lemit, remit, op: SetOp, out_size: int
                  ) -> torch.Tensor:
    """Per shard, the result's row indices, padded with -1 to
    ``out_size`` (int32 [W, out_size]). Indices address the concatenated
    [left; right] rows: i < nl is left row i, i >= nl right row i - nl
    (only UNION emits those)."""
    gl_eff, gr_eff, first_l = _masks(gl, gr, lemit, remit)
    if op == SetOp.UNION:
        first_r = _first_occurrence(gr_eff) & remit
        mask = torch.cat([first_l, first_r & ~_isin(gr_eff, gl_eff)], 1)
    else:
        in_r = _isin(gl_eff, gr_eff)
        keep = first_l & ~in_r if op == SetOp.SUBTRACT else first_l & in_r
        mask = torch.cat([keep, torch.zeros_like(remit)], 1)
    return _masked_indices(mask, out_size)


def setop_rows(gl, gr, lemit, remit, op: SetOp) -> torch.Tensor:
    """The local route over 1-D ids: count, materialize at pow2 capacity,
    slice. Returns the result's int32 row indices."""
    args = (gl[None], gr[None], lemit[None], remit[None])
    total = int(setop_counts(*args)[_COUNT_KEYS[SetOp(op)]][0])
    return setop_indices(*args, op, pow2(total))[0, :total]


# ---------------------------------------------------------------------------
# stream route: ONE sort on a 2x32-bit full-row hash + kernel K5
# ---------------------------------------------------------------------------

# None = auto (the kernel route on CUDA, dense ranks on the CPU); False
# disables the stream route; True forces it, also on the CPU, where K5 and
# K6 run their plain versions
STREAM_SETOP: Optional[bool] = None

# lane budget of the stream route (the TPU sort took 3 keys + the lanes;
# K9 takes as many)
MAX_SETOP_LANES = _k.MAX_SETOP_LANES


def setop_lane_descs(lcols, rcols):
    """Static lane plan over ALIGNED column pairs, or None when the
    columns do not fit the lane budget. Per column: (kind, has_validity)
    with kind "d" (4-byte bit-exact; dictionary strings as their codes),
    "n" (1/2-byte widened), "b" (bool), "w" (8-byte split hi/lo).
    Varbytes content has no fixed lanes: such schemas take dense ranks."""
    descs = []
    total = 0
    for a, b in zip(lcols, rcols):
        has_v = a.validity is not None or b.validity is not None
        if a.is_varbytes or b.is_varbytes:
            return None
        if a.is_string:
            kind, slots = "d", 1
        elif a.data.dtype == torch.bool:
            kind, slots = "b", 1
        elif a.data.dim() != 1:
            return None
        else:
            size = a.data.element_size()
            if size == 4:
                kind, slots = "d", 1
            elif size == 8:
                kind, slots = "w", 2
            elif size in (1, 2):
                kind, slots = "n", 1
            else:
                return None
        total += slots + (1 if has_v else 0)
        if total > MAX_SETOP_LANES:
            return None
        descs.append((kind, has_v))
    return tuple(descs)


def setop_stream_applicable(n_total: int, descs,
                            device: torch.device) -> bool:
    if STREAM_SETOP is False or descs is None:
        return False
    if n_total == 0 or n_total >= (1 << 29):
        return False
    if STREAM_SETOP:
        return True
    return device.type == "cuda"


def stream_out_len(nl: int, nr: int) -> int:
    """The TPU kernel's output stream length, ``(rows_for(n) + BR + 8) *
    128``: the result's capacity is clamped to it, so the port's results
    keep the JAX package's capacities."""
    rows = max(-(-(nl + nr) // 128), 1)
    return (rows + stream_block_rows(nl, nr) + 8) * 128


def setop_stream_hash(descs, lcols, rcols, lemit: Optional[torch.Tensor],
                      remit: Optional[torch.Tensor]):
    """The hash stage of the stream route over the aligned column pairs
    (K9 ``kernels.setop_hash_rows``, one shard): the int32 [1 + L, 1, n]
    stack of the tag (row 0) and the canonical lanes, and the row hash.
    Returns (h1, h2, streams, side, live): h1/h2 int64 values in [0,
    2^32), side and live bool [1, n]. ``lemit``/``remit``: the tables' row
    masks, or None where every row is live."""
    def side(cols, emit):
        return ([c.data[None] for c in cols],
                [None if c.validity is None else c.validity[None]
                 for c in cols],
                None if emit is None else emit[None])

    return _k.setop_hash_rows(*side(lcols, lemit), *side(rcols, remit),
                              descs)


def setop_stream_sort(h1, h2, streams, side, live):
    """The sort stage of the stream route: K5's (h1_s, h2_s, streams_s),
    the stream in (h1, h2, tag) order, the stack in one piece so that K5
    hands it to its compaction as it is. On the card the rows move as
    records (``record_setop_stream_sort``, K10); elsewhere
    ``plain_setop_stream_sort``, which gives the same tensors."""
    if not h1.is_cuda:
        return plain_setop_stream_sort(h1, h2, streams, side, live)
    return record_setop_stream_sort(h1, h2, streams, side, live)


def record_setop_stream_sort(h1, h2, streams, side, live):
    """``setop_stream_sort`` with the rows as records of 32-bit words (K10
    ``kernels.permute_rows``): h1, h2 and the stack packed in the first
    sort's order with the second sort's key, then moved by the second
    sort's permutation and split. The sorts are
    ``plain_setop_stream_sort``'s, so the order is the same."""
    rows, key = _k.permute_rows([h1, h2, *streams], _side_live_order(
        side, live), key=2)
    perm = torch.sort(key, dim=1, stable=True).indices
    del key
    s, _ = _k.permute_rows(rows, perm, 2 + len(streams), split=True)
    return s[0], s[1], s[2:]


def _side_live_order(side, live):
    # tag order is (side, live, iota) order, a stable sort by side * 2 +
    # live
    return torch.sort((side.to(torch.uint8) << 1) | live.to(torch.uint8),
                      dim=1, stable=True).indices


def plain_setop_stream_sort(h1, h2, streams, side, live):
    """``setop_stream_sort`` by torch gathers: the packed key gathered by
    the first sort's permutation, then h1, h2 and the stack by the
    composed one."""
    perm = _side_live_order(side, live)
    # then a stable sort by the packed hash pair
    key = (((h1 << 32) | h2) ^ _SIGN64).gather(1, perm)
    perm = perm.gather(1, torch.sort(key, dim=1, stable=True).indices)
    return (_hash.as_i32(h1.gather(1, perm)),
            _hash.as_i32(h2.gather(1, perm)),
            streams.gather(2, perm.unsqueeze(0).expand_as(streams)))


def setop_stream_inputs(lane_l: Sequence[torch.Tensor],
                        lane_r: Sequence[torch.Tensor],
                        lemit: torch.Tensor, remit: torch.Tensor):
    """The tag, the row hash and the sort of the stream route from the
    sides' lanes (the JAX package's program's inputs): K5's (h1_s, h2_s,
    streams_s), where streams_s is the int32 [1 + L, W, n] stack of the
    tag (row 0) and the lanes."""
    return setop_stream_sort(*_k.setop_stack_hash(lane_l, lane_r, lemit,
                                                  remit))


def _setop_stream_program(lane_l, lane_r, lemit, remit, op: SetOp,
                          out_len: int):
    """``setop_stream_inputs`` then K5: returns K5's (counts, streams)."""
    return _k.setop_stream(*setop_stream_inputs(lane_l, lane_r, lemit,
                                                remit), int(op), out_len)


def setop_stream_columns(descs, lcols, streams, n_out: int, out_len: int):
    """The result's columns from K5's compacted streams: (columns, emit
    mask) at ``capacity(n_out)`` rows, clamped to ``out_len``."""
    from ..data.column import Column

    # capacity() rounds n_out up by up to ~6%, which can pass the stream
    # length when n_out is close to n: clamp (it is always >= n_out)
    cap = min(_capacity(n_out), out_len)
    flat = [s[0, :cap] for s in streams[1:]]  # drop the idx stream
    emit = torch.arange(cap, device=streams.device) < n_out
    cols = []
    k = 0
    for (kind, has_v), a in zip(descs, lcols):
        dt = a.data.dtype
        if kind == "w":
            u = (flat[k].to(torch.int64) << 32) \
                | (flat[k + 1].to(torch.int64) & _hash.M32)
            data = u.view(dt)
            k += 2
        elif kind == "b":
            data = flat[k] != 0
            k += 1
        elif kind == "n":
            narrow = torch.int16 if a.data.element_size() == 2 \
                else torch.int8
            data = flat[k].to(narrow).view(dt)
            k += 1
        else:
            data = flat[k].view(dt)
            k += 1
        validity = None
        if has_v:
            validity = (flat[k] != 0) & emit
            k += 1
        cols.append(Column(data, a.dtype, validity, a.name,
                           dictionary=a.dictionary))
    return cols, emit
