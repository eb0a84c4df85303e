"""The shuffle: hash-partition + the counted padded all-to-all
(counterpart of the padded route of cylon_tpu.parallel.shuffle).

A two-phase exchange, as in the JAX package:

  phase 1 ("header"): the per-(src, dst) send-count matrix, fetched to
     the host (``count_pair``);
  phase 2 ("body"): each shard partitions its rows stably by target
     (kernels K1 + K2 on the kernel route, a stable sort otherwise), and
     every (src, dst) pair moves ONE ``block``-row slice into the static
     slot ``dst_out[src*block : (src+1)*block]``. The block is the pow2 of
     the largest pair; the output is padded per source, capacity
     ``world * block``, live rows marked by the emit mask.

Rows whose emit mask is False are dropped in transit. When padding would
cost more than PADDED_WASTE_FACTOR over the compact layout (a skewed
count matrix), the JAX package takes its blockwise route
(``_exchange_fn``); that route is not ported yet and the exchange raises.
The JAX package's chunked pipeline is bit-identical to its single-shot
program by contract, so the port runs the single-shot program.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..context import CylonContext
from ..dtypes import movable
from ..ops import kernels as _k
from ..status import not_ported
from ..util import pow2 as _pow2
from . import comm

# upper bound on the per-pair block (rows per (src, dst) pair)
MAX_BLOCK = 1 << 22

# padded-mode acceptance: worst-case capacity blowup over the compact
# layout before the blockwise (skew) route takes over
PADDED_WASTE_FACTOR = 2

# None = auto (K1 + K2 on CUDA, the stable sort elsewhere); False forces
# the stable sort; True forces the kernel wrappers, which run their plain
# versions on the CPU. The TPU route's world <= 16 cap does not carry
# over: the Hopper scatter reads its input once whatever the world, so
# every world whose world + 1 buckets fit the kernel (world <= 255) takes
# the kernel route; a larger world raises on the card unless this is
# False.
PARTITION_KERNEL: Optional[bool] = None


def _target_counts(t: torch.Tensor, world: int) -> torch.Tensor:
    """counts[s, w] = #rows of shard s with target w (ids == world are
    dead and not counted), int32 [W, world]."""
    counts = torch.zeros(t.shape[0], world + 1, dtype=torch.int64,
                         device=t.device)
    counts.scatter_add_(1, t.to(torch.int64).clamp(0, world),
                        torch.ones_like(t, dtype=torch.int64))
    return counts[:, :world].to(torch.int32)


def _dead_keyed(targets: torch.Tensor, emit: torch.Tensor,
                world: int) -> torch.Tensor:
    return torch.where(emit, targets.to(torch.int32), world).contiguous()


def _bucket_sort(payload: Dict[str, torch.Tensor], targets, emit,
                 world: int):
    """Stable partition of [W, n] leaves by target, dead rows (emit
    False) keyed ``world`` to the tail. Returns (sorted leaves,
    counts_out int32 [W, world], start int64 [W, world])."""
    t = _dead_keyed(targets, emit, world)
    perm = torch.sort(t, dim=1, stable=True).indices
    out = {k: movable(x).gather(1, perm).view(x.dtype)
           for k, x in payload.items()}
    counts_out = _target_counts(t, world)
    c = counts_out.to(torch.int64)
    return out, counts_out, torch.cumsum(c, 1) - c


def _leg_split(x: torch.Tensor):
    """One [W, n] leaf -> (int32 [W, n] legs, join(legs) -> leaf): the
    partition kernel moves 32-bit words; 8-byte values ride as two
    words, narrower ones widen value-exactly. Round trips are
    bit-exact."""
    dt = x.dtype
    size = x.element_size()
    if size == 4:
        return [x.view(torch.int32)], lambda ls: ls[0].view(dt)
    if size == 8:
        pair = x.view(torch.int32).view(*x.shape, 2)
        return ([pair[..., 0].contiguous(), pair[..., 1].contiguous()],
                lambda ls: torch.stack(ls, -1).view(torch.int64).view(
                    *ls[0].shape).view(dt))
    if dt == torch.bool:
        return [x.to(torch.int32)], lambda ls: ls[0] != 0
    if size == 2:
        return ([x.view(torch.int16).to(torch.int32) & 0xFFFF],
                lambda ls: ls[0].to(torch.int16).view(dt))
    return ([x.view(torch.uint8).to(torch.int32)],
            lambda ls: ls[0].to(torch.uint8).view(dt))


def _kernel_partition(payload, targets, emit, world: int):
    """The kernel twin of `_bucket_sort`: identical contract, via one
    histogram pass (K1), its sum over tiles, and one counting-scatter pass
    (K2) that reads the payload's legs in place."""
    t = _dead_keyed(targets, emit, world)
    splits = {k: _leg_split(x.contiguous()) for k, x in payload.items()}
    hist = _k.partition_hist(t, world + 1)
    counts_out = hist[:, :, :world].sum(1, dtype=torch.int32)
    c = counts_out.to(torch.int64)
    outs = _k.partition_scatter(
        t, [leg for ls, _ in splits.values() for leg in ls], world + 1,
        counts_out)
    out, i = {}, 0
    for k, (ls, join) in splits.items():
        out[k] = join(list(outs[i:i + len(ls)]))
        i += len(ls)
    return out, counts_out, torch.cumsum(c, 1) - c


def use_partition_kernel(world: int, device: torch.device) -> bool:
    """The partition route of a world >= 2 exchange. On the card a world
    whose world + 1 buckets exceed the kernels' limit raises: the sort
    route is taken only when the caller asks for it."""
    if PARTITION_KERNEL is False:
        return False
    if device.type == "cuda" and world + 1 > _k.MAX_BUCKETS:
        raise not_ported(f"a partition of {world + 1} buckets on the card "
                         f"(K1/K2 take at most {_k.MAX_BUCKETS})")
    return PARTITION_KERNEL is True or device.type == "cuda"


def _padded_body_w1(block: int, payload, targets, emit):
    """One-shard padded body: the all-to-all is the identity; the only
    work is pushing dead rows to the tail (skipped when all rows live)."""
    n = targets.shape[1]
    if bool(emit.all()):
        out = payload
        counts_in = torch.full((1, 1), n, dtype=torch.int32,
                               device=targets.device)
    else:
        out, counts_in, _start = _bucket_sort(payload, targets, emit, 1)

    def pad(x):
        if block <= x.shape[1]:
            return x[:, :block]
        z = torch.zeros(1, block - x.shape[1], dtype=x.dtype,
                        device=x.device)
        return torch.cat([x, z], 1)

    pos = torch.arange(block, device=targets.device)
    return ({k: pad(x) for k, x in out.items()},
            (pos < counts_in[:, :1]), counts_in)


def _send_block(xs: torch.Tensor, start: torch.Tensor, block: int,
                world: int) -> torch.Tensor:
    """[W_src, W_dst, block] send stack: ONE contiguous slice per target
    (rows are target-sorted). ``xs`` is padded by ``block`` rows here, so
    slices stay in range; over-read rows belong to other targets and are
    dead on the receiving side."""
    pad = torch.zeros(world, block, dtype=xs.dtype, device=xs.device)
    xp = torch.cat([xs, pad], 1)
    rows = (start.unsqueeze(-1)
            + torch.arange(block, device=xs.device)).view(world, -1)
    return movable(xp).gather(1, rows).view(xp.dtype).view(
        world, world, block)


def _padded_partition(world: int, block: int, payload, targets, emit):
    """The partition prefix of the padded exchange: stable partition by
    target (K1 + K2 on the kernel route, the stable sort otherwise — the
    same layout), the counts exchange, and the receive-side emit mask."""
    if use_partition_kernel(world, targets.device):
        sorted_leaves, counts_out, start = _kernel_partition(
            payload, targets, emit, world)
    else:
        sorted_leaves, counts_out, start = _bucket_sort(
            payload, targets, emit, world)
    counts_in = comm.all_to_all(counts_out)
    cap_out = world * block
    pos = torch.arange(cap_out, device=targets.device)
    new_emit = (pos % block) < counts_in.gather(
        1, (pos // block).expand(world, cap_out))
    return sorted_leaves, counts_in, start, new_emit


def _padded_body(world: int, block: int, payload, targets, emit):
    """The padded-mode exchange over [W, n] per-shard values. Returns
    (leaves [W, world*block], new emit, counts_in int32 [W, world]):
    source s's rows land at ``[s*block, s*block + counts_in[:, s])``."""
    if world == 1:
        return _padded_body_w1(block, payload, targets, emit)
    sorted_leaves, counts_in, start, new_emit = _padded_partition(
        world, block, payload, targets, emit)
    out = {k: comm.all_to_all(_send_block(x, start, block, world)).view(
        world, world * block) for k, x in sorted_leaves.items()}
    return out, new_emit, counts_in


def _count_matrix(targets, emit, world: int) -> torch.Tensor:
    """The send-count matrix [src, dst] of flat [W * cap] targets."""
    return _target_counts(_dead_keyed(targets.view(world, -1),
                                      emit.view(world, -1), world), world)


def count_pair(targets1, emit1, targets2, emit2, world: int):
    """Host (countsL, countsR) send-count matrices [src, dst] for two
    shuffles, one device->host copy."""
    host = torch.stack([_count_matrix(targets1, emit1, world),
                        _count_matrix(targets2, emit2, world)]).cpu().numpy()
    return host[0], host[1]


def _padded_route(counts: np.ndarray, world: int) -> Tuple[bool, int]:
    """(padded_ok, block): the JAX package's routing rule."""
    max_pair = int(counts.max()) if counts.size else 0
    recv_max = int(counts.sum(axis=0).max()) if counts.size else 0
    block_p = _pow2(max_pair)
    # the port has no memory-pool comm budget yet: only MAX_BLOCK binds
    ok = (world * block_p <= PADDED_WASTE_FACTOR * max(_pow2(recv_max), 1)
          and block_p <= MAX_BLOCK)
    return ok, block_p


def _flat(d: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: x.reshape(-1) for k, x in d.items()}


def _shards(d: Dict[str, torch.Tensor], world: int):
    return {k: x.view(world, -1) for k, x in d.items()}


def exchange(payload: Dict[str, torch.Tensor], targets: torch.Tensor,
             emit: torch.Tensor, ctx: CylonContext,
             counts: Optional[np.ndarray] = None, dense: bool = False):
    """Shuffle flat ``[W * cap]`` per-row tensors to their target shards.
    Returns (exchanged payload, new emit mask, output capacity ``world *
    block``, meta {"mode", "block", "counts_in"}), the JAX package's
    4-tuple. Each source's rows land contiguous and in stable order."""
    world = ctx.get_world_size()
    if world == 1 and counts is None and dense:
        # one shard, every row live: block = pow2(n), counts in-program
        block = _pow2(int(targets.shape[0]))
        out, new_emit, ci = _padded_body(
            1, block, _shards(payload, 1), targets.view(1, -1),
            emit.view(1, -1))
        return _flat(out), new_emit.reshape(-1), block, {
            "mode": "padded", "block": block, "counts_in": ci}
    if counts is None:
        counts = _count_matrix(targets, emit, world).cpu().numpy()
    ok, block = _padded_route(counts, world)
    if not ok:
        raise not_ported("the blockwise (skew) exchange route "
                         "cylon_tpu.parallel.shuffle._exchange_fn")
    out, new_emit, ci = _padded_body(
        world, block, _shards(payload, world), targets.view(world, -1),
        emit.view(world, -1))
    return _flat(out), new_emit.reshape(-1), world * block, {
        "mode": "padded", "block": block, "counts_in": ci}


def exchange_pair(payload1, targets1, emit1, counts1,
                  payload2, targets2, emit2, counts2, ctx: CylonContext,
                  dense: bool = False):
    """Both sides of a two-table shuffle; each result is exchange()'s
    4-tuple. ``counts`` may be None on a one-shard world with dense
    emits (the counts then come from the exchange itself)."""
    return (exchange(payload1, targets1, emit1, ctx, counts=counts1,
                     dense=dense),
            exchange(payload2, targets2, emit2, ctx, counts=counts2,
                     dense=dense))
