"""The collectives of the distributed ops: the counterparts of the
collectives that cylon_tpu runs inside ``shard_map``, behind one
interface with two backends. The context picks the backend
(``CylonContext.comm``):

* the *virtual world* (`VirtualComm`): one process holds all W shards.
  Every per-shard value is one row of a tensor with a leading shard
  dimension, so a collective is a tensor operation on that dimension and
  moves no bytes between devices (the module-level functions below);
* the *process group* (`ProcessGroupComm`): P processes of V shards each
  (W = P * V), joined by ``torch.distributed``. Process p owns the global
  shards ``[p * V, (p + 1) * V)``; its tensors carry only those V shards
  as their leading dimension, and the collectives move them between
  processes: ``all_to_all_single``, ``all_gather`` and point-to-point
  sends.

Both take and return the same shapes, with V = W in the virtual world:
``all_to_all`` ``[V, W, ...] -> [V, W_src, ...]``, ``replicated_gather``
``[V, ...] -> [W, ...]``, ``ring_shift`` ``[V, ...] -> [V, ...]``,
``gather_full`` ``[V, n, ...] -> [V, W * n, ...]``; ``all_reduce`` (sum,
max, min) and ``all_gather_host`` agree small host values, which the
virtual world already holds for every shard; `all_gather_rows` and
`all_gather_bytes` bring every process's host array or byte strings of
any length (the scalar aggregates' partials, the exact redo's keys, the
long-key sort's keys).

The process group sends every tensor as its bytes (a uint8 view), so any
dtype crosses. NCCL moves CUDA tensors where they lie (one card a
process). Gloo moves host tensors: on the CPU as they are; CUDA tensors
(several processes sharing one card, where NCCL refuses a second rank on
a device) are staged through pinned host buffers, copied out before each
collective and back after it. That staging is the gloo backend's design,
not a fallback: a CUDA tensor never reaches gloo itself.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..telemetry.metrics import record_host_sync


def all_to_all(send: torch.Tensor) -> torch.Tensor:
    """``jax.lax.all_to_all`` of the ``[W_src, W_dst, ...]`` send stack:
    shard d receives ``send[s, d]`` from every source s, in source order
    — the transpose of the two leading dimensions."""
    return send.transpose(0, 1).contiguous()


def replicated_gather(x: torch.Tensor) -> torch.Tensor:
    """``shuffle.replicated_gather`` (cylon_tpu/parallel/shuffle.py:102):
    the ``[W, ...]`` matrix of every shard's value, replicated. In the
    virtual world the per-shard values already form that matrix."""
    return x


def ring_shift(x: torch.Tensor) -> torch.Tensor:
    """``jax.lax.ppermute`` with the permutation ``i -> (i + 1) % W`` over
    the ``[W, ...]`` shard dimension: shard ``i + 1`` receives shard
    ``i``'s value, so after k shifts shard i holds shard ``(i - k) % W``'s
    (the ring join's rotation, cylon_tpu/parallel/dist_ops.py:1307)."""
    return torch.roll(x, 1, dims=0)


def gather_full(x: torch.Tensor) -> torch.Tensor:
    """``dist_ops._gather_full`` (cylon_tpu/parallel/dist_ops.py:1530):
    ``jax.lax.psum`` of each shard's rows placed one-hot in a ``[W, n,
    ...]`` matrix, i.e. a replicated ``jax.lax.all_gather``. The ``[W, n,
    ...]`` per-shard values become the full ``[W * n, ...]`` table in
    shard-major order, replicated on every shard as ``[W, W * n, ...]``
    (a broadcast view: nothing is copied)."""
    w = x.shape[0]
    full = x.reshape((1, -1) + tuple(x.shape[2:]))
    return full.expand((w,) + tuple(full.shape[1:]))


class VirtualComm:
    """The virtual world: all W shards in this process (P = 1, V = W).
    Host values computed over the shards are already global."""

    def __init__(self, world: int):
        self.world = self.shards = int(world)
        self.nproc, self.rank = 1, 0

    all_to_all = staticmethod(all_to_all)
    replicated_gather = staticmethod(replicated_gather)
    ring_shift = staticmethod(ring_shift)
    gather_full = staticmethod(gather_full)

    def all_reduce(self, values, op: str) -> np.ndarray:
        return np.asarray(values)

    def all_gather_host(self, values) -> np.ndarray:
        return np.asarray(values)[None]

    def barrier(self) -> None:
        pass


_OPS = ("sum", "max", "min")


def _as_bytes(x: torch.Tensor) -> torch.Tensor:
    """A tensor's bytes as a flat uint8 view (copied only when it is not
    contiguous)."""
    return x.contiguous().view(-1).view(torch.uint8)


class ProcessGroupComm:
    """P processes of V shards each over the default ``torch.distributed``
    process group; this process (rank p) owns the global shards
    ``[p * V, (p + 1) * V)``. ``backend`` is the group's ("nccl" or
    "gloo"); ``device`` is the context's."""

    def __init__(self, nproc: int, rank: int, shards: int,
                 device: torch.device, backend: str):
        self.nproc, self.rank, self.shards = int(nproc), int(rank), \
            int(shards)
        self.world = self.nproc * self.shards
        self.device = device
        self.backend = backend
        # gloo moves host tensors: CUDA tensors are staged through pinned
        # host buffers (the module docstring)
        self.stage = backend == "gloo" and device.type == "cuda"
        self.comm_device = torch.device("cpu") if backend == "gloo" \
            else device

    # -- byte buffers on the collectives' device --

    def _empty(self, nbytes: int) -> torch.Tensor:
        return torch.empty(nbytes, dtype=torch.uint8,
                           device=self.comm_device, pin_memory=self.stage)

    def _out(self, b: torch.Tensor) -> torch.Tensor:
        """A byte view headed into a collective, on its device."""
        if not self.stage:
            return b
        buf = self._empty(b.numel())
        buf.copy_(b)
        return buf

    def _back(self, b: torch.Tensor, dtype, shape) -> torch.Tensor:
        """Received bytes as a tensor of ``dtype`` and ``shape`` on the
        context's device."""
        if self.stage:
            b = b.to(self.device, non_blocking=True)
        return b.view(dtype).view(shape)

    # -- the interface --

    def all_to_all(self, send: torch.Tensor) -> torch.Tensor:
        """The local ``[V, W_dst, ...]`` send stack -> the local ``[V,
        W_src, ...]`` receive stack: one ``all_to_all_single`` of the
        stack laid out by destination process."""
        import torch.distributed as dist

        v, p = self.shards, self.nproc
        rest = tuple(send.shape[2:])
        r = int(np.prod(rest)) if rest else 1
        inp = send.reshape(v, p, v, r).permute(1, 0, 2, 3)  # [P_dst, ...]
        b = _as_bytes(inp)
        out = self._empty(b.numel())
        dist.all_to_all_single(out, self._out(b))
        # [P_src, V_src, V_dst, r] -> [V_dst, W_src, ...]
        recv = self._back(out, send.dtype, (p, v, v, r))
        return recv.permute(2, 0, 1, 3).contiguous().view(
            (v, self.world) + rest)

    def replicated_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The local ``[V, ...]`` values -> every shard's ``[W, ...]``,
        in global shard order."""
        import torch.distributed as dist

        b = _as_bytes(x)
        outs = [self._empty(b.numel()) for _ in range(self.nproc)]
        dist.all_gather(outs, self._out(b))
        return self._back(torch.cat(outs), x.dtype,
                          (self.world,) + tuple(x.shape[1:]))

    def ring_shift(self, x: torch.Tensor) -> torch.Tensor:
        """Global shard i + 1 receives shard i's value: a local roll, and
        the last local shard goes to the next process (one send and one
        receive a process, batched)."""
        import torch.distributed as dist

        if self.nproc == 1:
            return torch.roll(x, 1, dims=0)
        last = self._out(_as_bytes(x[-1]))
        recv = self._empty(last.numel())
        ops = [dist.P2POp(dist.isend, last, (self.rank + 1) % self.nproc),
               dist.P2POp(dist.irecv, recv, (self.rank - 1) % self.nproc)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        first = self._back(recv, x.dtype, (1,) + tuple(x.shape[1:]))
        return torch.cat([first, x[:-1]])

    def gather_full(self, x: torch.Tensor) -> torch.Tensor:
        """The local ``[V, n, ...]`` rows -> the full ``[W * n, ...]``
        table, replicated on every local shard as ``[V, W * n, ...]``."""
        full = self.replicated_gather(x).reshape(
            (1, -1) + tuple(x.shape[2:]))
        return full.expand((self.shards,) + tuple(full.shape[1:]))

    def _host_tensor(self, values) -> torch.Tensor:
        a = np.ascontiguousarray(np.asarray(values))
        if a.dtype == np.bool_:
            a = a.astype(np.int64)
        return torch.from_numpy(a).to(self.comm_device)

    def all_reduce(self, values, op: str) -> np.ndarray:
        """Elementwise sum, max or min of a small host array over the
        processes."""
        import torch.distributed as dist

        if op not in _OPS:
            raise ValueError(f"op must be one of {_OPS}, got {op!r}")
        t = self._host_tensor(values)
        dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM,
                               "max": dist.ReduceOp.MAX,
                               "min": dist.ReduceOp.MIN}[op])
        out = t.cpu().numpy()
        # the port's own site: the processes agreeing a host value
        record_host_sync("comm.all_reduce")
        return out

    def all_gather_host(self, values) -> np.ndarray:
        """``[P, ...]``: every process's host array of one shape, in rank
        order."""
        import torch.distributed as dist

        t = self._host_tensor(values)
        outs = [torch.empty_like(t) for _ in range(self.nproc)]
        dist.all_gather(outs, t)
        out = torch.stack(outs).cpu().numpy()
        record_host_sync("comm.all_gather_host")
        return out

    def barrier(self) -> None:
        self.all_reduce(np.zeros(1, np.int64), "sum")


def all_gather_rows(comm, values: np.ndarray) -> list:
    """Every process's 1-D host array of one dtype and any length, in
    rank order: the lengths first, then the rows as bytes, each process's
    padded to the longest (``all_gather_host`` takes one shape)."""
    a = np.ascontiguousarray(values).reshape(-1)
    if comm.nproc == 1:
        return [a]
    size = a.dtype.itemsize
    n = comm.all_gather_host(np.array([a.shape[0]], np.int64))[:, 0]
    buf = np.zeros(max(int(n.max()), 1) * size, np.uint8)
    buf[:a.nbytes] = a.view(np.uint8)
    every = comm.all_gather_host(buf)
    return [every[p, :int(n[p]) * size].view(a.dtype)
            for p in range(comm.nproc)]


def all_gather_bytes(comm, items: Sequence) -> list:
    """Every process's list of byte strings (None allowed), in rank
    order: the lengths first (-1 for None), then one flat uint8 buffer
    of the bytes, both through `all_gather_rows`."""
    lens = np.array([-1 if b is None else len(b) for b in items], np.int64)
    flat = np.frombuffer(b"".join(b for b in items if b is not None),
                         np.uint8)
    out = []
    for ln, buf in zip(all_gather_rows(comm, lens),
                       all_gather_rows(comm, flat)):
        ends = np.cumsum(np.maximum(ln, 0))
        raw = buf.tobytes()
        out.append([None if k < 0 else raw[e - k:e]
                    for k, e in zip(ln, ends)])
    return out


def agree_max(comm, values: Sequence[int]) -> list:
    """Host integers maxed over the processes (the virtual world's values
    are already global)."""
    ints = [int(v) for v in values]
    if comm.nproc == 1:
        return ints
    return [int(v) for v in comm.all_reduce(np.array(ints, np.int64),
                                            "max")]
