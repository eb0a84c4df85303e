"""The virtual world's collectives: the counterparts of the collectives
that cylon_tpu runs inside ``shard_map``.

In the virtual world every per-shard value is one row of a tensor with a
leading shard dimension, so a collective is a tensor operation on that
dimension and moves no bytes between devices. A ``torch.distributed``
backend (``all_to_all_single`` over NCCL) is queued in ROADMAP.md.
"""
from __future__ import annotations

import torch


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
