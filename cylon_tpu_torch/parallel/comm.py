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
