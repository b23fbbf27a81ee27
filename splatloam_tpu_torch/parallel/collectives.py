"""The collectives of the sharded programs, with autograd and accounting.

The JAX package has no module of its own for these: shard_map supplies
its collectives and their transposes.  The port wraps the plain
torch.distributed calls, keeping JAX's transpose rules (its semantics
under ``check_vma=False``: a rank's gradient is the derivative of the sum
of every rank's loss):

  all_gather (tiled, dim 0)  backward: reduce_scatter (SUM)
  all_reduce (SUM)           no backward here: the programs sum
                             gradients and losses after autograd, as
                             JAX's psums outside value_and_grad do
  all_to_all, broadcast      no gradient

Every call records its per-device send bytes in stats.py.  Under gloo a
CUDA tensor is staged through host memory (``group.staged``, fixed when
the mesh is built): copied to the host before the call and back after,
and those bytes are counted as staged.  No call is retried and no failure
is caught.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from . import stats
from .mesh import Group


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _host(t: torch.Tensor, group: Group) -> torch.Tensor:
    return t.cpu() if group.staged and t.is_cuda else t


def _record(kind: str, out_bytes: int, group: Group, staged: int,
            send: int | None = None) -> None:
    if send is None:
        send = stats._send_bytes(kind, out_bytes, group.size)
    stats.record(stats.CollectiveOp(kind, out_bytes, group.size, send,
                                    staged))


def all_reduce_(t: torch.Tensor, group: Group) -> torch.Tensor:
    """In-place SUM over the group; returns ``t``."""
    h = _host(t, group)
    dist.all_reduce(h, op=dist.ReduceOp.SUM, group=group.pg)
    if h is not t:
        t.copy_(h)
    _record("all-reduce", _nbytes(t), group,
            2 * _nbytes(t) if h is not t else 0)
    return t


def all_gather_raw(t: torch.Tensor, group: Group) -> torch.Tensor:
    """[n, ...] per rank -> [size * n, ...], ranks in group order."""
    t = t.contiguous()
    h = _host(t, group)
    out = h.new_empty((group.size * t.shape[0], *t.shape[1:]))
    dist.all_gather_into_tensor(out, h, group=group.pg)
    staged = 0
    if h is not t:
        staged = _nbytes(t) + _nbytes(out)
        out = out.to(t.device)
    _record("all-gather", _nbytes(out), group, staged)
    return out


def reduce_scatter_raw(t: torch.Tensor, group: Group) -> torch.Tensor:
    """[size * n, ...] per rank -> this rank's [n, ...] block of the SUM
    over the group."""
    t = t.contiguous()
    h = _host(t, group)
    out = h.new_empty((t.shape[0] // group.size, *t.shape[1:]))
    dist.reduce_scatter_tensor(out, h, op=dist.ReduceOp.SUM, group=group.pg)
    staged = 0
    if h is not t:
        staged = _nbytes(t) + _nbytes(out)
        out = out.to(t.device)
    _record("reduce-scatter", _nbytes(out), group, staged)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_gather_raw(t, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_raw(g, ctx.group), None


def all_gather(t: torch.Tensor, group: Group) -> torch.Tensor:
    """Differentiable tiled all-gather along dim 0 (JAX's
    ``all_gather(..., tiled=True)``); its backward is the reduce-scatter
    of the cotangent."""
    return _AllGather.apply(t, group)


def all_to_all(t: torch.Tensor, in_splits: list[int],
               out_splits: list[int], group: Group) -> torch.Tensor:
    """Rows [sum(in_splits), ...] sent in group order (the first
    in_splits[0] rows to group rank 0, ...); returns the received rows
    [sum(out_splits), ...], sources in group order."""
    t = t.contiguous()
    h = _host(t, group)
    out = h.new_empty((sum(out_splits), *t.shape[1:]))
    dist.all_to_all_single(out, h, output_split_sizes=out_splits,
                           input_split_sizes=in_splits, group=group.pg)
    staged = 0
    if h is not t:
        staged = _nbytes(t) + _nbytes(out)
        out = out.to(t.device)
    row = _nbytes(t) // max(t.shape[0], 1)
    sent = (sum(in_splits) - in_splits[group.rank]) * row
    _record("all-to-all", _nbytes(out), group, staged, send=sent)
    return out


def broadcast_(t: torch.Tensor, group: Group, src: int = 0) -> torch.Tensor:
    """In place: every rank gets the tensor of group rank ``src``."""
    h = _host(t, group)
    dist.broadcast(h, src=group.ranks[src], group=group.pg)
    if h is not t:
        t.copy_(h)
    _record("broadcast", _nbytes(t), group,
            2 * _nbytes(t) if h is not t else 0)
    return t
