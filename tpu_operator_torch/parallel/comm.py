"""Differentiable collectives over a process group, with JAX's transposes.

Under ``shard_map`` JAX differentiates a collective by transposing it;
here each collective is a ``torch.autograd.Function`` whose backward is
that transpose, so a loss computed on every rank gets JAX's gradients:

- ``ring_shift``: rank r's tensor moves to r+1 (``lax.ppermute`` by +1);
  the cotangent moves back by -1. One batched exchange, in which every
  rank sends and receives (unbatched NCCL send/recv pairs can deadlock).
- ``replicate_sum``: an all-reduce (sum) whose output is replicated; the
  backward is the identity. This is ``lax.psum`` into ``out_specs=P()``
  when the loss counts the replicated output once. ``torch.distributed
  .nn.functional.all_reduce`` sums the gradient as well, which would give
  every rank n times its share.
- ``grad_sum``: the identity, whose backward sums the gradient over the
  group: the input of a product whose weight is sharded, or a replicated
  parameter (JAX's gradient of a ``P()`` input is the sum over devices).
- ``gather_last``: an all-gather along the last dim whose output is
  replicated; the backward keeps this rank's slice.
- ``all_to_all``: equal blocks of dim 0 exchanged; the backward is the
  same exchange of the cotangent.

``group=None`` is the default group. Every rank of the group calls each
function in the same order, forward and backward.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist


def ring_peer(group, step: int) -> Tuple[int, int]:
    """Global ranks (destination, source) ``step`` places round the ring."""
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    dst, src = (rank + step) % n, (rank - step) % n
    if group is not None:
        dst = dist.get_global_rank(group, dst)
        src = dist.get_global_rank(group, src)
    return dst, src


def shift(tensors: Sequence[torch.Tensor], group, step: int
          ) -> List[torch.Tensor]:
    """``tensors`` moved ``step`` ranks along the ring in one batched
    exchange; a copy at world size 1. Not differentiable."""
    tensors = [t.contiguous() for t in tensors]
    if dist.get_world_size(group) == 1:
        return [t.clone() for t in tensors]
    dst, src = ring_peer(group, step)
    out = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t, dst, group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, t, src, group) for t in out]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class RingShift(torch.autograd.Function):
    """``RingShift.apply(group, *tensors)``: every tensor one rank along
    the ring (r to r+1) in one exchange; the cotangents go back."""

    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return tuple(shift(tensors, group, +1))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *shift(grads, ctx.group, -1))


def ring_shift(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` from rank r to rank r+1 of ``group`` (``lax.ppermute`` with
    ``perm=[(i, (i + 1) % n)]``); differentiable."""
    return RingShift.apply(group, x)[0]


class _ReplicateSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def replicate_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over ``group``, replicated; the gradient passes
    through unchanged (``lax.psum`` into ``out_specs=P()``)."""
    return _ReplicateSum.apply(x, group)


class _GradSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def grad_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` unchanged; its gradient is summed over ``group``."""
    return _GradSum.apply(x, group)


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.width = group, x.shape[-1]
        n = dist.get_world_size(group)
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        i, w = dist.get_rank(ctx.group), ctx.width
        return grad[..., i * w:(i + 1) * w].contiguous(), None


def gather_last(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along the last dim, in rank order,
    replicated; the gradient of this rank's slice comes back."""
    return _GatherLast.apply(x, group)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllToAll.apply(grad, ctx.group), None


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """``all_to_all_single`` in equal blocks of dim 0 (``lax.all_to_all``
    with ``split_axis=concat_axis=0, tiled=True``): block j goes to rank
    j, and block i of the output came from rank i."""
    return _AllToAll.apply(x, group)
