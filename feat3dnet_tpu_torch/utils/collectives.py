"""The collectives of data-parallel training, over a torch.distributed group.

`all_reduce_sum` is differentiable: its forward sums a tensor over the
group's ranks and its backward sums the cotangents the same way, so each
rank's autograd yields its share of the gradient of the ranks' summed loss.
The other helpers are plain (no grad). Every rank must call the same
collectives in the same order; a collective that fails raises.
"""
from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """In-place sum of a contiguous tensor over the group's ranks."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.detach().clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.detach().clone(memory_format=torch.contiguous_format),
                           ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of x over the group's ranks, with the sum of the cotangents as
    its backward."""
    return _AllReduceSum.apply(x, group)


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """(rows, ...) on each rank -> (ranks, rows, ...), rank order."""
    parts: List[torch.Tensor] = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.stack(parts)
