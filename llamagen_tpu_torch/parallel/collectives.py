"""The collectives that join a GPT's tensor-parallel shards (Megatron's
conjugate pairs), over `torch.distributed`.

In a forward they are the decode step's and the prefill's: `reduce_from_tp`
sums the row-parallel matmuls' partial outputs (wo, w2) over the TP group
in the input's dtype, as JAX's `psum` of the bf16 product, and
`gather_from_tp` concatenates the column-parallel head's logits along the
vocabulary in rank order (`dist.all_gather_into_tensor`). For training each
is an autograd function with the conjugate backward: `copy_to_tp`
(identity, then an all-reduce of the gradient) goes before wqkv, w1, w3 and
the head; `reduce_from_tp` passes the gradient on; `gather_from_tp` takes
the rank's slice of it. With no group (a whole model) each is the
identity.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

Group = Optional[dist.ProcessGroup]


def _all_reduce(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


def gather_last(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """[..., n] on each rank -> [..., n * tp], the ranks' slices in rank
    order."""
    tp = dist.get_world_size(group)
    out = x.new_empty(tp * x.shape[0], *x.shape[1:])  # gloo: dim-0 concat
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out.view(tp, *x.shape).movedim(0, -2).reshape(
        *x.shape[:-1], tp * x.shape[-1])


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.n = group, x.shape[-1]
        return gather_last(x, group)

    @staticmethod
    def backward(ctx, g):
        r = dist.get_rank(ctx.group)
        return g[..., r * ctx.n:(r + 1) * ctx.n].contiguous(), None


def copy_to_tp(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Identity forward; the backward sums the gradient over the group."""
    return x if group is None else _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The sum of the ranks' partial outputs, in x's dtype; the backward
    passes the gradient on."""
    return x if group is None else _ReduceFromTP.apply(x, group)


def gather_from_tp(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The ranks' last-dim slices concatenated in rank order; the backward
    takes the rank's slice."""
    return x if group is None else _GatherFromTP.apply(x, group)


__all__ = ["copy_to_tp", "reduce_from_tp", "gather_from_tp", "gather_last"]
