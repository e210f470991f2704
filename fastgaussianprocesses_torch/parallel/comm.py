"""The collectives the sharded paths call, over one process group.

Where a gradient passes through, each is an autograd Function whose backward
is the adjoint collective:

* :func:`all_sum` (``all_reduce``, sum): its backward all-reduces the
  gradient, so a loss that every rank computes identically is seeded with
  ``1 / D`` on each rank and the replicated parameters' gradients are then
  summed over the group (``models/abstract._make_loss_fn``);
* :func:`all_amax` (an ``all_gather``, then ``amax``): the gather's backward
  reduce-scatters the gradient;
* :func:`reduce_scatter` (sum): its backward all-gathers the gradient.

They are written here rather than taken from ``torch.distributed.nn``
because their outputs must be fresh tensors (the centring adds the DC term
in place on a transform's output) and because that family is deprecated.
Every helper takes ``group=None`` to mean "no group": the identity, so a
single-process model runs the same code.  Complex tensors travel as their
real view (``torch.view_as_real``).
"""

import torch
import torch.distributed as dist


def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _gather(x, group):
    parts = [torch.empty_like(x) for _ in range(size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return parts


def _reduce_scatter(parts, group):
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, [p.contiguous() for p in parts], group=group)
    return out


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllGather(torch.autograd.Function):
    """(...) on every rank -> (D, ...), rank order."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return torch.stack(_gather(x, group))

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(list(g.unbind(0)), ctx.group), None


class _ReduceScatter(torch.autograd.Function):
    """(D, ...) on every rank -> (...): the sum over ranks of row ``rank``."""

    @staticmethod
    def forward(ctx, parts, group):
        ctx.group = group
        return _reduce_scatter(list(parts.unbind(0)), group)

    @staticmethod
    def backward(ctx, g):
        return torch.stack(_gather(g, ctx.group)), None


def _real_io(fn, x, group):
    if x.is_complex():
        return torch.view_as_complex(fn(torch.view_as_real(x), group))
    return fn(x, group)


def all_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of ``x`` over the group (identity without one)."""
    if group is None:
        return x
    return _real_io(_AllReduce.apply, x, group)


def all_amax(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable elementwise max of a real ``x`` over the group: an
    all-gather of the local values, then ``amax`` (its gradient goes to the
    rank that holds the max, as the unsharded ``amax``'s does)."""
    if group is None:
        return x
    return _AllGather.apply(x, group).amax(0)


def reduce_scatter(contribs: torch.Tensor, group) -> torch.Tensor:
    """``contribs`` (D, ...): this rank's contribution to every rank's block.
    Returns ``sum over ranks c of contribs_c[j]`` on rank j, differentiable."""
    return _real_io(_ReduceScatter.apply, contribs, group)


def all_gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Not differentiable: every rank's ``x`` concatenated along ``dim`` in
    rank order (the blocks must have equal shapes)."""
    if group is None:
        return x
    return torch.cat(_gather(x.detach(), group), dim)


def sum_(x: torch.Tensor, group) -> torch.Tensor:
    """Not differentiable: a sum over the group, out of place."""
    if group is None:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, group=group)
    return x
