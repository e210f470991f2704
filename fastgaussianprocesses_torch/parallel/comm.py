"""The collectives the sharded paths call, over one process group.

Where a gradient passes through, each is an autograd Function whose backward
is the adjoint collective:

* :func:`all_sum` (``all_reduce``, sum): its backward all-reduces the
  gradient, so a loss that every rank computes identically is seeded with
  ``1 / D`` on each rank and the replicated parameters' gradients are then
  summed over the group (``models/abstract._make_loss_fn``);
* :func:`all_amax` (an ``all_gather``, then ``amax``): the gather's backward
  reduce-scatters the gradient;
* :func:`reduce_scatter` (sum): its backward all-gathers the gradient;
* :func:`all_to_all` (pieces of the last axis to each rank): its backward
  is the inverse all-to-all;
* :func:`shared_input` (the identity): its backward takes the group mean of
  the ranks' gradients, for an input that every rank feeds into the same
  replicated computation.

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


class _AllToAll(torch.autograd.Function):
    """(K, ...) on every rank, cut along dim 0 into ``in_splits[c]`` rows for
    rank c -> the rows every rank sent here, in rank order (``out_splits[c]``
    from rank c)."""

    @staticmethod
    def forward(ctx, x, group, in_splits, out_splits):
        ctx.group, ctx.splits = group, (in_splits, out_splits)
        return _all_to_all(x, group, in_splits, out_splits)

    @staticmethod
    def backward(ctx, g):
        in_splits, out_splits = ctx.splits
        return _all_to_all(g, ctx.group, out_splits, in_splits), None, None, None


def _all_to_all(x, group, in_splits, out_splits):
    x = x.contiguous()
    out = x.new_empty((sum(out_splits),) + tuple(x.shape[1:]))
    dist.all_to_all_single(out, x, list(out_splits), list(in_splits), group=group)
    return out


class _SharedInput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g / size(ctx.group), None


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


def all_to_all(x: torch.Tensor, group, in_splits, out_splits) -> torch.Tensor:
    """Differentiable all-to-all along the LAST axis: that axis is cut into
    consecutive pieces of ``in_splits[c]`` entries, piece c goes to rank c,
    and the result holds the pieces that every rank sent here, in rank order
    (``out_splits[c]`` entries from rank c).  Its backward is the inverse
    all-to-all (the splits swapped).  The identity without a group."""
    if group is None:
        return x
    t = x.movedim(-1, 0)
    if x.is_complex():
        return torch.view_as_complex(_AllToAll.apply(
            torch.view_as_real(t), group, tuple(in_splits), tuple(out_splits))).movedim(0, -1)
    return _AllToAll.apply(t, group, tuple(in_splits), tuple(out_splits)).movedim(0, -1)


def shared_input(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself, for an input that every rank feeds into the same
    replicated computation whose sums over the group are :func:`all_sum`'s.
    Seeded with 1 on every rank, rank c's gradient is then D times its local
    terms plus the replicated terms; the backward returns their mean over the
    group, which is the whole gradient, the same on every rank.  The
    identity without a group."""
    if group is None:
        return x
    return _SharedInput.apply(x, group)


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
