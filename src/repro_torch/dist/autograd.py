"""The mesh train step's collectives as autograd functions over a
``dist.comm.Comm`` (or a ``MetaComm`` in the dry run).

Each is a ``torch.autograd.Function`` whose backward is the adjoint of
its forward on the mesh:

* `copy_to` (Megatron's "copy to model"): the identity; its backward sums
  the ranks' gradients over the group.
* `sum_over` (Megatron's "sum over model"): the sum of the ranks' partials
  over the group; its backward hands each rank the gradient as it is.
* `mean_over` (a MoE layer's balance loss under the shard-local
  dispatch): the mean of the ranks' values over the group; its backward
  is the mean of the ranks' gradients, since each rank's loss holds its
  share of the replicated mean.
* `gather` (FSDP's all-gather, the rows a MoE layer gathers and its
  experts' outputs): the ranks' tensors concatenated along a dim; with
  ``reduce`` its backward sums the gradients over the group and scatters
  each rank its stripe (the ranks computed different things with the
  whole), without it the backward takes the rank's own stripe of its
  gradient (every rank computed the same thing with the whole: a sum
  would count that gradient once a rank).

`gather` takes several tensors at once and moves them in one collective
each way (a block's weights: one all-gather forward, one all-to-all
backward). Float sums add the partials in rank order (``Comm.sum``,
``Comm.sum_scatter``): every rank holds the same bits on every transport,
and a repeated step gives the same bits. A group of one rank is the
identity both ways, with no collective.
"""
from __future__ import annotations

import torch


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, x):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.comm.sum(g)


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, x):
        return comm.sum(x)

    @staticmethod
    def backward(ctx, g):
        return None, g


class _MeanOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, x):
        ctx.comm = comm
        return comm.all_reduce(x) / comm.size

    @staticmethod
    def backward(ctx, g):
        return None, ctx.comm.all_reduce(g) / ctx.comm.size


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, dims, reduce, *xs):
        ctx.comm, ctx.dims, ctx.reduce = comm, dims, reduce
        ctx.shapes = [x.shape for x in xs]
        ctx.like = dict(dtype=xs[0].dtype, device=xs[0].device)
        n = comm.size
        parts = comm.all_gather(torch.cat([x.reshape(-1) for x in xs]))
        out, off = [], 0
        for x, d in zip(xs, dims):
            k = x.numel()
            p = parts[:, off:off + k].reshape((n,) + tuple(x.shape))
            out.append(torch.cat(p.unbind(0), dim=d))
            off += k
        return tuple(out)

    @staticmethod
    def backward(ctx, *gs):
        comm, n = ctx.comm, ctx.comm.size
        # each gradient's n stripes written once into one [n, ...] buffer
        sizes = [int(torch.Size(shape).numel()) for shape in ctx.shapes]
        flat = torch.empty((n, sum(sizes)), **ctx.like)
        off = 0
        for g, d, shape, k in zip(gs, ctx.dims, ctx.shapes, sizes):
            dst = flat[:, off:off + k]
            if g is None:   # an output the loss does not reach
                dst.zero_()
            else:
                dst.view((n,) + tuple(shape)).copy_(
                    g.unflatten(d, (n, shape[d])).movedim(d, 0))
            off += k
        mine = comm.sum_scatter(flat)[0] if ctx.reduce else flat[comm.rank]
        out, off = [], 0
        for shape, k in zip(ctx.shapes, sizes):
            out.append(mine[off:off + k].reshape(shape))
            off += k
        return (None, None, None) + tuple(out)


def copy_to(x: torch.Tensor, comm) -> torch.Tensor:
    """``x`` (the same on every rank of ``comm``) as it is; the backward
    sums the ranks' gradients."""
    return x if comm.size == 1 else _CopyTo.apply(comm, x)


def sum_over(x: torch.Tensor, comm) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``comm``, in rank order; the
    backward passes the gradient through."""
    return x if comm.size == 1 else _SumOver.apply(comm, x)


def mean_over(x: torch.Tensor, comm) -> torch.Tensor:
    """The mean of every rank's ``x`` over ``comm`` (an ``all_reduce``
    sum, then divided: a scalar, where the rank-ordered `Comm.sum` would
    cost an all-gather); the backward takes the mean of the ranks'
    gradients, one all-reduce each way."""
    return x if comm.size == 1 else _MeanOver.apply(comm, x)


def gather(xs, dims, comm, reduce: bool = True) -> list:
    """Each tensor of ``xs`` concatenated over the ranks of ``comm`` along
    its dim of ``dims`` (rank order), in one collective; ``reduce``: the
    ranks use the whole differently, so the backward sums the gradients
    and scatters (FSDP, gathered rows); else every rank uses it the same
    way and the backward keeps the rank's stripe."""
    xs = list(xs)
    if comm.size == 1 or not xs:
        return xs
    if len({x.dtype for x in xs}) != 1:
        raise TypeError("gather takes tensors of one dtype")
    return list(_Gather.apply(comm, tuple(dims), reduce, *xs))
