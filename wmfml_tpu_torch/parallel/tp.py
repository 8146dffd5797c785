"""Column-parallel layers over the "model" axis: the computation the JAX
package's partitioner runs on kernels placed by ``param_sharding_rule``
(``wmfml_tpu/parallel/mesh.py:92-124``; here ``parallel/mesh.py:
shard_state``).

A parameter that ``shard_state`` split holds this rank's rows of dim 0 (a
linear layer's output features, a convolution's output channels) and is
marked ``model_shard`` = (context, dim, full shape). Everything outside
these layers runs whole and alike on every rank of a model group, so the
loss and every cotangent that reaches a layer's output are the same on
each of them. A layer on a shard:

  * computes its own slice of output features or channels from the whole
    input (``to_model``: the identity forward);
  * gathers the slices over the model group, concatenated in rank order
    along the feature axis (``gather``), and adds the whole bias after;
  * backward: the weight's gradient takes its own slice of the output's
    cotangent, which every rank holds whole, so it needs no sum
    (``gather``'s backward narrows); the input's gradient is this rank's
    columns' partial product, summed over the model group (``to_model``'s
    backward).

``parallel/mesh.py:_Gather`` (the data axis) sums its cotangent over the ranks:
right there, where every rank contributes other tasks' rows, it would
multiply a shard's gradient by the model axis here, so these layers keep
their own. The gather is an all-reduce of the slices placed at their
offsets in zeros (a sum with zeros is exact), and every collective here is
an all-reduce: gloo runs them on the CPU and on CUDA tensors alike, NCCL
on the card.

Where a shard feeds a computation that takes the whole weight (K1's stem,
the s2d trunk stem), ``full`` gathers it; its backward keeps this rank's
rows of the whole weight's gradient. A Bayes-by-Backprop layer draws eps
for the whole weight from the same generator state on every rank and keeps
its rows (``sample_rows``), as the data axis does with its draws, and sums
its KL over the model group (``model_sum``: the cotangent is the same on
every rank, so its backward is the identity).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def shard_of(t) -> Optional[tuple]:
    """(context, dim, full shape) of a model shard, else None."""
    return getattr(t, "model_shard", None)


def _gather(x: torch.Tensor, ctx, dim: int) -> torch.Tensor:
    """The model group's slices of ``x`` along ``dim``, in rank order."""
    dim = dim % x.dim()
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * ctx.model
    out = x.new_zeros(shape)
    out.narrow(dim, ctx.model_rank * n, n).copy_(x)
    dist.all_reduce(out, group=ctx.model_group)
    return out


class _ToModel(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx):
        fctx.ctx = ctx
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=fctx.ctx.model_group)
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, dim):
        fctx.ctx, fctx.dim, fctx.n = ctx, dim % x.dim(), x.shape[dim]
        return _gather(x.contiguous(), ctx, dim)

    @staticmethod
    def backward(fctx, g):
        return (g.narrow(fctx.dim, fctx.ctx.model_rank * fctx.n, fctx.n),
                None, None)


class _ModelSum(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx):
        x = x.detach().clone()
        dist.all_reduce(x, group=ctx.model_group)
        return x

    @staticmethod
    def backward(fctx, g):
        return g, None


def to_model(x: torch.Tensor, ctx) -> torch.Tensor:
    """``x`` as it is; its gradient summed over the model group."""
    return _ToModel.apply(x, ctx)


def gather(x: torch.Tensor, ctx, dim: int) -> torch.Tensor:
    """The model group's slices of ``x`` concatenated along ``dim`` in rank
    order; the gradient of this rank's slice is its rows of the whole
    cotangent."""
    return _Gather.apply(x, ctx, dim)


def model_sum(x: torch.Tensor, ctx) -> torch.Tensor:
    """``x`` summed over the model group (a KL over the rows of a shard);
    the gradient as it comes."""
    return _ModelSum.apply(x, ctx)


def full(w: torch.Tensor) -> torch.Tensor:
    """The whole weight of a model shard (else ``w`` as it is)."""
    shard = shard_of(w)
    return w if shard is None else gather(w, shard[0], shard[1])


def sample_rows(eps: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A draw for the whole weight, cut to the rows of ``like``'s shard
    (``eps`` itself where ``like`` is whole); ``lead`` sample axes come
    first, the weight's dim 0 after them."""
    shard = shard_of(like)
    if shard is None:
        return eps
    ctx, dim, full_shape = shard
    dim = eps.dim() - len(full_shape) + dim
    rows = full_shape[shard[1]] // ctx.model
    return eps.narrow(dim, ctx.model_rank * rows, rows)


def mark(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` marked as a shard of the same rows as ``like`` (a BBB sample of
    a sharded posterior)."""
    shard = shard_of(like)
    if shard is not None:
        t.model_shard = shard
    return t


def column(op, x: torch.Tensor, w: torch.Tensor, b, dim: int) -> torch.Tensor:
    """``op(x, w)`` (no bias) on a model shard ``w``: this rank's output
    features along ``dim``, gathered over the model group, then ``b`` (None,
    or the whole bias as ``op``'s output expects it) added."""
    ctx = shard_of(w)[0]
    y = gather(op(to_model(x, ctx), w), ctx, dim)
    return y if b is None else y + b
