"""Data parallelism over the task axis (``wmfml_tpu/parallel/mesh.py``).

The JAX package places one ``jax.sharding.Mesh`` with axes ("data",
"model") over its devices and shards ``tasks_per_batch`` over "data"; XLA's
partitioner keeps the semantics of the whole batch inside one step. Here
one process runs on each card (started by ``torchrun``; NCCL on the card,
gloo on the CPU), and ``MeshContext`` says which slice of the task axis this
process holds. The rule it keeps: a step on n ranks gives the loss and the
updated parameters that the step on one rank gives, for the same seed.
Every place where the port draws, normalises or reduces across the task
axis therefore acts on the whole batch:

  * every random draw with a task axis is made for the whole batch, from
    the same generator state on every rank, and each rank keeps its slice
    of tasks ``[r T / n, (r + 1) T / n)`` (``local``, ``widen``): the
    device sampler's classes, instance uniforms and backgrounds, the host
    episodes (``train/steps.py:HostEpisodes``), TA offsets, K6's uniforms
    and hash keys, MAMLMR's per-task BBB samples; draws without a task axis
    (the shot, K6's op order, a shared BBB sample) are the same on every
    rank as they are;
  * each rank's objective is its share times n, and the gradients are
    averaged (``all_reduce_grads``: one all-reduce of a flat buffer, inside
    a captured CUDA graph where the step is captured). A mean over tasks
    needs nothing more; a masked mean over every task's rows reduces its
    count (``global_count``, ``losses/losses.py:_masked_mean``);
  * FAVOR+'s key stabiliser is one max over every task's keys
    (``global_max``: MAX across ranks; its gradient splits ties over the
    whole batch, as ``jnp.max``'s does);
  * FCL's NT-Xent takes its negatives from every task
    (``gather``: an all-gather whose gradient sums across ranks);
  * reported losses and evaluation losses are averaged over the ranks
    (``shard_mean``); parameters and Adam's state start as rank 0's
    (``broadcast_``); rank 0 writes checkpoints and logs.

Where ``tasks_per_batch`` does not divide the world, the data axis shrinks
to its largest divisor, with the JAX package's warning (``create_mesh``,
``:44-58``), and the ranks left over sit out (``active`` false).

The "model" axis. ``mesh_shape`` may name both axes, data x model = the
world, else the JAX package's "!= #devices" error; rank r sits where
``np.arange(world).reshape(sizes)`` puts it, the sizes in the key order of
``mesh_shape`` (``create_mesh``, ``:58-61``): ``{model: 2, data: 2}`` puts
ranks 0 and 2 on one data index, ``{data: 2, model: 2}`` ranks 0 and 1.
Every rank builds the same groups in the same order: one data group per
model index (its ranks share the model index and hold every slice of the
task axis between them) and one model group per data index (its ranks hold
the same slice). The task axis goes by the data index (``index``), and
every collective over it (``all_reduce_grads``, ``global_count``,
``global_max``, ``gather``, ``shard_mean``) runs over this rank's data
group. A trainer on such a mesh keeps the state replicated on every rank
and the model ranks of a data group compute the same slice, as the JAX
trainer does (``wmfml_tpu/train/trainer.py:97``). The tensor-parallel
placement (``param_sharding_rule``, ``state_shardings``, ``shard_state``,
the JAX package's ``:92-124``) splits the large kernels over the model
group instead; ``parallel/tp.py`` holds the layers that compute on such
shards, and ``train/steps.py:build_train_step`` takes one step on them.

``current()`` is the process's context (``use``; None: one process, every
collective skipped). A context with a process group of one rank still
issues the gradient all-reduce, which then changes no bit.
"""

from __future__ import annotations

import contextlib
import logging
import os
import re
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

_CURRENT: Optional["MeshContext"] = None
_PER_TASK = [0]        # > 0 inside ``per_task``: masked means stay local


def current() -> Optional["MeshContext"]:
    """The process's mesh context, or None."""
    return _CURRENT


def sharded() -> Optional["MeshContext"]:
    """The process's mesh context where the task axis is split (more than
    one data shard), else None."""
    ctx = _CURRENT
    return ctx if ctx is not None and ctx.n > 1 else None


def use(ctx: Optional["MeshContext"]) -> Optional["MeshContext"]:
    """Make ``ctx`` the process's context; returns the one it replaces."""
    global _CURRENT
    before, _CURRENT = _CURRENT, ctx
    return before


@contextlib.contextmanager
def per_task():
    """Inside: a masked mean is one task's own (MAML's ``vmap`` over
    tasks), never reduced across ranks."""
    _PER_TASK[0] += 1
    try:
        yield
    finally:
        _PER_TASK[0] -= 1


def in_per_task() -> bool:
    return _PER_TASK[0] > 0


def mesh_layout(world: int, mesh_shape: Optional[Dict[str, int]] = None,
                batch_divisor: Optional[int] = None
                ) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """The mesh's axes and sizes in ``mesh_shape``'s key order (the axis
    it leaves out last, of size 1; ``data`` defaults to the world over
    ``model``), as ``wmfml_tpu/parallel/mesh.py:create_mesh`` lays them;
    without ``mesh_shape``, (data, model) = (``data_shards``, 1)."""
    if not mesh_shape:
        return (DATA_AXIS, MODEL_AXIS), (
            data_shards(world, None, batch_divisor), 1)
    shape = {str(k): int(v) for k, v in dict(mesh_shape).items()}
    unknown = set(shape) - {DATA_AXIS, MODEL_AXIS}
    if unknown:
        raise ValueError(f"mesh_shape {shape}: unknown axes "
                         f"{sorted(unknown)}")
    model = shape.get(MODEL_AXIS, 1)
    shape.setdefault(DATA_AXIS, world // max(model, 1))
    shape.setdefault(MODEL_AXIS, 1)
    if min(shape.values()) < 1 or int(np.prod(list(shape.values()))) != world:
        raise ValueError(f"mesh shape {dict(mesh_shape)} != #devices {world}")
    return tuple(shape), tuple(shape.values())


def data_shards(world: int, mesh_shape: Optional[Dict[str, int]] = None,
                batch_divisor: Optional[int] = None) -> int:
    """How many slices of the task axis ``world`` ranks hold
    (``wmfml_tpu/parallel/mesh.py:create_mesh``): ``mesh_shape``'s data
    size, or the world shrunk to a divisor of ``batch_divisor``."""
    if mesh_shape:
        axes, sizes = mesh_layout(world, mesh_shape)
        return sizes[axes.index(DATA_AXIS)]
    n = world
    if batch_divisor is not None and batch_divisor % n != 0:
        n_fit = max(d for d in range(1, n + 1) if batch_divisor % d == 0)
        logging.getLogger("wmfml_tpu_torch").warning(
            "create_mesh: batch of %d tasks does not divide %d devices "
            "— data axis shrunk to %d device(s); %d device(s) IDLE. "
            "Pick tasks_per_batch divisible by the device count to use "
            "the whole mesh.", batch_divisor, world, n_fit, world - n_fit)
        n = n_fit
    return n


def local_device(device: str) -> str:
    """``cuda:LOCAL_RANK`` for a CUDA device under ``torchrun``, else
    ``device`` as it is."""
    if torch.device(device).type == "cuda" and "LOCAL_RANK" in os.environ:
        return f"cuda:{int(os.environ['LOCAL_RANK'])}"
    return device


@dataclass
class MeshContext:
    """This rank's place on the mesh: ``world`` ranks in the process group;
    ``n`` slices of the task axis (the data axis), this rank's the
    ``index``-th, summed and gathered over ``group``, the ranks that share
    its model index (None: no process group); ``model`` ranks on the model
    axis, this one the ``model_rank``-th of ``model_group``, the ranks that
    share its data index (None where ``model`` is 1). ``replicas`` is the
    group of every rank that holds the training state (the whole world, or
    the first ``n`` ranks where the data axis shrank)."""

    world: int = 1
    rank: int = 0
    n: int = 1
    group: Optional[object] = None
    index: int = 0
    model: int = 1
    model_rank: int = 0
    model_group: Optional[object] = None
    replicas: Optional[object] = None

    @classmethod
    def create(cls, mesh_shape: Optional[Dict[str, int]] = None,
               batch_divisor: Optional[int] = None) -> "MeshContext":
        """The context of this process: over the default process group when
        one is running, else a single rank without collectives."""
        if not dist.is_initialized():
            mesh_layout(1, mesh_shape, batch_divisor)
            return cls()
        world, rank = dist.get_world_size(), dist.get_rank()
        axes, sizes = mesh_layout(world, mesh_shape, batch_divisor)
        n, m = sizes[axes.index(DATA_AXIS)], sizes[axes.index(MODEL_AXIS)]
        if m == 1:                     # the data axis alone, maybe shrunk
            group = (dist.group.WORLD if n == world
                     else dist.new_group(list(range(n))))
            return cls(world=world, rank=rank, n=n, group=group,
                       index=rank if rank < n else 0, replicas=group)
        grid = np.arange(world).reshape(sizes)
        if axes.index(DATA_AXIS) > axes.index(MODEL_AXIS):
            grid = grid.T                          # [data, model]
        index, model_rank = (int(a[0]) for a in np.nonzero(grid == rank))
        # every rank makes every group, in one order
        data_groups = [dist.new_group(grid[:, j].tolist()) for j in range(m)]
        model_groups = [dist.new_group(grid[i, :].tolist()) for i in range(n)]
        return cls(world=world, rank=rank, n=n, group=data_groups[model_rank],
                   index=index, model=m, model_rank=model_rank,
                   model_group=model_groups[index], replicas=dist.group.WORLD)

    @property
    def active(self) -> bool:
        """Whether this rank holds a slice of the task axis."""
        return self.rank < self.n * self.model

    @property
    def lead(self) -> bool:
        """Rank 0: it writes checkpoints and logs."""
        return self.rank == 0

    def widen(self, count: int) -> int:
        """A local count of tasks (or of rows in task order) as the whole
        batch's."""
        return count * self.n

    def local(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's slice of ``x`` along the task axis ``dim`` (rows in
        task order: the slice of its tasks)."""
        if self.n == 1:
            return x
        size = x.shape[dim]
        if size % self.n:
            raise ValueError(f"{size} rows do not split over {self.n} data "
                             "shards")
        step = size // self.n
        return x.narrow(dim, self.index * step, step)

    def local_batch(self, batch: Dict[str, torch.Tensor],
                    dim: int = 0) -> Dict[str, torch.Tensor]:
        return {k: self.local(v, dim) for k, v in batch.items()}

    def all_reduce_grads(self, params: Iterable[torch.nn.Parameter]):
        """Average the gradients over the data shards: one all-reduce of a
        flat buffer, nothing read on the host (it can be captured). On NCCL
        the average is NCCL's own (each rank's share scaled by 1 / n, then
        summed), which on one rank scales by 1 in a kernel of its own
        where a sum in place would launch nothing; gloo sums, then the
        buffer is divided."""
        if self.group is None:
            return
        grads = [p.grad for p in params if p.grad is not None]
        if not grads:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        nccl = dist.get_backend(self.group) == "nccl"
        dist.all_reduce(flat, op=dist.ReduceOp.AVG if nccl
                        else dist.ReduceOp.SUM, group=self.group)
        if self.n > 1 and not nccl:
            flat.div_(self.n)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()

    def shard_mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of a (detached) value over the data shards."""
        if self.n == 1:
            return x
        x = x.detach().clone()
        dist.all_reduce(x, group=self.group)
        return x / self.n

    def global_count(self, count: torch.Tensor) -> torch.Tensor:
        """A count (no gradient) summed over the data shards."""
        count = count.detach().clone()
        dist.all_reduce(count, group=self.group)
        return count

    def global_max(self, x: torch.Tensor) -> torch.Tensor:
        """max over every element of ``x`` on every shard, with
        ``jnp.max``'s gradient: the cotangent, summed over the shards,
        split evenly among the elements that equal the max on every
        shard."""
        return _GlobalMax.apply(x, self.group)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every shard's ``x`` concatenated along dim 0 in rank order; the
        gradient of a shard's rows is the sum over the shards of theirs."""
        return _Gather.apply(x, self.group, self.n, self.index)

    @torch.no_grad()
    def broadcast_(self, tensors: Iterable[torch.Tensor]):
        """Rank 0's values into ``tensors`` on every rank that holds the
        state (``replicas``; the state is whole there: ``shard_state``
        places it after)."""
        if self.group is None:
            return
        for x in tensors:
            dist.broadcast(x, src=0, group=self.replicas)


class _GlobalMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        m = x.detach().amax()
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        hit = x.detach() == m
        ties = hit.sum().to(x.dtype)
        dist.all_reduce(ties, group=group)
        ctx.save_for_backward(hit, ties)
        ctx.group = group
        return m

    @staticmethod
    def backward(ctx, g):
        hit, ties = ctx.saved_tensors
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return torch.where(hit, g / ties, torch.zeros_like(g)), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, rank):
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        ctx.group, ctx.n, ctx.rank, ctx.rows = group, n, rank, x.shape[0]
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g.narrow(0, ctx.rank * ctx.rows, ctx.rows), None, None, None


def broadcast_training_state(ctx: Optional[MeshContext], model,
                             optimizer) -> None:
    """Parameters and the optimizer's state as rank 0's on every rank (the
    JAX package replicates one state over the mesh)."""
    if ctx is None:
        return
    ctx.broadcast_(list(model.parameters()) + list(model.buffers()))
    ctx.broadcast_(v for state in optimizer.state.values()
                   for v in state.values() if torch.is_tensor(v))


# the JAX shape of a port parameter's counterpart
# (``ckpt/jax_params.py`` re-lays each one out): an attention block's
# per-head projections are one dense [in, heads * d] in JAX
_HEAD = re.compile(r"^(.*?)(_W_[kvq])\.(\d+)\.linear\.weight$")


def jax_shape(name: str, shape, heads: int = 1) -> Tuple[int, ...]:
    """The JAX shape of the counterpart of the port's parameter ``name`` of
    ``shape``: a linear weight [out, in] is [in, out], a convolution's OIHW
    HWIO, one of ``heads`` attention heads' projections [d, in] the whole
    block's [in, heads * d]; anything else its own."""
    shape = tuple(int(d) for d in shape)
    if _HEAD.match(name):
        return (shape[1], heads * shape[0])
    if len(shape) == 2:
        return (shape[1], shape[0])
    if len(shape) == 4:
        return (shape[2], shape[3], shape[1], shape[0])
    return shape


def _heads(names) -> Dict[str, int]:
    """Per attention projection (its prefix), how many heads it has."""
    count: Dict[str, int] = {}
    for name in names:
        m = _HEAD.match(name)
        if m:
            key = m.group(1) + m.group(2)
            count[key] = count.get(key, 0) + 1
    return count


def param_sharding_rule(ctx: Optional[MeshContext], min_size: int = 32768
                        ) -> Callable[[Tuple[int, ...]], bool]:
    """``wmfml_tpu/parallel/mesh.py:param_sharding_rule`` on a JAX shape:
    whether a kernel of that shape splits its last axis over "model" (2 or
    more dimensions, at least ``min_size`` elements, the last axis
    divisible by the model axis); everything else stays whole. With one
    model rank, nothing splits."""
    model_n = 1 if ctx is None else ctx.model

    def rule(shape) -> bool:
        shape = tuple(shape)
        return (model_n > 1 and len(shape) >= 2
                and int(np.prod(shape)) >= min_size
                and shape[-1] % model_n == 0)

    return rule


def state_shardings(ctx: Optional[MeshContext], model: torch.nn.Module,
                    min_size: int = 32768) -> Dict[str, Optional[int]]:
    """For every parameter of ``model`` (its ``state_dict`` key), the torch
    dimension it splits over "model" under the JAX rule on its counterpart's
    shape, or None (whole). The last JAX axis of a linear or convolution
    kernel is dim 0 of the torch weight; an attention head's projection
    splits its own d rows, each model rank computing d / model features of
    every head (the JAX kernel's placement gives a rank whole heads: the
    same columns in another order). Biases stay whole; Adam's moments follow
    their parameters. The FAVOR projection, a constant buffer, stays
    whole: K2 reads it whole."""
    rule = param_sharding_rule(ctx, min_size)
    named = dict(model.named_parameters())
    heads = _heads(named)
    out: Dict[str, Optional[int]] = {}
    for name, p in named.items():
        m = _HEAD.match(name)
        h = heads[m.group(1) + m.group(2)] if m else 1
        out[name] = 0 if rule(jax_shape(name, p.shape, h)) else None
        if out[name] is not None and p.shape[0] % ctx.model:
            raise NotImplementedError(
                f"{name} {tuple(p.shape)}: its {p.shape[0]} rows do not "
                f"split over {ctx.model} model ranks")
    return out


def _take_shard(t: torch.Tensor, ctx: MeshContext, dim: int) -> torch.Tensor:
    rows = t.shape[dim] // ctx.model
    return t.narrow(dim, ctx.model_rank * rows, rows).clone()


@torch.no_grad()
def shard_state(ctx: MeshContext, model: torch.nn.Module,
                optimizer: Optional[torch.optim.Optimizer] = None,
                min_size: int = 32768) -> Dict[str, Optional[int]]:
    """Place ``model``'s parameters by the JAX rule (``state_shardings``):
    each one that splits keeps this rank's rows, in place (the same
    ``Parameter``, so an optimizer built before still holds it), and is
    marked with ``model_shard`` = (ctx, dim, full shape) for the layers of
    ``parallel/tp.py``; the optimizer's state of such a parameter, where
    it has some, keeps the same rows. Returns the placement. The MAML
    families take no placement, as in the JAX package."""
    if type(model).__name__ in ("MAMLRegressor", "MMAMLBundle"):
        raise NotImplementedError(
            "MAML and MMAML take no tensor-parallel placement (the JAX "
            "package's MAML steps take none either)")
    placement = state_shardings(ctx, model, min_size)
    for name, p in model.named_parameters():
        dim = placement[name]
        if dim is None:
            continue
        full = tuple(p.shape)
        p.data = _take_shard(p.data, ctx, dim)
        p.model_shard = (ctx, dim, full)
        if p.grad is not None:
            p.grad = _take_shard(p.grad, ctx, dim)
        state = optimizer.state.get(p, {}) if optimizer is not None else {}
        for k, v in state.items():
            if torch.is_tensor(v) and tuple(v.shape) == full:
                state[k] = _take_shard(v, ctx, dim)
    return placement


def from_config(config) -> MeshContext:
    """The context for ``config``: the default process group's when one is
    running (its data axis from ``mesh_shape``, else the world shrunk to a
    divisor of ``tasks_per_batch``), else one rank."""
    return MeshContext.create(getattr(config, "mesh_shape", None),
                              batch_divisor=config.tasks_per_batch)


__all__ = ["DATA_AXIS", "MODEL_AXIS", "MeshContext", "broadcast_training_state",
           "current", "data_shards", "from_config", "in_per_task",
           "jax_shape", "local_device", "mesh_layout", "param_sharding_rule",
           "per_task", "shard_state", "sharded", "state_shardings", "use"]
