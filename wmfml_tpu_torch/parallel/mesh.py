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
``:44-58``), and the ranks left over sit out (``active`` false). A "model"
axis above 1 (the JAX package's tensor-parallel placement, ``:92-124``)
raises, naming ROADMAP.md A18c.

``current()`` is the process's context (``use``; None: one process, every
collective skipped). A context with a process group of one rank still
issues the gradient all-reduce, which then changes no bit.
"""

from __future__ import annotations

import contextlib
import logging
import os
from dataclasses import dataclass
from typing import Dict, Iterable, Optional

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


def data_shards(world: int, mesh_shape: Optional[Dict[str, int]] = None,
                batch_divisor: Optional[int] = None) -> int:
    """How many ranks of ``world`` hold a slice of the task axis
    (``wmfml_tpu/parallel/mesh.py:create_mesh``)."""
    if mesh_shape:
        shape = {str(k): int(v) for k, v in dict(mesh_shape).items()}
        if shape.get(MODEL_AXIS, 1) > 1:
            raise NotImplementedError(
                f"mesh_shape {shape}: the tensor-parallel 'model' axis is "
                "not ported (ROADMAP.md A18c); the port shards the task axis "
                "over 'data' only")
        unknown = set(shape) - {DATA_AXIS, MODEL_AXIS}
        if unknown:
            raise ValueError(f"mesh_shape {shape}: unknown axes "
                             f"{sorted(unknown)}")
        n = shape.get(DATA_AXIS, world)
        if n != world:
            raise ValueError(f"mesh shape {shape} != #devices {world}")
        return n
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
    """This rank's place on the data axis: ``world`` ranks in the process
    group, the first ``n`` of which hold a slice of the task axis each;
    ``group`` the process group of those ``n`` (None: no process group)."""

    world: int = 1
    rank: int = 0
    n: int = 1
    group: Optional[object] = None

    @classmethod
    def create(cls, mesh_shape: Optional[Dict[str, int]] = None,
               batch_divisor: Optional[int] = None) -> "MeshContext":
        """The context of this process: over the default process group when
        one is running, else a single rank without collectives."""
        if not dist.is_initialized():
            data_shards(1, mesh_shape, batch_divisor)
            return cls()
        world, rank = dist.get_world_size(), dist.get_rank()
        n = data_shards(world, mesh_shape, batch_divisor)
        group = (dist.group.WORLD if n == world
                 else dist.new_group(list(range(n))))
        return cls(world=world, rank=rank, n=n, group=group)

    @property
    def active(self) -> bool:
        """Whether this rank holds a slice of the task axis."""
        return self.rank < self.n

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
        return x.narrow(dim, self.rank * step, step)

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
        return _Gather.apply(x, self.group, self.n, self.rank)

    @torch.no_grad()
    def broadcast_(self, tensors: Iterable[torch.Tensor]):
        """Rank 0's values into ``tensors`` on every shard."""
        if self.group is None:
            return
        for x in tensors:
            dist.broadcast(x, src=0, group=self.group)


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


def from_config(config) -> MeshContext:
    """The context for ``config``: the default process group's when one is
    running (its data axis from ``mesh_shape``, else the world shrunk to a
    divisor of ``tasks_per_batch``), else one rank."""
    return MeshContext.create(getattr(config, "mesh_shape", None),
                              batch_divisor=config.tasks_per_batch)


__all__ = ["DATA_AXIS", "MODEL_AXIS", "MeshContext", "broadcast_training_state",
           "current", "data_shards", "from_config", "in_per_task",
           "local_device", "per_task", "sharded", "use"]
