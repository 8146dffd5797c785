"""Train and eval steps (``wmfml_tpu/train/steps.py``).

A train step processes the raw episode on the device (normalise, image and
task augmentation, label encoding), runs the model, and takes one optimizer
step on ``total = task_loss + beta * kl [+ contrastive_rate * contra]``,
the task loss taken on ``mu.float()`` whatever the compute dtype (the JAX
package's ``out.mu.astype(float32)``); kl is a Bayes-by-Backprop model's
(MR), contra FCL's NT-Xent over the model's views (``contra_term``, with
``contrastive: true``). The step's generator draws the BBB weights too,
so a CUDA graph replay draws new ones; an eval step takes a generator for
them (BBB samples at evaluation, as in the reference). A step returns the
loss as a device tensor: the trainer reads it on the host only at its
validation cadence, so the host never waits on the card in between.

``build_device_data_train_step`` runs ``steps_per_call`` such steps as one
call (``FusedSteps``), the JAX package's fused dispatch: on the card one
CUDA graph replay, on the CPU a loop. The episodes are sampled on the
device (``data/device_sampler.py``; ``wmfml_tpu/train/steps.py:166-232``),
or, on the host-streamed path, loaded from the host (``HostEpisodes``: the
K host episodes of a call copied into static device buffers, the JAX
package's ``build_multi_train_step``, ``:113-163``); either way DA and TA
are drawn on the device from the trainer's generator inside the step.

``init_model`` builds ``config.method`` with weights drawn from
``config.seed`` and moves it to the config's device.

Under a data-parallel mesh (``parallel/mesh.py``) a train step runs on
this rank's slice of the batch's tasks (the sampler or ``HostEpisodes``
hands it over), averages the gradients over the ranks before the optimizer
(``reduce_grads``, inside the captured graph) and reports the loss
averaged over them (``shard_mean``); FCL's views are gathered from every
rank; an eval step takes the whole batch, scores its own slice and returns
the average. With a "model" axis the state stays whole on every rank and
the model ranks of a data group run the same slice, as the JAX trainer
does; ``build_train_step(state_sharding=...)`` instead takes one eager step
on a model placed over it (``parallel/mesh.py:shard_state``), the JAX
package's tensor-parallel step.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import torch

from wmfml_tpu_torch.aug.pipeline import build_episode_processor
from wmfml_tpu_torch.configs.config import torch_dtype
from wmfml_tpu_torch.kernels.favor import favor_attention
from wmfml_tpu_torch.kernels.features import maml_features
from wmfml_tpu_torch.kernels.image_da import image_da
from wmfml_tpu_torch.kernels.stem import (literature_stem,
                                          literature_stem_backward)
from wmfml_tpu_torch.losses.losses import (LossFunc, contrastive_loss,
                                           contrastive_loss_anp)
from wmfml_tpu_torch.models.registry import build_model
from wmfml_tpu_torch.parallel import mesh, tp


def require_device(name) -> torch.device:
    """The torch device for ``name``; raises when it is CUDA and no card is
    present (the port never falls back to the CPU on its own)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r}: no CUDA device is available; pass device=cpu "
            "to run on the CPU")
    return device


def init_model(config, device=None):
    return build_model(config).to(require_device(device or config.device))


def _apply(model, batch: Dict[str, torch.Tensor], generator=None):
    return model(batch["ctx_x"], batch["ctx_y"], batch["qry_x"],
                 ctx_mask=batch["ctx_mask"], qry_y=batch["qry_y"],
                 generator=generator)


def reduce_grads(model):
    """The gradients averaged over the data shards (``parallel/mesh.py``;
    nothing without a mesh)."""
    ctx = mesh.current()
    if ctx is not None:
        ctx.all_reduce_grads(model.parameters())


def shard_mean(x: torch.Tensor) -> torch.Tensor:
    """A reported value, detached, averaged over the data shards."""
    ctx = mesh.sharded()
    return x.detach() if ctx is None else ctx.shard_mean(x)


def local_batch(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """This rank's tasks of a whole batch."""
    ctx = mesh.sharded()
    return batch if ctx is None else ctx.local_batch(batch)


def contra_term(config, out):
    """FCL's contrastive term (``wmfml_tpu/train/steps.py:55-65``): NT-Xent
    over the two views (FCL-CNP) or over the query reps by task (FCLANP),
    every rank's gathered under a mesh; 0.0 without ``contrastive`` or
    without views (evaluation)."""
    if not config.contrastive:
        return 0.0
    ctx = mesh.sharded()
    every = (lambda z: z) if ctx is None else ctx.gather
    ex = out.extras
    if "z_ctx_view" in ex and "z_qry_view" in ex:
        return contrastive_loss(every(ex["z_ctx_view"]),
                                every(ex["z_qry_view"]),
                                t=config.temperature)
    if "qry_rep" in ex:
        return contrastive_loss_anp(every(ex["qry_rep"]),
                                    t=config.temperature)
    return 0.0


def _build_update(model, optimizer, config, objective) -> Callable:
    """A step on one raw episode: process it on the device (DA on both
    image sets, TA where ``aug_list`` says), run the model in train mode,
    and take one optimizer step on the first of ``objective(out,
    pbatch)``'s (total, reported) losses; returns the reported one, a
    device tensor."""
    process = build_episode_processor(
        config.task, config.aug_list, train=True, dtype=torch_dtype(config),
        aug_random_order=config.aug_random_order)

    def step(batch, generator: Optional[torch.Generator] = None,
             ta_idx: Optional[torch.Tensor] = None,
             da_params=None) -> torch.Tensor:
        model.train()
        pbatch = process(batch, generator, ta_idx, da_params)
        total, reported = objective(_apply(model, pbatch, generator), pbatch)
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        reduce_grads(model)
        optimizer.step()
        return shard_mean(reported)

    return step


def build_train_step(model, optimizer, config,
                     state_sharding: Optional[Dict[str, Optional[int]]] = None
                     ) -> Callable:
    """One eager train step (``wmfml_tpu/train/steps.py:68-110``).
    ``state_sharding``: the placement ``parallel/mesh.py:shard_state``
    gave ``model`` (the JAX package's ``state_sharding=``); the step then
    runs on those shards through the column-parallel layers
    (``parallel/tp.py``), its gradients averaged over the data group.
    Captured steps (``FusedSteps``) take no placement."""
    if state_sharding is not None:
        placed = {name: tp.shard_of(p)[1] if tp.shard_of(p) else None
                  for name, p in model.named_parameters()}
        if placed != dict(state_sharding):
            raise ValueError("state_sharding is not the model's placement: "
                             "place it with parallel/mesh.py:shard_state")
    loss_func = LossFunc(config.loss_type, config.task)
    beta = float(config.beta or 0.0)
    rate = float(config.contrastive_rate or 0.0)

    def objective(out, pbatch):
        loss = loss_func.calc_loss(out.mu.float(), out.var, pbatch["qry_y"])
        loss = loss + beta * out.kl
        if config.contrastive:
            loss = loss + rate * contra_term(config, out)
        return loss, loss

    return _build_update(model, optimizer, config, objective)


def build_refine_step(model, optimizer, config) -> Callable:
    """Single-task refinement's step (``wmfml_tpu/eval/evaluator.py:
    202-215``): the train step on ``loss + beta * kl``, the loss taken on
    ``mu.float()`` against ``qry_y`` masked by ``ctx_mask`` (the context
    set's rows; no contrastive term), so K6 launches twice. Returns the
    loss without the kl. It runs eagerly, one host batch a call
    (``eval/evaluator.py:ModelEvaluator.refine``)."""
    loss_func = LossFunc(config.loss_type, config.task)
    beta = float(config.beta or 0.0)

    def objective(out, pbatch):
        loss = loss_func.calc_loss(out.mu.float(), out.var, pbatch["qry_y"],
                                   mask=pbatch["ctx_mask"])
        return loss + beta * out.kl, loss

    return _build_update(model, optimizer, config, objective)


# the kernel wrappers whose launch counters a capture reads
KERNELS = {fn.__name__: fn for fn in (literature_stem,
                                      literature_stem_backward,
                                      favor_attention, maml_features,
                                      image_da)}


class FusedSteps:
    """``steps_per_call`` training steps as one call: ``call(generator)``
    draws each step's episode with ``sampler.sample(tasks_per_batch,
    generator)``, runs ``step(episode, generator)`` on it and returns
    ``reduce(losses)``, a dict of device tensors, which it also keeps as
    ``metrics``.

    On the CPU a call is the loop (``loop``). On the card:

      * the first ``ceil(3 / K)`` calls run the loop on a side stream: real
        steps, in which the kernels build and set their attributes and
        cuBLAS, cuDNN, autograd and the optimizer create their lazy state;
      * the next call sets the gradients to None, registers ``generator``
        with a ``torch.cuda.CUDAGraph``, captures the loop into it (with
        the host's syncs made errors), instantiates it and replays it; every
        later call replays it. A replay draws from the generator's offset at
        that moment what the loop would draw, and moves the offset as far,
        so graph and loop are one random stream;
      * the returned tensors are the graph's static outputs, which the next
        replay overwrites: a caller that keeps them clones them.

    A capture or replay that fails raises; nothing falls back to the loop.
    Nothing may reallocate a parameter or the optimizer's state once the
    graph is captured (a checkpoint is restored before).

    Launch accounting: the wrappers' counters (``KERNELS``) count the
    launches the host issued, so a replay does not move them.
    ``captured_launches`` holds how far each moved during the capture and
    ``replays`` how many replays ran: the card launched each kernel its
    counter's count minus ``captured_launches`` plus ``captured_launches``
    times ``replays``. ``graph_stats`` holds the capture's and the
    instantiation's host seconds and the bytes the graph's private memory
    pool reserved; ``dot_path``, set before the capture, has the captured
    graph written there as DOT (``debug_dump``)."""

    def __init__(self, step: Callable, sampler, tasks_per_batch: int,
                 steps_per_call: int, optimizer, reduce: Callable):
        self.step, self.sampler, self.reduce = step, sampler, reduce
        self.tasks, self.k = tasks_per_batch, max(int(steps_per_call), 1)
        self.optimizer = optimizer
        self.device = optimizer.param_groups[0]["params"][0].device
        self.warm_calls = -(-3 // self.k)
        self.calls = self.replays = 0
        self.graph = self.out = self.dot_path = None
        self.metrics: Dict[str, torch.Tensor] = {}
        self.captured_launches: Dict[str, int] = {}
        self.graph_stats: Dict[str, float] = {}
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)

    def loop(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """The K steps, each kernel issued by the host."""
        return self.reduce([self.step(self.sampler.sample(self.tasks,
                                                          generator),
                                      generator) for _ in range(self.k)])

    def __call__(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        self.calls += 1
        if self.stream is None:
            self.metrics = self.loop(generator)
        elif self.calls <= self.warm_calls:
            current = torch.cuda.current_stream(self.device)
            self.stream.wait_stream(current)
            with torch.cuda.stream(self.stream):
                self.metrics = self.loop(generator)
            current.wait_stream(self.stream)
        else:
            if self.graph is None:
                self._capture(generator)
            self.graph.replay()
            self.replays += 1
            self.metrics = self.out
        return self.metrics

    def _capture(self, generator: torch.Generator):
        if any(tp.shard_of(p) is not None
               for g in self.optimizer.param_groups for p in g["params"]):
            raise NotImplementedError(
                "a step on model shards (tensor parallel) runs eagerly: "
                "capturing its collectives is ROADMAP.md A18d")
        self.optimizer.zero_grad(set_to_none=True)
        (self.graph, self.out, self.captured_launches,
         self.graph_stats) = capture_graph(lambda: self.loop(generator),
                                           self.stream, generator,
                                           self.dot_path)


def capture_graph(fn: Callable, stream, generator: torch.Generator,
                  dot_path: Optional[str] = None):
    """Capture ``fn()`` into a ``torch.cuda.CUDAGraph`` on ``stream``, with
    ``generator`` registered (a replay draws from its offset at that
    moment what ``fn`` would draw, and moves it as far) and the host's
    syncs made errors, and instantiate it. Returns (graph, fn's output: the
    graph's static tensors, each kernel counter's launches in the capture,
    {capture_s, end_capture_s, instantiate_s, pool_bytes}); with
    ``dot_path`` the graph is written there as DOT."""
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    graph.register_generator_state(generator)
    if dot_path is not None:
        graph.enable_debug_mode()
    before = {name: fn_.launches for name, fn_ in KERNELS.items()}
    mode = torch.cuda.get_sync_debug_mode()
    device = stream.device
    with torch.cuda.graph(graph, stream=stream):
        t0 = time.perf_counter()
        reserved = torch.cuda.memory_reserved(device)
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        t1 = time.perf_counter()
    t2 = time.perf_counter()
    graph.instantiate()
    stats = dict(capture_s=t1 - t0, end_capture_s=t2 - t1,
                 instantiate_s=time.perf_counter() - t2,
                 pool_bytes=torch.cuda.memory_reserved(device) - reserved)
    captured = {name: fn_.launches - before[name]
                for name, fn_ in KERNELS.items()}
    if dot_path is not None:
        graph.debug_dump(dot_path)
    return graph, out, captured, stats


class HostEpisodes:
    """The host-streamed path's sampler: ``load(batch)`` copies a call's K
    host episodes, stacked [K, T, ...] (pinned on the card's path), into
    static device buffers with ``non_blocking=True``, on the current
    stream, so after the previous call's reads and before this call's;
    ``sample`` hands the call's steps their episodes in turn, as views of
    those buffers, so a captured graph reads whatever the last ``load``
    wrote. The buffers are made at the first ``load``; every later batch
    has its shapes and dtypes."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.buffers: Optional[Dict[str, torch.Tensor]] = None
        self.next = 0

    def load(self, batch: Dict[str, torch.Tensor]):
        ctx = mesh.sharded()
        if ctx is not None:        # this rank's tasks of each episode
            batch = ctx.local_batch(batch, dim=1)
        if self.buffers is None:
            self.buffers = {k: torch.empty_like(v, device=self.device)
                            for k, v in batch.items()}
        for k, v in batch.items():
            self.buffers[k].copy_(v, non_blocking=True)
        self.next = 0

    def sample(self, tasks_per_batch: int,
               generator: Optional[torch.Generator] = None
               ) -> Dict[str, torch.Tensor]:
        episode = {k: v[self.next] for k, v in self.buffers.items()}
        self.next += 1
        return episode


def anp_metrics(losses: List[torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The JAX fused step's metrics (``steps.py:217``)."""
    return {"loss": torch.stack(losses).mean(), "last_loss": losses[-1]}


def build_device_data_train_step(model, optimizer, config, sampler,
                                 steps_per_call: int) -> FusedSteps:
    """``steps_per_call`` of ``build_train_step``'s steps per call, on
    episodes drawn by ``sampler`` (``FusedSteps``: a ``DeviceEpisodeSampler``
    on the device, or ``HostEpisodes``); a call returns ``{"loss": mean of
    the K losses, "last_loss": the K-th}``.

    The JAX step draws its K episodes in one ``vmap`` ahead of its scan;
    here each step draws its own, in the eager loop's order, so that a
    replay draws exactly what K eager steps draw."""
    return FusedSteps(build_train_step(model, optimizer, config), sampler,
                      config.tasks_per_batch, steps_per_call, optimizer,
                      anp_metrics)


def build_eval_step(model, config) -> Callable:
    process = build_episode_processor(config.task, [], train=False,
                                      dtype=torch_dtype(config))
    loss_func = LossFunc(config.loss_type, config.task)

    @torch.no_grad()
    def eval_step(batch, generator=None) -> torch.Tensor:
        """The test metric on one episode; a BBB model draws its weights
        from ``generator`` (a ``torch.Generator`` or an ``EpsFeed``)."""
        model.eval()
        pbatch = process(local_batch(batch))
        out = _apply(model, pbatch, generator)
        return shard_mean(loss_func.calc_loss(
            out.mu.float(), out.var, pbatch["qry_y"], test=True))

    return eval_step
