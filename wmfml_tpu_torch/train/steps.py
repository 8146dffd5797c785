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

``build_device_data_train_step`` runs ``steps_per_call`` such steps on
episodes sampled on the device as one call (``FusedSteps``), the JAX
package's fused dispatch (``wmfml_tpu/train/steps.py:166-232``): on the card
one CUDA graph replay, on the CPU a loop.

``init_model`` builds ``config.method`` with weights drawn from
``config.seed`` and moves it to the config's device.
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
from wmfml_tpu_torch.kernels.stem import literature_stem
from wmfml_tpu_torch.losses.losses import (LossFunc, contrastive_loss,
                                           contrastive_loss_anp)
from wmfml_tpu_torch.models.registry import build_model


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


def contra_term(config, out):
    """FCL's contrastive term (``wmfml_tpu/train/steps.py:55-65``): NT-Xent
    over the two views (FCL-CNP) or over the query reps by task (FCLANP);
    0.0 without ``contrastive`` or without views (evaluation)."""
    if not config.contrastive:
        return 0.0
    ex = out.extras
    if "z_ctx_view" in ex and "z_qry_view" in ex:
        return contrastive_loss(ex["z_ctx_view"], ex["z_qry_view"],
                                t=config.temperature)
    if "qry_rep" in ex:
        return contrastive_loss_anp(ex["qry_rep"], t=config.temperature)
    return 0.0


def build_train_step(model, optimizer, config) -> Callable:
    process = build_episode_processor(
        config.task, config.aug_list, train=True, dtype=torch_dtype(config),
        aug_random_order=config.aug_random_order)
    loss_func = LossFunc(config.loss_type, config.task)
    beta = float(config.beta or 0.0)
    rate = float(config.contrastive_rate or 0.0)

    def train_step(batch, generator: Optional[torch.Generator] = None,
                   ta_idx: Optional[torch.Tensor] = None,
                   da_params=None) -> torch.Tensor:
        model.train()
        pbatch = process(batch, generator, ta_idx, da_params)
        out = _apply(model, pbatch, generator)
        loss = loss_func.calc_loss(out.mu.float(), out.var, pbatch["qry_y"])
        loss = loss + beta * out.kl
        if config.contrastive:
            loss = loss + rate * contra_term(config, out)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step


# the kernel wrappers whose launch counters a capture reads
KERNELS = {fn.__name__: fn for fn in (literature_stem, favor_attention,
                                      maml_features, image_da)}


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
        self.optimizer.zero_grad(set_to_none=True)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        graph.register_generator_state(generator)
        if self.dot_path is not None:
            graph.enable_debug_mode()
        before = {name: fn.launches for name, fn in KERNELS.items()}
        mode = torch.cuda.get_sync_debug_mode()
        with torch.cuda.graph(graph, stream=self.stream):
            t0 = time.perf_counter()
            reserved = torch.cuda.memory_reserved(self.device)
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = self.loop(generator)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
            t1 = time.perf_counter()
        t2 = time.perf_counter()
        graph.instantiate()
        self.graph_stats = dict(
            capture_s=t1 - t0, end_capture_s=t2 - t1,
            instantiate_s=time.perf_counter() - t2,
            pool_bytes=torch.cuda.memory_reserved(self.device) - reserved)
        self.captured_launches = {name: fn.launches - before[name]
                                  for name, fn in KERNELS.items()}
        if self.dot_path is not None:
            graph.debug_dump(self.dot_path)
        self.graph, self.out = graph, out


def anp_metrics(losses: List[torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The JAX fused step's metrics (``steps.py:217``)."""
    return {"loss": torch.stack(losses).mean(), "last_loss": losses[-1]}


def build_device_data_train_step(model, optimizer, config, sampler,
                                 steps_per_call: int) -> FusedSteps:
    """``steps_per_call`` of ``build_train_step``'s steps per call, on
    episodes drawn on the device (``FusedSteps``); a call returns
    ``{"loss": mean of the K losses, "last_loss": the K-th}``.

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
        pbatch = process(batch)
        out = _apply(model, pbatch, generator)
        return loss_func.calc_loss(out.mu.float(), out.var, pbatch["qry_y"],
                                   test=True)

    return eval_step
