"""MAML meta-training (``wmfml_tpu/train/maml.py``).

The JAX package ``vmap``s one task's inner loop and ``lax.scan``s its SGD
steps; here the tasks sit side by side on a written-out axis and the steps
are a Python loop:

  * every adapted parameter gets a per-task copy [T, ...]; each inner step
    takes ``torch.autograd.grad`` of the SUM of the per-task inner losses
    with respect to those copies, which gives each task exactly its own
    gradient (as ``vmap(grad)`` does; a mean would scale it by 1/T);
  * second order by default: the inner gradient is taken with
    ``create_graph=True`` and the outer backward goes through it;
    ``first_order`` takes it without a graph (FOMAML);
  * step sizes: ``update_lr``, or the model's learnable ``step_size``
    (one scalar, or one per adapted parameter) when ``learn_step_size``;
  * outer loss = mean over tasks of (query loss + beta * kl), the query
    loss taken in float32; kl is the Bayes-by-Backprop encoder's (MAMLMR)
    from the query pass, 0 without one. A BBB encoder draws one sample per
    task in every inner step and in the query pass, from the step's
    generator (the JAX package gives each task and step its own key,
    ``wmfml_tpu/train/maml.py:110-150``); it stays frozen in the inner
    loop, and the outer gradient reaches its ``W_mu`` / ``W_rho`` through
    K1's backward;
  * in ``compute_dtype`` bfloat16 the episode's images and the forward are
    bfloat16 while the per-task copies, their inner SGD steps and every
    gradient stay float32; the inner loss meets float32 labels and so is
    float32, as in the JAX package (``train/maml.py:129``);
  * ``maml_remat`` (``remat_mode``): ``step`` recomputes each inner step
    (the forward, the inner gradient, the update) in the outer backward
    instead of keeping what autograd saved in it, as the JAX package's
    ``jax.checkpoint`` of the step (``wmfml_tpu/train/maml.py:69-78``):
    ``rematerialised`` runs the step under saved-tensor hooks that drop
    its saved tensors when it returns and recompute them all, once, at the
    outer backward's first read (``_RematFrame``). The step's BBB draws
    are kept from its first run and replayed by the recompute
    (``StepDraws``, as JAX hands the step its key), so the recompute,
    eager or inside a CUDA graph, sees the same sample and the generator
    is never read or set; K1 and K3 launch twice an inner step. ``dots``
    is JAX's ``dots_with_no_batch_dims_saveable`` policy, which saves
    nothing more than ``step`` at these shapes: under ``vmap`` every
    product of the step has a batch dimension (per-task weights, per-task
    BBB samples) and convolutions are never saved, so its residuals are
    ``step``'s and ``dots`` runs ``step`` here
    (``tests/test_torch_port_remat.py`` holds JAX's residual lists). Only
    a training outer call rematerialises: evaluation takes no outer
    gradient, so there is nothing to recompute;
  * validation adapts with ``test_num_steps`` steps, so it needs autograd
    (without a graph of the gradient), and reports the degree metric;
  * training runs ``steps_per_call`` outer steps a call
    (``build_maml_device_train_step``, the JAX package's
    ``build_maml_device_train_step``): on the card one CUDA graph replay
    (``train/steps.py:FusedSteps``), the second-order inner loop included;
    on the host-streamed path (``train/trainer.py``) one step a call, as
    the JAX package's host path (``wmfml_tpu/train/maml.py:250-289``);
  * validation after training on the device path sweeps the val/test
    splits on the device (``data/device_eval.py``, the trainer's
    ``_make_device_sweep`` over this eval step: the JAX package's
    ``build_outer_device_sweep``).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import torch

from wmfml_tpu_torch.aug.pipeline import build_episode_processor
from wmfml_tpu_torch.configs.config import torch_dtype
from wmfml_tpu_torch.losses.losses import LossFunc
from wmfml_tpu_torch.models.maml import step_size_key
from wmfml_tpu_torch.nn.bbb import draw_normal
from wmfml_tpu_torch.parallel import mesh
from wmfml_tpu_torch.train.steps import (FusedSteps, local_batch,
                                         reduce_grads, shard_mean)
from wmfml_tpu_torch.train.trainer import ModelTrainer


def task_losses(loss_func: LossFunc, out, y, test: bool = False, mask=None):
    """The loss of each task over its own rows, [T] (``mesh.per_task``: no
    count is reduced across ranks)."""
    with mesh.per_task():
        if mask is None:
            return torch.func.vmap(
                lambda o, g: loss_func.calc_loss(o, None, g, test=test))(out,
                                                                          y)
        return torch.func.vmap(
            lambda o, g, m: loss_func.calc_loss(o, None, g, test=test,
                                                mask=m))(out, y, mask)


def remat_mode(config) -> str:
    """``maml_remat`` as the JAX package reads it (``wmfml_tpu/train/
    maml.py:69-78, 100``): ``none`` (also unset or empty), ``dots``, and
    any other value ``step``."""
    mode = str(config.maml_remat or "none")
    return mode if mode in ("none", "dots") else "step"


class StepDraws:
    """A rematerialised inner step's BBB draws: the step's first run draws
    from ``noise`` (a generator or an ``EpsFeed``) and keeps each draw; a
    run after ``rewind`` (the recompute) hands the same draws out again."""

    def __init__(self, noise):
        self.noise, self.draws, self.used = noise, [], 0

    def rewind(self):
        self.used = 0

    def normal(self, shape, device) -> torch.Tensor:
        if self.used == len(self.draws):
            self.draws.append(draw_normal(self.noise, shape, device))
        self.used += 1
        return self.draws[self.used - 1]


class _RematFrame:
    """One call of a rematerialised step. While the step runs, every tensor
    autograd saves is kept in ``saved`` under its index in the order of
    saving, and the graph holds only the index; the step's own inner
    backward reads them from there. When the step returns they are
    dropped. The first read after that (the outer backward's) runs the
    step once more on its inputs, detached, which saves the same tensors
    in the same order (shapes and dtypes checked); each is then handed out
    once and dropped. Every graph task reads the one recompute, so the
    step runs twice in all, as under ``jax.checkpoint``.
    (``torch.utils.checkpoint`` recomputes once per graph task that reads
    a dropped tensor: the inner gradient's, and that of each K1 and K3
    backward's ``autograd.grad`` on its twin, five runs of a MAML step.)"""

    def __init__(self, step: Callable, inputs):
        self.step, self.inputs = step, inputs
        self.saved: Dict[int, torch.Tensor] = {}
        self.meta = []
        self.packed: Optional[int] = None      # next index while running

    def run(self, inputs, first: bool):
        self.packed = 0
        try:
            with torch.autograd.graph.saved_tensors_hooks(
                    functools.partial(self._pack, first), self._unpack):
                out = self.step(*inputs)
        finally:
            count, self.packed = self.packed, None
        if count != len(self.meta):
            raise RuntimeError(f"a recompute of a rematerialised step saved "
                               f"{count} tensors, its first run "
                               f"{len(self.meta)}")
        return out

    def _pack(self, first: bool, x: torch.Tensor) -> int:
        i = self.packed
        self.packed += 1
        if first:
            self.meta.append((x.shape, x.dtype))
        elif self.meta[i] != (x.shape, x.dtype):
            raise RuntimeError(f"a recompute of a rematerialised step saved "
                               f"{tuple(x.shape)} {x.dtype} as tensor {i}, "
                               f"its first run {self.meta[i]}")
        self.saved[i] = x if first else x.detach()
        return i

    def _unpack(self, i: int) -> torch.Tensor:
        if self.packed is not None:             # the step's own backward
            return self.saved[i]
        if i not in self.saved:
            with torch.enable_grad():
                self.run([x.detach().requires_grad_(x.requires_grad)
                          for x in self.inputs], first=False)
        return self.saved.pop(i)


def rematerialised(step: Callable, mode: str) -> Callable:
    """``step(*tensors) -> tuple of tensors`` as it is (``none``), or
    recomputed in the outer backward (``step``; ``dots`` saves nothing
    more at the MAML family's shapes, see the module docstring) through
    ``_RematFrame``'s saved-tensor hooks. No random state is saved or
    restored: the draws are the step's own (``StepDraws``)."""
    if mode == "none":
        return step

    def run(*inputs):
        frame = _RematFrame(step, inputs)
        out = frame.run(inputs, first=True)
        frame.saved.clear()
        return out

    return run


def build_maml_outer(model, config, num_steps: int, train: bool,
                     test: bool) -> Callable:
    """Return ``outer(batch, generator=None, ta_idx=None, da_params=None,
    noise=None) -> (outer_loss, pre_loss)`` over a raw episode, processed
    once (image and task augmentation in training only); its inner steps
    need grad enabled. A BBB encoder draws from ``noise`` (an
    ``nn/bbb.py:EpsFeed``), else from ``generator``."""
    loss_func = LossFunc(config.loss_type, config.task)
    process = build_episode_processor(config.task,
                                      config.aug_list if train else [],
                                      train=train, dtype=torch_dtype(config),
                                      aug_random_order=config.aug_random_order)
    create_graph = train and not config.first_order
    remat = remat_mode(config) if train else "none"
    beta = float(config.beta or 0.0)
    update_lr = float(config.update_lr)
    learned = getattr(model, "step_size", None)

    def step_size(name: str):
        if learned is None:
            return update_lr
        if isinstance(learned, torch.nn.ParameterDict):
            return learned[step_size_key(name)]
        return learned

    def outer(batch: Dict[str, torch.Tensor],
              generator: Optional[torch.Generator] = None,
              ta_idx: Optional[torch.Tensor] = None, da_params=None,
              noise=None):
        pbatch = process(batch, generator, ta_idx, da_params)
        noise = generator if noise is None else noise
        mask = pbatch["ctx_mask"]
        params = model.task_params(pbatch["ctx_x"].shape[0])
        names = [k for k in params if model.adaptable(k)]
        frozen = {k: v for k, v in params.items() if k not in names}

        def inner_step(draws):
            """One inner SGD step of the adapted copies, drawing from
            ``draws``."""
            def step(*adapted):
                if isinstance(draws, StepDraws):
                    draws.rewind()
                p = dict(frozen, **dict(zip(names, adapted)))
                out = model(pbatch["ctx_x"], mask, p, draws)
                inner = task_losses(loss_func, out, pbatch["ctx_y"],
                                    mask=mask).sum()
                grads = torch.autograd.grad(inner, adapted,
                                            create_graph=create_graph)
                return tuple(a - step_size(k) * g
                             for k, a, g in zip(names, adapted, grads))
            return rematerialised(step, remat)

        for _ in range(num_steps):
            step = inner_step(noise if remat == "none" else StepDraws(noise))
            params = dict(params, **dict(zip(
                names, step(*(params[k] for k in names)))))
        with torch.set_grad_enabled(train):
            out, kl = model.forward_with_kl(pbatch["qry_x"], None, params,
                                            noise)
            losses = task_losses(loss_func, out.float(), pbatch["qry_y"],
                                 test=test)
        return (losses + beta * kl).mean(), losses.mean()

    return outer


def _num_steps(config):
    # None-checks: an explicit num_updates: 0 is a real zero-adaptation run
    num_steps = 5 if config.num_steps is None else int(config.num_steps)
    test_steps = (num_steps if config.test_num_steps is None
                  else int(config.test_num_steps))
    return num_steps, test_steps


def build_maml_train_step(model, optimizer, config) -> Callable:
    outer = build_maml_outer(model, config, _num_steps(config)[0],
                             train=True, test=False)
    inv_beta = 1.0 / float(config.beta) if config.beta else 0.0

    def train_step(batch, generator: Optional[torch.Generator] = None,
                   ta_idx: Optional[torch.Tensor] = None,
                   da_params=None) -> torch.Tensor:
        model.train()
        loss, pre = outer(batch, generator, ta_idx, da_params)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        reduce_grads(model)
        optimizer.step()
        loss, pre = shard_mean(loss), shard_mean(pre)
        # the JAX step's metrics (train/maml.py:192-196), kept on the device
        train_step.metrics = {"loss": loss, "task_loss": pre,
                              "kl": (loss - pre) * inv_beta, "contra": 0.0}
        return loss

    return train_step


def build_maml_device_train_step(model, optimizer, config, sampler,
                                 steps_per_call: int) -> FusedSteps:
    """``steps_per_call`` of ``build_maml_train_step``'s outer steps per
    call, each step drawing its own episode from ``sampler`` (on the
    device, or ``HostEpisodes``; ``FusedSteps``); a call returns the JAX step's metrics
    (``wmfml_tpu/train/maml.py:192-196``): ``loss``, the mean of the K
    losses, and ``task_loss``, ``kl`` and ``contra`` of the K-th step."""
    step = build_maml_train_step(model, optimizer, config)

    def reduce(losses):
        return {"loss": torch.stack(losses).mean(),
                **{k: step.metrics[k] for k in ("task_loss", "kl", "contra")}}

    return FusedSteps(step, sampler, config.tasks_per_batch, steps_per_call,
                      optimizer, reduce)


def build_maml_eval_step(model, config) -> Callable:
    outer = build_maml_outer(model, config, _num_steps(config)[1],
                             train=False, test=True)

    def eval_step(batch, generator=None) -> torch.Tensor:
        """The query loss before the kl; a BBB encoder draws from
        ``generator`` (a ``torch.Generator`` or an ``EpsFeed``)."""
        model.eval()
        with torch.enable_grad():        # the inner steps take gradients
            return shard_mean(outer(local_batch(batch), noise=generator)[1])

    return eval_step


class MAMLTrainer(ModelTrainer):
    """The port's trainer loop with MAML steps underneath."""

    def _build_steps(self):
        if self.streamed:       # the host path: one step a call, as in JAX
            self.steps_per_call = 1
        return (build_maml_device_train_step(self.model, self.optimizer,
                                             self.config, self.sampler,
                                             self.steps_per_call),
                build_maml_eval_step(self.model, self.config))
