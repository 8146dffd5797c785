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
  * validation adapts with ``test_num_steps`` steps, so it needs autograd
    (without a graph of the gradient), and reports the degree metric;
  * training runs ``steps_per_call`` outer steps a call
    (``build_maml_device_train_step``, the JAX package's
    ``build_maml_device_train_step``): on the card one CUDA graph replay
    (``train/steps.py:FusedSteps``), the second-order inner loop included.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from wmfml_tpu_torch.aug.pipeline import build_episode_processor
from wmfml_tpu_torch.configs.config import torch_dtype
from wmfml_tpu_torch.losses.losses import LossFunc
from wmfml_tpu_torch.models.maml import step_size_key
from wmfml_tpu_torch.train.steps import FusedSteps
from wmfml_tpu_torch.train.trainer import ModelTrainer


def task_losses(loss_func: LossFunc, out, y, test: bool = False, mask=None):
    """The loss of each task over its own rows, [T]."""
    if mask is None:
        return torch.func.vmap(
            lambda o, g: loss_func.calc_loss(o, None, g, test=test))(out, y)
    return torch.func.vmap(
        lambda o, g, m: loss_func.calc_loss(o, None, g, test=test, mask=m))(
            out, y, mask)


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
        for _ in range(num_steps):
            out = model(pbatch["ctx_x"], mask, params, noise)
            inner = task_losses(loss_func, out, pbatch["ctx_y"],
                                mask=mask).sum()
            grads = torch.autograd.grad(inner, [params[k] for k in names],
                                        create_graph=create_graph)
            params = dict(params)
            for k, g in zip(names, grads):
                params[k] = params[k] - step_size(k) * g
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
        optimizer.step()
        loss, pre = loss.detach(), pre.detach()
        # the JAX step's metrics (train/maml.py:192-196), kept on the device
        train_step.metrics = {"loss": loss, "task_loss": pre,
                              "kl": (loss - pre) * inv_beta, "contra": 0.0}
        return loss

    return train_step


def build_maml_device_train_step(model, optimizer, config, sampler,
                                 steps_per_call: int) -> FusedSteps:
    """``steps_per_call`` of ``build_maml_train_step``'s outer steps per
    call, on episodes drawn on the device, each step drawing its own
    (``FusedSteps``); a call returns the JAX step's metrics
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
            return outer(batch, noise=generator)[1].detach()

    return eval_step


class MAMLTrainer(ModelTrainer):
    """The port's trainer loop with MAML steps underneath."""

    def _build_steps(self):
        return (build_maml_device_train_step(self.model, self.optimizer,
                                             self.config, self.sampler,
                                             self.steps_per_call),
                build_maml_eval_step(self.model, self.config))
