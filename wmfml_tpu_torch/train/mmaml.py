"""MMAML meta-training (``wmfml_tpu/train/mmaml.py``).

  * ``build_mmaml_outer``: the episode processed once (image DA through K6
    and TA in training); the task embeddings computed once from the
    processed context with its mask; ``num_steps`` manual SGD steps on the
    gated net's per-task copies of every parameter, each gradient clamped
    element-wise to +-``INNER_GRAD_CLIP``; the query pass (BN over every
    row) from the adapted copies and the same embeddings, its loss taken
    on ``preds.float()``; the outer loss is the mean over tasks. As in
    ``train/maml.py`` the tasks sit side by side and each inner step takes
    ``torch.autograd.grad`` of the sum of the per-task losses, which gives
    each task its own gradient. Second order unless ``first_order``: then
    the inner gradients carry no graph (JAX's ``stop_gradient(grads)``),
    and the outer gradient still reaches the embedding net through the
    modulation of every inner step and of the query pass. ``maml_remat``
    recomputes each inner step (the forward, the clamped gradient, the
    update) in the outer backward, as MAML's (``train/maml.py:
    rematerialised``; ``dots`` is ``step`` at these shapes too).
  * ``build_mmaml_optimizer``: one Adam(``lr``) over two parameter groups,
    ``model`` and ``embedding`` (optax's ``multi_transform`` of two
    ``clip_by_global_norm(2.0)`` + Adam chains); the YAML's ``optimizer``
    and ``weight_decay`` are ignored, as in the JAX package. Capturable on
    the card, so that a CUDA graph holds the update.
  * ``clip_groups_``: each group's gradients clipped to global norm
    ``OUTER_GRAD_NORM_CLIP`` on their own, as optax computes it (``g`` when
    ``|g| < 2``, else ``g / |g| * 2``; torch's ``clip_grad_norm_`` divides
    by ``|g| + 1e-6`` instead), on the device, with no host read.
  * ``build_mmaml_device_train_step``: ``steps_per_call`` outer steps a
    call (``train/steps.py:FusedSteps``; on the card one CUDA graph
    replay), returning the JAX step's metrics: ``loss`` (the mean of the
    K), ``task_loss`` (the K-th), ``kl`` and ``contra`` 0; one step a call
    on the host-streamed path (``wmfml_tpu/train/mmaml.py:211-248``).
  * ``build_mmaml_eval_step``: ``test_num_steps`` inner steps under
    ``enable_grad``, the degree metric (``test=True``); the trainer's
    device sweep runs it over the splits on the device.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from wmfml_tpu_torch.aug.pipeline import build_episode_processor
from wmfml_tpu_torch.configs.config import torch_dtype
from wmfml_tpu_torch.losses.losses import LossFunc
from wmfml_tpu_torch.train.maml import (_num_steps, rematerialised,
                                        remat_mode, task_losses)
from wmfml_tpu_torch.train.steps import (FusedSteps, local_batch,
                                         reduce_grads, shard_mean)
from wmfml_tpu_torch.train.trainer import ModelTrainer

INNER_GRAD_CLIP = 20.0
OUTER_GRAD_NORM_CLIP = 2.0


def build_mmaml_outer(model, config, num_steps: int, train: bool,
                      test: bool) -> Callable:
    """Return ``outer(batch, generator=None, ta_idx=None, da_params=None)
    -> outer_loss`` over a raw episode; its inner steps need grad enabled.
    ``model`` is an ``MMAMLBundle``."""
    loss_func = LossFunc(config.loss_type, config.task)
    process = build_episode_processor(config.task,
                                      config.aug_list if train else [],
                                      train=train, dtype=torch_dtype(config),
                                      aug_random_order=config.aug_random_order)
    create_graph = train and not config.first_order
    remat = remat_mode(config) if train else "none"
    fast_lr = float(config.update_lr)
    gated = model.model

    def outer(batch: Dict[str, torch.Tensor],
              generator: Optional[torch.Generator] = None,
              ta_idx: Optional[torch.Tensor] = None, da_params=None):
        pbatch = process(batch, generator, ta_idx, da_params)
        ctx_x, mask = pbatch["ctx_x"], pbatch["ctx_mask"]
        embeddings = model.embedding_model(ctx_x, mask)
        params = gated.task_params(ctx_x.shape[0])
        names = list(params)

        def inner_step(*adapted):
            out = gated(ctx_x, embeddings, mask, dict(zip(names, adapted)))
            inner = task_losses(loss_func, out, pbatch["ctx_y"],
                                mask=mask).sum()
            grads = torch.autograd.grad(inner, adapted,
                                        create_graph=create_graph)
            return tuple(p - fast_lr * g.clamp(-INNER_GRAD_CLIP,
                                               INNER_GRAD_CLIP)
                         for p, g in zip(adapted, grads))

        step = rematerialised(inner_step, remat)
        for _ in range(num_steps):
            params = dict(zip(names, step(*params.values())))
        with torch.set_grad_enabled(train):
            out = gated(pbatch["qry_x"], embeddings, None, params)
            losses = task_losses(loss_func, out.float(), pbatch["qry_y"],
                                 test=test)
        return losses.mean()

    return outer


def build_mmaml_optimizer(model, config) -> torch.optim.Adam:
    params = list(model.parameters())
    return torch.optim.Adam(
        [{"params": list(model.model.parameters()), "name": "model"},
         {"params": list(model.embedding_model.parameters()),
          "name": "embedding"}],
        lr=config.lr, capturable=params[0].is_cuda)


@torch.no_grad()
def clip_groups_(optimizer, max_norm: float = OUTER_GRAD_NORM_CLIP):
    """Clip each parameter group's gradients to global norm ``max_norm``
    on their own, in place (``optax.clip_by_global_norm``)."""
    for group in optimizer.param_groups:
        grads = [p.grad for p in group["params"]]
        norm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
        keep = norm < max_norm
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm * max_norm))


def build_mmaml_train_step(model, optimizer, config) -> Callable:
    outer = build_mmaml_outer(model, config, _num_steps(config)[0],
                              train=True, test=False)

    def train_step(batch, generator: Optional[torch.Generator] = None,
                   ta_idx: Optional[torch.Tensor] = None,
                   da_params=None) -> torch.Tensor:
        model.train()
        loss = outer(batch, generator, ta_idx, da_params)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        reduce_grads(model)             # the clip reads the whole batch's
        clip_groups_(optimizer)
        optimizer.step()
        return shard_mean(loss)

    return train_step


def build_mmaml_device_train_step(model, optimizer, config, sampler,
                                  steps_per_call: int) -> FusedSteps:
    """``steps_per_call`` of ``build_mmaml_train_step``'s outer steps per
    call, on episodes drawn by ``sampler`` (``FusedSteps``)."""

    def reduce(losses):
        return {"loss": torch.stack(losses).mean(), "task_loss": losses[-1],
                "kl": 0.0, "contra": 0.0}

    return FusedSteps(build_mmaml_train_step(model, optimizer, config),
                      sampler, config.tasks_per_batch, steps_per_call,
                      optimizer, reduce)


def build_mmaml_eval_step(model, config) -> Callable:
    outer = build_mmaml_outer(model, config, _num_steps(config)[1],
                              train=False, test=True)

    def eval_step(batch, generator=None) -> torch.Tensor:
        """The query loss after ``test_num_steps`` inner steps (MMAML draws
        nothing: ``generator`` is ignored)."""
        model.eval()
        with torch.enable_grad():        # the inner steps take gradients
            return shard_mean(outer(local_batch(batch)))

    return eval_step


class MMAMLTrainer(ModelTrainer):
    """The port's trainer loop with MMAML steps and optimizer underneath,
    and the JAX MMAML trainer's best-loss thresholds
    (``wmfml_tpu/train/mmaml.py:168-198``)."""

    def __init__(self, model, config, data):
        super().__init__(model, config, data)
        self.best_loss = {"validation": 10000.0, "test": 10000.0}

    def _build_optimizer(self):
        return build_mmaml_optimizer(self.model, self.config)

    def _build_steps(self):
        if self.streamed:       # the host path: one step a call, as in JAX
            self.steps_per_call = 1
        return (build_mmaml_device_train_step(self.model, self.optimizer,
                                              self.config, self.sampler,
                                              self.steps_per_call),
                build_mmaml_eval_step(self.model, self.config))
