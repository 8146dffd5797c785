"""Train and eval steps (``wmfml_tpu/train/steps.py``).

A train step processes the raw episode on the device (normalise, image and
task augmentation, label encoding), runs the model, and takes one optimizer
step on ``total = task_loss + beta * kl``, the task loss taken on
``mu.float()`` whatever the compute dtype (the JAX package's
``out.mu.astype(float32)``). It returns the loss as a device
tensor: the trainer reads it on the host only at its validation cadence,
so the host never waits on the card in between.

``init_model`` builds ``config.method`` with weights drawn from
``config.seed`` and moves it to the config's device.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from wmfml_tpu_torch.aug.pipeline import build_episode_processor
from wmfml_tpu_torch.configs.config import torch_dtype
from wmfml_tpu_torch.losses.losses import LossFunc
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


def _apply(model, batch: Dict[str, torch.Tensor]):
    return model(batch["ctx_x"], batch["ctx_y"], batch["qry_x"],
                 ctx_mask=batch["ctx_mask"])


def build_train_step(model, optimizer, config) -> Callable:
    process = build_episode_processor(config.task, config.aug_list, train=True,
                                      dtype=torch_dtype(config))
    loss_func = LossFunc(config.loss_type, config.task)
    beta = float(config.beta or 0.0)

    def train_step(batch, generator: Optional[torch.Generator] = None,
                   ta_idx: Optional[torch.Tensor] = None,
                   da_params=None) -> torch.Tensor:
        model.train()
        pbatch = process(batch, generator, ta_idx, da_params)
        out = _apply(model, pbatch)
        loss = loss_func.calc_loss(out.mu.float(), out.var, pbatch["qry_y"])
        loss = loss + beta * out.kl
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step


def build_eval_step(model, config) -> Callable:
    process = build_episode_processor(config.task, [], train=False,
                                      dtype=torch_dtype(config))
    loss_func = LossFunc(config.loss_type, config.task)

    @torch.no_grad()
    def eval_step(batch) -> torch.Tensor:
        model.eval()
        pbatch = process(batch)
        out = _apply(model, pbatch)
        return loss_func.calc_loss(out.mu.float(), out.var, pbatch["qry_y"],
                                   test=True)

    return eval_step
