"""Optimizer factory (``wmfml_tpu/train/state.py:build_optimizer``).

Adam by default; a truthy ``weight_decay`` turns Adam into decoupled AdamW
with that decay (optax ``adamw`` and ``torch.optim.AdamW`` take the same
step); ``adamw`` without a decay uses 1e-2; ``sgd`` is plain SGD.

On CUDA parameters Adam and AdamW are ``capturable``: their step count
lives on the card and the bias corrections are computed there in float32,
as optax computes them, so that a CUDA graph can hold the update
(``train/steps.py:FusedSteps``). On the CPU they keep PyTorch's default.

On a model placed over the "model" axis (``parallel/mesh.py:shard_state``)
the optimizer holds the local shards: its moments are created on them (or
cut to them by ``shard_state``), so they are the shards of the whole
moments, as JAX's Adam state follows its kernels' placement.
"""

from __future__ import annotations

import torch


def build_optimizer(config, params) -> torch.optim.Optimizer:
    params = list(params)
    name = config.optimizer.lower()
    lr, wd = config.lr, config.weight_decay
    capturable = bool(params) and params[0].is_cuda
    if name == "adam":
        if wd:
            return torch.optim.AdamW(params, lr=lr, weight_decay=float(wd),
                                     capturable=capturable)
        return torch.optim.Adam(params, lr=lr, capturable=capturable)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=lr,
                                 weight_decay=float(wd) if wd else 1e-2,
                                 capturable=capturable)
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr)
    raise NameError(f"optimizer {config.optimizer!r} not supported")
