"""Optimizer factory (``wmfml_tpu/train/state.py:build_optimizer``).

Adam by default; a truthy ``weight_decay`` turns Adam into decoupled AdamW
with that decay (optax ``adamw`` and ``torch.optim.AdamW`` take the same
step); ``adamw`` without a decay uses 1e-2; ``sgd`` is plain SGD.
"""

from __future__ import annotations

import torch


def build_optimizer(config, params) -> torch.optim.Optimizer:
    name = config.optimizer.lower()
    lr, wd = config.lr, config.weight_decay
    if name == "adam":
        if wd:
            return torch.optim.AdamW(params, lr=lr, weight_decay=float(wd))
        return torch.optim.Adam(params, lr=lr)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=lr,
                                 weight_decay=float(wd) if wd else 1e-2)
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr)
    raise NameError(f"optimizer {config.optimizer!r} not supported")
