"""MLP blocks with the reference's torch layouts (``nn.Sequential`` indices).

Their ``Linear`` layers compute in ``compute_dtype`` as Flax's
``Dense(dtype=...)`` does (``ops/cast.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from wmfml_tpu_torch.ops.cast import linear


class Linear(nn.Linear):
    """``nn.Linear`` (same parameters and ``state_dict``) computed in
    ``compute_dtype``: float32 parameters cast to it, bfloat16 out when it
    is bfloat16."""

    compute_dtype = torch.float32

    def forward(self, x):
        return linear(x, self.weight, self.bias, self.compute_dtype)


def mlp(in_dim: int, hidden: Sequence[int], out: int,
        final_activation: Optional[str] = None) -> nn.Sequential:
    """Linear -> ReLU per hidden width, then a linear head (+ Tanh/ReLU).

    ``mlp(i, [h0, h1], o)`` has Linear layers at indices 0, 2, 4."""
    layers = []
    for h in hidden:
        layers += [Linear(in_dim, h), nn.ReLU()]
        in_dim = h
    layers.append(Linear(in_dim, out))
    if final_activation == "tanh":
        layers.append(nn.Tanh())
    elif final_activation == "relu":
        layers.append(nn.ReLU())
    elif final_activation is not None:
        raise ValueError(f"final_activation {final_activation!r}")
    return nn.Sequential(*layers)


class EncoderFC(nn.Module):
    """Set-element encoder: input -> hidden* -> dim_r, ReLU between
    (reference ``EncoderFC``; its Sequential sits under ``layers``)."""

    def __init__(self, in_dim: int, n_hidden_units_r: Sequence[int],
                 dim_r: int):
        super().__init__()
        self.layers = mlp(in_dim, n_hidden_units_r, dim_r)

    def forward(self, x):
        return self.layers(x)
