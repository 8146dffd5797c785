"""Parameter initialisers drawn from an explicit ``torch.Generator``.

The same distributions as the reference torch models and the JAX package
(``wmfml_tpu/nn/init.py``):

  * ``nn.Linear`` / ``nn.Conv2d``: W, b ~ U(+-1/sqrt(fan_in)) (torch default);
  * attention projections (``AttnLinear``): W ~ N(0, fan_in^-0.5), default
    bias;
  * the ResNet trunk's block convolutions (``kaiming_fan_out`` set):
    W ~ N(0, sqrt(2 / fan_out)), the reference ResNet's kaiming_normal
    (the JAX package truncates it at two standard deviations);
  * Bayes-by-Backprop layers: mu ~ N(0, 0.1), rho ~ -3 + N(0, 0.1)
    (``nn/bbb.py:init_bbb``).

Modules are built on the CPU, initialised here from a seeded CPU generator
and then moved, so one seed gives the same weights on every device.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from wmfml_tpu_torch.nn.bbb import BBBLayer, init_bbb
from wmfml_tpu_torch.nn.mlp import Linear


class AttnLinear(nn.Module):
    """Reference ``AttnLinear``: a ``linear`` child with N(0, fan_in^-0.5) W
    (``nn/mlp.py:Linear``)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.linear = Linear(in_dim, out_dim)

    def forward(self, x):
        return self.linear(x)


@torch.no_grad()
def init_parameters(module: nn.Module, generator: torch.Generator):
    """Re-draw every Linear/Conv2d (and AttnLinear, BBB) parameter of
    ``module``."""
    for m in module.modules():
        if isinstance(m, BBBLayer):
            init_bbb(m, generator)
        elif getattr(m, "kaiming_fan_out", False):     # bias-free
            fan_out = m.weight.shape[0] * m.weight[0, 0].numel()
            m.weight.normal_(0.0, math.sqrt(2.0 / fan_out),
                             generator=generator)
        elif isinstance(m, (nn.Linear, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
    for m in module.modules():
        if isinstance(m, AttnLinear):
            w = m.linear.weight
            w.normal_(0.0, w.shape[1] ** -0.5, generator=generator)
