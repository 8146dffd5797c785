"""Generic torchmeta-style meta-models (``wmfml_tpu/models/meta_models.py``,
the reference's ``networks/models.py:206-266``).

``MetaConvModel``: four blocks of conv3x3 (stride 1) + batch-statistics BN
over the task's real rows + ReLU + 2x2 max pool, then a linear head;
``MetaMLPModel``: an MLP with ReLU hidden layers. The paper's main path uses
neither, and no shipped YAML reaches them; they take the per-task form of
``models/maml.py:MAMLRegressor``, so ``train/maml.py``'s inner loop runs
them as they are: images [T, N, H, W, C], a dict of parameters whose
adapted entries carry a leading task axis [T, ...] (``task_params``), and
``adaptable`` (everything but the BN scale and bias, the JAX package's
``adaptable_param_filter``). The conv model's BN is MAML's
(``kernels/features.py:masked_batch_norm``), its convolutions grouped over
the tasks, its head a batched product; the MLP flattens each image HWC, as
the JAX package does. Both compute in ``compute_dtype`` as
``MAMLRegressor`` does.

Keys are torchmeta's: ``features.layer{i}.{conv,norm}`` and
``classifier`` (conv); ``features.layer{i}.linear`` and ``classifier``
(MLP). The conv model flattens its last map CHW, as the reference does
(``ckpt/jax_params.py`` permutes the JAX head).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from wmfml_tpu_torch.kernels.features import masked_batch_norm
from wmfml_tpu_torch.models.maml import _Block
from wmfml_tpu_torch.nn.init import init_parameters
from wmfml_tpu_torch.ops.cast import bmm_bias, conv2d


class _PerTask(nn.Module):
    """``task_params`` and ``forward_with_kl`` of the per-task form."""

    compute_dtype = torch.float32

    def adaptable(self, name: str) -> bool:
        return ".norm." not in name

    def adaptable_param_filter(self):
        return self.adaptable

    def task_params(self, t: int) -> Dict[str, torch.Tensor]:
        """Every parameter, the adapted ones as per-task copies [T, ...]."""
        return {k: p.expand(t, *p.shape) if self.adaptable(k) else p
                for k, p in self.named_parameters()}

    def _inputs(self, x, params):
        p = self.task_params(x.shape[0]) if params is None else params
        d = self.compute_dtype
        if d != torch.float32:
            x, p = x.to(d), {k: v.to(d) for k, v in p.items()}
        return x, p

    def forward_with_kl(self, x, mask=None, params=None, generator=None):
        """``forward``'s output and a kl of 0.0 (no BBB layer)."""
        return self(x, mask, params, generator), 0.0


class MetaConvModel(_PerTask):
    def __init__(self, out_features: int, hidden_size: int = 64,
                 img_size: Sequence[int] = (32, 32, 1),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        h, w, c = img_size
        self.features = nn.Module()
        for i in range(1, 5):
            self.features.add_module(
                f"layer{i}", _Block(c if i == 1 else hidden_size, hidden_size))
            h, w = h // 2, w // 2
        self.flatten_chw = (hidden_size, h, w)      # what the head consumes
        self.classifier = nn.Linear(hidden_size * h * w, out_features)
        init_parameters(self, generator)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                params: Optional[Dict[str, torch.Tensor]] = None,
                generator=None) -> torch.Tensor:
        """x [T, N, H, W, C]; mask [T, N] bool (BN over real rows) or None;
        returns [T, N, out_features]."""
        t, n = x.shape[:2]
        x, p = self._inputs(x, params)
        h = x.permute(1, 0, 4, 2, 3).flatten(1, 2)            # [N, T*C, H, W]
        for i in range(1, 5):
            b = f"features.layer{i}."
            wc = p[b + "conv.weight"]                         # [T, Co, Ci, 3, 3]
            h = conv2d(h, wc.flatten(0, 1), p[b + "conv.bias"].flatten(),
                       padding=1, groups=t)
            co, hh, ww = wc.shape[1], h.shape[2], h.shape[3]
            y = masked_batch_norm(
                h.reshape(n, t, co, hh, ww).permute(1, 0, 3, 4, 2), mask,
                p[b + "norm.weight"], p[b + "norm.bias"])     # [T, N, h, w, C]
            h = F.max_pool2d(F.relu(y).permute(1, 0, 4, 2, 3).flatten(1, 2),
                             2)                               # [N, T*C, h/2, w/2]
        h = h.reshape(n, t, -1).transpose(0, 1)               # CHW flatten
        return bmm_bias(h, p["classifier.weight"], p["classifier.bias"])


class _Linear(nn.Module):
    """torchmeta's ``layer{i}`` block of an MLP: a ``linear`` child."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.linear = nn.Linear(c_in, c_out)


class MetaMLPModel(_PerTask):
    def __init__(self, in_features: int, out_features: int,
                 hidden_sizes: Sequence[int] = (64, 64),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.features = nn.Module()
        width = in_features
        for i, h in enumerate(hidden_sizes):
            self.features.add_module(f"layer{i + 1}", _Linear(width, h))
            width = h
        self.classifier = nn.Linear(width, out_features)
        self.depth = len(hidden_sizes)
        init_parameters(self, generator)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                params: Optional[Dict[str, torch.Tensor]] = None,
                generator=None) -> torch.Tensor:
        """x [T, N, ...] -> [T, N, out_features]; each item flattened as it
        lies (HWC for channel-last images)."""
        t, n = x.shape[:2]
        x, p = self._inputs(x, params)
        h = x.reshape(t, n, -1)
        for i in range(1, self.depth + 1):
            b = f"features.layer{i}.linear."
            h = F.relu(bmm_bias(h, p[b + "weight"], p[b + "bias"]))
        return bmm_bias(h, p["classifier.weight"], p["classifier.bias"])
