"""The MAML regressor (``wmfml_tpu/models/maml.py:MAMLRegressor``).

Literature encoder -> dim_w feature reshaped to a side x side x 1 "image"
-> 4 blocks of 3x3 stride-1 conv + batch-statistics BN + ReLU -> global
mean over H, W -> linear (+ Tanh for MAMLShapeNet1D).

The forward takes the tasks side by side: images [T, N, H, W, C] and, for
the inner loop, a dict of parameters where every adapted one carries a
leading task axis [T, ...] (the JAX package ``vmap``s a one-task forward
instead). The encoder's stem runs through K1 with per-task weights, layers
2-4 through K3 (``kernels/features.py``); layer 1's 1 -> dim_hidden lift is
a grouped convolution plus the plain masked BN, the mean, the regressor and
the Tanh are plain torch. BN uses batch statistics at train and eval time,
over the task's real context rows (``mask``), or over every row (the
queries: ``mask=None``). In ``compute_dtype`` bfloat16 the forward casts
the images and every parameter to bfloat16 and computes each layer in it,
as the JAX package's ``dtype=`` does (``ops/cast.py``); the parameters, and
the inner loop's per-task copies and gradients, stay float32.

Parameter names are the reference's torchmeta keys
(``wmfml_tpu/ckpt/torch_import.py:352-376``): ``encoder_w.layer{1,2,3}.conv``,
``encoder_w.linear``, ``features.layer{i}.{conv,norm}``, then
``regressor.regressor`` (MAMLShapeNet1D) or ``regressor`` (VanillaMAML).
The inner loop adapts everything but the BN scale/bias (``adaptable``), as
torchmeta does. With ``learn_step_size`` the inner step sizes are
parameters too: ``step_size`` (one scalar) or, per parameter,
``step_size.<name with / for .>``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from wmfml_tpu_torch.kernels.features import maml_features, masked_batch_norm
from wmfml_tpu_torch.nn.encoders import PerTaskLiteratureEncoder
from wmfml_tpu_torch.nn.init import init_parameters
from wmfml_tpu_torch.ops.cast import bmm_bias, conv2d


class _Norm(nn.Module):
    """The reference's ``BatchNorm2d(track_running_stats=False)`` params."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))


class _Block(nn.Module):
    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, 3, 1, 1)
        self.norm = _Norm(c_out)


def step_size_key(name: str) -> str:
    """The ``step_size`` entry of adapted parameter ``name``."""
    return name.replace(".", "/")


class MAMLRegressor(nn.Module):
    compute_dtype = torch.float32

    def __init__(self, dim_w: int = 196, dim_hidden: int = 64,
                 output_dim: int = 2, tanh_out: bool = True,
                 img_size: Sequence[int] = (128, 128, 1),
                 learn_step_size: bool = False,
                 per_param_step_size: bool = False, update_lr: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.side = math.isqrt(dim_w)
        if self.side ** 2 != dim_w:
            raise ValueError(f"dim_w={dim_w} is not a square")
        self.tanh_out = tanh_out
        self.encoder_w = PerTaskLiteratureEncoder(dim_w, img_size)
        self.features = nn.Module()
        for i in range(1, 5):
            self.features.add_module(f"layer{i}", _Block(1 if i == 1 else dim_hidden,
                                                          dim_hidden))
        linear = nn.Linear(dim_hidden, output_dim)
        if tanh_out:          # MetaSequential(MetaLinear) in the reference
            self.regressor = nn.Module()
            self.regressor.regressor = linear
            self.reg_name = "regressor.regressor"
        else:
            self.regressor = linear
            self.reg_name = "regressor"
        init_parameters(self, generator)
        if learn_step_size:
            lr = torch.tensor(float(update_lr))
            if per_param_step_size:
                self.step_size = nn.ParameterDict({
                    step_size_key(k): nn.Parameter(lr.clone())
                    for k, _ in self.named_parameters() if self.adaptable(k)})
            else:
                self.step_size = nn.Parameter(lr)

    @staticmethod
    def adaptable(name: str) -> bool:
        """True for the parameters the inner loop updates."""
        return not (".norm." in name or name.startswith("step_size"))

    def task_params(self, t: int) -> Dict[str, torch.Tensor]:
        """Every network parameter, the adapted ones as per-task copies
        [T, ...] (expanded views of the meta parameters)."""
        return {k: p.expand(t, *p.shape) if self.adaptable(k) else p
                for k, p in self.named_parameters()
                if not k.startswith("step_size")}

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                params: Optional[Dict[str, torch.Tensor]] = None):
        """x [T, N, H, W, C]; mask [T, N] bool (BN over real rows) or None;
        params as from ``task_params`` (default: the module's own).
        Returns [T, N, output_dim]."""
        t, n = x.shape[:2]
        p = self.task_params(t) if params is None else params
        d = self.compute_dtype
        if d != torch.float32:
            x = x.to(d)
            p = {k: v.to(d) for k, v in p.items()}
        enc = {k[len("encoder_w."):]: v for k, v in p.items()
               if k.startswith("encoder_w.")}
        s = self.side
        h = self.encoder_w(x, enc).reshape(t, n, s, s)        # the 1-channel map
        # layer 1, the 1 -> C lift: grouped conv + masked BN + ReLU
        w1 = p["features.layer1.conv.weight"]                 # [T, C, 1, 3, 3]
        h = conv2d(h.transpose(0, 1), w1.flatten(0, 1),
                   p["features.layer1.conv.bias"].flatten(), padding=1,
                   groups=t)                                  # [N, T*C, s, s]
        c = w1.shape[1]
        h = h.reshape(n, t, c, s, s).permute(1, 0, 3, 4, 2)   # [T, N, s, s, C]
        h = F.relu(masked_batch_norm(h, mask, p["features.layer1.norm.weight"],
                                     p["features.layer1.norm.bias"]))
        # layers 2-4: K3, per-task conv weights and biases [T, 3, ...],
        # shared BN scale and bias [3, C]
        blocks = [f"features.layer{i}." for i in (2, 3, 4)]
        h = maml_features(
            h, torch.stack([p[b + "conv.weight"] for b in blocks], 1),
            torch.stack([p[b + "conv.bias"] for b in blocks], 1),
            torch.stack([p[b + "norm.weight"] for b in blocks]),
            torch.stack([p[b + "norm.bias"] for b in blocks]), mask)
        h = h.mean((2, 3))                                    # [T, N, C]
        out = bmm_bias(h, p[f"{self.reg_name}.weight"],
                       p[f"{self.reg_name}.bias"])
        return torch.tanh(out) if self.tanh_out else out
