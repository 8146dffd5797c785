"""The literature image encoder (ShapeNet1D / Pascal1D families).

conv3x3 s2 (C->32) / ReLU / conv3x3 s2 (32->48) / ReLU / maxpool2 /
conv3x3 s2 (48->64) / ReLU / flatten / linear(->dim_w), as
``wmfml_tpu/nn/encoders.py:LiteratureEncoder``. The module is the
reference's ``nn.Sequential``, so its ``state_dict`` keys are
``{0,2,5,8}.{weight,bias}``; its forward runs the first five layers (the
stem) through the fused kernel ``kernels/stem.py`` (K1) and the rest on
cuDNN/cuBLAS. Input is channel-last [B, H, W, C] like the JAX package's;
the flatten is CHW like the reference's. It computes in ``compute_dtype``
as the JAX package's ``dtype=`` does: the images and the weights cast to it,
and bfloat16 out when it is bfloat16 (``ops/cast.py``).

``PerTaskLiteratureEncoder`` is the same stack as MAML's encoder: the
reference's torchmeta keys (``layer{1,2,3}.conv``, ``linear``) and a
forward over per-task weights [T, ...] and images [T, N, H, W, C], as the
JAX package's ``vmap`` over tasks computes it. The stem runs through K1
with per-task weights, conv2 is a grouped convolution (``groups=T``), the fc
a batched matrix product, all in the dtype of the images and parameters it
is given.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from wmfml_tpu_torch.kernels.stem import literature_stem
from wmfml_tpu_torch.nn.mlp import Linear
from wmfml_tpu_torch.ops.cast import bmm_bias, conv2d


class LiteratureEncoder(nn.Sequential):
    compute_dtype = torch.float32

    def __init__(self, dim_w: int, img_size: Sequence[int]):
        h, w, c = img_size
        if h % 16 or w % 16:
            raise ValueError(f"literature encoder needs H, W % 16 == 0; "
                             f"got {h}x{w}")
        super().__init__(
            nn.Conv2d(c, 32, 3, 2, 1), nn.ReLU(),
            nn.Conv2d(32, 48, 3, 2, 1), nn.ReLU(), nn.MaxPool2d((2, 2)),
            nn.Conv2d(48, 64, 3, 2, 1), nn.ReLU(), nn.Flatten(),
            Linear(64 * (h // 16) * (w // 16), dim_w))
        self.flatten_chw = (64, h // 16, w // 16)   # what the fc consumes

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # [B, H, W, C]
        conv0, conv1, conv2, fc = self[0], self[2], self[5], self[8]
        d = self.compute_dtype
        h = literature_stem(*(a.to(d) for a in (
            x, conv0.weight, conv0.bias, conv1.weight,
            conv1.bias)))                                     # [B, H/8, W/8, 48]
        h = F.relu(conv2d(h.permute(0, 3, 1, 2), conv2.weight, conv2.bias,
                          stride=2, padding=1))               # [B, 64, H/16, W/16]
        return fc(h.flatten(1))


class _Conv(nn.Module):
    """torchmeta's ``layer{i}`` block: a ``conv`` child."""

    def __init__(self, conv: nn.Conv2d):
        super().__init__()
        self.conv = conv


class PerTaskLiteratureEncoder(nn.Module):
    def __init__(self, dim_w: int, img_size: Sequence[int]):
        super().__init__()
        h, w, c = img_size
        if h % 16 or w % 16:
            raise ValueError(f"literature encoder needs H, W % 16 == 0; "
                             f"got {h}x{w}")
        self.layer1 = _Conv(nn.Conv2d(c, 32, 3, 2, 1))
        self.layer2 = _Conv(nn.Conv2d(32, 48, 3, 2, 1))
        self.layer3 = _Conv(nn.Conv2d(48, 64, 3, 2, 1))
        self.linear = nn.Linear(64 * (h // 16) * (w // 16), dim_w)
        self.flatten_chw = (64, h // 16, w // 16)   # what the fc consumes

    def forward(self, x: torch.Tensor,
                params: Dict[str, torch.Tensor]) -> torch.Tensor:
        """x [T, N, H, W, C]; ``params`` maps each parameter name to its
        per-task value [T, ...]. Returns [T, N, dim_w]."""
        t, n = x.shape[:2]
        h = literature_stem(x.flatten(0, 1), *(params[k].to(x.dtype) for k in (
            "layer1.conv.weight", "layer1.conv.bias", "layer2.conv.weight",
            "layer2.conv.bias")))                             # [T*N, h, w, 48]
        _, h8, w8, c1 = h.shape
        h = h.reshape(t, n, h8, w8, c1).permute(1, 0, 4, 2, 3).reshape(
            n, t * c1, h8, w8)
        w2 = params["layer3.conv.weight"]
        h = F.relu(conv2d(h, w2.flatten(0, 1),
                          params["layer3.conv.bias"].flatten(), stride=2,
                          padding=1, groups=t))               # [N, T*64, h/2, w/2]
        h = h.reshape(n, t, -1).transpose(0, 1)               # CHW flatten
        return bmm_bias(h, params["linear.weight"], params["linear.bias"])
