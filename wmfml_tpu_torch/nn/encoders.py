"""The literature image encoder (ShapeNet1D / Pascal1D families).

conv3x3 s2 (C->32) / ReLU / conv3x3 s2 (32->48) / ReLU / maxpool2 /
conv3x3 s2 (48->64) / ReLU / flatten / linear(->dim_w), as
``wmfml_tpu/nn/encoders.py:LiteratureEncoder``. The module is the
reference's ``nn.Sequential``, so its ``state_dict`` keys are
``{0,2,5,8}.{weight,bias}``; its forward runs the first five layers (the
stem) through the fused kernel ``kernels/stem.py`` (K1) and the rest on
cuDNN/cuBLAS. Input is channel-last [B, H, W, C] like the JAX package's;
the flatten is CHW like the reference's.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from wmfml_tpu_torch.kernels.stem import literature_stem


class LiteratureEncoder(nn.Sequential):
    def __init__(self, dim_w: int, img_size: Sequence[int]):
        h, w, c = img_size
        if h % 16 or w % 16:
            raise ValueError(f"literature encoder needs H, W % 16 == 0; "
                             f"got {h}x{w}")
        super().__init__(
            nn.Conv2d(c, 32, 3, 2, 1), nn.ReLU(),
            nn.Conv2d(32, 48, 3, 2, 1), nn.ReLU(), nn.MaxPool2d((2, 2)),
            nn.Conv2d(48, 64, 3, 2, 1), nn.ReLU(), nn.Flatten(),
            nn.Linear(64 * (h // 16) * (w // 16), dim_w))
        self.flatten_chw = (64, h // 16, w // 16)   # what the fc consumes

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # [B, H, W, C]
        conv0, conv1, conv2, fc = self[0], self[2], self[5], self[8]
        h = literature_stem(x, conv0.weight, conv0.bias, conv1.weight,
                            conv1.bias)                       # [B, H/8, W/8, 48]
        h = F.relu(conv2(h.permute(0, 3, 1, 2)))              # [B, 64, H/16, W/16]
        return fc(h.flatten(1))
