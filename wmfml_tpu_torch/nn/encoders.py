"""The image encoders: the literature encoder (ShapeNet1D / Pascal1D
families) and the ResNet trunk (the LargeCNP family: Distractor,
ShapeNet3D).

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

``ResNetTrunk`` is ``wmfml_tpu/nn/encoders.py:ResNetTrunk`` with its stock
``conv`` stem (the phase-layout ``s2d`` stem is ROADMAP.md B8b): conv5x5 s2
(C -> 64) / ReLU, then four ``BasicBlockNoBN`` stages of 64 channels at
stride 2, then ``img_agg``: mean -> the global average (64 features),
max / baco -> ``adaptive_max_pool`` to 2 x 2 (256), reshape -> the whole map
(64 h w). Its keys are the reference ImageEncoder's (``conv1``, then
``resnet.layer{i}.0.{conv1,conv2,downsample.0}``); its maps are flattened
CHW, as the reference flattens them (the JAX package flattens HWC:
``ckpt/jax_params.py`` permutes every consumer). These are plain dense
convolutions, which the JAX package leaves to XLA outside any Pallas
kernel; here cuDNN runs them. The trunk computes in ``compute_dtype`` as
the JAX package's ``ResNetTrunk(dtype=...)`` does: every convolution
through ``ops/cast.py:conv2d`` (the images and the float32 weights cast to
it, the product rounded, then conv1's bias added), the residual add, the
ReLUs and the pooling in that dtype; the parameters stay float32, so the
weight carry is the same in both. ``load_pretrained_resnet`` copies
a torchvision-style ResNet's compatible block convolutions into a trunk
from a ``state_dict`` the caller has loaded; nothing is fetched.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from wmfml_tpu_torch.kernels.stem import literature_stem
from wmfml_tpu_torch.nn.mlp import Linear
from wmfml_tpu_torch.ops.cast import bmm_bias, conv2d

IMG_AGGS = ("mean", "max", "baco", "reshape")


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


def adaptive_max_pool(x: torch.Tensor, out_hw: int = 2) -> torch.Tensor:
    """AdaptiveMaxPool2d((2, 2)) of [B, C, H, W] maps with even H and W
    (``wmfml_tpu/nn/encoders.py:adaptive_max_pool``)."""
    b, c, h, w = x.shape
    if h % out_hw or w % out_hw:
        raise ValueError(f"adaptive_max_pool needs H, W % {out_hw} == 0; "
                         f"got {h}x{w}")
    return x.reshape(b, c, out_hw, h // out_hw, out_hw, w // out_hw).amax(
        (3, 5))


def _kaiming_conv(c_in: int, c_out: int, k: int, stride: int,
                  padding: int = 0) -> nn.Conv2d:
    """A bias-free conv that ``init_parameters`` draws from
    N(0, sqrt(2 / fan_out)), the reference ResNet's kaiming_normal."""
    conv = nn.Conv2d(c_in, c_out, k, stride, padding, bias=False)
    conv.kaiming_fan_out = True
    return conv


def _conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` on x in x's dtype (``ops/cast.py:conv2d``)."""
    return conv2d(x, conv.weight, conv.bias, stride=conv.stride,
                  padding=conv.padding)


class BasicBlockNoBN(nn.Module):
    """ResNet BasicBlock without batch norm (``BasicBlockNoBN``):
    relu(conv2(relu(conv1(x))) + downsample(x)), conv1 3x3 at ``stride``,
    the downsample a 1x1 conv at ``stride`` (``downsample.0``), in x's
    dtype (the trunk's ``compute_dtype``)."""

    def __init__(self, planes: int = 64, stride: int = 2):
        super().__init__()
        self.conv1 = _kaiming_conv(planes, planes, 3, stride, 1)
        self.conv2 = _kaiming_conv(planes, planes, 3, 1, 1)
        self.downsample = nn.Sequential(_kaiming_conv(planes, planes, 1,
                                                      stride))

    def forward(self, x):
        out = F.relu(_conv(self.conv1, x))
        return F.relu(_conv(self.conv2, out) + _conv(self.downsample[0], x))


class ResNetTrunk(nn.Module):
    """[B, H, W, C] images -> [B, trunk_feature_dim] features in
    ``compute_dtype``."""

    compute_dtype = torch.float32

    def __init__(self, img_agg: str = "max", in_ch: int = 1):
        super().__init__()
        if img_agg not in IMG_AGGS:
            raise ValueError(f"img_agg {img_agg!r} not in {IMG_AGGS}")
        self.img_agg = img_agg
        self.conv1 = nn.Conv2d(in_ch, 64, 5, 2, 2)
        self.resnet = nn.Module()
        for i in range(1, 5):
            self.resnet.add_module(f"layer{i}",
                                   nn.Sequential(BasicBlockNoBN(64, 2)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(_conv(self.conv1,
                         x.permute(0, 3, 1, 2).to(self.compute_dtype)))
        for i in range(1, 5):
            x = getattr(self.resnet, f"layer{i}")(x)
        if self.img_agg == "mean":
            return x.mean((2, 3))
        if self.img_agg in ("max", "baco"):
            x = adaptive_max_pool(x, 2)
        return x.flatten(1)


def load_pretrained_resnet(trunk: ResNetTrunk, state_dict_numpy):
    """Copy every ``layer{i}.0.conv{j}.weight`` of a torchvision-style
    ResNet ``state_dict`` (numpy arrays, OIHW) whose shape fits into
    ``trunk`` (``wmfml_tpu/nn/encoders.py:566 load_pretrained_resnet``);
    return the keys it skipped. The reference's own pretrained branch loads
    resnet18 strictly into its modified trunk and fails; this hook copies
    what fits and says what did not."""
    skipped = []
    for key, val in state_dict_numpy.items():
        parts = key.split(".")
        if (len(parts) == 4 and parts[0] in {f"layer{i}" for i in range(1, 5)}
                and parts[1] == "0" and parts[2] in ("conv1", "conv2")
                and parts[3] == "weight"):
            conv = getattr(getattr(trunk.resnet, parts[0])[0], parts[2])
            if tuple(conv.weight.shape) == tuple(val.shape):
                with torch.no_grad():
                    conv.weight.copy_(torch.as_tensor(val))
                continue
        skipped.append(key)
    return skipped


def trunk_feature_dim(img_agg: str, img_hw: int) -> int:
    """Features of ``ResNetTrunk`` for a square input of side ``img_hw``."""
    if img_agg == "mean":
        return 64
    if img_agg in ("max", "baco"):
        return 64 * 4
    if img_agg == "reshape":
        return 64 * (img_hw // 32) ** 2
    raise ValueError(f"img_agg {img_agg!r} not in {IMG_AGGS}")


def trunk_chw(img_agg: str, img_hw: int):
    """(C, h, w) of the map the trunk flattens, or None where ``mean``
    leaves no spatial structure."""
    if img_agg == "mean":
        return None
    hw = 2 if img_agg in ("max", "baco") else img_hw // 32
    return (64, hw, hw)
