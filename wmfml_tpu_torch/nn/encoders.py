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

``ResNetTrunk`` is ``wmfml_tpu/nn/encoders.py:ResNetTrunk``: conv5x5 s2
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

``Bottleneck`` is the JAX package's (1x1 -> 3x3 -> 1x1, expansion 4,
three batch-statistics norms in float32), which no shipped configuration
reaches.

``trunk_stem: s2d`` computes conv1, its ReLU and layer1 in phase
(space-to-depth) layout on the same stored parameters
(``s2d_trunk_stem``, the JAX package's ``_s2d_trunk_stem``), where H and W
are multiples of 4; elsewhere, and for any other value, the stock stack
runs. Four cuDNN convolutions through ``ops/cast.py:conv2d``: a 4x4 conv
at stride 2 over the phase-major s2d input, a 2x2 conv over the phase
blocks padded (1, 0) x (1, 0), layer1's 3x3 conv2 and its 1x1 skip on
phase block (0, 0). Their weights are gathered from the stored ones
through fixed index maps (``_S2D_SLOTS``; every entry takes at most one
tap, so the assembly is exact in bfloat16 too), and the
gradient flows back into ``conv1`` and ``resnet.layer1.0.*``.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from wmfml_tpu_torch.kernels.stem import literature_stem
from wmfml_tpu_torch.nn.mlp import Linear
from wmfml_tpu_torch.ops.cast import bmm_bias, conv2d
from wmfml_tpu_torch.parallel import tp

IMG_AGGS = ("mean", "max", "baco", "reshape")


class LiteratureEncoder(nn.Sequential):
    """``conv_bwd``: ``phase`` takes the stem's backward through K1b
    (``kernels/stem.py``: conv1's input gradient by the phase form, the JAX
    package's ``conv3x3_s2_phase``); any other value autodiff of K1's plain
    twin, as the JAX package reads it (``encoders.py:461``)."""

    compute_dtype = torch.float32

    def __init__(self, dim_w: int, img_size: Sequence[int],
                 conv_bwd: str = "xla"):
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
        self.conv_bwd = conv_bwd

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # [B, H, W, C]
        conv0, conv1, conv2, fc = self[0], self[2], self[5], self[8]
        d = self.compute_dtype
        h = literature_stem(*(a.to(d) for a in (
            x, tp.full(conv0.weight), conv0.bias, tp.full(conv1.weight),
            conv1.bias)), conv_bwd=self.conv_bwd)             # [B, H/8, W/8, 48]
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
        return per_task_literature(x, params)


def per_task_literature(x: torch.Tensor,
                        params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The literature stack with per-task weights (``layer{1,2,3}.conv``,
    ``linear``, each [T, ...]) over x [T, N, H, W, C], in x's dtype:
    [T, N, dim_w]."""
    t, n = x.shape[:2]
    h = literature_stem(x.flatten(0, 1), *(params[k].to(x.dtype) for k in (
        "layer1.conv.weight", "layer1.conv.bias", "layer2.conv.weight",
        "layer2.conv.bias")))                                 # [T*N, h, w, 48]
    _, h8, w8, c1 = h.shape
    h = h.reshape(t, n, h8, w8, c1).permute(1, 0, 4, 2, 3).reshape(
        n, t * c1, h8, w8)
    w2 = params["layer3.conv.weight"]
    h = F.relu(conv2d(h, w2.flatten(0, 1),
                      params["layer3.conv.bias"].flatten(), stride=2,
                      padding=1, groups=t))                   # [N, T*64, h/2, w/2]
    h = h.reshape(n, t, -1).transpose(0, 1)                   # CHW flatten
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


def _s2d_slots0() -> torch.Tensor:
    """conv1 (5x5, stride 2) over the s2d input as a 4x4 conv at stride 2:
    for output phase (a, b) and tap (kh, kw), in that order, the slot
    ((((a * 2 + b) * 2 + dh) * 2 + dw) * 4 + th) * 4 + tw of the [a, b,
    dh, dw, th, tw] weight table it lands in. Row p = 2i + a reads rows
    4i + 2a + kh - 2 = 2m + dh: dh = kh mod 2, th = a + (kh - 2 - dh) // 2
    + 1. No slot takes two taps."""
    slots = []
    for a in (0, 1):
        for b in (0, 1):
            for kh in range(5):
                dh, th = kh % 2, a + (kh - 2 - kh % 2) // 2 + 1
                for kw in range(5):
                    dw, tw = kw % 2, b + (kw - 2 - kw % 2) // 2 + 1
                    slots.append(((((a * 2 + b) * 2 + dh) * 2 + dw) * 4
                                  + th) * 4 + tw)
    return torch.tensor(slots)


def _s2d_slots1() -> torch.Tensor:
    """layer1's conv1 (3x3, stride 2) over the phase blocks as a 2x2 conv
    padded (1, 0): for tap (kh, kw), the slot ((a * 2 + b) * 2 + di) * 2
    + dj of the [a, b, di, dj] table, (di, a) being (0, 1), (1, 0), (1, 1)
    for kh = 0, 1, 2."""
    tap = ((0, 1), (1, 0), (1, 1))
    return torch.tensor([((tap[kh][1] * 2 + tap[kw][1]) * 2 + tap[kh][0]) * 2
                         + tap[kw][0] for kh in range(3) for kw in range(3)])


_S2D_SLOTS = (_s2d_slots0(), _s2d_slots1())
_S2D_ON: Dict[tuple, torch.Tensor] = {}     # (which, device) -> slots there


def _place_taps(w: torch.Tensor, which: int, phases: int,
                table: Sequence[int]) -> torch.Tensor:
    """w [O, I, k, k]'s taps, repeated for ``phases`` output phases, put
    into the zero table ``table`` + [O, I] at ``_S2D_SLOTS[which]``: one
    ``index_put``, whose gradient is a gather (no accumulation). The slots
    are copied to the card once, at the first (eager) call."""
    key = (which, w.device)
    if key not in _S2D_ON:
        _S2D_ON[key] = _S2D_SLOTS[which].to(w.device)
    o, i = w.shape[:2]
    taps = w.permute(2, 3, 0, 1).reshape(1, -1, o, i).expand(phases, -1, -1,
                                                             -1)
    flat = w.new_zeros(math.prod(table), o, i).index_put(
        (_S2D_ON[key],), taps.reshape(-1, o, i))
    return flat.reshape(*table, o, i)


def s2d(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, 4C, H/2, W/2], phase-major: channel (dh * 2 +
    dw) * C + c holds x[:, 2i + dh, 2j + dw, c] (the JAX package's
    ``_s2d``; ``pixel_unshuffle`` is c-major)."""
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).permute(
        0, 2, 4, 5, 1, 3).reshape(b, 4 * c, h // 2, w // 2)


def s2d_trunk_stem(x: torch.Tensor, wc, bc, wa, wb, ws) -> torch.Tensor:
    """relu(conv1) and layer1 of the trunk in phase layout (the JAX
    package's ``_s2d_trunk_stem``): x [B, H, W, C] in the compute dtype,
    the stored float32 weights (conv1's wc [64, C, 5, 5] and bc, layer1's
    conv1 wa, conv2 wb, downsample ws) cast to it before the assembly;
    returns [B, 64, H/4, W/4]."""
    ci, c0 = x.shape[-1], wc.shape[0]
    wc, bc, wa, wb, ws = (t.to(x.dtype) for t in (wc, bc, wa, wb, ws))
    k0 = _place_taps(wc, 0, 4, (2, 2, 2, 2, 4, 4)).permute(
        0, 1, 6, 2, 3, 7, 4, 5).reshape(4 * c0, 4 * ci, 4, 4)
    a1 = F.relu(conv2d(s2d(x), k0, bc.repeat(4), stride=2, padding=1))
    k1 = _place_taps(wa, 1, 1, (2, 2, 2, 2)).permute(
        4, 0, 1, 5, 2, 3).reshape(c0, 4 * c0, 2, 2)
    h = F.relu(conv2d(F.pad(a1, (1, 0, 1, 0)), k1, None))
    out = conv2d(h, wb, None, padding=1)
    return F.relu(out + conv2d(a1[:, :c0], ws, None))   # phase (0, 0)


class _BatchNorm(nn.Module):
    """A batch-statistics norm's learnable scale and bias (``weight``,
    ``bias``, as ``BatchNorm2d``'s)."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
        """x [B, C, H, W]: the statistics over (B, H, W) in float32, var
        clamped at 0, the normalisation, scale and bias in x's dtype."""
        mean = x.mean((0, 2, 3), dtype=torch.float32)
        var = (x.square().mean((0, 2, 3), dtype=torch.float32)
               - mean.square()).clamp_min(0.0)
        shape = (1, -1, 1, 1)
        y = ((x - mean.to(x.dtype).reshape(shape))
             * torch.rsqrt(var + eps).to(x.dtype).reshape(shape))
        return (y * self.weight.to(x.dtype).reshape(shape)
                + self.bias.to(x.dtype).reshape(shape))


class Bottleneck(nn.Module):
    """ResNet Bottleneck (``wmfml_tpu/nn/encoders.py:510``, the reference's
    ``networks/ResNet.py:77-119``): 1x1 -> 3x3 (at ``stride``) -> 1x1 with
    expansion 4, each conv bias-free and followed by a batch-statistics
    norm (``bn{1,2,3}``: the reference keeps these three, in training
    mode), ReLU after the first two, the 1x1 ``downsample.0`` at
    ``stride`` where the shape changes, then relu(out + identity). x
    [B, C, H, W] in the compute dtype. No shipped configuration reaches it
    (only ``BasicBlock`` trunks are built)."""

    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 base_width: int = 64):
        super().__init__()
        width = int(planes * (base_width / 64.0))
        out = planes * self.expansion
        self.conv1 = _kaiming_conv(in_planes, width, 1, 1)
        self.bn1 = _BatchNorm(width)
        self.conv2 = _kaiming_conv(width, width, 3, stride, 1)
        self.bn2 = _BatchNorm(width)
        self.conv3 = _kaiming_conv(width, out, 1, 1)
        self.bn3 = _BatchNorm(out)
        self.downsample = (nn.Sequential(_kaiming_conv(in_planes, out, 1,
                                                       stride))
                           if stride != 1 or in_planes != out else None)

    def forward(self, x):
        y = F.relu(self.bn1(_conv(self.conv1, x)))
        y = F.relu(self.bn2(_conv(self.conv2, y)))
        y = self.bn3(_conv(self.conv3, y))
        identity = x if self.downsample is None else _conv(self.downsample[0],
                                                           x)
        return F.relu(y + identity)


class ResNetTrunk(nn.Module):
    """[B, H, W, C] images -> [B, trunk_feature_dim] features in
    ``compute_dtype``; ``trunk_stem`` ``s2d`` runs conv1 and layer1 through
    ``s2d_trunk_stem`` where H and W are multiples of 4."""

    compute_dtype = torch.float32

    def __init__(self, img_agg: str = "max", in_ch: int = 1,
                 trunk_stem: str = "conv"):
        super().__init__()
        if img_agg not in IMG_AGGS:
            raise ValueError(f"img_agg {img_agg!r} not in {IMG_AGGS}")
        self.img_agg = img_agg
        self.trunk_stem = trunk_stem
        self.conv1 = nn.Conv2d(in_ch, 64, 5, 2, 2)
        self.resnet = nn.Module()
        for i in range(1, 5):
            self.resnet.add_module(f"layer{i}",
                                   nn.Sequential(BasicBlockNoBN(64, 2)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype)
        if (self.trunk_stem == "s2d" and x.shape[1] % 4 == 0
                and x.shape[2] % 4 == 0):
            block = self.resnet.layer1[0]
            x = s2d_trunk_stem(x, tp.full(self.conv1.weight),
                               self.conv1.bias, tp.full(block.conv1.weight),
                               tp.full(block.conv2.weight),
                               tp.full(block.downsample[0].weight))
            start = 2
        else:
            x = F.relu(_conv(self.conv1, x.permute(0, 3, 1, 2)))
            start = 1
        for i in range(start, 5):
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
