"""Bayes-by-Backprop layers (meta-regularization, "MR"): the counterpart of
``wmfml_tpu/nn/bbb.py``.

As there, and as the reference's ``BBBLinear`` / ``BBBConv2d``:

  * every call draws ``w = mu + eps * softplus(rho)`` with eps ~ N(0, 1),
    the bias likewise, evaluation included (the reference samples at
    evaluation too, so an MR evaluation is stochastic);
  * init: mu ~ N(0, 0.1), rho ~ -3 + N(0, 0.1) (``init_bbb``, which
    ``nn/init.py:init_parameters`` calls);
  * each layer returns ``(y, kl)``: KL(q || N(0, 0.1)) in closed form,
    summed over its weight and bias in float32;
  * in ``compute_dtype`` bfloat16 the sampled ``w`` and the input are cast
    after sampling and the bias is added in y's dtype, as Flax's
    ``dtype=`` computes it (``ops/cast.py``).

The draws come from ``noise``: a ``torch.Generator`` on the tensors'
device (the trainer's, which a CUDA graph capture registers, so every
replay draws new weights), or an ``EpsFeed`` that hands out given draws in
call order (parity tests, and the card-against-CPU checks, which draw once
and give both devices the same ``eps``). A layer draws its weight's eps,
then its bias's.

``BBBLiteratureEncoder`` is the literature encoder (``BBBEncoder``,
``networks/CNPMR.py:39-52``) with the reference's keys
``net.layer{1,2,3}.conv`` and ``net.linear``: its stem (conv0, ReLU,
conv1, ReLU, 2x2 max pool) runs through K1 (``kernels/stem.py``) on the
sampled weights, conv2 on cuDNN and the fc on cuBLAS, as
``nn/encoders.py:LiteratureEncoder``; ``per_task`` draws one sample per
task (MAMLMR) and runs as ``PerTaskLiteratureEncoder`` (K1 per task, a
grouped conv2, a batched fc).

``BBBResNetTrunk`` is ANPMRShapeNet3D's trunk (``networks/ANPMRShapeNet3D
.py:30-90``): a 5x5 stride-2 BBB conv and four stride-2 blocks of biased
BBB convs whose "downsample" is, as in the reference, a 3x3 stride-2 conv
(``net.layer1.conv``, ``net.layer{2..5}.{conv1,conv2,downsample.0}``),
then ``img_agg`` and a CHW flatten, like ``ResNetTrunk``. Its convolutions
run on cuDNN (``ops/cast.py:conv2d``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from wmfml_tpu_torch.kernels.stem import literature_stem
from wmfml_tpu_torch.nn.encoders import (IMG_AGGS, adaptive_max_pool,
                                         per_task_literature)
from wmfml_tpu_torch.ops.cast import conv2d, linear
from wmfml_tpu_torch.parallel import mesh, tp

PRIOR_MU = 0.0
PRIOR_SIGMA = 0.1


class EpsFeed:
    """Standard-normal draws for the BBB layers, handed out in call order.

    ``EpsFeed(draws)`` replays the given tensors (each moved to the
    layer's device); ``EpsFeed(generator=g)`` draws from ``g`` and keeps
    every draw in ``draws``, so that another device can replay them."""

    def __init__(self, draws: Optional[Sequence[torch.Tensor]] = None,
                 generator: Optional[torch.Generator] = None):
        self.draws = list(draws or [])
        self.generator = generator
        self.used = 0

    def normal(self, shape, device) -> torch.Tensor:
        if self.generator is not None:
            eps = torch.randn(shape, generator=self.generator, device=device)
            self.draws.append(eps)
            return eps
        if self.used >= len(self.draws):
            raise IndexError(f"EpsFeed: draw {self.used} asked for, "
                             f"{len(self.draws)} given")
        eps = self.draws[self.used]
        self.used += 1
        if tuple(eps.shape) != tuple(shape):
            raise ValueError(f"EpsFeed: draw {self.used - 1} has shape "
                             f"{tuple(eps.shape)}, the layer asks for "
                             f"{tuple(shape)}")
        return eps.to(device)


def draw_normal(noise, shape, device) -> torch.Tensor:
    if noise is None:
        raise ValueError("a BBB layer samples its weights at every call: "
                         "pass a torch.Generator or an EpsFeed")
    if isinstance(noise, torch.Generator):
        return torch.randn(shape, generator=noise, device=device)
    return noise.normal(shape, device)


def gaussian_kl(mu_q, sig_q, mu_p: float = PRIOR_MU,
                sig_p: float = PRIOR_SIGMA) -> torch.Tensor:
    """KL(q || p) summed (``networks/bbb/BBBLinear.py:32-34``)."""
    return 0.5 * torch.sum(
        2.0 * torch.log(sig_p / sig_q) - 1.0 + (sig_q / sig_p) ** 2
        + ((mu_p - mu_q) / sig_p) ** 2)


class BBBLayer(nn.Module):
    """A weight and a bias posterior (``W_mu``, ``W_rho``, ``bias_mu``,
    ``bias_rho``, torch layouts)."""

    def __init__(self, w_shape: Sequence[int]):
        super().__init__()
        self.W_mu = nn.Parameter(torch.zeros(*w_shape))
        self.W_rho = nn.Parameter(torch.zeros(*w_shape))
        self.bias_mu = nn.Parameter(torch.zeros(w_shape[0]))
        self.bias_rho = nn.Parameter(torch.zeros(w_shape[0]))

    def sample(self, noise, lead: Sequence[int] = ()):
        """(w, b, kl): one sample of the weight and the bias, with
        ``lead`` (e.g. (T,)) samples stacked in front, and the KL of the
        posterior (the same for every sample)."""
        w_sig, b_sig = F.softplus(self.W_rho), F.softplus(self.bias_rho)
        lead = tuple(lead)
        # a model shard (parallel/tp.py) draws for the whole weight and
        # keeps its rows; its KL sums over the model group
        shard = tp.shard_of(self.W_mu)
        whole = tuple(self.W_mu.shape) if shard is None else shard[2]
        eps = tp.sample_rows(draw_normal(noise, lead + whole,
                                         self.W_mu.device), self.W_mu)
        w = tp.mark(self.W_mu + eps * w_sig, self.W_mu)
        b = self.bias_mu + draw_normal(noise, lead + tuple(self.bias_mu.shape),
                                       self.bias_mu.device) * b_sig
        kl_w = gaussian_kl(self.W_mu, w_sig)
        if shard is not None:
            kl_w = tp.model_sum(kl_w, shard[0])
        return w, b, kl_w + gaussian_kl(self.bias_mu, b_sig)


class BBBLinear(BBBLayer):
    """[.., in] -> ([.., out], kl); W_mu [out, in]."""

    compute_dtype = torch.float32

    def __init__(self, in_features: int, out_features: int):
        super().__init__((out_features, in_features))

    def forward(self, x, noise):
        w, b, kl = self.sample(noise)
        return linear(x, w, b, self.compute_dtype), kl


class BBBConv(BBBLayer):
    """NCHW in x's dtype -> (y, kl); W_mu [out, in, k, k]."""

    def __init__(self, c_in: int, c_out: int, k: int, stride: int,
                 padding: int):
        super().__init__((c_out, c_in, k, k))
        self.stride, self.padding = stride, padding

    def forward(self, x, noise):
        w, b, kl = self.sample(noise)
        return conv2d(x, w, b, stride=self.stride, padding=self.padding), kl


@torch.no_grad()
def init_bbb(layer: BBBLayer, generator: torch.Generator):
    """mu ~ N(0, 0.1), rho ~ -3 + N(0, 0.1) (``wmfml_tpu/nn/bbb.py:27-32``),
    in the order W_mu, W_rho, bias_mu, bias_rho."""
    for p, mean in ((layer.W_mu, 0.0), (layer.W_rho, -3.0),
                    (layer.bias_mu, 0.0), (layer.bias_rho, -3.0)):
        p.normal_(0.0, 0.1, generator=generator).add_(mean)


class _Layer(nn.Module):
    """The reference's ``layer{i}`` block: a ``conv`` child."""

    def __init__(self, conv: BBBConv):
        super().__init__()
        self.conv = conv


class BBBLiteratureEncoder(nn.Module):
    compute_dtype = torch.float32

    def __init__(self, dim_w: int, img_size: Sequence[int]):
        super().__init__()
        h, w, c = img_size
        if h % 16 or w % 16:
            raise ValueError(f"literature encoder needs H, W % 16 == 0; "
                             f"got {h}x{w}")
        self.net = nn.Module()
        self.net.layer1 = _Layer(BBBConv(c, 32, 3, 2, 1))
        self.net.layer2 = _Layer(BBBConv(32, 48, 3, 2, 1))
        self.net.layer3 = _Layer(BBBConv(48, 64, 3, 2, 1))
        self.net.linear = BBBLinear(64 * (h // 16) * (w // 16), dim_w)
        self.flatten_chw = (64, h // 16, w // 16)   # what the fc consumes

    def _samples(self, noise, lead=()):
        layers = (self.net.layer1.conv, self.net.layer2.conv,
                  self.net.layer3.conv, self.net.linear)
        out, kl = [], 0.0
        for layer in layers:
            w, b, k = layer.sample(noise, lead)
            out += [w, b]
            kl = kl + k
        return out, kl

    def forward(self, x: torch.Tensor, noise):
        """x [B, H, W, C] -> ([B, dim_w], kl), one sample for the batch."""
        (w0, b0, w1, b1, w2, b2, wf, bf), kl = self._samples(noise)
        d = self.compute_dtype
        h = literature_stem(*(a.to(d) for a in (x, tp.full(w0), b0,
                                                tp.full(w1), b1)))
        h = F.relu(conv2d(h.permute(0, 3, 1, 2), w2, b2, stride=2,
                          padding=1))                         # [B, 64, H/16, W/16]
        return linear(h.flatten(1), wf, bf, d), kl

    def per_task(self, x: torch.Tensor, noise):
        """x [T, N, H, W, C] in the compute dtype -> ([T, N, dim_w], kl),
        one sample per task; K1 reads the T samples per task. Under a
        data-parallel mesh the samples are drawn for the whole batch's
        tasks and this rank's are kept (``parallel/mesh.py``)."""
        ctx = mesh.sharded()
        if ctx is None:
            samples, kl = self._samples(noise, (x.shape[0],))
        else:
            samples, kl = self._samples(noise, (ctx.widen(x.shape[0]),))
            samples = [ctx.local(s) for s in samples]
        names = ("layer1.conv.weight", "layer1.conv.bias",
                 "layer2.conv.weight", "layer2.conv.bias",
                 "layer3.conv.weight", "layer3.conv.bias", "linear.weight",
                 "linear.bias")
        return per_task_literature(x, dict(zip(names, samples))), kl


class BBBBlock(nn.Module):
    """relu(conv2(relu(conv1(x))) + downsample(x)), every conv a biased
    BBB conv, the downsample 3x3 at stride 2 (the reference's quirk)."""

    def __init__(self, planes: int = 64):
        super().__init__()
        self.conv1 = BBBConv(planes, planes, 3, 2, 1)
        self.conv2 = BBBConv(planes, planes, 3, 1, 1)
        self.downsample = nn.Sequential(BBBConv(planes, planes, 3, 2, 1))

    def forward(self, x, noise):
        y, kl1 = self.conv1(x, noise)
        y, kl2 = self.conv2(F.relu(y), noise)
        idn, kl3 = self.downsample[0](x, noise)
        return F.relu(y + idn), kl1 + kl2 + kl3


class BBBResNetTrunk(nn.Module):
    """[B, H, W, C] images -> ([B, trunk_feature_dim], kl) in
    ``compute_dtype``."""

    compute_dtype = torch.float32

    def __init__(self, img_agg: str = "reshape", in_ch: int = 3):
        super().__init__()
        if img_agg not in IMG_AGGS:
            raise ValueError(f"img_agg {img_agg!r} not in {IMG_AGGS}")
        self.img_agg = img_agg
        self.net = nn.Module()
        self.net.layer1 = _Layer(BBBConv(in_ch, 64, 5, 2, 2))
        for i in range(2, 6):
            self.net.add_module(f"layer{i}", BBBBlock(64))

    def forward(self, x: torch.Tensor, noise):
        x, kl = self.net.layer1.conv(
            x.permute(0, 3, 1, 2).to(self.compute_dtype), noise)
        x = F.relu(x)
        for i in range(2, 6):
            x, k = getattr(self.net, f"layer{i}")(x, noise)
            kl = kl + k
        if self.img_agg == "mean":
            return x.mean((2, 3)), kl
        if self.img_agg in ("max", "baco"):
            x = adaptive_max_pool(x, 2)
        return x.flatten(1), kl
