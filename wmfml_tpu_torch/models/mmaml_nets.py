"""MMAML's two networks (``wmfml_tpu/models/mmaml_nets.py``) and the pair
the registry builds.

``GatedConvNet``, the base learner the inner loop adapts: four 3x3
stride-2 pad-1 convolutions (``num_channels`` x 1, 2, 4, 8 channels), each
followed by batch-statistics BN without affine over the task's real rows
(``kernels/features.py:masked_batch_norm``, one pass as the JAX function),
the modulation by the task's embedding (``affine``: FiLM, x (1 + gamma) +
beta with gamma = e[:C], beta = e[C:2C]; ``sigmoid_gate``: x sigmoid(e[:C]);
``softmax``: x softmax(e)[:C]) and ReLU; then the spatial mean, the
``classifier`` and Tanh (the registry's only form; the JAX package's
``tanh_out`` is always on there).

``ConvEmbeddingNet``, the task encoder: four 3x3 stride-2 convolutions with
shared weights (one convolution over every image of every task), BN per
task with its affine ``bn{i}`` scale and bias, ReLU, the spatial mean;
then ``linear`` -> ``hidden_size`` + ReLU and the average (or, with
``embedding_pooling: max``, the maximum) over the task's real instances,
and one head ``_embeddings.{i}`` a modulated layer. Channels double from
``num_channels`` up to 256. With ``rnn_aggregation`` a bidirectional
two-layer GRU over the
instances replaces ``linear`` and the pooling: each direction's carry holds
on masked steps, so a padded episode gives what its truncation gives, and
the readout is the two directions' final carries (``_gru_aggregate``). The
GRU's parameters are ``nn.GRU``'s (``_rnn``); it runs as its equations, a
step at a time, so that the mask can hold the carry. Flax's ``GRUCell``
has no bias on the hidden side's r and z products, so the r and z thirds
of each ``bias_hh`` start at 0 and never enter the function: their
gradient is 0 and a trained model keeps them at 0.

The JAX package ``vmap``s one task's forward; here the tasks sit side by
side, images [T, N, H, W, C]. The inner loop adapts every parameter of the
gated net, so its forward takes a dict of per-task parameters [T, ...]
(``task_params``) and runs each convolution as one grouped convolution
(groups = T) and the classifier as a batched product. In ``compute_dtype``
bfloat16 both nets cast the images and their parameters to bfloat16 and
compute each layer in it, as the JAX package's ``dtype=`` does
(``ops/cast.py``); the parameters stay float32.

``MMAMLBundle`` holds the two as ``model`` and ``embedding_model``, so that
its ``state_dict`` has the keys of the reference's combined checkpoint
(``wmfml_tpu/ckpt/torch_import.py:import_mmaml``):
``model.features.layer{i}_conv``, ``model.classifier.fully_connected``,
``embedding_model.conv.{conv,bn}{i}``, ``embedding_model.linear``,
``embedding_model._embeddings.{i}`` and, with ``rnn_aggregation``,
``embedding_model._rnn.*``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from wmfml_tpu_torch.kernels.features import masked_batch_norm
from wmfml_tpu_torch.models.maml import _Norm
from wmfml_tpu_torch.nn.init import init_parameters
from wmfml_tpu_torch.nn.mlp import Linear
from wmfml_tpu_torch.ops.cast import bmm_bias, conv2d, linear

CONDITIONS = ("affine", "sigmoid_gate", "softmax")


def _per_task_layout(h: torch.Tensor, t: int) -> torch.Tensor:
    """[N, T * C, h, w] -> the view [T, N, h, w, C] that the BN takes."""
    n, tc, hh, ww = h.shape
    return h.view(n, t, tc // t, hh, ww).permute(1, 0, 3, 4, 2)


class GatedConvNet(nn.Module):
    compute_dtype = torch.float32

    def __init__(self, output_dim: int = 2, num_channels: int = 32,
                 condition_type: str = "affine", in_channels: int = 1):
        super().__init__()
        if condition_type not in CONDITIONS:
            raise ValueError(f"Unrecognized conditional layer type "
                             f"{condition_type}")
        self.condition_type = condition_type
        self.features = nn.Module()
        c_in = in_channels
        for i in range(4):
            c_out = num_channels * 2 ** i
            self.features.add_module(f"layer{i + 1}_conv",
                                     nn.Conv2d(c_in, c_out, 3, 2, 1))
            c_in = c_out
        self.classifier = nn.Module()
        self.classifier.fully_connected = nn.Linear(c_in, output_dim)

    def task_params(self, t: int) -> Dict[str, torch.Tensor]:
        """Every parameter as per-task copies [T, ...] (expanded views of
        the meta parameters): the inner loop adapts them all."""
        return {k: p.expand(t, *p.shape) for k, p in self.named_parameters()}

    def _condition(self, x, e):
        """x [T, N, h, w, C] modulated by the tasks' embeddings e [T, D]."""
        if e is None:
            return x
        c = x.shape[-1]
        if self.condition_type == "affine":
            gamma, beta = e[:, None, None, None, :c], e[:, None, None, None,
                                                         c:2 * c]
            return x * (1.0 + gamma) + beta
        gate = torch.sigmoid(e) if self.condition_type == "sigmoid_gate" \
            else torch.softmax(e, dim=-1)
        return x * gate[:, None, None, None, :c]

    def forward(self, x: torch.Tensor,
                embeddings: Optional[Sequence[torch.Tensor]] = None,
                mask: Optional[torch.Tensor] = None,
                params: Optional[Dict[str, torch.Tensor]] = None):
        """x [T, N, H, W, C]; embeddings the 4 per-task vectors [T, D_i] or
        None (no modulation); mask [T, N] bool (BN over real rows) or None;
        params as from ``task_params`` (default: the module's own). Returns
        [T, N, output_dim]."""
        t, n = x.shape[:2]
        p = self.task_params(t) if params is None else params
        d = self.compute_dtype
        if d != torch.float32:
            x = x.to(d)
            p = {k: v.to(d) for k, v in p.items()}
        h = x.permute(1, 0, 4, 2, 3).flatten(1, 2)             # [N, T*C, H, W]
        for i in range(4):
            name = f"features.layer{i + 1}_conv"
            w = p[f"{name}.weight"]                            # [T, Co, Ci, 3, 3]
            h = conv2d(h, w.flatten(0, 1), p[f"{name}.bias"].flatten(),
                       stride=2, padding=1, groups=t)
            y = masked_batch_norm(_per_task_layout(h, t), mask)
            y = F.relu(self._condition(
                y, None if embeddings is None else embeddings[i]))
            # elementwise results keep the view's strides: back to
            # [N, T*C, h, w] without a copy
            h = y.permute(1, 0, 4, 2, 3).flatten(1, 2)
        out = bmm_bias(y.mean((2, 3)),                         # [T, N, C]
                       p["classifier.fully_connected.weight"],
                       p["classifier.fully_connected.bias"])
        return torch.tanh(out)


class ConvEmbeddingNet(nn.Module):
    compute_dtype = torch.float32

    def __init__(self, embedding_dims: Sequence[int] = (64, 128, 256, 512),
                 num_channels: int = 32, hidden_size: int = 128,
                 embedding_pooling: str = "avg",
                 rnn_aggregation: bool = False, in_channels: int = 1):
        super().__init__()
        if embedding_pooling not in ("avg", "max"):
            raise ValueError(f"embedding_pooling {embedding_pooling!r}")
        self.pooling = embedding_pooling
        self.rnn_aggregation = rnn_aggregation
        self.conv = nn.Module()
        c_in = in_channels
        for i in range(4):
            c_out = min(256, num_channels * 2 ** i)
            self.conv.add_module(f"conv{i + 1}", nn.Conv2d(c_in, c_out, 3, 2, 1))
            self.conv.add_module(f"bn{i + 1}", _Norm(c_out))
            c_in = c_out
        if rnn_aggregation:
            self._rnn = nn.GRU(c_in, hidden_size, 2, bidirectional=True)
            head_in = 2 * hidden_size
        else:
            self.linear = Linear(c_in, hidden_size)
            head_in = hidden_size
        self._embeddings = nn.ModuleList(Linear(head_in, dim)
                                         for dim in embedding_dims)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
        """x [T, N, H, W, C]; mask [T, N] bool or None -> the per-task
        embeddings, one [T, D_i] a head."""
        t, n = x.shape[:2]
        d = self.compute_dtype
        h = x.to(d).flatten(0, 1).permute(0, 3, 1, 2)         # [T*N, C, H, W]
        for i in range(1, 5):
            conv, bn = getattr(self.conv, f"conv{i}"), getattr(self.conv,
                                                               f"bn{i}")
            h = conv2d(h, conv.weight, conv.bias, stride=2, padding=1)
            y = h.view(t, n, *h.shape[1:]).permute(0, 1, 3, 4, 2)
            y = F.relu(masked_batch_norm(y, mask, bn.weight.to(d),
                                         bn.bias.to(d)))
            h = y.permute(0, 1, 4, 2, 3).flatten(0, 1)
        feat = y.mean((2, 3))                                  # [T, N, C]
        if self.rnn_aggregation:
            pooled = self._gru_aggregate(feat, mask)
        else:
            h = F.relu(self.linear(feat))
            pooled = self._pool(h, mask)
        return [head(pooled) for head in self._embeddings]

    def _pool(self, h, mask):
        """The task's instances [T, N, F] -> [T, F], over its real rows."""
        if mask is None:
            return h.mean(1) if self.pooling == "avg" else h.amax(1)
        m = mask[..., None].to(h.dtype)
        if self.pooling == "avg":
            return (h * m).sum(1) / m.sum(1).clamp_min(1.0)
        return torch.where(m > 0, h, float("-inf")).amax(1)

    def _gru_aggregate(self, x, mask):
        """Bidirectional GRU over the instance axis, x [T, N, F] ->
        [T, 2 * hidden]: layer l > 0 reads the concatenated outputs of
        layer l - 1; each direction's carry holds where ``mask`` is False;
        the readout is the final carry of each direction of the last
        layer (the reference's cat(forward output at the last step,
        backward output at step 0))."""
        rnn, d = self._rnn, self.compute_dtype
        m = (torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)
             if mask is None else mask)
        h = x
        for layer in range(rnn.num_layers):
            outs, finals = [], []
            for suffix in ("", "_reverse"):
                w_ih, w_hh, b_ih, b_hh = (
                    getattr(rnn, f"{name}_l{layer}{suffix}")
                    for name in ("weight_ih", "weight_hh", "bias_ih",
                                 "bias_hh"))
                b_hh = torch.cat([b_hh.new_zeros(2 * rnn.hidden_size),
                                  b_hh[2 * rnn.hidden_size:]])  # b_hr = b_hz = 0
                rev = bool(suffix)
                seq, msk = (h.flip(1), m.flip(1)) if rev else (h, m)
                gi = linear(seq, w_ih, b_ih, d).chunk(3, -1)   # r, z, n
                carry = seq.new_zeros(seq.shape[0], rnn.hidden_size)
                ys = []
                for s in range(seq.shape[1]):
                    gh = linear(carry, w_hh, b_hh, d).chunk(3, -1)
                    r = torch.sigmoid(gi[0][:, s] + gh[0])
                    z = torch.sigmoid(gi[1][:, s] + gh[1])
                    cand = torch.tanh(gi[2][:, s] + r * gh[2])
                    new = (1.0 - z) * cand + z * carry
                    carry = torch.where(msk[:, s, None], new, carry)
                    ys.append(carry)
                ys = torch.stack(ys, 1)
                outs.append(ys.flip(1) if rev else ys)
                finals.append(carry)
            h = torch.cat(outs, -1)
        return torch.cat(finals, -1)


class MMAMLBundle(nn.Module):
    """The two networks of a MMAML method (``wmfml_tpu/train/mmaml.py:
    MMAMLBundle``), their weights drawn from ``generator``: convolutions
    and linear layers as ``nn/init.py`` draws them, BN scale 1 and bias 0,
    the GRU's weights and biases U(+-1/sqrt(hidden)) as ``nn.GRU``'s but
    for the hidden side's r and z biases, which are 0 as in Flax."""

    def __init__(self, output_dim: int = 2, num_channels: int = 32,
                 condition_type: str = "affine",
                 embedding_dims: Sequence[int] = (64, 128, 256, 512),
                 hidden_size: int = 128, embedding_pooling: str = "avg",
                 rnn_aggregation: bool = False, in_channels: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.model = GatedConvNet(output_dim, num_channels, condition_type,
                                  in_channels)
        self.embedding_model = ConvEmbeddingNet(
            embedding_dims, num_channels, hidden_size=hidden_size,
            embedding_pooling=embedding_pooling,
            rnn_aggregation=rnn_aggregation, in_channels=in_channels)
        init_parameters(self, generator)
        if rnn_aggregation:
            bound = 1.0 / math.sqrt(hidden_size)
            with torch.no_grad():
                for name, p in self.embedding_model._rnn.named_parameters():
                    p.uniform_(-bound, bound, generator=generator)
                    if name.startswith("bias_hh"):
                        p[:2 * hidden_size] = 0.0
