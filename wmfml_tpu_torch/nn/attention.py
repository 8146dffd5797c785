"""FAVOR+ (Performer) multi-head cross-attention.

``favor_attention`` (positive random features, non-causal linear attention,
key mask applied after featurisation) is kernel K2 in
``kernels/favor.py``; this module holds the projection draw and the
8-head block of ``wmfml_tpu/nn/attention.py:156-194``.

The block keeps the reference's torch layout, which fixes its
``state_dict`` keys: per-head ``_W_k.{i}.linear``, ``_W_v.{i}.linear``,
``_W_q.{i}.linear``, the output ``_W.linear`` and the projection buffer
``attn.projection_matrix``. Heads are full width (8 x h_dim). The per-head
projections run as one matmul over the stacked head weights, and the head
outputs are flattened dim-major (index = dim * H + head), as the reference
does. The projection is drawn once at construction; nothing in training
redraws it. In ``compute_dtype`` bfloat16 the projections and ``_W`` compute
in bfloat16 as Flax's ``Dense(dtype=...)`` does; the core takes the
bfloat16 q, k, v and returns float32, as the JAX core promotes against the
float32 projection (``kernels/favor.py``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from wmfml_tpu_torch.kernels.favor import favor_attention
from wmfml_tpu_torch.nn.init import AttnLinear
from wmfml_tpu_torch.parallel import tp


def gaussian_orthogonal_random_matrix(nb_rows: int, nb_columns: int,
                                      generator: Optional[torch.Generator] = None,
                                      scaling: int = 0) -> torch.Tensor:
    """Stacked orthogonal blocks with re-drawn row norms (FAVOR+), on the CPU."""
    def normal(*shape):
        return torch.randn(*shape, generator=generator)

    nb_full_blocks = nb_rows // nb_columns
    blocks = [torch.linalg.qr(normal(nb_columns, nb_columns))[0].t()
              for _ in range(nb_full_blocks)]
    remaining = nb_rows - nb_full_blocks * nb_columns
    if remaining > 0:
        q, _ = torch.linalg.qr(normal(nb_columns, nb_columns))
        blocks.append(q.t()[:remaining])
    final = torch.cat(blocks, 0)
    if scaling == 0:
        multiplier = normal(nb_rows, nb_columns).norm(dim=1)
    elif scaling == 1:
        multiplier = torch.full((nb_rows,), math.sqrt(float(nb_columns)))
    else:
        raise ValueError(f"Invalid scaling {scaling}")
    return multiplier[:, None] * final


class FastAttention(nn.Module):
    """Holds the projection buffer; m = int(d * ln d) features by default."""

    def __init__(self, dim_heads: int, nb_features: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        m = nb_features or int(dim_heads * math.log(dim_heads))
        self.register_buffer("projection_matrix",
                             gaussian_orthogonal_random_matrix(m, dim_heads,
                                                               generator))

    def forward(self, q, k, v, mask=None):
        return favor_attention(q, k, v, self.projection_matrix, mask)


def _stacked(heads: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
    """All heads' projections in one matmul, in the heads' compute dtype:
    [T, N, in] -> [T, H, N, d]. Heads split over the model axis
    (``parallel/tp.py``) compute d / model features of every head, gathered
    per head in rank order."""
    dtype = heads[0].linear.compute_dtype
    w = torch.cat([m.linear.weight for m in heads], 0).to(dtype)  # [H*d, in]
    b = torch.cat([m.linear.bias for m in heads], 0).to(dtype)
    shard = tp.shard_of(heads[0].linear.weight)
    if shard is None:
        y = torch.matmul(x.to(dtype), w.t()) + b
    else:
        y = torch.matmul(tp.to_model(x, shard[0]).to(dtype), w.t())
        t, n = y.shape[:2]
        y = tp.gather(y.reshape(t, n, len(heads), -1), shard[0], -1)
        y = y.reshape(t, n, -1) + b
    t, n = y.shape[:2]
    return y.reshape(t, n, len(heads), -1).transpose(1, 2)


class MultiheadFavorCrossAttention(nn.Module):
    """k: context image features, v: context task features, q: query image
    features, [T, N, *]; mask [T, Nk] bool. Returns [T, Nq, h_dim].
    ``kq_dim`` is the width of k and q (default ``h_dim``): the LargeCNP
    family feeds them the ResNet trunk's features (256 at ``img_agg:
    max``, 64 h w at ``reshape``)."""

    def __init__(self, h_dim: int, v_dim: int, n_heads: int = 8,
                 nb_features: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 kq_dim: Optional[int] = None):
        super().__init__()
        kq_dim = kq_dim or h_dim
        self._W_k = nn.ModuleList([AttnLinear(kq_dim, h_dim) for _ in range(n_heads)])
        self._W_v = nn.ModuleList([AttnLinear(v_dim, h_dim) for _ in range(n_heads)])
        self._W_q = nn.ModuleList([AttnLinear(kq_dim, h_dim) for _ in range(n_heads)])
        self._W = AttnLinear(n_heads * h_dim, h_dim)
        self.attn = FastAttention(h_dim, nb_features, generator)

    def forward(self, k, v, q, mask=None):
        outs = self.attn(_stacked(self._W_q, q), _stacked(self._W_k, k),
                         _stacked(self._W_v, v), mask)        # [T, H, Nq, d]
        t, _, nq, _ = outs.shape
        return self._W.linear(outs.permute(0, 2, 3, 1).reshape(t, nq, -1))
