"""Conditional and attentive neural processes, literature-encoder family.

``SmallCNP`` is ``wmfml_tpu/models/neural_process.py:SmallCNP`` (the
reference's CNPShapeNet1D, ANPShapeNet1D and the Pascal1D variants): conv
encoder -> dim_w image feature; label -> dim_w/4; EncoderFC over
[feature, label]; aggregate (mean / max / baco / FAVOR attention); r_to_z;
MLP decoder over [query feature, z] with an optional Tanh head.

As in the JAX package:
  * context and query images go through the encoder as ONE batch of
    T * (S + Q) images (the JAX package's ``MERGE_CTX_QRY``), 300 images at
    the main path's shapes, so the stem kernel runs once per step;
  * padded context rows are masked in every aggregation, and a task with no
    context row gets z = 0 (``_gate_zero_ctx``);
  * with ``compute_dtype`` bfloat16 (``ops/cast.py:set_compute_dtype``)
    every layer and the aggregation compute in bfloat16 and ``mu`` is
    bfloat16; the caller takes its loss on ``mu.float()``.

Parameter names follow the reference torch models (``encoder_w0.{0,2,5,8}``,
``transform_y``, ``encoder_r.layers.{0,2,4}``, ``r_to_z``,
``decoder0.{0,2,4}``, ``rs_to_mu``/``rs_to_var`` for baco and the attention
block's ``_W_k``/``_W_v``/``_W_q``/``_W``/``attn`` at the top level).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from wmfml_tpu_torch.models.base import ModelOutput
from wmfml_tpu_torch.nn.attention import MultiheadFavorCrossAttention
from wmfml_tpu_torch.nn.encoders import LiteratureEncoder
from wmfml_tpu_torch.nn.init import init_parameters
from wmfml_tpu_torch.nn.mlp import EncoderFC, Linear, mlp
from wmfml_tpu_torch.ops.setops import baco, masked_max, masked_mean

AGG_MODES = ("mean", "max", "baco", "attention")


def _gate_zero_ctx(z: torch.Tensor, ctx_mask: Optional[torch.Tensor]):
    """Zero the latent of tasks with an empty context set."""
    if ctx_mask is None:
        return z
    has_ctx = ctx_mask.any(1)[:, None, None]
    return torch.where(has_ctx, z, torch.zeros_like(z))


class SmallCNP(nn.Module):
    def __init__(self, dim_w: int = 64, n_hidden_units_r: Sequence[int] = (100, 100),
                 dim_r: int = 100, dim_z: int = 64, y_dim: int = 2,
                 label_dim: int = 3, agg_mode: str = "max",
                 tanh_out: bool = True, img_size: Sequence[int] = (128, 128, 1),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if agg_mode not in AGG_MODES:
            raise TypeError(f"agg_mode is not applicable, choose from {list(AGG_MODES)}")
        self.agg_mode = agg_mode
        self.encoder_w0 = LiteratureEncoder(dim_w, img_size)
        self.transform_y = Linear(label_dim, dim_w // 4)
        self.encoder_r = EncoderFC(dim_w + dim_w // 4, n_hidden_units_r, dim_r)
        if agg_mode == "baco":
            self.rs_to_mu = Linear(dim_r, dim_r)
            self.rs_to_var = Linear(dim_r, dim_r)
        self.r_to_z = Linear(dim_w if agg_mode == "attention" else dim_r, dim_z)
        self.decoder0 = mlp(dim_w + dim_z, (100, 100), y_dim,
                            "tanh" if tanh_out else None)
        self.cross_attn = None
        if agg_mode == "attention":
            attn = MultiheadFavorCrossAttention(dim_w, dim_r, n_heads=8,
                                                generator=generator)
            # the reference keeps the block's layers at the model's top
            # level; register them there and keep the block unregistered
            for name, child in attn.named_children():
                self.add_module(name, child)
            object.__setattr__(self, "cross_attn", attn)
        init_parameters(self, generator)

    def forward(self, ctx_x, ctx_y, qry_x, ctx_mask=None) -> ModelOutput:
        t, s = ctx_x.shape[:2]
        q = qry_x.shape[1]
        both = torch.cat([ctx_x, qry_x], 1)          # one encoder batch
        feats = self.encoder_w0(both.flatten(0, 1)).reshape(t, s + q, -1)
        x_ctx, x_qry = feats[:, :s], feats[:, s:]

        rs = self.encoder_r(torch.cat([x_ctx, self.transform_y(ctx_y)], -1))
        if self.agg_mode == "attention":
            z = self.r_to_z(self.cross_attn(x_ctx, rs, x_qry, mask=ctx_mask))
        else:
            if self.agg_mode == "mean":
                r = masked_mean(rs, ctx_mask)
            elif self.agg_mode == "max":
                r = masked_max(rs, ctx_mask)
            else:
                var = 1e-5 + F.softplus(self.rs_to_var(rs))
                r, _ = baco(self.rs_to_mu(rs), var, ctx_mask)
            z = self.r_to_z(r)[:, None, :].expand(t, q, -1)
        z = _gate_zero_ctx(z, ctx_mask)
        mu = self.decoder0(torch.cat([x_qry, z], -1))
        return ModelOutput(mu=mu, extras={"qry_feat": x_qry, "z": z})
