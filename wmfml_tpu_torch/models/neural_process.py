"""Conditional and attentive neural processes: the literature-encoder
family (``SmallCNP``) and the ResNet-trunk family (``LargeCNP``).

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

MR and FCL (``wmfml_tpu/models/neural_process.py:94-173``): with
``bbb_encoder`` the encoder is ``nn/bbb.py:BBBLiteratureEncoder``
(``encoder_w0.net.layer{1,2,3}.conv``, ``encoder_w0.net.linear``); the
query images go through it first, then the context images, each pass with
its own sample (two stem launches a forward), and the kl is the query
pass's. With ``fcl``, in training (``self.training``) and where a latent
z_0 exists (not attention), the query reps built with their labels
(``qry_y``) give z_q = r_to_z(max over the queries), and ``extras`` carry
``z_ctx_view`` (z_0) and ``z_qry_view`` (z_q) for NT-Xent.

Parameter names follow the reference torch models (``encoder_w0.{0,2,5,8}``,
``transform_y``, ``encoder_r.layers.{0,2,4}``, ``r_to_z``,
``decoder0.{0,2,4}``, ``rs_to_mu``/``rs_to_var`` for baco and the attention
block's ``_W_k``/``_W_v``/``_W_q``/``_W``/``attn`` at the top level).

``LargeCNP`` is ``wmfml_tpu/models/neural_process.py:LargeCNP`` (the
reference's CNPDistractor and ANPDistractor; CondNeuralProcess and ANP with
ShapeNet3D's data, ROADMAP.md A12c): ``ResNetTrunk`` image features
(``img_agg``); the label embedded to ``label_embed_dim`` (Distractor:
dim_w) or taken raw; a 3-layer task encoder over [feature, label] with a
final ReLU; mean / max / baco aggregation then the ``mu`` head, or FAVOR
attention (k, q the trunk features, v the task features, 8 full-width
heads) then ``mu``; ``_gate_zero_ctx``; ``NPDecoder``: its own trunk over
the query images and ``fc_mu`` (256, 256) over [query feature, latent].
With attention the context and query images go through the encoder trunk
as one batch (``MERGE_CTX_QRY``). Keys: ``img_encoder.{conv1,resnet.*}``,
``transform_y``, ``task_encoder.{0,2,4}``, ``mu``, ``latent_mu`` /
``latent_var`` (baco), the attention block's layers at the top level and
``decoder.{conv1,resnet.*,fc_mu.{0,2,4}}``. With ``bbb_trunk``
(ANPMRShapeNet3D) the encoder trunk is ``nn/bbb.py:BBBResNetTrunk``
(``img_encoder.net.*``), over the context, then the queries, each with its
own sample, the kl the query pass's; the decoder's trunk stays plain. With
``fcl`` in training the queries go through the encoder trunk too (one
batch with the context, as attention does) and ``extras`` carry
``qry_rep`` (attention: the gated per-query latent) or ``z_ctx_view`` and
``z_qry_view`` (the aggregate of the query reps built with their
labels). In ``compute_dtype`` bfloat16
(``wmfml_tpu/models/registry.py:86-91`` passes the dtype to every
LargeCNP) both trunks, the label embedding, the task encoder, the
aggregation (baco's heads included), the attention block's projections,
``mu`` and the decoder's head compute in bfloat16, as ``SmallCNP`` does;
ShapeNet3D's raw float32 labels meet the bfloat16 trunk features in one
concatenation that promotes to float32, and the task encoder's first layer
rounds both, as JAX's ``jnp.concatenate`` and ``Dense(dtype=...)`` do.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from wmfml_tpu_torch.models.base import ModelOutput
from wmfml_tpu_torch.nn.attention import MultiheadFavorCrossAttention
from wmfml_tpu_torch.nn.bbb import BBBLiteratureEncoder, BBBResNetTrunk
from wmfml_tpu_torch.nn.encoders import (LiteratureEncoder, ResNetTrunk,
                                         trunk_feature_dim)
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


def _register_attention(model: nn.Module, attn: nn.Module):
    """The reference keeps the attention block's layers at the model's top
    level: register them there and keep the block unregistered."""
    for name, child in attn.named_children():
        model.add_module(name, child)
    object.__setattr__(model, "cross_attn", attn)


class SmallCNP(nn.Module):
    def __init__(self, dim_w: int = 64, n_hidden_units_r: Sequence[int] = (100, 100),
                 dim_r: int = 100, dim_z: int = 64, y_dim: int = 2,
                 label_dim: int = 3, agg_mode: str = "max",
                 tanh_out: bool = True, img_size: Sequence[int] = (128, 128, 1),
                 bbb_encoder: bool = False, fcl: bool = False,
                 generator: Optional[torch.Generator] = None,
                 conv_bwd: str = "xla"):
        super().__init__()
        if agg_mode not in AGG_MODES:
            raise TypeError(f"agg_mode is not applicable, choose from {list(AGG_MODES)}")
        self.agg_mode = agg_mode
        self.bbb, self.fcl = bbb_encoder, fcl
        self.encoder_w0 = (BBBLiteratureEncoder(dim_w, img_size) if bbb_encoder
                           else LiteratureEncoder(dim_w, img_size, conv_bwd))
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

    def _encode(self, x, generator):
        """BBB: [T, N, ...] images -> ([T, N, dim_w], kl), one sample."""
        t, n = x.shape[:2]
        feats, kl = self.encoder_w0(x.flatten(0, 1), generator)
        return feats.reshape(t, n, -1), kl

    def forward(self, ctx_x, ctx_y, qry_x, ctx_mask=None, qry_y=None,
                generator=None) -> ModelOutput:
        """``qry_y`` feeds FCL's query view (training only); ``generator``
        (a ``torch.Generator`` or an ``nn/bbb.py:EpsFeed``) draws the BBB
        encoder's weights."""
        t, s = ctx_x.shape[:2]
        q = qry_x.shape[1]
        kl = 0.0
        if self.bbb:       # the query pass first: its sample gives the kl
            x_qry, kl = self._encode(qry_x, generator)
            x_ctx, _ = self._encode(ctx_x, generator)
        else:
            both = torch.cat([ctx_x, qry_x], 1)      # one encoder batch
            feats = self.encoder_w0(both.flatten(0, 1)).reshape(t, s + q, -1)
            x_ctx, x_qry = feats[:, :s], feats[:, s:]

        rs = self.encoder_r(torch.cat([x_ctx, self.transform_y(ctx_y)], -1))
        z_0 = None
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
            z_0 = self.r_to_z(r)
            z = z_0[:, None, :].expand(t, q, -1)
        z = _gate_zero_ctx(z, ctx_mask)
        extras = {"qry_feat": x_qry, "z": z}
        if self.fcl and self.training and qry_y is not None and z_0 is not None:
            # the query view: max over the query reps built with their labels
            rq = self.encoder_r(torch.cat([x_qry, self.transform_y(qry_y)], -1))
            extras["z_ctx_view"] = z_0
            extras["z_qry_view"] = self.r_to_z(rq.amax(1))
        mu = self.decoder0(torch.cat([x_qry, z], -1))
        return ModelOutput(mu=mu, kl=kl, extras=extras)


class NPDecoder(ResNetTrunk):
    """The query trunk and ``fc_mu`` (``NPDecoder``): [T, Q, H, W, C] query
    images and the latent [T, Q, h] -> mu [T, Q, y_dim]."""

    def __init__(self, img_agg: str, in_ch: int, in_dim: int, y_dim: int,
                 trunk_stem: str = "conv"):
        super().__init__(img_agg, in_ch, trunk_stem)
        self.fc_mu = mlp(in_dim, (256, 256), y_dim)

    def forward(self, qry_x, sample):
        t, q = qry_x.shape[:2]
        feats = super().forward(qry_x.flatten(0, 1)).reshape(t, q, -1)
        return self.fc_mu(torch.cat([feats, sample], -1))


class LargeCNP(nn.Module):
    def __init__(self, img_agg: str = "max", agg_mode: str = "max",
                 y_dim: int = 2, label_dim: int = 2, h_dim: int = 256,
                 label_embed_dim: Optional[int] = None,
                 img_size: Sequence[int] = (128, 128, 1),
                 bbb_trunk: bool = False, fcl: bool = False,
                 trunk_stem: str = "conv",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if agg_mode not in AGG_MODES:
            raise TypeError(f"agg_mode is not applicable, choose from {list(AGG_MODES)}")
        self.agg_mode = agg_mode
        self.bbb, self.fcl = bbb_trunk, fcl
        h, (hw, _, c) = h_dim, img_size
        self.img_hw = hw
        trunk = trunk_feature_dim(img_agg, hw)
        self.img_encoder = (BBBResNetTrunk(img_agg, c) if bbb_trunk
                            else ResNetTrunk(img_agg, c, trunk_stem))
        self.transform_y = (Linear(label_dim, label_embed_dim)
                            if label_embed_dim else None)
        self.task_encoder = mlp(trunk + (label_embed_dim or label_dim),
                                (h, h), h, "relu")
        self.mu = Linear(h, h)
        if agg_mode == "baco":
            self.latent_mu = Linear(h, h)
            self.latent_var = Linear(h, h)
        self.cross_attn = None
        if agg_mode == "attention":
            _register_attention(self, MultiheadFavorCrossAttention(
                h, h, n_heads=8, generator=generator, kq_dim=trunk))
        self.decoder = NPDecoder(img_agg, c, trunk + h, y_dim, trunk_stem)
        init_parameters(self, generator)

    def _aggregate(self, reps, mask):
        """mean / max / baco latent over a set, then ``mu``."""
        if self.agg_mode == "mean":
            r = masked_mean(reps, mask)
        elif self.agg_mode == "max":
            r = masked_max(reps, mask)
        else:
            var = 1e-5 + F.softplus(self.latent_var(reps))
            r, _ = baco(self.latent_mu(reps), var, mask)
        return self.mu(r)

    def forward(self, ctx_x, ctx_y, qry_x, ctx_mask=None, qry_y=None,
                generator=None) -> ModelOutput:
        """``qry_y`` feeds FCL's query view (training only); ``generator``
        (a ``torch.Generator`` or an ``nn/bbb.py:EpsFeed``) draws the BBB
        trunk's weights."""
        t, s = ctx_x.shape[:2]
        q = qry_x.shape[1]
        kl = 0.0
        need_qry = self.agg_mode == "attention" or (self.fcl and self.training)
        x_qry = None
        if self.bbb:       # ctx, then qry, each with its own sample
            x_ctx, _ = self.img_encoder(ctx_x.flatten(0, 1), generator)
            x_ctx = x_ctx.reshape(t, s, -1)
            if need_qry:   # the query pass gives the kl
                x_qry, kl = self.img_encoder(qry_x.flatten(0, 1), generator)
                x_qry = x_qry.reshape(t, q, -1)
        elif need_qry:     # one trunk batch, ctx + qry
            both = torch.cat([ctx_x, qry_x], 1)
            feats = self.img_encoder(both.flatten(0, 1)).reshape(t, s + q, -1)
            x_ctx, x_qry = feats[:, :s], feats[:, s:]
        else:
            x_ctx = self.img_encoder(ctx_x.flatten(0, 1)).reshape(t, s, -1)
        embed = (lambda y: y) if self.transform_y is None else self.transform_y
        reps = self.task_encoder(torch.cat([x_ctx, embed(ctx_y)], -1))
        z_0 = None
        if self.agg_mode == "attention":
            sample = self.mu(self.cross_attn(x_ctx, reps, x_qry,
                                             mask=ctx_mask))
        else:
            z_0 = self._aggregate(reps, ctx_mask)
            sample = z_0[:, None, :].expand(t, q, -1)
        sample = _gate_zero_ctx(sample, ctx_mask)
        extras = {"sample_features": sample}
        if self.fcl and self.training:
            if self.agg_mode == "attention":
                extras["qry_rep"] = sample               # FCLANP's views
            elif qry_y is not None:                      # FCL-CNP's two views
                rq = self.task_encoder(torch.cat([x_qry, embed(qry_y)], -1))
                extras["z_ctx_view"] = z_0
                extras["z_qry_view"] = self._aggregate(rq, None)
        mu = self.decoder(qry_x, sample)
        return ModelOutput(mu=mu, kl=kl, extras=extras)
