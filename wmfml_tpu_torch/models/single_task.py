"""The non-meta SingleTask baselines: a prediction from the query image
alone (``wmfml_tpu/models/single_task.py``).

``SingleTaskSmall`` is the reference's SingleTaskShapeNet1D: the literature
encoder (its stem K1) on the query images alone -> ``EncoderFC`` -> ``r_to_z``
-> ``decoder0`` over [feature, z], Tanh out. ``SingleTaskLarge`` is
SingleTaskShapeNet3D / SingleTaskDistractor: ``ResNetTrunk``
(``img_encoder``) on the queries -> ``task_encoder`` (3 layers, ReLU out) ->
``mu`` -> ``NPDecoder``, whose own trunk runs over the same query images a
second time. Both take and ignore the context (``ctx_x``, ``ctx_y``,
``ctx_mask``), return ``kl = 0`` and compute in ``compute_dtype``, as the
neural processes do (``ops/cast.py``).

Parameter names are the reference torch models' (``encoder_w0.{0,2,5,8}``,
``encoder_r.layers.{0,2,4}``, ``r_to_z``, ``decoder0.{0,2,4}``;
``img_encoder.{conv1,resnet.*}``, ``task_encoder.{0,2,4}``, ``mu``,
``decoder.{conv1,resnet.*,fc_mu.{0,2,4}}``), so the JAX package's
``import_torch_checkpoint("SingleTask...", sd)`` takes a port ``state_dict``
as it is.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from wmfml_tpu_torch.models.base import ModelOutput
from wmfml_tpu_torch.models.neural_process import NPDecoder
from wmfml_tpu_torch.nn.encoders import (LiteratureEncoder, ResNetTrunk,
                                         trunk_feature_dim)
from wmfml_tpu_torch.nn.init import init_parameters
from wmfml_tpu_torch.nn.mlp import EncoderFC, Linear, mlp


class SingleTaskSmall(nn.Module):
    def __init__(self, dim_w: int = 64, n_hidden_units_r: Sequence[int] = (100, 100),
                 dim_r: int = 100, dim_z: int = 64, y_dim: int = 2,
                 img_size: Sequence[int] = (128, 128, 1),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.encoder_w0 = LiteratureEncoder(dim_w, img_size)
        self.encoder_r = EncoderFC(dim_w, n_hidden_units_r, dim_r)
        self.r_to_z = Linear(dim_r, dim_z)
        self.decoder0 = mlp(dim_w + dim_z, (100, 100), y_dim, "tanh")
        init_parameters(self, generator)

    def forward(self, ctx_x, ctx_y, qry_x, ctx_mask=None, qry_y=None,
                generator=None) -> ModelOutput:
        t, q = qry_x.shape[:2]
        x = self.encoder_w0(qry_x.flatten(0, 1)).reshape(t, q, -1)
        z = self.r_to_z(self.encoder_r(x))
        mu = self.decoder0(torch.cat([x, z], -1))
        return ModelOutput(mu=mu, kl=0.0, extras={})


class SingleTaskLarge(nn.Module):
    def __init__(self, img_agg: str = "reshape", y_dim: int = 4,
                 img_size: Sequence[int] = (64, 64, 3),
                 trunk_stem: str = "conv",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        h, (hw, _, c) = 256, img_size
        self.img_hw = hw
        trunk = trunk_feature_dim(img_agg, hw)
        self.img_encoder = ResNetTrunk(img_agg, c, trunk_stem)
        self.task_encoder = mlp(trunk, (h, h), h, "relu")
        self.mu = Linear(h, h)
        self.decoder = NPDecoder(img_agg, c, trunk + h, y_dim, trunk_stem)
        init_parameters(self, generator)

    def forward(self, ctx_x, ctx_y, qry_x, ctx_mask=None, qry_y=None,
                generator=None) -> ModelOutput:
        t, q = qry_x.shape[:2]
        x = self.img_encoder(qry_x.flatten(0, 1)).reshape(t, q, -1)
        sample = self.mu(self.task_encoder(x))
        return ModelOutput(mu=self.decoder(qry_x, sample), kl=0.0, extras={})
