"""Model registry: reference method names -> port modules.

The four literature-encoder methods of ``wmfml_tpu/models/registry.py:60-81``,
ShapeNet3D's CondNeuralProcess / ANP and CNPDistractor / ANPDistractor
(``:86-111``), the MR and FCL methods (``:116-177``), MAMLShapeNet1D /
VanillaMAML and MAMLMR / MAMLMRShapeNet1D (``:182-212``), MMAMLShapeNet1D
(``:217-233``) and the SingleTask baselines (``:238-259``): all 24 are
ported, and ``NOT_PORTED`` is empty.

``method_family`` says which trainer and eval step a method takes; every
entry point dispatches through it.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from wmfml_tpu_torch.configs.config import torch_dtype
from wmfml_tpu_torch.models.maml import MAMLRegressor
from wmfml_tpu_torch.models.mmaml_nets import MMAMLBundle
from wmfml_tpu_torch.models.neural_process import LargeCNP, SmallCNP
from wmfml_tpu_torch.models.single_task import SingleTaskLarge, SingleTaskSmall
from wmfml_tpu_torch.ops.cast import set_compute_dtype

_REGISTRY: Dict[str, Callable] = {}

NOT_PORTED: Dict[str, str] = {}


def method_family(method: str) -> str:
    """``"mmaml"``, ``"maml"`` or ``"np"`` (the neural processes and the
    SingleTask baselines). MMAML is tested first: "MAML" is a substring of
    its name (the JAX CLI's order, ``wmfml_tpu/cli/train_cli.py:27-34``)."""
    if method.startswith("MMAML"):
        return "mmaml"
    return "maml" if "MAML" in method else "np"


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def available_methods():
    return sorted(_REGISTRY)


def build_model(config, generator: Optional[torch.Generator] = None):
    """Build ``config.method`` on the CPU, its weights drawn from
    ``generator`` (default: seeded with ``config.seed``), computing in
    ``config.compute_dtype``."""
    if config.method in NOT_PORTED:
        raise NotImplementedError(
            f"method {config.method!r} is not ported yet "
            f"(ROADMAP.md {NOT_PORTED[config.method]})")
    if config.method not in _REGISTRY:
        raise NameError(
            f"method {config.method!r} unknown; available: {available_methods()}")
    if generator is None:
        generator = torch.Generator().manual_seed(int(config.seed))
    return set_compute_dtype(_REGISTRY[config.method](config, generator),
                             torch_dtype(config))


def _small(config, agg_mode, tanh_out, generator, **options):
    """SmallCNP; ``options``: ``bbb_encoder`` (MR), ``fcl``, ``conv_bwd``
    (the four methods the JAX package's ``_small`` builds pass it, as
    there: ``wmfml_tpu/models/registry.py:49-57``)."""
    return SmallCNP(
        dim_w=config.dim_w, n_hidden_units_r=tuple(config.n_hidden_units_r),
        dim_r=config.dim_r, dim_z=config.dim_z, y_dim=config.output_dim,
        label_dim=config.input_dim, agg_mode=agg_mode, tanh_out=tanh_out,
        img_size=config.img_size, generator=generator, **options)


def _attention_only(config):
    if config.agg_mode != "attention":
        raise TypeError("agg_mode is not applicable for ANP, choose from ['attention']")


@register("CNPShapeNet1D")
def _(config, generator):
    return _small(config, config.agg_mode, True, generator,
                  conv_bwd=config.conv_bwd)


@register("ANPShapeNet1D")
def _(config, generator):
    _attention_only(config)
    return _small(config, "attention", True, generator,
                  conv_bwd=config.conv_bwd)


@register("CNPVanillaPascal1D")
def _(config, generator):
    return _small(config, config.agg_mode, False, generator,
                  conv_bwd=config.conv_bwd)


@register("ANPVanillaPascal1D")
def _(config, generator):
    _attention_only(config)
    return _small(config, "attention", False, generator,
                  conv_bwd=config.conv_bwd)


def _trunk_input(config):
    """The trunk's input size: ShapeNet3D's alpha is stripped before the
    model (``aug/pipeline.py``), so its trunk reads 3 channels of 4."""
    h, w, c = config.img_size
    return (h, w, c - 1) if config.task == "shapenet_3d" else (h, w, c)


def _large(config, agg_mode, generator, label_embed=None, **options):
    """LargeCNP on the task's images. ``options``: ``bbb_trunk`` (MR),
    ``fcl``. Both trunks take ``trunk_stem``, except with ``bbb_trunk``,
    as the JAX registry builds them (``wmfml_tpu/models/registry.py:
    145-149``: ANPMRShapeNet3D's decoder trunk stays on the stock
    stem)."""
    if not options.get("bbb_trunk"):
        options["trunk_stem"] = config.trunk_stem
    return LargeCNP(
        img_agg=config.img_agg, agg_mode=agg_mode, y_dim=config.output_dim,
        label_dim=config.input_dim, label_embed_dim=label_embed,
        img_size=_trunk_input(config), generator=generator, **options)


@register("CondNeuralProcess")
def _(config, generator):
    return _large(config, config.agg_mode, generator)


@register("ANP")
def _(config, generator):
    return _large(config, "attention", generator)


@register("CNPDistractor")
def _(config, generator):
    return _large(config, config.agg_mode, generator, config.dim_w)


@register("ANPDistractor")
def _(config, generator):
    return _large(config, "attention", generator, config.dim_w)


# -- MR (Bayes-by-Backprop) and FCL (contrastive) variants ---------------------

@register("CNPMR")
def _(config, generator):
    # base CNPMR has no Tanh head; the ShapeNet1D subclass adds it
    return _small(config, config.agg_mode, False, generator, bbb_encoder=True)


@register("CNPMRShapeNet1D")
def _(config, generator):
    return _small(config, config.agg_mode, True, generator, bbb_encoder=True)


@register("ANPMR")
def _(config, generator):
    return _small(config, "attention", False, generator, bbb_encoder=True)


@register("ANPMRShapeNet1D")
def _(config, generator):
    return _small(config, "attention", True, generator, bbb_encoder=True)


@register("ANPMRShapeNet3D")
def _(config, generator):
    return _large(config, "attention", generator, bbb_trunk=True)


@register("FCLCNPShapeNet1D")
def _(config, generator):
    return _small(config, config.agg_mode, True, generator, fcl=True)


@register("FCLCNPDistractor")
def _(config, generator):
    return _large(config, config.agg_mode, generator, config.dim_w, fcl=True)


@register("FCLANP")
def _(config, generator):
    return _large(config, "attention", generator, fcl=True)


def _maml(config, tanh_out, generator, bbb=False):
    return MAMLRegressor(
        dim_w=config.dim_w, dim_hidden=config.dim_hidden or 64,
        output_dim=config.output_dim, tanh_out=tanh_out,
        img_size=config.img_size,
        learn_step_size=bool(config.learn_step_size),
        per_param_step_size=bool(config.per_param_step_size),
        update_lr=float(config.update_lr or 0.0), bbb_encoder=bbb,
        generator=generator)


@register("MAMLShapeNet1D")
def _(config, generator):
    return _maml(config, True, generator)


@register("VanillaMAML")
def _(config, generator):
    return _maml(config, False, generator)


@register("MAMLMR")
def _(config, generator):
    return _maml(config, False, generator, bbb=True)


@register("MAMLMRShapeNet1D")
def _(config, generator):
    return _maml(config, True, generator, bbb=True)


# -- MMAML ----------------------------------------------------------------------

@register("MMAMLShapeNet1D")
def _(config, generator):
    # networks/MMAMLShapeNet1D.py:52-84: num_channels=32, affine FiLM
    # conditioning, embedding dims 2x the modulated channels
    return MMAMLBundle(
        output_dim=config.output_dim, num_channels=32,
        condition_type="affine", embedding_dims=(64, 128, 256, 512),
        hidden_size=128, embedding_pooling="avg",
        rnn_aggregation=bool(config.rnn_aggregation),
        in_channels=_trunk_input(config)[2], generator=generator)


# -- the SingleTask baselines (context ignored) ---------------------------------

@register("SingleTaskShapeNet1D")
def _(config, generator):
    return SingleTaskSmall(
        dim_w=config.dim_w, n_hidden_units_r=tuple(config.n_hidden_units_r),
        dim_r=config.dim_r, dim_z=config.dim_z, y_dim=config.output_dim,
        img_size=config.img_size, generator=generator)


def _single_large(config, generator):
    return SingleTaskLarge(img_agg=config.img_agg, y_dim=config.output_dim,
                           img_size=_trunk_input(config),
                           trunk_stem=config.trunk_stem, generator=generator)


register("SingleTaskShapeNet3D")(_single_large)
register("SingleTaskDistractor")(_single_large)
