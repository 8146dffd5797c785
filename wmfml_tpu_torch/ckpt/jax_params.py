"""Carry JAX package weights into the port: the inverse of
``wmfml_tpu/ckpt/torch_import.py:import_small_cnp`` and ``import_maml``.

``load_jax_variables(model, variables)`` takes a SmallCNP's or a
LargeCNP's JAX variables ``{"params": ..., ["favor": ...]}``, a
SingleTaskSmall's or SingleTaskLarge's ``{"params": ...}``, a
MAMLRegressor's ``{"params": ...}``
(``{"params": {"net": ..., "step_size": ...}}`` with learnable step sizes)
or an MMAMLBundle's ``{"params": {"model": ..., "embedding": ...}}`` as
nested dicts of numpy arrays and fills the port's model in place. Layout
rules:

  * conv kernels: flax HWIO -> torch OIHW;
  * dense kernels: flax [in, out] -> torch [out, in];
  * the fc after the flatten reads an HWC-flattened map in JAX and a
    CHW-flattened one here; (C, h, w) comes from the model's image size;
  * SingleTaskSmall: SmallCNP's rules without the label embedding;
    SingleTaskLarge: LargeCNP's without label embedding or aggregation;
  * LargeCNP: every consumer of the ResNet trunk's flattened features
    (``task_encoder.0``, the attention block's ``W_k`` and ``W_q``,
    ``decoder.fc_mu.0``) reads them HWC in JAX and CHW here, its trailing
    inputs (the label embedding, the latent) in the same order; the trunk
    convs ``conv1``, ``layer{i}/{conv1,conv2,downsample}`` go to
    ``conv1`` and ``resnet.layer{i}.0.{conv1,conv2,downsample.0}``;
  * the stacked W_k/W_v/W_q [in, H*d] (head-major columns) split into the
    per-head ``_W_*.{i}.linear`` layers;
  * W_out's input axis is head-major in JAX (head * d + dim) and dim-major
    in the reference layout (dim * H + head);
  * the FAVOR projection goes to the ``attn.projection_matrix`` buffer;
  * MAML: ``encoder_w/conv{0,1,2}`` -> ``encoder_w.layer{1,2,3}.conv``,
    ``encoder_w/fc`` -> ``encoder_w.linear``, ``features_{i}_conv`` and
    ``features_{i}_bn_{scale,bias}`` -> ``features.layer{i}.{conv,norm}``,
    ``regressor`` -> ``regressor.regressor`` / ``regressor``; step sizes
    keyed ``"encoder_w/conv0/kernel"`` go to ``step_size.<port name>``;
  * Bayes-by-Backprop layers (MR): ``W_mu`` and ``W_rho`` take the conv or
    dense rule of their layer (the literature encoder's ``fc`` the
    flatten permutation), ``bias_mu`` / ``bias_rho`` as they are; the
    encoder's ``conv{0,1,2}`` / ``fc`` go to ``net.layer{1,2,3}.conv`` /
    ``net.linear`` (SmallCNP's ``encoder_w0``, MAMLMR's ``encoder_w``,
    whose Tanh regressor is ``regressor.linear``), the BBB trunk's
    ``conv1`` / ``layer{i}_{conv1,conv2,down}`` to ``net.layer1.conv`` /
    ``net.layer{i+1}.{conv1,conv2,downsample.0}``
    (``wmfml_tpu/ckpt/torch_import.py:165-215``);
  * MMAML (``wmfml_tpu/ckpt/torch_import.py:401-433``, reversed): the gated
    net's ``layer{i}_conv`` and ``classifier`` go to
    ``model.features.layer{i}_conv`` and ``model.classifier.
    fully_connected``; the embedding net's ``conv{i}``, ``bn{i}_{scale,
    bias}``, ``linear`` and ``embedding_{i}`` to ``embedding_model.conv.
    conv{i}``, ``embedding_model.conv.bn{i}.{weight,bias}``,
    ``embedding_model.linear`` and ``embedding_model._embeddings.{i}``;
    the GRU's ``gru_l{l}_{fwd,bwd}/cell`` Dense layers ``i{r,z,n}`` and
    ``h{r,z,n}`` stack, gate order r, z, n, into ``_rnn.weight_ih_l{l}`` /
    ``weight_hh_l{l}`` (``_reverse`` for bwd), ``bias_ih_l{l}`` from
    ``i{r,z,n}``'s biases and ``bias_hh_l{l}`` = (0, 0, ``hn``'s bias):
    Flax's GRUCell has no bias on the hidden-to-hidden r and z products;
  * the surface modules: ``MetaConvModel``'s ``layer{i}_conv`` and
    ``layer{i}_bn_{scale,bias}`` -> ``features.layer{i}.{conv,norm}``,
    ``classifier`` (the flatten permutation); ``MetaMLPModel``'s
    ``layer{i}`` -> ``features.layer{i}.linear``, ``classifier``;
    ``Bottleneck``'s ``conv{1,2,3}``, ``bn{i}_{scale,bias}`` and
    ``downsample`` -> ``conv{1,2,3}``, ``bn{i}.{weight,bias}``,
    ``downsample.0`` (``bottleneck_state_dict``).

A model placed over the tensor-parallel "model" axis loads each shard's
rows (``load_jax_variables``) and exports its whole ``state_dict`` by
gathering over the model group (``full_state_dict``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from wmfml_tpu_torch.models.maml import MAMLRegressor, step_size_key
from wmfml_tpu_torch.models.meta_models import MetaConvModel, MetaMLPModel
from wmfml_tpu_torch.models.mmaml_nets import MMAMLBundle
from wmfml_tpu_torch.models.neural_process import LargeCNP
from wmfml_tpu_torch.models.single_task import SingleTaskLarge
from wmfml_tpu_torch.nn.encoders import Bottleneck, trunk_chw
from wmfml_tpu_torch.parallel import tp


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(kernel) -> torch.Tensor:
    return _t(np.transpose(np.asarray(kernel), (3, 2, 0, 1)))


def _dense(kernel) -> torch.Tensor:
    return _t(np.asarray(kernel).T)


def _dense_after_flatten(kernel, chw) -> torch.Tensor:
    """A flax kernel [in, out] whose first C h w inputs read an
    HWC-flattened map -> the torch weight [out, in] reading it CHW; the
    inputs after the map keep their order. ``chw`` None: a plain dense."""
    k = np.asarray(kernel)
    if chw is None:
        return _t(k.T)
    c, h, w = chw
    n = c * h * w
    img = k[:n].reshape(h, w, c, -1).transpose(3, 2, 0, 1).reshape(-1, n)
    return _t(np.concatenate([img, k[n:].T], axis=1))


def jax_to_state_dict(model, variables) -> Dict[str, torch.Tensor]:
    """The port ``state_dict`` that ``variables`` describe for ``model``."""
    if isinstance(model, MAMLRegressor):
        return maml_state_dict(model, variables)
    if isinstance(model, MMAMLBundle):
        return mmaml_state_dict(variables)
    if isinstance(model, (LargeCNP, SingleTaskLarge)):
        return large_cnp_state_dict(model, variables)
    if isinstance(model, (MetaConvModel, MetaMLPModel)):
        return meta_model_state_dict(model, variables["params"])
    if isinstance(model, Bottleneck):
        return bottleneck_state_dict(variables["params"])
    p = variables["params"]
    sd: Dict[str, torch.Tensor] = {}

    def dense(prefix, node, kernel=_dense):
        sd[f"{prefix}.weight"] = kernel(node["kernel"])
        sd[f"{prefix}.bias"] = _t(node["bias"])

    bbb = getattr(model, "bbb", False)
    encoder = bbb_encoder_state_dict if bbb else encoder_state_dict
    for key, value in encoder(p["encoder_w0"],
                              model.encoder_w0.flatten_chw).items():
        sd[f"encoder_w0.{key}"] = value
    if "transform_y" in p:                        # not in SingleTaskSmall
        dense("transform_y", p["transform_y"]["Dense_0"])
    mlp0 = p["encoder_r"]["MLP_0"]
    for i in range(len(mlp0)):
        dense(f"encoder_r.layers.{2 * i}", mlp0[f"Dense_{i}"]["Dense_0"])
    dense("r_to_z", p["r_to_z"]["Dense_0"])
    for i in range(len(p["decoder0"])):
        dense(f"decoder0.{2 * i}", p["decoder0"][f"Dense_{i}"]["Dense_0"])
    agg_mode = getattr(model, "agg_mode", None)
    if agg_mode == "baco":
        dense("rs_to_mu", p["rs_to_mu"]["Dense_0"])
        dense("rs_to_var", p["rs_to_var"]["Dense_0"])
    if agg_mode == "attention":
        sd.update(attention_state_dict(
            p["cross_attn"], variables["favor"]["cross_attn"]["favor"]["projection"],
            n_heads=len(model._W_k)))
    return sd


def _bbb(node, kernel=_conv) -> Dict[str, torch.Tensor]:
    """A BBB layer's posterior, its weights by ``kernel``."""
    return {"W_mu": kernel(node["W_mu"]), "W_rho": kernel(node["W_rho"]),
            "bias_mu": _t(node["bias_mu"]), "bias_rho": _t(node["bias_rho"])}


def _prefixed(prefix: str, sd) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.{k}": v for k, v in sd.items()}


def bbb_encoder_state_dict(params, chw) -> Dict[str, torch.Tensor]:
    """``BBBLiteratureEncoder`` params -> the port encoder's ``state_dict``;
    ``chw`` is the (C, h, w) map the fc reads."""
    sd: Dict[str, torch.Tensor] = {}
    for i in range(3):
        sd.update(_prefixed(f"net.layer{i + 1}.conv", _bbb(params[f"conv{i}"])))
    sd.update(_prefixed("net.linear", _bbb(
        params["fc"], lambda k: _dense_after_flatten(k, chw))))
    return sd


def bbb_trunk_state_dict(params) -> Dict[str, torch.Tensor]:
    """``BBBResNetTrunk`` params -> the port trunk's ``state_dict``."""
    sd = _prefixed("net.layer1.conv", _bbb(params["conv1"]))
    for i in range(1, 5):
        for jax_name, name in (("conv1", "conv1"), ("conv2", "conv2"),
                               ("down", "downsample.0")):
            sd.update(_prefixed(f"net.layer{i + 1}.{name}",
                                _bbb(params[f"layer{i}_{jax_name}"])))
    return sd


def trunk_state_dict(params) -> Dict[str, torch.Tensor]:
    """``ResNetTrunk`` params -> the port trunk's ``state_dict``."""
    sd = {"conv1.weight": _conv(params["conv1"]["kernel"]),
          "conv1.bias": _t(params["conv1"]["bias"])}
    for i in range(1, 5):
        layer = params[f"layer{i}"]
        for jax_name, name in (("conv1", "conv1"), ("conv2", "conv2"),
                               ("downsample", "downsample.0")):
            sd[f"resnet.layer{i}.0.{name}.weight"] = _conv(
                layer[jax_name]["kernel"])
    return sd


def large_cnp_state_dict(model, variables) -> Dict[str, torch.Tensor]:
    """LargeCNP or SingleTaskLarge variables
    (``wmfml_tpu/models/neural_process.py``, ``single_task.py``) -> the port
    model's ``state_dict``."""
    p = variables["params"]
    trunk = model.img_encoder
    chw = trunk_chw(trunk.img_agg, model.img_hw)
    sd: Dict[str, torch.Tensor] = {}

    def dense(prefix, node, chw=None):
        sd[f"{prefix}.weight"] = _dense_after_flatten(node["kernel"], chw)
        sd[f"{prefix}.bias"] = _t(node["bias"])

    agg_mode = getattr(model, "agg_mode", None)
    encoder = (bbb_trunk_state_dict if getattr(model, "bbb", False)
               else trunk_state_dict)
    sd.update(_prefixed("img_encoder", encoder(p["img_encoder"])))
    sd.update(_prefixed("decoder", trunk_state_dict(p["decoder"]["trunk"])))
    if getattr(model, "transform_y", None) is not None:
        dense("transform_y", p["transform_y"]["Dense_0"])
    for i in range(3):
        dense(f"task_encoder.{2 * i}",
              p["task_encoder"][f"Dense_{i}"]["Dense_0"], chw if i == 0 else None)
        dense(f"decoder.fc_mu.{2 * i}",
              p["decoder"]["fc_mu"][f"Dense_{i}"]["Dense_0"],
              chw if i == 0 else None)
    dense("mu", p["mu"]["Dense_0"])
    if agg_mode == "baco":
        dense("latent_mu", p["latent_mu"]["Dense_0"])
        dense("latent_var", p["latent_var"]["Dense_0"])
    if agg_mode == "attention":
        sd.update(attention_state_dict(
            p["cross_attn"],
            variables["favor"]["cross_attn"]["favor"]["projection"],
            n_heads=len(model._W_k), kq_chw=chw))
    return sd


def encoder_state_dict(params, chw: Tuple[int, int, int]) -> Dict[str, torch.Tensor]:
    """``LiteratureEncoder`` params (conv0/conv1/conv2/fc) -> the port
    encoder's ``state_dict``; ``chw`` is the (C, h, w) map the fc reads."""
    sd: Dict[str, torch.Tensor] = {}
    for idx, name in (("0", "conv0"), ("2", "conv1"), ("5", "conv2")):
        sd[f"{idx}.weight"] = _conv(params[name]["kernel"])
        sd[f"{idx}.bias"] = _t(params[name]["bias"])
    sd["8.weight"] = _dense_after_flatten(params["fc"]["Dense_0"]["kernel"], chw)
    sd["8.bias"] = _t(params["fc"]["Dense_0"]["bias"])
    return sd


def _maml_layers(model):
    """(port module, JAX path, kind) of each MAMLRegressor layer but a BBB
    encoder."""
    layers = []
    if not model.bbb:
        layers = [(f"encoder_w.layer{i + 1}.conv", ("encoder_w", f"conv{i}"),
                   "conv") for i in range(3)]
        layers.append(("encoder_w.linear", ("encoder_w", "fc", "Dense_0"),
                       "fc"))
    layers += [(f"features.layer{i}.conv", (f"features_{i}_conv",), "conv")
               for i in range(1, 5)]
    layers.append((model.reg_name, ("regressor", "Dense_0"), "dense"))
    return layers


def maml_state_dict(model, variables) -> Dict[str, torch.Tensor]:
    """MAMLRegressor variables (``wmfml_tpu/models/maml.py``) -> the port
    model's ``state_dict``."""
    p = variables["params"]
    net = p["net"] if "net" in p else p
    chw = model.encoder_w.flatten_chw
    kernels = {"conv": _conv, "dense": _dense,
               "fc": lambda k: _dense_after_flatten(k, chw)}
    sd: Dict[str, torch.Tensor] = {}
    jax_names = {}
    for prefix, path, kind in _maml_layers(model):
        node = net
        for key in path:
            node = node[key]
        sd[f"{prefix}.weight"] = kernels[kind](node["kernel"])
        sd[f"{prefix}.bias"] = _t(node["bias"])
        jax_names["/".join(path + ("kernel",))] = f"{prefix}.weight"
        jax_names["/".join(path + ("bias",))] = f"{prefix}.bias"
    if model.bbb:
        sd.update(_prefixed("encoder_w", bbb_encoder_state_dict(
            net["encoder_w"], chw)))
    for i in range(1, 5):
        sd[f"features.layer{i}.norm.weight"] = _t(net[f"features_{i}_bn_scale"])
        sd[f"features.layer{i}.norm.bias"] = _t(net[f"features_{i}_bn_bias"])
    if "step_size" in p:
        ss = p["step_size"]
        if isinstance(ss, dict):
            for key, value in ss.items():
                sd[f"step_size.{step_size_key(jax_names[key])}"] = _t(value)
        else:
            sd["step_size"] = _t(ss)
    return sd


def _dense_into(sd, prefix, node):
    sd[f"{prefix}.weight"] = _dense(node["kernel"])
    sd[f"{prefix}.bias"] = _t(node["bias"])


def _conv_into(sd, prefix, node):
    sd[f"{prefix}.weight"] = _conv(node["kernel"])
    sd[f"{prefix}.bias"] = _t(node["bias"])


def mmaml_state_dict(variables) -> Dict[str, torch.Tensor]:
    """MMAMLBundle variables (``wmfml_tpu/models/mmaml_nets.py``) -> the
    port bundle's ``state_dict``."""
    gated, embed = variables["params"]["model"], variables["params"]["embedding"]
    sd: Dict[str, torch.Tensor] = {}
    for i in range(1, 5):
        _conv_into(sd, f"model.features.layer{i}_conv", gated[f"layer{i}_conv"])
        _conv_into(sd, f"embedding_model.conv.conv{i}", embed[f"conv{i}"])
        sd[f"embedding_model.conv.bn{i}.weight"] = _t(embed[f"bn{i}_scale"])
        sd[f"embedding_model.conv.bn{i}.bias"] = _t(embed[f"bn{i}_bias"])
    _dense_into(sd, "model.classifier.fully_connected",
                gated["classifier"]["Dense_0"])
    if "linear" in embed:
        _dense_into(sd, "embedding_model.linear", embed["linear"]["Dense_0"])
    heads = sorted(int(k.split("_")[1]) for k in embed
                   if k.startswith("embedding_"))
    for i in heads:
        _dense_into(sd, f"embedding_model._embeddings.{i}",
                    embed[f"embedding_{i}"]["Dense_0"])
    layers = sorted({int(k.split("_")[1][1:]) for k in embed
                     if k.startswith("gru_l")})
    for layer in layers:
        for dname, suffix in (("fwd", ""), ("bwd", "_reverse")):
            cell = embed[f"gru_l{layer}_{dname}"]["cell"]
            key = f"embedding_model._rnn.{{}}_l{layer}{suffix}"
            sd[key.format("weight_ih")] = torch.cat(
                [_dense(cell[g]["kernel"]) for g in ("ir", "iz", "in")])
            sd[key.format("weight_hh")] = torch.cat(
                [_dense(cell[g]["kernel"]) for g in ("hr", "hz", "hn")])
            sd[key.format("bias_ih")] = torch.cat(
                [_t(cell[g]["bias"]) for g in ("ir", "iz", "in")])
            hn = _t(cell["hn"]["bias"])
            sd[key.format("bias_hh")] = torch.cat(
                [torch.zeros_like(hn), torch.zeros_like(hn), hn])
    return sd


def attention_state_dict(params, projection, n_heads: int = 8,
                         kq_chw=None):
    """``MultiheadFavorCrossAttention`` params (W_k/W_v/W_q/W_out) and its
    FAVOR projection -> the port block's ``state_dict``; ``kq_chw`` is the
    (C, h, w) map whose HWC flatten k and q are (LargeCNP), else None."""
    sd: Dict[str, torch.Tensor] = {}
    for jax_name, torch_name in (("W_k", "_W_k"), ("W_v", "_W_v"),
                                 ("W_q", "_W_q")):
        kernel = np.asarray(params[jax_name]["kernel"])         # [in, H*d]
        bias = np.asarray(params[jax_name]["bias"])
        d = kernel.shape[1] // n_heads
        chw = None if jax_name == "W_v" else kq_chw
        for i in range(n_heads):
            sd[f"{torch_name}.{i}.linear.weight"] = _dense_after_flatten(
                kernel[:, i * d:(i + 1) * d], chw)
            sd[f"{torch_name}.{i}.linear.bias"] = _t(bias[i * d:(i + 1) * d])
    w = np.asarray(params["W_out"]["kernel"]).T                 # [out, H*d] head-major
    out, hd = w.shape
    sd["_W.linear.weight"] = _t(
        w.reshape(out, n_heads, hd // n_heads).transpose(0, 2, 1).reshape(out, hd))
    sd["_W.linear.bias"] = _t(params["W_out"]["bias"])
    sd["attn.projection_matrix"] = _t(projection)
    return sd


def meta_model_state_dict(model, params) -> Dict[str, torch.Tensor]:
    """MetaConvModel or MetaMLPModel params -> the port model's
    ``state_dict``."""
    sd: Dict[str, torch.Tensor] = {}
    head = params["classifier"]["Dense_0"]
    if isinstance(model, MetaMLPModel):
        for i in range(1, model.depth + 1):
            _dense_into(sd, f"features.layer{i}.linear",
                        params[f"layer{i}"]["Dense_0"])
        _dense_into(sd, "classifier", head)
        return sd
    for i in range(1, 5):
        _conv_into(sd, f"features.layer{i}.conv", params[f"layer{i}_conv"])
        sd[f"features.layer{i}.norm.weight"] = _t(params[f"layer{i}_bn_scale"])
        sd[f"features.layer{i}.norm.bias"] = _t(params[f"layer{i}_bn_bias"])
    sd["classifier.weight"] = _dense_after_flatten(head["kernel"],
                                                   model.flatten_chw)
    sd["classifier.bias"] = _t(head["bias"])
    return sd


def bottleneck_state_dict(params) -> Dict[str, torch.Tensor]:
    """``Bottleneck`` params -> the port block's ``state_dict``."""
    sd = {f"conv{i}.weight": _conv(params[f"conv{i}"]["kernel"])
          for i in (1, 2, 3)}
    for i in (1, 2, 3):
        sd[f"bn{i}.weight"] = _t(params[f"bn{i}_scale"])
        sd[f"bn{i}.bias"] = _t(params[f"bn{i}_bias"])
    if "downsample" in params:
        sd["downsample.0.weight"] = _conv(params["downsample"]["kernel"])
    return sd


def load_jax_variables(model, variables):
    """Fill ``model`` (any device) with the JAX ``variables``; strict. A
    model placed over the "model" axis (``parallel/mesh.py:shard_state``)
    takes each shard's rows of the whole weight."""
    sd = jax_to_state_dict(model, variables)
    for name, p in model.named_parameters():
        shard = tp.shard_of(p)
        if shard is not None:
            ctx, dim, _ = shard
            rows = sd[name].shape[dim] // ctx.model
            sd[name] = sd[name].narrow(dim, ctx.model_rank * rows, rows)
    model.load_state_dict(sd, strict=True)
    return model


@torch.no_grad()
def full_state_dict(model) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with every model shard gathered whole over its
    model group (``parallel/tp.py``): what ``import_torch_checkpoint`` and
    the checkpoint forms read, on every rank of the group."""
    sd = model.state_dict()
    for name, p in model.named_parameters():
        shard = tp.shard_of(p)
        if shard is not None:
            sd[name] = tp.gather(p.detach(), shard[0], shard[1])
    return sd
