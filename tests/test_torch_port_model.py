"""The port's SmallCNP against the JAX package's, all four ``agg_mode``s.

Forward outputs and loss gradients after ``load_jax_variables``, and the
reverse direction: the port's ``state_dict`` through the JAX package's own
importer (``import_torch_checkpoint``) gives a JAX model with equal outputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import (ATOL, RTOL, WIDTHS, assert_grads_match, episode,
                               jax_grads_as_port, jax_model, port_model, t)
from wmfml_tpu.ckpt.torch_import import (import_torch_checkpoint,
                                         state_dict_to_numpy)
from wmfml_tpu.losses.losses import azimuth_loss as jax_azimuth_loss
from wmfml_tpu_torch.losses.losses import azimuth_loss
from torch_port_common import one_torch_thread  # noqa: F401

AGG_MODES = ["mean", "max", "baco", "attention"]


@pytest.mark.parametrize("agg_mode", AGG_MODES)
def test_small_cnp_matches_jax_forward_and_loss_grads(agg_mode):
    ep = episode(1, shots=(4, 2))
    jmodel, variables = jax_model(agg_mode)

    def jloss(params):
        out = jmodel.apply({**variables, "params": params}, ep["ctx_x"],
                           ep["ctx_y"], ep["qry_x"], ctx_mask=ep["ctx_mask"])
        return jax_azimuth_loss(ep["qry_y"], out.mu), out.mu

    (want_loss, want_mu), grads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(variables["params"])

    model = port_model(agg_mode, variables)
    out = model(t(ep["ctx_x"]), t(ep["ctx_y"]), t(ep["qry_x"]),
                ctx_mask=t(ep["ctx_mask"]))
    loss = azimuth_loss(t(ep["qry_y"]), out.mu)
    np.testing.assert_allclose(out.mu.detach().numpy(), np.asarray(want_mu),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=RTOL)
    loss.backward()
    assert_grads_match(model, jax_grads_as_port(model, grads, variables))


@pytest.mark.parametrize("method,agg_mode", [("CNPShapeNet1D", "max"),
                                             ("ANPShapeNet1D", "attention")])
def test_port_state_dict_imports_into_jax(method, agg_mode):
    # the JAX importer reads the reference's 128x128 literature encoder
    ep = episode(2, shots=(3, 4), hw=128)
    _, variables = jax_model(agg_mode, hw=128, seed=3)
    model = port_model(agg_mode, variables, hw=128)
    with torch.no_grad():
        for p in model.parameters():      # move off the JAX init
            p.add_(0.01 * torch.randn(p.shape, generator=torch.Generator()
                                      .manual_seed(p.numel())))
        got = model(t(ep["ctx_x"]), t(ep["ctx_y"]), t(ep["qry_x"]),
                    ctx_mask=t(ep["ctx_mask"])).mu.numpy()
    kw = {"agg_mode": agg_mode} if method == "CNPShapeNet1D" else {}
    imported = import_torch_checkpoint(
        method, state_dict_to_numpy(model.state_dict()),
        n_hidden=len(WIDTHS["n_hidden_units_r"]), **kw)
    jmodel, _ = jax_model(agg_mode, hw=128)
    want = jmodel.apply(jax.tree_util.tree_map(jnp.asarray, imported),
                        ep["ctx_x"], ep["ctx_y"], ep["qry_x"],
                        ctx_mask=ep["ctx_mask"]).mu
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def test_state_dict_keys_follow_reference_layout():
    _, variables = jax_model("attention")
    keys = set(port_model("attention", variables).state_dict())
    for k in ["encoder_w0.0.weight", "encoder_w0.2.weight",
              "encoder_w0.5.weight", "encoder_w0.8.weight", "transform_y.weight",
              "encoder_r.layers.0.weight", "encoder_r.layers.2.weight",
              "encoder_r.layers.4.weight", "r_to_z.weight",
              "decoder0.0.weight", "decoder0.2.weight", "decoder0.4.weight",
              "_W_k.7.linear.weight", "_W_v.0.linear.bias",
              "_W_q.3.linear.weight", "_W.linear.weight",
              "attn.projection_matrix"]:
        assert k in keys, k
    assert not any(k.startswith("cross_attn") for k in keys)
