"""Functional contrastive learning (FCL) in the port against the JAX package
on the CPU.

Held: ``nt_xent``, ``contrastive_loss`` and ``contrastive_loss_anp`` (value
and gradient), among them saturated embeddings at FCLANP's t = 0.007 with a
zero row, where the naive form turns to NaN; the three FCL methods' views
in training (FCLCNPShapeNet1D's and FCLCNPDistractor's two views z_0 and
z_q, FCLANP's query representations) and none in evaluation; one train
step's total loss (task + contrastive_rate x NT-Xent) and gradients; the
weight carry both ways; the config keys. Small sizes: T = 2, 3 context and
2 query rows, 32x32 (ShapeNet1D), 128x128 (Distractor) and 64x64 RGBA
(ShapeNet3D) images. Tolerance: ``RTOL``/``ATOL`` for values,
``GRAD_TOL`` for gradients, unless a test says why not.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import (ATOL, GRAD_TOL, RTOL, WIDTHS, jax_grads_as_port,
                               t, to_numpy)
from wmfml_tpu import losses as jlosses
from wmfml_tpu.aug.pipeline import build_episode_processor as jax_processor
from wmfml_tpu.ckpt.torch_import import (import_torch_checkpoint,
                                         state_dict_to_numpy)
from wmfml_tpu.configs import Config as JaxConfig
from wmfml_tpu.models.registry import build_model as jax_build_model
from wmfml_tpu.train.steps import _contra_term as jax_contra_term
from wmfml_tpu.train.steps import make_forward as jax_forward
from wmfml_tpu_torch.ckpt.jax_params import load_jax_variables
from wmfml_tpu_torch.configs import Config
from wmfml_tpu_torch.losses import losses as plosses
from wmfml_tpu_torch.models.registry import build_model
from wmfml_tpu_torch.train.state import build_optimizer
from wmfml_tpu_torch.train.steps import build_train_step, contra_term
from torch_port_common import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T_, S_, Q_ = 2, 3, 2
SHOTS = (3, 2)


# -- (a) NT-Xent ----------------------------------------------------------------

def _nt_cases():
    rng = np.random.RandomState(0)
    plain = rng.randn(2, 5, 8).astype(np.float32)
    # saturated: each task's rows within ~1e-3 of one direction, norms ~1e3,
    # so |sim| reaches 1 / t = 143 at t = 0.007; one row exactly zero
    dirs = rng.randn(2, 1, 8)
    sat = (1e3 * (dirs + 1e-3 * rng.randn(2, 5, 8))).astype(np.float32)
    sat[1, 2] = 0.0
    return {"random": (plain, 0.07), "saturated": (sat, 0.007)}


@pytest.mark.parametrize("form", ["anp", "two_view"])
@pytest.mark.parametrize("case", ["random", "saturated"])
def test_nt_xent_matches_jax(case, form):
    """Value and gradient; finite where embeddings saturate at t = 0.007
    and a row is zero (the clamp before the sqrt, -inf before the exp, the
    shared shift)."""
    z, temp = _nt_cases()[case]
    if form == "anp":
        jfn = lambda a: jlosses.contrastive_loss_anp(a, t=temp)   # noqa: E731
        pfn = lambda a: plosses.contrastive_loss_anp(a, t=temp)   # noqa: E731
    else:
        z = z.reshape(2, -1, 8)[:, :4]
        jfn = lambda a: jlosses.contrastive_loss(a[0], a[1], t=temp)  # noqa: E731
        pfn = lambda a: plosses.contrastive_loss(a[0], a[1], t=temp)  # noqa: E731
    want, want_g = jax.value_and_grad(jfn)(z)
    zt = t(z).requires_grad_(True)
    got = pfn(zt)
    got.backward()
    assert np.isfinite(got.item()) and bool(torch.isfinite(zt.grad).all())
    assert np.isfinite(float(want)) and np.isfinite(np.asarray(want_g)).all()
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL, atol=ATOL)
    g, wg = zt.grad.numpy(), np.asarray(want_g)
    # at t = 0.007 a gradient entry carries 1 / t = 143 times the float32
    # rounding of a cosine: the absolute tolerance scales with the largest
    np.testing.assert_allclose(g, wg, rtol=GRAD_TOL["rtol"],
                               atol=max(GRAD_TOL["atol"],
                                        1e-5 * np.abs(wg).max()))


def test_nt_xent_labels_and_the_reference_surface():
    """Pairs of one label are positives, every other label a negative;
    ``LossFunc`` keeps the reference's two static aliases."""
    z = t(np.random.RandomState(1).randn(6, 4).astype(np.float32))
    labels = torch.tensor([0, 0, 1, 1, 2, 2])
    want = jlosses.nt_xent(np.asarray(z), np.asarray(labels), 0.5)
    np.testing.assert_allclose(float(plosses.nt_xent(z, labels, 0.5)),
                               float(want), rtol=RTOL)
    assert plosses.LossFunc.contrastive_loss is plosses.contrastive_loss
    assert plosses.LossFunc.contrastive_loss_ANP is plosses.contrastive_loss_anp


# -- (b) the three FCL methods: views, one train step ---------------------------

def _raw1d(seed=0, hw=32):
    rng = np.random.RandomState(seed)
    lab = lambda n: rng.uniform(0, 2 * np.pi, (T_, n, 1)).astype(np.float32)  # noqa: E731
    return dict(ctx_x=rng.randint(0, 255, (T_, S_, hw, hw, 1)).astype(np.uint8),
                ctx_y=lab(S_),
                ctx_mask=np.arange(S_)[None, :] < np.asarray(SHOTS)[:, None],
                qry_x=rng.randint(0, 255, (T_, Q_, hw, hw, 1)).astype(np.uint8),
                qry_y=lab(Q_))


def _raw_distractor(seed=0, hw=128):
    rng = np.random.RandomState(seed)
    img = lambda n: rng.randint(0, 255, (T_, n, hw, hw, 1)).astype(np.uint8)  # noqa: E731
    lab = lambda n: rng.uniform(24, 104, (T_, n, 2)).astype(np.float32)  # noqa: E731
    return dict(ctx_x=img(S_), ctx_y=lab(S_),
                ctx_mask=np.arange(S_)[None, :] < np.asarray(SHOTS)[:, None],
                qry_x=img(Q_), qry_y=lab(Q_))


def _raw3d(seed=0, hw=64):
    rng = np.random.RandomState(seed)
    quats = lambda n: (lambda q: q / np.linalg.norm(q, axis=-1, keepdims=True))(  # noqa: E731
        rng.randn(T_, n, 4)).astype(np.float32)
    img = lambda n: rng.rand(T_, n, hw, hw, 4).astype(np.float32)  # noqa: E731
    return dict(ctx_x=img(S_), ctx_y=quats(S_),
                ctx_mask=np.arange(S_)[None, :] < np.asarray(SHOTS)[:, None],
                qry_x=img(Q_), qry_y=quats(Q_))


BASE = dict(aug_list=[], tasks_per_batch=T_, max_ctx_num=S_, query_num=Q_,
            lr=1e-4, seed=0, loss_type="mse", device="cpu", contrastive=True,
            contrastive_rate=1)
METHODS = {
    "FCLCNPShapeNet1D": (dict(
        BASE, method="FCLCNPShapeNet1D", task="shapenet_1d", agg_mode="max",
        temperature=0.07, n_hidden_units_r=list(WIDTHS["n_hidden_units_r"]),
        dim_w=WIDTHS["dim_w"], dim_r=WIDTHS["dim_r"], dim_z=WIDTHS["dim_z"]),
        _raw1d, (32, 32, 1)),
    "FCLCNPDistractor": (dict(
        BASE, method="FCLCNPDistractor", task="distractor", agg_mode="max",
        img_agg="max", dim_w=16, temperature=0.07), _raw_distractor,
        (128, 128, 1)),
    "FCLANP": (dict(
        BASE, method="FCLANP", task="shapenet_3d", agg_mode="attention",
        img_agg="reshape", temperature=0.007, gen_bg=False), _raw3d,
        (64, 64, 4)),
}
VIEWS = {"FCLCNPShapeNet1D": ("z_ctx_view", "z_qry_view"),
         "FCLCNPDistractor": ("z_ctx_view", "z_qry_view"),
         "FCLANP": ("qry_rep",)}


def _scaled(params):
    """The trunks' first convolution x 3 (features O(1), as in
    ``test_torch_port_distractor.py``)."""
    for node in (params.get("img_encoder"),
                 params.get("decoder", {}).get("trunk")):
        if node is not None:
            node["conv1"]["kernel"] = node["conv1"]["kernel"] * 3.0
    return params


def _pair(method, seed=0):
    cfg, raw_fn, img_size = METHODS[method]
    raw = raw_fn(seed)
    jcfg = JaxConfig.from_dict(cfg)
    jm = jax_build_model(jcfg)
    pb = jax_processor(jcfg.task, [], train=True)(jax.random.PRNGKey(0), raw)
    variables = to_numpy(jm.init(
        jax.random.PRNGKey(1), pb["ctx_x"], pb["ctx_y"], pb["qry_x"],
        ctx_mask=pb["ctx_mask"]))
    variables["params"] = _scaled(variables["params"])
    pcfg = Config.from_dict(cfg)
    pcfg.img_size = list(img_size)
    pm = load_jax_variables(build_model(pcfg), variables)
    return (jm, jcfg, variables), (pm, pcfg), raw, pb


@pytest.mark.parametrize("method", sorted(METHODS))
def test_fcl_views_and_train_step_match_jax(method):
    """In training: the views the contrastive term reads, the term itself,
    then one train step's total loss and every gradient; in evaluation
    the model gives no views."""
    (jm, jcfg, variables), (pm, pcfg), raw, pb = _pair(method)
    forward = jax_forward(jm, jcfg, train=True)
    loss_func = jlosses.LossFunc(jcfg.loss_type, jcfg.task)

    def loss_fn(params):
        out, b = forward({**variables, "params": params}, raw,
                         jax.random.PRNGKey(3))
        task = loss_func.calc_loss(out.mu.astype(jnp.float32), out.var,
                                   b["qry_y"])
        contra = jax_contra_term(jcfg, out, b)
        return task + float(jcfg.contrastive_rate) * contra, (out, contra)

    (want_loss, (out, contra)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    args = [t(np.asarray(pb[k])) for k in ("ctx_x", "ctx_y", "qry_x")]
    pm.train()
    with torch.no_grad():
        got = pm(*args, ctx_mask=t(np.asarray(pb["ctx_mask"])),
                 qry_y=t(np.asarray(pb["qry_y"])))
    assert set(VIEWS[method]) <= set(got.extras)
    for k in VIEWS[method]:
        np.testing.assert_allclose(got.extras[k].numpy(),
                                   np.asarray(out.extras[k]), err_msg=k,
                                   rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(contra_term(pcfg, got)), float(contra),
                               rtol=RTOL, atol=ATOL)
    assert float(contra) > 0.0
    pm.eval()
    with torch.no_grad():
        ev = pm(*args, ctx_mask=t(np.asarray(pb["ctx_mask"])),
                qry_y=t(np.asarray(pb["qry_y"])))
    assert not set(VIEWS[method]) & set(ev.extras)
    assert contra_term(pcfg, ev) == 0.0

    opt = build_optimizer(pcfg, pm.parameters())
    loss = build_train_step(pm, opt, pcfg)({k: t(v) for k, v in raw.items()})
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=RTOL)
    want = jax_grads_as_port(pm, grads, variables)
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("method", sorted(METHODS))
def test_weight_carry_both_ways(method):
    """JAX variables -> the port -> its ``state_dict`` ->
    ``import_torch_checkpoint`` -> the same JAX variables, bit for bit (FCL
    adds no parameter to its base model)."""
    (_, _, variables), (pm, pcfg), _, _ = _pair(method, seed=1)
    kw = {"FCLCNPShapeNet1D": dict(n_hidden=2, agg_mode="max"),
          "FCLCNPDistractor": dict(agg_mode="max", img_agg="max"),
          "FCLANP": dict(img_agg="reshape")}[method]
    if method == "FCLCNPShapeNet1D":     # the importer reads 128x128 encoders
        cfg = dict(METHODS[method][0])
        x = jnp.zeros((T_, 2, 128, 128, 1), jnp.float32)
        jm = jax_build_model(JaxConfig.from_dict(cfg))
        variables = to_numpy(jm.init(jax.random.PRNGKey(2), x,
                                     jnp.zeros((T_, 2, 3)), x))
        pm = load_jax_variables(build_model(Config.from_dict(cfg)), variables)
    back = import_torch_checkpoint(method, state_dict_to_numpy(
        pm.state_dict()), **kw)
    flat = lambda tree: {jax.tree_util.keystr(k): np.asarray(v)  # noqa: E731
                         for k, v in jax.tree_util.tree_leaves_with_path(tree)}
    want, got = flat(variables), flat(back)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_config_reads_the_contrastive_keys():
    """``contrastive`` (default False), ``contrastive_rate`` (1),
    ``temperature`` (0.07), as the JAX package reads them; the shipped
    FCLANP YAML's t = 0.007."""
    yaml = os.path.join(REPO, "cfg", "train", "contrastive",
                        "FCLANP_DA+TA_ShapeNet3D.yaml")
    cfg = Config(yaml, ["device=cpu"], make_dirs=False)
    assert (cfg.contrastive, cfg.contrastive_rate, cfg.temperature) == (
        True, 1, 0.007)
    plain = Config(os.path.join(REPO, "cfg", "train", "ANP_ShapeNet1D.yaml"),
                   ["device=cpu"], make_dirs=False)
    jplain = JaxConfig(os.path.join(REPO, "cfg", "train",
                                    "ANP_ShapeNet1D.yaml"), [],
                       make_dirs=False)
    for key in ("contrastive", "contrastive_rate", "temperature"):
        assert getattr(plain, key) == getattr(jplain, key), key
    assert (plain.contrastive, plain.contrastive_rate, plain.temperature) == (
        False, 1, 0.07)
