"""Meta-regularization (MR, Bayes-by-Backprop) in the port against the JAX
package on the CPU.

The random streams differ (Philox against threefry), so every comparison
feeds JAX's own draws into the port: ``jax_draws`` records each
``jax.random.normal`` of an eager JAX apply, ``port_eps`` turns them into
the port's layouts (conv HWIO -> OIHW, dense [in, out] -> [out, in], the
literature encoder's fc with the HWC -> CHW flatten permutation) and an
``EpsFeed`` hands them to the port's BBB layers in call order. MAMLMR's
per-task, per-step draws are replayed from JAX's key derivation
(``k_model`` -> ``split(k_model, T)`` -> ``split(task_key, steps + 1)``,
one eager apply per task and step).

Held: the BBB layers and both encoders (output, kl, gradients on
``W_mu``/``W_rho`` and the bias posteriors); the four SmallCNP MR methods
and ANPMRShapeNet3D (forward, one train step's loss and gradients, one
with beta = 1 so that a wrong kl cannot hide under beta = 1e-7); MAMLMR's
second-order outer step and its evaluation; the init statistics; the weight
carry both ways for all seven; bfloat16 for SmallCNP MR and the BBB trunk;
that a generator draws new weights each call and the same for one seed.
Small widths: T = 2, a few points, 32x32 (literature) or 64x64 (trunk)
images. Tolerance: ``RTOL``/``ATOL`` for values, ``GRAD_TOL`` for
gradients, the kl by rtol (it sums thousands of terms in float32), unless a
test says why not.
"""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import (ATOL, GRAD_TOL, RTOL, WIDTHS, jax_grads_as_port,
                               t, to_numpy)
from wmfml_tpu.aug.pipeline import build_episode_processor as jax_processor
from wmfml_tpu.ckpt.torch_import import (import_torch_checkpoint,
                                         state_dict_to_numpy)
from wmfml_tpu.configs import Config as JaxConfig
from wmfml_tpu.losses import LossFunc as JaxLoss
from wmfml_tpu.models.registry import build_model as jax_build_model
from wmfml_tpu.nn import bbb as jbbb
from wmfml_tpu.train.maml import build_maml_outer as jax_maml_outer
from wmfml_tpu.train.steps import make_forward as jax_forward
from wmfml_tpu_torch.ckpt.jax_params import (_conv, _dense_after_flatten,
                                             bbb_encoder_state_dict,
                                             bbb_trunk_state_dict,
                                             jax_to_state_dict,
                                             load_jax_variables)
from wmfml_tpu_torch.configs import Config
from wmfml_tpu_torch.models.registry import build_model
from wmfml_tpu_torch.nn.bbb import (BBBConv, BBBLinear, BBBLiteratureEncoder,
                                    BBBResNetTrunk, EpsFeed)
from wmfml_tpu_torch.ops.cast import set_compute_dtype
from wmfml_tpu_torch.train.maml import build_maml_eval_step, build_maml_outer
from wmfml_tpu_torch.train.state import build_optimizer
from wmfml_tpu_torch.train.steps import build_eval_step, build_train_step
from torch_port_common import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T_, S_, Q_, HW = 2, 3, 2, 32
SHOTS = (3, 2)
KL_RTOL = 1e-5


@contextlib.contextmanager
def jax_draws():
    """Every ``jax.random.normal`` drawn inside the block (eager applies
    only), as numpy, in call order; Flax's shape checks of the parameter
    initialisers (traced, abstract) are not draws."""
    draws, orig = [], jax.random.normal

    def normal(key, shape=(), dtype=jnp.float32):
        out = orig(key, shape, dtype)
        if not isinstance(out, jax.core.Tracer):
            draws.append(np.asarray(out))
        return out

    jax.random.normal = normal
    try:
        yield draws
    finally:
        jax.random.normal = orig


def port_eps(draws, chw=None):
    """JAX's draws in the port's layouts; a 2-D draw with C h w rows reads
    the literature encoder's HWC flatten."""
    out = []
    for d in draws:
        if d.ndim == 4:
            out.append(_conv(d))
        elif d.ndim == 2:
            flat = chw is not None and d.shape[0] == int(np.prod(chw))
            out.append(_dense_after_flatten(d, chw if flat else None))
        else:
            out.append(t(d))
    return out


def _kl_close(got, want):
    np.testing.assert_allclose(float(torch.as_tensor(got).detach()),
                               float(want), rtol=KL_RTOL)


def _raw(task, seed=0, hw=HW):
    """A raw episode of ``task`` (uint8 images; ShapeNet1D angles,
    Pascal1D values)."""
    rng = np.random.RandomState(seed)
    lab = (lambda n: rng.uniform(0, 2 * np.pi, (T_, n, 1))) if task == \
        "shapenet_1d" else (lambda n: rng.uniform(0, 1, (T_, n, 1)))
    return dict(
        ctx_x=rng.randint(0, 255, (T_, S_, hw, hw, 1)).astype(np.uint8),
        ctx_y=lab(S_).astype(np.float32),
        ctx_mask=np.arange(S_)[None, :] < np.asarray(SHOTS)[:, None],
        qry_x=rng.randint(0, 255, (T_, Q_, hw, hw, 1)).astype(np.uint8),
        qry_y=lab(Q_).astype(np.float32))


# -- (a) the layers and encoders, with JAX's draws --------------------------------

def _grads_of(loss_fn, variables):
    """(loss, aux, gradients) of ``loss_fn`` at ``variables["params"]`` and
    its draws: the draws from an eager forward, the gradients jitted (the
    same keys draw the same)."""
    with jax_draws() as draws:
        loss_fn(variables["params"])
    (loss, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    return loss, aux, to_numpy(grads), draws


@pytest.mark.parametrize("kind", ["dense", "conv"])
def test_bbb_layer_matches_jax(kind):
    """Output, kl, and the gradients of a loss on both on W_mu, W_rho,
    bias_mu and bias_rho."""
    rng = np.random.RandomState(0)
    if kind == "dense":
        jl, pl = jbbb.BBBDense(5), BBBLinear(7, 5)
        x, to_port, wl = rng.randn(4, 7), (lambda y: y), (lambda w: w.T)
    else:
        jl = jbbb.BBBConv(6, (3, 3), strides=2, padding=[(1, 1), (1, 1)])
        pl = BBBConv(3, 6, 3, 2, 1)
        x = rng.randn(2, 8, 8, 3)
        to_port = lambda y: np.transpose(y, (0, 3, 1, 2))   # noqa: E731
        wl = lambda w: np.transpose(w, (3, 2, 0, 1))         # noqa: E731
    x = x.astype(np.float32)
    variables = to_numpy(jl.init({"params": jax.random.PRNGKey(0),
                                  "bbb": jax.random.PRNGKey(1)}, x))

    def loss_fn(p):
        y, kl = jl.apply({"params": p}, x, rngs={"bbb": jax.random.PRNGKey(2)})
        return jnp.sum(y * jnp.cos(y)) + 3.0 * kl, (y, kl)

    _, (y, kl), grads, draws = _grads_of(loss_fn, variables)
    assert len(draws) == 2
    p = variables["params"]
    pl.load_state_dict({k: t(wl(p[k]) if k.startswith("W") else p[k])
                        for k in ("W_mu", "W_rho", "bias_mu", "bias_rho")})
    x_in = t(x) if kind == "dense" else t(x).permute(0, 3, 1, 2)
    got, got_kl = pl(x_in, EpsFeed([t(wl(draws[0])), t(draws[1])]))
    np.testing.assert_allclose(got.detach().numpy(), to_port(np.asarray(y)),
                               rtol=RTOL, atol=ATOL)
    _kl_close(got_kl, kl)
    ((got * torch.cos(got)).sum() + 3.0 * got_kl).backward()
    for k in ("W_mu", "W_rho", "bias_mu", "bias_rho"):
        want = wl(grads[k]) if k.startswith("W") else grads[k]
        np.testing.assert_allclose(getattr(pl, k).grad.numpy(), want,
                                   err_msg=k, **GRAD_TOL)


def _encoder_pair(seed=0):
    jenc = jbbb.BBBLiteratureEncoder(dim_w=16)
    x = np.random.RandomState(seed).rand(T_ * S_, HW, HW, 1).astype(np.float32)
    variables = to_numpy(jenc.init({"params": jax.random.PRNGKey(seed),
                                    "bbb": jax.random.PRNGKey(9)}, x))
    penc = BBBLiteratureEncoder(16, (HW, HW, 1))
    penc.load_state_dict(bbb_encoder_state_dict(variables["params"],
                                                penc.flatten_chw))
    return jenc, penc, variables, x


def _assert_encoder_grads(penc, grads):
    want = bbb_encoder_state_dict(grads, penc.flatten_chw)
    for name, p in penc.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   err_msg=name, **GRAD_TOL)


def test_literature_encoder_matches_jax():
    """The shared form (one sample for the batch): K1's twin on the
    sampled stem weights, conv2, the fc; output, kl and every posterior
    gradient."""
    jenc, penc, variables, x = _encoder_pair()

    def loss_fn(p):
        y, kl = jenc.apply({"params": p}, x,
                           rngs={"bbb": jax.random.PRNGKey(3)})
        return jnp.sum(jnp.sin(y)) + 2.0 * kl, (y, kl)

    _, (y, kl), grads, draws = _grads_of(loss_fn, variables)
    got, got_kl = penc(t(x), EpsFeed(port_eps(draws, penc.flatten_chw)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y),
                               rtol=RTOL, atol=ATOL)
    _kl_close(got_kl, kl)
    (torch.sin(got).sum() + 2.0 * got_kl).backward()
    _assert_encoder_grads(penc, grads)


def test_per_task_encoder_matches_jax_per_task_keys():
    """The per-task form: task i draws with its own key in JAX and reads
    sample i of [T, ...] draws in the port (K1's per-task twin)."""
    jenc, penc, variables, x = _encoder_pair(1)
    x = x.reshape(T_, S_, HW, HW, 1)
    keys = jax.random.split(jax.random.PRNGKey(4), T_)

    def loss_fn(p):
        ys, kls = [], []
        for i in range(T_):
            y, kl = jenc.apply({"params": p}, x[i], rngs={"bbb": keys[i]})
            ys.append(y)
            kls.append(kl)
        y = jnp.stack(ys)
        return jnp.sum(jnp.sin(y)) + 2.0 * kls[0], (y, kls)

    _, (y, kls), grads, draws = _grads_of(loss_fn, variables)
    per = len(draws) // T_
    eps = [torch.stack(pair) for pair in zip(*(
        port_eps(draws[i * per:(i + 1) * per], penc.flatten_chw)
        for i in range(T_)))]
    got, got_kl = penc.per_task(t(x), EpsFeed(eps))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y),
                               rtol=RTOL, atol=ATOL)
    _kl_close(got_kl, kls[0])
    _kl_close(kls[0], kls[1])          # the posterior's kl, the same per task
    (torch.sin(got).sum() + 2.0 * got_kl).backward()
    _assert_encoder_grads(penc, grads)


def _hwc_to_chw(y, img_agg, b):
    """JAX's HWC-flattened trunk features in the port's CHW order."""
    if img_agg == "mean":
        return y
    hw = 2 if img_agg == "max" else HW3 // 32
    return y.reshape(b, hw, hw, 64).transpose(0, 3, 1, 2).reshape(b, -1)


HW3 = 64


def _trunk_scaled(params):
    """BBB trunk posteriors with W_mu x 0.3 and W_rho - 1 (a sample's
    spread ~0.035), so that 13 convolutions keep the features O(1), where
    float32's rtol 1e-5 holds per element."""
    out = jax.tree_util.tree_map(np.array, params)
    for node in out.values():
        node["W_mu"] *= 0.3
        node["W_rho"] -= 1.0
    return out


@pytest.mark.parametrize("img_agg", ["reshape", "max", "mean"])
def test_bbb_trunk_matches_jax(img_agg):
    """ANPMRShapeNet3D's trunk at 64x64x3: 13 biased BBB convs (the 3x3
    stride-2 "downsample"), ``img_agg``; output, kl, gradients."""
    jtr = jbbb.BBBResNetTrunk(img_agg=img_agg)
    x = np.random.RandomState(2).rand(2, HW3, HW3, 3).astype(np.float32)
    variables = to_numpy(jtr.init({"params": jax.random.PRNGKey(5),
                                   "bbb": jax.random.PRNGKey(6)}, x))
    variables = {"params": _trunk_scaled(variables["params"])}

    def loss_fn(p):
        y, kl = jtr.apply({"params": p}, x,
                          rngs={"bbb": jax.random.PRNGKey(7)})
        return jnp.sum(jnp.sin(y)) + 2.0 * kl, (y, kl)

    if img_agg == "reshape":
        _, (y, kl), grads, draws = _grads_of(loss_fn, variables)
    else:
        with jax_draws() as draws:
            _, (y, kl) = loss_fn(variables["params"])
    assert len(draws) == 26
    ptr = BBBResNetTrunk(img_agg, 3)
    ptr.load_state_dict(bbb_trunk_state_dict(variables["params"]))
    got, got_kl = ptr(t(x), EpsFeed(port_eps(draws)))
    np.testing.assert_allclose(got.detach().numpy(),
                               _hwc_to_chw(np.asarray(y), img_agg, 2),
                               rtol=RTOL, atol=ATOL)
    _kl_close(got_kl, kl)
    if img_agg != "reshape":      # the pooling alone differs: forward only
        return
    (torch.sin(got).sum() + 2.0 * got_kl).backward()
    want = bbb_trunk_state_dict(grads)
    for name, p in ptr.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   err_msg=name, **GRAD_TOL)


# -- (b) the SmallCNP MR methods and ANPMRShapeNet3D: forward, one train step ---

SMALL = [("CNPMR", "pascal_1d", "mean"), ("CNPMRShapeNet1D", "shapenet_1d", "max"),
         ("ANPMR", "pascal_1d", "attention"),
         ("ANPMRShapeNet1D", "shapenet_1d", "attention")]


def _small_cfg(method, task, agg_mode, **over):
    return dict(dict(
        method=method, task=task, agg_mode=agg_mode, aug_list=[],
        tasks_per_batch=T_, max_ctx_num=S_, query_num=Q_, lr=1e-4,
        seed=0, loss_type="mse", device="cpu", beta=1e-4,
        n_hidden_units_r=list(WIDTHS["n_hidden_units_r"]),
        dim_w=WIDTHS["dim_w"], dim_r=WIDTHS["dim_r"],
        dim_z=WIDTHS["dim_z"]), **over)


def _pair(cfg, raw, img_size, trunk_scaled=False):
    """(JAX model, config, variables), the port model with its weights,
    its config, and JAX's processed episode."""
    jcfg = JaxConfig.from_dict(cfg)
    jm = jax_build_model(jcfg)
    pb = jax_processor(jcfg.task, [], train=True)(jax.random.PRNGKey(0), raw)
    variables = to_numpy(jm.init(
        {"params": jax.random.PRNGKey(1), "bbb": jax.random.PRNGKey(2)},
        pb["ctx_x"], pb["ctx_y"], pb["qry_x"], ctx_mask=pb["ctx_mask"]))
    if trunk_scaled:
        variables["params"]["img_encoder"] = _trunk_scaled(
            variables["params"]["img_encoder"])
    pcfg = Config.from_dict(cfg)
    pcfg.img_size = list(img_size)
    pm = load_jax_variables(build_model(pcfg), variables)
    return (jm, jcfg, variables), (pm, pcfg), pb


def _jax_step(jm, jcfg, variables, raw):
    """JAX's train-step loss (``wmfml_tpu/train/steps.py:build_train_step``'s
    ``loss_fn``, eager) and gradients, with its BBB draws."""
    forward = jax_forward(jm, jcfg, train=True)
    loss_func = JaxLoss(jcfg.loss_type, jcfg.task)

    def loss_fn(params):
        out, pb = forward({**variables, "params": params}, raw,
                          jax.random.PRNGKey(3))
        task = loss_func.calc_loss(out.mu.astype(jnp.float32), out.var,
                                   pb["qry_y"])
        return task + float(jcfg.beta) * out.kl, out

    return _grads_of(loss_fn, variables)


def _port_step(pm, pcfg, raw, eps):
    opt = build_optimizer(pcfg, pm.parameters())
    # no augmentation: the step's generator draws the BBB weights alone
    loss = build_train_step(pm, opt, pcfg)(
        {k: t(v) for k, v in raw.items()}, EpsFeed(eps))
    return loss


def _assert_forward(pm, pb, eps, want):
    """The port's training forward on JAX's draws: mu, and the kl of the
    query pass."""
    args = [t(np.asarray(pb[k])) for k in ("ctx_x", "ctx_y", "qry_x")]
    with torch.no_grad():
        got = pm(*args, ctx_mask=t(np.asarray(pb["ctx_mask"])),
                 qry_y=t(np.asarray(pb["qry_y"])), generator=EpsFeed(eps))
    np.testing.assert_allclose(got.mu.numpy(), np.asarray(want.mu),
                               rtol=RTOL, atol=ATOL)
    _kl_close(got.kl, want.kl)


def _assert_step(pm, variables, got_loss, want_loss, grads):
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=RTOL)
    want = jax_grads_as_port(pm, grads, variables)
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("method,task,agg_mode", SMALL)
def test_small_mr_forward_and_train_step_match_jax(method, task, agg_mode):
    """Forward (mu, kl from the query pass) on JAX's draws, the query pass
    drawing first; then one train step (beta 1e-4): loss and every
    gradient."""
    raw = _raw(task)
    (jm, jcfg, variables), (pm, pcfg), pb = _pair(
        _small_cfg(method, task, agg_mode), raw, (HW, HW, 1))
    loss, want, grads, draws = _jax_step(jm, jcfg, variables, raw)
    assert len(draws) == 16
    eps = port_eps(draws, pm.encoder_w0.flatten_chw)
    _assert_forward(pm, pb, eps, want)
    _assert_step(pm, variables, _port_step(pm, pcfg, raw, eps), loss, grads)


def test_kl_and_its_gradients_at_beta_one():
    """beta = 1: the kl is most of the loss, so the step's loss and the
    W_mu / W_rho gradients hold the kl on its own, where beta = 1e-7 (the
    shipped value) would hide any error in it."""
    raw = _raw("shapenet_1d", seed=3)
    (jm, jcfg, variables), (pm, pcfg), _ = _pair(
        _small_cfg("CNPMRShapeNet1D", "shapenet_1d", "max", beta=1.0), raw,
        (HW, HW, 1))
    loss, out, grads, draws = _jax_step(jm, jcfg, variables, raw)
    assert float(out.kl) > 100 * abs(float(loss) - float(out.kl))
    got = _port_step(pm, pcfg, raw, port_eps(draws, pm.encoder_w0.flatten_chw))
    _assert_step(pm, variables, got, loss, grads)


def _raw3d(seed=0, hw=HW3):
    """A raw ShapeNet3D episode (float RGBA, quaternions)."""
    rng = np.random.RandomState(seed)
    quats = lambda n: (lambda q: q / np.linalg.norm(q, axis=-1, keepdims=True))(  # noqa: E731
        rng.randn(T_, n, 4)).astype(np.float32)
    x = lambda n: rng.rand(T_, n, hw, hw, 4).astype(np.float32)  # noqa: E731
    return dict(ctx_x=x(S_), ctx_y=quats(S_),
                ctx_mask=np.arange(S_)[None, :] < np.asarray(SHOTS)[:, None],
                qry_x=x(Q_), qry_y=quats(Q_))


def _cfg3d(method, **over):
    return dict(dict(method=method, task="shapenet_3d", agg_mode="attention",
                     img_agg="reshape", aug_list=[], tasks_per_batch=T_,
                     max_ctx_num=S_, query_num=Q_, lr=1e-4, seed=0,
                     loss_type="mse", device="cpu", beta=1e-7, gen_bg=False),
                **over)


def test_anpmr_shapenet3d_forward_and_train_step_match_jax():
    """ANPMRShapeNet3D at 64x64 RGB, img_agg reshape: the BBB trunk over the
    context, then over the queries (its kl), each with its own draws; the
    plain decoder trunk; FAVOR at h 256. Forward and one train step."""
    raw = _raw3d()
    (jm, jcfg, variables), (pm, pcfg), pb = _pair(_cfg3d("ANPMRShapeNet3D"),
                                                  raw, (HW3, HW3, 4),
                                                  trunk_scaled=True)
    loss, want, grads, draws = _jax_step(jm, jcfg, variables, raw)
    assert len(draws) == 52
    _assert_forward(pm, pb, port_eps(draws), want)
    _assert_step(pm, variables, _port_step(pm, pcfg, raw, port_eps(draws)),
                 loss, grads)


# -- (c) MAMLMR: second-order outer step with per-task, per-step draws --------

MAML_CFG = dict(method="MAMLMRShapeNet1D", task="shapenet_1d", aug_list=[],
                tasks_per_batch=T_, max_ctx_num=S_, query_num=Q_, dim_w=36,
                num_filters=8, num_updates=2, test_num_updates=3,
                first_order=False, update_lr=0.1, beta=1.0, lr=1e-4, seed=0,
                loss_type="mse", device="cpu")


def _maml_pair(**over):
    cfg = dict(MAML_CFG, **over)
    jcfg = JaxConfig.from_dict(cfg)
    jm = jax_build_model(jcfg)
    x = jnp.zeros((S_, HW, HW, 1), jnp.float32)
    net = to_numpy(jm.init({"params": jax.random.PRNGKey(1),
                            "bbb": jax.random.PRNGKey(2)}, x)["params"])
    pcfg = Config.from_dict(cfg)
    pcfg.img_size = [HW, HW, 1]
    pm = load_jax_variables(build_model(pcfg), {"params": net})
    return (jm, jcfg, net), (pm, pcfg)


def _maml_eps(jm, net, steps, chw, key=jax.random.PRNGKey(0)):
    """JAX's draws of ``build_maml_outer(...)(params, batch, key)``, replayed:
    k_model -> a key per task -> a key per inner step and the query pass,
    one eager apply each; stacked per task in the port's order."""
    _, k_model = jax.random.split(key)
    x = jnp.zeros((1, HW, HW, 1), jnp.float32)
    per_task = []
    for tkey in jax.random.split(k_model, T_):
        drawn = []
        for skey in jax.random.split(tkey, steps + 1):
            with jax_draws() as draws:
                jm.apply({"params": net}, x, rngs={"bbb": skey})
            drawn += port_eps(draws, chw)
        per_task.append(drawn)
    return [torch.stack(d) for d in zip(*per_task)]


def _assert_maml_grads(pm, grads):
    from wmfml_tpu_torch.ckpt.jax_params import maml_state_dict

    want = maml_state_dict(pm, {"params": to_numpy(grads)})
    assert sorted(n for n, _ in pm.named_parameters()) == sorted(want)
    for name, p in pm.named_parameters():
        w = want[name].numpy()
        # the outer gradient passes the inner steps and four batch norms
        # (test_torch_port_maml.py: MAML_GRAD_ATOL)
        atol = max(GRAD_TOL["atol"], 1e-3 * np.abs(w).max())
        np.testing.assert_allclose(p.grad.numpy(), w, err_msg=name,
                                   rtol=GRAD_TOL["rtol"], atol=atol)


def test_mamlmr_second_order_step_matches_jax(method="MAMLMRShapeNet1D"):
    """One second-order outer step (2 inner steps, beta = 1): every task
    and step draws its own encoder sample (distinct draws, checked); the
    encoder stays frozen in the inner loop; loss = mean(losses + kl); the
    gradients on W_mu / W_rho reach them through the inner loop and K1's
    backward."""
    (jm, jcfg, net), (pm, pcfg) = _maml_pair(method=method)
    assert not any(pm.adaptable(k) for k in pm.state_dict()
                   if k.startswith("encoder_w."))
    outer = jax_maml_outer(jm, jcfg, 2, train=True, test=False)
    raw = _raw("shapenet_1d")
    (want, pre), grads = jax.jit(jax.value_and_grad(
        lambda p: outer(p, raw, jax.random.PRNGKey(0)), has_aux=True))(net)
    eps = _maml_eps(jm, net, 2, pm.encoder_w.flatten_chw)
    assert len(eps) == 3 * 8
    assert not torch.equal(eps[0][0], eps[0][1])      # task 0 vs task 1
    assert not torch.equal(eps[0], eps[8])            # step 0 vs step 1
    loss, got_pre = build_maml_outer(pm, pcfg, 2, train=True, test=False)(
        {k: t(v) for k, v in raw.items()}, noise=EpsFeed(eps))
    np.testing.assert_allclose(loss.item(), float(want), rtol=RTOL)
    np.testing.assert_allclose(got_pre.item(), float(pre), rtol=RTOL)
    assert float(want) - float(pre) > 10.0            # the kl is in it
    loss.backward()
    _assert_maml_grads(pm, grads)


def test_mamlmr_eval_loss_matches_jax():
    """Evaluation (MAMLMR, no Tanh): ``test_num_updates`` inner steps, each
    with its draws, the degree metric before the kl."""
    (jm, jcfg, net), (pm, pcfg) = _maml_pair(method="MAMLMR")
    outer = jax_maml_outer(jm, jcfg, 3, train=False, test=True)
    raw = _raw("shapenet_1d", 1)
    want = jax.jit(lambda p: outer(p, raw, jax.random.PRNGKey(5))[1])(net)
    eps = _maml_eps(jm, net, 3, pm.encoder_w.flatten_chw,
                    jax.random.PRNGKey(5))
    got = build_maml_eval_step(pm, pcfg)({k: t(v) for k, v in raw.items()},
                                         EpsFeed(eps))
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)


# -- (d) init, sampling, the weight carry, bfloat16 -------------------------------

def test_init_statistics():
    """mu ~ N(0, 0.1), rho ~ -3 + N(0, 0.1) on every BBB layer of the
    shipped ANPMRShapeNet1D (about 300k posterior entries), as in JAX."""
    cfg = Config(os.path.join(REPO, "cfg", "train", "ANPMR_DA+TA_ShapeNet1D.yaml"),
                 ["device=cpu"],
                 make_dirs=False)
    sd = build_model(cfg).state_dict()
    mus = torch.cat([v.flatten() for k, v in sd.items() if "_mu" in k])
    rhos = torch.cat([v.flatten() for k, v in sd.items() if "_rho" in k])
    assert mus.numel() == rhos.numel() > 250_000
    for x, mean in ((mus, 0.0), (rhos, -3.0)):
        assert abs(float(x.mean()) - mean) < 2e-3
        assert abs(float(x.std()) - 0.1) < 2e-3


def test_each_call_draws_new_weights_and_one_seed_the_same():
    cfg = _small_cfg("ANPMRShapeNet1D", "shapenet_1d", "attention")
    pcfg = Config.from_dict(cfg)
    pcfg.img_size = [HW, HW, 1]
    pm = build_model(pcfg)
    step = build_eval_step(pm, pcfg)
    batch = {k: t(v) for k, v in _raw("shapenet_1d", 6).items()}
    gen = torch.Generator().manual_seed(0)
    a, b = step(batch, gen), step(batch, gen)
    c = step(batch, torch.Generator().manual_seed(0))
    assert float(a) != float(b) and float(a) == float(c)
    with pytest.raises(ValueError, match="EpsFeed"):
        step(batch)


MR_METHODS = {
    "CNPMR": dict(task="pascal_1d", agg_mode="max"),
    "CNPMRShapeNet1D": dict(task="shapenet_1d", agg_mode="max"),
    "ANPMR": dict(task="pascal_1d", agg_mode="attention"),
    "ANPMRShapeNet1D": dict(task="shapenet_1d", agg_mode="attention"),
}


@pytest.mark.parametrize("method", sorted(MR_METHODS) + [
    "ANPMRShapeNet3D", "MAMLMR", "MAMLMRShapeNet1D"])
def test_weight_carry_both_ways(method):
    """JAX variables -> the port (``load_jax_variables``) -> its
    ``state_dict`` -> ``import_torch_checkpoint`` -> the same JAX variables,
    bit for bit, at the reference's image sizes (the importer reads 128x128
    literature encoders and 64x64 ShapeNet3D trunks)."""
    if method.startswith("MAML"):
        cfg = dict(MAML_CFG, method=method)
        x = jnp.zeros((1, 128, 128, 1), jnp.float32)
        init = lambda m: m.init({"params": jax.random.PRNGKey(1),  # noqa: E731
                                 "bbb": jax.random.PRNGKey(2)}, x)
        kw = {}
    elif method == "ANPMRShapeNet3D":
        cfg = _cfg3d(method)
        x = jnp.zeros((T_, 2, HW3, HW3, 3), jnp.float32)
        y = jnp.zeros((T_, 2, 4), jnp.float32)
        init = lambda m: m.init({"params": jax.random.PRNGKey(1),  # noqa: E731
                                 "bbb": jax.random.PRNGKey(2)}, x, y, x)
        kw = {"img_agg": "reshape"}
    else:
        cfg = _small_cfg(method, **MR_METHODS[method])
        x = jnp.zeros((T_, 2, 128, 128, 1), jnp.float32)
        y = jnp.zeros((T_, 2, 3 if "ShapeNet1D" in method else 1), jnp.float32)
        init = lambda m: m.init({"params": jax.random.PRNGKey(1),  # noqa: E731
                                 "bbb": jax.random.PRNGKey(2)}, x, y, x)
        kw = dict(n_hidden=2, **({} if method.startswith("ANP") else
                                 {"agg_mode": "max"}))
    jm = jax_build_model(JaxConfig.from_dict(cfg))
    variables = to_numpy(init(jm))
    pm = load_jax_variables(build_model(Config.from_dict(cfg)), variables)
    back = import_torch_checkpoint(method, state_dict_to_numpy(
        pm.state_dict()), **kw)
    flat = lambda tree: {jax.tree_util.keystr(k): np.asarray(v)  # noqa: E731
                         for k, v in jax.tree_util.tree_leaves_with_path(tree)}
    want, got = flat(variables), flat(back)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert any("W_rho" in k for k in pm.state_dict())
    assert set(jax_to_state_dict(pm, variables)) == set(pm.state_dict())


def _bf16_close(got, want_bf16, want_f32, name):
    """PERF.md's bf16 rule: max|port - jax_bf16| <= 2 max|jax_bf16 -
    jax_f32| + 2^-7 max|jax_f32|, and the port nearer jax_bf16 in the
    mean."""
    g = got.detach().float().numpy()
    wb, wf = (np.asarray(jnp.asarray(w).astype(jnp.float32))
              for w in (want_bf16, want_f32))
    err = np.abs(g - wb).max()
    bound = 2 * np.abs(wb - wf).max() + 2.0 ** -7 * np.abs(wf).max()
    assert err <= bound, f"{name}: {err} > {bound}"
    near, far = np.abs(g - wb).mean(), np.abs(g - wf).mean()
    assert near < far or near == 0, f"{name}: {near} >= {far}"


def test_small_mr_in_bf16_follows_the_bf16_rule():
    """ANPMRShapeNet1D in bfloat16: the BBB layers sample in float32 and
    cast the sample and their input after sampling (mu in bf16, kl in
    float32, the same as in float32)."""
    raw = _raw("shapenet_1d", seed=7)
    cfg = _small_cfg("ANPMRShapeNet1D", "shapenet_1d", "attention")
    (jm, jcfg, variables), (pm, pcfg), pb = _pair(cfg, raw, (HW, HW, 1))
    jm16 = jax_build_model(JaxConfig.from_dict(dict(cfg,
                                                    compute_dtype="bfloat16")))
    set_compute_dtype(pm, torch.bfloat16)
    outs = []
    for m in (jm16, jm):
        with jax_draws() as draws:
            outs.append(m.apply(variables, pb["ctx_x"], pb["ctx_y"],
                                pb["qry_x"], ctx_mask=pb["ctx_mask"],
                                rngs={"bbb": jax.random.PRNGKey(4)}))
    args = [t(np.asarray(pb[k])) for k in ("ctx_x", "ctx_y", "qry_x")]
    with torch.no_grad():
        got = pm(*args, ctx_mask=t(np.asarray(pb["ctx_mask"])),
                 generator=EpsFeed(port_eps(draws, pm.encoder_w0.flatten_chw)))
    assert got.mu.dtype == torch.bfloat16 and got.kl.dtype == torch.float32
    _bf16_close(got.mu, outs[0].mu, outs[1].mu, "mu")
    _kl_close(got.kl, outs[0].kl)


def test_bbb_trunk_in_bf16_follows_the_bf16_rule():
    x = np.random.RandomState(8).rand(2, HW3, HW3, 3).astype(np.float32)
    jtr16, jtr = (jbbb.BBBResNetTrunk(img_agg="reshape", dtype=d)
                  for d in (jnp.bfloat16, None))
    variables = to_numpy(jtr.init({"params": jax.random.PRNGKey(5),
                                   "bbb": jax.random.PRNGKey(6)}, x))
    variables = {"params": _trunk_scaled(variables["params"])}
    outs = []
    for m in (jtr16, jtr):
        with jax_draws() as draws:
            outs.append(m.apply(variables, x,
                                rngs={"bbb": jax.random.PRNGKey(7)})[0])
    ptr = BBBResNetTrunk("reshape", 3)
    ptr.load_state_dict(bbb_trunk_state_dict(variables["params"]))
    ptr.compute_dtype = torch.bfloat16
    with torch.no_grad():
        got, _ = ptr(t(x), EpsFeed(port_eps(draws)))
    assert got.dtype == torch.bfloat16
    _bf16_close(got, *(_hwc_to_chw(np.asarray(o.astype(jnp.float32)),
                                   "reshape", 2) for o in outs), "trunk")
