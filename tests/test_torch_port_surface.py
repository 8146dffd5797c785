"""The surface modules of the port against their JAX counterparts, on the
same inputs from numpy seeds: ``models/meta_models.py`` (MetaConvModel and
MetaMLPModel in the per-task form, values and parameter gradients, the
adaptable filter, one MAML inner loop through ``train/maml.py``),
``nn/encoders.py:Bottleneck`` (float32 and bfloat16), and the numpy
helpers ``data/normalize_label.py``, ``utils/algebra.py`` and
``utils/misc.py``. Tolerance: ``RTOL``/``ATOL`` for values; gradients
within rtol 1e-4 and 1e-5 of each tensor's largest.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_bf16 import _as_written, assert_bf16_close
from torch_port_common import ATOL, RTOL, t, to_numpy
from wmfml_tpu.data import normalize_label as jnorm
from wmfml_tpu.models.meta_models import MetaConvModel as JaxMetaConv
from wmfml_tpu.models.meta_models import MetaMLPModel as JaxMetaMLP
from wmfml_tpu.nn.encoders import Bottleneck as JaxBottleneck
from wmfml_tpu.utils import algebra as jalg
from wmfml_tpu.utils import misc as jmisc
from wmfml_tpu_torch.ckpt.jax_params import jax_to_state_dict, load_jax_variables
from wmfml_tpu_torch.configs import Config
from wmfml_tpu_torch.data import normalize_label as pnorm
from wmfml_tpu_torch.models.meta_models import MetaConvModel, MetaMLPModel
from wmfml_tpu_torch.nn.encoders import Bottleneck
from wmfml_tpu_torch.ops.cast import set_compute_dtype
from wmfml_tpu_torch.train.maml import build_maml_outer
from wmfml_tpu_torch.utils import algebra as palg
from wmfml_tpu_torch.utils import misc as pmisc

T, N, HW = 2, 5, 32


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for each test: at these sizes torch's threads
    only add synchronisation under ``pytest -n`` (every worker's threads on
    the same cores); the previous count is restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _grad_close(got, want, name=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max(), err_msg=name)


def _inputs(seed=0, c=1):
    rng = np.random.RandomState(seed)
    x = rng.rand(T, N, HW, HW, c).astype(np.float32)
    mask = np.arange(N)[None, :] < np.asarray([5, 3])[:, None]
    cot = rng.randn(T, N, 3).astype(np.float32)
    return x, mask, cot


def _meta_pair(kind, seed=0):
    """The JAX model, its variables (batch-norm scale and bias moved off
    1 and 0) and the port's model with them."""
    x, mask, _ = _inputs(seed)
    if kind == "conv":
        jm = JaxMetaConv(out_features=3, hidden_size=8)
        pm = MetaConvModel(3, hidden_size=8, img_size=(HW, HW, 1))
    else:
        jm = JaxMetaMLP(out_features=3, hidden_sizes=(16, 12))
        pm = MetaMLPModel(HW * HW, 3, hidden_sizes=(16, 12))
    variables = to_numpy(jm.init(jax.random.PRNGKey(seed), x[0], mask[0]))
    rng = np.random.RandomState(seed + 1)
    for k, v in variables["params"].items():
        if "_bn_" in k:
            variables["params"][k] = (v + 0.3 * rng.randn(*v.shape)).astype(
                np.float32)
    return jm, variables, load_jax_variables(pm, variables)


@pytest.mark.parametrize("kind", ["conv", "mlp"])
def test_meta_models_match_jax_per_task(kind):
    """The JAX one-task forward ``vmap``ped over tasks (with each task's
    mask) against the port's per-task form: values, and every parameter's
    gradient of a seeded cotangent."""
    jm, variables, pm = _meta_pair(kind)
    x, mask, cot = _inputs(1)

    def jax_out(params):
        return jax.vmap(lambda a, m: jm.apply({"params": params}, a, m)[0])(
            x, mask)

    want = np.asarray(jax_out(variables["params"]))
    jgrads = jax.grad(lambda p: jnp.sum(jax_out(p) * cot))(
        variables["params"])
    got = pm(t(x), t(mask))
    (got * t(cot)).sum().backward()
    assert got.shape == (T, N, 3) and np.abs(want).max() > 0.05
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL)
    want_grads = jax_to_state_dict(pm, {"params": to_numpy(jgrads)})
    # a conv bias before a batch norm has no gradient but rounding: held at
    # 1e-5 of the model's largest gradient
    scale = max(float(g.abs().max()) for g in want_grads.values())
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(),
                                   rtol=1e-4, atol=1e-5 * scale,
                                   err_msg=name)
    assert pm.forward_with_kl(t(x), t(mask))[1] == 0.0


def test_adaptable_filter_is_jaxs():
    """Everything but the batch-norm scale and bias adapts, as the JAX
    ``adaptable_param_filter`` says."""
    jconv = JaxMetaConv(out_features=3).adaptable_param_filter()
    conv = MetaConvModel(3, hidden_size=8, img_size=(HW, HW, 1))
    for jax_name, name in (("layer1_bn_scale", "features.layer1.norm.weight"),
                           ("layer2_bn_bias", "features.layer2.norm.bias"),
                           ("layer3_conv", "features.layer3.conv.weight"),
                           ("classifier", "classifier.bias")):
        assert conv.adaptable(name) == jconv((jax_name,)), name
        assert conv.adaptable_param_filter()(name) == conv.adaptable(name)
    mlp = MetaMLPModel(HW * HW, 3)
    assert all(mlp.adaptable(k) for k, _ in mlp.named_parameters())
    assert JaxMetaMLP(out_features=3).adaptable_param_filter()(("layer1",))


def test_meta_conv_runs_maml_inner_loop_as_jax():
    """Two inner SGD steps of the conv model on each task's context (its
    mask), then the query loss, through ``train/maml.py``'s outer loop,
    against the same in JAX: one ``vmap``ped ``grad`` per step over the
    adaptable parameters."""
    cfg = Config.from_dict(dict(
        method="MAMLShapeNet1D", task="pascal_1d", aug_list=[],
        tasks_per_batch=T, max_ctx_num=N, query_num=N, num_updates=2,
        update_lr=0.01, first_order=False, beta=0.0, lr=1e-4, seed=0,
        loss_type="mse", device="cpu"))
    rng = np.random.RandomState(3)
    raw = dict(ctx_x=rng.randint(0, 255, (T, N, HW, HW, 1)).astype(np.uint8),
               ctx_y=rng.rand(T, N, 1).astype(np.float32),
               ctx_mask=np.arange(N)[None, :] < np.asarray([5, 3])[:, None],
               qry_x=rng.randint(0, 255, (T, N, HW, HW, 1)).astype(np.uint8),
               qry_y=rng.rand(T, N, 1).astype(np.float32))
    jm1 = JaxMetaConv(out_features=1, hidden_size=8)
    v1 = to_numpy(jm1.init(jax.random.PRNGKey(2), raw["ctx_x"][0] / 255.0))
    pm = load_jax_variables(MetaConvModel(1, hidden_size=8,
                                          img_size=(HW, HW, 1)), v1)
    outer = build_maml_outer(pm, cfg, num_steps=2, train=True, test=False)
    loss, _ = outer({k: t(v) for k, v in raw.items()})
    adapt = jm1.adaptable_param_filter()
    x = {k: raw[k].astype(np.float32) / 255.0 for k in ("ctx_x", "qry_x")}
    y = {k: raw[k] * 10.0 for k in ("ctx_y", "qry_y")}

    def task_loss(params, xs, ys, m=None):
        out = jm1.apply({"params": params}, xs, m)[0]
        se = (out - ys) ** 2
        if m is None:
            return jnp.mean(se)
        w = m[:, None].astype(se.dtype)
        return jnp.sum(se * w) / jnp.maximum(jnp.sum(w), 1.0)

    def one_task(xc, yc, mc, xq, yq):
        params = v1["params"]
        for _ in range(2):
            g = jax.grad(task_loss)(params, xc, yc, mc)
            params = {k: jax.tree_util.tree_map(lambda a, b: a - 0.01 * b, p,
                                                g[k]) if adapt((k,)) else p
                      for k, p in params.items()}
        return task_loss(params, xq, yq)

    want = jnp.mean(jax.vmap(one_task)(x["ctx_x"], y["ctx_y"],
                                       raw["ctx_mask"], x["qry_x"],
                                       y["qry_y"]))
    assert 0.5 < float(want) < 100.0
    np.testing.assert_allclose(float(loss), float(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("stride,c_in", [(2, 32), (1, 64)],
                         ids=["downsample", "identity"])
def test_bottleneck_matches_jax(stride, c_in):
    """Values and gradients in float32; in bfloat16 within the bf16 rule,
    the three norms' statistics in float32 and var clamped at 0."""
    rng = np.random.RandomState(4)
    x = rng.randn(3, 16, 16, c_in).astype(np.float32)
    jm = JaxBottleneck(planes=16, stride=stride)
    variables = to_numpy(jm.init(jax.random.PRNGKey(0), x))
    for k, v in variables["params"].items():
        if k.startswith("bn"):
            variables["params"][k] = (v + 0.3 * rng.randn(*v.shape)).astype(
                np.float32)
    pm = load_jax_variables(Bottleneck(c_in, 16, stride), variables)
    assert (pm.downsample is None) == (stride == 1 and c_in == 64)
    cot = rng.randn(*jm.apply(variables, x).shape).astype(np.float32)
    want = np.asarray(jm.apply(variables, x))
    jgrads = jax.grad(lambda p: jnp.sum(jm.apply({"params": p}, x) * cot))(
        variables["params"])
    xp = t(x).permute(0, 3, 1, 2)
    got = pm(xp)
    (got * t(cot).permute(0, 3, 1, 2)).sum().backward()
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), want,
                               rtol=RTOL, atol=ATOL)
    want_grads = jax_to_state_dict(pm, {"params": to_numpy(jgrads)})
    for name, p in pm.named_parameters():
        _grad_close(p.grad.numpy(), want_grads[name].numpy(), name)
    xb = jnp.asarray(x, jnp.bfloat16)
    want_bf16 = _as_written(jax.jit(lambda v, a: JaxBottleneck(
        planes=16, stride=stride, dtype=jnp.bfloat16).apply(v, a)),
        variables, xb)
    want_f32 = jm.apply(variables, xb.astype(jnp.float32))
    set_compute_dtype(pm, torch.bfloat16)
    with torch.no_grad():
        got = pm(t(np.asarray(xb.astype(jnp.float32))).to(
            torch.bfloat16).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.dtype == torch.bfloat16
    assert_bf16_close(got, want_bf16, want_f32, "bottleneck bf16")


def test_normalize_label_matches_jax(tmp_path):
    rng = np.random.RandomState(5)
    data = (rng.randint(0, 255, (4, 6, 8, 8, 1)).astype(np.uint8),
            rng.randn(4, 6, 3).astype(np.float32))
    path = tmp_path / "train_data.pkl"
    with open(path, "wb") as f:
        pickle.dump(data, f)
    for got, want in zip(pnorm.compute_label_stats(str(path)),
                         jnorm.compute_label_stats(str(path))):
        assert np.array_equal(got, want)
    got = pnorm.normalize_labels(str(path), str(tmp_path / "port.npz"))
    want = jnorm.normalize_labels(str(path), str(tmp_path / "jax.npz"))
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    a, b = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert np.array_equal(a["mean"], b["mean"])
    assert np.array_equal(a["std"], b["std"])
    default = pnorm.normalize_labels(str(path))
    assert (tmp_path / "label_stats.npz").exists()
    assert all(np.array_equal(a, b) for a, b in zip(default, want))


def test_algebra_matches_jax():
    values = np.random.RandomState(6).randn(17)
    assert palg.mean_std(values) == jalg.mean_std(values)
    for p1, p2 in (((0.0, 1.0), (2.0, 5.0)), ((1.5, -2.0), (1.5, 3.0)),
                   ((-1.0, 0.5), (3.0, 0.5))):
        assert palg.line_equation(p1, p2) == jalg.line_equation(p1, p2)
    assert palg.point_on_line(2.0, 1.0, 3.0) == jalg.point_on_line(2.0, 1.0,
                                                                   3.0)


def test_misc_matches_jax():
    for index in (0, 7, 35):
        assert np.allclose(pmisc.convert_index_to_angle(index, 36),
                           jmisc.convert_index_to_angle(index, 36), rtol=0,
                           atol=0)
    a, b = np.arange(10), np.arange(10) * 2
    got = pmisc.shuffle_batch(a, b, rng=np.random.RandomState(7))
    want = jmisc.shuffle_batch(a, b, rng=np.random.RandomState(7))
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert np.array_equal(
        pmisc.shuffle_batch(a, rng=np.random.RandomState(8)),
        jmisc.shuffle_batch(a, rng=np.random.RandomState(8)))
    logits = np.random.RandomState(9).randn(20, 4)
    targets = np.random.RandomState(10).randint(0, 4, 20)
    assert (pmisc.compute_accuracy(logits, targets)
            == jmisc.compute_accuracy(logits, targets))
    values = np.random.RandomState(11).randn(30)
    for confidence in (0.95, 0.9):
        assert (pmisc.mean_confidence_interval(values, confidence)
                == jmisc.mean_confidence_interval(values, confidence))
    assert pmisc.mean_confidence_interval([2.0]) == (2.0, 0.0)
