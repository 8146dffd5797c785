"""The port's MAML path against the JAX package on the CPU.

K3's twin ``features_plain`` against the Pallas prototype (interpret mode)
and its XLA reference; the per-task masked BN, encoder and whole
``MAMLRegressor`` against the JAX model under ``vmap``; the outer loss and
its gradients, second and first order, and the eval loss against
``jax.grad`` of ``build_maml_outer``; learnable step sizes. Small widths:
T = 2 tasks, S = 3 padded context rows (one task has 2), Q = 2 queries,
32x32 images, dim_w 36 (a 6x6 map), 8 filters, 2 inner steps.

Tolerance: ``RTOL``/``ATOL`` for values, ``GRAD_TOL`` for gradients
(``torch_port_common``), unless a test says why not.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import ATOL, GRAD_TOL, RTOL, t, to_numpy
from wmfml_tpu.configs import Config as JaxConfig
from wmfml_tpu.models.maml import masked_batch_norm as jax_masked_bn
from wmfml_tpu.models.registry import build_model as jax_build_model
from wmfml_tpu.nn.encoders import LiteratureEncoder as JaxEncoder
from wmfml_tpu.train.maml import build_maml_outer as jax_maml_outer
from wmfml_tpu.train.maml import init_step_sizes
from wmfml_tpu_torch.ckpt.jax_params import (encoder_state_dict,
                                             load_jax_variables, maml_state_dict)
from wmfml_tpu_torch.configs import Config
from wmfml_tpu_torch.kernels import features as kfeatures
from wmfml_tpu_torch.models.registry import build_model
from wmfml_tpu_torch.nn.encoders import PerTaskLiteratureEncoder
from wmfml_tpu_torch.train.maml import build_maml_outer
from torch_port_common import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T_, S_, Q_, HW = 2, 3, 2, 32
SHOTS = (3, 2)
CFG = dict(method="MAMLShapeNet1D", task="shapenet_1d", aug_list=[],
           tasks_per_batch=T_, max_ctx_num=S_, query_num=Q_, dim_w=36,
           num_filters=8, num_updates=2, test_num_updates=2,
           first_order=False, update_lr=0.1, beta=0.0, lr=1e-4, seed=0,
           loss_type="mse", device="cpu",
           # the stock conv stem: the same function as the s2d lowering
           # (held against K1's twin in test_torch_port_kernels.py), and its
           # second-order graph compiles in 40% of the time
           stem_impl="conv")


def _raw_batch(seed=0):
    rng = np.random.RandomState(seed)
    return dict(
        ctx_x=rng.randint(0, 255, (T_, S_, HW, HW, 1)).astype(np.uint8),
        ctx_y=rng.uniform(0, 2 * np.pi, (T_, S_, 1)).astype(np.float32),
        ctx_mask=np.arange(S_)[None, :] < np.asarray(SHOTS)[:, None],
        qry_x=rng.randint(0, 255, (T_, Q_, HW, HW, 1)).astype(np.uint8),
        qry_y=rng.uniform(0, 2 * np.pi, (T_, Q_, 1)).astype(np.float32))


def _pair(**overrides):
    """(JAX model, its config, params tree) and the port model with the
    same weights."""
    cfg = dict(CFG, **overrides)
    jcfg = JaxConfig.from_dict(cfg)
    jmodel = jax_build_model(jcfg)
    x = jnp.zeros((S_, HW, HW, 1), jnp.float32)
    net = to_numpy(jmodel.init({"params": jax.random.PRNGKey(1),
                                "bbb": jax.random.PRNGKey(2)}, x)["params"])
    params = net
    if jcfg.learn_step_size:
        params = {"net": net, "step_size": to_numpy(
            init_step_sizes(jcfg, jmodel, net))}
    pcfg = Config.from_dict(cfg)
    pcfg.img_size = [HW, HW, 1]
    model = load_jax_variables(build_model(pcfg), {"params": params})
    return (jmodel, jcfg, params), (model, pcfg)


# The outer gradient passes through the inner steps and four batch norms,
# whose backward subtracts means (cancellation). Against a float64 run of the
# port, JAX's float32 gradients sit up to 3.2e-4 of each tensor's largest
# entry away, the port's up to 7.5e-5 (measured at these shapes). So each
# tensor also gets an absolute tolerance of 1e-3 of its largest entry.
MAML_GRAD_ATOL = 1e-3


def _assert_grads(model, jax_grads):
    want = maml_state_dict(model, {"params": to_numpy(jax_grads)})
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(want)
    for name, p in model.named_parameters():
        w = want[name].numpy()
        atol = max(GRAD_TOL["atol"], MAML_GRAD_ATOL * np.abs(w).max())
        np.testing.assert_allclose(p.grad.numpy(), w, err_msg=name,
                                   rtol=GRAD_TOL["rtol"], atol=atol)


# -- (a) K3's twin against the Pallas prototype and its XLA reference ----------

def _load_prototype():
    path = os.path.join(REPO, "scripts", "proto_maml_pallas_conv.py")
    spec = importlib.util.spec_from_file_location("proto_maml_pallas_conv",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_features_plain_matches_pallas_prototype_and_xla():
    proto = _load_prototype()
    n, h, w, c, layers = 3, 6, 6, 8, 3
    rng = np.random.RandomState(0)
    x5 = (rng.rand(T_, n, h, w, c) - 0.5).astype(np.float32)
    wts = (rng.rand(T_, layers, 3, 3, c, c) * 0.5 - 0.25).astype(np.float32)
    gam = rng.rand(layers * 2, c).astype(np.float32)
    gam_t = np.broadcast_to(gam, (T_, 2 * layers, c))   # shared by the tasks
    shape = dict(n=n, h=h, w=w, c=c, layers=layers)
    pallas = np.asarray(jax.jit(functools.partial(
        proto.features_block_pallas, interpret=True, **shape))(
        x5.reshape(T_, n * h * w, c), wts.reshape(T_, layers * 9 * c, c),
        gam_t)).reshape(x5.shape)
    xla = np.asarray(proto.features_block_xla(x5, wts, gam_t, **shape))

    got = kfeatures.features_plain(
        t(x5), t(wts).permute(0, 1, 5, 4, 2, 3),          # HWIO -> OIHW
        torch.zeros(T_, layers, c), t(gam[0::2]), t(gam[1::2])).numpy()
    np.testing.assert_allclose(got, xla, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)


# -- (b) masked batch norm ------------------------------------------------------

@pytest.mark.parametrize("masked", [True, False])
def test_masked_batch_norm_matches_jax(masked):
    rng = np.random.RandomState(1)
    x = (rng.randn(T_, S_, 5, 5, 4) * 2 + 1).astype(np.float32)
    scale, bias = rng.rand(4).astype(np.float32), rng.randn(4).astype(np.float32)
    mask = np.arange(S_)[None, :] < np.asarray(SHOTS)[:, None]
    x[1, 2] = 100.0                   # a padded row must not move the stats
    if masked:
        want = jax.vmap(lambda a, m: jax_masked_bn(a, m, scale, bias))(x, mask)
    else:
        want = jax.vmap(lambda a: jax_masked_bn(a, None, scale, bias))(x)
    got = kfeatures.masked_batch_norm(t(x), t(mask) if masked else None,
                                      t(scale), t(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_unmasked_batch_norm_equals_the_all_rows_mask_bit_for_bit():
    """Without a mask the statistics divide by the count, a scalar filled on
    the data's device (no host copy each call): the same true division as
    the masked form's, to the bit (on the card: ``test_torch_port_cuda``)."""
    rng = np.random.RandomState(8)
    x = t((rng.randn(T_, S_, 5, 5, 4) * 2 + 1).astype(np.float32))
    scale, bias = t(rng.rand(4).astype(np.float32)), t(rng.randn(4).astype(
        np.float32))
    every = torch.ones((T_, S_), dtype=torch.bool)
    assert torch.equal(kfeatures.masked_batch_norm(x, None, scale, bias),
                       kfeatures.masked_batch_norm(x, every, scale, bias))


# -- (c) the per-task encoder and the whole regressor -----------------------------

def _per_task(tree, seed):
    """The tree with a different perturbation for each task: [T, ...]."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: np.stack([a + 0.05 * i * rng.randn(*a.shape).astype(a.dtype)
                            for i in range(T_)]), tree)


def test_per_task_encoder_matches_jax_vmap():
    x = np.random.RandomState(2).rand(T_, S_, HW, HW, 1).astype(np.float32)
    jenc = JaxEncoder(dim_w=36, stem_impl="s2d", pool_impl="slice")
    params = _per_task(to_numpy(jenc.init(jax.random.PRNGKey(3), x[0])
                                ["params"]), seed=4)
    want = jax.jit(jax.vmap(lambda p, a: jenc.apply({"params": p}, a)))(
        params, x)

    enc = PerTaskLiteratureEncoder(36, (HW, HW, 1))
    sds = [encoder_state_dict(jax.tree_util.tree_map(lambda a: a[i], params),
                              enc.flatten_chw) for i in range(T_)]
    names = {"0": "layer1.conv", "2": "layer2.conv", "5": "layer3.conv",
             "8": "linear"}
    got = enc(t(x), {f"{names[k.split('.')[0]]}.{k.split('.')[1]}":
                     torch.stack([sd[k] for sd in sds]) for k in sds[0]})
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def test_regressor_with_per_task_weights_matches_jax_vmap():
    (jmodel, _, net), (model, _) = _pair()
    adapt = jmodel.adaptable_param_filter()
    per_task = _per_task(net, seed=5)
    # the BN scale/bias stay shared, as the inner loop leaves them
    per_task = {k: (per_task[k] if adapt((k,)) else
                    np.broadcast_to(net[k], (T_,) + net[k].shape))
                for k in net}
    x = np.random.RandomState(6).rand(T_, S_, HW, HW, 1).astype(np.float32)
    mask = np.arange(S_)[None, :] < np.asarray(SHOTS)[:, None]
    apply = jax.jit(jax.vmap(
        lambda p, a, m: jmodel.apply({"params": p}, a, mask=m)[0]))
    want = apply(per_task, x, mask)

    sds = [maml_state_dict(model, {"params": jax.tree_util.tree_map(
        lambda a: a[i], per_task)}) for i in range(T_)]
    params = {k: torch.stack([sd[k] for sd in sds]) if model.adaptable(k)
              else sds[0][k] for k in sds[0]}
    got = model(t(x), t(mask), params)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    # and with the module's own weights, unmasked (the query pass)
    want_q = apply(jax.tree_util.tree_map(
        lambda a: np.broadcast_to(a, (T_,) + a.shape), net), x,
        np.ones((T_, S_), bool))    # every row counts, as with mask=None
    np.testing.assert_allclose(model(t(x)).detach().numpy(),
                               np.asarray(want_q), rtol=RTOL, atol=ATOL)


# -- (d) outer loss and gradients, (e) step sizes -----------------------------------

@functools.lru_cache(maxsize=None)
def _jax_outer_grad(first_order, learn, per_param):
    (jmodel, jcfg, params), _ = _pair(first_order=first_order,
                                      learn_step_size=learn,
                                      per_param_step_size=per_param)
    outer = jax_maml_outer(jmodel, jcfg, 2, train=True, test=False)
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: outer(p, b, jax.random.PRNGKey(0)), has_aux=True))
    return to_numpy(fn(params, _raw_batch()))


@pytest.mark.parametrize("first_order", [False, True])
def test_outer_loss_and_grads_match_jax(first_order):
    (want_loss, _), want_grads = _jax_outer_grad(first_order, False, False)
    _, (model, pcfg) = _pair(first_order=first_order)
    outer = build_maml_outer(model, pcfg, 2, train=True, test=False)
    loss, pre = outer({k: t(v) for k, v in _raw_batch().items()})
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=RTOL)
    assert loss.item() == pre.item()
    loss.backward()
    _assert_grads(model, want_grads)


def test_second_order_terms_are_what_the_test_sees():
    """The two orders' gradients differ by far more than the tolerance, so
    the test above tells them apart."""
    second = _jax_outer_grad(False, False, False)[1]
    first = _jax_outer_grad(True, False, False)[1]
    diffs = jax.tree_util.tree_map(
        lambda a, b: np.abs(a - b).max() / max(np.abs(a).max(), 1e-12),
        second, first)
    assert max(jax.tree_util.tree_leaves(diffs)) > 10 * MAML_GRAD_ATOL


def test_eval_degree_loss_matches_jax():
    (jmodel, jcfg, params), (model, pcfg) = _pair()
    jouter = jax_maml_outer(jmodel, jcfg, 2, train=False, test=True)
    want = jax.jit(lambda p, b: jouter(p, b, jax.random.PRNGKey(0))[1])(
        params, _raw_batch(1))
    outer = build_maml_outer(model, pcfg, 2, train=False, test=True)
    got = outer({k: t(v) for k, v in _raw_batch(1).items()})[1]
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)


@pytest.mark.parametrize("per_param", [False, True])
def test_learned_step_sizes_receive_jax_gradients(per_param):
    (want_loss, _), want_grads = _jax_outer_grad(False, True, per_param)
    _, (model, pcfg) = _pair(learn_step_size=True,
                             per_param_step_size=per_param)
    ss = dict(model.named_parameters())
    assert any(k.startswith("step_size") for k in ss)
    outer = build_maml_outer(model, pcfg, 2, train=True, test=False)
    loss, _ = outer({k: t(v) for k, v in _raw_batch().items()})
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=RTOL)
    loss.backward()
    _assert_grads(model, want_grads)
    for k, p in ss.items():
        if k.startswith("step_size"):
            assert float(p.grad.abs().max()) > 0, k


# -- the reference's state_dict layout, both ways ------------------------------------

@pytest.mark.parametrize("method", ["MAMLShapeNet1D", "VanillaMAML"])
def test_port_state_dict_imports_into_jax(method):
    # the JAX importer reads the reference's 128x128 literature encoder
    from wmfml_tpu.ckpt.torch_import import (import_torch_checkpoint,
                                             state_dict_to_numpy)
    from wmfml_tpu.models.maml import MAMLRegressor as JaxMAML

    cfg = Config.from_dict(dict(CFG, method=method))
    model = build_model(cfg)
    keys = set(model.state_dict())
    reg = "regressor.regressor" if method == "MAMLShapeNet1D" else "regressor"
    assert {"encoder_w.layer1.conv.weight", "encoder_w.layer3.conv.bias",
            "encoder_w.linear.weight", "features.layer4.norm.bias",
            f"{reg}.weight"} <= keys and len(keys) == 26
    x = np.random.RandomState(7).rand(T_, S_, 128, 128, 1).astype(np.float32)
    with torch.no_grad():
        got = model(t(x)).numpy()
    imported = import_torch_checkpoint(
        method, state_dict_to_numpy(model.state_dict()))
    jmodel = JaxMAML(dim_w=36, dim_hidden=8, output_dim=2,
                     tanh_out=method == "MAMLShapeNet1D")
    want, _ = jax.vmap(lambda a: jmodel.apply(imported, a))(x)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


# -- the trainer CLI end to end on the CPU ------------------------------------------

def test_train_cli_runs_maml_and_validates(tmp_path, monkeypatch):
    from wmfml_tpu_torch.cli import train_cli
    from wmfml_tpu_torch.data.synthetic import generate_shapenet1d
    from wmfml_tpu_torch.train.maml import MAMLTrainer

    data = str(tmp_path / "sn1d")
    generate_shapenet1d(data, seed=0, instances=2 * S_ + 1, val_classes=3,
                        test_classes=2)
    monkeypatch.chdir(tmp_path)
    yaml = os.path.join(REPO, "cfg", "train", "MAML_DA_ShapeNet1D.yaml")
    cfg = Config(yaml, ["aug_list=[]", "device=cpu", f"data_path={data}",
                        "data_size=small", "iterations=2", "val_freq=1",
                        "val_iters=1", f"tasks_per_batch={T_}",
                        f"max_ctx_num={S_}", "dim_w=36", "num_filters=8",
                        "num_updates=1", "test_num_updates=2"])
    assert (cfg.num_steps, cfg.test_num_steps, cfg.dim_hidden,
            cfg.first_order, cfg.update_lr) == (1, 2, 8, False, 0.002)
    trainer = train_cli.train(cfg)
    assert isinstance(trainer, MAMLTrainer) and trainer.step == 2
    metrics = trainer.train_step.metrics
    assert float(metrics["kl"]) == 0.0 and metrics["contra"] == 0.0
    assert float(metrics["loss"]) == float(metrics["task_loss"])
    names = sorted(os.listdir(os.path.join(cfg.save_path, "models")))
    assert names == ["model_best_test.pt", "model_best_validation.pt",
                     "model_end_2.pt", "model_intermediate.pt"]
    with open(os.path.join(cfg.save_path, "metrics.jsonl")) as f:
        tags = [line.split('"tag": "')[1].split('"')[0] for line in f]
    assert tags.count("Loss/train") == 2 and tags.count("Loss/validation") == 2
