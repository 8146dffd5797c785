"""The SingleTask baselines in the port against the JAX package on the CPU.

Held: ``SingleTaskSmall`` (SingleTaskShapeNet1D) and ``SingleTaskLarge``
(SingleTaskShapeNet3D at ``img_agg: reshape`` on 64x64 RGB,
SingleTaskDistractor at ``max`` on 128x128x1) forwards in float32, and
``SingleTaskSmall`` in bfloat16 under the bf16 rule; that the context
moves nothing; the weight carry both ways (``load_jax_variables``, then the
port's ``state_dict`` through ``import_torch_checkpoint`` back to the same
variables, whose JAX forward gives the port's output); one SingleTaskShapeNet1D
train step with JAX's DA and TA draws replayed; the registry and the three
shipped SingleTask YAMLs; a model that ignores the context training through
the fused step. Small sizes: T = 2, 3 context and 2 query rows, narrow
widths. Tolerance: ``RTOL``/``ATOL`` (the step compares the parameters
after Adam's update).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_aug import _jax_process_draws
from torch_port_common import (ATOL, RTOL, WIDTHS, jax_grads_as_port, t,
                               to_numpy)
from wmfml_tpu.ckpt.torch_import import (import_torch_checkpoint,
                                         state_dict_to_numpy)
from wmfml_tpu.configs import Config as JaxConfig
from wmfml_tpu.models.registry import build_model as jax_build_model
from wmfml_tpu.models.single_task import SingleTaskLarge as JaxLarge
from wmfml_tpu.models.single_task import SingleTaskSmall as JaxSmall
from wmfml_tpu.train.state import TrainState
from wmfml_tpu.train.state import build_optimizer as jax_optimizer
from wmfml_tpu.train.steps import build_train_step as jax_train_step
from wmfml_tpu_torch.aug import image_aug
from wmfml_tpu_torch.ckpt.jax_params import load_jax_variables
from wmfml_tpu_torch.cli import train_cli
from wmfml_tpu_torch.configs import Config
from wmfml_tpu_torch.data.synthetic import generate_shapenet1d
from wmfml_tpu_torch.models.registry import build_model
from wmfml_tpu_torch.models.single_task import SingleTaskLarge, SingleTaskSmall
from wmfml_tpu_torch.ops.cast import set_compute_dtype
from wmfml_tpu_torch.train.state import build_optimizer
from wmfml_tpu_torch.train.steps import build_train_step
from torch_port_common import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T_, S_, Q_ = 2, 3, 2
SMALL = dict(dim_w=WIDTHS["dim_w"], n_hidden_units_r=WIDTHS["n_hidden_units_r"],
             dim_r=WIDTHS["dim_r"], dim_z=WIDTHS["dim_z"], y_dim=2)
# (img_agg, image side, channels): SingleTaskShapeNet3D, SingleTaskDistractor
LARGE = {"reshape": (64, 3), "max": (128, 1)}


def _images(rng, n, hw, c):
    return rng.rand(T_, n, hw, hw, c).astype(np.float32)


def _small_pair(hw=32, seed=0):
    jm = JaxSmall(**SMALL)
    x = _images(np.random.RandomState(seed), Q_, hw, 1)
    variables = to_numpy(jm.init(jax.random.PRNGKey(seed), None, None, x))
    # the head x 20, so that mu is O(1) and differs across queries
    head = variables["params"]["decoder0"]["Dense_2"]["Dense_0"]
    head["kernel"] = head["kernel"] * 20.0
    pm = SingleTaskSmall(**SMALL, img_size=(hw, hw, 1))
    return jm, load_jax_variables(pm, variables), variables


def _scaled(params):
    """The trunks' first convolution x 3, so that their features are O(1)
    (as in ``test_torch_port_distractor.py``)."""
    for node in (params["img_encoder"], params["decoder"]["trunk"]):
        node["conv1"]["kernel"] = node["conv1"]["kernel"] * 3.0
    return params


@pytest.fixture(scope="module")
def large_pairs():
    out = {}
    for agg, (hw, c) in LARGE.items():
        jm = JaxLarge(img_agg=agg, y_dim=4 if agg == "reshape" else 2)
        x = _images(np.random.RandomState(1), Q_, hw, c)
        variables = to_numpy(jm.init(jax.random.PRNGKey(2), None, None, x))
        variables["params"] = _scaled(variables["params"])
        pm = SingleTaskLarge(img_agg=agg, y_dim=jm.y_dim,
                             img_size=(hw, hw, c))
        out[agg] = (jm, load_jax_variables(pm, variables), variables)
    return out


def _context(rng, hw, c, label_dim):
    return (t(_images(rng, S_, hw, c)),
            t(rng.rand(T_, S_, label_dim).astype(np.float32)))


# -- forwards ------------------------------------------------------------------

def test_single_task_small_matches_jax_and_ignores_the_context():
    jm, pm, variables = _small_pair()
    rng = np.random.RandomState(3)
    qry = _images(rng, Q_, 32, 1)
    want = jm.apply(variables, None, None, qry)
    ctx_x, ctx_y = _context(rng, 32, 1, 3)
    with torch.no_grad():
        got = pm(ctx_x, ctx_y, t(qry), ctx_mask=torch.ones(T_, S_, dtype=bool))
        other = pm(ctx_x * 0, ctx_y + 1, t(qry))
    np.testing.assert_allclose(got.mu.numpy(), np.asarray(want.mu),
                               rtol=RTOL, atol=ATOL)
    assert torch.equal(got.mu, other.mu)
    assert got.kl == 0.0 and float(want.kl) == 0.0
    assert float(np.abs(np.asarray(want.mu)).max()) > 0.1


@pytest.mark.parametrize("agg", sorted(LARGE))
def test_single_task_large_matches_jax_and_ignores_the_context(large_pairs,
                                                               agg):
    """``reshape`` at 64x64x3 (a CHW / HWC flatten order error shows
    there) and ``max`` at 128x128x1; the query images go through two
    trunks, the encoder's and the decoder's."""
    jm, pm, variables = large_pairs[agg]
    hw, c = LARGE[agg]
    rng = np.random.RandomState(4)
    qry = _images(rng, Q_, hw, c)
    want = jm.apply(variables, None, None, qry)
    ctx_x, ctx_y = _context(rng, hw, c, jm.y_dim)
    with torch.no_grad():
        got = pm(ctx_x, ctx_y, t(qry))
        other = pm(ctx_x + 1, ctx_y * 0, t(qry))
    np.testing.assert_allclose(got.mu.numpy(), np.asarray(want.mu),
                               rtol=RTOL, atol=ATOL)
    assert torch.equal(got.mu, other.mu) and got.kl == 0.0
    assert float(np.abs(np.asarray(want.mu)).max()) > 0.05


def test_single_task_small_in_bf16_follows_the_bf16_rule():
    """The bf16 rule (PERF.md §2): max|port - jax_bf16| <= 2 max|jax_bf16 -
    jax_f32| + 2^-7 max|jax_f32|, and the port nearer jax_bf16 in the
    mean; mu is bfloat16 as JAX's."""
    jm, pm, variables = _small_pair(seed=5)
    jm16 = JaxSmall(**SMALL, dtype=jnp.bfloat16)
    qry = _images(np.random.RandomState(6), Q_, 32, 1)
    want16 = jm16.apply(variables, None, None, qry).mu
    want32 = jm.apply(variables, None, None, qry).mu
    set_compute_dtype(pm, torch.bfloat16)
    with torch.no_grad():
        got = pm(None, None, t(qry)).mu
    assert got.dtype == torch.bfloat16 and want16.dtype == jnp.bfloat16
    g = got.float().numpy()
    wb, wf = (np.asarray(w.astype(jnp.float32)) for w in (want16, want32))
    err = np.abs(g - wb).max()
    bound = 2 * np.abs(wb - wf).max() + 2.0 ** -7 * np.abs(wf).max()
    assert err <= bound, (err, bound)
    near, far = np.abs(g - wb).mean(), np.abs(g - wf).mean()
    assert near < far or near == 0, (near, far)


# -- the weight carry -------------------------------------------------------------

def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("method", ["SingleTaskShapeNet1D",
                                    "SingleTaskShapeNet3D",
                                    "SingleTaskDistractor"])
def test_weight_carry_both_ways(method, large_pairs):
    """JAX variables -> the port -> its ``state_dict`` ->
    ``import_torch_checkpoint`` -> the same variables bit for bit, whose
    JAX forward gives the port's output (the importer reads ShapeNet1D's
    encoder at 128x128)."""
    if method == "SingleTaskShapeNet1D":
        jm, pm, variables = _small_pair(hw=128, seed=7)
        hw, c, kw = 128, 1, dict(n_hidden=2)
    else:
        agg = "reshape" if method == "SingleTaskShapeNet3D" else "max"
        jm, pm, variables = large_pairs[agg]
        (hw, c), kw = LARGE[agg], dict(img_agg=agg)
    back = import_torch_checkpoint(method, state_dict_to_numpy(
        pm.state_dict()), **kw)
    want, got = _flat(variables), _flat(back)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    qry = _images(np.random.RandomState(8), Q_, hw, c)
    with torch.no_grad():
        port = pm(None, None, t(qry)).mu.numpy()
    np.testing.assert_allclose(np.asarray(jm.apply(back, None, None, qry).mu),
                               port, rtol=RTOL, atol=ATOL)


# -- one train step, the registry, the YAMLs ---------------------------------------

STEP_CFG = dict(method="SingleTaskShapeNet1D", task="shapenet_1d",
                agg_mode="", aug_list=["task_aug", "data_aug"],
                tasks_per_batch=T_, max_ctx_num=S_, query_num=Q_,
                dim_w=WIDTHS["dim_w"], dim_r=WIDTHS["dim_r"],
                dim_z=WIDTHS["dim_z"],
                n_hidden_units_r=list(WIDTHS["n_hidden_units_r"]), lr=1e-3,
                seed=0, loss_type="mse", optimizer="Adam", device="cpu")


def _raw_episode(seed, hw=128):
    rng = np.random.RandomState(seed)
    return dict(
        ctx_x=rng.randint(0, 255, (T_, S_, hw, hw, 1)).astype(np.uint8),
        ctx_y=rng.uniform(0, 2 * np.pi, (T_, S_, 1)).astype(np.float32),
        ctx_mask=np.arange(S_)[None, :].repeat(T_, 0) < 2,
        qry_x=rng.randint(0, 255, (T_, Q_, hw, hw, 1)).astype(np.uint8),
        qry_y=rng.uniform(0, 2 * np.pi, (T_, Q_, 1)).astype(np.float32))


def test_one_train_step_with_da_and_ta_matches_jax():
    """SingleTask_DA+TA_ShapeNet1D's step (T1) at small widths: JAX's
    image DA draws (both image sets, the context's unused by the model)
    and TA offsets replayed; the loss and every parameter after Adam's
    update."""
    jcfg = JaxConfig.from_dict(STEP_CFG)
    jmodel = jax_build_model(jcfg)
    raw = _raw_episode(9)
    variables = to_numpy(jmodel.init(jax.random.PRNGKey(1), None, None,
                                     raw["qry_x"].astype(np.float32)))
    pcfg = Config.from_dict(STEP_CFG)
    model = load_jax_variables(build_model(pcfg), variables)
    key = jax.random.PRNGKey(3)
    da, ta = _jax_process_draws(jax.random.split(key)[0], raw)
    tx = jax_optimizer(jcfg)
    state = TrainState.create(jax.tree_util.tree_map(np.array, variables), tx)
    state, metrics = jax_train_step(jmodel, jcfg, tx=tx)(state, raw, key)
    step = build_train_step(model, build_optimizer(pcfg, model.parameters()),
                            pcfg)
    loss = step({k: t(v) for k, v in raw.items()}, ta_idx=ta, da_params=da)
    np.testing.assert_allclose(loss.item(), float(metrics["loss"]), rtol=RTOL)
    want = jax_grads_as_port(model, state.params, variables)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("name,cls,trunk_channels", [
    ("SingleTask_DA+TA_ShapeNet1D.yaml", SingleTaskSmall, None),
    ("SingleTask_DA+TA_Distractor.yaml", SingleTaskLarge, 1),
    ("SingleTask_DA+TA_ShapeNet3D.yaml", SingleTaskLarge, 3),
])
def test_shipped_single_task_yamls_build(name, cls, trunk_channels):
    """Each shipped SingleTask YAML builds its model at full width with the
    reference's keys (the JAX importer's), ShapeNet3D's trunks on 3 of the 4
    channels; Distractor's ``dim_w: 16`` is read and unused, as in JAX."""
    cfg = Config(os.path.join(REPO, "cfg", "train", name), ["device=cpu"],
                 make_dirs=False)
    model = build_model(cfg)
    assert type(model) is cls
    if trunk_channels is not None:
        for trunk in (model.img_encoder, model.decoder):
            assert trunk.conv1.in_channels == trunk_channels
    kw = {"SingleTaskShapeNet1D": dict(n_hidden=2)}.get(
        cfg.method, dict(img_agg=cfg.img_agg))
    variables = import_torch_checkpoint(cfg.method, state_dict_to_numpy(
        model.state_dict()), **kw)
    assert _flat(variables)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sn1d_single_task"))
    generate_shapenet1d(root, seed=0, instances=2 * S_ + 1, val_classes=2,
                        test_classes=2)
    return root


def test_single_task_trains_through_the_fused_step(data_dir, tmp_path,
                                                   monkeypatch):
    """``train_cli`` with SingleTask_DA+TA_ShapeNet1D.yaml on the CPU: the
    device sampler still draws context rows and DA still runs on them (two
    augmenter calls a step), the model reads the queries alone, and the
    fused K-step call trains (the loss moves, checkpoints written)."""
    monkeypatch.chdir(tmp_path)
    cfg = Config(os.path.join(REPO, "cfg", "train",
                              "SingleTask_DA+TA_ShapeNet1D.yaml"),
                 ["device=cpu", f"data_path={data_dir}", "data_size=small",
                  f"max_ctx_num={S_}", f"query_num={Q_}", "iterations=4",
                  "steps_per_call=2", "val_freq=2", "val_iters=1",
                  f"tasks_per_batch={T_}", "lr=1e-2"])
    trainer = train_cli.build_trainer(cfg)
    calls = []
    real = image_aug.Augmenter.__call__

    def counted(self, x, *args, **kw):
        calls.append(tuple(x.shape))
        return real(self, x, *args, **kw)

    monkeypatch.setattr(image_aug.Augmenter, "__call__", counted)
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    trainer.train()
    assert trainer.step == 4
    assert calls[:2] == [(T_, S_, 128, 128, 1), (T_, Q_, 128, 128, 1)]
    assert len(calls) == 8
    moved = [k for k, v in trainer.model.state_dict().items()
             if not torch.equal(v, before[k])]
    assert len(moved) == len(before)
    assert os.path.exists(trainer.ckpt.path("model_end_4"))
