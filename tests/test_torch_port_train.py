"""The port's data, episode processing, losses and training against the JAX
package, and its trainer CLI end to end on the CPU.

Synthetic data and host episode draws are byte-identical; one Adam step from
the same parameters on the same batch, with the same task-augmentation
offsets fed in, leaves the same parameters; validation on the same host
episodes gives the same degree loss.
"""

import glob
import os

import jax
import numpy as np
import pytest
import torch

from torch_port_common import (ATOL, RTOL, WIDTHS, jax_grads_as_port, t,
                               to_numpy)
from wmfml_tpu.aug.pipeline import build_episode_processor as jax_processor
from wmfml_tpu.configs import Config as JaxConfig
from wmfml_tpu.data.shapenet_1d import ShapeNet1D as JaxShapeNet1D
from wmfml_tpu.data.synthetic import generate_shapenet1d as jax_generate
from wmfml_tpu.losses import losses as jlosses
from wmfml_tpu.models.registry import build_model as jax_build_model
from wmfml_tpu.ops import setops as jsetops
from wmfml_tpu.train.state import TrainState, build_optimizer as jax_optimizer
from wmfml_tpu.train.steps import build_eval_step as jax_eval_step
from wmfml_tpu.train.steps import build_train_step as jax_train_step
from wmfml_tpu.train.steps import init_model as jax_init_model
from wmfml_tpu_torch.aug.pipeline import build_episode_processor
from wmfml_tpu_torch.ckpt.jax_params import load_jax_variables
from wmfml_tpu_torch.cli import train_cli
from wmfml_tpu_torch.configs import Config
from wmfml_tpu_torch.data.device_sampler import DeviceEpisodeSampler
from wmfml_tpu_torch.data.shapenet_1d import ShapeNet1D
from wmfml_tpu_torch.data.synthetic import generate_shapenet1d
from wmfml_tpu_torch.losses import losses as plosses
from wmfml_tpu_torch.models.registry import build_model
from wmfml_tpu_torch.ops import setops as psetops
from wmfml_tpu_torch.train.state import build_optimizer
from wmfml_tpu_torch.train.steps import build_eval_step, build_train_step
from wmfml_tpu_torch.train.trainer import episode_to_device
from torch_port_common import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAIN_YAML = os.path.join(REPO, "cfg", "train", "ANP_DA+TA_ShapeNet1D.yaml")
T_, S_, Q_ = 2, 4, 3

CFG = dict(method="ANPShapeNet1D", task="shapenet_1d", agg_mode="attention",
           aug_list=["task_aug"], tasks_per_batch=T_, max_ctx_num=S_,
           query_num=Q_, dim_w=WIDTHS["dim_w"], dim_r=WIDTHS["dim_r"],
           dim_z=WIDTHS["dim_z"],
           n_hidden_units_r=list(WIDTHS["n_hidden_units_r"]), lr=1e-4,
           seed=0, loss_type="mse", weight_decay=False, optimizer="Adam",
           val_iters=2, val_freq=1, iterations=3, data_size="small",
           device="cpu")


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sn1d"))
    generate_shapenet1d(root, seed=0, instances=S_ + Q_ + 1, val_classes=3,
                        test_classes=2)
    return root


def _pair(cfg=CFG):
    """(port model + config, JAX model + config + variables), same weights."""
    jcfg = JaxConfig.from_dict(cfg)
    jmodel = jax_build_model(jcfg)
    variables = to_numpy(jax_init_model(jmodel, jcfg, jax.random.PRNGKey(1)))
    pcfg = Config.from_dict(cfg)
    model = load_jax_variables(build_model(pcfg), variables)
    return (model, pcfg), (jmodel, jcfg, variables)


# -- data ----------------------------------------------------------------------

def test_synthetic_data_is_byte_identical(tmp_path):
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    generate_shapenet1d(a, seed=3, instances=2, val_classes=2, test_classes=2)
    jax_generate(b, seed=3, instances=2, val_classes=2, test_classes=2)
    names = sorted(os.listdir(b))
    assert names == sorted(os.listdir(a)) and len(names) == 5
    for name in names:
        with open(os.path.join(a, name), "rb") as fa, \
                open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name


def test_host_episodes_are_identical(data_dir):
    kw = dict(img_size=[128, 128, 1], seed=42, data_size="small",
              max_ctx=S_, query_num=Q_)
    port, ref = ShapeNet1D(data_dir, **kw), JaxShapeNet1D(data_dir, **kw)
    for source in ("train", "validation", "test"):
        for _ in range(3):
            got = port.get_batch_indices(source, T_, S_)
            want = ref.get_batch_indices(source, T_, S_)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
        port.reset_eval(source)
        ref.reset_eval(source)
        got, want = port.get_batch(source, T_, S_), ref.get_batch(source, T_, S_)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_device_sampler_episode_semantics():
    rng = np.random.RandomState(0)
    x = rng.randint(0, 255, (5, 9, 8, 8, 1)).astype(np.uint8)
    y = rng.rand(5, 9, 1).astype(np.float32)
    sampler = DeviceEpisodeSampler(x, y, max_ctx=S_, query=Q_, shot_min=3,
                                   label_scale=2 * np.pi, device="cpu")
    gen = torch.Generator().manual_seed(0)
    shots = set()
    for _ in range(20):
        b = sampler.sample(T_, gen)
        assert tuple(b["ctx_x"].shape) == (T_, S_, 8, 8, 1)
        assert tuple(b["qry_x"].shape) == (T_, Q_, 8, 8, 1)
        shot = int(b["ctx_mask"][0].sum())
        assert 3 <= shot <= S_ and bool(b["ctx_mask"][:, :shot].all())
        shots.add(shot)
        both = torch.cat([b["ctx_y"], b["qry_y"]], 1)[..., 0] / (2 * np.pi)
        for task in both.numpy():         # instances without replacement
            assert len(set(np.round(task, 6))) == S_ + Q_
    assert shots == {3, 4}


def test_task_augmentation_matches_jax_for_the_same_offsets():
    rng = np.random.RandomState(1)
    raw = dict(ctx_x=rng.randint(0, 255, (T_, S_, 8, 8, 1)).astype(np.uint8),
               ctx_y=rng.uniform(0, 2 * np.pi, (T_, S_, 1)).astype(np.float32),
               ctx_mask=np.ones((T_, S_), bool),
               qry_x=rng.randint(0, 255, (T_, Q_, 8, 8, 1)).astype(np.uint8),
               qry_y=rng.uniform(0, 2 * np.pi, (T_, Q_, 1)).astype(np.float32))
    key = jax.random.PRNGKey(9)
    want = jax_processor("shapenet_1d", ["task_aug"], train=True)(key, raw)
    _, k_ta = jax.random.split(key)
    idx = np.asarray(jax.random.randint(k_ta, (T_, 1, 1), 0, 15)).ravel()
    got = build_episode_processor("shapenet_1d", ["task_aug"], train=True)(
        {k: t(v) for k, v in raw.items()}, ta_idx=t(idx))
    for k in ("ctx_x", "qry_x", "ctx_y", "qry_y"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


# -- losses and set ops ---------------------------------------------------------

@pytest.mark.parametrize("name", ["azimuth_loss", "degree_loss",
                                  "mean_square_loss"])
def test_losses_match_jax(name):
    rng = np.random.RandomState(2)
    a = rng.uniform(0, 2 * np.pi, (T_, Q_, 1)).astype(np.float32)
    gt = np.concatenate([np.cos(a), np.sin(a), a], -1)
    pr = np.tanh(rng.randn(T_, Q_, 2)).astype(np.float32)
    if name == "mean_square_loss":
        gt = gt[..., :2]
    mask = rng.rand(T_, Q_) > 0.3
    for m in (None, mask):
        want = getattr(jlosses, name)(gt, pr, m)
        got = getattr(plosses, name)(t(gt), t(pr), None if m is None else t(m))
        np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)


@pytest.mark.parametrize("op", ["masked_mean", "masked_max", "baco"])
def test_setops_match_jax(op):
    rng = np.random.RandomState(3)
    x = rng.randn(3, S_, 5).astype(np.float32)
    var = (0.1 + rng.rand(3, S_, 5)).astype(np.float32)
    mask = np.arange(S_)[None, :] < np.array([0, 2, S_])[:, None]
    if op == "baco":
        got = psetops.baco(t(x), t(var), t(mask))
        want = jsetops.baco(x, var, mask)
    else:
        got = (getattr(psetops, op)(t(x), t(mask)),)
        want = (getattr(jsetops, op)(x, mask),)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


# -- training --------------------------------------------------------------------

def test_one_adam_step_matches_jax():
    (model, pcfg), (jmodel, jcfg, variables) = _pair()
    rng = np.random.RandomState(4)
    batch = dict(
        ctx_x=rng.randint(0, 255, (T_, S_, 128, 128, 1)).astype(np.uint8),
        ctx_y=rng.uniform(0, 2 * np.pi, (T_, S_, 1)).astype(np.float32),
        ctx_mask=np.arange(S_)[None, :].repeat(T_, 0) < 3,
        qry_x=rng.randint(0, 255, (T_, Q_, 128, 128, 1)).astype(np.uint8),
        qry_y=rng.uniform(0, 2 * np.pi, (T_, Q_, 1)).astype(np.float32))
    key = jax.random.PRNGKey(7)
    # the offsets JAX's train step draws: key -> (k_aug, _) -> (_, k_ta)
    _, k_ta = jax.random.split(jax.random.split(key)[0])
    ta_idx = np.asarray(jax.random.randint(k_ta, (T_, 1, 1), 0, 15)).ravel()

    tx = jax_optimizer(jcfg)
    state = TrainState.create(jax.tree_util.tree_map(np.array, variables), tx)
    state, metrics = jax_train_step(jmodel, jcfg, tx=tx)(state, batch, key)

    step = build_train_step(model, build_optimizer(pcfg, model.parameters()),
                            pcfg)
    loss = step({k: t(v) for k, v in batch.items()}, ta_idx=t(ta_idx))
    np.testing.assert_allclose(loss.item(), float(metrics["loss"]), rtol=RTOL)
    want = jax_grads_as_port(model, state.params, variables)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def test_validation_degree_loss_matches_jax(data_dir):
    cfg = dict(CFG, data_size="small")
    (model, pcfg), (jmodel, jcfg, variables) = _pair(cfg)
    kw = dict(img_size=[128, 128, 1], seed=42, data_size="small",
              max_ctx=S_, query_num=Q_)
    port, ref = ShapeNet1D(data_dir, **kw), JaxShapeNet1D(data_dir, **kw)
    port.reset_eval("validation")
    ref.reset_eval("validation")
    state = TrainState.create(variables, jax_optimizer(jcfg))
    jstep, pstep = jax_eval_step(jmodel, jcfg), build_eval_step(model, pcfg)
    for v in range(2):
        want = jstep(state, ref.get_batch("validation", T_, S_),
                     jax.random.PRNGKey(v))
        got = pstep(episode_to_device(port.get_batch("validation", T_, S_),
                                      "cpu"))
        np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)


def test_train_cli_runs_three_steps_and_writes_checkpoints(data_dir, tmp_path,
                                                          monkeypatch):
    monkeypatch.chdir(tmp_path)
    train_cli.main(["--config", MAIN_YAML, "aug_list=[task_aug]", "device=cpu",
                    f"data_path={data_dir}", "data_size=small",
                    "iterations=3", "val_freq=2", "val_iters=1",
                    f"tasks_per_batch={T_}", f"max_ctx_num={S_}",
                    "dim_w=16", "dim_r=12", "dim_z=8"])
    runs = glob.glob("results/train/ANPShapeNet1D/*")
    assert len(runs) == 1
    names = sorted(os.listdir(os.path.join(runs[0], "models")))
    assert names == ["model_best_test.pt", "model_best_validation.pt",
                     "model_end_3.pt", "model_intermediate.pt"]
    payload = torch.load(os.path.join(runs[0], "models", "model_end_3.pt"),
                         weights_only=True)
    assert payload["step"] == 3
    cfg = Config(MAIN_YAML, ["aug_list=[task_aug]", "device=cpu", "dim_w=16",
                             "dim_r=12", "dim_z=8"], make_dirs=False)
    build_model(cfg).load_state_dict(payload["model"])
    with open(os.path.join(runs[0], "metrics.jsonl")) as f:
        tags = [line.split('"tag": "')[1].split('"')[0] for line in f]
    assert tags.count("Loss/train") == 2 and tags.count("Loss/test") == 2
    assert os.path.exists(os.path.join(runs[0], "best_validation_error.txt"))


def test_trainer_resumes_from_its_checkpoint(data_dir, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    overrides = ["aug_list=[task_aug]", "device=cpu", f"data_path={data_dir}",
                 "data_size=small", "val_freq=100", "val_iters=1",
                 f"tasks_per_batch={T_}", f"max_ctx_num={S_}", "dim_w=16",
                 "dim_r=12", "dim_z=8", "steps_per_call=2"]
    first = train_cli.train(Config(MAIN_YAML, overrides + ["iterations=4"]))
    assert first.step == 4
    ckpt = first.ckpt.path("model_end_4")
    second = train_cli.train(Config(MAIN_YAML, overrides + [
        "iterations=6", f"checkpoint={ckpt}"]))
    assert second.step == 6
    resumed = torch.load(ckpt, weights_only=True)["model"]
    # the checkpoint gives its generator state back; a bare reference
    # state_dict restores too (model only, step 0, the generator as seeded)
    model = build_model(Config(MAIN_YAML, overrides, make_dirs=False))
    gen = torch.Generator().manual_seed(7)
    assert second.ckpt.restore(ckpt, model, generator=gen) == 4
    assert torch.equal(gen.get_state(),
                       torch.load(ckpt, weights_only=True)["generator"])
    bare = str(tmp_path / "bare.pt")
    torch.save(resumed, bare)
    seeded = torch.Generator().manual_seed(7)
    assert second.ckpt.restore(bare, model, generator=seeded) == 0
    assert torch.equal(seeded.get_state(),
                       torch.Generator().manual_seed(7).get_state())
    for k, v in model.state_dict().items():
        assert torch.equal(v, resumed[k]), k


def test_resumed_run_draws_what_an_unbroken_run_draws(data_dir, tmp_path,
                                                      monkeypatch):
    """4 steps, then a run resumed from their checkpoint to 6, with image
    and task augmentation, equal one unbroken run of 6 steps: the
    checkpoint holds the generator that draws every episode, DA and TA
    draw (the JAX trainer keys step ``it`` by ``fold_in(base_key, it)``)."""
    monkeypatch.chdir(tmp_path)
    overrides = ["aug_list=[data_aug,task_aug]", "device=cpu",
                 f"data_path={data_dir}", "data_size=small", "val_freq=100",
                 "val_iters=1", f"tasks_per_batch={T_}", f"max_ctx_num={S_}",
                 "dim_w=16", "dim_r=12", "dim_z=8", "steps_per_call=2"]
    first = train_cli.train(Config(MAIN_YAML, overrides + ["iterations=4"]))
    resumed = train_cli.train(Config(MAIN_YAML, overrides + [
        "iterations=6", f"checkpoint={first.ckpt.path('model_end_4')}"]))
    whole = train_cli.train(Config(MAIN_YAML, overrides + ["iterations=6"]))
    assert resumed.step == whole.step == 6
    want = whole.model.state_dict()
    for k, v in resumed.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)
    assert torch.equal(resumed.generator.get_state(),
                       whole.generator.get_state())
