"""The port's evaluation against the JAX package's, and its CLI end to end,
on the CPU.

``ModelEvaluator.evaluate`` sweeps the loss over ctx = 1..max_ctx_num on the
same host episodes as the JAX evaluator's host path (streams reseeded to
RandomState 42 per point); with the JAX model's weights carried over, both
give the same curves and write the same files. Tolerance: the degree loss
of each point within rtol 1e-5 (float32, as ``test_torch_port_train.py``);
the written files agree to their last printed digit (``%1.4f``).

The CLIs run as a user would: ``train_cli`` on a shipped YAML with its own
``aug_list`` (image DA included), then ``evaluation_cli`` over the
checkpoint it wrote.
"""

import glob
import os
import re

import jax
import numpy as np
import pytest
import torch

from torch_port_common import WIDTHS, to_numpy
from wmfml_tpu.configs import Config as JaxConfig
from wmfml_tpu.data.factory import build_data as jax_build_data
from wmfml_tpu.eval.evaluator import ModelEvaluator as JaxEvaluator
from wmfml_tpu.models.registry import build_model as jax_build_model
from wmfml_tpu.train.state import TrainState, build_optimizer as jax_optimizer
from wmfml_tpu.train.steps import init_model as jax_init_model
from wmfml_tpu_torch.ckpt.jax_params import load_jax_variables
from wmfml_tpu_torch.cli import evaluation_cli, train_cli
from wmfml_tpu_torch.configs import Config
from wmfml_tpu_torch.data.factory import build_data
from wmfml_tpu_torch.data.synthetic import generate_shapenet1d
from wmfml_tpu_torch.eval.evaluator import ModelEvaluator
from wmfml_tpu_torch.models.registry import build_model
from wmfml_tpu_torch.train.trainer import episode_to_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ANP_YAML = os.path.join(REPO, "cfg", "train", "ANP_DA+TA_ShapeNet1D.yaml")
MAML_YAML = os.path.join(REPO, "cfg", "train", "MAML_DA_ShapeNet1D.yaml")
EVAL_YAML = os.path.join(REPO, "cfg", "evaluation", "ANP_ShapeNet1D.yaml")
T_, S_ = 2, 3
ROW = re.compile(r"^\d+\.0000 -?\d+\.\d{4} \d+\.\d{4}$")


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sn1d"))
    generate_shapenet1d(root, seed=0, instances=2 * S_ + 1, val_classes=3,
                        test_classes=2)
    return root


def _eval_cfg(data_dir):
    return dict(method="ANPShapeNet1D", task="shapenet_1d", mode="eval",
                agg_mode="attention", aug_list=[], tasks_per_batch=T_,
                max_ctx_num=S_, dim_w=WIDTHS["dim_w"], dim_r=WIDTHS["dim_r"],
                dim_z=WIDTHS["dim_z"],
                n_hidden_units_r=list(WIDTHS["n_hidden_units_r"]), lr=1e-4,
                seed=0, loss_type="mse", val_iters=2, data_size="small",
                data_path=data_dir, device="cpu", device_data=False)


def test_evaluator_matches_jax(data_dir, tmp_path):
    cfg = _eval_cfg(data_dir)
    jcfg = JaxConfig.from_dict(cfg, make_dirs=True,
                               results_root=str(tmp_path / "jax"))
    jmodel = jax_build_model(jcfg)
    variables = to_numpy(jax_init_model(jmodel, jcfg, jax.random.PRNGKey(1)))
    state = TrainState.create(variables, jax_optimizer(jcfg))
    jdata = jax_build_data(jcfg, mode="eval")
    want = JaxEvaluator(jmodel, jcfg, jdata, state=state).evaluate()

    pcfg = Config.from_dict(cfg, make_dirs=True,
                            results_root=str(tmp_path / "port"))
    model = load_jax_variables(build_model(pcfg), variables)
    got = ModelEvaluator(model, pcfg, build_data(pcfg)).evaluate()
    for g, w in zip(got, want):
        assert len(g) == S_
        np.testing.assert_allclose(g, w, rtol=1e-5)
    assert got[0] != got[1] and len(set(got[0])) == S_
    for name in ("val_losses.txt", "test_losses.txt"):
        with open(os.path.join(pcfg.save_path, name)) as f:
            lines = f.read().splitlines()
        assert len(lines) == S_ and all(ROW.match(x) for x in lines), lines
        np.testing.assert_allclose(
            np.loadtxt(os.path.join(pcfg.save_path, name)),
            np.loadtxt(os.path.join(jcfg.save_path, name)), atol=1.01e-4)
    assert pcfg.save_path.startswith(str(tmp_path / "port" / "eval"))
    assert os.path.exists(os.path.join(pcfg.save_path, "loss_vs_ctx_num.png"))
    payload = torch.load(os.path.join(pcfg.save_path, "models", "model.pt"),
                         weights_only=True)
    assert payload["step"] == 0
    for k, v in model.state_dict().items():
        assert torch.equal(payload["model"][k], v), k


def test_evaluator_std_is_over_episodes_with_ddof_1(data_dir, tmp_path):
    pcfg = Config.from_dict(_eval_cfg(data_dir), make_dirs=True,
                            results_root=str(tmp_path))
    ev = ModelEvaluator(build_model(pcfg), pcfg, build_data(pcfg))
    losses = []
    ev.data.reset_eval("test", seed=42)
    for _ in range(pcfg.val_iters):
        losses.append(float(ev.eval_step(episode_to_device(
            ev.data.get_batch("test", T_, 2), "cpu"))))
    loss, std = ev._validate_iter("test", 2)
    assert loss == pytest.approx(np.mean(losses), rel=1e-12)
    assert std == pytest.approx(np.std(losses, ddof=1), rel=1e-12)
    assert ev._validate_iter("test", 2) == (loss, std)     # reseeded


def _files(run):
    out = {}
    for name in ("val_losses.txt", "test_losses.txt"):
        out[name] = np.loadtxt(os.path.join(run, name))
    return out


def test_train_then_evaluation_cli_with_the_shipped_aug_list(data_dir,
                                                             tmp_path,
                                                             monkeypatch):
    """The ANP YAML as shipped (task and image augmentation) trains on the
    CPU, and the evaluation CLI scores the checkpoint it wrote."""
    monkeypatch.chdir(tmp_path)
    small = [f"data_path={data_dir}", "data_size=small", "device=cpu",
             f"tasks_per_batch={T_}", f"max_ctx_num={S_}", "dim_w=16",
             "dim_r=12", "dim_z=8"]
    trainer = train_cli.train(Config(ANP_YAML, small + [
        "iterations=2", "val_freq=1", "val_iters=1"]))
    assert trainer.config.aug_list == ["task_aug", "data_aug"]
    ckpt = trainer.ckpt.path("model_end_2")
    evaluation_cli.main(["--config", EVAL_YAML, f"checkpoint={ckpt}",
                         "val_iters=2", *small])
    runs = glob.glob("results/eval/ANPShapeNet1D/*")
    assert len(runs) == 1
    for name, arr in _files(runs[0]).items():
        assert arr.shape == (S_, 3) and np.isfinite(arr).all(), name
        np.testing.assert_array_equal(arr[:, 0], np.arange(1, S_ + 1))
    payload = torch.load(os.path.join(runs[0], "models", "model.pt"),
                         weights_only=True)
    assert payload["step"] == 2
    trained = torch.load(ckpt, weights_only=True)["model"]
    for k, v in trained.items():
        assert torch.equal(payload["model"][k], v), k
    # a bare reference state_dict restores and scores the same
    bare = str(tmp_path / "bare.pt")
    torch.save(trained, bare)
    evaluation_cli.main(["--config", EVAL_YAML, f"checkpoint={bare}",
                         "val_iters=2", "mode=bare", *small])
    (scored,) = glob.glob("results/bare/ANPShapeNet1D/*")     # the mode's dir
    for name, arr in _files(scored).items():
        np.testing.assert_array_equal(arr, _files(runs[0])[name])


def test_maml_trains_with_its_shipped_da_and_evaluates(data_dir, tmp_path,
                                                       monkeypatch):
    monkeypatch.chdir(tmp_path)
    small = [f"data_path={data_dir}", "data_size=small", "device=cpu",
             f"tasks_per_batch={T_}", f"max_ctx_num={S_}", "dim_w=36",
             "num_filters=8", "num_updates=1", "test_num_updates=2"]
    trainer = train_cli.train(Config(MAML_YAML, small + [
        "iterations=2", "val_freq=10", "val_iters=1"]))
    assert trainer.config.aug_list == ["data_aug"]
    evaluation_cli.main(["--config", MAML_YAML, "mode=eval", "val_iters=2",
                         f"checkpoint={trainer.ckpt.path('model_end_2')}",
                         *small])
    (run,) = glob.glob("results/eval/MAMLShapeNet1D/*")
    for name, arr in _files(run).items():
        assert arr.shape == (S_, 3) and np.isfinite(arr).all(), name


def test_evaluation_cli_raises_without_a_card_or_a_ported_method(
        data_dir, tmp_path, monkeypatch):
    """Without a card the CLI raises before touching data. ANPMRShapeNet1D
    (ROADMAP.md A13, done) now evaluates: its BBB encoder samples at
    evaluation, as in the reference, from a generator reseeded from the
    config's seed at every point, so two sweeps of one model write the
    same numbers. (The name is from when that method raised naming A13; it
    is kept so that the test's record runs on.)"""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluation_cli.evaluate(Config(EVAL_YAML, [
            f"data_path={tmp_path / 'none'}"]))
    assert not os.path.exists(tmp_path / "none")
    small = [f"data_path={data_dir}", "data_size=small", "device=cpu",
             f"tasks_per_batch={T_}", f"max_ctx_num={S_}", "dim_w=16",
             "dim_r=12", "dim_z=8", "checkpoint=", "val_iters=2",
             "method=ANPMRShapeNet1D"]
    for mode in ("eval", "again"):
        evaluation_cli.main(["--config", EVAL_YAML, f"mode={mode}", *small])
    runs = [glob.glob(f"results/{m}/ANPMRShapeNet1D/*") for m in ("eval",
                                                                  "again")]
    assert [len(r) for r in runs] == [1, 1]
    first, second = _files(runs[0][0]), _files(runs[1][0])
    for name, arr in first.items():
        assert arr.shape == (S_, 3) and np.isfinite(arr).all(), name
        np.testing.assert_array_equal(arr, second[name])
