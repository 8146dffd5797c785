"""Device-resident evaluation sweeps (``data/device_eval.py``) and the
``device_data`` decision (``data/device_sampler.py:from_dataset``) against
the port's host sweeps and the JAX package, on the CPU.

  * ``from_dataset`` / ``split_from_dataset`` give None exactly where the
    JAX package's do: a split over ``DEVICE_DATA_BYTES_LIMIT`` (made small
    here), a class shorter than the episode, an unknown task;
  * each data module's ``get_batch_indices`` draws the JAX module's
    indices and consumes its stream as ``get_batch`` does;
  * the trainer's device sweep scores what its host sweep scores, batch
    for batch (bit for bit: the same gathers and the same ops), on
    CNP/ANP/CNPMR (BBB weights drawn at evaluation)/MAML/MMAML; the
    evaluator's device sweep gives the host sweep's means and stds on the
    JAX device-CLI test's five cases and on ANP (FAVOR's key stabiliser
    over edge-padded context rows), within that test's rtol 1e-4 / atol
    1e-5 (stds rtol 1e-3);
  * with the JAX model's weights carried over, the port's sweeps give JAX's
    ``build_device_eval_sweep`` losses batch for batch, and the
    evaluators' device sweeps the same curves, including eval-mode
    all-view queries, within rtol / atol 1e-5 (float32; models that draw
    nothing at evaluation).

Small sizes: T = 2, S = 3, ``val_iters`` 2, ``data_size: small``.
"""

import os

import jax
import numpy as np
import pytest
import torch

from torch_port_common import to_numpy
from wmfml_tpu.configs import Config as JaxConfig
from wmfml_tpu.data import device_eval as jax_device_eval
from wmfml_tpu.data import device_sampler as jax_device_sampler
from wmfml_tpu.data.factory import build_data as jax_build_data
from wmfml_tpu.eval.evaluator import ModelEvaluator as JaxEvaluator
from wmfml_tpu.models.registry import build_model as jax_build_model
from wmfml_tpu.train.state import TrainState, build_optimizer as jax_optimizer
from wmfml_tpu.train.steps import init_model as jax_init_model
from wmfml_tpu_torch.ckpt.jax_params import load_jax_variables
from wmfml_tpu_torch.cli.train_cli import build_trainer
from wmfml_tpu_torch.configs import Config
from wmfml_tpu_torch.data import device_sampler, synthetic
from wmfml_tpu_torch.data.device_eval import (DeviceSweep,
                                              build_device_eval_sweep,
                                              split_from_dataset)
from wmfml_tpu_torch.data.factory import build_data
from wmfml_tpu_torch.eval.evaluator import ModelEvaluator
from wmfml_tpu_torch.models.registry import build_model
from wmfml_tpu_torch.train.steps import build_eval_step
from wmfml_tpu_torch.train.trainer import episode_to_device
from torch_port_common import one_torch_thread  # noqa: F401

TASKS = ("shapenet_1d", "pascal_1d", "distractor", "shapenet_3d")
BASE = dict(checkpoint="", loss_type="mse", tasks_per_batch=2, max_ctx_num=3,
            lr=1e-3, weight_decay=False, optimizer="Adam", val_iters=2,
            val_freq=2, iterations=2, device="cpu", seed=1, aug_list=[],
            dim_w=32, n_hidden_units_r=[64, 64], dim_r=32, dim_z=32,
            data_size="small", bg_gen_freq=100)
METHOD = {"shapenet_1d": ("CNPShapeNet1D", dict(agg_mode="max")),
          "pascal_1d": ("CNPVanillaPascal1D", dict(agg_mode="max")),
          "distractor": ("CNPDistractor", dict(agg_mode="max", img_agg="max",
                                               dim_w=16)),
          "shapenet_3d": ("CondNeuralProcess", dict(agg_mode="mean",
                                                    img_agg="reshape"))}


@pytest.fixture(scope="module")
def data_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("device_eval")
    dirs = {task: str(root / task) for task in TASKS}
    synthetic.generate_shapenet1d(dirs["shapenet_1d"], seed=0, instances=7,
                                  val_classes=3, test_classes=2)
    synthetic.generate_pascal1d(dirs["pascal_1d"], seed=5, train_classes=3,
                                val_classes=2, instances=31)
    synthetic.generate_distractor(dirs["distractor"], objects_per_categ=5)
    synthetic.generate_shapenet3d(dirs["shapenet_3d"], small=True)
    return dirs


def _cfg(data_dirs, task, tmp, mode="train", **extra):
    method, kw = METHOD[task]
    d = dict(BASE, method=method, task=task, data_path=data_dirs[task],
             mode=mode, **{**kw, **extra})
    return d, Config.from_dict(d, make_dirs=True, results_root=str(tmp))


@pytest.fixture(scope="module")
def datasets(data_dirs, tmp_path_factory):
    """task -> (port data, JAX data, port config, JAX config), train mode."""
    tmp = tmp_path_factory.mktemp("cfg")
    out = {}
    for task in TASKS:
        d, cfg = _cfg(data_dirs, task, tmp)
        jcfg = JaxConfig.from_dict(d, make_dirs=True, results_root=str(tmp))
        out[task] = (build_data(cfg), jax_build_data(jcfg), cfg, jcfg)
    return out


# -- (a) the device_data decision ---------------------------------------------

class _Unknown:
    task_name = "mystery"


@pytest.mark.parametrize("case", ["fits", "over_the_limit", "short_class",
                                  "unknown_task"])
@pytest.mark.parametrize("task", TASKS)
def test_from_dataset_declines_where_jax_declines(datasets, monkeypatch,
                                                  task, case):
    data, jdata, cfg, jcfg = datasets[task]
    if case == "over_the_limit":
        limit = data.x_train.nbytes - 1
        monkeypatch.setattr(device_sampler, "DEVICE_DATA_BYTES_LIMIT", limit)
        monkeypatch.setattr(jax_device_sampler, "DEVICE_DATA_BYTES_LIMIT",
                            limit)
    if case == "short_class":
        for c in (cfg, jcfg):
            monkeypatch.setattr(c, "query_num",
                                data.x_train.shape[1] - c.max_ctx_num + 1)
    if case == "unknown_task":
        data = jdata = _Unknown()
    got = device_sampler.from_dataset(data, cfg, "cpu")
    want = jax_device_sampler.from_dataset(jdata, jcfg)
    assert (got is None) == (want is None) == (case != "fits")
    if got is None:
        assert device_sampler.refusal(data, cfg)


@pytest.mark.parametrize("case", ["fits", "over_the_limit", "short_class",
                                  "short_for_query_all", "unknown_task"])
@pytest.mark.parametrize("task", TASKS)
def test_split_from_dataset_declines_where_jax_declines(datasets, monkeypatch,
                                                        task, case):
    data, jdata, cfg, jcfg = datasets[task]
    query_all = case == "short_for_query_all"
    for source in ("validation", "test"):
        x = (getattr(data, "splits", {}).get(source, {}).get("images")
             if task in ("distractor", "shapenet_3d") else
             getattr(data, {"validation": "x_val", "test": "x_test"}[source],
                     None))
        if x is None:       # Pascal1D has no test split: None either way
            assert task == "pascal_1d"
            assert split_from_dataset(data, cfg, source, "cpu") is None
            assert jax_device_eval.split_from_dataset(jdata, jcfg,
                                                      source) is None
            continue
        with monkeypatch.context() as m:
            if case == "over_the_limit":
                m.setattr(device_sampler, "DEVICE_DATA_BYTES_LIMIT",
                          x.nbytes - 1)
                m.setattr(jax_device_eval, "DEVICE_DATA_BYTES_LIMIT",
                          x.nbytes - 1)
            if case == "short_class":
                for c in (cfg, jcfg):
                    m.setattr(c, "query_num", x.shape[1] - c.max_ctx_num + 1)
            if query_all:
                for c in (cfg, jcfg):
                    m.setattr(c, "max_ctx_num", x.shape[1] + 1)
            d, jd = ((_Unknown(), _Unknown()) if case == "unknown_task"
                     else (data, jdata))
            got = split_from_dataset(d, cfg, source, "cpu",
                                     query_all=query_all)
            want = jax_device_eval.split_from_dataset(jd, jcfg, source,
                                                      query_all=query_all)
        assert (got is None) == (want is None) == (case != "fits"), source
        if got is not None:
            np.testing.assert_array_equal(got.x.numpy(), np.asarray(want.x))
            np.testing.assert_array_equal(got.y.numpy(), np.asarray(want.y))
            assert got.label_scale == want.label_scale


@pytest.mark.parametrize("task", TASKS)
def test_batch_indices_follow_jax_and_consume_as_get_batch(datasets, task):
    """Three index draws per split equal the JAX module's, and after an
    index draw and a ``get_batch`` from one reset the stream stands where
    two ``get_batch`` calls leave it (both paths see one episode
    sequence)."""
    data, jdata, cfg, _ = datasets[task]
    sources = ["train", "validation"] + ([] if task == "pascal_1d"
                                         else ["test"])
    for source in sources:
        for d in (data, jdata):
            d.reset_eval(source, seed=42)
        for _ in range(3):
            got = data.get_batch_indices(source, 2, 3)
            want = jdata.get_batch_indices(source, 2, 3)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
        if source == "train":
            continue
        data.reset_eval(source, seed=42)
        data.get_batch_indices(source, 2, 3)
        after_indices = data.get_batch(source, 2, 3)
        data.reset_eval(source, seed=42)
        data.get_batch(source, 2, 3)
        after_batch = data.get_batch(source, 2, 3)
        for k in after_batch:
            np.testing.assert_array_equal(after_indices[k], after_batch[k])


# -- (b) the device sweep against the host sweep ------------------------------

def _trainer(data_dirs, tmp_path, method, **extra):
    cfg = Config.from_dict(dict(
        BASE, method=method, task="shapenet_1d",
        data_path=data_dirs["shapenet_1d"], steps_per_call=2, **extra),
        make_dirs=True, results_root=str(tmp_path))
    return build_trainer(cfg)


@pytest.mark.parametrize("method,extra", [
    ("CNPShapeNet1D", dict(agg_mode="max")),
    ("ANPShapeNet1D", dict(agg_mode="attention")),
    ("CNPMRShapeNet1D", dict(agg_mode="max", beta=1e-7)),
    ("MAMLShapeNet1D", dict(dim_w=16, num_updates=1, test_num_updates=2,
                            update_lr=0.01)),
    ("MMAMLShapeNet1D", dict(dim_w=16, num_updates=1, test_num_updates=1,
                             update_lr=0.01))])
def test_trainer_device_sweep_equals_host_sweep(data_dirs, tmp_path,
                                                monkeypatch, method, extra):
    """The validation split's device sweep scores each batch as the host
    sweep does, bit for bit; a BBB model draws its weights from the
    reseeded generator alike, so a second sweep scores the same."""
    monkeypatch.chdir(tmp_path)
    trainer = _trainer(data_dirs, tmp_path, method, **extra)
    trainer.device_eval = trainer._setup_device_eval()
    assert sorted(trainer.device_eval) == ["test", "validation"]
    got = trainer._device_validate("validation")
    trainer.data.reset_eval("validation", seed=42)
    trainer.eval_generator.manual_seed(int(trainer.config.seed) + 10_000_000)
    want = [float(trainer.eval_step(episode_to_device(
        trainer.data.get_batch("validation", 2, 3), "cpu"),
        trainer.eval_generator)) for _ in range(2)]
    np.testing.assert_array_equal(got, want)
    assert got[0] != got[1]
    if method == "CNPMRShapeNet1D":
        np.testing.assert_array_equal(trainer._device_validate("validation"),
                                      got)


@pytest.mark.parametrize("device_data", ["auto", False])
def test_validate_sweeps_on_the_device_after_device_training(
        data_dirs, tmp_path, monkeypatch, device_data):
    """``validate`` takes the device sweep only after training on the
    device path (the JAX trainer's ``_want_device_eval``), and both paths
    write one validation loss a split."""
    monkeypatch.chdir(tmp_path)
    trainer = _trainer(data_dirs, tmp_path, "CNPShapeNet1D", agg_mode="max",
                       device_data=device_data)
    trainer.train()
    assert trainer.streamed == (device_data is False)
    assert (trainer.device_eval is None) == trainer.streamed
    if not trainer.streamed:
        assert sorted(trainer.device_eval) == ["test", "validation"]
        sweep = trainer.device_eval["validation"]
        assert sweep.eager == 2 and sweep.graph is None     # the CPU: a loop


EVAL_CASES = [
    ("CNPShapeNet1D", "shapenet_1d", dict(agg_mode="max")),
    ("CondNeuralProcess", "shapenet_3d", dict(agg_mode="mean",
                                              img_agg="reshape")),
    ("CNPDistractor", "distractor", dict(agg_mode="max", img_agg="max",
                                         dim_w=16)),
    ("CNPVanillaPascal1D", "pascal_1d", dict(agg_mode="max")),
    ("CNPMRShapeNet1D", "shapenet_1d", dict(agg_mode="max")),
    ("ANPShapeNet1D", "shapenet_1d", dict(agg_mode="attention")),
]


def _evaluator(data_dirs, tmp_path, method, task, extra, variables=None):
    d = dict(BASE, method=method, task=task, data_path=data_dirs[task],
             mode="eval", **extra)
    cfg = Config.from_dict(d, make_dirs=True, results_root=str(tmp_path))
    data = build_data(cfg, mode="eval")
    cfg.query_num = getattr(data, "query_num", cfg.query_num)
    model = build_model(cfg)
    if variables is not None:
        model = load_jax_variables(model, variables)
    return ModelEvaluator(model, cfg, data), d


@pytest.mark.parametrize("method,task,extra", EVAL_CASES)
def test_evaluator_device_sweep_equals_host_sweep(data_dirs, tmp_path,
                                                  method, task, extra):
    ev, _ = _evaluator(data_dirs, tmp_path, method, task, extra)
    cfg = ev.config
    for source in ["validation"] + ([] if task == "pascal_1d" else ["test"]):
        dev = ev._device_sweep(source)
        assert dev is not None, f"the device sweep must take {task}"
        cfg.device_data = False
        host_losses, host_stds = ev._sweep_source(source)
        cfg.device_data = "auto"
        np.testing.assert_allclose(dev[0], host_losses, rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(dev[1], host_stds, rtol=1e-3, atol=1e-4)
    if task in ("distractor", "shapenet_3d"):   # eval mode: every view
        assert ev.sweeps["validation"].shape[3] == ev.data.query_num == {
            "distractor": 36, "shapenet_3d": 30}[task]


def test_evaluator_sweep_logs_and_writes_as_the_host_sweep(data_dirs,
                                                           tmp_path):
    """``evaluate()`` on the device writes the host path's files to their
    last printed digit and logs that the sweep ran device-resident; a
    sampler without ``get_batch_indices`` stays on the host."""
    files = {}
    for dd in ("auto", False):
        ev, _ = _evaluator(data_dirs, tmp_path / str(dd), "CNPShapeNet1D",
                           "shapenet_1d", dict(agg_mode="max",
                                               device_data=dd))
        ev.evaluate()
        files[dd] = [np.loadtxt(os.path.join(ev.config.save_path, n))
                     for n in ("val_losses.txt", "test_losses.txt")]
        with open(os.path.join(ev.config.save_path, "log.log")) as f:
            log = f.read()
        assert (dd == "auto") == ("sweep ran device-resident" in log)
        assert bool(ev.sweeps) == (dd == "auto")
    for g, w in zip(files["auto"], files[False]):
        np.testing.assert_allclose(g, w, atol=1.01e-4)
    ev.data = type("NoIndices", (), {"mode": None})()
    assert ev._device_sweep("validation") is None


# -- (c) against the JAX package's device sweeps ------------------------------

def _jax_state(d, tmp_path):
    jcfg = JaxConfig.from_dict(d, make_dirs=True,
                               results_root=str(tmp_path / "jax"))
    jmodel = jax_build_model(jcfg)
    variables = to_numpy(jax_init_model(jmodel, jcfg, jax.random.PRNGKey(1)))
    return jcfg, jmodel, variables, TrainState.create(variables,
                                                      jax_optimizer(jcfg))


@pytest.mark.parametrize("method,agg", [("CNPShapeNet1D", "max"),
                                        ("ANPShapeNet1D", "attention")])
def test_trainer_sweep_matches_jax_build_device_eval_sweep(data_dirs,
                                                           tmp_path, method,
                                                           agg):
    d = dict(BASE, method=method, task="shapenet_1d", agg_mode=agg,
             data_path=data_dirs["shapenet_1d"])
    jcfg, jmodel, variables, state = _jax_state(d, tmp_path)
    cfg = Config.from_dict(d, make_dirs=True,
                           results_root=str(tmp_path / "port"))
    data = build_data(cfg)
    model = load_jax_variables(build_model(cfg), variables)
    v = 3
    data.reset_eval("validation", seed=42)
    draws = [data.get_batch_indices("validation", 2, 3) for _ in range(v)]
    cls = np.stack([c for c, _, _ in draws])
    ctx = np.stack([take[:, :3] for _, take, _ in draws])
    qry = np.stack([take[:, 3:3 + cfg.query_num] for _, take, _ in draws])
    split = split_from_dataset(data, cfg, "validation", "cpu")
    sweep = build_device_eval_sweep(build_eval_step(model, cfg), split,
                                    torch.Generator().manual_seed(0))
    got = sweep(cls, ctx, qry, [None] * v).numpy()
    jsplit = jax_device_eval.split_from_dataset(jax_build_data(jcfg), jcfg,
                                                "validation")
    want = np.asarray(jax_device_eval.build_device_eval_sweep(
        jmodel, jcfg, jsplit)(state, cls, ctx, qry,
                              jax.random.split(jax.random.PRNGKey(0), v)))
    assert isinstance(sweep, DeviceSweep) and got.shape == (v,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("method,task,extra", [EVAL_CASES[5], EVAL_CASES[2]])
def test_evaluator_sweep_matches_jax_build_device_eval_ctx_sweep(
        data_dirs, tmp_path, method, task, extra):
    """The evaluators' device sweeps over the same checkpoint: ANP (edge
    padding under FAVOR's stabiliser) and CNPDistractor in eval mode (all
    36 views as queries, validation from the test categories)."""
    ev, d = _evaluator(data_dirs, tmp_path / "port", method, task, extra)
    jcfg, jmodel, variables, state = _jax_state(d, tmp_path)
    ev.model = load_jax_variables(ev.model, variables)
    jdata = jax_build_data(jcfg, mode="eval")
    jcfg.query_num = getattr(jdata, "query_num", jcfg.query_num)
    jev = JaxEvaluator(jmodel, jcfg, jdata, state=state)
    for source in ("validation", "test"):
        got, want = ev._device_sweep(source), jev._device_sweep(source)
        assert got is not None and want is not None
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got[1], want[1], rtol=1e-4, atol=1e-5)
