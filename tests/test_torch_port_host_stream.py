"""Host-streamed training (``device_data`` off, or a train split that
``data/device_sampler.py:from_dataset`` declines) against the JAX
package's host path, on the CPU.

  * the trainer streams the train split's host episodes through
    ``Prefetcher`` into ``FusedSteps`` (``train/steps.py:HostEpisodes``)
    where the JAX trainer streams them: ``device_data: false``, a split
    over ``DEVICE_DATA_BYTES_LIMIT`` (made small here), a short class; it
    logs why once;
  * CNPShapeNet1D with ``aug_list: []`` at ``steps_per_call`` 1 and 2 from
    the JAX trainer's weights: both packages' host samplers draw the same
    numpy episodes, so each call's training loss and each validation loss
    agree within rtol 1e-5 (float32);
  * ``Prefetcher``: order kept, depth bounded, a worker's exception raised
    on the next ``next()``, ``close()`` ends the thread;
  * ShapeNet3D recomposites its train split as often as the JAX trainer
    does for the same ``iterations``, K and ``bg_gen_freq``, always before
    that iteration's batch is drawn.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from torch_port_common import to_numpy
from wmfml_tpu.configs import Config as JaxConfig
from wmfml_tpu.data.factory import build_data as jax_build_data
from wmfml_tpu.models.registry import build_model as jax_build_model
from wmfml_tpu.train.trainer import ModelTrainer as JaxModelTrainer
from wmfml_tpu_torch.ckpt.jax_params import load_jax_variables
from wmfml_tpu_torch.cli.train_cli import build_trainer
from wmfml_tpu_torch.configs import Config
from wmfml_tpu_torch.data import device_sampler, episode_core, synthetic
from wmfml_tpu_torch.data.factory import build_data
from wmfml_tpu_torch.models.registry import build_model
from wmfml_tpu_torch.train.steps import HostEpisodes
from wmfml_tpu_torch.train.trainer import ModelTrainer, Prefetcher
from torch_port_common import one_torch_thread  # noqa: F401

BASE = dict(method="CNPShapeNet1D", task="shapenet_1d", agg_mode="max",
            checkpoint="", loss_type="mse", tasks_per_batch=2, max_ctx_num=3,
            lr=1e-3, weight_decay=False, optimizer="Adam", val_iters=2,
            val_freq=1, device="cpu", seed=1, aug_list=[], dim_w=32,
            n_hidden_units_r=[64, 64], dim_r=32, dim_z=32, data_size="small")


@pytest.fixture(scope="module")
def data_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("host_stream")
    dirs = {"shapenet_1d": str(root / "sn1d"), "shapenet_3d": str(root / "s3d")}
    synthetic.generate_shapenet1d(dirs["shapenet_1d"], seed=0, instances=7,
                                  val_classes=3, test_classes=2)
    synthetic.generate_shapenet3d(dirs["shapenet_3d"], small=True)
    return dirs


def _records(trainer):
    out = []
    add = trainer.writer.add_scalar

    def record(tag, value, step):
        out.append((tag, step, float(value)))
        add(tag, value, step)

    trainer.writer.add_scalar = record
    return out


@pytest.mark.parametrize("k", [1, 2])
def test_host_stream_training_matches_the_jax_host_path(data_dirs, tmp_path,
                                                        monkeypatch, k):
    monkeypatch.chdir(tmp_path)
    d = dict(BASE, data_path=data_dirs["shapenet_1d"], steps_per_call=k,
             iterations=3 * k, device_data=False)
    jcfg = JaxConfig.from_dict(d, make_dirs=True,
                               results_root=str(tmp_path / "jax"))
    jtrainer = JaxModelTrainer(jax_build_model(jcfg), jcfg,
                               jax_build_data(jcfg))
    assert jtrainer.device_sampler is None
    cfg = Config.from_dict(d, make_dirs=True,
                           results_root=str(tmp_path / "port"))
    model = load_jax_variables(build_model(cfg),
                               to_numpy(jtrainer.state.model_variables()))
    trainer = ModelTrainer(model, cfg, build_data(cfg))
    assert trainer.streamed and trainer.steps_per_call == k
    want, got = _records(jtrainer), _records(trainer)
    jtrainer.train()
    trainer.train()
    assert [r[:2] for r in got] == [r[:2] for r in want] and len(got) == 9
    np.testing.assert_allclose([r[2] for r in got], [r[2] for r in want],
                               rtol=1e-5)
    assert trainer.train_step.calls == 3 and trainer.device_eval is None
    assert trainer.prefetch_stats["calls"] == 3


@pytest.mark.parametrize("why", ["device_data_false", "over_the_limit",
                                 "short_class"])
def test_declined_splits_train_from_the_host(data_dirs, tmp_path,
                                             monkeypatch, why):
    """Where ``from_dataset`` declines the train split the trainer takes
    the host path, with the reason in its log, and does not raise."""
    monkeypatch.chdir(tmp_path)
    d = dict(BASE, data_path=data_dirs["shapenet_1d"], steps_per_call=2,
             iterations=2, device_data=False if why == "device_data_false"
             else True)
    if why == "over_the_limit":
        monkeypatch.setattr(device_sampler, "DEVICE_DATA_BYTES_LIMIT", 1000)
    if why == "short_class":
        d["query_num"] = 5          # 3 + 5 > the 7 instances a class
    cfg = Config.from_dict(d, make_dirs=True, results_root=str(tmp_path))
    trainer = build_trainer(cfg)
    assert trainer.streamed and isinstance(trainer.sampler, HostEpisodes)
    with open(os.path.join(cfg.save_path, "log.log")) as f:
        log = f.read()
    reason = {"device_data_false": "device_data is False",
              "over_the_limit": "over DEVICE_DATA_BYTES_LIMIT",
              "short_class": "7 instances a class, fewer than 8"}[why]
    assert "train split streamed from the host" in log and reason in log
    assert ("device_data requested but" in log) == (why != "device_data_false")
    if why != "short_class":        # the host sampler needs 8 instances too
        trainer.train()
        assert trainer.step == 2 and trainer.train_step.calls == 1


# -- Prefetcher ---------------------------------------------------------------

def test_prefetcher_keeps_order_and_bounds_its_depth():
    drawn = []

    def sample():
        drawn.append(len(drawn))
        return drawn[-1]

    pf = Prefetcher(sample, lambda x: x * 10, depth=3)
    deadline = time.time() + 5
    while len(drawn) < 4 and time.time() < deadline:
        time.sleep(0.01)
    time.sleep(0.2)
    # three in the queue and one drawn and waiting for room
    assert len(drawn) == 4 and pf.q.qsize() == 3
    assert [next(pf) for _ in range(6)] == [0, 10, 20, 30, 40, 50]
    pf.close()
    assert not pf.thread.is_alive()


def test_prefetcher_raises_the_workers_exception_and_ends_a_finite_stream():
    def sample():
        raise ValueError("no more episodes")

    pf = Prefetcher(sample, lambda x: x)
    with pytest.raises(ValueError, match="no more episodes"):
        next(pf)
    pf.close()
    finite = Prefetcher(iter([1, 2, 3]).__next__, lambda x: x, depth=1)
    assert list(finite) == [1, 2, 3]
    finite.close()
    assert not finite.thread.is_alive()
    slow = Prefetcher(lambda: time.sleep(0.3) or 7, lambda x: x)
    assert next(slow) == 7 and slow.empty_waits == 1    # it waited once
    slow.close()


def test_prefetcher_close_ends_a_blocked_worker():
    pf = Prefetcher(lambda: 1, lambda x: x, depth=1)
    time.sleep(0.3)                     # the queue full, the worker waiting
    before = threading.active_count()
    pf.close()
    assert not pf.thread.is_alive() and threading.active_count() < before


# -- ShapeNet3D's recomposite cadence -----------------------------------------

S3D = dict(BASE, method="CondNeuralProcess", task="shapenet_3d",
           agg_mode="mean", img_agg="reshape", dim_w=16, device_data=False,
           gen_bg=True)


def _jax_gen_bg_calls(cfg_dict, tmp_path, monkeypatch):
    """gen_bg calls of the JAX trainer's host path over ``iterations``,
    its step and validation stubbed."""
    monkeypatch.setattr(JaxModelTrainer, "_init_variables",
                        lambda self, key: {"params": {
                            "w": np.zeros(1, np.float32)}})
    jcfg = JaxConfig.from_dict(cfg_dict, make_dirs=True,
                               results_root=str(tmp_path / "jax"))
    data = jax_build_data(jcfg)
    calls = []
    gen_bg = data.gen_bg
    data.gen_bg = lambda config, data="all": (calls.append(data),
                                              gen_bg(config, data))
    trainer = JaxModelTrainer(jax_build_model(jcfg), jcfg, data)
    trainer.train_step = lambda state, batch, key: (state, {"loss": 0.0})
    trainer.validate = lambda it, source: 0.0
    trainer.ckpt.save = lambda *a, **k: None
    trainer.train()
    return calls


@pytest.mark.parametrize("k,freq", [(2, 3), (1, 4)])
def test_shapenet3d_recomposites_at_the_jax_cadence_in_order(
        data_dirs, tmp_path, monkeypatch, k, freq):
    monkeypatch.chdir(tmp_path)
    d = dict(S3D, data_path=data_dirs["shapenet_3d"], steps_per_call=k,
             iterations=10, bg_gen_freq=freq)
    want = _jax_gen_bg_calls(d, tmp_path, monkeypatch)
    cfg = Config.from_dict(d, make_dirs=True,
                           results_root=str(tmp_path / "port"))
    trainer = build_trainer(cfg)
    assert trainer.streamed
    events, data = [], trainer.data
    gen_bg, draw_batch = data.gen_bg, data.draw_batch
    gather = episode_core.Rows.gather

    def logged_gen_bg(config, data="all"):
        events.append(("gen_bg", data))
        gen_bg(config, data)

    def logged_draw_batch(source, *a):
        events.append(("batch", source))
        return draw_batch(source, *a)

    def logged_gather(rows, out=None):
        events.append(("gather", rows.shape[1]))
        return gather(rows, out)

    data.gen_bg, data.draw_batch = logged_gen_bg, logged_draw_batch
    monkeypatch.setattr(episode_core.Rows, "gather", logged_gather)
    pixels = data.splits["train"]["images"].copy()
    trainer.train_step = lambda generator: {"loss": torch.zeros(())}
    trainer.validate = lambda it, source: 0.0
    trainer._save = lambda name: None
    trainer.train()
    # a call's episodes are drawn, then their image rows gathered (the
    # context rows of each, then the query rows), after every recomposite
    # at iterations <= its own and before the next
    expected = [("gen_bg", "all")]
    for it in range(0, 10, k):
        if it > 0 and it % freq < k:
            expected.append(("gen_bg", "train"))
        expected += [("batch", "train")] * k
        expected += ([("gather", cfg.max_ctx_num)] * k
                     + [("gather", cfg.query_num)] * k)
    assert events == expected
    assert [e[1] for e in events if e[0] == "gen_bg"] == want
    assert want.count("train") >= 2
    assert not np.array_equal(pixels, data.splits["train"]["images"])
