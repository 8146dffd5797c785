"""The tensor-parallel "model" axis (``wmfml_tpu_torch/parallel/mesh.py``,
``parallel/tp.py``) on a 4-rank gloo world ``{data: 2, model: 2}`` on the
CPU, against the JAX package's ``{data: 4, model: 2}`` step
(``tests/test_mesh.py:42-90``) and the port's one process, at
``tests/test_torch_port_dp.py``'s tolerances (loss within 1e-5, parameters
within rtol 1e-4 / atol 1e-6; gradients within rtol 1e-4 and 1e-5 of the
step's largest).

The four workers (``tests/_torch_tp_worker.py``) run every case in one
spawn: the JAX configuration's step placed by ``shard_state`` (its
sharded keys = the JAX rule's, its shards kept through the update, Adam's
moments the shards' shape), ANPShapeNet1D and ANPMRShapeNet1D with
``min_size`` lowered on both sides so that small widths split, a trainer
built by ``train_cli`` on the mesh, and the rank order of ``{data: 2,
model: 2}`` against ``{model: 2, data: 2}``. The sharded-leaf sets are
compared by ``state_dict`` key: JAX's rule on JAX's parameters, carried
through ``jax_to_state_dict`` with the split leaves ones and the rest
zeros, against the port's rule on the port's model.
"""

import os
import pickle
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest

from _torch_tp_worker import HW, MIN_SIZE, SMALL
from torch_port_common import one_torch_thread, to_numpy  # noqa: F401
from wmfml_tpu.configs import Config as JaxConfig
from wmfml_tpu.models.registry import build_model as jax_build_model
from wmfml_tpu.parallel.mesh import (MeshContext as JaxMesh, create_mesh,
                                     param_sharding_rule, shard_state,
                                     state_shardings)
from wmfml_tpu.train.state import TrainState, build_optimizer
from wmfml_tpu.train.steps import build_train_step as jax_train_step
from wmfml_tpu.train.steps import init_model as jax_init_model
from wmfml_tpu_torch.ckpt.jax_params import jax_to_state_dict
from wmfml_tpu_torch.configs import Config
from wmfml_tpu_torch.data.synthetic import generate_shapenet1d
from wmfml_tpu_torch.models.registry import build_model
from wmfml_tpu_torch.parallel import mesh

WORKER = os.path.join(os.path.dirname(__file__), "_torch_tp_worker.py")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
TP_CFG = dict(method="CondNeuralProcess", task="shapenet_3d", agg_mode="mean",
              img_agg="reshape", aug_list=[], loss_type="mse",
              tasks_per_batch=4, max_ctx_num=3, query_num=3, lr=1e-3, seed=0,
              gen_bg=False, optimizer="SGD")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_tp_step(workdir):
    """``test_tp_param_sharding_rule_and_train_step``'s step on a
    ``{data: 4, model: 2}`` mesh; its weights and batch written for the
    workers. Returns (loss, the new parameters, the sharded-leaf set by
    the port's keys)."""
    cfg = JaxConfig.from_dict(dict(TP_CFG, donate=False,
                                   mesh_shape={"data": 4, "model": 2}))
    cfg.img_size = [32, 32, 4]
    ctx = JaxMesh.create({"data": 4, "model": 2})
    model = jax_build_model(cfg)
    tx = build_optimizer(cfg)
    key = jax.random.PRNGKey(0)
    variables = jax_init_model(model, cfg, key)
    rng = np.random.RandomState(0)
    batch = dict(
        ctx_x=rng.rand(4, 3, 32, 32, 3).astype(np.float32),
        ctx_y=rng.rand(4, 3, 4).astype(np.float32),
        ctx_mask=np.ones((4, 3), bool),
        qry_x=rng.rand(4, 3, 32, 32, 3).astype(np.float32),
        qry_y=rng.rand(4, 3, 4).astype(np.float32))
    with open(os.path.join(workdir, "jax_tp_inputs.pkl"), "wb") as f:
        pickle.dump((to_numpy(variables), batch), f)
    port = build_model(_port_cfg(TP_CFG, (32, 32, 4)))
    split = _jax_split_keys(port, variables, ctx.mesh, 32768)
    state = shard_state(ctx.mesh, TrainState.create(variables, tx))
    step = jax_train_step(model, cfg, ctx, tx,
                          state_sharding=state_shardings(ctx.mesh, state))
    new, metrics = step(state, ctx.put_batch(batch), key)
    return float(metrics["loss"]), to_numpy(new.params), split


def _port_cfg(cfg, img_size):
    out = Config.from_dict(dict(cfg, device="cpu"))
    out.img_size = list(img_size)
    return out


def _jax_split_keys(port_model, variables, jax_mesh, min_size):
    """The port's ``state_dict`` keys of the parameters whose JAX
    counterparts the JAX rule splits over "model"."""
    rule = param_sharding_rule(jax_mesh, min_size)
    marked = jax.tree_util.tree_map(
        lambda x: np.full(np.shape(x), "model" in str(rule(x).spec),
                          np.float32), to_numpy(variables["params"]))
    sd = jax_to_state_dict(port_model, {**to_numpy(variables),
                                        "params": marked})
    return sorted(k for k, _ in port_model.named_parameters()
                  if bool((sd[k] != 0).any()))


def _small_split_keys(method):
    """JAX's and the port's split sets at ``MIN_SIZE`` for the workers'
    small ``method``."""
    cfg = dict(method=method, task="shapenet_1d", agg_mode="attention",
               aug_list=[], tasks_per_batch=4, max_ctx_num=4, query_num=3,
               lr=1e-2, seed=0, loss_type="mse", **SMALL)
    jcfg = JaxConfig.from_dict(cfg)
    jcfg.img_size = [HW, HW, 1]
    variables = jax_init_model(jax_build_model(jcfg), jcfg,
                               jax.random.PRNGKey(0))
    port = build_model(_port_cfg(cfg, (HW, HW, 1)))
    want = _jax_split_keys(port, variables,
                           create_mesh({"data": 4, "model": 2}), MIN_SIZE)
    got = sorted(k for k, d in mesh.state_shardings(
        mesh.MeshContext(model=2), port, MIN_SIZE).items() if d is not None)
    return got, want


@pytest.fixture(scope="module")
def tp_results(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("tp"))
    jax_tp = _jax_tp_step(workdir)
    generate_shapenet1d(os.path.join(workdir, "sn1d"), seed=0, instances=8,
                        val_classes=3, test_classes=2)
    port = str(_free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, WORKER, str(rank), str(WORLD),
                               port, workdir], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env,
                              cwd=ROOT)
             for rank in range(WORLD)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append(out)
    finally:
        for p in procs:
            p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {rank} failed:\n{out[-3000:]}"
        assert f"worker {rank}: ok" in out
    ranks = []
    for rank in range(WORLD):
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    return ranks, jax_tp


def _assert_close(got, want, what):
    (loss_a, params_a), (loss_b, params_b) = got, want
    assert abs(loss_a - loss_b) < 1e-5, (what, loss_a, loss_b)
    assert params_a.keys() == params_b.keys()
    for k in params_a:
        np.testing.assert_allclose(params_a[k], params_b[k], rtol=1e-4,
                                   atol=1e-6, err_msg=f"{what}: {k}")


def test_tp_step_matches_jax_data4_model2(tp_results):
    """The port's ``{data: 2, model: 2}`` step = JAX's ``{data: 4, model:
    2}`` step on the same weights and batch, on every rank (SGD on both
    sides: ``_torch_tp_worker.py:jax_tp``)."""
    ranks, (loss, params, _) = tp_results
    port = build_model(_port_cfg(TP_CFG, (32, 32, 4)))
    want = jax_to_state_dict(port, {"params": params})
    for rank, out in enumerate(ranks):
        got_loss, got, _, _ = out["jax_tp"]
        _assert_close((got_loss, {k: got[k] for k in want}),
                      (loss, {k: v.numpy() for k, v in want.items()}),
                      f"JAX TP step vs port rank {rank}")


def test_tp_split_keys_are_the_jax_rules_and_keep_their_shards(tp_results):
    """The keys ``shard_state`` split = those whose JAX counterparts the
    JAX rule splits (none of K1's, whose weights stay below the
    threshold); after the update every split parameter and Adam's moments
    hold half the rows of the whole."""
    ranks, (_, _, want) = tp_results
    assert want and not any(k.startswith("img_encoder.conv1.")
                            for k in want)
    for out in ranks:
        _, _, split, shards = out["jax_tp"]
        assert split == want
        assert sorted(shards) == want
        for name, (shape, whole, moments) in shards.items():
            assert shape == (whole[0] // 2, *whole[1:]), name
            assert moments == [shape, shape], (name, moments)


@pytest.mark.parametrize("method", ["ANPShapeNet1D", "ANPMRShapeNet1D"])
def test_lowered_min_size_splits_what_jax_splits(method):
    got, want = _small_split_keys(method)
    assert got == want and len(got) >= 6, (got, want)


@pytest.mark.parametrize("path", ["anp", "anp_mr"])
def test_small_tp_step_as_one_process(tp_results, path):
    """ANPShapeNet1D and ANPMRShapeNet1D (K1 fed gathered weights, the
    heads split per head, the BBB posteriors' rows with eps drawn whole)
    on ``{data: 2, model: 2}`` = one process: the loss, the parameters
    after an SGD step and the gradients."""
    ranks, _ = tp_results
    for rank, out in enumerate(ranks):
        one, two = out[path]
        what = f"{path} rank {rank}"
        _assert_close((two[0], two[1]), (one[0], one[1]), what)
        scale = max(np.abs(g).max() for g in one[2].values())
        for k, g in one[2].items():
            np.testing.assert_allclose(two[2][k], g, rtol=1e-4,
                                       atol=1e-5 * scale,
                                       err_msg=f"{what}: grad {k}")
        assert len(two[3]) >= 6 and any("_W_k" in k for k in two[3])
        assert any(k.startswith("encoder_w0.") for k in two[3])


def test_trainer_on_data2_model2_as_one_process(tp_results):
    """A CNPShapeNet1D trainer built by ``train_cli`` on ``{data: 2, model:
    2}`` (the state whole on every rank, each data index its tasks, the
    model ranks alike) ends 2 steps where one process ends them; rank 0
    alone leads."""
    ranks, _ = tp_results
    for rank, out in enumerate(ranks):
        (one, _), (two, where) = out["cli"]
        assert where[:2] == (2, 2) and where[4] == (rank == 0)
        assert one.keys() == two.keys()
        for k in one:
            np.testing.assert_allclose(two[k], one[k], rtol=1e-4, atol=1e-6,
                                       err_msg=f"cli rank {rank}: {k}")


def test_mesh_key_order_gives_jax_rank_order(tp_results):
    """Rank r sits where ``np.asarray(devices).reshape(sizes)`` puts it, the
    sizes in ``mesh_shape``'s key order (``create_mesh``)."""
    ranks, _ = tp_results
    devices = np.arange(WORLD)
    for order, shape in (("data_model", {"data": 2, "model": 2}),
                         ("model_data", {"model": 2, "data": 2})):
        grid = devices.reshape(tuple(shape.values()))
        axes = list(shape)
        for rank, out in enumerate(ranks):
            pos = [int(a[0]) for a in np.nonzero(grid == rank)]
            want = (pos[axes.index("data")], pos[axes.index("model")])
            assert out["order"][order] == want, (order, rank)
    assert [r["order"]["model_data"] for r in ranks] != [
        r["order"]["data_model"] for r in ranks]


def test_mesh_shape_must_fill_the_world():
    with pytest.raises(ValueError, match="!= #devices"):
        mesh.data_shards(4, {"data": 4, "model": 2})
    assert mesh.mesh_layout(4, {"model": 2, "data": 2}) == (
        ("model", "data"), (2, 2))
    assert mesh.mesh_layout(4, {"model": 2}) == (("model", "data"), (2, 2))
