"""Data parallelism over the task axis (``wmfml_tpu_torch/parallel/mesh.py``)
on a 2-rank gloo world on the CPU, against the port's one-process step and
the JAX package's 8-device step (``tests/test_dp_consistency.py``), at that
test's tolerances (loss within 1e-5, parameters within rtol 1e-4 / atol
1e-6), and the profiling hooks (``obs/profile.py``) against the JAX
package's.

The two workers (``tests/_torch_dp_worker.py``, spawned as
``tests/test_multihost.py`` spawns its own) run every path in one spawn:
CNPShapeNet1D on device data fused for 2 steps, ANPShapeNet1D (the key
stabiliser), FCLCNPShapeNet1D (NT-Xent), second-order MAML, a masked loss
whose masks differ between the ranks, ANP's and MAML's eval steps, the JAX
8-device step's
configuration, a run saved and resumed on 2 ranks, the shrink warning and
the groups of a ``model`` axis of 2. Beside the loss and the parameters
after the step, each path's averaged gradients are held within 1e-5 of the
step's largest gradient (ANP's parameters after an SGD step: its key-projection
bias gradients are about 5e-9, where Adam's first step turns float32
reordering into a tenth of the learning rate; ``_torch_dp_worker.py``).
"""

import json
import os
import pickle
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from tests.test_models_np import episode, make_cfg
from torch_port_common import to_numpy
from wmfml_tpu.models.registry import build_model as jax_build_model
from wmfml_tpu.obs.profile import StepTimer as JaxStepTimer
from wmfml_tpu.parallel.mesh import MeshContext as JaxMesh
from wmfml_tpu.train.state import TrainState, build_optimizer
from wmfml_tpu.train.steps import build_train_step as jax_train_step
from wmfml_tpu.train.steps import init_model as jax_init_model
from wmfml_tpu_torch.ckpt.jax_params import jax_to_state_dict
from wmfml_tpu_torch.models.neural_process import SmallCNP
from wmfml_tpu_torch.obs.profile import TRACE_NAME, StepTimer, profile_trace
from wmfml_tpu_torch.parallel import mesh

WORKER = os.path.join(os.path.dirname(__file__), "_torch_dp_worker.py")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATHS = ["cnp_fused", "anp", "fcl", "maml", "masked"]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for each test: at these sizes torch's threads
    only add synchronisation under ``pytest -n`` (every worker's threads on
    the same cores); the previous count is restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_8_device_step(workdir):
    """``test_sharded_step_matches_single_device``'s two steps; its batch
    and initial variables written for the workers."""
    cfg = make_cfg(method="CNPShapeNet1D", task="shapenet_1d",
                   agg_mode="max", aug_list=[], tasks_per_batch=8,
                   donate=False, img_size=(32, 32, 1))
    model = jax_build_model(cfg)
    tx = build_optimizer(cfg)
    key = jax.random.PRNGKey(0)
    variables = jax_init_model(model, cfg, key)
    batch = episode(cfg, label_dim=1)
    with open(os.path.join(workdir, "jax8_inputs.pkl"), "wb") as f:
        pickle.dump((to_numpy(variables), batch), f)
    out = {}
    for name, mesh_ctx in (("one", JaxMesh.create(devices=jax.devices()[:1])),
                           ("eight", JaxMesh.create())):
        state = jax.device_put(TrainState.create(variables, tx),
                               mesh_ctx.replicated)
        state, metrics = jax_train_step(model, cfg, mesh_ctx, tx)(
            state, mesh_ctx.put_batch(batch), key)
        out[name] = (float(metrics["loss"]), to_numpy(state.params))
    assert JaxMesh.create().num_data_shards == 8
    return out


@pytest.fixture(scope="module")
def dp_results(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("dp"))
    jax8 = _jax_8_device_step(workdir)
    port = str(_free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, WORKER, str(rank), "2", port,
                               workdir], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env,
                              cwd=ROOT)
             for rank in (0, 1)]
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
    for rank in (0, 1):
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    return ranks, jax8


def _assert_step_close(got, want, what):
    (loss_a, params_a), (loss_b, params_b) = got, want
    assert abs(loss_a - loss_b) < 1e-5, (what, loss_a, loss_b)
    assert params_a.keys() == params_b.keys()
    for k in params_a:
        np.testing.assert_allclose(params_a[k], params_b[k], rtol=1e-4,
                                   atol=1e-6, err_msg=f"{what}: {k}")


@pytest.mark.parametrize("path", PATHS)
def test_two_ranks_step_as_one_process(dp_results, path):
    """Each rank's loss and updated parameters = the one-process step's
    (``test_dp_consistency.py``'s tolerances), its averaged gradients
    within 1e-5 of the step's largest gradient, and the two ranks hold the
    same parameters bit for bit."""
    ranks, _ = dp_results
    for rank, out in enumerate(ranks):
        (loss1, (params1, grads1)), (loss2, (params2, grads2)) = out[path]
        what = f"{path} rank {rank}"
        _assert_step_close((loss2, params2), (loss1, params1), what)
        assert grads1.keys() == grads2.keys()
        scale = max(np.abs(g).max() for g in grads1.values())
        for k, g in grads1.items():
            np.testing.assert_allclose(grads2[k], g, rtol=1e-4,
                                       atol=1e-5 * scale,
                                       err_msg=f"{what}: grad {k}")
    (la, (a, _)), (lb, (b, _)) = ranks[0][path][1], ranks[1][path][1]
    assert la == lb
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_two_ranks_evaluate_as_one_process(dp_results):
    """An eval step on 2 ranks (each its tasks of the whole batch, the
    losses averaged) = the one-process loss: ANP's, and second-order
    MAML's after its inner steps; each rank's forwards see its 2 tasks of
    the 4."""
    ranks, _ = dp_results
    for out in ranks:
        one, two = out["evaluation"]
        assert one.keys() == two.keys() == {"anp", "maml"}
        for k in one:
            (loss1, tasks1), (loss2, tasks2) = one[k], two[k]
            assert abs(loss1 - loss2) < 1e-5 * max(1.0, abs(loss1)), (
                k, loss1, loss2)
            assert (tasks1, tasks2) == (4, 2), (k, tasks1, tasks2)


def test_two_ranks_step_as_jax_8_devices(dp_results):
    """``test_dp_consistency.py``'s configuration, batch and weights: the
    port's 2-rank step against JAX's 8-device step (and its 1-device)."""
    ranks, jax8 = dp_results
    model = SmallCNP(dim_w=64, n_hidden_units_r=(100, 100), dim_r=64,
                     dim_z=64, y_dim=2, label_dim=3, agg_mode="max",
                     tanh_out=True, img_size=(32, 32, 1))
    for name in ("one", "eight"):
        loss, params = jax8[name]
        want = jax_to_state_dict(model, {"params": params})
        for rank, out in enumerate(ranks):
            got_loss, (got, _) = out["jax8"][1]
            _assert_step_close(
                (got_loss, got),
                (loss, {k: want[k].numpy() for k in got}),
                f"jax {name} vs port rank {rank}")


def test_resumed_on_two_ranks_draws_what_an_unbroken_run_draws(dp_results):
    ranks, _ = dp_results
    for rank, out in enumerate(ranks):
        unbroken, resumed = out["resumed"]
        for k in unbroken:
            assert np.array_equal(unbroken[k], resumed[k]), (rank, k)


def test_shrink_warning_and_idle_ranks(dp_results):
    """tasks_per_batch 3 on a world of 2: the data axis shrinks to 1, with
    ``create_mesh``'s warning, and rank 1 sits out."""
    ranks, _ = dp_results
    for rank, out in enumerate(ranks):
        n, active, messages = out["shrink"]
        assert n == 1 and active == (rank == 0)
        assert any("data axis shrunk to 1 device(s); 1 device(s) IDLE" in m
                   for m in messages), messages


def test_model_axis_raises_naming_a18c(dp_results):
    """(Named when a ``model`` axis above 1 raised, naming ROADMAP.md A18c;
    A18c is done.) ``{data: 1, model: 2}`` on the 2-rank world builds its
    groups: one data slice, both ranks active, rank r the r-th of a model
    group of 2 and alone in its data group; a shape that does not fill
    the world still raises JAX's error."""
    ranks, _ = dp_results
    for rank, out in enumerate(ranks):
        assert out["model_axis"] == (1, 2, 0, rank, True, 1, 2), out
    assert mesh.data_shards(2, {"data": 1, "model": 2}) == 1
    with pytest.raises(ValueError, match="!= #devices"):
        mesh.data_shards(2, {"data": 4})


def test_one_process_has_no_mesh_and_shards_nothing():
    """Without a process group: one rank, no collectives, every helper
    the identity (the single-card path is unchanged)."""
    ctx = mesh.MeshContext.create(batch_divisor=4)
    assert (ctx.world, ctx.rank, ctx.n, ctx.group) == (1, 0, 1, None)
    x = torch.arange(8.0)
    assert ctx.local(x) is x and ctx.widen(3) == 3
    assert mesh.current() is None and mesh.sharded() is None
    assert mesh.data_shards(8, None, batch_divisor=12) == 6


def test_step_timer_and_trace_match_the_jax_hooks(tmp_path):
    """``StepTimer`` skips the same first steps as the JAX package's and
    counts the same; ``profile_trace`` writes a trace into its directory
    and does nothing when disabled."""
    timers = (StepTimer(skip_first=2), JaxStepTimer(skip_first=2))
    for _ in range(5):
        for timer in timers:
            with timer:
                time.sleep(0.001)
    assert [t.steps_timed for t in timers] == [3, 3]
    assert [t.count for t in timers] == [5, 5]
    assert all(t.mean_step_s >= 0.001 for t in timers)
    assert np.isnan(StepTimer().mean_step_s)
    with profile_trace(str(tmp_path / "off"), enabled=False) as prof:
        assert prof is None
    assert not (tmp_path / "off").exists()
    with profile_trace(str(tmp_path / "on")) as prof:
        torch.ones(4).add_(1)
    with open(tmp_path / "on" / TRACE_NAME) as f:
        trace = json.load(f)
    assert any(e.get("name", "").startswith("aten::add")
               for e in trace["traceEvents"])
    assert prof is not None
