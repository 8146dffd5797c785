"""Single-task refinement, single-task evaluation and evaluate-and-plot in
the port against the JAX package on the CPU.

Held: ``RefinementSampler``'s frozen task and every ``refine_train``
resample bit for bit (``shot`` ignored, ``reset_eval`` and ``gen_bg``
doing nothing); one refine iteration of ``ModelEvaluator.refine`` with
JAX's DA draws replayed, from a port checkpoint (Adam's moments and step
count restored, the refinement config's learning rate) and from a bare
``state_dict`` (Adam fresh), against the JAX evaluator's ``refine`` from
the same ``TrainState``; every context count of ``refinement_cli``
starting from the checkpoint's weights and optimizer state; the files of
``refinement_cli`` (``loss_vs_ctx.txt``, ``best_test_error.txt``),
``eval_one_task_cli`` (``test_losses.txt``, flat) and
``eval_and_plot_cli`` (``losses_all.txt`` and the PNGs) against the JAX
package's CLIs over the same checkpoint. The CLI comparisons run without
image DA (no random draw, so both frameworks score the same numbers);
the DA path is the refine iteration's. Small sizes: synthetic ShapeNet1D
(128x128, 7 instances a class), ``max_ctx_num`` 3, narrow widths.
Tolerance: ``RTOL``/``ATOL``; the text files (``%1.4f``) within ``RTOL``
and one unit of their last digit, 1e-4.
"""

import os

import jax
import numpy as np
import pytest
import torch

from test_torch_port_aug import _jax_process_draws
from torch_port_common import ATOL, RTOL, WIDTHS, jax_grads_as_port, to_numpy
from wmfml_tpu.cli import eval_one_task_cli as jax_eval_one_task_cli
from wmfml_tpu.cli import refinement_cli as jax_refinement_cli
from wmfml_tpu.configs import Config as JaxConfig
from wmfml_tpu.data.factory import build_data as jax_build_data
from wmfml_tpu.data.refinement import RefinementSampler as JaxSampler
from wmfml_tpu.eval.evaluator import ModelEvaluator as JaxEvaluator
from wmfml_tpu.eval.plotting import evaluate_and_plot as jax_evaluate_and_plot
from wmfml_tpu.models.registry import build_model as jax_build_model
from wmfml_tpu.train.state import TrainState
from wmfml_tpu.train.state import build_optimizer as jax_optimizer
from wmfml_tpu.train.steps import build_train_step as jax_train_step
from wmfml_tpu.train.steps import init_model as jax_init_model
from wmfml_tpu_torch.ckpt.checkpoint import CheckpointManager
from wmfml_tpu_torch.ckpt.jax_params import load_jax_variables
from wmfml_tpu_torch.cli import eval_and_plot_cli, eval_one_task_cli
from wmfml_tpu_torch.cli import refinement_cli
from wmfml_tpu_torch.configs import Config
from wmfml_tpu_torch.data.factory import build_data
from wmfml_tpu_torch.data.refinement import RefinementSampler
from wmfml_tpu_torch.data.synthetic import generate_shapenet1d
from wmfml_tpu_torch.eval.evaluator import ModelEvaluator
from wmfml_tpu_torch.models.registry import build_model
from wmfml_tpu_torch.train.state import build_optimizer
from wmfml_tpu_torch.train.steps import build_train_step
from torch_port_common import one_torch_thread  # noqa: F401

MAX_CTX = 3
FILE_TOL = 1e-4


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sn1d_refine"))
    generate_shapenet1d(root, seed=0, instances=2 * MAX_CTX + 1,
                        val_classes=2, test_classes=2)
    return root


def _cfg(data_dir, **kw):
    d = dict(method="SingleTaskShapeNet1D", task="shapenet_1d", agg_mode="",
             aug_list=["data_aug"], checkpoint="", tasks_per_batch=1,
             max_ctx_num=MAX_CTX, data_size="small", dim_w=WIDTHS["dim_w"],
             n_hidden_units_r=list(WIDTHS["n_hidden_units_r"]),
             dim_r=WIDTHS["dim_r"], dim_z=WIDTHS["dim_z"], lr=1e-3,
             weight_decay=False, optimizer="Adam", val_iters=2, val_freq=1,
             iterations=1, seed=3, loss_type="mse", mode="refinement",
             device="cpu", data_path=data_dir, bg_gen_freq=1000)
    d.update(kw)
    return d


def _configs(cfg, tmp_path):
    """(JAX config, port config) of one dict, each with its run dir."""
    return (JaxConfig.from_dict(cfg, make_dirs=True,
                                results_root=str(tmp_path / "jax")),
            Config.from_dict(cfg, make_dirs=True,
                             results_root=str(tmp_path / "port")))


def _variables(cfg):
    """JAX init of ``cfg``'s model, its last layer x 20 (mu O(1))."""
    jcfg = JaxConfig.from_dict(cfg)
    variables = to_numpy(jax_init_model(jax_build_model(jcfg), jcfg,
                                        jax.random.PRNGKey(1)))
    head = variables["params"]["decoder0"]["Dense_2"]["Dense_0"]
    head["kernel"] = head["kernel"] * 20.0
    return variables


def _bare_checkpoint(cfg, variables, path):
    """A reference-style ``.pt`` (a bare ``state_dict``) of ``variables``:
    the JAX package imports it (``maybe_restore_torch``), the port loads
    it; both start Adam fresh."""
    model = load_jax_variables(build_model(Config.from_dict(cfg)), variables)
    torch.save(model.state_dict(), path)
    return str(path)


# -- the sampler -------------------------------------------------------------------

def test_refinement_sampler_matches_jax_bit_for_bit(data_dir):
    """The frozen task and three ``refine_train`` resamples (tasks 2) of
    each context count equal JAX's; ``shot`` is ignored; ``reset_eval``
    and ``gen_bg`` change nothing."""
    cfg = Config.from_dict(_cfg(data_dir))
    jcfg = JaxConfig.from_dict(_cfg(data_dir))
    port_base, jax_base = build_data(cfg, mode="eval"), jax_build_data(
        jcfg, mode="eval")
    for ctx_num in (1, MAX_CTX):
        port = RefinementSampler(port_base, ctx_num=ctx_num, seed=42)
        ref = JaxSampler(jax_base, ctx_num=ctx_num, seed=42)
        for k in ("task_ctx_x", "task_ctx_y", "task_qry_x", "task_qry_y"):
            np.testing.assert_array_equal(getattr(port, k), getattr(ref, k))
        assert port.task_ctx_x.shape[0] == ctx_num
        for source in ("refine_train", "refine_train", "test", "refine_train",
                       "validation"):
            port.reset_eval(source)
            port.gen_bg(cfg, data="train")
            got, want = (s.get_batch(source, 2, 1) for s in (port, ref))
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for shot in (1, MAX_CTX):
            b = port.get_batch("test", 1, shot)
            assert b["ctx_x"].shape[1] == ctx_num and b["ctx_mask"].all()
        b = port.get_batch("refine_train", 2, 1)
        np.testing.assert_array_equal(b["ctx_x"], b["qry_x"])


# -- one refine iteration ---------------------------------------------------------

def _trained(cfg, variables, batch):
    """One training step (no augmentation, lr 1e-4) from ``variables`` on
    ``batch``, in both frameworks: (JAX TrainState, port model and
    optimizer). (At lr 1e-2 an Adam update of a weight whose gradient is
    float32 noise, sign(m) lr, carries the two frameworks' summation order
    into a 1e-5 difference of the weight.)"""
    train = dict(cfg, aug_list=[], lr=1e-4, mode="train")
    jcfg, pcfg = JaxConfig.from_dict(train), Config.from_dict(train)
    tx = jax_optimizer(jcfg)
    state = TrainState.create(jax.tree_util.tree_map(np.array, variables), tx)
    state, _ = jax_train_step(jax_build_model(jcfg), jcfg, tx=tx)(
        state, batch, jax.random.PRNGKey(0))
    model = load_jax_variables(build_model(pcfg), variables)
    opt = build_optimizer(pcfg, model.parameters())
    build_train_step(model, opt, pcfg)({k: torch.from_numpy(np.array(v))
                                        for k, v in batch.items()})
    return state, model, opt


def _raw(seed, n):
    rng = np.random.RandomState(seed)
    img = lambda: rng.randint(0, 255, (1, n, 128, 128, 1)).astype(np.uint8)  # noqa: E731
    lab = lambda: rng.uniform(0, 2 * np.pi, (1, n, 1)).astype(np.float32)  # noqa: E731
    return dict(ctx_x=img(), ctx_y=lab(), ctx_mask=np.ones((1, n), bool),
                qry_x=img(), qry_y=lab())


def _best_test_error(config):
    """``best_test_error.txt``: (its text lines, its numbers)."""
    text, numbers = [], []
    with open(os.path.join(config.save_path, "best_test_error.txt")) as f:
        for line in f.read().split("\n")[:-1]:
            try:
                numbers.append(float(line))
            except ValueError:
                text.append(line)
    return text, numbers


@pytest.mark.parametrize("adam", ["restored", "fresh"])
def test_one_refine_iteration_matches_jax(data_dir, tmp_path, adam):
    """``refine()`` with ``iterations: 0``: one refine step on a
    ``refine_train`` batch (DA on both image sets with JAX's draws for
    ``fold_in(PRNGKey(seed), 0)``), then the validation and test sweeps;
    the weights after it, the best test loss and ``best_test_error.txt``.
    ``restored``: JAX's evaluator takes the ``TrainState`` of one training
    step, the port the port checkpoint of the same step (Adam's moments and
    step count carried on at the refinement config's lr, 1e-3, not the
    training's 1e-4); ``fresh``: both from the bare ``state_dict``."""
    cfg = _cfg(data_dir, iterations=0)
    jcfg, pcfg = _configs(cfg, tmp_path)
    variables = _variables(cfg)
    state = None
    if adam == "restored":
        state, model, opt = _trained(cfg, variables, _raw(5, 2))
        CheckpointManager(str(tmp_path)).save("trained", 1, model, opt)
        pcfg.checkpoint = CheckpointManager(str(tmp_path)).path("trained")
    else:
        pcfg.checkpoint = _bare_checkpoint(cfg, variables,
                                           tmp_path / "bare.pt")
        jcfg.checkpoint = pcfg.checkpoint

    jdata = JaxSampler(jax_build_data(jcfg, mode="eval"), ctx_num=MAX_CTX,
                       seed=42)
    jcfg.query_num = jdata.task_qry_x.shape[0]
    jev = JaxEvaluator(jax_build_model(jcfg), jcfg, jdata, state=state)
    want_best, want_it = jev.refine()

    pdata = RefinementSampler(build_data(pcfg, mode="eval"), ctx_num=MAX_CTX,
                              seed=42)
    pcfg.query_num = pdata.task_qry_x.shape[0]
    pev = ModelEvaluator(build_model(pcfg), pcfg, pdata)
    da, _ = _jax_process_draws(jax.random.split(jax.random.fold_in(
        jax.random.PRNGKey(cfg["seed"]), 0))[0], _raw(0, MAX_CTX))
    step = pev.refine_step
    pev.refine_step = lambda batch, gen: step(batch, gen, da_params=da)
    got_best, got_it = pev.refine()

    assert got_it == want_it == 0
    np.testing.assert_allclose(got_best, want_best, rtol=RTOL)
    want = jax_grads_as_port(pev.model, jev.state.params, variables)
    for name, p in pev.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    counts = {int(s["step"]) for s in pev.optimizer.state_dict()["state"]
              .values()}
    assert counts == {2 if adam == "restored" else 1}
    assert pev.optimizer.param_groups[0]["lr"] == 1e-3
    got, want = (_best_test_error(c) for c in (pcfg, jcfg))
    assert got[0] == want[0] == ["Best Step: 0 ", "Best test Loss: ",
                                 "Best test Loss std: "]
    np.testing.assert_allclose(got[1], want[1], rtol=RTOL, atol=ATOL)
    assert os.path.exists(pev.ckpt.path("model_end_0"))
    assert os.path.exists(pev.ckpt.path("best_test_model"))


def test_every_context_count_starts_from_the_checkpoint(data_dir, tmp_path,
                                                        monkeypatch):
    """``refinement_cli``: each count's evaluator starts from the
    checkpoint's weights and Adam state, although the count before it
    refined its own model (a port module keeps its weights: reusing one
    would carry count n's refinement into n + 1)."""
    cfg = _cfg(data_dir)
    pcfg = Config.from_dict(dict(cfg, aug_list=[]))
    model = load_jax_variables(build_model(pcfg), _variables(cfg))
    opt = build_optimizer(pcfg, model.parameters())
    build_train_step(model, opt, pcfg)({k: torch.from_numpy(v)
                                        for k, v in _raw(6, 2).items()})
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save("trained", 1, model, opt)
    pcfg = Config.from_dict(dict(cfg, checkpoint=ckpt.path("trained")),
                            make_dirs=True, results_root=str(tmp_path))
    starts, ends = [], []
    refine = ModelEvaluator.refine

    def spy_refine(self):
        starts.append(({k: v.clone() for k, v in
                        self.model.state_dict().items()},
                       {i: {k: v.clone() for k, v in s.items()} for i, s in
                        self.optimizer.state_dict()["state"].items()}))
        out = refine(self)
        ends.append({k: v.clone() for k, v in self.model.state_dict().items()})
        return out

    monkeypatch.setattr(ModelEvaluator, "refine", spy_refine)
    best = refinement_cli.refine(pcfg)
    assert len(best) == len(starts) == len(ends) == MAX_CTX
    want_model = model.state_dict()
    want_opt = opt.state_dict()["state"]
    for weights, adam in starts:
        for k, v in want_model.items():
            assert torch.equal(weights[k], v), k
        for i, s in want_opt.items():
            for k, v in s.items():
                assert torch.equal(adam[i][k], v), (i, k)
    for end in ends:
        assert any(not torch.equal(end[k], v) for k, v in want_model.items())
    assert np.loadtxt(os.path.join(pcfg.save_path,
                                   "loss_vs_ctx.txt")).shape == (MAX_CTX,)


# -- the CLIs' files against JAX's ------------------------------------------------

def _loadtxt(config, name):
    return np.loadtxt(os.path.join(config.save_path, name))


def test_refinement_cli_matches_jax(data_dir, tmp_path):
    """``refinement_cli`` at ``max_ctx_num`` 3, ``iterations`` 1, over a
    bare ``state_dict``: ``loss_vs_ctx.txt`` and the returned best test
    losses against the JAX CLI's."""
    cfg = _cfg(data_dir, aug_list=[])
    cfg["checkpoint"] = _bare_checkpoint(cfg, _variables(cfg),
                                         tmp_path / "bare.pt")
    jcfg, pcfg = _configs(cfg, tmp_path)
    want = jax_refinement_cli.refine(jcfg)
    got = refinement_cli.refine(pcfg)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_loadtxt(pcfg, "loss_vs_ctx.txt"),
                               _loadtxt(jcfg, "loss_vs_ctx.txt"),
                               rtol=RTOL, atol=FILE_TOL)
    assert _loadtxt(pcfg, "loss_vs_ctx.txt").shape == (MAX_CTX,)


def _anp_cfg(data_dir, **kw):
    return _cfg(data_dir, method="ANPShapeNet1D", agg_mode="attention",
                aug_list=[], **kw)


def test_eval_one_task_cli_matches_jax(data_dir, tmp_path):
    """``eval_one_task_cli`` with an ANP (K2 at one task) over a bare
    ``state_dict``: ``test_losses.txt`` against the JAX CLI's; the curve is
    flat (every point scores the same frozen batch) and its std 0."""
    cfg = _anp_cfg(data_dir, mode="eval_one_task")
    jcfg0 = JaxConfig.from_dict(cfg)
    variables = to_numpy(jax_init_model(jax_build_model(jcfg0), jcfg0,
                                        jax.random.PRNGKey(2)))
    cfg["checkpoint"] = _bare_checkpoint(cfg, variables, tmp_path / "anp.pt")
    jcfg, pcfg = _configs(cfg, tmp_path)
    want = jax_eval_one_task_cli.evaluate(jcfg)
    got = eval_one_task_cli.evaluate(pcfg)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    table = _loadtxt(pcfg, "test_losses.txt")
    np.testing.assert_allclose(table, _loadtxt(jcfg, "test_losses.txt"),
                               rtol=RTOL, atol=FILE_TOL)
    assert table.shape == (MAX_CTX, 3)
    assert list(table[:, 0]) == list(range(1, MAX_CTX + 1))
    assert len(set(got)) == 1 and not table[:, 2].any()


def test_eval_and_plot_cli_matches_jax(data_dir, tmp_path):
    """``eval_and_plot_cli`` (ctx ``min(15, max_ctx_num)``, ``val_iters``
    2, T = 2): ``losses_all.txt`` against the JAX function's, and a PNG per
    episode where matplotlib is installed."""
    cfg = _anp_cfg(data_dir, mode="eval_and_plot", tasks_per_batch=2)
    jcfg0 = JaxConfig.from_dict(cfg)
    variables = to_numpy(jax_init_model(jax_build_model(jcfg0), jcfg0,
                                        jax.random.PRNGKey(4)))
    cfg["checkpoint"] = _bare_checkpoint(cfg, variables, tmp_path / "anp.pt")
    jcfg, pcfg = _configs(cfg, tmp_path)
    want = jax_evaluate_and_plot(jcfg, ctx_num=min(15, jcfg.max_ctx_num))
    got = eval_and_plot_cli.evaluate(pcfg)
    assert len(got) == 2
    np.testing.assert_allclose(got, want, rtol=RTOL)
    np.testing.assert_allclose(_loadtxt(pcfg, "losses_all.txt"),
                               _loadtxt(jcfg, "losses_all.txt"),
                               rtol=RTOL, atol=FILE_TOL)
    try:
        import matplotlib  # noqa: F401
    except ImportError:     # the numbers are written, no plot
        assert not os.path.exists(os.path.join(pcfg.save_path, "plots"))
        return
    assert sorted(os.listdir(os.path.join(pcfg.save_path, "plots"))) == [
        "batch_000.png", "batch_001.png"]
