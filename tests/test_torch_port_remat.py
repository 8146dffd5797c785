"""``maml_remat`` (the MAML inner loop's rematerialisation) on the CPU.

For MAMLShapeNet1D, MAMLMRShapeNet1D (a BBB sample per task and inner
step, drawn inside the rematerialised step), Pascal1D's VanillaMAML and
MMAMLShapeNet1D at the parity tests' small widths (2 tasks, 32 x 32, 2
inner steps), the second-order outer loss and gradients under ``step`` and
``dots``:

  * against the port's ``none``: bit for bit, in float64 and in float32
    (the recompute runs the same operations on the same values on the CPU,
    and the generator ends where ``none`` leaves it: the recompute replays
    the step's draws);
  * against the JAX package under the same ``maml_remat``: in
    ``tests/test_torch_port_remat_jax.py``.

JAX's ``dots`` (``dots_with_no_batch_dims_saveable``) saves what ``step``
saves at these shapes, for all four methods: its residual lists are equal
(``jax.ad_checkpoint.print_saved_residuals``), so ``dots`` runs ``step``
in the port. Any other value reads as ``step``, as in JAX; learned step
sizes get none's gradients; what autograd keeps outside the steps shrinks
to a small share of none's; evaluation is the same with and without
remat; the shipped YAMLs train through ``train_cli`` with each mode.
"""

import copy
import functools
import os

import jax
import pytest
import torch

from test_torch_port_maml import _pair as maml_pair
from test_torch_port_maml import _raw_batch as maml_batch
from test_torch_port_mmaml import (_configs, _jax_bundle, _jax_params,
                                   _port_bundle)
from test_torch_port_mmaml import _raw_batch as mmaml_batch
from test_torch_port_mr import _maml_pair, _raw
from test_torch_port_pascal import _raw_episode as pascal_batch
from torch_port_common import t
from wmfml_tpu.train.maml import build_maml_outer as jax_maml_outer
from wmfml_tpu.train.mmaml import build_mmaml_outer as jax_mmaml_outer
from wmfml_tpu_torch.aug import pipeline
from wmfml_tpu_torch.configs import Config
from wmfml_tpu_torch.ops.cast import set_compute_dtype
from wmfml_tpu_torch.train.maml import (build_maml_eval_step,
                                        build_maml_outer, remat_mode)
from wmfml_tpu_torch.train.mmaml import (build_mmaml_eval_step,
                                         build_mmaml_outer)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METHODS = ("MAMLShapeNet1D", "MAMLMRShapeNet1D", "VanillaMAML",
           "MMAMLShapeNet1D")
MODES = ("step", "dots")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for each test: at these sizes torch's threads
    only add synchronisation, and under ``pytest -n`` (every worker's
    threads on the same cores) each small op waits on it many times over;
    the previous count is restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _built(method, over):
    """``_case``'s objects under ``maml_remat: none``, built once for each
    method and set of overrides (the JAX models' inits compile)."""
    over = dict(over)
    if method == "MMAMLShapeNet1D":
        jcfg, pcfg = _configs(**over)
        return (_jax_bundle(), jcfg, _jax_params(), mmaml_batch(),
                _port_bundle(), pcfg)
    if method == "MAMLMRShapeNet1D":
        (jm, jcfg, net), (pm, pcfg) = _maml_pair(method=method, **over)
        return jm, jcfg, net, _raw("shapenet_1d"), pm, pcfg
    if method == "VanillaMAML":     # Pascal1D's: output dim 1, no tanh
        (jm, jcfg, net), (pm, pcfg) = maml_pair(
            method=method, task="pascal_1d", update_lr=0.002, **over)
        return jm, jcfg, net, pascal_batch(4, s=3, q=2), pm, pcfg
    (jm, jcfg, net), (pm, pcfg) = maml_pair(method=method, **over)
    return jm, jcfg, net, maml_batch(), pm, pcfg


def _case(method, mode, **over):
    """(JAX model or bundle, JAX config, JAX params, raw batch, port model,
    port config) of ``method`` at the small widths, ``maml_remat=mode``:
    the configs and the port model are fresh copies."""
    jm, jcfg, net, raw, pm, pcfg = _built(method, tuple(sorted(over.items())))
    jcfg, pcfg = copy.copy(jcfg), copy.copy(pcfg)
    jcfg.maml_remat = pcfg.maml_remat = mode
    return jm, jcfg, net, raw, copy.deepcopy(pm), pcfg


def _port_grads(method, model, cfg, raw, noise, dtype=torch.float32):
    """The port's outer loss and gradients on ``raw`` (a copy of ``model``
    in ``dtype``, the images cast to it), and the noise generator's state
    after."""
    model = set_compute_dtype(copy.deepcopy(model).to(dtype), dtype)
    batch = {k: t(v) for k, v in raw.items()}
    saved = pipeline._to_float
    pipeline._to_float = lambda x, _=None: saved(x).to(dtype)
    try:
        if method == "MMAMLShapeNet1D":
            loss = build_mmaml_outer(model, cfg, 2, train=True,
                                     test=False)(batch)
        else:
            loss = build_maml_outer(model, cfg, 2, train=True,
                                    test=False)(batch, noise=noise)[0]
        names, params = zip(*model.named_parameters())
        grads = torch.autograd.grad(loss, params)
    finally:
        pipeline._to_float = saved
    return loss, dict(zip(names, grads))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("method", METHODS)
def test_remat_equals_none_bit_for_bit(method, mode, dtype):
    """``step`` / ``dots`` against ``none``: the loss and every gradient
    equal bit for bit, in float64 and in float32 (tolerance 0: the CPU
    recomputes the same operations in the same order); MAMLMR's generator
    ends where ``none`` leaves it, so the recompute drew nothing."""
    runs = {}
    for m in ("none", mode):
        *_, raw, model, cfg = _case(method, m)
        gen = torch.Generator().manual_seed(3)
        runs[m] = (*_port_grads(method, model, cfg, raw, gen, dtype),
                   gen.get_state())
    (loss0, grads0, state0), (loss, grads, state) = runs["none"], runs[mode]
    assert loss.dtype == (torch.float32 if method == "MMAMLShapeNet1D"
                          or dtype == torch.float32 else loss.dtype)
    assert torch.equal(loss, loss0)
    assert grads.keys() == grads0.keys()
    for name in grads:
        assert grads[name].dtype == dtype, name
        assert torch.equal(grads[name], grads0[name]), name
    assert torch.equal(state, state0)
    # the check sees the second-order terms (the gradients are not zero)
    assert max(g.abs().max().item() for g in grads.values()) > 0


@pytest.mark.parametrize("per_param", [False, True])
def test_remat_with_learned_step_sizes_equals_none(per_param):
    """``learn_step_size`` (one step size, or one per adapted parameter):
    under ``step`` the step sizes, which the rematerialised steps read from
    outside, get none's gradients bit for bit, as every other parameter."""
    grads = {}
    for mode in ("none", "step"):
        *_, raw, model, cfg = _case("MAMLShapeNet1D", mode,
                                    learn_step_size=True,
                                    per_param_step_size=per_param)
        grads[mode] = _port_grads("MAMLShapeNet1D", model, cfg, raw, None,
                                  torch.float64)[1]
    assert any(k.startswith("step_size") for k in grads["step"])
    for name, g in grads["step"].items():
        assert torch.equal(g, grads["none"][name]), name
        if name.startswith("step_size"):
            assert g.abs().max().item() > 0, name


@pytest.mark.parametrize("method", ["MAMLMRShapeNet1D", "MMAMLShapeNet1D"])
def test_remat_keeps_only_what_the_steps_do_not_recompute(method):
    """What autograd keeps for the outer backward, outside the
    rematerialised steps (an outer ``saved_tensors_hooks`` sees every
    tensor saved there): under ``step`` the steps' activations and inner
    gradients are gone, a small share of ``none``'s bytes is left."""
    kept = {}
    for mode in ("none", "step"):
        *_, raw, model, cfg = _case(method, mode)
        nbytes = []

        def pack(x):
            nbytes.append(x.numel() * x.element_size())
            return x

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
            loss, _ = _port_grads(method, model, cfg, raw,
                                  torch.Generator().manual_seed(3))
        kept[mode] = sum(nbytes)
    assert kept["step"] < 0.5 * kept["none"], kept


def _jax_residuals(method, mode, capsys):
    """JAX's saved residuals of the outer loss's VJP under ``mode``."""
    from jax.ad_checkpoint import print_saved_residuals

    jm, jcfg, params, raw, _, _ = _case(method, "none")
    jcfg.maml_remat = mode
    key = jax.random.PRNGKey(0)
    if method == "MMAMLShapeNet1D":
        outer = jax_mmaml_outer(jm, jcfg, 2, train=True, test=False)
        fn = lambda p: outer(p, raw, key)            # noqa: E731
    else:
        outer = jax_maml_outer(jm, jcfg, 2, train=True, test=False)
        fn = lambda p: outer(p, raw, key)[0]         # noqa: E731
    capsys.readouterr()
    print_saved_residuals(fn, params)
    return capsys.readouterr().out.strip().splitlines()


@pytest.mark.parametrize("method", METHODS)
def test_jax_dots_saves_what_step_saves(method, capsys):
    """JAX's ``dots`` (``dots_with_no_batch_dims_saveable`` inside
    ``vmap(per_task)``) keeps exactly ``step``'s residuals: every product
    of the inner step has a batch dimension (the adapted weights are per
    task, MAMLMR's BBB sample too) and convolutions are never saved. So
    ``dots`` runs ``step`` in the port."""
    assert (_jax_residuals(method, "dots", capsys)
            == _jax_residuals(method, "step", capsys))


def test_jax_reads_an_unknown_mode_as_step(capsys):
    """A value JAX does not know (``full``) keeps ``step``'s residuals;
    ``none`` keeps far more."""
    step = _jax_residuals("MAMLShapeNet1D", "step", capsys)
    assert _jax_residuals("MAMLShapeNet1D", "full", capsys) == step
    assert len(_jax_residuals("MAMLShapeNet1D", "none", capsys)) > 1.3 * len(
        step)


def test_remat_mode_reads_maml_remat_as_jax():
    """none / unset / empty -> none, dots -> dots, anything else -> step
    (``wmfml_tpu/train/maml.py:69-78, 100``), and an unknown value runs
    the step path: bit for bit ``step``'s gradients."""
    for value, mode in ((None, "none"), ("", "none"), ("none", "none"),
                        ("dots", "dots"), ("step", "step"), ("full", "step"),
                        (True, "step")):
        cfg = Config.from_dict(dict(method="MAMLShapeNet1D",
                                    task="shapenet_1d", tasks_per_batch=2,
                                    max_ctx_num=3, lr=1e-4, seed=0,
                                    device="cpu", maml_remat=value))
        assert remat_mode(cfg) == mode, value
    runs = {}
    for m in ("step", "full"):
        *_, raw, model, cfg = _case("MAMLMRShapeNet1D", m)
        runs[m] = _port_grads("MAMLMRShapeNet1D", model, cfg, raw,
                              torch.Generator().manual_seed(5))
    assert torch.equal(runs["step"][0], runs["full"][0])
    for name, g in runs["step"][1].items():
        assert torch.equal(g, runs["full"][1][name]), name


@pytest.mark.parametrize("method", ["MAMLMRShapeNet1D", "MMAMLShapeNet1D"])
def test_evaluation_is_the_same_with_remat(method):
    """The eval step (``test_num_steps`` inner steps, no outer gradient)
    gives the same loss bit for bit under every mode."""
    got = {}
    for mode in ("none", "step", "dots"):
        *_, raw, model, cfg = _case(method, mode)
        batch = {k: t(v) for k, v in raw.items()}
        if method == "MMAMLShapeNet1D":
            got[mode] = build_mmaml_eval_step(model, cfg)(batch)
        else:
            got[mode] = build_maml_eval_step(model, cfg)(
                batch, torch.Generator().manual_seed(2))
    assert torch.equal(got["step"], got["none"])
    assert torch.equal(got["dots"], got["none"])


@pytest.mark.parametrize("yaml", ["MAML_DA_ShapeNet1D.yaml",
                                  "MMAML_ShapeNet1D_DA+TA.yaml"])
def test_shipped_yaml_trains_with_each_mode(yaml, tmp_path, monkeypatch):
    """``train_cli`` over a shipped YAML (full widths, the shipped
    augmentation; 2 tasks, 3 context rows, 2 inner steps): one step under
    ``none``, ``step`` and ``dots`` from one seed leaves the same loss and
    weights bit for bit."""
    from wmfml_tpu_torch.cli import train_cli
    from wmfml_tpu_torch.data.synthetic import generate_shapenet1d

    data = str(tmp_path / "sn1d")
    generate_shapenet1d(data, seed=0, instances=7, val_classes=3,
                        test_classes=2)
    monkeypatch.chdir(tmp_path)
    out = {}
    for mode in ("none", "step", "dots"):
        cfg = Config(os.path.join(REPO, "cfg", "train", yaml),
                     ["device=cpu", f"data_path={data}", "data_size=small",
                      "tasks_per_batch=2", "max_ctx_num=3", "num_updates=2",
                      "steps_per_call=1", f"maml_remat={mode}"],
                     make_dirs=False)
        trainer = train_cli.build_trainer(cfg)
        loss = trainer.train_step(trainer.generator)["loss"]
        out[mode] = (loss, [p.detach().clone()
                            for p in trainer.model.parameters()])
    for mode in ("step", "dots"):
        assert torch.equal(out[mode][0], out["none"][0]), mode
        assert all(torch.equal(a, b) for a, b in zip(out[mode][1],
                                                     out["none"][1])), mode
    assert bool(torch.isfinite(out["none"][0]))
