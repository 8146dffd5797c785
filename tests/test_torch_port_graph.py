"""The port's fused K-step training call (``train/steps.py:FusedSteps``)
on the CPU, where a call is a loop of K steps: against K calls of the
single step, against a trainer that takes one step a call, and against the
JAX package's ``build_multi_train_step`` over the same staged batches.
On the card the same call is one CUDA graph replay
(``tests/test_torch_port_cuda.py`` holds it against this loop there).

Small widths: T = 2 tasks, S = 3 context rows, 32x32 images (128x128 where
the trainer reads the synthetic ShapeNet1D split). Tolerance: bit for bit
where both sides run the same code on the same draws; ``RTOL``/``ATOL``
(``torch_port_common``) against the JAX package.
"""

import math
import os

import jax
import numpy as np
import pytest
import torch

from torch_port_adam import optax_adam
from torch_port_common import ATOL, RTOL, WIDTHS, jax_grads_as_port, t, to_numpy
from wmfml_tpu.configs import Config as JaxConfig
from wmfml_tpu.models.registry import build_model as jax_build_model
from wmfml_tpu.train.state import TrainState, build_optimizer as jax_optimizer
from wmfml_tpu.train.steps import build_multi_train_step as jax_multi_step
from wmfml_tpu.train.steps import init_model as jax_init_model
from wmfml_tpu_torch.ckpt.checkpoint import CheckpointManager
from wmfml_tpu_torch.ckpt.jax_params import load_jax_variables
from wmfml_tpu_torch.cli import train_cli
from wmfml_tpu_torch.configs import Config
from wmfml_tpu_torch.data.device_sampler import DeviceEpisodeSampler
from wmfml_tpu_torch.data.synthetic import generate_shapenet1d
from wmfml_tpu_torch.models.registry import build_model
from wmfml_tpu_torch.train.maml import (build_maml_device_train_step,
                                        build_maml_train_step)
from wmfml_tpu_torch.train.state import build_optimizer
from wmfml_tpu_torch.train.steps import (FusedSteps, anp_metrics,
                                         build_device_data_train_step,
                                         build_train_step)
from torch_port_common import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ANP_YAML = os.path.join(REPO, "cfg", "train", "ANP_DA+TA_ShapeNet1D.yaml")
MAML_YAML = os.path.join(REPO, "cfg", "train", "MAML_DA_ShapeNet1D.yaml")
T_, S_, HW, K = 2, 3, 32, 3
AUG = "aug_list=[data_aug,task_aug]"
SMALL = {"ANPShapeNet1D": ["dim_w=16", "dim_r=12", "dim_z=8"],
         "MAMLShapeNet1D": ["dim_w=36", "num_filters=8", "num_updates=1",
                            "test_num_updates=1"]}
YAML = {"ANPShapeNet1D": ANP_YAML, "MAMLShapeNet1D": MAML_YAML}


def _config(method, *extra):
    cfg = Config(YAML[method], ["device=cpu", AUG, f"tasks_per_batch={T_}",
                                f"max_ctx_num={S_}", *SMALL[method], *extra],
                 make_dirs=False)
    cfg.img_size = [HW, HW, 1]
    return cfg


def _sampler(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 255, (4, 2 * S_ + 1, HW, HW, 1)).astype(np.uint8)
    y = rng.rand(4, 2 * S_ + 1, 1).astype(np.float32)
    return DeviceEpisodeSampler(x, y, max_ctx=S_, query=S_, shot_min=2,
                                label_scale=2 * np.pi, device="cpu")


def _state(model, optimizer, generator):
    return ({k: v.clone() for k, v in model.state_dict().items()},
            {i: {k: v.clone() for k, v in s.items()}
             for i, s in optimizer.state_dict()["state"].items()},
            generator.get_state())


def _assert_same_state(a, b):
    (wa, oa, ga), (wb, ob, gb) = a, b
    assert wa.keys() == wb.keys() and oa.keys() == ob.keys() and oa
    for k in wa:
        assert torch.equal(wa[k], wb[k]), k
    for i in oa:
        for k in oa[i]:
            assert torch.equal(oa[i][k], ob[i][k]), (i, k)
    assert torch.equal(ga, gb)


@pytest.mark.parametrize("method", ["ANPShapeNet1D", "MAMLShapeNet1D"])
def test_fused_call_equals_k_single_steps_bit_for_bit(method):
    """One call at K = 3 against three calls of the single step on the same
    draws: weights, Adam state, generator and the metric dict."""
    cfg = _config(method)
    sampler = _sampler()
    runs = []
    for fused in (True, False):
        model = build_model(cfg)
        opt = build_optimizer(cfg, model.parameters())
        gen = torch.Generator().manual_seed(5)
        if fused:
            build = (build_maml_device_train_step if "MAML" in method
                     else build_device_data_train_step)
            call = build(model, opt, cfg, sampler, K)
            metrics = call(gen)
            assert call.graph is None and call.replays == 0
            assert call.metrics is metrics
        else:
            build = (build_maml_train_step if "MAML" in method
                     else build_train_step)
            step = build(model, opt, cfg)
            losses = [step(sampler.sample(T_, gen), gen) for _ in range(K)]
            metrics = {"loss": torch.stack(losses).mean()}
            if "MAML" in method:
                metrics.update({k: step.metrics[k]
                                for k in ("task_loss", "kl", "contra")})
            else:
                metrics["last_loss"] = losses[-1]
        runs.append((metrics, _state(model, opt, gen)))
    (got, state), (want, want_state) = runs
    want_keys = ({"loss", "task_loss", "kl", "contra"} if "MAML" in method
                 else {"loss", "last_loss"})
    assert set(got) == set(want) == want_keys
    for k in want:
        assert torch.equal(torch.as_tensor(got[k]),
                           torch.as_tensor(want[k])), k
    _assert_same_state(state, want_state)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sn1d"))
    generate_shapenet1d(root, seed=0, instances=2 * S_ + 1, val_classes=3,
                        test_classes=2)
    return root


@pytest.mark.parametrize("method", ["ANPShapeNet1D", "MAMLShapeNet1D"])
def test_trainer_at_two_steps_a_call_equals_one_step_a_call(method, data_dir,
                                                            tmp_path,
                                                            monkeypatch):
    """6 iterations at ``steps_per_call`` 2 and at 1, image and task
    augmentation on: the same weights, Adam state and generator state."""
    monkeypatch.chdir(tmp_path)
    states = []
    for k in (2, 1):
        cfg = Config(YAML[method], [
            "device=cpu", AUG, f"data_path={data_dir}", "data_size=small",
            "iterations=6", "val_freq=100", "val_iters=1",
            f"tasks_per_batch={T_}", f"max_ctx_num={S_}", *SMALL[method],
            f"steps_per_call={k}"])
        trainer = train_cli.train(cfg)
        assert trainer.step == 6
        assert trainer.train_step.calls == 6 // k
        states.append(_state(trainer.model, trainer.optimizer,
                             trainer.generator))
    _assert_same_state(*states)


class _Staged:
    """A sampler that hands out staged episodes in order."""

    def __init__(self, batches):
        self.batches = iter(batches)

    def sample(self, tasks, generator):
        return next(self.batches)


def test_k_steps_over_staged_batches_match_jax_multi_train_step():
    """K = 3 port steps, each fed its staged batch and the TA offsets JAX
    draws for it, against ``build_multi_train_step`` over the same [K, ...]
    batches: ``loss`` (mean of K), ``last_loss`` and the weights."""
    cfg = dict(method="ANPShapeNet1D", task="shapenet_1d",
               agg_mode="attention", aug_list=["task_aug"],
               tasks_per_batch=T_, max_ctx_num=S_, query_num=S_,
               dim_w=WIDTHS["dim_w"], dim_r=WIDTHS["dim_r"],
               dim_z=WIDTHS["dim_z"],
               n_hidden_units_r=list(WIDTHS["n_hidden_units_r"]), lr=1e-4,
               seed=0, loss_type="mse", weight_decay=False, optimizer="Adam",
               device="cpu")
    jcfg, pcfg = JaxConfig.from_dict(cfg), Config.from_dict(cfg)
    jcfg.img_size = pcfg.img_size = [HW, HW, 1]
    jmodel = jax_build_model(jcfg)
    variables = to_numpy(jax_init_model(jmodel, jcfg, jax.random.PRNGKey(1)))
    model = load_jax_variables(build_model(pcfg), variables)

    rng = np.random.RandomState(4)
    batches = [dict(
        ctx_x=rng.randint(0, 255, (T_, S_, HW, HW, 1)).astype(np.uint8),
        ctx_y=rng.uniform(0, 2 * np.pi, (T_, S_, 1)).astype(np.float32),
        ctx_mask=np.arange(S_)[None, :].repeat(T_, 0) < 2 + i % 2,
        qry_x=rng.randint(0, 255, (T_, S_, HW, HW, 1)).astype(np.uint8),
        qry_y=rng.uniform(0, 2 * np.pi, (T_, S_, 1)).astype(np.float32))
        for i in range(K)]
    key = jax.random.PRNGKey(7)
    # step i's key, then the offsets its forward draws: (k_aug, _) ->
    # (_, k_ta), as in test_torch_port_train's single step
    ta = []
    for k_i in jax.random.split(key, K):
        _, k_ta = jax.random.split(jax.random.split(k_i)[0])
        ta.append(t(np.asarray(jax.random.randint(k_ta, (T_, 1, 1), 0,
                                                  15)).ravel()))

    tx = jax_optimizer(jcfg)
    state = TrainState.create(jax.tree_util.tree_map(np.array, variables), tx)
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    state, want = jax_multi_step(jmodel, jcfg, None, tx, K)(state, stacked,
                                                             key)

    opt = build_optimizer(pcfg, model.parameters())
    step = build_train_step(model, opt, pcfg)
    offsets = iter(ta)
    call = FusedSteps(lambda b, g: step(b, g, ta_idx=next(offsets)),
                      _Staged([{k: t(v) for k, v in b.items()}
                               for b in batches]),
                      T_, K, opt, anp_metrics)
    got = call(None)
    for k in ("loss", "last_loss"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    mapped = jax_grads_as_port(model, state.params, variables)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), mapped[name].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("name,weight_decay", [("Adam", False),
                                               ("Adam", 0.01),
                                               ("AdamW", False),
                                               ("SGD", False)])
def test_optimizer_is_not_capturable_on_cpu_parameters(name, weight_decay):
    """``build_optimizer`` makes Adam and AdamW capturable on CUDA
    parameters only (the ``cuda`` tests assert that case): on the CPU they
    keep PyTorch's default step, and SGD has nothing to capture."""
    cfg = _config("ANPShapeNet1D", f"optimizer={name}",
                  f"weight_decay={weight_decay}")
    model = build_model(cfg)
    opt = build_optimizer(cfg, model.parameters())
    want = {"Adam": torch.optim.AdamW if weight_decay else torch.optim.Adam,
            "AdamW": torch.optim.AdamW, "SGD": torch.optim.SGD}[name]
    assert type(opt) is want
    assert opt.param_groups[0].get("capturable", False) is False
    assert len(opt.param_groups[0]["params"]) == len(list(model.parameters()))


def test_float32_adam_reference_matches_optax():
    """``torch_port_adam.optax_adam``, the reference the ``cuda`` tests hold
    the card's capturable Adam to, against optax's Adam over 8 steps."""
    import optax

    rng = np.random.RandomState(3)
    p0 = rng.randn(64).astype(np.float32)
    grads = [(rng.randn(64) * 10.0 ** rng.uniform(-4, 1, 64)).astype(
        np.float32) for _ in range(8)]
    tx = optax.adam(1e-3)
    params = jax.numpy.asarray(p0)
    state = tx.init(params)
    for g, want in zip(grads, optax_adam(p0, grads, 1e-3)):
        updates, state = tx.update(jax.numpy.asarray(g), state, params)
        params = optax.apply_updates(params, updates)
        np.testing.assert_allclose(want, np.asarray(params), rtol=RTOL,
                                   atol=ATOL)


def test_restore_keeps_the_optimizers_own_capturable_flag(tmp_path):
    """A checkpoint written on the card (its Adam groups capturable) restores
    into a CPU trainer's Adam, which stays non-capturable with its step
    counts on the CPU, and steps on; and the other way round the flag the
    optimizer was built with wins."""
    cfg = _config("ANPShapeNet1D")
    model = build_model(cfg)
    opt = build_optimizer(cfg, model.parameters())
    step = build_train_step(model, opt, cfg)
    gen = torch.Generator().manual_seed(1)
    sampler = _sampler()
    step(sampler.sample(T_, gen), gen)
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save("card", 1, model, opt, gen)
    payload = torch.load(ckpt.path("card"), weights_only=True)
    for group in payload["optimizer"]["param_groups"]:
        group["capturable"] = True            # as a card run writes it
    torch.save(payload, ckpt.path("card"))

    restored = build_model(cfg)
    opt2 = build_optimizer(cfg, restored.parameters())
    gen2 = torch.Generator()
    assert ckpt.restore("card", restored, opt2, generator=gen2) == 1
    assert torch.equal(gen2.get_state(), gen.get_state())
    assert opt2.param_groups[0]["capturable"] is False
    steps = [s["step"] for s in opt2.state.values()]
    assert steps and all(s.device.type == "cpu" and float(s) == 1.0
                         for s in steps)
    build_train_step(restored, opt2, cfg)(sampler.sample(T_, gen2), gen2)
    assert all(float(s["step"]) == 2.0 for s in opt2.state.values())

    opt3 = build_optimizer(cfg, build_model(cfg).parameters())
    opt3.param_groups[0]["capturable"] = True  # as build_optimizer on CUDA
    ckpt.save("cpu", 1, model, opt, gen)
    ckpt.restore("cpu", build_model(cfg), opt3)
    assert opt3.param_groups[0]["capturable"] is True


def test_fused_call_warms_up_ceil_three_over_k_calls():
    """The number of eager calls before the capture (on the card): enough
    calls that three steps run before it, whatever K."""
    cfg = _config("ANPShapeNet1D")
    model = build_model(cfg)
    opt = build_optimizer(cfg, model.parameters())
    for k in (1, 2, 3, 4, 64):
        call = build_device_data_train_step(model, opt, cfg, _sampler(), k)
        assert call.k == k and call.warm_calls == math.ceil(3 / k)
        assert call.warm_calls * k >= 3 > (call.warm_calls - 1) * k
