"""The phase-layout ResNet trunk stem (``trunk_stem: s2d``) against the
JAX package's ``ResNetTrunk(trunk_stem="s2d")`` (``_s2d_trunk_stem``), on
the same variables, as ``tests/test_s2d_trunk.py`` runs it on the CPU:

  * values within 1e-5 in float32, parameter gradients within 1e-5 of
    each tensor's largest plus rtol 1e-4 (``_grad_close``: they sum over
    every pixel of the batch in another order), within the bfloat16 rule
    (``test_torch_port_bf16.py:assert_bf16_close``) in bfloat16, for every
    ``img_agg``;
  * against the port's stock stem within JAX's own 2e-5 / 2e-4;
  * the stock stack at sizes that are not multiples of 4;
  * ANPMRShapeNet3D (the BBB trunk) unchanged by the key;
  * one DA + TA ANPDistractor step with ``trunk_stem=s2d`` against JAX's,
    in float32 and in bfloat16.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_bf16 import (_as_written, _capture_grads, _same_dtype,
                                  assert_bf16_close, assert_nearer_overall)
from test_torch_port_distractor import _raw_episode as distractor_episode
from test_torch_port_distractor import jax_process_draws as distractor_draws
from test_torch_port_large_bf16 import _scaled
from test_torch_port_shapenet3d import _raw_episode as s3d_episode
from torch_port_common import (ATOL, GRAD_TOL, RTOL, jax_grads_as_port, t,
                               to_numpy)
from wmfml_tpu.configs import Config as JaxConfig
from wmfml_tpu.models.registry import build_model as jax_build_model
from wmfml_tpu.nn.encoders import ResNetTrunk as JaxTrunk
from wmfml_tpu.train.state import TrainState
from wmfml_tpu.train.steps import build_train_step as jax_train_step
from wmfml_tpu.train.steps import init_model as jax_init_model
from wmfml_tpu_torch.ckpt.jax_params import load_jax_variables, trunk_state_dict
from wmfml_tpu_torch.configs import Config
from wmfml_tpu_torch.models.registry import build_model
from wmfml_tpu_torch.nn.encoders import ResNetTrunk
from wmfml_tpu_torch.ops.cast import set_compute_dtype
from wmfml_tpu_torch.train.steps import build_train_step

BF16, F32 = jnp.bfloat16, jnp.float32
AGGS = ["mean", "max", "baco", "reshape"]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for each test: at these sizes torch's threads
    only add synchronisation under ``pytest -n`` (every worker's threads on
    the same cores); the previous count is restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _chw(y, n, img_agg, hw):
    """JAX's HWC flatten as the port's CHW one."""
    y = np.asarray(jnp.asarray(y).astype(F32))
    if img_agg == "mean":
        return y
    side = 2 if img_agg in ("max", "baco") else hw // 32
    return y.reshape(n, side, side, 64).transpose(0, 3, 1, 2).reshape(n, -1)


def _trunks(img_agg, hw, c, seed=0):
    """x, the JAX s2d trunk's variables, and the port's trunks with them
    (s2d and stock)."""
    x = np.random.RandomState(seed).rand(3, hw, hw, c).astype(np.float32)
    variables = to_numpy(JaxTrunk(img_agg=img_agg, trunk_stem="s2d").init(
        jax.random.PRNGKey(seed), x))
    ports = {}
    for stem in ("s2d", "conv"):
        ports[stem] = ResNetTrunk(img_agg, c, stem)
        ports[stem].load_state_dict(trunk_state_dict(variables["params"]),
                                    strict=True)
    return x, variables, ports


def _grad_close(got, want, name=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max(), err_msg=name)


def _port_grads(trunk, x):
    trunk.zero_grad(set_to_none=True)
    y = trunk(t(x))
    y.square().sum().backward()
    return y.detach().numpy(), {k: p.grad.numpy().copy()
                                for k, p in trunk.named_parameters()}


@pytest.mark.parametrize("img_agg", AGGS)
def test_s2d_trunk_matches_jax_values_and_grads(img_agg):
    hw = 64 if img_agg in ("max", "baco") else 32
    x, variables, ports = _trunks(img_agg, hw, 3)
    jm = JaxTrunk(img_agg=img_agg, trunk_stem="s2d")
    want = _chw(jm.apply(variables, x), 3, img_agg, hw)
    jgrads = jax.grad(lambda p: jnp.sum(jm.apply({"params": p}, x) ** 2))(
        variables["params"])
    want_grads = trunk_state_dict(to_numpy(jgrads))
    got, grads = _port_grads(ports["s2d"], x)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    for name, g in grads.items():
        _grad_close(g, want_grads[name].numpy(), name)
    # the port's stock stem on the same weights, at JAX's own tolerances
    stock, stock_grads = _port_grads(ports["conv"], x)
    np.testing.assert_allclose(got, stock, rtol=2e-5, atol=2e-5)
    for name, g in grads.items():
        np.testing.assert_allclose(g, stock_grads[name], rtol=2e-4,
                                   atol=2e-4, err_msg=name)


@pytest.mark.parametrize("img_agg", AGGS)
def test_s2d_trunk_matches_jax_in_bf16(img_agg):
    """x and every weight cast before the assembly, the bias added in
    bfloat16, each convolution rounded, as JAX's s2d stem does."""
    hw = 64
    x, variables, ports = _trunks(img_agg, hw, 3, seed=2)
    xb = jnp.asarray(x, BF16)
    want = {dt: jax.jit(lambda v, a, dt=dt: JaxTrunk(
        img_agg=img_agg, dtype=dt, trunk_stem="s2d").apply(v, a))
        for dt in (BF16, None)}
    want_bf16 = _as_written(want[BF16], variables, xb)
    want_f32 = want[None](variables, xb.astype(F32))
    trunk = set_compute_dtype(ports["s2d"], torch.bfloat16)
    with torch.no_grad():
        got = trunk(t(np.asarray(xb.astype(F32))).to(torch.bfloat16))
    _same_dtype(got, want_bf16)
    assert_bf16_close(got, _chw(want_bf16, 3, img_agg, hw),
                      _chw(want_f32, 3, img_agg, hw), f"s2d {img_agg}")


@pytest.mark.parametrize("hw", [34, 66])
def test_s2d_falls_back_to_the_stock_stack(hw):
    """H, W not multiples of 4: both packages run the stock stack."""
    x, variables, ports = _trunks("mean", hw, 1, seed=3)
    want = np.asarray(JaxTrunk(img_agg="mean", trunk_stem="s2d").apply(
        variables, x))
    got, grads = _port_grads(ports["s2d"], x)
    stock, stock_grads = _port_grads(ports["conv"], x)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.array_equal(got, stock)
    assert all(np.array_equal(g, stock_grads[k]) for k, g in grads.items())


def _cfg(method, task, agg_mode, img_agg, **extra):
    return dict(method=method, task=task, agg_mode=agg_mode, img_agg=img_agg,
                aug_list=["data_aug", "task_aug"], tasks_per_batch=2,
                max_ctx_num=3, query_num=3, lr=1e-4, seed=0, loss_type="mse",
                optimizer="SGD", device="cpu", **extra)


def test_s2d_builds_where_jax_takes_it_and_not_in_the_bbb_trunk():
    """Every LargeCNP and SingleTask ShapeNet3D / Distractor method builds
    with ``trunk_stem=s2d`` on both trunks; ANPMRShapeNet3D keeps the
    stock stem everywhere, as the JAX registry builds it, so its output is
    the stock model's."""
    for method, task, agg in (("CondNeuralProcess", "shapenet_3d", "baco"),
                              ("ANP", "shapenet_3d", "attention"),
                              ("FCLANP", "shapenet_3d", "attention"),
                              ("SingleTaskShapeNet3D", "shapenet_3d", "max"),
                              ("CNPDistractor", "distractor", "max"),
                              ("ANPDistractor", "distractor", "attention"),
                              ("FCLCNPDistractor", "distractor", "max"),
                              ("SingleTaskDistractor", "distractor", "max")):
        model = build_model(Config.from_dict(_cfg(
            method, task, agg, "max", dim_w=16, trunk_stem="s2d")))
        assert model.img_encoder.trunk_stem == "s2d", method
        assert model.decoder.trunk_stem == "s2d", method
    raw = s3d_episode(4)
    out = {}
    for stem in ("s2d", "conv"):
        model = build_model(Config.from_dict(_cfg(
            "ANPMRShapeNet3D", "shapenet_3d", "attention", "reshape",
            trunk_stem=stem)))
        assert not hasattr(model.img_encoder, "trunk_stem")
        assert model.decoder.trunk_stem == "conv"
        with torch.no_grad():
            out[stem] = model.eval()(
                t(raw["ctx_x"][..., :3]), t(raw["ctx_y"]),
                t(raw["qry_x"][..., :3]), ctx_mask=t(raw["ctx_mask"]),
                generator=torch.Generator().manual_seed(5)).mu
    assert torch.equal(out["s2d"], out["conv"])


# ANPDistractor at T = 2: ShapeNet3D's RGB trunks are held above
STEP_CFG = dict(_cfg("ANPDistractor", "distractor", "attention", "max",
                     dim_w=16), trunk_stem="s2d")


@functools.lru_cache(maxsize=None)
def _jax_step(jdtype):
    """JAX's DA + TA step on D's episode at JAX's draws (compiled as
    written in bfloat16): (loss, gradients, variables, the draws), once a
    dtype for both tests."""
    raw = distractor_episode(8)
    key = jax.random.PRNGKey(3)
    draws = distractor_draws(jax.random.split(key)[0], raw)
    jcfg = JaxConfig.from_dict(dict(STEP_CFG, compute_dtype="float32"))
    variables = _scaled(to_numpy(jax_init_model(
        jax_build_model(jcfg), jcfg, jax.random.PRNGKey(1))))
    jcfg = JaxConfig.from_dict(dict(STEP_CFG, compute_dtype=jdtype))
    jmodel = jax_build_model(jcfg)
    assert jmodel.trunk_stem == "s2d"
    tx = _capture_grads()
    state = TrainState.create(jax.tree_util.tree_map(np.array, variables),
                              tx)
    run = jax_train_step(jmodel, jcfg, tx=tx)
    state, metrics = (_as_written(run, state, raw, key)
                      if jdtype == "bfloat16" else run(state, raw, key))
    return metrics["loss"], state.opt_state, variables, raw, draws


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_s2d_step_matches_jax(dtype):
    """One DA + TA ANPDistractor step with ``trunk_stem=s2d`` at JAX's
    draws: the loss and every parameter's gradient within the float32
    tolerances, or in bfloat16 within the bfloat16 rule."""
    want = {k: _jax_step(k)[:2] for k in dict.fromkeys([dtype, "float32"])}
    variables, raw, (da, ta) = _jax_step("float32")[2:]
    pcfg = Config.from_dict(dict(STEP_CFG, compute_dtype=dtype))
    model = load_jax_variables(build_model(pcfg), variables)
    step = build_train_step(model, torch.optim.SGD(model.parameters(), lr=0.0),
                            pcfg)
    loss = step({k: t(v) for k, v in raw.items()}, ta_idx=ta, da_params=da)
    grads = {k: jax_grads_as_port(model, g, variables)
             for k, (_, g) in want.items()}
    if dtype == "float32":
        np.testing.assert_allclose(float(loss), float(want[dtype][0]),
                                   rtol=RTOL, atol=ATOL)
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(),
                                       grads[dtype][name].numpy(),
                                       err_msg=name, **GRAD_TOL)
        return
    assert_bf16_close(loss, want["bfloat16"][0], want["float32"][0], "loss",
                      nearer=False)
    assert_nearer_overall([assert_bf16_close(
        p.grad, grads["bfloat16"][name], grads["float32"][name], name,
        nearer=False) for name, p in model.named_parameters()], "gradients")
