"""LargeCNP in ``compute_dtype: bfloat16`` (the Distractor and ShapeNet3D
families) in the port against the JAX package, on the CPU.

Each module that holds a kernel on these paths, through its plain twin
(what a CPU tensor takes): the ResNet trunk (cuDNN's convolutions on the
card) at 64 x 64 x 3 and 128 x 128 x 1 for every ``img_agg``, the FAVOR+
core at LargeCNP's width with more than 64 rows an item (K2's wide form),
and image DA's programs 4-7 (K6) with JAX's draws replayed as
``DAParams``; then LargeCNP's forward for CondNeuralProcess (baco), ANP,
CNPDistractor (max) and ANPDistractor, Distractor's inversion, ShapeNet3D's
compositing on bfloat16 backgrounds, one training step of the S5, D5 and
S6 configurations, the fused call against single steps, and the shipped
YAMLs. Inputs come from numpy seeds; every comparison runs the JAX
function in bfloat16 and in float32 on the same inputs.

Tolerance: the bfloat16 rule of ``tests/test_torch_port_bf16.py``
(``assert_bf16_close``, its reasons stated there):

    max|port_bf16 - jax_bf16| <= 2 max|jax_bf16 - jax_f32| + 2^-7 max|jax_f32|

per tensor, and the port nearer jax_bf16 than jax_f32 in the mean: tensor
by tensor for module outputs and losses, summed over a step's gradients
(``assert_nearer_overall``: XLA on the CPU sums bfloat16 cotangents with
bfloat16 partial sums). S6's step holds its near-zero gradients (below
``NEAR_ZERO`` of the step's largest: FAVOR+'s query projections, whose
float32 values are rounding noise) against the port's step in float64
instead: at most twice the larger of JAX bfloat16's and JAX float32's
distance from it. The jitted references are compiled without excess
precision (``_as_written``), so that they round where their code rounds.
Bit for bit, with no tolerance: the masks of K6's programs 4-7 (every other
op off, JAX's dropout draws), Distractor's 1 - x / 255 in bfloat16 (two
roundings), the bfloat16 split and its compositing, and the fused call
against single steps. The FAVOR+ twin at R = 100 in float32: rtol and atol
1e-5, as the float32 parity tests.
"""

import glob
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_aug import _jax_drop
from test_torch_port_bf16 import (_as_written, _capture_grads, _f32,
                                  _same_dtype, assert_bf16_close,
                                  assert_nearer_overall)
from test_torch_port_distractor import _raw_episode as distractor_episode
from test_torch_port_distractor import (jax_distractor_fixed_params,
                                        jax_distractor_params, key_for_order)
from test_torch_port_distractor import jax_process_draws as distractor_draws
from test_torch_port_fixed_order import _drop_fixed
from test_torch_port_shapenet3d import _quats, _rgba
from test_torch_port_shapenet3d import _raw_episode as s3d_episode
from test_torch_port_shapenet3d import (jax_rgb_fixed_params, jax_rgb_params,
                                        key_for_rgb_order)
from test_torch_port_shapenet3d import jax_process_draws as s3d_draws
from torch_port_common import (ATOL, GRAD_TOL, RTOL, jax_grads_as_port, t,
                               to_numpy)
from wmfml_tpu.aug import image_aug as jaug
from wmfml_tpu.aug.pipeline import build_episode_processor as jax_processor
from wmfml_tpu.configs import Config as JaxConfig
from wmfml_tpu.data.device_sampler import DeviceEpisodeSampler as JaxSampler
from wmfml_tpu.models.neural_process import LargeCNP as JaxLargeCNP
from wmfml_tpu.models.registry import build_model as jax_build_model
from wmfml_tpu.nn.attention import favor_attention as jax_favor
from wmfml_tpu.nn.encoders import ResNetTrunk as JaxTrunk
from wmfml_tpu.train.state import TrainState
from wmfml_tpu.train.steps import build_train_step as jax_train_step
from wmfml_tpu.train.steps import init_model as jax_init_model
from wmfml_tpu_torch.aug import image_aug as paug
from wmfml_tpu_torch.aug.pipeline import build_episode_processor
from wmfml_tpu_torch.ckpt.jax_params import load_jax_variables, trunk_state_dict
from wmfml_tpu_torch.configs import Config
from wmfml_tpu_torch.data.device_sampler import DeviceEpisodeSampler
from wmfml_tpu_torch.kernels.favor import favor_plain
from wmfml_tpu_torch.models.neural_process import LargeCNP
from wmfml_tpu_torch.models.registry import build_model
from wmfml_tpu_torch.nn.encoders import ResNetTrunk
from wmfml_tpu_torch.ops.cast import set_compute_dtype
from wmfml_tpu_torch.train.state import build_optimizer
from wmfml_tpu_torch.train.steps import (build_device_data_train_step,
                                         build_eval_step, build_train_step)
from torch_port_common import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16, F32 = jnp.bfloat16, jnp.float32
PBF16 = torch.bfloat16


def _scaled(variables):
    """Variables with every trunk's first convolution x 3 (the 1-channel
    trunks' features are O(1) then)."""
    v = jax.tree_util.tree_map(np.array, variables)
    for node in (v["params"].get("img_encoder"),
                 v["params"].get("decoder", {}).get("trunk"), v["params"]):
        if node is not None and "conv1" in node:
            node["conv1"]["kernel"] *= 3.0
    return v


def _bits_equal(got: torch.Tensor, want) -> bool:
    w = torch.from_numpy(np.asarray(jnp.asarray(want).astype(F32)))
    return (got.dtype == PBF16 and str(jnp.asarray(want).dtype) == "bfloat16"
            and torch.equal(got.float(), w))


# -- the ResNet trunk ---------------------------------------------------------

@pytest.mark.parametrize("img_agg", ["mean", "max", "baco", "reshape"])
@pytest.mark.parametrize("hw,c", [(64, 3), (128, 1)], ids=["rgb64", "gray128"])
def test_resnet_trunk_matches_jax_in_bf16(hw, c, img_agg):
    """Every convolution through ``ops/cast.py:conv2d`` (conv1 with its
    bias, the blocks' bias-free), the residual adds and ReLUs, the pooling
    and the flatten (CHW here, HWC in JAX) in bfloat16."""
    x = np.random.RandomState(2).rand(3, hw, hw, c).astype(np.float32)
    variables = to_numpy(JaxTrunk(img_agg=img_agg).init(
        jax.random.PRNGKey(0), x))
    if c == 1:
        variables = _scaled(variables)
    xb = jnp.asarray(x, BF16)
    want = {dt: jax.jit(lambda v, a, dt=dt: JaxTrunk(
        img_agg=img_agg, dtype=dt).apply(v, a)) for dt in (BF16, None)}
    want_bf16 = _as_written(want[BF16], variables, xb)
    want_f32 = want[None](variables, xb.astype(F32))
    trunk = ResNetTrunk(img_agg, c)
    trunk.load_state_dict(trunk_state_dict(variables["params"]), strict=True)
    set_compute_dtype(trunk, PBF16)
    with torch.no_grad():
        got = trunk(t(np.asarray(xb.astype(F32))).to(PBF16))
    _same_dtype(got, want_bf16)
    if img_agg != "mean":
        side = 2 if img_agg in ("max", "baco") else hw // 32
        want_bf16, want_f32 = (np.asarray(w.astype(F32)).reshape(
            3, side, side, 64).transpose(0, 3, 1, 2).reshape(3, -1)
            for w in (want_bf16, want_f32))
    assert np.abs(np.asarray(want_f32)).max() > 0.1
    assert_bf16_close(got, want_bf16, want_f32, f"trunk {img_agg}")


# -- LargeCNP's forward -----------------------------------------------------------

# method -> (task, agg_mode, img_agg, the JAX model's keywords)
LARGE = {"CondNeuralProcess": ("shapenet_3d", "baco", "reshape",
                               dict(y_dim=4)),
         "ANP": ("shapenet_3d", "attention", "reshape", dict(y_dim=4)),
         "CNPDistractor": ("distractor", "max", "max",
                           dict(y_dim=2, label_embed_dim=16)),
         "ANPDistractor": ("distractor", "attention", "max",
                           dict(y_dim=2, label_embed_dim=16))}


def _model_inputs(task, seed):
    """Model-facing float32 inputs: Distractor's inverted images, ShapeNet3D's
    RGB without its alpha."""
    if task == "distractor":
        raw = distractor_episode(seed)
        cx, qx = (1.0 - raw[k] / np.float32(255.0) for k in ("ctx_x", "qry_x"))
    else:
        raw = s3d_episode(seed)
        cx, qx = raw["ctx_x"][..., :3], raw["qry_x"][..., :3]
    return (cx.astype(np.float32), raw["ctx_y"], qx.astype(np.float32),
            raw["ctx_mask"])


@pytest.mark.parametrize("method", list(LARGE))
def test_large_cnp_forward_matches_jax_in_bf16(method):
    """The JAX registry passes ``dtype`` to every LargeCNP; the port's
    ``set_compute_dtype`` reaches both trunks, the label embedding, the task
    encoder, baco's heads, the attention projections, ``mu`` and the
    decoder: mu and the latent bfloat16, as JAX's."""
    task, agg_mode, img_agg, kw = LARGE[method]
    cx, cy, qx, mask = _model_inputs(task, 3)
    jm = {dt: JaxLargeCNP(img_agg=img_agg, agg_mode=agg_mode, dtype=dt, **kw)
          for dt in (BF16, None)}
    variables = _scaled(to_numpy(jm[None].init(
        jax.random.PRNGKey(0), cx, cy, qx, ctx_mask=mask)))
    cxb, qxb = (jnp.asarray(a, BF16) for a in (cx, qx))
    apply = {dt: jax.jit(lambda v, a, b, dt=dt: jm[dt].apply(
        v, a, cy, b, ctx_mask=mask)) for dt in (BF16, None)}
    want_bf16 = _as_written(apply[BF16], variables, cxb, qxb)
    want_f32 = apply[None](variables, cxb.astype(F32), qxb.astype(F32))
    h, w, c = cx.shape[2:]
    pm = LargeCNP(img_agg=img_agg, agg_mode=agg_mode, label_dim=cy.shape[-1],
                  img_size=(h, w, c), **kw,
                  generator=torch.Generator().manual_seed(0))
    pm = set_compute_dtype(load_jax_variables(pm, variables), PBF16)
    with torch.no_grad():
        got = pm(t(cx).to(PBF16), t(cy), t(qx).to(PBF16), ctx_mask=t(mask))
    _same_dtype(got.mu, want_bf16.mu)
    assert np.abs(np.asarray(want_f32.mu)).max() > 0.1
    assert_bf16_close(got.mu, want_bf16.mu, want_f32.mu, "mu")
    assert_bf16_close(got.extras["sample_features"],
                      want_bf16.extras["sample_features"],
                      want_f32.extras["sample_features"], "latent")


# -- K2's wide form: more than 64 rows an item -------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_favor_twin_matches_jax_at_100_rows_an_item(dtype):
    """Nq 50, Nk 50, d = e = 256, m = 1419 (K2 wide's row groups and
    phase-2 chunks run more than once): the twin the kernel is held
    against equals JAX's masked FAVOR+, where the JAX package has no row
    limit; a task with one real row."""
    rng = np.random.RandomState(8)
    q, k, v = (rng.randn(2, 2, 50, 256).astype(np.float32) for _ in range(3))
    proj = rng.randn(1419, 256).astype(np.float32)
    mask = np.arange(50)[None, :] < np.array([[37], [1]])
    if dtype == "float32":
        want = jax_favor(q, k, v, proj, mask[:, None, :])
        got = favor_plain(t(q), t(k), t(v), t(proj), t(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
        return
    qb, kb, vb = (jnp.asarray(a, BF16) for a in (q, k, v))
    want_bf16 = jax_favor(qb, kb, vb, proj, mask[:, None, :])
    want_f32 = jax_favor(*(a.astype(F32) for a in (qb, kb, vb)), proj,
                         mask[:, None, :])
    got = favor_plain(*(t(np.asarray(a.astype(F32))).to(PBF16)
                        for a in (qb, kb, vb)), t(proj), t(mask))
    _same_dtype(got, want_bf16)
    assert_bf16_close(got, want_bf16, want_f32, "favor R100")


# -- K6's programs 4-7 in bfloat16 ---------------------------------------------

def _da_input(program, b, hw):
    """(what the port's augmenter takes, JAX's bfloat16 and float32 images
    for the same pixels): Distractor's uint8 images and JAX's 1.0 -
    x.astype(dtype) / 255.0; ShapeNet3D's RGB channels of bfloat16 RGBA."""
    if program.startswith("distractor"):
        img = np.random.RandomState(b).randint(0, 256, (2, b // 2, hw, hw, 1)
                                               ).astype(np.uint8)
        return t(img), *(1.0 - jnp.asarray(img, dt) / 255.0
                         for dt in (BF16, F32))
    x = jnp.asarray(_rgba(b, (2, b // 2))[..., :3], BF16)
    return t(np.asarray(x.astype(F32))).to(PBF16), x, x.astype(F32)


PROGRAM_CASES = [("distractor", 0), ("distractor", 1),
                 ("distractor_fixed", None), ("shapenet_3d", 0),
                 ("shapenet_3d", 719), ("shapenet_3d_fixed", None)]


@pytest.mark.parametrize("program,order", PROGRAM_CASES)
def test_programs_4_to_7_match_jax_in_bf16(program, order):
    """Each program's twin in bfloat16 against the JAX augmenter on its
    bfloat16 images (Distractor: 128 x 128 x 1; ShapeNet3D: 64 x 64 RGB),
    JAX's draws injected; each op rounds where the JAX op returns
    ``img.dtype``."""
    task = "distractor" if program.startswith("distractor") else "shapenet_3d"
    hw = 32 if task == "distractor" else 64
    b = 6
    x, xb, xf = _da_input(program, b, hw)
    fixed = order is None
    if task == "distractor":
        key = jax.random.PRNGKey(11) if fixed else key_for_order(order)
        draw = jax_distractor_fixed_params if fixed else jax_distractor_params
    else:
        key = jax.random.PRNGKey(12) if fixed else key_for_rgb_order(order)
        draw = jax_rgb_fixed_params if fixed else jax_rgb_params
    params = draw(key, b, hw, hw)
    assert params.order == order
    aug = jax.jit(jaug.build_augmenter(task, random_order=not fixed))
    want_bf16 = _as_written(aug, key, xb)
    want_f32 = aug(key, xf)
    got = paug.Augmenter(PBF16, program)(x, params=params)
    _same_dtype(got, want_bf16)
    assert not np.array_equal(np.asarray(want_bf16.astype(F32)),
                              np.asarray(xb.astype(F32)))
    assert_bf16_close(got, want_bf16, want_f32, program)


@pytest.mark.parametrize("program", ["distractor", "distractor_fixed",
                                     "shapenet_3d", "shapenet_3d_fixed"])
def test_programs_4_to_7_masks_equal_jax_bit_for_bit_in_bf16(program):
    """Every op off but the dropout op, at JAX's own dropout draws (gate,
    Dropout or CoarseDropout, rate, size, per channel, key words; the fixed
    grid's cells): the twin's bfloat16 output equals JAX's
    ``sometimes(one_of_dropout)`` (or its fixed-grid form) on the same
    bfloat16 images, bit for bit."""
    task = "distractor" if program.startswith("distractor") else "shapenet_3d"
    hw, b = (32, 8) if task == "distractor" else (64, 8)
    x, xb, _ = _da_input(program, b, hw)
    flat = xb.reshape((b,) + xb.shape[2:])
    keys = jax.random.split(jax.random.PRNGKey(28), b)
    fixed = program.endswith("_fixed")
    warp = np.zeros((b, 2, 7), np.float32)
    warp[:, 0, :2] = 1.0            # program 7's geometric: the identity
    warp[:, 0, 6] = float(program == "shapenet_3d_fixed")
    if fixed:
        gh, gw = paug.fixed_grid(hw, hw)
        draws = [_drop_fixed(k, gh, gw) for k in keys]
        drop, words, cells = (np.stack([np.asarray(d[i]) for d in draws])
                              for i in range(3))
        want = jax.vmap(jaug.sometimes(jaug.one_of_dropout_fixed))(keys, flat)
    else:
        drop, words = (np.asarray(a) for a in jax.vmap(_jax_drop)(keys))
        cells = None
        want = jax.vmap(jaug.sometimes(jaug.one_of_dropout))(keys, flat)
    pixel = torch.zeros((b, 6)) if task == "shapenet_3d" else None
    params = paug.DAParams(None if fixed else 0, t(warp), t(drop),
                           t(words.astype(np.uint32).view(np.int32)),
                           pixel=pixel,
                           cells=None if cells is None else t(cells))
    got = paug.Augmenter(PBF16, program)(x, params=params)
    want = want.reshape(xb.shape)
    assert _bits_equal(got, want)
    dropped = (got == 0) & (torch.from_numpy(np.asarray(xb.astype(F32))) != 0)
    assert bool(dropped.any()) and bool((got != 0).any())


def test_distractor_inversion_in_bf16_is_jaxs_bit_for_bit():
    """1.0 - x.astype(bf16) / 255.0: the quotient rounds to bfloat16, then
    the difference rounds again (two roundings, which one rounding of the
    float32 1 - x / 255 misses for some of the 256 values); in evaluation
    (the processor's cast) and as programs 4 and 5 start (``program_input``,
    which K6's inverted quotient table holds)."""
    raw = distractor_episode(4)
    want = jax_processor("distractor", [], train=False, compute_dtype=BF16)(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in raw.items()})
    got = build_episode_processor("distractor", [], train=False,
                                  dtype=PBF16)({k: t(v) for k, v in raw.items()})
    for k in ("ctx_x", "qry_x"):
        assert _bits_equal(got[k], want[k]), k
    every = torch.arange(256, dtype=torch.uint8).reshape(1, 16, 16, 1)
    table = paug.program_input("distractor", every, PBF16)
    want = 1.0 - jnp.asarray(every.numpy(), BF16) / 255.0
    assert _bits_equal(table, want)
    once = (1.0 - paug.to_unit(every)).to(PBF16)
    assert not torch.equal(table, once)


def test_bf16_split_and_compositing_are_jaxs_bit_for_bit():
    """Under bfloat16 compute the sampler keeps the float split and the
    backgrounds in bfloat16 as the JAX sampler does (``store_dtype``), and
    composites each batch on them at JAX's background indices bit for
    bit; a uint8 split stays uint8."""
    x = _rgba(5, (3, 8))
    y = _quats(5, (3, 8))
    bg = np.random.RandomState(6).rand(5, 64, 64, 3).astype(np.float32)
    cfg = Config.from_dict(dict(
        method="CondNeuralProcess", task="shapenet_3d", agg_mode="baco",
        img_agg="reshape", tasks_per_batch=2, max_ctx_num=3, query_num=3,
        lr=1e-4, seed=0, device="cpu", compute_dtype="bfloat16"))

    class Data:
        task_name, x_train, y_train, bg_imgs = "shapenet_3d", x, y, bg

    sampler = DeviceEpisodeSampler.from_dataset(Data, cfg, "cpu")
    jsampler = JaxSampler("shapenet_3d", x, y, 3, 3, 1, bg_images=bg,
                          gen_bg=True, store_dtype=BF16)
    assert _bits_equal(sampler.x, jsampler.x)
    assert _bits_equal(sampler.bg, jsampler.bg)
    key = jax.random.PRNGKey(3)
    images = jsampler.x[:2, :5]
    want = jsampler._composite(key, images, jsampler.bg)
    idx = np.asarray(jax.random.randint(key, (2, 5), 0, 5))
    got = sampler.composite(sampler.x[:2, :5], t(idx))
    assert _bits_equal(got, want)
    ep = sampler.sample(2, torch.Generator().manual_seed(0))
    assert ep["ctx_x"].dtype == PBF16 and ep["ctx_y"].dtype == torch.float32
    gray = DeviceEpisodeSampler(np.zeros((2, 8, 4, 4, 1), np.uint8), y[:2],
                                3, 3, 1, 1.0, "cpu", store_dtype=PBF16)
    assert gray.x.dtype == torch.uint8


# -- the slice: one step of S5's and D5's configurations, the fused call -------

# the S5 (the ShapeNet3D perf YAML), D5 (ANPDistractor) and S6 (ANP
# ShapeNet3D) configurations at T = 2, 3 context rows, 3 queries
STEP_CFGS = {
    "S5": dict(method="CondNeuralProcess", task="shapenet_3d",
               agg_mode="baco", img_agg="reshape"),
    "D5": dict(method="ANPDistractor", task="distractor",
               agg_mode="attention", img_agg="max", dim_w=16),
    "S6": dict(method="ANP", task="shapenet_3d", agg_mode="attention",
               img_agg="reshape")}
# S6's query projections (_W_q, and _W_k) take gradients of 1e-16 to 1e-10
# against the decoder's 14: FAVOR+'s per-row query factors cancel in the
# normaliser, and what is left is float32 rounding of the cancelling terms.
# Every computation of them lies about as far from float64 as they are
# large, JAX's own float32 step included, so the bfloat16 rule, which
# reads jax_bf16 - jax_f32, measures noise there. A tensor whose largest
# float32 gradient (JAX's) lies below NEAR_ZERO times the step's largest is
# held against the step in float64 instead: the port's distance from it at
# most twice the larger of JAX bfloat16's and JAX float32's.
F64_PATHS = ("S6",)
NEAR_ZERO = 1e-6


def _step_cfg(path, **extra):
    cfg = dict(STEP_CFGS[path], aug_list=["data_aug", "task_aug"],
               tasks_per_batch=2, max_ctx_num=3, query_num=3, lr=1e-4,
               seed=0, loss_type="mse", optimizer="SGD", device="cpu")
    cfg.update(extra)
    return cfg


@pytest.mark.parametrize("path", list(STEP_CFGS))
def test_one_step_matches_jax_in_bf16(path):
    """One DA + TA step at JAX's draws, JAX's step compiled as written:
    every parameter's gradient (both rules, the second over the step) and
    the loss (float32, on mu.float()) within the first rule. The loss keeps
    only the first, as MAML's validation loss does in
    ``test_torch_port_bf16.py``: LargeCNP's losses shrink bfloat16's effect
    on mu (Distractor's pixel distance is dominated by the labels, of order
    60; ShapeNet3D's quaternion loss normalises a small mu), so which
    reference one scalar lies nearer is the draw of sums taken in another
    order, where mu itself lies nearer jax_bf16
    (``test_large_cnp_forward_matches_jax_in_bf16``). On S6 every gradient
    is also held against the step in float64 (JAX float32's within
    ``GRAD_TOL`` of it), and its near-zero ones (``NEAR_ZERO``) by that
    rule in place of the first."""
    cfg = _step_cfg(path)
    s3d = cfg["task"] == "shapenet_3d"
    raw = s3d_episode(8) if s3d else distractor_episode(8)
    key = jax.random.PRNGKey(3)
    da, ta = (s3d_draws if s3d else distractor_draws)(
        jax.random.split(key)[0], raw)
    want, variables = {}, None
    for dtype in ("bfloat16", "float32"):
        jcfg = JaxConfig.from_dict(dict(cfg, compute_dtype=dtype))
        jmodel = jax_build_model(jcfg)
        if variables is None:
            variables = _scaled(to_numpy(jax_init_model(
                jmodel, jcfg, jax.random.PRNGKey(1))))
        tx = _capture_grads()
        state = TrainState.create(
            jax.tree_util.tree_map(np.array, variables), tx)
        state, metrics = _as_written(jax_train_step(jmodel, jcfg, tx=tx),
                                     state, raw, key)
        want[dtype] = (metrics["loss"], state.opt_state)
    pcfg = Config.from_dict(dict(cfg, compute_dtype="bfloat16"))
    model = load_jax_variables(build_model(pcfg), variables)
    step = build_train_step(model, torch.optim.SGD(model.parameters(), lr=0.0),
                            pcfg)
    loss = step({k: t(v) for k, v in raw.items()}, ta_idx=ta, da_params=da)
    _same_dtype(loss, want["bfloat16"][0])
    assert_bf16_close(loss, want["bfloat16"][0], want["float32"][0], "loss",
                      nearer=False)
    grads = {k: jax_grads_as_port(model, g, variables)
             for k, (_, g) in want.items()}
    f64 = (_float64_grads(cfg, variables, raw, ta, da) if path in F64_PATHS
           else {})
    largest = max(np.abs(g).max() for g in grads["float32"].values())
    distances = []
    for name, p in model.named_parameters():
        wb, wf = grads["bfloat16"][name], grads["float32"][name]
        if f64:
            np.testing.assert_allclose(f64[name], np.asarray(wf, np.float64),
                                       err_msg=name, **GRAD_TOL)
        if not (f64 and np.abs(wf).max() < NEAR_ZERO * largest):
            distances.append(assert_bf16_close(p.grad, wb, wf, name,
                                               nearer=False))
            continue
        g, wb, wf = _f32(p.grad), _f32(wb), _f32(wf)
        port, jb, jf = (np.abs(a.astype(np.float64) - f64[name]).max()
                        for a in (g, wb, wf))
        assert port <= 2 * max(jb, jf), (
            f"{name}: port {port}, jax_bf16 {jb}, jax_f32 {jf} from float64")
        distances.append((np.abs(g - wb).mean(), np.abs(g - wf).mean(),
                          np.abs(wb - wf).mean()))
    assert_nearer_overall(distances, "gradients")


def _float64_grads(cfg, variables, raw, ta, da):
    """The step's parameter gradients with the port's model, its inputs and
    its compute in float64 (the task loss still on mu.float(), as in every
    precision), as numpy float64."""
    pcfg = Config.from_dict(dict(cfg, compute_dtype="float32"))
    model = load_jax_variables(build_model(pcfg), variables).double()
    set_compute_dtype(model, torch.float64)
    step = build_train_step(model, torch.optim.SGD(model.parameters(), lr=0.0),
                            pcfg)
    batch = {k: t(v) for k, v in raw.items()}
    step({k: v.double() if v.dtype == torch.float32 else v
          for k, v in batch.items()}, ta_idx=ta, da_params=da)
    return {name: p.grad.numpy() for name, p in model.named_parameters()}


def _split_data(path):
    """A small dense train split for the path: ShapeNet3D's float RGBA with
    its backgrounds, or Distractor's uint8 views with pixel-centre
    labels."""
    rng = np.random.RandomState(1)

    class Data:
        task_name = STEP_CFGS[path]["task"]
        if task_name == "shapenet_3d":
            x_train, y_train = _rgba(2, (3, 8)), _quats(2, (3, 8))
            bg_imgs = rng.rand(5, 64, 64, 3).astype(np.float32)
        else:
            x_train = rng.randint(0, 256, (3, 8, 128, 128, 1)).astype(np.uint8)
            y_train = rng.uniform(24, 104, (3, 8, 2)).astype(np.float32)

    return Data


@pytest.mark.parametrize("path", list(STEP_CFGS))
def test_fused_call_equals_single_steps_in_bf16(path):
    """The fused call (episodes drawn by the device sampler, composited on
    bfloat16 backgrounds for S5, K6's program in bfloat16 twice a step, the
    bfloat16 model) on the CPU: one call of 3 steps equals 3 single steps
    from the same generator state, losses, weights and generator bit for
    bit; every image the trunks see is bfloat16."""
    cfg = Config.from_dict(_step_cfg(path, compute_dtype="bfloat16",
                                     optimizer="Adam"))
    data = _split_data(path)
    models = [build_model(cfg) for _ in range(2)]
    seen = set()
    for trunk in (models[0].img_encoder, models[0].decoder):
        trunk.register_forward_pre_hook(
            lambda m, args: seen.add(args[0].dtype))
    opts = [build_optimizer(cfg, m.parameters()) for m in models]
    sampler = DeviceEpisodeSampler.from_dataset(data, cfg, "cpu")
    fused = build_device_data_train_step(models[0], opts[0], cfg, sampler, 3)
    step = build_train_step(models[1], opts[1], cfg)
    gens = [torch.Generator().manual_seed(5) for _ in range(2)]
    got = fused(gens[0])
    losses = [step(sampler.sample(2, gens[1]), gens[1]) for _ in range(3)]
    assert torch.equal(got["loss"], torch.stack(losses).mean())
    assert torch.equal(gens[0].get_state(), gens[1].get_state())
    for a, b in zip(models[0].parameters(), models[1].parameters()):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    assert seen == {PBF16}


def test_validation_batches_reach_the_trunks_in_bf16():
    """A validation episode from the host splits (ShapeNet3D's float32 RGBA,
    Distractor's uint8) goes through the evaluation processor's cast: no
    float32 image reaches a bfloat16 trunk."""
    for path in STEP_CFGS:
        cfg = Config.from_dict(_step_cfg(path, compute_dtype="bfloat16"))
        model = build_model(cfg)
        seen = set()
        for trunk in (model.img_encoder, model.decoder):
            trunk.register_forward_pre_hook(
                lambda m, args: seen.add(args[0].dtype))
        s3d = cfg.task == "shapenet_3d"
        raw = s3d_episode(2) if s3d else distractor_episode(2)
        loss = build_eval_step(model, cfg)({k: t(v) for k, v in raw.items()})
        assert loss.dtype == torch.float32 and bool(torch.isfinite(loss))
        assert seen == {PBF16}, (path, seen)


# -- the shipped YAMLs ------------------------------------------------------------

def test_shipped_yamls_build_or_name_their_roadmap_item():
    """``Config`` + ``build_model`` on ``device=cpu`` over every shipped YAML:
    all 63 build, the ShapeNet3D perf YAML (bfloat16), the 14 MR and FCL
    YAMLs (A13), the 5 SingleTask and refinement YAMLs (A14) and MMAML's
    (A16) among them, and none raises naming a ROADMAP item (the test's
    name is from when MMAML's did). The A14 models run one forward at their
    YAMLs' image sizes."""
    paths = sorted(glob.glob(os.path.join(REPO, "cfg", "**", "*.yaml"),
                             recursive=True))
    built, raised, single_task = [], {}, 0
    for path in paths:
        try:
            cfg = Config(path, ["device=cpu"], make_dirs=False)
            model = build_model(cfg)
            built.append(os.path.relpath(path, REPO))
        except NotImplementedError as e:
            item = re.search(r"ROADMAP\.md (A\d+)", str(e))
            assert item, (path, str(e))
            raised[item.group(1)] = raised.get(item.group(1), 0) + 1
            continue
        if cfg.method.startswith("SingleTask"):
            single_task += 1
            h, w, c = cfg.img_size
            qry = torch.rand(1, 2, h, w, c - (cfg.task == "shapenet_3d"))
            with torch.no_grad():
                mu = model(None, None, qry).mu
            assert tuple(mu.shape) == (1, 2, cfg.output_dim), path
            assert bool(torch.isfinite(mu).all()), path
    assert len(paths) == 63
    assert len(built) == 63, built
    assert raised == {}
    assert os.path.join("cfg", "train",
                        "MMAML_ShapeNet1D_DA+TA.yaml") in built
    assert single_task == 5
    assert os.path.join("cfg", "train", "perf",
                        "CondNeuralProcess_DA+TA_ShapeNet3D_tpu.yaml") in built
