"""The port's Pascal1D slice against the JAX package, on the CPU.

The synthetic generator (its pickles byte for byte), the host sampler (its
episodes draw for draw, the fixed shot, no test split), the device
sampler's Pascal branch, the episode processor (task augmentation's
offsets fed in as ``ta_idx``, labels x 10 in training and evaluation), the
twins of GammaContrast and AverageBlur and the five-op random-order chain
(K6's ``pascal_1d`` program, JAX's draws replayed as ``DAParams``) in
float32 and bfloat16, one ANPVanillaPascal1D training step and one
second-order VanillaMAML outer step with weights carried by
``load_jax_variables``, the shipped Pascal1D YAMLs building CPU trainers,
the fused K-step call against K single steps and the evaluation CLI.

Tolerances: float32 rtol/atol 1e-5 (``torch_port_common``; sums of the same
nonnegative terms in another order, and ``pow`` of two libraries); the
generator and the sampler bit for bit; bfloat16 by the rule of
``test_torch_port_bf16.py`` (max|port - jax_bf16| <= 2 max|jax_bf16 -
jax_f32| + 2^-7 max|jax_f32|, the port nearer jax_bf16 than jax_f32 in the
mean), the JAX references compiled with ``xla_allow_excess_precision``
off so that they round where their code rounds; the MAML gradients as
``test_torch_port_maml.py``.
"""

import itertools
import os
import pickle
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_aug import _jax_drop
from test_torch_port_bf16 import _as_written, assert_bf16_close
from test_torch_port_maml import MAML_GRAD_ATOL
from test_torch_port_maml import _pair as maml_pair
from torch_port_common import (ATOL, GRAD_TOL, RTOL, WIDTHS,
                               jax_grads_as_port, t, to_numpy)
from wmfml_tpu.aug import image_aug as jaug
from wmfml_tpu.aug.pipeline import _to_float as jax_to_float
from wmfml_tpu.aug.pipeline import build_episode_processor as jax_processor
from wmfml_tpu.configs import Config as JaxConfig
from wmfml_tpu.data import synthetic as jsynth
from wmfml_tpu.data.pascal_1d import Pascal1D as JaxPascal1D
from wmfml_tpu.models.registry import build_model as jax_build_model
from wmfml_tpu.train.maml import build_maml_outer as jax_maml_outer
from wmfml_tpu.train.state import TrainState, build_optimizer as jax_optimizer
from wmfml_tpu.train.steps import build_train_step as jax_train_step
from wmfml_tpu.train.steps import init_model as jax_init_model
from wmfml_tpu_torch.aug import image_aug as paug
from wmfml_tpu_torch.aug.pipeline import build_episode_processor
from wmfml_tpu_torch.ckpt.jax_params import load_jax_variables, maml_state_dict
from wmfml_tpu_torch.cli import evaluation_cli, train_cli
from wmfml_tpu_torch.configs import Config
from wmfml_tpu_torch.data import synthetic as psynth
from wmfml_tpu_torch.data.device_sampler import DeviceEpisodeSampler
from wmfml_tpu_torch.data.factory import build_data
from wmfml_tpu_torch.data.pascal_1d import Pascal1D
from wmfml_tpu_torch.kernels import image_da as kda
from wmfml_tpu_torch.models.registry import build_model
from wmfml_tpu_torch.train.maml import build_maml_outer
from wmfml_tpu_torch.train.state import build_optimizer
from wmfml_tpu_torch.train.steps import (build_device_data_train_step,
                                         build_train_step)
from torch_port_common import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = os.path.join(REPO, "cfg", "train")
BF16, F32 = jnp.bfloat16, jnp.float32
# a small synthetic Pascal1D: 3 train and 2 validation classes of 31
# instances (the shipped YAMLs take 15 + 15)
SMALL = dict(train_classes=3, val_classes=2, instances=31)


def _close(got, want, err_msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=err_msg)


def _images(seed, shape):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(np.uint8)


# -- the JAX package's Pascal1D draws, replayed as the port's parameters ------------

def _warp_row(s, tr, cval, nearest, gate):
    f = jnp.float32
    return jnp.stack([s[0], s[1], tr[0], tr[1], cval,
                      jnp.float32(0) if nearest is None else nearest.astype(f),
                      gate.astype(f)])


def _pascal_op_draws(op, k, h, w):
    """What ``PASCAL_OPS[op]`` (a ``sometimes`` of it, :432-442) draws
    from one image's key."""
    kg, ko = jax.random.split(k)
    gate = jax.random.bernoulli(kg, 0.5)
    if op == paug.P_CROP:
        return _warp_row(*jaug._sample_crop_params(ko, h, w), gate)
    if op == paug.P_AFFINE:
        return _warp_row(*jaug._sample_affine_params(ko, h, w), gate)
    if op == paug.P_GAMMA:
        return jnp.stack([gate.astype(F32),
                          jax.random.uniform(ko, (), minval=0.5, maxval=2.0)])
    if op == paug.P_BLUR:
        return jnp.stack([gate.astype(F32),
                          jax.random.randint(ko, (), 1, 4).astype(F32)])
    raise ValueError(op)


def jax_pascal_params(key, b, h, w) -> paug.DAParams:
    """``build_augmenter("pascal_1d")``'s draws for ``b`` images from
    ``key`` (:569-577): the permutation, then the op at chain position s
    draws from per-image keys split from ``step_keys[s]``."""
    kperm, kops = jax.random.split(key)
    step_keys = jax.random.split(kops, 5)
    perm = tuple(int(v) for v in jax.random.permutation(kperm, 5))
    warp = np.zeros((b, 2, 7), np.float32)
    pixel = np.zeros((b, 4), np.float32)
    drop, words = np.zeros((b, 5), np.float32), np.zeros((b, 2), np.uint32)
    for s, op in enumerate(perm):
        keys = jax.random.split(step_keys[s], b)
        if op == paug.P_DROP:
            d, km = jax.vmap(_jax_drop)(keys)
            drop[:], words[:] = np.asarray(d), np.asarray(km)
            continue
        rows = np.asarray(jax.vmap(lambda k: _pascal_op_draws(op, k, h, w))(
            keys))
        if op in (paug.P_CROP, paug.P_AFFINE):
            warp[:, int(op == paug.P_AFFINE)] = rows
        else:
            col = 0 if op == paug.P_GAMMA else 2
            pixel[:, col:col + 2] = rows
    return paug.DAParams(paug.PASCAL_ORDERS.index(perm), t(warp), t(drop),
                         t(words.view(np.int32)), pixel=t(pixel))


def key_for_pascal_order(order: int):
    want = paug.PASCAL_ORDERS[order]
    for seed in itertools.count():
        key = jax.random.PRNGKey(seed)
        perm = jax.random.permutation(jax.random.split(key)[0], 5)
        if tuple(int(v) for v in perm) == want:
            return key


def jax_pascal_process_draws(key, raw):
    """The DA parameters and TA offsets the Pascal1D ``process(key,
    batch)`` draws (``wmfml_tpu/aug/pipeline.py:48-56, 116-131``)."""
    k_aug, k_ta = jax.random.split(key)
    k1, k2 = jax.random.split(k_aug)
    hw = raw["ctx_x"].shape[2:4]
    da = tuple(jax_pascal_params(k, int(np.prod(raw[x].shape[:2])), *hw)
               for k, x in ((k1, "ctx_x"), (k2, "qry_x")))
    t_ = raw["ctx_y"].shape[0]
    ta = np.asarray(jax.random.randint(k_ta, (t_, 1, 1), 0, 4)).ravel()
    return da, t(ta)


# -- 1. data: the generator, the host sampler, the device sampler ----------------------

def test_generator_pickles_are_byte_identical_to_jax(tmp_path):
    assert psynth.GENERATORS["pascal_1d"][0] == jsynth.GENERATORS[
        "pascal_1d"][0] == "Pascal1D"
    for gen, name in ((jsynth.generate_pascal1d, "jax"),
                      (psynth.generate_pascal1d, "port")):
        gen(str(tmp_path / name), seed=5, **SMALL)
    for f in ("train_data_ins.pkl", "val_data_ins.pkl"):
        with open(tmp_path / "jax" / f, "rb") as a, \
                open(tmp_path / "port" / f, "rb") as b:
            assert a.read() == b.read(), f
    with open(tmp_path / "port" / "train_data_ins.pkl", "rb") as f:
        x, y = pickle.load(f)
    assert x.shape == (3, 31, 128, 128, 1) and x.dtype == np.uint8
    assert y.shape == (3, 31, 1) and 0 <= y.min() and y.max() < 1


@pytest.fixture(scope="module")
def pascal_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pascal"))
    psynth.generate_pascal1d(root, seed=5, **SMALL)
    return root


def test_sampler_draws_the_jax_episodes_and_has_no_test_split(pascal_dir):
    kw = dict(img_size=[128, 128, 1], seed=42, max_ctx=4)
    port, ref = Pascal1D(pascal_dir, **kw), JaxPascal1D(pascal_dir, **kw)
    assert port.query_num == 4                   # default: max_ctx
    for source, shot in (("train", 4), ("validation", 2), ("validation", 4)):
        got, want = port.get_batch(source, 3, shot), ref.get_batch(source, 3,
                                                                   shot)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["ctx_x"].shape == (3, 4, 128, 128, 1)
        assert got["qry_x"].shape == (3, 4, 128, 128, 1)
        assert got["ctx_mask"].sum(1).tolist() == [shot] * 3
        assert got["ctx_y"].max() < 1          # raw: scaled by the processor
    port.reset_eval("validation")
    ref.reset_eval("validation")
    np.testing.assert_array_equal(port.get_batch("validation", 2, 3)["qry_x"],
                                  ref.get_batch("validation", 2, 3)["qry_x"])
    port.reset_eval("test")                      # nothing to reset
    with pytest.raises(TypeError, match="no test split"):
        port.get_batch("test", 2, 3)


def test_factory_and_device_sampler_take_pascal(pascal_dir):
    cfg = Config(os.path.join(TRAIN, "ANP_DA+TA_Pascal1D.yaml"),
                 ["device=cpu", f"data_path={pascal_dir}", "max_ctx_num=4"],
                 make_dirs=False)
    data = build_data(cfg)
    assert isinstance(data, Pascal1D) and data.query_num == 4
    sampler = DeviceEpisodeSampler.from_dataset(data, cfg, "cpu")
    assert (sampler.shot_min, sampler.label_scale) == (4, 1.0)
    batch = sampler.sample(3, torch.Generator().manual_seed(0))
    assert bool(batch["ctx_mask"].all())           # the shot is fixed
    assert batch["ctx_x"].shape == batch["qry_x"].shape == (3, 4, 128, 128,
                                                            1)
    y = torch.cat([batch["ctx_y"], batch["qry_y"]], 1)
    assert float(y.min()) >= 0 and float(y.max()) < 1


# -- 2. the op order ---------------------------------------------------------------

def test_order_decode_is_itertools_permutations_and_the_kernels():
    """K6 decodes the drawn index into the order (``csrc/pixel_ops.cuh``);
    the twin decodes it the same way, which must be itertools' order."""
    perms = list(itertools.permutations(range(5)))
    assert [paug.decode_order(i, 5) for i in range(120)] == perms
    assert paug.PASCAL_ORDERS == tuple(perms)
    assert [paug.decode_order(i, 3) for i in range(6)] == list(paug.ORDERS)
    with open(os.path.join(REPO, "wmfml_tpu_torch", "csrc",
                           "image_da.cu")) as f:
        src = f.read()
    assert "((a.order[0] % 120) + 120) % 120" in src
    assert "da::decode_order(P->order, NPASCAL, P->perm);" in src
    ops = re.search(r"enum PascalOp \{(.*?)\};", src, re.S).group(1)
    names = re.findall(r"P_([A-Z]+) = (\d)", ops)
    assert [(n.lower(), int(i)) for n, i in names] == [
        ("crop", paug.P_CROP), ("gamma", paug.P_GAMMA), ("blur", paug.P_BLUR),
        ("affine", paug.P_AFFINE), ("drop", paug.P_DROP)]


def test_sampler_draws_orders_and_pixel_parameters_by_distribution():
    aug = paug.Augmenter(program="pascal_1d")
    gen = torch.Generator().manual_seed(0)
    u, keys, order = aug.sample(6000, gen, "cpu")
    assert u.shape == (6000, 23) and keys.shape == (6000, 2)
    assert order.shape == (1,) and 0 <= int(order) < 120
    px = paug.pixel_from_draw(u)
    for rate in (px[:, 0], px[:, 2]):
        assert abs(float(rate.mean()) - 0.5) < 0.03
    assert 0.5 <= float(px[:, 1].min()) and float(px[:, 1].max()) < 2.0
    counts = torch.bincount(px[:, 3].long(), minlength=4)[1:]
    assert int(counts.sum()) == 6000 and int((counts - 2000).abs().max()) < 150
    # the order: uniform over the 120 (2400 calls, each count 20 +- 20)
    orders = torch.cat([aug.sample(1, gen, "cpu")[2] for _ in range(2400)])
    counts = torch.bincount(orders, minlength=120)
    assert counts.shape == (120,) and int((counts - 20).abs().max()) < 20
    chi2 = float(((counts - 20.0) ** 2 / 20.0).sum())
    assert chi2 < 180                            # 119 dof: p ~ 3e-4


# -- 3. the pixel ops and the five-op chain ------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gamma_contrast_matches_jax(dtype):
    b, h, w = 6, 16, 20
    img = _images(0, (b, h, w, 1))
    img[0, :4] = 0                                 # black -> 1e-6 ** gamma
    keys = jax.random.split(jax.random.PRNGKey(3), b)
    gammas = jax.vmap(lambda k: jax.random.uniform(k, (), minval=0.5,
                                                   maxval=2.0))(keys)
    jdt = BF16 if dtype == "bfloat16" else F32
    x = jax_to_float(jnp.asarray(img), jdt)
    got = paug.gamma_contrast(paug.to_unit(t(img)).to(getattr(torch, dtype)),
                              t(np.asarray(gammas)))
    assert got.dtype == getattr(torch, dtype)
    want = jax.vmap(jaug.gamma_contrast)(keys, x)
    assert want.dtype == jdt
    if dtype == "float32":
        _close(got, want)
        assert float(got[0, 0, 0, 0]) == pytest.approx(
            1e-6 ** float(gammas[0]), rel=1e-5)
    else:
        want_f32 = jax.vmap(jaug.gamma_contrast)(keys, jax_to_float(
            jnp.asarray(img), F32))
        assert_bf16_close(got, want, want_f32, "gamma")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_average_blur_matches_jax(k, dtype):
    b, h, w = 3, 16, 12
    img = _images(k, (b, h, w, 1))
    jdt = BF16 if dtype == "bfloat16" else F32
    # a key whose draw is k for every image
    keys = next(ks for s in itertools.count()
                for ks in [jax.random.split(jax.random.PRNGKey(s), b)]
                if all(int(jax.random.randint(kk, (), 1, 4)) == k
                       for kk in ks))
    blur = jax.jit(jax.vmap(jaug.average_blur))
    want = _as_written(blur, keys, jax_to_float(jnp.asarray(img), jdt))
    got = paug.average_blur(paug.to_unit(t(img)).to(getattr(torch, dtype)),
                            torch.full((b,), float(k)))
    assert got.dtype == getattr(torch, dtype) and want.dtype == jdt
    if dtype == "float32" or k == 1:
        _close(got.float(), np.asarray(want.astype(F32)))
    else:
        want_f32 = blur(keys, jax_to_float(jnp.asarray(img), F32))
        assert_bf16_close(got, want, want_f32, f"blur k={k}")
    if k == 2 and dtype == "float32":   # the pixel, its top and left
                                        # neighbours; edge padding
        x = paug.to_unit(t(img)).double()
        mean = (x[0, 3, 5] + x[0, 2, 5] + x[0, 3, 4] + x[0, 2, 4]) / 4
        assert float(got[0, 3, 5]) == pytest.approx(float(mean), rel=1e-3)
        corner = float(x[0, 0, 0])
        assert float(got[0, 0, 0]) == pytest.approx(corner, rel=1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("order", [0, 119, 37, 90])
def test_five_op_chain_matches_jax(order, dtype):
    """uint8 images through the twin (x / 255, then the five ops one at a
    time in the drawn order) against ``_to_float``, then
    ``build_augmenter("pascal_1d")``, with JAX's draws injected. The
    identity order (0) and the reverse (119) included."""
    b, h, w = 6, 32, 32
    key = key_for_pascal_order(order)
    img = _images(order, (2, b // 2, h, w, 1))
    params = jax_pascal_params(key, b, h, w)
    assert params.order == order
    jdt = BF16 if dtype == "bfloat16" else F32
    aug = jax.jit(jaug.build_augmenter("pascal_1d"))
    want = _as_written(aug, key, jax_to_float(jnp.asarray(img), jdt))
    got = paug.Augmenter(getattr(torch, dtype), "pascal_1d")(t(img),
                                                         params=params)
    assert got.shape == img.shape and got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        _close(got, want)
    else:
        want_f32 = aug(key, jax_to_float(jnp.asarray(img), F32))
        assert_bf16_close(got, want, want_f32, f"order {order}")
    assert not np.allclose(np.asarray(want.astype(F32)), img / 255.0)


def test_cpu_image_da_runs_the_pascal_twin_and_counts_no_launch():
    gen = torch.Generator().manual_seed(4)
    x = torch.randint(0, 256, (2, 3, 16, 16, 1), dtype=torch.uint8,
                      generator=gen)
    aug = paug.Augmenter(program="pascal_1d")
    u, keys, order = aug.sample(6, gen, "cpu")
    before = dict(kda.image_da.program_launches)
    got = kda.image_da(x, u, keys, order, program="pascal_1d")
    assert kda.image_da.program_launches == before
    p = paug.params_for("pascal_1d", u, keys, order, 16, 16)
    assert p.pixel.shape == (6, 4) and paug.params_row(p).shape == (6, 23)
    want = paug.apply_pascal(paug.to_unit(x.reshape(6, 16, 16, 1)), p)
    assert torch.equal(got, want.reshape(x.shape))
    # every op off: x / 255 exactly
    u[:, 13:17] = 0.75
    u[:, 19] = u[:, 21] = 0.75
    assert torch.equal(kda.image_da(x, u, keys, order, program="pascal_1d"),
                       paug.to_unit(x))


# -- 4. the episode processor -------------------------------------------------------

def _raw_episode(seed, t_=2, s=4, q=3, hw=32):
    rng = np.random.RandomState(seed)
    return dict(
        ctx_x=rng.randint(0, 255, (t_, s, hw, hw, 1)).astype(np.uint8),
        ctx_y=rng.uniform(0, 1, (t_, s, 1)).astype(np.float32),
        ctx_mask=np.ones((t_, s), bool),
        qry_x=rng.randint(0, 255, (t_, q, hw, hw, 1)).astype(np.uint8),
        qry_y=rng.uniform(0, 1, (t_, q, 1)).astype(np.float32))


def test_process_matches_jax_in_training_and_evaluation():
    raw = _raw_episode(5)
    key = jax.random.PRNGKey(21)
    aug = ["task_aug", "data_aug"]
    want = jax_processor("pascal_1d", aug, train=True)(key, raw)
    da, ta = jax_pascal_process_draws(key, raw)
    assert set(ta.tolist()) <= {0, 1, 2, 3}
    got = build_episode_processor("pascal_1d", aug, train=True)(
        {k: t(v) for k, v in raw.items()}, ta_idx=ta, da_params=da)
    for k in ("ctx_x", "qry_x", "ctx_y", "qry_y"):
        _close(got[k], want[k], err_msg=k)
    offsets = np.array([0.0, 0.25, 0.5, 0.75], np.float32)[ta.numpy()]
    np.testing.assert_allclose(
        got["ctx_y"].numpy(),
        10 * ((raw["ctx_y"] + offsets[:, None, None]) % 1.0), rtol=1e-6)
    # evaluation: no DA, no TA, labels x 10 all the same
    ev = build_episode_processor("pascal_1d", aug, train=False)
    assert ev.augment is None
    got = ev({k: t(v) for k, v in raw.items()})
    want = jax_processor("pascal_1d", aug, train=False)(key, raw)
    for k in ("ctx_x", "qry_x", "ctx_y", "qry_y"):
        _close(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["qry_y"].numpy(), raw["qry_y"] * 10.0)


# -- 5. one training step of each method --------------------------------------------

def _pascal_cfg(method, **extra):
    cfg = dict(method=method, task="pascal_1d", agg_mode="attention",
               aug_list=["task_aug", "data_aug"], tasks_per_batch=2,
               max_ctx_num=4, query_num=3, dim_w=WIDTHS["dim_w"],
               dim_r=WIDTHS["dim_r"], dim_z=WIDTHS["dim_z"],
               n_hidden_units_r=list(WIDTHS["n_hidden_units_r"]), lr=1e-4,
               seed=0, loss_type="mse", optimizer="Adam", device="cpu")
    cfg.update(extra)
    return cfg


def test_one_anp_pascal_train_step_matches_jax():
    cfg = _pascal_cfg("ANPVanillaPascal1D")
    jcfg = JaxConfig.from_dict(cfg)
    jmodel = jax_build_model(jcfg)
    variables = to_numpy(jax_init_model(jmodel, jcfg, jax.random.PRNGKey(1)))
    pcfg = Config.from_dict(cfg)
    model = load_jax_variables(build_model(pcfg), variables)
    raw = _raw_episode(8, hw=128)
    key = jax.random.PRNGKey(3)
    da, ta = jax_pascal_process_draws(jax.random.split(key)[0], raw)

    tx = jax_optimizer(jcfg)
    state = TrainState.create(jax.tree_util.tree_map(np.array, variables), tx)
    state, metrics = jax_train_step(jmodel, jcfg, tx=tx)(state, raw, key)
    step = build_train_step(model, build_optimizer(pcfg, model.parameters()),
                            pcfg)
    loss = step({k: t(v) for k, v in raw.items()}, ta_idx=ta, da_params=da)
    np.testing.assert_allclose(loss.item(), float(metrics["loss"]), rtol=RTOL)
    want = jax_grads_as_port(model, state.params, variables)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def test_one_second_order_vanilla_maml_pascal_step_matches_jax():
    """VanillaMAML on Pascal1D (output dim 1, no tanh), image and task
    augmentation with JAX's draws, two inner steps at the shipped YAML's
    update_lr (0.002), second order: the outer loss and every gradient as
    ``test_torch_port_maml.py`` holds them, except the features blocks'
    conv biases. Those feed a batch norm, which removes any per-channel
    shift: their true gradient is 0 and float32 computes noise around it
    (Pascal1D's labels x 10 make it larger than ShapeNet1D's), so they are
    held against the model's largest gradient entry, as ``chip_smoke.py``
    holds them. (At the MAML tests' update_lr of 0.1 the inner steps
    diverge on these labels, and float32 noise grows to 7% of a tensor,
    with or without augmentation.)"""
    aug = ["data_aug", "task_aug"]
    (jmodel, jcfg, params), (model, pcfg) = maml_pair(
        method="VanillaMAML", task="pascal_1d", aug_list=aug,
        update_lr=0.002)
    assert pcfg.output_dim == 1 and pcfg.first_order is False
    rng = np.random.RandomState(4)
    t_, s_, q_, hw = 2, 3, 2, 32
    raw = dict(
        ctx_x=rng.randint(0, 255, (t_, s_, hw, hw, 1)).astype(np.uint8),
        ctx_y=rng.uniform(0, 1, (t_, s_, 1)).astype(np.float32),
        ctx_mask=np.ones((t_, s_), bool),
        qry_x=rng.randint(0, 255, (t_, q_, hw, hw, 1)).astype(np.uint8),
        qry_y=rng.uniform(0, 1, (t_, q_, 1)).astype(np.float32))
    key = jax.random.PRNGKey(9)
    outer = jax_maml_outer(jmodel, jcfg, 2, train=True, test=False)
    (want_loss, _), want_grads = to_numpy(jax.jit(jax.value_and_grad(
        lambda p, b: outer(p, b, key), has_aux=True))(params, raw))
    da, ta = jax_pascal_process_draws(jax.random.split(key)[0], raw)
    loss, pre = build_maml_outer(model, pcfg, 2, train=True, test=False)(
        {k: t(v) for k, v in raw.items()}, ta_idx=ta, da_params=da)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=RTOL)
    loss.backward()
    want = maml_state_dict(model, {"params": to_numpy(want_grads)})
    largest = max(np.abs(w.numpy()).max() for w in want.values())
    for name, p in model.named_parameters():
        w = want[name].numpy()
        atol = max(GRAD_TOL["atol"], MAML_GRAD_ATOL * np.abs(w).max())
        if re.fullmatch(r"features\.layer\d\.conv\.bias", name):
            atol = MAML_GRAD_ATOL * largest
        np.testing.assert_allclose(p.grad.numpy(), w, err_msg=name,
                                   rtol=GRAD_TOL["rtol"], atol=atol)


# -- 6. the shipped YAMLs, the fused call, evaluation --------------------------------

PASCAL_YAMLS = ["CNP_DA+TA_Pascal1D.yaml", "ANP_Pascal1D.yaml",
                "ANP_DA_Pascal1D.yaml", "ANP_DA+TA_Pascal1D.yaml",
                "MAML_Pascal1D.yaml", "MAML_DA+TA_Pascal1D.yaml"]


@pytest.mark.parametrize("name", PASCAL_YAMLS)
def test_shipped_pascal_yaml_builds_a_cpu_trainer(name, pascal_dir, tmp_path,
                                                  monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = Config(os.path.join(TRAIN, name),
                 ["device=cpu", f"data_path={pascal_dir}"])
    assert cfg.task == "pascal_1d" and cfg.device == "cpu"
    trainer = train_cli.build_trainer(cfg)
    assert trainer.sampler.shot_min == cfg.max_ctx_num == 15
    process = trainer.train_step.step
    assert callable(process)
    aug = build_episode_processor("pascal_1d", cfg.aug_list, train=True)
    if "data_aug" in cfg.aug_list:
        assert isinstance(aug.augment, paug.Augmenter)
        assert aug.augment.program == "pascal_1d"
    else:
        assert aug.augment is None


def test_fused_call_equals_k_single_steps_on_pascal_anp():
    """P1's fused call (K = 3 steps of ANPVanillaPascal1D, DA + TA) against
    three single steps on the same draws, bit for bit."""
    cfg = Config(os.path.join(TRAIN, "ANP_DA+TA_Pascal1D.yaml"),
                 ["device=cpu", "tasks_per_batch=2", "max_ctx_num=3",
                  "dim_w=16", "dim_r=12", "dim_z=8"], make_dirs=False)
    cfg.img_size = [32, 32, 1]
    rng = np.random.RandomState(0)
    sampler = DeviceEpisodeSampler(
        rng.randint(0, 255, (4, 7, 32, 32, 1)).astype(np.uint8),
        rng.rand(4, 7, 1).astype(np.float32), max_ctx=3, query=3, shot_min=3,
        label_scale=1.0, device="cpu")
    runs = []
    for fused in (True, False):
        model = build_model(cfg)
        opt = build_optimizer(cfg, model.parameters())
        gen = torch.Generator().manual_seed(5)
        if fused:
            metrics = build_device_data_train_step(model, opt, cfg, sampler,
                                                   3)(gen)
        else:
            step = build_train_step(model, opt, cfg)
            losses = [step(sampler.sample(2, gen), gen) for _ in range(3)]
            metrics = {"loss": torch.stack(losses).mean(),
                       "last_loss": losses[-1]}
        runs.append((metrics, [p.detach().clone() for p in model.parameters()],
                     gen.get_state()))
    (got, wg, gg), (want, ww, gw) = runs
    assert all(torch.equal(got[k], want[k]) for k in ("loss", "last_loss"))
    assert all(torch.equal(a, b) for a, b in zip(wg, ww))
    assert torch.equal(gg, gw)


def test_evaluation_cli_writes_validation_losses_only(pascal_dir, tmp_path,
                                                      monkeypatch):
    """Pascal1D has no test split: ``val_losses.txt`` alone, one row per
    context count (``wmfml_tpu/eval/evaluator.py:161-167``)."""
    monkeypatch.chdir(tmp_path)
    cfg = Config(os.path.join(TRAIN, "ANP_DA+TA_Pascal1D.yaml"),
                 ["device=cpu", f"data_path={pascal_dir}", "mode=eval",
                  "max_ctx_num=3", "val_iters=2", "tasks_per_batch=2",
                  "dim_w=16", "dim_r=12", "dim_z=8"])
    val, test = evaluation_cli.evaluate(cfg)
    assert len(val) == 3 and test == []
    files = set(os.listdir(cfg.save_path))
    assert "val_losses.txt" in files and "test_losses.txt" not in files
    arr = np.loadtxt(os.path.join(cfg.save_path, "val_losses.txt"))
    assert arr.shape == (3, 3) and np.isfinite(arr).all()
    assert list(arr[:, 0]) == [1, 2, 3]
