"""The port's ShapeNet3D slice against the JAX package, on the CPU.

The quaternion algebra, the synthetic generator (its arrays bit for bit),
the host sampler (its episodes draw for draw in training, validation, test
and evaluation mode), background compositing (the host splits bit for bit;
the device sampler's per-batch compositing with JAX's indices injected),
the episode processor (the alpha stripped, DA as two calls, the pose noise
fed in as ``ta_idx``, ``azimuth_only``), K6's programs 6 and 7 through
their twins (JAX's draws replayed as ``DAParams``: several of the 720
orders, the fixed order with the grid's cells injected), brightness, the
per-channel masks, the quaternion loss, CondNeuralProcess (baco) and ANP on
the ResNet trunk at ``img_agg: reshape`` and h = 256, one training step of
each (loss and gradients), the fused K-step call against K single steps, a
``state_dict`` round trip through the JAX package's importer, the
pretrained-trunk hook, the shipped ShapeNet3D YAMLs, validation after
``train()`` recomposites the backgrounds, the evaluation sweep, a resumed
run, and the numeric settings every entry point makes (TF32 off).

Small sizes: T = 2, 3 context rows and 3 queries (the evaluation's 30),
full 64 x 64 images, the generator's ``small`` split (30 / 8 / 8 items).
Tolerances: float32 rtol/atol 1e-5 (``torch_port_common``), the quaternion
utils 1e-6; gradients ``GRAD_TOL``; the generator, the sampler, the
compositing and the masks bit for bit. The trunks' first convolution is
scaled x 3 so that features are O(1) and a wrong flatten order shows.
"""

import itertools
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy.spatial.transform import Rotation

from test_torch_port_aug import _jax_drop
from test_torch_port_fixed_order import _drop_fixed, _geometric_row
from test_torch_port_pascal import _pascal_op_draws
from torch_port_common import (ATOL, GRAD_TOL, RTOL, jax_grads_as_port, t,
                               to_numpy)
from wmfml_tpu.aug import image_aug as jaug
from wmfml_tpu.aug.pipeline import build_episode_processor as jax_processor
from wmfml_tpu.ckpt.torch_import import (import_torch_checkpoint,
                                         state_dict_to_numpy)
from wmfml_tpu.configs import Config as JaxConfig
from wmfml_tpu.data import synthetic as jsynth
from wmfml_tpu.data.device_sampler import DeviceEpisodeSampler as JaxSampler
from wmfml_tpu.data.shapenet_3d import ShapeNet3DData as JaxShapeNet3D
from wmfml_tpu.losses.losses import LossFunc as JaxLossFunc
from wmfml_tpu.models.neural_process import LargeCNP as JaxLargeCNP
from wmfml_tpu.nn.encoders import ResNetTrunk as JaxTrunk
from wmfml_tpu.nn.encoders import \
    load_pretrained_resnet as jax_load_pretrained
from wmfml_tpu.train.state import TrainState
from wmfml_tpu.train.steps import build_eval_step as jax_eval_step
from wmfml_tpu.train.steps import make_forward as jax_forward
from wmfml_tpu.utils import quaternion as jq
from wmfml_tpu_torch.aug import image_aug as paug
from wmfml_tpu_torch.aug.pipeline import build_episode_processor
from wmfml_tpu_torch.ckpt.jax_params import load_jax_variables, trunk_state_dict
from wmfml_tpu_torch.cli import train_cli
from wmfml_tpu_torch.configs import Config
from wmfml_tpu_torch.data import synthetic as psynth
from wmfml_tpu_torch.data.device_sampler import DeviceEpisodeSampler
from wmfml_tpu_torch.data.factory import build_data
from wmfml_tpu_torch.data.shapenet_3d import ShapeNet3DData
from wmfml_tpu_torch.eval.evaluator import ModelEvaluator
from wmfml_tpu_torch.kernels import image_da as kda
from wmfml_tpu_torch.losses.losses import LossFunc
from wmfml_tpu_torch.models.neural_process import LargeCNP
from wmfml_tpu_torch.models.registry import build_model
from wmfml_tpu_torch.nn.encoders import ResNetTrunk, load_pretrained_resnet
from wmfml_tpu_torch.train.state import build_optimizer
from wmfml_tpu_torch.train.steps import (build_device_data_train_step,
                                         build_train_step)
from wmfml_tpu_torch.utils import quaternion as pq
from torch_port_common import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = os.path.join(REPO, "cfg", "train")
S1_YAML = os.path.join(TRAIN, "ANP_DA+TA_ShapeNet3D.yaml")
CNP_YAML = os.path.join(TRAIN, "CNP_ShapeNet3D.yaml")
EVAL_YAML = os.path.join(REPO, "cfg", "evaluation", "ANP_ShapeNet3D.yaml")
PERF_YAML = os.path.join(TRAIN, "perf",
                         "CondNeuralProcess_DA+TA_ShapeNet3D_tpu.yaml")
# the shipped ShapeNet3D YAMLs of the two ported methods
YAMLS = [os.path.join(TRAIN, f"{n}_ShapeNet3D.yaml") for n in (
    "ANP", "ANP_DA", "ANP_DA+TA", "ANP_DA_wDR", "ANP_NOAUG", "ANP_TA_AZI",
    "CNP")] + [EVAL_YAML, os.path.join(REPO, "cfg", "evaluation",
                                       "eval_and_plot", "ANP_ShapeNet3D.yaml")]
HW = 64
F32 = jnp.float32


def _close(got, want, err_msg="", tol=None):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or dict(rtol=RTOL, atol=ATOL)),
                               err_msg=err_msg)


def _quats(seed, shape):
    q = np.random.RandomState(seed).randn(*shape, 4)
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def _rgba(seed, shape):
    """Float RGBA images: alpha 1 (background) on about a third of the
    pixels, and some pure black foreground pixels (brightness's gray
    branch)."""
    rng = np.random.RandomState(seed)
    x = rng.rand(*shape, HW, HW, 4).astype(np.float32)
    x[..., 3] = np.where(rng.rand(*shape, HW, HW) < 0.35, 1.0, x[..., 3] * .9)
    x[..., :3] *= (rng.rand(*shape, HW, HW, 1) > 0.05)
    return x


def _raw_episode(seed, t_=2, s=3, q=3, shots=(3, 1)):
    """A raw ShapeNet3D episode: float RGBA images, quaternion labels."""
    return dict(ctx_x=_rgba(seed, (t_, s)), ctx_y=_quats(seed, (t_, s)),
                ctx_mask=np.arange(s)[None, :] < np.asarray(shots)[:, None],
                qry_x=_rgba(seed + 1, (t_, q)),
                qry_y=_quats(seed + 1, (t_, q)))


# -- the JAX package's ShapeNet3D draws, replayed as the port's parameters ------

def _rgb_op_draws(op, k, h, w):
    """What ``FULL_OPS[op]`` (a ``sometimes`` of it) draws from one image's
    key: a warp row, or a pixel op's (gate, parameter)."""
    if op == paug.S_BRIGHT:
        kg, ko = jax.random.split(k)
        return jnp.stack([jax.random.bernoulli(kg, 0.5).astype(F32),
                          jax.random.uniform(ko, (), minval=-30.0 / 255.0,
                                             maxval=30.0 / 255.0)])
    pascal = {paug.S_CROP: paug.P_CROP, paug.S_GAMMA: paug.P_GAMMA,
              paug.S_BLUR: paug.P_BLUR, paug.S_AFFINE: paug.P_AFFINE}[op]
    return _pascal_op_draws(pascal, k, h, w)


_PIXEL_COLS = {paug.S_GAMMA: 0, paug.S_BLUR: 2, paug.S_BRIGHT: 4}


def jax_rgb_params(key, b, h, w) -> paug.DAParams:
    """``build_augmenter("shapenet_3d")``'s draws for ``b`` images from
    ``key`` (the per-step switch chain, :567-577): the permutation, then
    the op at chain position s draws from per-image keys split from
    ``step_keys[s]``."""
    kperm, kops = jax.random.split(key)
    step_keys = jax.random.split(kops, 6)
    perm = tuple(int(v) for v in jax.random.permutation(kperm, 6))
    warp = np.zeros((b, 2, 7), np.float32)
    pixel = np.zeros((b, 6), np.float32)
    drop, words = np.zeros((b, 5), np.float32), np.zeros((b, 2), np.uint32)
    for s, op in enumerate(perm):
        keys = jax.random.split(step_keys[s], b)
        if op == paug.S_DROP:
            d, km = jax.vmap(_jax_drop)(keys)
            drop[:], words[:] = np.asarray(d), np.asarray(km)
            continue
        rows = np.asarray(jax.vmap(lambda k: _rgb_op_draws(op, k, h, w))(
            keys))
        if op in (paug.S_CROP, paug.S_AFFINE):
            warp[:, int(op == paug.S_AFFINE)] = rows
        else:
            pixel[:, _PIXEL_COLS[op]:_PIXEL_COLS[op] + 2] = rows
    return paug.DAParams(paug.SHAPENET3D_ORDERS.index(perm), t(warp), t(drop),
                         t(words.view(np.int32)), pixel=t(pixel))


def jax_rgb_fixed_params(key, b, h, w) -> paug.DAParams:
    """``build_augmenter("shapenet_3d", random_order=False)``'s draws: one
    key per image, split into one per op of ``FUSED_PIPELINES``
    (geometric, gamma, brightness, blur, the fixed dropout op)."""
    gh, gw = paug.fixed_grid(h, w)
    warp = np.zeros((b, 2, 7), np.float32)
    pixel = np.zeros((b, 6), np.float32)
    drop, words = np.zeros((b, 5), np.float32), np.zeros((b, 2), np.uint32)
    cells = np.zeros((b, gh, gw), bool)
    for i, k in enumerate(jax.random.split(key, b)):
        ks = jax.random.split(k, 5)
        warp[i, 0] = np.asarray(_geometric_row(ks[0], h, w))
        for j, op in ((1, paug.S_GAMMA), (2, paug.S_BRIGHT),
                      (3, paug.S_BLUR)):
            c = _PIXEL_COLS[op]
            pixel[i, c:c + 2] = np.asarray(_rgb_op_draws(op, ks[j], h, w))
        d, km, low = _drop_fixed(ks[4], gh, gw)
        drop[i], words[i], cells[i] = np.asarray(d), np.asarray(km), low
    return paug.DAParams(None, t(warp), t(drop), t(words.view(np.int32)),
                         pixel=t(pixel), cells=t(cells))


@jax.jit
def _first_perms(seeds):
    return jax.vmap(lambda s: jax.random.permutation(
        jax.random.split(jax.random.PRNGKey(s))[0], 6))(seeds)


def key_for_rgb_order(order: int):
    """A key whose augmenter call draws order ``order`` of the 720."""
    want = np.asarray(paug.SHAPENET3D_ORDERS[order])
    for start in itertools.count(0, 20000):
        perms = np.asarray(_first_perms(jnp.arange(start, start + 20000)))
        hit = np.nonzero((perms == want).all(1))[0]
        if hit.size:
            return jax.random.PRNGKey(start + int(hit[0]))


def jax_process_draws(key, raw, azimuth_only=False, random_order=True):
    """The DA parameters and pose noise ShapeNet3D's ``process(key, batch)``
    draws (``wmfml_tpu/aug/pipeline.py:48-56, 78-96``)."""
    k_aug, k_ele, k_azi = jax.random.split(key, 3)
    k1, k2 = jax.random.split(k_aug)
    draw = jax_rgb_params if random_order else jax_rgb_fixed_params
    da = tuple(draw(k, int(np.prod(raw[x].shape[:2])), HW, HW)
               for k, x in ((k1, "ctx_x"), (k2, "qry_x")))
    t_ = raw["ctx_y"].shape[0]
    azi = np.asarray(jax.random.randint(k_azi, (t_,), -10, 20))
    ele = (np.zeros(t_, np.int32) if azimuth_only else
           np.asarray(jax.random.randint(k_ele, (t_,), -5, 10)))
    return da, t(np.stack([ele, azi], -1))


# -- 1. quaternions ---------------------------------------------------------------

def test_quaternion_utils_match_jax_and_scipy():
    q1, q2 = _quats(0, (5, 7)), _quats(1, (5, 7))
    _close(pq.quat_mul(t(q1), t(q2)), jq.quat_mul(q1, q2), tol=dict(
        rtol=1e-6, atol=1e-6))
    want = (Rotation.from_quat(q1.reshape(-1, 4))
            * Rotation.from_quat(q2.reshape(-1, 4))).as_quat()
    got = pq.quat_mul(t(q1), t(q2)).numpy().reshape(-1, 4)
    sign = np.sign((got * want).sum(-1, keepdims=True))   # q and -q agree
    np.testing.assert_allclose(got * sign, want, atol=1e-6)
    ang = np.random.RandomState(2).uniform(-4, 4, (5, 7)).astype(np.float32)
    tol = dict(rtol=1e-6, atol=1e-6)
    _close(pq.quat_rot_z(t(ang)), jq.quat_rot_z(ang), tol=tol)
    _close(pq.quat_rot_x(t(ang)), jq.quat_rot_x(ang), tol=tol)
    euler = np.random.RandomState(3).uniform(-80, 80, (9, 3)).astype(
        np.float32)
    _close(pq.euler_zyx_to_quat(t(euler)), jq.euler_zyx_to_quat(euler),
           tol=tol)
    _close(pq.quat_to_euler_zyx(t(q1)), jq.quat_to_euler_zyx(q1),
           tol=dict(rtol=1e-5, atol=1e-4))           # degrees
    _close(pq.quat_to_euler_zyx(t(q1), degrees=False),
           jq.quat_to_euler_zyx(q1, degrees=False), tol=tol)
    ele = np.random.RandomState(4).randint(-5, 10, 5).astype(np.float32)
    azi = np.random.RandomState(5).randint(-10, 20, 5).astype(np.float32)
    _close(pq.task_augment_quat(t(q1), t(ele), t(azi)),
           jq.task_augment_quat(q1, ele, azi), tol=tol)
    _close(pq.quat_canonicalize(t(q1)), jq.quat_canonicalize(q1), tol=tol)
    assert (pq.quat_canonicalize(t(q1))[..., 1] >= 0).all()


# -- 2. data: the generator, the host sampler, compositing -------------------------

def _load(path):
    with open(path, "rb") as f:
        return {k: np.asarray(v) for k, v in pickle.load(f).items()}


def test_generator_arrays_equal_jax(tmp_path):
    assert psynth.GENERATORS["shapenet_3d"][0] == \
        jsynth.GENERATORS["shapenet_3d"][0] == "ShapeNet3D_azi180ele30"
    psynth.generate_shapenet3d(str(tmp_path / "port"), small=True)
    jsynth.generate_shapenet3d(str(tmp_path / "jax"), small=True)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names and len(names) == 4
    got, want = (np.load(tmp_path / d / "bg_images.npy") for d in
                 ("port", "jax"))
    assert got.shape == (200, HW, HW, 3) and np.array_equal(got, want)
    for split, n in (("train", 30), ("val", 8), ("test", 8)):
        name = f"shapenet3d_azi180ele30_{split}.pkl"
        got, want = (_load(tmp_path / d / name) for d in ("port", "jax"))
        assert got.keys() == want.keys() == {"images", "item_indices", "Q"}
        assert got["images"].shape == (n * 30, HW, HW, 4)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert np.array_equal(got[k], want[k]), (split, k)


@pytest.fixture(scope="module")
def s3d_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("shapenet3d"))
    psynth.generate_shapenet3d(root, small=True)
    return root


def _samplers(path, mode="train", max_ctx=15, aug=None):
    common = dict(img_size=[HW, HW, 4], seed=42, max_ctx=max_ctx, mode=mode,
                  aug=aug)
    return ShapeNet3DData(path, **common), JaxShapeNet3D(path, **common)


def _assert_same_batch(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k


def test_sampler_draws_the_jax_episodes_in_train_validation_and_test(s3d_dir):
    """Train (shot ~ U[1, 15], 15 queries of the remaining views),
    validation and test (a fixed item permutation walked by a counter that
    wraps), twice over, each split's stream reset to 42 between rounds."""
    port, jx = _samplers(s3d_dir)
    for split, n in (("train", 30), ("validation", 8), ("test", 8)):
        assert port.splits[split]["n_items"] == n
        for k in ("images", "Q"):
            assert np.array_equal(port.splits[split][k], jx.splits[split][k])
    assert np.array_equal(port.bg_imgs, jx.bg_imgs)
    for source in ("train", "validation", "test", "test", "validation"):
        for _ in range(3):          # 3 x 3 tasks wrap the 8 items
            _assert_same_batch(port.get_batch(source, 3, 15),
                               jx.get_batch(source, 3, 15))
            for a, b in zip(port.get_batch_indices(source, 3, 15),
                            jx.get_batch_indices(source, 3, 15)):
                assert np.array_equal(a, b)
        assert port.counters == jx.counters
        port.reset_eval(source)
        jx.reset_eval(source)
    batch = port.get_batch("validation", 3, 15)
    assert batch["qry_x"].shape == (3, 15, HW, HW, 4)
    assert batch["ctx_y"].shape == (3, 15, 4)
    assert batch["qry_x"].dtype == batch["ctx_y"].dtype == np.float32


def test_eval_mode_skips_the_train_split_and_queries_all_views(s3d_dir):
    port, jx = _samplers(s3d_dir, mode="eval", max_ctx=25)
    assert port.query_num == 30 and "train" not in port.splits
    for source in ("validation", "test"):
        for shot in (1, 25):
            port.reset_eval(source)
            jx.reset_eval(source)
            got = port.get_batch(source, 2, shot)
            _assert_same_batch(got, jx.get_batch(source, 2, shot))
            assert got["qry_x"].shape == (2, 30, HW, HW, 4)
            assert got["ctx_x"].shape == (2, 25, HW, HW, 4)
            assert np.array_equal(got["ctx_x"][:, :shot],
                                  got["qry_x"][:, :shot])


def test_host_compositing_is_the_jax_packages_bit_for_bit(s3d_dir):
    """``gen_bg`` over every split, then over the train split again, from
    the background stream alone: the splits equal the JAX package's bit for
    bit; the episode streams do not move; background pixels changed and
    foreground pixels kept."""
    port, jx = _samplers(s3d_dir)
    before = port.splits["validation"]["images"].copy()
    cfg = Config(S1_YAML, ["device=cpu"], make_dirs=False)
    for data in ("all", "train"):
        port.gen_bg(cfg, data=data)
        jx.gen_bg(cfg, data=data)
        for split in ("train", "validation", "test"):
            assert np.array_equal(port.splits[split]["images"],
                                  jx.splits[split]["images"]), (data, split)
    after = port.splits["validation"]["images"]
    fg = before[..., 3] < 1.0
    assert np.array_equal(after[fg], before[fg])
    assert not np.array_equal(after[~fg], before[~fg])
    _assert_same_batch(port.get_batch("train", 2, 15),
                       jx.get_batch("train", 2, 15))
    with pytest.raises(TypeError):
        port.gen_bg(cfg, data="test")


def test_factory_and_device_sampler_composite_as_jax(s3d_dir):
    """The factory's ShapeNet3D route; the device sampler's branch (shot_min
    1, the bank resident when ``gen_bg``), its per-batch compositing against
    the JAX sampler's ``_composite`` with the same indices, bit for bit,
    and a sampled episode whose background pixels come from the bank."""
    cfg = Config(S1_YAML, ["device=cpu", f"data_path={s3d_dir}"],
                 make_dirs=False)
    assert (cfg.query_num, cfg.img_size, cfg.input_dim, cfg.output_dim) == \
        (15, [HW, HW, 4], 4, 4)
    assert (cfg.gen_bg, cfg.bg_gen_freq) == (True, 500)
    data = build_data(cfg)
    assert isinstance(data, ShapeNet3DData) and data.query_num == 15
    assert build_data(cfg, mode="eval").query_num == 30
    sampler = DeviceEpisodeSampler.from_dataset(data, cfg, "cpu")
    assert (sampler.shot_min, sampler.label_scale) == (1, 1.0)
    assert tuple(sampler.x.shape) == (30, 30, HW, HW, 4)
    assert tuple(sampler.bg.shape) == (200, HW, HW, 3)
    images = data.splits["train"]["images"][:2, :5]
    idx = np.random.RandomState(0).randint(0, 200, (2, 5))
    jsampler = JaxSampler("shapenet_3d", data.splits["train"]["images"],
                          data.splits["train"]["Q"], 15, 15, 1,
                          bg_images=data.bg_imgs, gen_bg=True)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jsampler._composite(key, jnp.asarray(images),
                                          jsampler.bg))
    jidx = np.asarray(jax.random.randint(key, (2, 5), 0, 200))
    got = sampler.composite(t(images), t(jidx)).numpy()
    assert np.array_equal(got, want)
    assert not np.array_equal(
        sampler.composite(t(images), t(idx)).numpy(), want)
    gen = torch.Generator().manual_seed(0)
    ep = sampler.sample(3, gen)
    assert ep["ctx_x"].shape == (3, 15, HW, HW, 4)
    assert ep["qry_y"].shape == (3, 15, 4)
    bg = ep["qry_x"][..., 3] >= 1.0
    bank = set(map(float, sampler.bg.flatten().unique()))
    assert bg.any() and set(map(float, ep["qry_x"][..., :3][bg].flatten()
                                .unique())) <= bank
    no_bg = Config(S1_YAML, ["device=cpu", "gen_bg=false"], make_dirs=False)
    assert DeviceEpisodeSampler.from_dataset(data, no_bg, "cpu").bg is None


# -- 3. image DA: programs 6 and 7, brightness, the masks, the processor ------------

@pytest.mark.parametrize("c", [3, 1])
def test_brightness_matches_jax(c):
    """The twin at the offsets JAX's ``brightness`` draws from its keys
    (RGB with black pixels, and gray); black RGB pixels turn the gray
    max(b, 0)."""
    x = _rgba(4, (4,))[..., :c]
    keys = jax.random.split(jax.random.PRNGKey(7), 4)
    want = jax.vmap(jaug.brightness)(keys, x)
    b = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (), minval=-30.0 / 255.0, maxval=30.0 / 255.0))(keys))
    assert (b > 0).any() and (b < 0).any()
    _close(paug.brightness(t(x), t(b)), want)
    black = np.zeros((2, 4, 4, 3), np.float32)
    got = paug.brightness(t(black), t(np.asarray([0.1, -0.1], np.float32)))
    assert torch.equal(got[0], torch.full((4, 4, 3), 0.1))
    assert torch.equal(got[1], torch.zeros((4, 4, 3)))


def test_order_decode_covers_the_720_orders():
    assert len(paug.SHAPENET3D_ORDERS) == kda.PROGRAM_ORDERS["shapenet_3d"]
    for i in (0, 1, 7, 119, 120, 359, 718, 719):
        assert paug.decode_order(i, 6) == paug.SHAPENET3D_ORDERS[i]
    assert paug.SHAPENET3D_ORDERS[719] == (5, 4, 3, 2, 1, 0)


@pytest.mark.parametrize("order", [0, 719, 100, 333])
def test_program_6_matches_jax(order):
    """Float RGB through the twin of K6's program 6 against
    ``build_augmenter("shapenet_3d")`` at the same key, JAX's draws
    injected: the identity order, its reverse and two others."""
    b = 6
    img = _rgba(7 + order, (2, b // 2))[..., :3]
    key = key_for_rgb_order(order)
    params = jax_rgb_params(key, b, HW, HW)
    assert params.order == order
    want = jax.jit(jaug.build_augmenter("shapenet_3d"))(key, img)
    got = paug.Augmenter(program="shapenet_3d")(t(img), params=params)
    assert got.shape == img.shape and got.dtype == torch.float32
    _close(got, want)
    assert not np.allclose(np.asarray(want), img)


def test_program_7_matches_jax():
    """The fixed order (geometric, gamma, brightness, blur, the fixed grid's
    dropout op, its cells injected) against ``build_augmenter(
    "shapenet_3d", random_order=False)``."""
    b = 6
    img = _rgba(11, (2, b // 2))[..., :3]
    key = jax.random.PRNGKey(12)
    params = jax_rgb_fixed_params(key, b, HW, HW)
    want = jax.jit(jaug.build_augmenter("shapenet_3d", random_order=False))(
        key, img)
    got = paug.Augmenter(program="shapenet_3d_fixed")(t(img), params=params)
    _close(got, want)
    assert not np.allclose(np.asarray(want), img)


@pytest.mark.parametrize("fixed", [False, True])
def test_rgb_masks_hash_per_channel_ids_bit_for_bit(fixed):
    """Every op but the dropout op off: the twin's keep bits on RGB equal
    JAX's ``one_of_dropout`` / ``one_of_dropout_fixed`` at C = 3, Dropout
    and CoarseDropout, per channel or not."""
    b, h, w = 16, 32, 32
    img = np.ones((b, h, w, 3), np.float32)
    keys = jax.random.split(jax.random.PRNGKey(5), b)
    drop, words, cells = [], [], []
    gh, gw = paug.fixed_grid(h, w)
    for k in keys:
        if fixed:
            d, km, low = _drop_fixed(k, gh, gw)
            cells.append(low)
        else:
            d, km = _jax_drop(k)
        drop.append(np.asarray(d))
        words.append(np.asarray(km))
    op = jaug.sometimes(jaug.one_of_dropout_fixed if fixed
                        else jaug.one_of_dropout)
    want = np.asarray(jax.vmap(op)(keys, img))
    drop = np.stack(drop)
    assert set(drop[:, 1]) == {0.0, 1.0} and drop[:, 4].any()
    p = paug.DAParams(None, torch.zeros((b, 2, 7)), t(drop),
                      t(np.stack(words).view(np.int32)),
                      pixel=torch.zeros((b, 6)),
                      cells=t(np.stack(cells)) if fixed else None)
    if fixed:
        got = paug.one_of_dropout_fixed(t(img), p.drop, p.keys, p.cells)
    else:
        got = paug.one_of_dropout(t(img), p.drop, p.keys)
    np.testing.assert_array_equal(got.numpy(), want)
    per_channel = drop[:, 4] > 0.5
    assert (want[per_channel, ..., 0] != want[per_channel, ..., 1]).any()


def test_rgb_programs_draw_and_count_as_the_kernel_reads_them():
    """The wrapper's tables, the parameter row's width (25: warp, drop, the
    pixel ops' and brightness's columns), the draw's 25 uniforms and 720
    orders, and the CPU path taking the twin with no launch counted; every
    gate off leaves the image."""
    for program, orders in (("shapenet_3d", 720), ("shapenet_3d_fixed", 1)):
        assert kda.PROGRAM_NU[program] == kda.NU_RGB == 25
        assert kda.PROGRAM_ORDERS[program] == orders
        assert program in kda.RGB
        assert kda.nparams(program) == 25
    assert "shapenet_3d_fixed" in kda.GEOMETRIC
    gen = torch.Generator().manual_seed(3)
    x = torch.rand((2, 3, 16, 16, 4), generator=gen)[..., :3]
    for program in ("shapenet_3d", "shapenet_3d_fixed"):
        aug = paug.build_augmenter("shapenet_3d",
                                   random_order=program == "shapenet_3d")
        assert aug.program == program and aug.nu == 25
        u, keys, order = aug.sample(6, gen, "cpu")
        assert (order is None) == (program == "shapenet_3d_fixed")
        p = paug.params_for(program, u, keys, order, 16, 16)
        assert paug.params_row(p).shape == (6, 25)
        torch.testing.assert_close(p.pixel[:, 5], u[:, 24] * (60 / 255)
                                   - 30 / 255, rtol=0, atol=1e-7)
        before = kda.image_da.launches
        out = kda.image_da(x, u, keys, order, program=program)
        assert out.shape == x.shape and kda.image_da.launches == before
        out = kda.image_da(x.bfloat16(), u, keys, order, torch.bfloat16,
                           program)
        assert (out.shape, out.dtype) == (x.shape, torch.bfloat16)
        assert kda.image_da.launches == before
        u[:, 13:17] = 0.75
        u[:, [19, 21, 23]] = 0.75
        if program == "shapenet_3d_fixed":   # geometric at the identity
            u[:, 13:15] = 0.75
        assert torch.equal(kda.image_da(x, u, keys, order, program=program),
                           x)


@pytest.mark.parametrize("azimuth_only,random_order", [
    (False, True), (True, True), (False, False)])
def test_process_matches_jax_in_training_and_evaluation(azimuth_only,
                                                        random_order):
    """The alpha stripped, DA as two calls (programs 6 or 7), the pose noise
    (ele 0 with ``azimuth_only``) on context and query quaternions;
    evaluation strips the alpha only."""
    raw = _raw_episode(5)
    key = jax.random.PRNGKey(21)
    aug = ["task_aug", "data_aug"] + (["azimuth_only"] if azimuth_only
                                      else [])
    want = jax_processor("shapenet_3d", aug, train=True,
                         azimuth_only=azimuth_only,
                         aug_random_order=random_order)(key, raw)
    da, ta = jax_process_draws(key, raw, azimuth_only, random_order)
    assert ta.shape == (2, 2) and (not azimuth_only or not ta[:, 0].any())
    process = build_episode_processor("shapenet_3d", aug, train=True,
                                      aug_random_order=random_order)
    got = process({k: t(v) for k, v in raw.items()}, ta_idx=ta, da_params=da)
    assert got["ctx_x"].shape == (2, 3, HW, HW, 3)
    for k in ("ctx_x", "qry_x", "ctx_y", "qry_y"):
        _close(got[k], want[k], err_msg=k)
    ev = build_episode_processor("shapenet_3d", aug, train=False)
    assert ev.augment is None
    got = ev({k: t(v) for k, v in raw.items()})
    want = jax_processor("shapenet_3d", aug, train=False)(key, raw)
    for k in ("ctx_x", "qry_x", "ctx_y", "qry_y"):
        _close(got[k], want[k], err_msg=k)
    assert torch.equal(got["qry_y"], t(raw["qry_y"]))


def test_pose_noise_is_drawn_on_the_labels_device_in_its_ranges():
    process = build_episode_processor("shapenet_3d", ["task_aug"], train=True)
    raw = {k: t(v) for k, v in _raw_episode(6, t_=64).items()}
    got = process(raw, torch.Generator().manual_seed(0))
    dots = (got["qry_y"] * raw["qry_y"]).sum(-1).abs()
    assert (dots < 1 - 1e-6).all() and (dots > np.cos(np.deg2rad(25))).all()
    # one rotation a task: the context and the queries move together
    q = torch.stack([got["ctx_y"][:, 0], got["qry_y"][:, 0]], 1)
    assert torch.isfinite(q).all()


# -- 4. the loss, the trunk at 64 x 64, CondNeuralProcess and ANP --------------------

def test_quaternion_loss_matches_jax():
    rng = np.random.RandomState(6)
    gt = _quats(6, (2, 5))
    pr = rng.randn(2, 5, 4).astype(np.float32) * 3.0
    pr[0, 0] = 0.0                      # eps: a zero prediction
    mask = rng.rand(2, 5) > 0.3
    for test in (False, True):
        for m in (None, mask):
            want = JaxLossFunc("mse", "shapenet_3d").calc_loss(
                pr, None, gt, test=test, mask=m)
            got = LossFunc("mse", "shapenet_3d").calc_loss(
                t(pr), None, t(gt), test=test,
                mask=None if m is None else t(m))
            _close(got, want)
    # antipodes: q and -q give the same loss
    a = LossFunc("mse", "shapenet_3d").calc_loss(t(pr), None, t(gt))
    b = LossFunc("mse", "shapenet_3d").calc_loss(t(-pr), None, t(gt))
    assert float(a) == float(b)


def _scaled(variables):
    v = jax.tree_util.tree_map(np.array, variables)
    for node in (v["params"].get("img_encoder"),
                 v["params"].get("decoder", {}).get("trunk"), v["params"]):
        if node is not None and "conv1" in node:
            node["conv1"]["kernel"] *= 3.0
    return v


def test_resnet_trunk_on_rgb_matches_jax_and_takes_pretrained_convs():
    """The trunk at 64 x 64 x 3, ``reshape`` (unscaled: with three input
    channels its features are O(1) already): 64 x 2 x 2 = 256 features,
    CHW here against HWC in JAX; then ``load_pretrained_resnet`` on a
    state_dict with fitting and unfitting keys, against the JAX hook."""
    x = np.random.RandomState(2).rand(3, HW, HW, 3).astype(np.float32)
    jm = JaxTrunk(img_agg="reshape")
    variables = to_numpy(jm.init(jax.random.PRNGKey(0), x))
    want = np.asarray(jm.apply(variables, x))
    assert 0.5 < np.abs(want).max() < 50.0
    trunk = ResNetTrunk("reshape", 3)
    trunk.load_state_dict(trunk_state_dict(variables["params"]), strict=True)
    with torch.no_grad():
        got = trunk(t(x)).numpy()
    assert got.shape == (3, 256)
    _close(got, want.reshape(3, 2, 2, 64).transpose(0, 3, 1, 2).reshape(3, -1))
    rng = np.random.RandomState(9)
    sd = {"layer1.0.conv1.weight": rng.randn(64, 64, 3, 3),
          "layer3.0.conv2.weight": rng.randn(64, 64, 3, 3),
          "layer2.0.conv1.weight": rng.randn(128, 64, 3, 3),    # misfit
          "layer1.1.conv1.weight": rng.randn(64, 64, 3, 3),     # block 1
          "layer4.0.bn1.weight": rng.randn(64), "fc.weight": rng.randn(9, 3)}
    sd = {k: (v * 0.05).astype(np.float32) for k, v in sd.items()}
    skipped = load_pretrained_resnet(trunk, sd)
    jvars, jskipped = jax_load_pretrained(variables, sd)
    assert sorted(skipped) == sorted(jskipped) == sorted(
        ["layer2.0.conv1.weight", "layer1.1.conv1.weight",
         "layer4.0.bn1.weight", "fc.weight"])
    assert torch.equal(trunk.resnet.layer1[0].conv1.weight,
                       t(sd["layer1.0.conv1.weight"]))
    want = np.asarray(jm.apply(jvars, x))
    with torch.no_grad():
        got = trunk(t(x)).numpy()
    _close(got, want.reshape(3, 2, 2, 64).transpose(0, 3, 1, 2).reshape(3, -1))


def _pair(agg_mode, seed=0):
    """The JAX LargeCNP (ShapeNet3D's: no label embedding, y_dim 4,
    ``reshape``) and the port's with its weights, trunks scaled."""
    raw = _raw_episode(seed)
    jm = JaxLargeCNP(img_agg="reshape", agg_mode=agg_mode, y_dim=4)
    variables = _scaled(to_numpy(jm.init(
        jax.random.PRNGKey(seed), raw["ctx_x"][..., :3], raw["ctx_y"],
        raw["qry_x"][..., :3], ctx_mask=raw["ctx_mask"])))
    pm = LargeCNP(img_agg="reshape", agg_mode=agg_mode, y_dim=4, label_dim=4,
                  img_size=(HW, HW, 3),
                  generator=torch.Generator().manual_seed(seed))
    return jm, load_jax_variables(pm, variables), variables


@pytest.mark.parametrize("agg_mode", ["baco", "attention"])
def test_large_cnp_forward_and_loss_match_jax(agg_mode):
    """CondNeuralProcess (baco) and ANP at ``reshape``, where every
    consumer of the trunk's flatten (task encoder, W_k, W_q, fc_mu) must be
    permuted; a task with one context row; the quaternion loss of each."""
    jm, pm, variables = _pair(agg_mode)
    raw = _raw_episode(3)
    cx, qx = raw["ctx_x"][..., :3], raw["qry_x"][..., :3]
    want = jm.apply(variables, cx, raw["ctx_y"], qx, ctx_mask=raw["ctx_mask"])
    with torch.no_grad():
        got = pm(t(cx), t(raw["ctx_y"]), t(qx), ctx_mask=t(raw["ctx_mask"]))
    assert got.mu.shape == (2, 3, 4)
    _close(got.mu, want.mu)
    _close(got.extras["sample_features"], want.extras["sample_features"])
    assert np.abs(np.asarray(want.mu)).max() > 0.1
    _close(LossFunc("mse", "shapenet_3d").calc_loss(got.mu, None,
                                                    t(raw["qry_y"])),
           JaxLossFunc("mse", "shapenet_3d").calc_loss(want.mu, None,
                                                       raw["qry_y"]))


def _cfg(method, agg_mode, **extra):
    cfg = dict(method=method, task="shapenet_3d", agg_mode=agg_mode,
               img_agg="reshape", aug_list=["task_aug", "data_aug"],
               tasks_per_batch=2, max_ctx_num=3, query_num=3, lr=1e-4,
               seed=0, loss_type="mse", optimizer="Adam", device="cpu")
    cfg.update(extra)
    return cfg


@pytest.mark.parametrize("method,agg_mode", [("ANP", "attention"),
                                             ("CondNeuralProcess", "baco")])
def test_one_train_step_matches_jax(method, agg_mode):
    """One step with DA and TA on JAX's draws: the loss and every
    parameter's gradient."""
    cfg = _cfg(method, agg_mode)
    jcfg = JaxConfig.from_dict(cfg)
    jm, pm, variables = _pair(agg_mode, seed=1)
    assert set(dict(pm.named_parameters())) == set(dict(build_model(
        Config.from_dict(cfg)).named_parameters()))
    raw = _raw_episode(8)
    key = jax.random.PRNGKey(3)
    da, ta = jax_process_draws(jax.random.split(key)[0], raw)
    forward = jax_forward(jm, jcfg, train=True)
    extra = {k: v for k, v in variables.items() if k != "params"}

    def loss_fn(params):
        out, pbatch = forward({"params": params, **extra}, raw, key)
        return JaxLossFunc("mse", "shapenet_3d").calc_loss(
            out.mu.astype(jnp.float32), None, pbatch["qry_y"])

    want_loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        variables["params"])
    step = build_train_step(pm, torch.optim.SGD(pm.parameters(), lr=0.0),
                            Config.from_dict(cfg))
    loss = step({k: t(v) for k, v in raw.items()}, ta_idx=ta, da_params=da)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=RTOL)
    want = jax_grads_as_port(pm, grads, variables)
    assert want.keys() == dict(pm.named_parameters()).keys()
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   err_msg=name, **GRAD_TOL)


def test_fused_call_equals_k_single_steps_on_s1(s3d_dir):
    """S1's fused call (device episodes composited per batch, programs 6
    twice a step, pose noise) on the CPU: one call of 3 steps equals 3
    single steps from the same generator state, losses and weights bit for
    bit."""
    cfg = Config(S1_YAML, ["device=cpu", f"data_path={s3d_dir}",
                           "tasks_per_batch=2", "max_ctx_num=3",
                           "query_num=3"], make_dirs=False)
    data = build_data(cfg)
    models = [build_model(cfg) for _ in range(2)]
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
        assert torch.equal(a, b)


@pytest.mark.parametrize("method,agg_mode", [("ANP", "attention"),
                                             ("CondNeuralProcess", "baco")])
def test_state_dict_round_trip_through_the_jax_importer(method, agg_mode):
    pm = build_model(Config.from_dict(_cfg(method, agg_mode)))
    with torch.no_grad():
        pm.img_encoder.conv1.weight.mul_(3.0)
        pm.decoder.conv1.weight.mul_(3.0)
    kw = dict(img_agg="reshape")
    if method == "CondNeuralProcess":
        kw["agg_mode"] = agg_mode
    variables = import_torch_checkpoint(
        method, state_dict_to_numpy(pm.state_dict()), **kw)
    jm = JaxLargeCNP(img_agg="reshape", agg_mode=agg_mode, y_dim=4)
    raw = _raw_episode(9)
    cx, qx = raw["ctx_x"][..., :3], raw["qry_x"][..., :3]
    want = jm.apply(variables, cx, raw["ctx_y"], qx, ctx_mask=raw["ctx_mask"])
    with torch.no_grad():
        got = pm(t(cx), t(raw["ctx_y"]), t(qx), ctx_mask=t(raw["ctx_mask"]))
    _close(got.mu, want.mu)


# -- 5. YAMLs, configuration rules, trainers, evaluation ------------------------------

@pytest.mark.parametrize("path", YAMLS, ids=lambda p: os.path.relpath(
    p, os.path.join(REPO, "cfg")))
def test_shipped_shapenet3d_yaml_builds_a_config_and_a_model(path):
    cfg = Config(path, ["device=cpu", "checkpoint="], make_dirs=False)
    assert cfg.task == "shapenet_3d" and cfg.img_agg == "reshape"
    model = build_model(cfg)
    assert isinstance(model, LargeCNP) and model.transform_y is None
    assert model.agg_mode == ("attention" if cfg.method == "ANP"
                              else cfg.agg_mode)
    assert tuple(model.img_encoder.conv1.weight.shape) == (64, 3, 5, 5)
    assert tuple(model.task_encoder[0].weight.shape) == (256, 256 + 4)
    assert (model.cross_attn is not None) == (cfg.method == "ANP")
    process = build_episode_processor(cfg.task, cfg.aug_list, train=True)
    assert (process.augment is None) == ("data_aug" not in cfg.aug_list)
    if process.augment is not None:
        assert process.augment.program == "shapenet_3d"
    fixed = build_episode_processor(cfg.task, cfg.aug_list, train=True,
                                    aug_random_order=False)
    if fixed.augment is not None:
        assert fixed.augment.program == "shapenet_3d_fixed"
    assert cfg.gen_bg == ("wDR" not in path and "NOAUG" not in path)


def test_shapenet3d_config_rules():
    """The perf YAML builds as shipped, in bfloat16 (ROADMAP.md A24), and
    in float32; the segmentation task has a shape and no loader; the fixed
    order and ``gen_bg`` read."""
    cfg = Config(PERF_YAML, ["device=cpu"], make_dirs=False)
    assert cfg.compute_dtype == "bfloat16"
    model = build_model(cfg)
    assert isinstance(model, LargeCNP)
    assert model.img_encoder.compute_dtype == torch.bfloat16
    cfg = Config(PERF_YAML, ["compute_dtype=float32", "device=cpu"],
                 make_dirs=False)
    assert (cfg.gen_bg, cfg.bg_gen_freq, cfg.steps_per_call) == (True, 1000,
                                                                  64)
    assert isinstance(build_model(cfg), LargeCNP)
    seg = Config.from_dict(dict(method="ANP", task="shapenet_3d_segmentation",
                                tasks_per_batch=2, max_ctx_num=4, lr=1e-4,
                                seed=0, device="cpu", data_path="."))
    assert seg.img_size == [HW, HW, 4]
    with pytest.raises(NotImplementedError, match="no loader"):
        build_data(seg)
    assert Config(S1_YAML, ["aug_random_order=false"],
                  make_dirs=False).aug_random_order is False


def _train_overrides(path, *extra):
    return ["device=cpu", f"data_path={path}", "tasks_per_batch=2",
            "max_ctx_num=3", "query_num=3", "val_iters=1", *extra]


def test_validation_after_train_starts_reads_the_recomposited_splits(
        s3d_dir, tmp_path, monkeypatch):
    """``train()`` recomposites the host splits first (after the device
    sampler took the train split), then validates on them: the trainer's
    validation loss after one step equals the JAX eval step's on the JAX
    sampler recomposited once, at the trained weights carried into JAX;
    the device sampler's train split is the one loaded, not recomposited.
    Building the trainer also set TF32 off (``cli/common.py:
    set_numerics``)."""
    monkeypatch.chdir(tmp_path)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    cfg = Config(S1_YAML, _train_overrides(s3d_dir, "iterations=1",
                                           "val_freq=1", "steps_per_call=1"))
    trainer = train_cli.build_trainer(cfg)
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
    loaded = trainer.data.splits["train"]["images"].copy()
    assert torch.equal(trainer.sampler.x, t(loaded))
    trainer.train()
    assert not np.array_equal(trainer.data.splits["train"]["images"], loaded)
    got = trainer.validate(1, "validation")
    jdata = JaxShapeNet3D(s3d_dir, img_size=[HW, HW, 4], seed=42, max_ctx=3,
                          query_num=3)
    jdata.gen_bg(cfg)
    jcfg = JaxConfig(S1_YAML, _train_overrides(s3d_dir), make_dirs=False)
    variables = import_torch_checkpoint(
        "ANP", state_dict_to_numpy(trainer.model.state_dict()),
        img_agg="reshape")
    jm = JaxLargeCNP(img_agg="reshape", agg_mode="attention", y_dim=4)
    state = TrainState.create(variables, optax.sgd(0.0))
    jdata.reset_eval("validation", seed=42)
    want = float(jax_eval_step(jm, jcfg)(
        state, jdata.get_batch("validation", 2, 3), jax.random.PRNGKey(0)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_resumed_run_draws_what_an_unbroken_run_draws_on_s1(s3d_dir, tmp_path,
                                                            monkeypatch):
    """S1's configuration (backgrounds composited per batch, program 6,
    pose noise): 2 steps, then a run resumed from their checkpoint to 4,
    equal one unbroken run of 4 steps, weights and generator state."""
    monkeypatch.chdir(tmp_path)
    overrides = _train_overrides(s3d_dir, "val_freq=100", "steps_per_call=2")
    first = train_cli.train(Config(S1_YAML, overrides + ["iterations=2"]))
    resumed = train_cli.train(Config(S1_YAML, overrides + [
        "iterations=4", f"checkpoint={first.ckpt.path('model_end_2')}"]))
    whole = train_cli.train(Config(S1_YAML, overrides + ["iterations=4"]))
    assert resumed.step == whole.step == 4
    want = whole.model.state_dict()
    for k, v in resumed.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)
    assert torch.equal(resumed.generator.get_state(),
                       whole.generator.get_state())


def test_evaluation_sweep_matches_the_jax_host_path(s3d_dir, tmp_path,
                                                    monkeypatch):
    """The shipped evaluation YAML (eval-mode data: all 30 views as
    queries, no background recompositing) at 3 context points x 2
    episodes, against the JAX package's host sweep on the same weights;
    both loss files written."""
    monkeypatch.chdir(tmp_path)
    overrides = ["device=cpu", f"data_path={s3d_dir}", "checkpoint=",
                 "max_ctx_num=3", "val_iters=2", "tasks_per_batch=2"]
    cfg = Config(EVAL_YAML, overrides)
    jcfg = JaxConfig(EVAL_YAML, overrides, make_dirs=False)
    jm, pm, variables = _pair("attention", seed=2)
    data = build_data(cfg, mode="eval")
    assert data.query_num == 30 and "train" not in data.splits
    val, test = ModelEvaluator(pm, cfg, data).evaluate()
    jdata = JaxShapeNet3D(s3d_dir, img_size=[HW, HW, 4], seed=42, max_ctx=3,
                          mode="eval")
    state = TrainState.create(variables, optax.sgd(0.0))
    step = jax_eval_step(jm, jcfg)
    for source, got in (("validation", val), ("test", test)):
        want = []
        for ctx in (1, 2, 3):
            jdata.reset_eval(source, seed=42)
            want.append(np.mean([float(step(
                state, jdata.get_batch(source, 2, ctx), jax.random.PRNGKey(0)))
                for _ in range(2)]))
        _close(got, want, err_msg=source)
    for name in ("val_losses.txt", "test_losses.txt"):
        arr = np.loadtxt(os.path.join(cfg.save_path, name))
        assert arr.shape == (3, 3) and np.isfinite(arr).all()
