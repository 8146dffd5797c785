"""The port's Distractor slice against the JAX package, on the CPU.

The synthetic generator (its arrays bit for bit), the host sampler (its
episodes draw for draw in training, validation, evaluation mode and the
test split's re-permutation), the device sampler's Distractor branch, the
episode processor (the inversion before DA, task augmentation's shifts fed
in as ``ta_idx``), K6's programs 4 and 5 through their twins (JAX's draws
replayed as ``DAParams``, both orders, the fixed grid's cells injected),
the ResNet trunk for every ``img_agg``, LargeCNP's forward for CNP mean,
max and baco and for ANP (at ``img_agg`` max, and at reshape, where the
CHW / HWC flatten shows), FAVOR's twin at LargeCNP's width (d = 256, m =
1419), one ANPDistractor and one CNPDistractor training step (loss and
gradients), the loss, a ``state_dict`` round trip through the JAX package's
importer, the shipped Distractor YAMLs building CPU trainers and the
evaluation sweep against the JAX package's host path.

Small sizes: T = 2-3, 3 context rows and 3 queries, full 128 x 128 images
(the trunk needs them). Tolerances: float32 rtol/atol 1e-5
(``torch_port_common``); gradients ``GRAD_TOL``; the generator, the sampler
and the masks bit for bit. The trunks' first convolution is scaled x 3 so
that features are O(1) and a wrong flatten order shows as an O(1) error.
"""

import itertools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_port_aug import _jax_drop
from test_torch_port_fixed_order import _drop_fixed
from test_torch_port_pascal import _pascal_op_draws
from torch_port_common import (ATOL, GRAD_TOL, RTOL, jax_grads_as_port, t,
                               to_numpy)
from wmfml_tpu.aug import image_aug as jaug
from wmfml_tpu.aug.pipeline import build_episode_processor as jax_processor
from wmfml_tpu.ckpt.torch_import import (import_torch_checkpoint,
                                         state_dict_to_numpy)
from wmfml_tpu.configs import Config as JaxConfig
from wmfml_tpu.data import synthetic as jsynth
from wmfml_tpu.data.shapenet_distractor import \
    ShapeNetDistractor as JaxDistractor
from wmfml_tpu.losses.losses import LossFunc as JaxLossFunc
from wmfml_tpu.models.neural_process import LargeCNP as JaxLargeCNP
from wmfml_tpu.nn.attention import favor_attention as jax_favor
from wmfml_tpu.nn.encoders import ResNetTrunk as JaxTrunk
from wmfml_tpu.train.state import TrainState
from wmfml_tpu.train.steps import build_eval_step as jax_eval_step
from wmfml_tpu.train.steps import make_forward as jax_forward
from wmfml_tpu_torch.aug import image_aug as paug
from wmfml_tpu_torch.aug.pipeline import build_episode_processor
from wmfml_tpu_torch.ckpt.jax_params import load_jax_variables, trunk_state_dict
from wmfml_tpu_torch.configs import Config
from wmfml_tpu_torch.data import synthetic as psynth
from wmfml_tpu_torch.data.device_sampler import DeviceEpisodeSampler
from wmfml_tpu_torch.data.factory import build_data
from wmfml_tpu_torch.data.shapenet_distractor import ShapeNetDistractor
from wmfml_tpu_torch.eval.evaluator import ModelEvaluator
from wmfml_tpu_torch.kernels.favor import favor_plain
from wmfml_tpu_torch.losses.losses import LossFunc
from wmfml_tpu_torch.models.neural_process import LargeCNP
from wmfml_tpu_torch.models.registry import build_model
from wmfml_tpu_torch.nn.encoders import ResNetTrunk
from wmfml_tpu_torch.train.steps import build_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = os.path.join(REPO, "cfg", "train")
EVAL_YAML = os.path.join(REPO, "cfg", "evaluation", "CNP_max_Distractor.yaml")
# the shipped train YAMLs of the two ported methods
YAMLS = ["ANP_Distractor.yaml", "ANP_DA_Distractor.yaml",
         "ANP_TA_Distractor.yaml", "ANP_DA+TA_Distractor.yaml",
         "CNP_max_Distractor.yaml", "CNP_max_DA+TA_Distractor.yaml",
         "CNP_mean_DA+TA_Distractor.yaml", "CNP_baco_DA+TA_Distractor.yaml"]
HW = 128


def _close(got, want, err_msg="", tol=None):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or dict(rtol=RTOL, atol=ATOL)),
                               err_msg=err_msg)


def _images(seed, shape):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(np.uint8)


def _raw_episode(seed, t_=2, s=3, q=3, shots=(3, 1)):
    """A raw Distractor episode: uint8 images, pixel-centre labels."""
    rng = np.random.RandomState(seed)
    return dict(ctx_x=_images(seed, (t_, s, HW, HW, 1)),
                ctx_y=rng.uniform(24, 104, (t_, s, 2)).astype(np.float32),
                ctx_mask=np.arange(s)[None, :] < np.asarray(shots)[:, None],
                qry_x=_images(seed + 1, (t_, q, HW, HW, 1)),
                qry_y=rng.uniform(24, 104, (t_, q, 2)).astype(np.float32))


# -- the JAX package's Distractor draws, replayed as the port's parameters -----

def jax_distractor_params(key, b, h, w) -> paug.DAParams:
    """``build_augmenter("distractor")``'s draws for ``b`` images from
    ``key`` (the enumerated path, :547-565): the order, then the op at
    chain position s draws from per-image keys split from
    ``step_keys[s]``."""
    kperm, kops = jax.random.split(key)
    order = int(jax.random.randint(kperm, (), 0, 2))
    step_keys = jax.random.split(kops, 2)
    warp = np.zeros((b, 2, 7), np.float32)
    drop, words = np.zeros((b, 5), np.float32), np.zeros((b, 2), np.uint32)
    for s, op in enumerate(paug.DISTRACTOR_ORDERS[order]):
        keys = jax.random.split(step_keys[s], b)
        if op == paug.D_DROP:
            d, km = jax.vmap(_jax_drop)(keys)
            drop[:], words[:] = np.asarray(d), np.asarray(km)
        else:
            warp[:, 1] = np.asarray(jax.vmap(
                lambda k: _pascal_op_draws(paug.P_AFFINE, k, h, w))(keys))
    return paug.DAParams(order, t(warp), t(drop), t(words.view(np.int32)))


def jax_distractor_fixed_params(key, b, h, w) -> paug.DAParams:
    """``build_augmenter("distractor", random_order=False)``'s draws: one
    key per image, split into Affine's and the fixed dropout op's."""
    gh, gw = paug.fixed_grid(h, w)
    warp = np.zeros((b, 2, 7), np.float32)
    drop, words = np.zeros((b, 5), np.float32), np.zeros((b, 2), np.uint32)
    cells = np.zeros((b, gh, gw), bool)
    for i, k in enumerate(jax.random.split(key, b)):
        ka, kd = jax.random.split(k, 2)
        warp[i, 1] = np.asarray(_pascal_op_draws(paug.P_AFFINE, ka, h, w))
        d, km, low = _drop_fixed(kd, gh, gw)
        drop[i], words[i], cells[i] = np.asarray(d), np.asarray(km), low
    return paug.DAParams(None, t(warp), t(drop), t(words.view(np.int32)),
                         cells=t(cells))


def key_for_order(order: int):
    for seed in itertools.count():
        key = jax.random.PRNGKey(seed)
        if int(jax.random.randint(jax.random.split(key)[0], (), 0, 2)) == order:
            return key


def jax_process_draws(key, raw, random_order=True):
    """The DA parameters and TA shifts Distractor's ``process(key, batch)``
    draws (``wmfml_tpu/aug/pipeline.py:48-56, 99-112``)."""
    k_aug, k_ta = jax.random.split(key)
    k1, k2 = jax.random.split(k_aug)
    draw = jax_distractor_params if random_order else \
        jax_distractor_fixed_params
    da = tuple(draw(k, int(np.prod(raw[x].shape[:2])), HW, HW)
               for k, x in ((k1, "ctx_x"), (k2, "qry_x")))
    shift = jax.random.randint(k_ta, (raw["ctx_y"].shape[0], 1, 2), 0, 16)
    return da, t(np.asarray(shift))


# -- 1. data: the generator, the host sampler, the device sampler ----------------

def test_generator_arrays_equal_jax(tmp_path):
    assert psynth.GENERATORS["distractor"][0] == \
        jsynth.GENERATORS["distractor"][0] == "distractor"
    psynth.generate_distractor(str(tmp_path / "port"), objects_per_categ=2)
    jsynth.generate_distractor(str(tmp_path / "jax"), objects_per_categ=2)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names and len(names) == 12
    for name in names:
        got, want = (np.load(tmp_path / d / name, allow_pickle=True)
                     for d in ("port", "jax"))
        assert got.shape == want.shape == (2, 36, 4)
        for a, b in zip(got.reshape(-1, 4), want.reshape(-1, 4)):
            assert a[0].dtype == np.float32 and a[0].shape == (HW, HW, 1)
            assert np.array_equal(a[0], b[0]) and a[2] == b[2]
            assert np.array_equal(a[3], b[3])


@pytest.fixture(scope="module")
def distractor_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("distractor"))
    psynth.generate_distractor(root)
    return root


def _samplers(path, mode="train", max_ctx=15):
    common = dict(img_size=[HW, HW, 1], seed=42, max_ctx=max_ctx, mode=mode,
                  load_test_categ_only=mode == "eval")
    return ShapeNetDistractor(path, **common), JaxDistractor(path, **common)


def _assert_same_batch(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k


def test_sampler_draws_the_jax_episodes_in_train_validation_and_test(
        distractor_dir):
    """Train (shot ~ U[1, 15]), validation (the 80/20 cut of the shuffled
    train objects) and test: every episode equal, twice over, the test
    split re-permuting on every call."""
    port, jx = _samplers(distractor_dir)
    assert port.splits["train"]["n_items"] == 48
    assert port.splits["validation"]["n_items"] == 12
    assert port.splits["test"]["n_items"] == 12
    for split in ("train", "validation", "test"):
        assert np.array_equal(port.splits[split]["images"],
                              jx.splits[split]["images"])
    for source in ("train", "validation", "test", "test", "validation"):
        for _ in range(2):
            _assert_same_batch(port.get_batch(source, 3, 15),
                               jx.get_batch(source, 3, 15))
            for a, b in zip(port.get_batch_indices(source, 3, 15),
                            jx.get_batch_indices(source, 3, 15)):
                assert np.array_equal(a, b)
        port.reset_eval(source)
        jx.reset_eval(source)
    batch = port.get_batch("validation", 3, 15)
    assert batch["qry_x"].shape == (3, 18, HW, HW, 1)
    assert batch["ctx_y"].dtype == np.float32


def test_test_split_repermutes_and_resets_its_counter_every_call(
        distractor_dir):
    """The reference's quirk: each call draws a new permutation of the
    objects and starts at its head, so 20 tasks walk 12 objects and wrap."""
    port, jx = _samplers(distractor_dir)
    for _ in range(3):
        a, b = port._draw("test", 20, 5), jx._draw("test", 20, 5)
        assert all(np.array_equal(x, y) for x, y in zip(a[:2], b[:2]))
        assert sorted(a[0][:12]) == list(range(12))
        assert port.test_counter == jx.counters["test"] == 8


def test_eval_mode_reads_the_test_categories_and_queries_all_views(
        distractor_dir):
    port, jx = _samplers(distractor_dir, mode="eval", max_ctx=25)
    assert port.query_num == 36
    assert port.splits["train"]["n_items"] == 9      # the 80/20 cut of 12
    assert port.splits["validation"]["n_items"] == 2
    test_images = set(map(bytes, port.splits["test"]["images"].reshape(
        12 * 36, -1)))
    assert all(bytes(x) in test_images
               for x in port.splits["validation"]["images"].reshape(72, -1))
    for source in ("validation", "test"):
        for shot in (1, 25):
            port.reset_eval(source)
            jx.reset_eval(source)
            got = port.get_batch(source, 2, shot)
            _assert_same_batch(got, jx.get_batch(source, 2, shot))
            assert got["qry_x"].shape == (2, 36, HW, HW, 1)
            # the context views are the queries' first views
            assert np.array_equal(got["ctx_x"][:, :shot],
                                  got["qry_x"][:, :shot])


def test_factory_and_device_sampler_take_distractor(distractor_dir):
    cfg = Config(os.path.join(TRAIN, "ANP_DA+TA_Distractor.yaml"),
                 ["device=cpu", f"data_path={distractor_dir}"],
                 make_dirs=False)
    assert (cfg.query_num, cfg.img_size, cfg.input_dim, cfg.output_dim) == \
        (18, [HW, HW, 1], 2, 2)
    data = build_data(cfg)
    assert isinstance(data, ShapeNetDistractor) and data.query_num == 18
    assert build_data(cfg, mode="eval").query_num == 36
    sampler = DeviceEpisodeSampler.from_dataset(data, cfg, "cpu")
    assert (sampler.shot_min, sampler.label_scale) == (1, 1.0)
    assert tuple(sampler.x.shape) == (48, 36, HW, HW, 1)
    gen = torch.Generator().manual_seed(0)
    shots = set()
    for _ in range(40):
        ep = sampler.sample(3, gen)
        shots.add(int(ep["ctx_mask"][0].sum()))
    assert ep["ctx_x"].shape == (3, 15, HW, HW, 1)
    assert ep["qry_y"].shape == (3, 18, 2)
    assert min(shots) >= 1 and max(shots) <= 15 and len(shots) > 5
    # labels are the gathered views' pixel centres, unscaled
    x, y = sampler.x.reshape(-1, HW * HW), sampler.y.reshape(-1, 2)
    for img, lab in zip(ep["qry_x"].reshape(-1, HW * HW),
                        ep["qry_y"].reshape(-1, 2)):
        rows = (x == img).all(1).nonzero().flatten()
        assert any(torch.equal(y[r], lab) for r in rows)


# -- 2. image DA: programs 4 and 5, the episode processor --------------------------

@pytest.mark.parametrize("program,order", [("distractor", 0),
                                           ("distractor", 1),
                                           ("distractor_fixed", None)])
def test_distractor_programs_match_jax(program, order):
    """uint8 images through the twin (1 - x / 255, then Affine and the
    dropout op) against ``build_augmenter("distractor")`` on the inverted
    float images, with JAX's draws injected (the fixed grid's cells too)."""
    b, h, w = 6, 32, 32
    img = _images(7, (2, b // 2, h, w, 1))
    x = 1.0 - jnp.asarray(img, jnp.float32) / 255.0
    if order is None:
        key = jax.random.PRNGKey(11)
        params = jax_distractor_fixed_params(key, b, h, w)
        aug = jaug.build_augmenter("distractor", random_order=False)
    else:
        key = key_for_order(order)
        params = jax_distractor_params(key, b, h, w)
        assert params.order == order
        aug = jaug.build_augmenter("distractor")
    want = jax.jit(aug)(key, x)
    got = paug.Augmenter(program=program)(t(img), params=params)
    assert got.shape == img.shape and got.dtype == torch.float32
    _close(got, want)
    assert not np.allclose(np.asarray(want), 1.0 - img / 255.0)


def test_distractor_params_and_every_gate_off_are_the_inverted_image():
    """The twin reads Affine's row (1) and the dropout op's draw from the
    19 uniforms as K6 does; every gate off leaves 1 - x / 255 exactly."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randint(0, 256, (2, 3, 16, 16, 1), dtype=torch.uint8,
                      generator=gen)
    for program in ("distractor", "distractor_fixed"):
        aug = paug.build_augmenter("distractor",
                                   random_order=program == "distractor")
        assert aug.program == program and aug.nu == 19
        u, keys, order = aug.sample(6, gen, "cpu")
        assert (order is None) == (program == "distractor_fixed")
        p = paug.params_for(program, u, keys, order, 16, 16)
        assert torch.equal(p.warp,
                           paug.params_from_draw(u, keys, order, 16, 16).warp)
        assert paug.params_row(p).shape == (6, 23)
        u[:, 13:17] = 0.75
        from wmfml_tpu_torch.kernels.image_da import image_da
        assert torch.equal(image_da(x, u, keys, order, program=program),
                           1.0 - paug.to_unit(x))


@pytest.mark.parametrize("random_order", [True, False])
def test_process_matches_jax_in_training_and_evaluation(random_order):
    """Images inverted before DA, DA as two calls, shifts per (task,
    coordinate) mod 128, labels unscaled; evaluation inverts only."""
    raw = _raw_episode(5)
    key = jax.random.PRNGKey(21)
    aug = ["task_aug", "data_aug"]
    want = jax_processor("distractor", aug, train=True,
                         aug_random_order=random_order)(key, raw)
    da, shift = jax_process_draws(key, raw, random_order)
    assert shift.shape == (2, 1, 2)
    got = build_episode_processor("distractor", aug, train=True,
                                  aug_random_order=random_order)(
        {k: t(v) for k, v in raw.items()}, ta_idx=shift, da_params=da)
    for k in ("ctx_x", "qry_x", "ctx_y", "qry_y"):
        _close(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(
        got["qry_y"].numpy(),
        (raw["qry_y"] + shift.numpy().astype(np.float32)) % np.float32(128))
    ev = build_episode_processor("distractor", aug, train=False)
    assert ev.augment is None
    got = ev({k: t(v) for k, v in raw.items()})
    want = jax_processor("distractor", aug, train=False)(key, raw)
    for k in ("ctx_x", "qry_x", "ctx_y", "qry_y"):
        _close(got[k], want[k], err_msg=k)
    assert torch.equal(got["ctx_x"], 1.0 - paug.to_unit(t(raw["ctx_x"])))


# -- 3. the modules: trunk, LargeCNP, FAVOR at LargeCNP's width, the loss ----------

def _scaled(variables):
    """Variables with every trunk's first convolution x 3, so that the
    features are O(1)."""
    v = jax.tree_util.tree_map(np.array, variables)
    for node in (v["params"].get("img_encoder"),
                 v["params"].get("decoder", {}).get("trunk"), v["params"]):
        if node is not None and "conv1" in node:
            node["conv1"]["kernel"] *= 3.0
    return v


@pytest.mark.parametrize("img_agg", ["mean", "max", "baco", "reshape"])
def test_resnet_trunk_matches_jax(img_agg):
    x = np.random.RandomState(2).rand(3, HW, HW, 1).astype(np.float32)
    jm = JaxTrunk(img_agg=img_agg)
    variables = _scaled(to_numpy(jm.init(jax.random.PRNGKey(0), x)))
    want = np.asarray(jm.apply(variables, x))
    trunk = ResNetTrunk(img_agg, 1)
    trunk.load_state_dict(trunk_state_dict(variables["params"]), strict=True)
    with torch.no_grad():
        got = trunk(t(x)).numpy()
    if img_agg != "mean":       # JAX flattens HWC, the port CHW
        hw = 2 if img_agg in ("max", "baco") else HW // 32
        want = want.reshape(3, hw, hw, 64).transpose(0, 3, 1, 2).reshape(3, -1)
    assert got.shape == want.shape
    assert np.abs(want).max() > 0.5
    _close(got, want)


def _pair(agg_mode, img_agg="max", seed=0):
    """The JAX LargeCNP (Distractor's: label embedded to 16) and the port's
    with its weights, trunks scaled."""
    raw = _raw_episode(seed)
    jm = JaxLargeCNP(img_agg=img_agg, agg_mode=agg_mode, y_dim=2,
                     label_embed_dim=16)
    variables = _scaled(to_numpy(jm.init(
        jax.random.PRNGKey(seed), raw["ctx_x"] / 255.0, raw["ctx_y"],
        raw["qry_x"] / 255.0, ctx_mask=raw["ctx_mask"])))
    pm = LargeCNP(img_agg=img_agg, agg_mode=agg_mode, y_dim=2, label_dim=2,
                  label_embed_dim=16,
                  generator=torch.Generator().manual_seed(seed))
    return jm, load_jax_variables(pm, variables), variables


def _model_inputs(raw):
    x = {k: (1.0 - raw[k] / np.float32(255.0)).astype(np.float32)
         for k in ("ctx_x", "qry_x")}
    return x["ctx_x"], raw["ctx_y"], x["qry_x"], raw["ctx_mask"]


@pytest.mark.parametrize("agg_mode,img_agg", [
    ("mean", "max"), ("max", "max"), ("baco", "max"), ("attention", "max"),
    ("max", "reshape"), ("attention", "reshape")])
def test_large_cnp_forward_matches_jax(agg_mode, img_agg):
    """CNPDistractor (mean, max, baco) and ANPDistractor at the shipped
    ``img_agg: max``, and at ``reshape``, where every consumer of the
    trunk's flatten (task encoder, W_k, W_q, fc_mu) must be permuted; a
    task with one context row."""
    jm, pm, variables = _pair(agg_mode, img_agg)
    cx, cy, qx, mask = _model_inputs(_raw_episode(3))
    want = jm.apply(variables, cx, cy, qx, ctx_mask=mask)
    with torch.no_grad():
        got = pm(t(cx), t(cy), t(qx), ctx_mask=t(mask))
    assert got.mu.shape == (2, 3, 2)
    _close(got.mu, want.mu)
    _close(got.extras["sample_features"], want.extras["sample_features"])
    assert np.abs(np.asarray(want.mu)).max() > 0.1


def test_favor_twin_matches_jax_at_large_cnp_width():
    """d = e = 256, m = int(256 ln 256) = 1419, masked rows (the key
    maximum over them too) and a task with one real row."""
    rng = np.random.RandomState(4)
    q, k, v = (rng.randn(2, 2, n, 256).astype(np.float32) for n in (5, 4, 4))
    proj = (rng.randn(1419, 256) * 1.0).astype(np.float32)
    mask = np.array([[1, 1, 0, 0], [1, 0, 0, 0]], bool)
    want = jax_favor(q, k, v, proj, mask[:, None, :])
    got = favor_plain(t(q), t(k), t(v), t(proj), t(mask))
    _close(got, want)


def test_loss_matches_jax():
    rng = np.random.RandomState(6)
    gt = rng.uniform(0, 128, (2, 5, 2)).astype(np.float32)
    pr = rng.uniform(0, 128, (2, 5, 2)).astype(np.float32)
    mask = rng.rand(2, 5) > 0.3
    for test in (False, True):
        for m in (None, mask):
            want = JaxLossFunc("mse", "distractor").calc_loss(
                pr, None, gt, test=test, mask=m)
            got = LossFunc("mse", "distractor").calc_loss(
                t(pr), None, t(gt), test=test,
                mask=None if m is None else t(m))
            _close(got, want)
    np.testing.assert_allclose(
        float(LossFunc("mse", "distractor").calc_loss(t(pr), None, t(gt))),
        np.sqrt(((gt - pr) ** 2).sum(-1)).mean(), rtol=1e-6)


# -- 4. training steps, the weight carry both ways, the YAMLs, evaluation ----------

def _cfg(method, agg_mode, **extra):
    cfg = dict(method=method, task="distractor", agg_mode=agg_mode,
               img_agg="max", aug_list=["task_aug", "data_aug"], dim_w=16,
               tasks_per_batch=2, max_ctx_num=3, query_num=3, lr=1e-4,
               seed=0, loss_type="mse", optimizer="Adam", device="cpu")
    cfg.update(extra)
    return cfg


@pytest.mark.parametrize("method,agg_mode", [("ANPDistractor", "attention"),
                                             ("CNPDistractor", "max")])
def test_one_train_step_matches_jax(method, agg_mode):
    """One step with DA and TA on JAX's draws: the loss and every
    parameter's gradient."""
    cfg = _cfg(method, agg_mode)
    jcfg = JaxConfig.from_dict(cfg)
    jm, pm, variables = _pair(agg_mode, seed=1)
    pcfg = Config.from_dict(cfg)
    raw = _raw_episode(8)
    key = jax.random.PRNGKey(3)
    da, shift = jax_process_draws(jax.random.split(key)[0], raw)
    forward = jax_forward(jm, jcfg, train=True)
    extra = {k: v for k, v in variables.items() if k != "params"}

    def loss_fn(params):
        out, pbatch = forward({"params": params, **extra}, raw, key)
        return JaxLossFunc("mse", "distractor").calc_loss(
            out.mu.astype(jnp.float32), None, pbatch["qry_y"])

    want_loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        variables["params"])
    step = build_train_step(pm, torch.optim.SGD(pm.parameters(), lr=0.0),
                            pcfg)
    loss = step({k: t(v) for k, v in raw.items()}, ta_idx=shift,
                da_params=da)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=RTOL)
    want = jax_grads_as_port(pm, grads, variables)
    assert want.keys() == dict(pm.named_parameters()).keys()
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("method,agg_mode", [("ANPDistractor", "attention"),
                                             ("CNPDistractor", "max")])
def test_state_dict_round_trip_through_the_jax_importer(method, agg_mode):
    """The port's ``state_dict`` (the reference's keys and layouts) read by
    ``import_torch_checkpoint``: the JAX model computes what the port
    does."""
    pm = build_model(Config.from_dict(_cfg(method, agg_mode)))
    with torch.no_grad():
        pm.img_encoder.conv1.weight.mul_(3.0)
        pm.decoder.conv1.weight.mul_(3.0)
    variables = import_torch_checkpoint(
        method, state_dict_to_numpy(pm.state_dict()), img_agg="max")
    jm = JaxLargeCNP(img_agg="max", agg_mode=agg_mode, y_dim=2,
                     label_embed_dim=16)
    cx, cy, qx, mask = _model_inputs(_raw_episode(9))
    want = jm.apply(variables, cx, cy, qx, ctx_mask=mask)
    with torch.no_grad():
        got = pm(t(cx), t(cy), t(qx), ctx_mask=t(mask))
    _close(got.mu, want.mu)


@pytest.mark.parametrize("name", YAMLS)
def test_shipped_distractor_yaml_builds_a_cpu_trainer(name, distractor_dir,
                                                      tmp_path, monkeypatch):
    from wmfml_tpu_torch.cli import train_cli

    monkeypatch.chdir(tmp_path)
    cfg = Config(os.path.join(TRAIN, name),
                 ["device=cpu", f"data_path={distractor_dir}"])
    assert cfg.task == "distractor" and cfg.img_agg == "max"
    trainer = train_cli.build_trainer(cfg)
    model = trainer.model
    assert isinstance(model, LargeCNP)
    assert model.agg_mode == ("attention" if name.startswith("ANP")
                              else cfg.agg_mode)
    assert tuple(model.transform_y.weight.shape) == (16, 2)
    assert tuple(model.task_encoder[0].weight.shape) == (256, 256 + 16)
    process = build_episode_processor(cfg.task, cfg.aug_list, train=True)
    assert (process.augment is None) == ("data_aug" not in cfg.aug_list)
    if process.augment is not None:
        assert process.augment.program == "distractor"
    fixed = Config(os.path.join(TRAIN, name),
                   ["device=cpu", "aug_random_order=false"], make_dirs=False)
    if "data_aug" in fixed.aug_list:
        assert build_episode_processor(
            fixed.task, fixed.aug_list, train=True,
            aug_random_order=False).augment.program == "distractor_fixed"


def test_distractor_config_rules():
    """bfloat16 builds (ROADMAP.md A24: the model computes in bfloat16,
    its parameters float32); the ``s2d`` trunk stem and FCL raise."""
    yaml = os.path.join(TRAIN, "ANP_DA+TA_Distractor.yaml")
    cfg = Config(yaml, ["compute_dtype=bfloat16", "device=cpu"],
                 make_dirs=False)
    model = build_model(cfg)
    assert isinstance(model, LargeCNP) and cfg.compute_dtype == "bfloat16"
    assert model.img_encoder.compute_dtype == torch.bfloat16
    assert model.decoder.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with pytest.raises(NotImplementedError, match="ROADMAP.md B8b"):
        Config(yaml, ["trunk_stem=s2d"], make_dirs=False)
    # FCL (ROADMAP.md A13, done: it raised here before) builds, and gives
    # its views in training only
    fcl = LargeCNP(fcl=True, label_embed_dim=16,
                   generator=torch.Generator().manual_seed(0))
    x, y = torch.rand(2, 2, 128, 128, 1), torch.rand(2, 2, 2)
    with torch.no_grad():
        views = fcl.train()(x, y, x, qry_y=y).extras
        plain = fcl.eval()(x, y, x, qry_y=y).extras
    assert {"z_ctx_view", "z_qry_view"} <= set(views)
    assert not {"z_ctx_view", "z_qry_view"} & set(plain)
    assert Config(yaml, ["aug_random_order=false"],
                  make_dirs=False).aug_random_order is False


def test_evaluation_sweep_matches_the_jax_host_path(distractor_dir, tmp_path,
                                                    monkeypatch):
    """The shipped evaluation YAML (eval-mode data: validation from the test
    categories, all 36 views as queries) at 3 context points x 2 episodes,
    against the JAX package's host sweep (``_validate_iter``) on the same
    weights; both loss files written."""
    monkeypatch.chdir(tmp_path)
    overrides = ["device=cpu", f"data_path={distractor_dir}", "checkpoint=",
                 "max_ctx_num=3", "val_iters=2", "tasks_per_batch=2"]
    cfg = Config(EVAL_YAML, overrides)
    jcfg = JaxConfig(EVAL_YAML, overrides, make_dirs=False)
    jm, pm, variables = _pair("max", seed=2)
    val, test = ModelEvaluator(pm, cfg, build_data(cfg, mode="eval")).evaluate()
    jdata = JaxDistractor(distractor_dir, img_size=[HW, HW, 1], seed=42,
                          max_ctx=3, mode="eval", load_test_categ_only=True)
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
