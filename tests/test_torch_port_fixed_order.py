"""The port's fixed-order DA pipeline (``aug_random_order: false``) against
the JAX package, on the CPU.

``geometric`` (CropAndPad and Affine as one warp with composed parameters),
the fixed 16-pixel grid of CoarseDropout and ``FUSED_PIPELINES`` of
ShapeNet1D and Pascal1D (K6's ``shapenet_1d_fixed`` and
``pascal_1d_fixed`` programs) with JAX's draws replayed as ``DAParams``;
the grid's keep rate and cell independence where the port hashes its bits;
the parameters the augmenter draws, by distribution; the shipped perf YAMLs
building and selecting the fixed program; the fused K-step call of P3
(bf16, fixed order) against K single steps.

The JAX package draws the fixed grid's bits with ``bernoulli``; the port
(and K6) hashes (key words, cell id) as CoarseDropout does: the same
distribution, other bits. The parity tests inject JAX's bits (``cells``),
so they show the upsampling exactly.

Tolerances: float32 rtol/atol 1e-5; the masks bit for bit; bfloat16 by the
rule of ``test_torch_port_bf16.py``, the JAX references compiled with
``xla_allow_excess_precision`` off.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_bf16 import _as_written, assert_bf16_close
from test_torch_port_pascal import _close, _images, _pascal_op_draws
from torch_port_common import t
from wmfml_tpu.aug import image_aug as jaug
from wmfml_tpu.aug.pipeline import _to_float as jax_to_float
from wmfml_tpu_torch.aug import image_aug as paug
from wmfml_tpu_torch.aug.pipeline import build_episode_processor
from wmfml_tpu_torch.configs import Config
from wmfml_tpu_torch.data.device_sampler import DeviceEpisodeSampler
from wmfml_tpu_torch.kernels import image_da as kda
from wmfml_tpu_torch.models.registry import build_model
from wmfml_tpu_torch.train.state import build_optimizer
from wmfml_tpu_torch.train.steps import (build_device_data_train_step,
                                         build_train_step)
from torch_port_common import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PERF = os.path.join(REPO, "cfg", "train", "perf")
BF16, F32 = jnp.bfloat16, jnp.float32


# -- the JAX package's fixed-order draws, replayed as the port's parameters -----------

def _geometric_row(k, h, w):
    """``geometric``'s (:386-417) one warp from its key, as JAX composes
    it."""
    k1, k2, ks, kt, kp_, kc = jax.random.split(k, 6)
    pad = jax.random.uniform(kp_, (), minval=0.0, maxval=0.05)
    s1 = jnp.where(jax.random.bernoulli(k1, 0.5), 1.0 / (1.0 + 2.0 * pad),
                   1.0)
    sxy = jax.random.uniform(ks, (2,), minval=0.8, maxval=1.2)
    txy = (jax.random.uniform(kt, (2,), minval=-0.1, maxval=0.1)
           * jnp.array([w, h], jnp.float32))
    g2 = jax.random.bernoulli(k2, 0.5)
    sxy, txy = jnp.where(g2, sxy, 1.0), jnp.where(g2, txy, 0.0)
    return jnp.stack([s1 * sxy[0], s1 * sxy[1], txy[0], txy[1],
                      jax.random.uniform(kc, ()), jnp.float32(0),
                      jnp.float32(1)])


def _drop_fixed(k, gh, gw):
    """``sometimes(one_of_dropout_fixed)``'s draws (:456, :378-383): the
    drop row, the Dropout key words and the fixed grid's bits."""
    kg, ko = jax.random.split(k)
    kc, kd = jax.random.split(ko)
    gate, pick = jax.random.bernoulli(kg, 0.5), jax.random.bernoulli(kc, 0.5)
    kp, km, kpc = jax.random.split(kd, 3)
    p_d = jax.random.uniform(kp, (), minval=0.01, maxval=0.1)
    pc_d = jax.random.bernoulli(kpc, 0.5)
    kp2, km2 = jax.random.split(kd)
    p_c = jax.random.uniform(kp2, (), minval=0.0, maxval=0.05)
    low = jax.random.bernoulli(km2, 1 - p_c, (gh, gw, 1))[..., 0]
    f = jnp.float32
    drop = jnp.stack([gate.astype(f), pick.astype(f),
                      jnp.where(pick, p_d, p_c), f(0),
                      jnp.where(pick, pc_d, False).astype(f)])
    return drop, km, low


def jax_fixed_params(key, b, h, w, task) -> paug.DAParams:
    """``build_augmenter(task, random_order=False)``'s draws for ``b``
    images (:578-580, :502-508): one key per image, split into one per op
    of ``FUSED_PIPELINES[task]``."""
    n = 4 if task == "pascal_1d" else 2
    gh, gw = paug.fixed_grid(h, w)
    img_keys = jax.random.split(key, b)
    warp = np.zeros((b, 2, 7), np.float32)
    pixel = np.zeros((b, 4), np.float32)
    drop, words = np.zeros((b, 5), np.float32), np.zeros((b, 2), np.uint32)
    cells = np.zeros((b, gh, gw), bool)
    for i in range(b):
        ks = jax.random.split(img_keys[i], n)
        warp[i, 0] = np.asarray(_geometric_row(ks[0], h, w))
        if n == 4:
            pixel[i, :2] = np.asarray(_pascal_op_draws(paug.P_GAMMA, ks[1],
                                                       h, w))
            pixel[i, 2:] = np.asarray(_pascal_op_draws(paug.P_BLUR, ks[2],
                                                       h, w))
        d, km, low = _drop_fixed(ks[-1], gh, gw)
        drop[i], words[i], cells[i] = np.asarray(d), np.asarray(km), low
    return paug.DAParams(None, t(warp), t(drop), t(words.view(np.int32)),
                         pixel=t(pixel) if n == 4 else None, cells=t(cells))


def _fixed_augmenter(task, dtype=torch.float32):
    return paug.build_augmenter(task, dtype, random_order=False)


# -- 1. geometric and the fixed pipelines ----------------------------------------------

def test_geometric_matches_jax():
    b, h, w = 8, 32, 24
    img = np.random.RandomState(2).rand(b, h, w, 1).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(4), b)
    want = jax.vmap(jaug.geometric)(keys, img)
    rows = t(np.asarray(jax.vmap(lambda k: _geometric_row(k, h, w))(keys)))
    got = paug._warp_op(t(img), rows)
    _close(got, want)
    assert not np.allclose(np.asarray(want), img)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("task", ["shapenet_1d", "pascal_1d"])
def test_fixed_pipeline_matches_jax(task, dtype):
    """uint8 images through the twin (x / 255, then ``FUSED_PIPELINES``)
    against ``_to_float``, then ``build_augmenter(task,
    random_order=False)``, with JAX's draws (the grid's bits too)
    injected."""
    b, h, w = 8, 32, 32
    key = jax.random.PRNGKey(11)
    img = _images(3, (2, b // 2, h, w, 1))
    params = jax_fixed_params(key, b, h, w, task)
    assert bool((params.drop[:, 0] > 0.5).any())
    assert bool((params.drop[:, 1] < 0.5).any())      # a fixed grid drawn
    jdt = BF16 if dtype == "bfloat16" else F32
    aug = jax.jit(jaug.build_augmenter(task, random_order=False))
    want = _as_written(aug, key, jax_to_float(jnp.asarray(img), jdt))
    got = _fixed_augmenter(task, getattr(torch, dtype))(t(img),
                                                        params=params)
    assert got.shape == img.shape and got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        _close(got, want)
    else:
        want_f32 = aug(key, jax_to_float(jnp.asarray(img), F32))
        assert_bf16_close(got, want, want_f32, f"{task} fixed")
    # the masks equal JAX's bit for bit: zero exactly where JAX zeroed
    zero = np.asarray(want.astype(F32)) == 0
    assert np.array_equal(got.float().numpy() == 0, zero)


@pytest.mark.parametrize("h,w", [(32, 32), (128, 128), (48, 40), (16, 8)])
def test_fixed_grid_upsamples_injected_bits_as_jnp_repeat(h, w):
    gh, gw = paug.fixed_grid(h, w)
    assert (gh, gw) == (max(h // 16, 1), max(w // 16, 1))
    rng = np.random.RandomState(h + w)
    low = rng.rand(3, gh, gw) < 0.5
    want = np.stack([np.repeat(np.repeat(lo, h // gh, 0), w // gw, 1)
                     for lo in low])
    drop = torch.tensor([[1.0, 0.0, 0.5, 0.0, 0.0]] * 3)      # the grid on
    keep = paug.dropout_mask_fixed((3, h, w, 2), drop,
                                   torch.zeros((3, 2), dtype=torch.int32),
                                   cells=t(low))
    assert keep.shape == (3, h, w, 2)
    np.testing.assert_array_equal(keep[..., 0].numpy(), want)
    np.testing.assert_array_equal(keep[..., 1].numpy(), want)


def test_fixed_grid_that_does_not_divide_the_image_raises():
    """``jnp.repeat`` of a 3 x 3 grid of 16 x 16 cells is 48 x 48: a 50 x
    50 image does not broadcast against it in the JAX package, and the
    port raises (K6 refuses the shape too)."""
    with pytest.raises(ValueError, match="does not divide"):
        paug.fixed_grid(50, 48)


def test_hashed_grid_keeps_cells_at_one_minus_p_independently():
    """Where the port hashes the grid's bits: each cell keeps with
    probability 1 - p, one bit for all its pixels, cells independent
    (neighbours' bits uncorrelated)."""
    b, h, w, p = 4000, 64, 64, 0.3
    gen = torch.Generator().manual_seed(0)
    keys = torch.randint(-2 ** 31, 2 ** 31, (b, 2), dtype=torch.int32,
                         generator=gen)
    drop = torch.tensor([[1.0, 0.0, p, 0.0, 0.0]]).expand(b, 5)
    keep = paug.dropout_mask_fixed((b, h, w, 1), drop, keys)[..., 0]
    cells = keep[:, ::16, ::16].float()                    # [b, 4, 4]
    # one bit per 16 x 16 cell
    assert torch.equal(keep.float(), cells.repeat_interleave(16, 1)
                       .repeat_interleave(16, 2))
    rate = float(cells.mean())                             # 64000 cells
    assert abs(rate - (1 - p)) < 0.01
    c = cells.reshape(b, 16) - rate
    for a, z in ((0, 1), (0, 4), (5, 6), (0, 15)):
        corr = float((c[:, a] * c[:, z]).mean()) / (rate * (1 - rate))
        assert abs(corr) < 0.05, (a, z, corr)
    # different keys, different grids
    assert not torch.equal(keep[0], keep[1])


def test_fixed_programs_draw_their_parameters_by_distribution():
    n, h, w = 6000, 128, 96
    gen = torch.Generator().manual_seed(1)
    for task in ("shapenet_1d", "pascal_1d"):
        aug = _fixed_augmenter(task)
        u, keys, order = aug.sample(n, gen, "cpu")
        assert order is None and u.shape == (n, aug.nu)
        p = paug.params_for(aug.program, u, keys, None, h, w)
        sx, sy, tx, ty, cval, nearest, gate = p.warp[:, 0].unbind(-1)
        assert bool((gate == 1).all() and (nearest == 0).all())
        assert bool((p.warp[:, 1] == 0).all())
        crop, aff = u[:, 13] < 0.5, u[:, 14] < 0.5
        # s = s1 s_affine: s1 = 1 / (1 + 2 pad) in (1/1.1, 1]
        both_off = ~crop & ~aff
        assert bool((sx[both_off] == 1).all() and (tx[both_off] == 0).all())
        s1 = sx[crop & ~aff]
        assert 1 / 1.1 < float(s1.min()) and float(s1.max()) <= 1
        assert bool(torch.equal(sx[crop & ~aff], sy[crop & ~aff]))
        sa = sx[aff & ~crop]
        assert 0.8 <= float(sa.min()) and float(sa.max()) < 1.2
        assert float(tx[aff].abs().max()) <= 0.1 * w + 1e-4
        assert float(ty[aff].abs().max()) <= 0.1 * h + 1e-4
        assert float(tx[~aff].abs().max()) == 0
        assert 0.8 / 1.1 < float(sx.min()) and float(sx.max()) < 1.2
        assert 0 <= float(cval.min()) and float(cval.max()) < 1
        for rate in (crop.float(), aff.float(), p.drop[:, 0], p.drop[:, 1]):
            assert abs(float(rate.mean()) - 0.5) < 0.03
        pick = p.drop[:, 1] > 0.5
        assert float(p.drop[~pick, 2].max()) < 0.05
        assert p.pixel.shape == (n, 4)
        if task == "shapenet_1d":
            assert bool((p.pixel == 0).all())
        assert paug.params_row(p).shape == (n, kda.nparams(aug.program))


def test_cpu_image_da_runs_the_fixed_twins_and_counts_no_launch():
    gen = torch.Generator().manual_seed(4)
    x = torch.randint(0, 256, (2, 3, 32, 32, 1), dtype=torch.uint8,
                      generator=gen)
    for task in ("shapenet_1d", "pascal_1d"):
        aug = _fixed_augmenter(task)
        u, keys, _ = aug.sample(6, gen, "cpu")
        before = dict(kda.image_da.program_launches)
        got = kda.image_da(x, u, keys, None, program=aug.program)
        assert kda.image_da.program_launches == before
        p = paug.params_for(aug.program, u, keys, None, 32, 32)
        want = paug.apply_fixed(paug.to_unit(x.reshape(6, 32, 32, 1)), p,
                                task == "pascal_1d")
        assert torch.equal(got, want.reshape(x.shape))
        assert torch.equal(aug(x, torch.Generator().manual_seed(9)),
                           aug(x, torch.Generator().manual_seed(9)))


def test_kernel_program_table_is_the_wrappers():
    with open(os.path.join(REPO, "wmfml_tpu_torch", "csrc",
                           "image_da.cu")) as f:
        src = f.read()
    body = re.search(r"enum Program \{(.*?)\};", src, re.S).group(1)
    names = re.findall(r"([A-Z0-9_]+) = (\d)", body)
    assert names.pop() == ("NPROGRAMS", str(len(kda.PROGRAMS)))
    want = {"shapenet_1d": "SHAPENET1D", "pascal_1d": "PASCAL",
            "shapenet_1d_fixed": "SHAPENET1D_FIXED",
            "pascal_1d_fixed": "PASCAL_FIXED", "distractor": "DISTRACTOR",
            "distractor_fixed": "DISTRACTOR_FIXED",
            "shapenet_3d": "SHAPENET3D",
            "shapenet_3d_fixed": "SHAPENET3D_FIXED"}
    assert names == [(want[p], str(i)) for i, p in enumerate(kda.PROGRAMS)]
    assert kda.PROGRAM_NU == {"shapenet_1d": 19, "pascal_1d": 23,
                              "shapenet_1d_fixed": 19, "pascal_1d_fixed": 23,
                              "distractor": 19, "distractor_fixed": 19,
                              "shapenet_3d": 25, "shapenet_3d_fixed": 25}
    nu = int(re.search(r"constexpr int NU = (\d+);", src).group(1))
    with open(os.path.join(REPO, "wmfml_tpu_torch", "csrc",
                           "pixel_ops.cuh")) as f:
        nx = int(re.search(r"constexpr int NX = (\d+);", f.read()).group(1))
    nb = int(re.search(r"constexpr int NB = (\d+);", src).group(1))
    assert (nu, nu + nx, nu + nx + nb) == (kda.NU, kda.NU_PIXEL, kda.NU_RGB)
    assert kda.PROGRAM_ORDERS == {"shapenet_1d": len(paug.ORDERS),
                                  "pascal_1d": len(paug.PASCAL_ORDERS),
                                  "shapenet_1d_fixed": 1,
                                  "pascal_1d_fixed": 1,
                                  "distractor": len(paug.DISTRACTOR_ORDERS),
                                  "distractor_fixed": 1,
                                  "shapenet_3d": len(paug.SHAPENET3D_ORDERS),
                                  "shapenet_3d_fixed": 1}


# -- 2. configs and the perf YAMLs ----------------------------------------------------

@pytest.mark.parametrize("name", ["ANP_DA+TA_ShapeNet1D_tpu.yaml",
                                  "ANP_DA+TA_ShapeNet1D_tpu_T40.yaml"])
def test_perf_yaml_builds_and_selects_the_fixed_program(name):
    cfg = Config(os.path.join(PERF, name), ["device=cpu"], make_dirs=False)
    assert cfg.aug_random_order is False and cfg.compute_dtype == "bfloat16"
    assert cfg.steps_per_call == 64
    process = build_episode_processor(cfg.task, cfg.aug_list, train=True,
                                      dtype=torch.bfloat16,
                                      aug_random_order=cfg.aug_random_order)
    assert isinstance(process.augment, paug.Augmenter)
    assert process.augment.program == "shapenet_1d_fixed"
    assert process.augment.dtype == torch.bfloat16
    model = build_model(cfg)
    build_train_step(model, torch.optim.Adam(model.parameters()), cfg)


def test_pascal_fixed_order_config_selects_its_program():
    cfg = Config(os.path.join(REPO, "cfg", "train", "ANP_DA+TA_Pascal1D.yaml"),
                 ["device=cpu", "aug_random_order=false"], make_dirs=False)
    process = build_episode_processor(cfg.task, cfg.aug_list, train=True,
                                      aug_random_order=cfg.aug_random_order)
    assert process.augment.program == "pascal_1d_fixed"
    assert process.augment.nu == 23


@pytest.mark.parametrize("task,item", [("distractor", "A12b"),
                                       ("shapenet_3d", "A12c")])
def test_fixed_order_for_unported_tasks_raises_naming_the_slice(task, item):
    """Distractor's and ShapeNet3D's fixed-order pipelines (their slices,
    A12b and A12c, now done) build their fixed programs. (The name and
    cases are from when both raised; they are kept so that the test's
    record runs on.)"""
    cfg = dict(method="ANPShapeNet1D", task=task, tasks_per_batch=2,
               max_ctx_num=4, lr=1e-4, seed=0, device="cpu",
               aug_random_order=False)
    assert Config.from_dict(cfg).aug_random_order is False
    assert paug.build_augmenter(task, random_order=False).program == \
        f"{task}_fixed"
    assert item in ("A12b", "A12c")


def test_fused_call_equals_k_single_steps_on_p3():
    """P3's fused call (the perf YAML: bfloat16, fixed-order DA, task
    augmentation; K = 3 here) against three single steps on the same
    draws, bit for bit."""
    cfg = Config(os.path.join(PERF, "ANP_DA+TA_ShapeNet1D_tpu.yaml"),
                 ["device=cpu", "tasks_per_batch=2", "max_ctx_num=3",
                  "dim_w=16", "dim_r=12", "dim_z=8"], make_dirs=False)
    cfg.img_size = [32, 32, 1]
    rng = np.random.RandomState(1)
    sampler = DeviceEpisodeSampler(
        rng.randint(0, 255, (4, 7, 32, 32, 1)).astype(np.uint8),
        rng.rand(4, 7, 1).astype(np.float32), max_ctx=3, query=3, shot_min=2,
        label_scale=2 * np.pi, device="cpu")
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
