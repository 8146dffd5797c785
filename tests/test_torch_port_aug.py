"""The port's image data augmentation against the JAX package, on the CPU.

The twins of ``wmfml_tpu/aug/image_aug.py`` (tent matrices, the warp
chain, the murmur3 masks), the whole ShapeNet1D augmenter for every one of
its six op orders, the DA + TA episode processor and one ANP train step with
DA. The JAX package draws its parameters from threefry keys; a helper here
replays its key derivation and hands the port the same draws
(``DAParams``). On the CPU the augmenter's K6 wrapper runs its plain twin
(``params_from_draw``, then the dense twins); the kernel is held against
the same twin on the card (``test_torch_port_cuda.py``, ``chip_smoke.py``).

Tolerances: warps rtol 1e-5 / atol 1e-5 (float32 sums of the same terms in
another order); hash masks bit for bit (integer arithmetic, two float32
steps done alike); the train step as ``test_torch_port_train.py``.
"""

import itertools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import ATOL, RTOL, WIDTHS, jax_grads_as_port, t, to_numpy
from wmfml_tpu.aug import image_aug as jaug
from wmfml_tpu.aug.pipeline import _to_float as jax_to_float
from wmfml_tpu.aug.pipeline import build_episode_processor as jax_processor
from wmfml_tpu.configs import Config as JaxConfig
from wmfml_tpu.models.registry import build_model as jax_build_model
from wmfml_tpu.train.state import TrainState, build_optimizer as jax_optimizer
from wmfml_tpu.train.steps import build_train_step as jax_train_step
from wmfml_tpu.train.steps import init_model as jax_init_model
from wmfml_tpu_torch.aug import image_aug as paug
from wmfml_tpu_torch.aug.pipeline import build_episode_processor
from wmfml_tpu_torch.ckpt.jax_params import load_jax_variables
from wmfml_tpu_torch.configs import Config
from wmfml_tpu_torch.kernels import image_da as kda
from wmfml_tpu_torch.models.registry import build_model
from wmfml_tpu_torch.train.state import build_optimizer
from wmfml_tpu_torch.train.steps import build_train_step
from torch_port_common import one_torch_thread  # noqa: F401

PERMS = list(itertools.permutations(range(3)))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _close(got, want, err_msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=err_msg)


# -- the JAX package's draws, replayed as the port's parameters -----------------

def _jax_drop(k):
    """``sometimes(one_of_dropout)``'s draws from one image key (:421-424,
    :372-375, dropout :302-304, coarse_dropout :329-333)."""
    kg, ko = jax.random.split(k)
    kc, kd = jax.random.split(ko)
    gate, pick = jax.random.bernoulli(kg, 0.5), jax.random.bernoulli(kc, 0.5)
    kp, km, kpc = jax.random.split(kd, 3)
    p_d = jax.random.uniform(kp, (), minval=0.01, maxval=0.1)
    pc_d = jax.random.bernoulli(kpc, 0.5)
    kp, ks, km2, kpc = jax.random.split(kd, 4)
    p_c = jax.random.uniform(kp, (), minval=0.0, maxval=0.05)
    sp = jax.random.uniform(ks, (), minval=0.02, maxval=0.25)
    pc_c = jax.random.bernoulli(kpc, 0.2)
    f = jnp.float32
    drop = jnp.stack([gate.astype(f), pick.astype(f), jnp.where(pick, p_d, p_c),
                      sp, jnp.where(pick, pc_d, pc_c).astype(f)])
    return drop, jnp.where(pick, km, km2)


def _warp_row(stage):
    near = stage["nearest"]
    return jnp.stack([stage["scale"][0], stage["scale"][1],
                      stage["translate"][0], stage["translate"][1],
                      stage["cval"],
                      jnp.float32(0) if near is None else near.astype(jnp.float32),
                      stage["gate"].astype(jnp.float32)])


def jax_da_params(key, b, h, w) -> paug.DAParams:
    """``build_augmenter("shapenet_1d")``'s draws for ``b`` images from
    ``key`` (:553-558): the order, then each chain position's per-image key
    drives the op at that position."""
    kperm, kops = jax.random.split(key)
    order = int(jax.random.randint(kperm, (), 0, 6))
    step_keys = jax.random.split(kops, 3)
    img_keys = jax.vmap(lambda k: jax.random.split(k, b))(step_keys)  # [3, B, 2]
    warp = np.zeros((b, 2, 7), np.float32)
    drop, words = np.zeros((b, 5), np.float32), np.zeros((b, 2), np.uint32)
    samplers = {paug.CROP: jaug._crop_stage, paug.AFFINE: jaug._affine_stage}
    for pos, op in enumerate(PERMS[order]):
        keys = img_keys[pos]
        if op == paug.DROP:
            d, km = jax.vmap(_jax_drop)(keys)
            drop[:], words[:] = np.asarray(d), np.asarray(km)
        else:
            rows = jax.vmap(lambda k: _warp_row(samplers[op](k, h, w)))(keys)
            warp[:, op] = np.asarray(rows)
    return paug.DAParams(order, t(warp), t(drop), t(words.view(np.int32)))


def _key_for_order(order: int):
    for seed in itertools.count():
        key = jax.random.PRNGKey(seed)
        if int(jax.random.randint(jax.random.split(key)[0], (), 0, 6)) == order:
            return key


def _stages(rng, n, b, h, w):
    """``n`` JAX stages per image ([b] leaves) alternating crop and affine,
    drawn by the JAX samplers themselves."""
    keys = jax.random.split(jax.random.PRNGKey(rng.randint(1 << 30)), n * b)
    samplers = (jaug._crop_stage, jaug._affine_stage)
    return [jax.vmap(lambda k: samplers[s % 2](k, h, w))(
        keys[s * b:(s + 1) * b]) for s in range(n)]


def _to_port(stage):
    return {k: (None if v is None else tuple(t(x) for x in v)
                if isinstance(v, tuple) else t(v)) for k, v in stage.items()}


# -- 1. tent matrices ------------------------------------------------------------

@pytest.mark.parametrize("case", ["bilinear", "nearest", "gate_off"])
def test_stage_matrices_match_jax(case):
    rng = np.random.RandomState(0)
    b, h, w = 5, 32, 24
    sx, sy = rng.uniform(0.8, 1.2, (2, b)).astype(np.float32)
    tx, ty = rng.uniform(-4, 4, (2, b)).astype(np.float32)
    nearest = np.full(b, case == "nearest") if case != "bilinear" else None
    gate = np.array([True, False, True, False, True]) if case == "gate_off" \
        else None

    def jax_one(i):
        return jaug._stage_matrices(
            h, w, (sx[i], sy[i]), (tx[i], ty[i]),
            None if nearest is None else jnp.asarray(nearest[i]),
            None if gate is None else jnp.asarray(gate[i]))

    wy, wx = paug.stage_matrices(
        h, w, (t(sx), t(sy)), (t(tx), t(ty)),
        None if nearest is None else t(nearest),
        None if gate is None else t(gate))
    for i in range(b):
        jy, jx = jax_one(i)
        np.testing.assert_array_equal(wy[i].numpy(), np.asarray(jy))
        np.testing.assert_array_equal(wx[i].numpy(), np.asarray(jx))
    src = rng.uniform(-3, h + 3, (b, h)).astype(np.float32)
    np.testing.assert_array_equal(
        paug.interp_matrix(h, t(src)).numpy(),
        np.asarray(jax.vmap(lambda s: jaug._interp_matrix(h, s))(src)))
    if case == "gate_off":             # the off-branch is the identity
        assert torch.equal(wy[1], torch.eye(h)) and torch.equal(wx[3], torch.eye(w))


# -- 2. warps ----------------------------------------------------------------------

@pytest.mark.parametrize("n_stages", [1, 2, 3])
def test_warp_chain_matches_jax(n_stages):
    rng = np.random.RandomState(n_stages)
    b, h, w, c = 6, 32, 32, 2
    img = rng.rand(b, h, w, c).astype(np.float32)
    stages = _stages(rng, n_stages, b, h, w)
    want = jax.vmap(jaug._warp_chain)(img, stages)
    got = paug.warp_chain(t(img), [_to_port(s) for s in stages])
    _close(got, want)


def test_affine_warp_matches_jax():
    rng = np.random.RandomState(7)
    b, h, w = 4, 32, 24
    img = rng.rand(b, h, w, 1).astype(np.float32)
    st = _to_port(_stages(rng, 2, b, h, w)[1])          # an affine stage
    want = jax.vmap(lambda im, s, tr, cv, nr: jaug._affine_warp(
        im, s, tr, cv, nearest=nr))(img, *(
            tuple(x.numpy() for x in st[k]) if isinstance(st[k], tuple)
            else st[k].numpy() for k in ("scale", "translate", "cval",
                                         "nearest")))
    got = paug.affine_warp(t(img), st["scale"], st["translate"], st["cval"],
                           st["nearest"])
    _close(got, want)


# -- 3. hash masks, bit for bit -----------------------------------------------------

def test_fmix32_and_hash_keep_are_bit_exact():
    rng = np.random.RandomState(3)
    ids = rng.randint(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    ids[:4] = [0, 1, 2 ** 31, 2 ** 32 - 1]
    np.testing.assert_array_equal(
        paug.fmix32(t(ids.astype(np.int64))).numpy(),
        np.asarray(jaug._fmix32(jnp.asarray(ids))).astype(np.int64))
    for key in ([0, 0], [2 ** 31 + 5, 17], [2 ** 32 - 1, 2 ** 31],
                list(rng.randint(0, 2 ** 32, 2, dtype=np.uint64))):
        key = np.asarray(key, np.uint32)
        for p in (0.0, 0.05, 0.5, 1.0):
            want = np.asarray(jaug._hash_keep(jnp.asarray(key),
                                              jnp.asarray(ids), p))
            got = paug.hash_keep(int(key[0]), int(key[1]),
                                 t(ids.astype(np.int64)), p)
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("op,c", [("dropout", 1), ("dropout", 3),
                                  ("coarse_dropout", 1),
                                  ("coarse_dropout", 3)])
def test_dropout_masks_are_bit_exact(op, c):
    b, h, w = 8, 32, 32
    keys = jax.random.split(jax.random.PRNGKey(11 + c), b)
    img = jnp.ones((h, w, c), jnp.float32)
    want = jax.vmap(lambda k: getattr(jaug, op)(k, img))(keys)
    # the draws dropout / coarse_dropout make from their own keys
    drop, words = [], []
    for k in keys:
        if op == "dropout":
            kp, km, kpc = jax.random.split(k, 3)
            p = jax.random.uniform(kp, (), minval=0.01, maxval=0.1)
            row = [1, 1, p, 0.1, jax.random.bernoulli(kpc, 0.5)]
        else:
            kp, ks, km, kpc = jax.random.split(k, 4)
            p = jax.random.uniform(kp, (), minval=0.0, maxval=0.05)
            sp = jax.random.uniform(ks, (), minval=0.02, maxval=0.25)
            row = [1, 0, p, sp, jax.random.bernoulli(kpc, 0.2)]
        drop.append(np.asarray([float(x) for x in row], np.float32))
        words.append(np.asarray(km))
    keep = paug.dropout_mask((b, h, w, c), t(np.stack(drop)),
                             t(np.stack(words).view(np.int32)))
    np.testing.assert_array_equal(keep.float().numpy(), np.asarray(want))
    assert 0 < float(keep.float().mean()) < 1


# -- 4. the whole augmenter, every order -------------------------------------------

def _images(seed, shape):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(np.uint8)


@pytest.mark.parametrize("order", range(6))
def test_augmenter_matches_jax_for_each_order(order):
    """uint8 images through the twin (x / 255, then the order) against the
    JAX package's ``_to_float``, then ``build_augmenter``."""
    b, h, w = 8, 32, 32
    key = _key_for_order(order)
    img = _images(order, (2, b // 2, h, w, 1))
    want = jaug.build_augmenter("shapenet_1d")(
        key, jax_to_float(jnp.asarray(img), jnp.float32))
    params = jax_da_params(key, b, h, w)
    assert params.order == order
    got = paug.ShapeNet1DAugmenter()(t(img), params=params)
    assert got.shape == img.shape and got.dtype == torch.float32
    _close(got, want)
    assert not np.allclose(np.asarray(want), img / 255.0)   # something applied


def test_augmenter_at_full_size_with_nearest_and_gates_mixed():
    key = _key_for_order(2)                       # affine + crop chained
    img = _images(1, (4, 128, 128, 1))
    params = jax_da_params(key, 4, 128, 128)
    _close(paug.ShapeNet1DAugmenter()(t(img), params=params),
           jaug.build_augmenter("shapenet_1d")(
               key, jax_to_float(jnp.asarray(img), jnp.float32)))


def test_kernel_order_table_is_orders_and_runs_group_adjacent_warps():
    """The order table compiled into K6 (``csrc/image_da.cu``) is
    ``ORDERS``, parsed from the source so that the two cannot drift; the
    twin's ``order_runs`` groups adjacent warps as ``perm_chain`` does."""
    path = os.path.join(REPO, "wmfml_tpu_torch", "csrc", "image_da.cu")
    with open(path) as f:
        body = re.search(r"ORDERS\[6\]\[3\]\s*=\s*\{(.*?)\};", f.read(),
                         re.S).group(1)
    table = tuple(tuple(int(v) for v in row) for row in
                  re.findall(r"\{\s*(\d+),\s*(\d+),\s*(\d+)\s*\}", body))
    assert table == paug.ORDERS == tuple(PERMS)
    runs = [paug.order_runs(o) for o in paug.ORDERS]
    assert runs[0] == [(0, 1), (2,)] and runs[1] == [(0,), (2,), (1,)]
    assert runs[4] == [(2,), (0, 1)] and runs[5] == [(2,), (1, 0)]


def _kernel_source():
    with open(os.path.join(REPO, "wmfml_tpu_torch", "csrc",
                           "image_da.cu")) as f:
        return f.read()


def test_twin_reads_the_order_modulo_six_as_the_kernel_does():
    assert "((a.order[0] % 6) + 6) % 6" in _kernel_source()
    gen = torch.Generator().manual_seed(6)
    x = torch.randint(0, 256, (4, 16, 16, 1), dtype=torch.uint8,
                      generator=gen)
    u, keys, _ = paug.ShapeNet1DAugmenter().sample(4, gen, "cpu")
    u[:, 13:17] = 0.25                             # every gate on
    for o in (-7, -1, 6, 7, 11):
        assert torch.equal(kda.image_da_plain(x, u, keys, torch.tensor([o])),
                           kda.image_da_plain(x, u, keys,
                                              torch.tensor([o % 6])))


def test_coarse_dropout_grid_fits_the_kernels_cell_table():
    """K6 keeps one keep bit per CoarseDropout cell in a table of
    (H/4 + 1) (W/4 + 1) entries (``layout``'s ``cap``): the grid at the
    largest size fraction the draw gives (u = 1 - 2^-24, just below 0.25)
    fits for every shape the kernel takes."""
    assert "L.cap = (H / 4 + 1) * (W / 4 + 1);" in _kernel_source()
    u, keys = torch.zeros((1, 19)), torch.zeros((1, 2), dtype=torch.int32)
    u[:, 12] = 1.0 - 2.0 ** -24
    for h in range(1, 257):
        for w in range(4, 129, 4):
            sp = paug.params_from_draw(u, keys, 0, h, w).drop[0, 3]
            grid = (torch.clamp_min(torch.round(h * sp), 1.0)
                    * torch.clamp_min(torch.round(w * sp), 1.0))
            assert 0.2499 < float(sp) < 0.25
            assert int(grid) <= (h // 4 + 1) * (w // 4 + 1), (h, w)


def test_store_layout_probe_still_applies_to_the_kernel():
    """``kernels/image_da_probe.py`` builds its float4-store variant from
    the shipped source by text substitution; each must still match once."""
    from wmfml_tpu_torch.kernels import image_da_probe

    src = _kernel_source()
    for old, new in image_da_probe.SUBSTITUTIONS:
        assert src.count(old) == 1 and new not in src


def test_to_unit_is_a_true_division_where_a_reciprocal_product_is_not():
    """x / 255 as JAX's ``_to_float`` rounds it; the card's ``x / 255.0``
    (a CUDA tensor divided by a Python scalar) multiplies by the float32
    reciprocal instead, which misses the quotient for 126 of the 256
    values, so the twin divides through a tensor."""
    x = np.arange(256, dtype=np.uint8)
    want = np.asarray(jax_to_float(jnp.asarray(x), jnp.float32))
    np.testing.assert_array_equal(paug.to_unit(t(x)).numpy(), want)
    product = x.astype(np.float32) * (np.float32(1) / np.float32(255))
    assert int((product != want).sum()) == 126


def test_cpu_image_da_takes_the_twin_and_counts_no_launch():
    gen = torch.Generator().manual_seed(4)
    x = torch.randint(0, 256, (2, 3, 16, 16, 1), dtype=torch.uint8,
                      generator=gen)
    u, keys, order = paug.ShapeNet1DAugmenter().sample(6, gen, "cpu")
    before = kda.image_da.launches
    got = kda.image_da(x, u, keys, order)
    assert kda.image_da.launches == before
    params = paug.params_from_draw(u, keys, order, 16, 16)
    want = paug.apply(paug.to_unit(x.reshape(6, 16, 16, 1)), params)
    assert torch.equal(got, want.reshape(x.shape))
    # injected parameters are for the CPU only
    with pytest.raises(ValueError, match="CPU only"):
        paug.ShapeNet1DAugmenter()(x.to("meta"), params=params)


# -- 5. the episode processor with DA and TA --------------------------------------

def _raw_episode(seed, t_=2, s=4, q=3, hw=32):
    rng = np.random.RandomState(seed)
    return dict(
        ctx_x=rng.randint(0, 255, (t_, s, hw, hw, 1)).astype(np.uint8),
        ctx_y=rng.uniform(0, 2 * np.pi, (t_, s, 1)).astype(np.float32),
        ctx_mask=np.arange(s)[None, :].repeat(t_, 0) < 3,
        qry_x=rng.randint(0, 255, (t_, q, hw, hw, 1)).astype(np.uint8),
        qry_y=rng.uniform(0, 2 * np.pi, (t_, q, 1)).astype(np.float32))


def _jax_process_draws(key, raw):
    """The DA parameters and TA offsets ``process(key, batch)`` draws
    (``wmfml_tpu/aug/pipeline.py:48-69``)."""
    k_aug, k_ta = jax.random.split(key)
    k1, k2 = jax.random.split(k_aug)
    hw = raw["ctx_x"].shape[2:4]
    da = tuple(jax_da_params(k, int(np.prod(raw[x].shape[:2])), *hw)
               for k, x in ((k1, "ctx_x"), (k2, "qry_x")))
    t_ = raw["ctx_y"].shape[0]
    ta = np.asarray(jax.random.randint(k_ta, (t_, 1, 1), 0, 15)).ravel()
    return da, t(ta)


def test_da_and_ta_episode_processor_matches_jax():
    raw = _raw_episode(5)
    key = jax.random.PRNGKey(21)
    want = jax_processor("shapenet_1d", ["task_aug", "data_aug"],
                         train=True)(key, raw)
    da, ta = _jax_process_draws(key, raw)
    got = build_episode_processor("shapenet_1d", ["task_aug", "data_aug"],
                                  train=True)(
        {k: t(v) for k, v in raw.items()}, ta_idx=ta, da_params=da)
    for k in ("ctx_x", "qry_x", "ctx_y", "qry_y"):
        _close(got[k], want[k], err_msg=k)
    # evaluation does not augment
    plain = build_episode_processor("shapenet_1d", ["data_aug"], train=False)
    assert plain.augment is None


# -- 6. one ANP train step with DA ------------------------------------------------

def test_one_train_step_with_da_matches_jax():
    t_, s, q = 2, 4, 3
    cfg = dict(method="ANPShapeNet1D", task="shapenet_1d", agg_mode="attention",
               aug_list=["task_aug", "data_aug"], tasks_per_batch=t_,
               max_ctx_num=s, query_num=q, dim_w=WIDTHS["dim_w"],
               dim_r=WIDTHS["dim_r"], dim_z=WIDTHS["dim_z"],
               n_hidden_units_r=list(WIDTHS["n_hidden_units_r"]), lr=1e-4,
               seed=0, loss_type="mse", optimizer="Adam", device="cpu")
    jcfg = JaxConfig.from_dict(cfg)
    jmodel = jax_build_model(jcfg)
    variables = to_numpy(jax_init_model(jmodel, jcfg, jax.random.PRNGKey(1)))
    pcfg = Config.from_dict(cfg)
    model = load_jax_variables(build_model(pcfg), variables)
    raw = _raw_episode(8, t_, s, q, hw=128)
    key = jax.random.PRNGKey(3)
    da, ta = _jax_process_draws(jax.random.split(key)[0], raw)

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


# -- 7. the port's own sampler, by distribution ---------------------------------------

def test_sampler_distributions():
    aug = paug.ShapeNet1DAugmenter()
    gen = torch.Generator().manual_seed(0)
    n, h, w = 4000, 128, 96
    u, keys, order = aug.sample(n, gen, "cpu")
    assert u.shape == (n, 19) and keys.shape == (n, 2) and order.shape == (1,)
    p = paug.params_from_draw(u, keys, order, h, w)
    assert p.warp.shape == (n, 2, 7) and p.drop.shape == (n, 5)
    assert p.keys.dtype == torch.int32 and bool((p.keys < 0).any())
    sx, sy, tx, ty, cval, nearest, gate = p.warp.unbind(-1)
    for rate in (gate[:, 0], gate[:, 1], nearest[:, 1], p.drop[:, 0],
                 p.drop[:, 1]):
        assert abs(float(rate.mean()) - 0.5) < 0.04
    assert bool((nearest[:, 0] == 0).all())
    # CropAndPad: scale 1 / (1 + two pads in [0, .05)), shift toward the
    # more padded side, at most a half pad of the size
    assert float(sx[:, 0].min()) > 1 / 1.1 and float(sx[:, 0].max()) <= 1
    assert float(tx[:, 0].abs().max()) < 0.05 * w / 2
    assert float(ty[:, 0].abs().max()) < 0.05 * h / 2
    # Affine: scale [.8, 1.2), translate +-10% of the size
    for v in (sx[:, 1], sy[:, 1]):
        assert 0.8 <= float(v.min()) and float(v.max()) < 1.2
    assert float(tx[:, 1].abs().max()) <= 0.1 * w + 1e-4
    assert float(ty[:, 1].abs().max()) <= 0.1 * h + 1e-4
    assert 0 <= float(cval.min()) and float(cval.max()) < 1
    pick = p.drop[:, 1] > 0.5
    rate, sp, pc = p.drop[:, 2], p.drop[:, 3], p.drop[:, 4]
    assert 0.01 <= float(rate[pick].min()) and float(rate[pick].max()) < 0.1
    assert float(rate[~pick].max()) < 0.05
    assert 0.02 <= float(sp.min()) and float(sp.max()) < 0.25
    assert abs(float(pc[pick].mean()) - 0.5) < 0.05
    assert abs(float(pc[~pick].mean()) - 0.2) < 0.05
    # the order: uniform over the six, one per call, from the same generator
    # 1200 calls, each count within 4.6 sigma of 200
    counts = torch.bincount(torch.cat([aug.sample(1, gen, "cpu")[2]
                                       for _ in range(1200)]), minlength=6)
    assert counts.shape == (6,) and int((counts - 200).abs().max()) < 60
    a = aug.sample(3, torch.Generator().manual_seed(5), "cpu")
    b = aug.sample(3, torch.Generator().manual_seed(5), "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_augmenter_keeps_hash_masks_and_warps_in_range():
    aug = paug.ShapeNet1DAugmenter()
    gen = torch.Generator().manual_seed(3)
    img = torch.randint(0, 256, (2, 8, 32, 32, 1), dtype=torch.uint8,
                        generator=gen)
    out = aug(img, gen)
    assert out.shape == img.shape and out.dtype == torch.float32
    assert bool(torch.isfinite(out).all())
    assert float(out.min()) >= -1e-6 and float(out.max()) <= 1 + 1e-6
