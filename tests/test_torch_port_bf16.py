"""``compute_dtype: bfloat16`` in the port against the JAX package, on the CPU.

Each module that holds a kernel, through its plain twin (what a CPU tensor
takes): the stem (K1, shared and per task), the FAVOR+ core (K2), the MAML
features block (K3) and image DA (K6, all six op orders, JAX's draws
replayed as ``DAParams``); then the slice as a whole: one ANP DA + TA
training step and one second-order MAML outer step (losses and per-tensor
gradients) and MAML's validation loss. Inputs come from numpy seeds; every
comparison runs the JAX function in bfloat16 and in float32 on the same
inputs.

Tolerance: XLA on the CPU may keep excess precision
(``xla_allow_excess_precision`` defaults to true), so the JAX reference
does not round at every point its code rounds, and the port (which does)
cannot equal it bit for bit; sums are taken in another order too. Each
comparison therefore holds the port to the size of bfloat16's own effect on
the same inputs:

    max|port_bf16 - jax_bf16| <= 2 max|jax_bf16 - jax_f32| + 2^-7 max|jax_f32|

per tensor. That rule alone would pass a port that computes in float32, so
each tensor is also held to a second rule: the port sits nearer jax_bf16
than jax_f32, mean|port_bf16 - jax_bf16| < mean|port_bf16 - jax_f32|.
The module outputs and the losses of the training steps meet it tensor by
tensor (the modules' bfloat16 outputs equal JAX's bit for bit). A step's
gradients meet it taken together (``assert_nearer_overall``), not tensor by
tensor: XLA on the CPU sums a bfloat16 cotangent over the batch with
bfloat16 partial sums, where the port sums in float32, so the bias
gradients and a few weight gradients far down the backward carry rounding
noise that puts them no nearer one reference than the other. MAML's
validation loss after its inner steps is the same noise (one bfloat16 ulp
of a prediction); it keeps the first rule.

The jitted references (the training steps, ``_as_written``) are compiled
without excess precision, so that they round where their code rounds, as
the port does: with it, XLA keeps whole chains of the ANP step's backward
in float32, and its bfloat16 gradients of ``transform_y`` and
``encoder_r.layers.0`` come out 3x closer to float32 than rounding as
written gives. The module references run op by op and round at each op.
The output dtype at each module boundary must be JAX's: the stem, the
features block and DA bfloat16, the FAVOR+ core and the losses float32.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_port_aug import (_images, _jax_process_draws, _key_for_order,
                                 _raw_episode, jax_da_params)
from test_torch_port_maml import _pair as maml_pair
from test_torch_port_maml import _raw_batch as maml_batch
from torch_port_common import WIDTHS, jax_grads_as_port, t, to_numpy
from wmfml_tpu.aug import image_aug as jaug
from wmfml_tpu.aug.pipeline import _to_float as jax_to_float
from wmfml_tpu.configs import Config as JaxConfig
from wmfml_tpu.models.maml import masked_batch_norm as jax_masked_bn
from wmfml_tpu.models.registry import build_model as jax_build_model
from wmfml_tpu.nn.attention import favor_attention as jax_favor
from wmfml_tpu.nn.attention import gaussian_orthogonal_random_matrix
from wmfml_tpu.nn.encoders import _s2d_stem
from wmfml_tpu.train.maml import build_maml_outer as jax_maml_outer
from wmfml_tpu.train.state import TrainState
from wmfml_tpu.train.steps import build_train_step as jax_train_step
from wmfml_tpu.train.steps import init_model as jax_init_model
from wmfml_tpu_torch.aug import image_aug as paug
from wmfml_tpu_torch.ckpt.jax_params import load_jax_variables, maml_state_dict
from wmfml_tpu_torch.configs import Config
from wmfml_tpu_torch.kernels import favor as kfavor
from wmfml_tpu_torch.kernels import features as kfeatures
from wmfml_tpu_torch.kernels import stem as kstem
from wmfml_tpu_torch.models.registry import build_model
from wmfml_tpu_torch.train.maml import build_maml_outer
from wmfml_tpu_torch.train.steps import build_train_step
from torch_port_common import one_torch_thread  # noqa: F401

BF16, F32 = jnp.bfloat16, jnp.float32


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(F32))


def assert_bf16_close(got, want_bf16, want_f32, name="", nearer=True):
    """The module docstring's rule; with ``nearer``, also its second rule
    for this one tensor. Returns (mean|port - jax_bf16|, mean|port -
    jax_f32|, mean|jax_bf16 - jax_f32|)."""
    g, wb, wf = _f32(got), _f32(want_bf16), _f32(want_f32)
    assert g.shape == wb.shape == wf.shape, (name, g.shape, wb.shape)
    assert np.isfinite(g).all(), name
    err = np.abs(g - wb).max()
    bound = 2 * np.abs(wb - wf).max() + 2.0 ** -7 * np.abs(wf).max()
    assert err <= bound, f"{name}: max|port - jax| {err} > {bound}"
    near, far, own = (np.abs(g - wb).mean(), np.abs(g - wf).mean(),
                      np.abs(wb - wf).mean())
    if nearer:
        assert near < far or near == own == 0, (
            f"{name}: mean|port - jax_bf16| {near} >= mean|port - jax_f32| "
            f"{far}")
    return near, far, own


def assert_nearer_overall(distances, what):
    """The second rule over a step's gradients: the sums of the per-tensor
    distances (``assert_bf16_close``'s), each scaled by its tensor's own
    mean|jax_bf16 - jax_f32|."""
    near = sum(n / o for n, _, o in distances if o > 0)
    far = sum(f / o for _, f, o in distances if o > 0)
    assert near < far, (f"{what}: the port sits no nearer jax_bf16 than "
                        f"jax_f32 ({near} >= {far}, scaled sums)")


def _as_written(jitted, *args):
    """``jitted(*args)``, compiled to round wherever its code rounds."""
    return jitted.lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _same_dtype(got: torch.Tensor, want):
    assert str(got.dtype).split(".")[-1] == str(jnp.asarray(want).dtype), (
        got.dtype, jnp.asarray(want).dtype)


def _oihw(w):
    return t(np.ascontiguousarray(np.moveaxis(w, (-1, -2), (-4, -3))))


# -- K1: the stem, shared and per task ----------------------------------------

def _stem_inputs(lead, seed):
    rng = np.random.RandomState(seed)
    shapes = ((0.3, (3, 3, 1, 32)), (0.1, (32,)), (0.06, (3, 3, 32, 48)),
              (0.1, (48,)))
    return [(s * rng.randn(*lead, *shape)).astype(np.float32)
            for s, shape in shapes]


@pytest.mark.parametrize("per_task", [False, True], ids=["shared", "per_task"])
def test_stem_matches_jax_in_bf16(per_task):
    t_, n, hw = 2, 3, 32
    lead = (t_,) if per_task else ()
    x = np.random.RandomState(0).rand(t_ * n, hw, hw, 1).astype(np.float32)
    w0, b0, w1, b1 = _stem_inputs(lead, 1)

    def jax_stem(dtype):
        def one(x, w0, b0, w1, b1):
            return _s2d_stem(x, w0, b0, w1, b1, dtype, phase_pool=True)
        if per_task:
            return jax.vmap(one)(x.reshape(t_, n, hw, hw, 1), w0, b0, w1,
                                 b1).reshape(t_ * n, hw // 8, hw // 8, 48)
        return one(x, w0, b0, w1, b1)

    want_bf16, want_f32 = jax_stem(BF16), jax_stem(None)
    bf = torch.bfloat16
    got = kstem.literature_stem(t(x).to(bf), _oihw(w0).to(bf), t(b0).to(bf),
                                _oihw(w1).to(bf), t(b1).to(bf))
    _same_dtype(got, want_bf16)
    assert_bf16_close(got, want_bf16, want_f32, "stem")


# -- K2: the FAVOR+ core ---------------------------------------------------------

def test_favor_core_takes_bf16_and_returns_float32_as_jax_does():
    rng = np.random.RandomState(2)
    t_, h, nq, nk, d = 2, 3, 5, 6, 16
    q, k, v = (rng.randn(t_, h, n, d).astype(np.float32)
               for n in (nq, nk, nk))
    proj = np.asarray(gaussian_orthogonal_random_matrix(
        jax.random.PRNGKey(3), 40, d))
    mask = np.arange(nk)[None, :] < np.array([nk, 2])[:, None]
    want_bf16 = jax_favor(*(jnp.asarray(a, BF16) for a in (q, k, v)), proj,
                          mask[:, None, :])
    want_f32 = jax_favor(q, k, v, proj, mask[:, None, :])
    got = kfavor.favor_attention(*(t(a).bfloat16() for a in (q, k, v)),
                                 t(proj), t(mask))
    _same_dtype(got, want_bf16)
    assert got.dtype == torch.float32
    assert_bf16_close(got, want_bf16, want_f32, "favor")


# -- K3: the MAML features block ---------------------------------------------------

def _jax_features(x, w, b, scale, bias, mask, dtype):
    """Layers 2-4 of the JAX ``MAMLRegressor`` (``models/maml.py:106-120``)
    on each task: ``nn.Conv(dtype=...)``, masked BN with the scale and bias
    cast to the activations' dtype, ReLU."""
    def one(x, w, b, m):
        h = x.astype(dtype or F32)
        for layer in range(w.shape[0]):
            conv = fnn.Conv(w.shape[-1], (3, 3), strides=1,
                            padding=[(1, 1), (1, 1)], dtype=dtype)
            h = conv.apply({"params": {"kernel": w[layer], "bias": b[layer]}},
                           h)
            h = jax_masked_bn(h, m, scale[layer].astype(h.dtype),
                              bias[layer].astype(h.dtype))
            h = jax.nn.relu(h)
        return h
    if mask is None:
        return jax.vmap(lambda a, c, e: one(a, c, e, None))(x, w, b)
    return jax.vmap(one)(x, w, b, mask)


@pytest.mark.parametrize("masked", [True, False])
def test_features_block_matches_jax_in_bf16(masked):
    rng = np.random.RandomState(4)
    t_, n, s, c, layers = 2, 3, 6, 8, 3
    x = np.maximum(rng.randn(t_, n, s, s, c), 0).astype(np.float32)
    w = (0.2 * rng.randn(t_, layers, 3, 3, c, c)).astype(np.float32)   # HWIO
    b = (0.1 * rng.randn(t_, layers, c)).astype(np.float32)
    scale = (1 + 0.1 * rng.randn(layers, c)).astype(np.float32)
    bias = (0.1 * rng.randn(layers, c)).astype(np.float32)
    mask = np.array([[True, True, True], [True, True, False]])
    m = mask if masked else None
    want_bf16 = _jax_features(jnp.asarray(x, BF16), w, b, scale, bias, m, BF16)
    want_f32 = _jax_features(x, w, b, scale, bias, m, None)
    bf = torch.bfloat16
    got = kfeatures.maml_features(
        t(x).to(bf), t(w).permute(0, 1, 5, 4, 2, 3).to(bf), t(b).to(bf),
        t(scale).to(bf), t(bias).to(bf), t(mask) if masked else None)
    _same_dtype(got, want_bf16)
    assert_bf16_close(got, want_bf16, want_f32, "features")


# -- K6: image DA, every op order ----------------------------------------------------

@pytest.mark.parametrize("order", range(6))
def test_augmenter_matches_jax_in_bf16_for_each_order(order):
    b, h, w = 8, 32, 32
    key = _key_for_order(order)
    img = _images(order, (2, b // 2, h, w, 1))
    want = {dt: jaug.build_augmenter("shapenet_1d")(
        key, jax_to_float(jnp.asarray(img), dt)) for dt in (BF16, F32)}
    params = jax_da_params(key, b, h, w)
    assert params.order == order
    got = paug.ShapeNet1DAugmenter(torch.bfloat16)(t(img), params=params)
    _same_dtype(got, want[BF16])
    assert_bf16_close(got, want[BF16], want[F32], f"DA order {order}")


# -- the slice: one ANP DA + TA step, one second-order MAML step -------------------

def _capture_grads():
    """An optax transformation that leaves the parameters and keeps the
    gradient as its state."""
    zeros = lambda tree: jax.tree_util.tree_map(jnp.zeros_like, tree)  # noqa: E731
    return optax.GradientTransformation(zeros, lambda g, s, p=None: (zeros(g), g))


def test_one_anp_da_ta_step_matches_jax_in_bf16():
    t_, s, q = 2, 4, 3
    cfg = dict(method="ANPShapeNet1D", task="shapenet_1d", agg_mode="attention",
               aug_list=["task_aug", "data_aug"], tasks_per_batch=t_,
               max_ctx_num=s, query_num=q, dim_w=WIDTHS["dim_w"],
               dim_r=WIDTHS["dim_r"], dim_z=WIDTHS["dim_z"],
               n_hidden_units_r=list(WIDTHS["n_hidden_units_r"]), lr=1e-4,
               seed=0, loss_type="mse", optimizer="SGD", device="cpu")
    raw = _raw_episode(8, t_, s, q, hw=128)
    key = jax.random.PRNGKey(3)
    da, ta = _jax_process_draws(jax.random.split(key)[0], raw)
    want = {}
    for dtype in ("bfloat16", "float32"):
        jcfg = JaxConfig.from_dict(dict(cfg, compute_dtype=dtype))
        jmodel = jax_build_model(jcfg)
        variables = to_numpy(jax_init_model(jmodel, jcfg,
                                            jax.random.PRNGKey(1)))
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
    assert_bf16_close(loss, want["bfloat16"][0], want["float32"][0], "loss")
    grads = {k: jax_grads_as_port(model, g, variables)
             for k, (_, g) in want.items()}
    assert_nearer_overall([assert_bf16_close(
        p.grad, grads["bfloat16"][name], grads["float32"][name], name,
        nearer=False) for name, p in model.named_parameters()], "gradients")


def _maml_grads(dtype, **kw):
    (jmodel, jcfg, params), (model, pcfg) = maml_pair(compute_dtype=dtype, **kw)
    outer = jax_maml_outer(jmodel, jcfg, 2, train=True, test=False)
    (loss, _), grads = _as_written(jax.jit(jax.value_and_grad(
        lambda p, b: outer(p, b, jax.random.PRNGKey(0)), has_aux=True)),
        params, maml_batch())
    return loss, maml_state_dict(model, {"params": to_numpy(grads)}), model, pcfg


def test_second_order_maml_step_matches_jax_in_bf16():
    want_loss, want, model, pcfg = _maml_grads("bfloat16")
    ref_loss, ref, _, _ = _maml_grads("float32")
    assert pcfg.compute_dtype == "bfloat16"
    outer = build_maml_outer(model, pcfg, 2, train=True, test=False)
    loss, _ = outer({k: t(v) for k, v in maml_batch().items()})
    _same_dtype(loss, want_loss)
    assert_bf16_close(loss, want_loss, ref_loss, "outer loss")
    loss.backward()
    distances = []
    for name, p in model.named_parameters():
        assert p.grad.dtype == torch.float32, name
        distances.append(assert_bf16_close(p.grad, want[name], ref[name],
                                           name, nearer=False))
    assert_nearer_overall(distances, "gradients")


def test_maml_validation_loss_matches_jax_in_bf16():
    """Validation adapts and predicts in bfloat16; its degree metric is
    taken in float32 (``NOTES.md`` r3 #14)."""
    want, port = {}, None
    for dtype in ("bfloat16", "float32"):
        (jmodel, jcfg, params), pair = maml_pair(compute_dtype=dtype)
        port = port or pair
        jouter = jax_maml_outer(jmodel, jcfg, 2, train=False, test=True)
        want[dtype] = _as_written(jax.jit(
            lambda p, b: jouter(p, b, jax.random.PRNGKey(0))[1]),
            params, maml_batch(1))
    model, pcfg = port
    outer = build_maml_outer(model, pcfg, 2, train=False, test=True)
    got = outer({k: t(v) for k, v in maml_batch(1).items()})[1]
    _same_dtype(got, want["bfloat16"])
    assert_bf16_close(got, want["bfloat16"], want["float32"], "validation",
                      nearer=False)
