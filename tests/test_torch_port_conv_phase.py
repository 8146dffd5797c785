"""``conv_bwd: phase`` (ROADMAP.md B8a): the stem's backward through K1b's
plain twin (``wmfml_tpu_torch/kernels/stem.py:stem_backward_phase_plain``)
against the JAX package's ``conv3x3_s2_phase`` on the CPU.

  * conv1's input gradient by the phase form (``conv3x3_s2_phase_input_
    grad``) and the weight gradient the twin takes, against JAX's
    ``conv3x3_s2_phase`` VJP at ``tests/test_conv_phase.py``'s shapes and
    tolerances (the odd size through the dilated form, as in JAX);
  * the literature encoder's gradients with ``conv_bwd='phase'`` against
    JAX's ``LiteratureEncoder(stem_impl='conv', conv_bwd='phase')`` at 32 x
    32, in float32 (1e-5) and bfloat16 (the bf16 rule of
    ``tests/test_torch_port_bf16.py``);
  * one ANPShapeNet1D Adam step with ``conv_bwd=phase`` against JAX's, as
    ``tests/test_torch_port_train.py`` holds the default;
  * the option read for the four methods that the JAX package's ``_small``
    builds and no other, and the three cases K1b is not ported for
    raising: per-task weights, an image gradient, ``create_graph``;
  * the twin fed decisions (``route``, ``mask0``: those K1b took, from
    K1's forward): fed its own (``stem_decisions_plain``) it is the default
    bit for bit; fed a route that differs at one window, it moves only
    that window's terms.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_bf16 import (_as_written, assert_bf16_close,
                                  assert_nearer_overall)
from test_torch_port_train import CFG, T_, Q_, S_, _pair
from torch_port_common import (ATOL, RTOL, jax_grads_as_port,  # noqa: F401
                               one_torch_thread, t, to_numpy)
from wmfml_tpu.nn.encoders import LiteratureEncoder as JaxLiteratureEncoder
from wmfml_tpu.nn.encoders import conv3x3_s2_phase
from wmfml_tpu.train.state import TrainState
from wmfml_tpu.train.state import build_optimizer as jax_optimizer
from wmfml_tpu.train.steps import build_train_step as jax_train_step
from wmfml_tpu_torch.ckpt.jax_params import encoder_state_dict
from wmfml_tpu_torch.configs import Config
from wmfml_tpu_torch.kernels import stem as kstem
from wmfml_tpu_torch.models.registry import build_model
from wmfml_tpu_torch.nn.encoders import LiteratureEncoder
from wmfml_tpu_torch.ops.cast import set_compute_dtype
from wmfml_tpu_torch.train.state import build_optimizer
from wmfml_tpu_torch.train.steps import build_train_step

BF16 = jnp.bfloat16


@pytest.mark.parametrize("hw,ci,co", [((16, 16), 3, 8), ((10, 14), 4, 6),
                                      ((9, 9), 2, 5)])
def test_phase_vjp_matches_jax(hw, ci, co):
    """``tests/test_conv_phase.py``'s inputs through JAX's VJP and the
    twin's two halves: the input gradient by the phase form (NCHW, OIHW),
    the weight gradient as the twin takes it."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, *hw, ci).astype(np.float32)
    w = rng.randn(3, 3, ci, co).astype(np.float32)
    y, vjp = jax.vjp(conv3x3_s2_phase, jnp.asarray(x), jnp.asarray(w))
    g = rng.randn(*y.shape).astype(np.float32)
    dx, dw = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    gn, wn = t(g).permute(0, 3, 1, 2), t(w).permute(3, 2, 0, 1)
    got_dx = kstem.conv3x3_s2_phase_input_grad(gn, wn, size=hw)
    got_dw = kstem._weight_grad(t(x).permute(0, 3, 1, 2), wn.shape, gn)
    np.testing.assert_allclose(got_dx.permute(0, 2, 3, 1).numpy(), dx,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_dw.permute(2, 3, 1, 0).numpy(), dw,
                               rtol=1e-5, atol=1e-4)


def _encoder_grads(dtype):
    """JAX's encoder gradients of sum(out^2) at 32 x 32 (4 images), with
    the port's encoder's in the port's layout; bfloat16: JAX compiled as
    written, its float32 grads beside."""
    rng = np.random.RandomState(1)
    x = rng.rand(4, 32, 32, 1).astype(np.float32)
    grads = {}
    for name, dt in (("f32", None), ("bf16", BF16)):
        mod = JaxLiteratureEncoder(dim_w=16, conv_bwd="phase",
                                   stem_impl="conv", dtype=dt)
        params = mod.init(jax.random.PRNGKey(0), x)["params"]

        def loss(p, mod=mod):
            return jnp.sum(mod.apply({"params": p}, x) ** 2)

        grads[name] = to_numpy(_as_written(jax.jit(jax.grad(loss)), params))
    enc = LiteratureEncoder(16, (32, 32, 1), conv_bwd="phase")
    chw = enc.flatten_chw
    enc.load_state_dict(encoder_state_dict(to_numpy(params), chw))
    set_compute_dtype(enc, dtype)
    out = enc(t(x))
    (out ** 2).sum().backward()
    got = {k: p.grad for k, p in enc.named_parameters()}
    want = {k: encoder_state_dict(g, chw) for k, g in grads.items()}
    return got, want


def test_encoder_grads_match_jax_phase_f32():
    got, want = _encoder_grads(torch.float32)
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), want["f32"][k].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_encoder_grads_match_jax_phase_bf16():
    got, want = _encoder_grads(torch.bfloat16)
    distances = [assert_bf16_close(g, want["bf16"][k].numpy(),
                                   want["f32"][k].numpy(), k, nearer=False)
                 for k, g in got.items()]
    assert_nearer_overall(distances, "encoder gradients, conv_bwd phase")


def test_one_adam_step_matches_jax_with_conv_bwd_phase():
    """``test_torch_port_train.py:test_one_adam_step_matches_jax`` with
    ``conv_bwd=phase`` on both sides (JAX's on its ``stem_impl: conv``,
    where the option acts)."""
    (model, pcfg), (jmodel, jcfg, variables) = _pair(
        dict(CFG, conv_bwd="phase", stem_impl="conv"))
    assert model.encoder_w0.conv_bwd == "phase"
    rng = np.random.RandomState(4)
    batch = dict(
        ctx_x=rng.randint(0, 255, (T_, S_, 128, 128, 1)).astype(np.uint8),
        ctx_y=rng.uniform(0, 2 * np.pi, (T_, S_, 1)).astype(np.float32),
        ctx_mask=np.arange(S_)[None, :].repeat(T_, 0) < 3,
        qry_x=rng.randint(0, 255, (T_, Q_, 128, 128, 1)).astype(np.uint8),
        qry_y=rng.uniform(0, 2 * np.pi, (T_, Q_, 1)).astype(np.float32))
    key = jax.random.PRNGKey(7)
    _, k_ta = jax.random.split(jax.random.split(key)[0])
    ta_idx = np.asarray(jax.random.randint(k_ta, (T_, 1, 1), 0, 15)).ravel()
    tx = jax_optimizer(jcfg)
    state = TrainState.create(jax.tree_util.tree_map(np.array, variables), tx)
    state, metrics = jax_train_step(jmodel, jcfg, tx=tx)(state, batch, key)
    step = build_train_step(model, build_optimizer(pcfg, model.parameters()),
                            pcfg)
    loss = step({k: t(v) for k, v in batch.items()}, ta_idx=t(ta_idx))
    np.testing.assert_allclose(loss.item(), float(metrics["loss"]), rtol=RTOL)
    want = jax_grads_as_port(model, state.params, variables)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("method,reads", [
    ("CNPShapeNet1D", True), ("ANPShapeNet1D", True),
    ("CNPVanillaPascal1D", True), ("ANPVanillaPascal1D", True),
    ("ANPMRShapeNet1D", False), ("FCLCNPShapeNet1D", False)])
def test_conv_bwd_is_read_by_the_four_small_methods(method, reads):
    task = "pascal_1d" if "Pascal" in method else "shapenet_1d"
    agg = "attention" if method.startswith("ANP") else "max"
    cfg = Config.from_dict(dict(CFG, method=method, task=task, agg_mode=agg,
                                conv_bwd="phase", contrastive="FCL" in method))
    enc = build_model(cfg).encoder_w0
    assert getattr(enc, "conv_bwd", "xla") == ("phase" if reads else "xla")
    assert Config.from_dict(dict(CFG)).conv_bwd == "xla"


def _stem_args(per_task=False, seed=3):
    rng = np.random.RandomState(seed)
    lead = (2,) if per_task else ()
    x = t(rng.rand(4, 16, 16, 1).astype(np.float32))
    w = [t(rng.randn(*lead, *s).astype(np.float32) * 0.2)
         for s in ((32, 1, 3, 3), (32,), (48, 32, 3, 3), (48,))]
    return x, [p.requires_grad_() for p in w]


def test_the_cases_k1b_is_not_ported_for_raise():
    x, w = _stem_args(per_task=True)
    with pytest.raises(NotImplementedError, match="per-task"):
        kstem.literature_stem(x, *w, conv_bwd="phase")
    x, w = _stem_args()
    with pytest.raises(NotImplementedError, match="image gradient"):
        kstem.literature_stem(x.requires_grad_(), *w, conv_bwd="phase")
    x, w = _stem_args()
    y = kstem.literature_stem(x, *w, conv_bwd="phase")
    with pytest.raises(NotImplementedError, match="create_graph"):
        torch.autograd.grad(y.sum(), w, create_graph=True)
    # first order, the twin: the gradients autodiff of the plain stem gives
    y = kstem.literature_stem(x, *w, conv_bwd="phase")
    got = torch.autograd.grad(y.square().sum(), w)
    want = torch.autograd.grad(kstem.stem_plain(x, *w).square().sum(), w)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_twin_routes_ties_to_the_first_maximum():
    """On dyadic images of flat 8 x 8 blocks (every forward sum exact in
    float32, equal patches inside a block, so pooled windows hold exact
    ties, as bfloat16's rounding makes them) the twin routes each window's
    gradient where ``F.max_pool2d`` does, to the first maximum in raster
    order: its gradients = autodiff of the plain stem."""
    rng = np.random.RandomState(7)

    def grid(lo, hi, shape, step):
        return t((rng.randint(lo, hi + 1, shape) * step).astype(np.float32))

    x = grid(0, 2, (6, 4, 4, 1), 1 / 2).repeat_interleave(
        8, 1).repeat_interleave(8, 2)
    w = [grid(-2, 2, (32, 1, 3, 3), 1 / 8), grid(-2, 2, (32,), 1 / 64),
         grid(-1, 1, (48, 32, 3, 3), 1 / 64), grid(-4, 4, (48,), 1 / 4096)]
    g = t(rng.randn(6, 4, 4, 48).astype(np.float32))
    a1 = torch.relu(torch.nn.functional.conv2d(torch.relu(
        torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w[0], w[1], 2, 1)),
        w[2], w[3], 2, 1))
    win = a1.unfold(2, 2, 2).unfold(3, 2, 2).flatten(-2)
    ties = ((win == win.amax(-1, keepdim=True)).sum(-1) > 1) & (
        win.amax(-1) > 0)
    assert int(ties.sum()) > 100
    got = kstem.stem_backward_phase_plain(x, *w, g)
    leaves = [p.clone().requires_grad_() for p in w]
    want = torch.autograd.grad(kstem.stem_plain(x, *leaves), leaves, g)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)


def _decision_args(dtype, seed=11):
    rng = np.random.RandomState(seed)
    x = t(rng.rand(3, 24, 32, 1).astype(np.float32)).to(dtype)
    w = [t((rng.randn(*s) * f).astype(np.float32)).to(dtype)
         for s, f in (((32, 1, 3, 3), 0.3), ((32,), 0.1),
                      ((48, 32, 3, 3), 0.06), ((48,), 0.1))]
    g = t(rng.randn(3, 3, 4, 48).astype(np.float32)).to(dtype)
    return x, w, g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_twin_fed_its_own_decisions_equals_the_default_bit_for_bit(dtype):
    x, w, g = _decision_args(dtype)
    route, mask0 = kstem.stem_decisions_plain(x, *w)
    assert route.dtype == torch.uint8 and tuple(route.shape) == (3, 3, 4, 48)
    assert tuple(mask0.shape) == (3, 12, 16, 32)
    assert int((route < 4).sum()) > 0 and int((route == 4).sum()) > 0
    want = kstem.stem_backward_phase_plain(x, *w, g)
    for fed in (kstem.stem_backward_phase_plain(x, *w, g, route=route),
                kstem.stem_backward_phase_plain(x, *w, g, route=route,
                                                mask0=mask0),
                kstem.literature_stem_backward(x, *w, g, route)):
        for a, b in zip(fed, want):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_twin_fed_a_route_that_differs_at_one_window_moves_only_its_terms():
    """Another first maximum for one window and channel (b, i, j, c): dW1
    moves in row c alone and db1 not at all (the gradient is routed, only
    elsewhere), and in float64 each gradient moves by exactly the
    difference the window's own gradient makes routed the one way and the
    other (the twin is linear in g for fixed decisions)."""
    x, w, g = _decision_args(torch.float32)
    route, mask0 = kstem.stem_decisions_plain(x, *w)
    b_, i, j, c = (int(v) for v in (route < 4).nonzero()[7])
    moved = route.clone()
    moved[b_, i, j, c] = (int(route[b_, i, j, c]) + 1) % 4
    base = kstem.stem_backward_phase_plain(x, *w, g, route, mask0)
    other = kstem.stem_backward_phase_plain(x, *w, g, moved, mask0)
    rows = torch.arange(48) != c
    assert torch.equal(other[2][rows], base[2][rows])
    assert not torch.equal(other[2][c], base[2][c])
    assert torch.equal(other[3], base[3])
    one = torch.zeros_like(g)
    one[b_, i, j, c] = g[b_, i, j, c]
    xd, wd, gd, od = x.double(), [v.double() for v in w], g.double(), \
        one.double()
    for got_a, got_b, win_a, win_b in zip(
            kstem.stem_backward_phase_plain(xd, *wd, gd, moved, mask0),
            kstem.stem_backward_phase_plain(xd, *wd, gd, route, mask0),
            kstem.stem_backward_phase_plain(xd, *wd, od, moved, mask0),
            kstem.stem_backward_phase_plain(xd, *wd, od, route, mask0)):
        np.testing.assert_allclose((got_a - got_b).numpy(),
                                   (win_a - win_b).numpy(), rtol=0,
                                   atol=1e-12)
