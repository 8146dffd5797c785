"""Port modules that hold a kernel, against the JAX package on the CPU.

K1, the fused stem (``kernels/stem.py``), against the JAX
``LiteratureEncoder`` on both of its stem lowerings, and its per-task form
against the shared one task by task; K2, the masked FAVOR+ core
(``kernels/favor.py``), against ``favor_attention`` and the multi-head
block. On the CPU each wrapper runs its plain PyTorch twin, which is what
these tests check; the kernels themselves are held against the same twins on
the card (``test_torch_port_cuda.py``, ``chip_smoke.py``). K3's twin is held
against JAX in ``test_torch_port_maml.py``.

The K1 and K3 ``autograd.Function``s run here with the kernel launch swapped
for the plain twin, in float64, through ``gradgradcheck``: second-order MAML
differentiates their backward again.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import (ATOL, GRAD_TOL, RTOL, S, T, episode, jax_model,
                               port_model, t, to_numpy)
from wmfml_tpu.nn.attention import MultiheadFavorCrossAttention as JaxMHA
from wmfml_tpu.nn.attention import favor_attention as jax_favor
from wmfml_tpu.nn.attention import gaussian_orthogonal_random_matrix
from wmfml_tpu.nn.encoders import LiteratureEncoder as JaxEncoder
from wmfml_tpu_torch.ckpt.jax_params import (attention_state_dict,
                                             encoder_state_dict)
from wmfml_tpu_torch.kernels import favor as kfavor
from wmfml_tpu_torch.kernels import features as kfeatures
from wmfml_tpu_torch.kernels import stem as kstem
from wmfml_tpu_torch.nn.attention import MultiheadFavorCrossAttention
from wmfml_tpu_torch.nn.encoders import LiteratureEncoder
from torch_port_common import one_torch_thread  # noqa: F401


# -- K1: stem ----------------------------------------------------------------

@pytest.mark.parametrize("stem_impl", ["s2d", "conv"])
def test_stem_encoder_matches_jax_values_and_weight_grads(stem_impl):
    x = np.random.RandomState(0).rand(5, 32, 32, 1).astype(np.float32)
    jenc = JaxEncoder(dim_w=16, stem_impl=stem_impl)
    params = to_numpy(jenc.init(jax.random.PRNGKey(1), x))["params"]
    want = np.asarray(jenc.apply({"params": params}, x))
    jgrads = to_numpy(jax.jit(jax.grad(
        lambda p: jnp.sum(jenc.apply({"params": p}, x) ** 2)))(params))

    enc = LiteratureEncoder(16, (32, 32, 1))
    enc.load_state_dict(encoder_state_dict(params, enc.flatten_chw))
    got = enc(t(x))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=ATOL)
    (got ** 2).sum().backward()
    gwant = encoder_state_dict(jgrads, enc.flatten_chw)
    for name, p in enc.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), gwant[name].numpy(),
                                   err_msg=name, **GRAD_TOL)


def test_stem_gradient_reaches_weights_only():
    x = torch.rand(2, 16, 16, 1, requires_grad=False)
    enc = LiteratureEncoder(8, (16, 16, 1))
    y = kstem.literature_stem(x, enc[0].weight, enc[0].bias, enc[2].weight,
                              enc[2].bias)
    assert tuple(y.shape) == (2, 2, 2, 48)
    y.sum().backward()
    assert x.grad is None and enc[0].weight.grad is not None


def _stem_weights(lead, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [(scale * torch.randn(*lead, *shape, dtype=dtype, generator=g))
            for scale, shape in ((0.3, (32, 1, 3, 3)), (0.1, (32,)),
                                 (0.06, (48, 32, 3, 3)), (0.1, (48,)))]


def test_per_task_stem_is_the_shared_stem_task_by_task():
    x = torch.rand(6, 16, 16, 1, generator=torch.Generator().manual_seed(1))
    ws = _stem_weights((3,), torch.float32)
    got = kstem.stem_plain(x, *ws)
    want = torch.cat([kstem.stem_plain(x[2 * i:2 * i + 2],
                                       *(w[i] for w in ws)) for i in range(3)])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("lead", [(), (2,)], ids=["shared", "per_task"])
def test_stem_function_is_twice_differentiable(monkeypatch, lead):
    monkeypatch.setattr(kstem, "stem_launch", kstem.stem_plain)
    x = torch.rand(4, 16, 16, 1, dtype=torch.float64,
                   generator=torch.Generator().manual_seed(2))
    ws = [w.requires_grad_(True) for w in _stem_weights(lead, torch.float64)]
    fn = lambda *w: kstem._FusedStem.apply(x, *w)       # noqa: E731
    assert torch.autograd.gradcheck(fn, ws, fast_mode=True)
    assert torch.autograd.gradgradcheck(fn, ws, fast_mode=True)


@pytest.mark.parametrize("lead", [(), (2,)], ids=["shared", "per_task"])
def test_stem_function_gives_the_image_gradient(monkeypatch, lead):
    # the JAX stem is plain autodiff, so its images have a gradient too
    monkeypatch.setattr(kstem, "stem_launch", kstem.stem_plain)
    x = torch.rand(4, 16, 16, 1, dtype=torch.float64,
                   generator=torch.Generator().manual_seed(4))
    inputs = [x.requires_grad_(True)] + [
        w.requires_grad_(True) for w in _stem_weights(lead, torch.float64, 5)]
    fn = kstem._FusedStem.apply
    assert torch.autograd.gradcheck(fn, inputs, fast_mode=True)
    assert torch.autograd.gradgradcheck(fn, inputs, fast_mode=True)
    y = fn(*inputs)
    (gx,) = torch.autograd.grad(y.sum(), x)
    (want,) = torch.autograd.grad(kstem.stem_plain(*inputs).sum(), x)
    torch.testing.assert_close(gx, want)


def test_features_function_is_twice_differentiable(monkeypatch):
    monkeypatch.setattr(kfeatures, "features_launch", kfeatures.features_plain)
    g = torch.Generator().manual_seed(3)
    t_, n, hw, c, layers = 2, 3, 4, 4, 3
    f64 = dict(dtype=torch.float64, generator=g)
    inputs = [torch.randn(t_, n, hw, hw, c, **f64),
              0.3 * torch.randn(t_, layers, c, c, 3, 3, **f64),
              0.1 * torch.randn(t_, layers, c, **f64),
              1.0 + 0.1 * torch.randn(layers, c, **f64),
              0.1 * torch.randn(layers, c, **f64)]
    inputs = [a.requires_grad_(True) for a in inputs]
    mask = torch.tensor([[True, True, True], [True, True, False]])
    fn = lambda *a: kfeatures._Features.apply(*a, mask)  # noqa: E731
    assert torch.autograd.gradcheck(fn, inputs, fast_mode=True)
    assert torch.autograd.gradgradcheck(fn, inputs, fast_mode=True)


# -- K2: FAVOR+ core ---------------------------------------------------------

def _qkv(seed, t_=T, h=3, nq=5, nk=S, d=8, e=6):
    rng = np.random.RandomState(seed)
    return (rng.randn(t_, h, nq, d).astype(np.float32),
            rng.randn(t_, h, nk, d).astype(np.float32),
            rng.randn(t_, h, nk, e).astype(np.float32))


def _projection(m=20, d=8, seed=3):
    return np.asarray(gaussian_orthogonal_random_matrix(
        jax.random.PRNGKey(seed), m, d))


def _both(q, k, v, proj, mask):
    want = np.asarray(jax_favor(q, k, v, proj, mask[:, None, :]))
    got = kfavor.favor_attention(t(q), t(k), t(v), t(proj), t(mask)).numpy()
    return got, want


@pytest.mark.parametrize("shot", list(range(1, S + 1)))
def test_favor_matches_jax_for_every_shot(shot):
    q, k, v = _qkv(shot)
    mask = np.arange(S)[None, :] < np.array([shot, S - shot + 1])[:, None]
    got, want = _both(q, k, v, _projection(), mask)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_favor_global_key_max_includes_masked_rows():
    q, k, v = _qkv(11)
    proj = _projection()
    mask = np.array([[True, True, False, False], [True, True, True, True]])
    # a masked key row whose projection beats every real row: the one max
    # over the whole key tensor is taken there
    k[0, 1, 3] = 6.0 * proj[0] / np.linalg.norm(proj[0])
    got, want = _both(q, k, v, proj, mask)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # with the masked row padded as an episode pads it (row 0 repeated) the
    # max moves and the output moves with it: masked rows do count
    k_pad = k.copy()
    k_pad[0, :, 2:] = k[0, :, :1]
    got_pad, want_pad = _both(q, k_pad, v, proj, mask)
    np.testing.assert_allclose(got_pad, want_pad, rtol=RTOL, atol=ATOL)
    assert np.abs(got_pad - got).max() > 1e-3


def _mha_inputs(seed, dim_w=16, dim_r=12):
    rng = np.random.RandomState(seed)
    return (rng.randn(T, S, dim_w).astype(np.float32),
            rng.randn(T, S, dim_r).astype(np.float32),
            rng.randn(T, 5, dim_w).astype(np.float32))


def test_multihead_block_matches_jax_outputs_and_grads():
    k, v, q = _mha_inputs(4)
    mask = np.array([[True, True, True, False], [True, False, False, False]])
    jmha = JaxMHA(h_dim=16, n_heads=8)
    variables = to_numpy(jmha.init(jax.random.PRNGKey(2), k, v, q,
                                   mask=mask))
    proj = variables["favor"]["favor"]["projection"]

    def jloss(params, k, v, q):
        out = jmha.apply({"params": params, "favor": variables["favor"]},
                         k, v, q, mask=mask)
        return jnp.sum(out ** 2), out

    (_, want), (gp, gk, gv, gq) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3), has_aux=True))(variables["params"], k, v, q)

    mha = MultiheadFavorCrossAttention(16, 12, n_heads=8)
    mha.load_state_dict(attention_state_dict(variables["params"], proj))
    kt, vt, qt = (t(a).requires_grad_(True) for a in (k, v, q))
    out = mha(kt, vt, qt, mask=t(mask))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    (out ** 2).sum().backward()
    for a, g in ((kt, gk), (vt, gv), (qt, gq)):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(g), **GRAD_TOL)
    gwant = attention_state_dict(to_numpy(gp), proj)
    for name, p in mha.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), gwant[name].numpy(),
                                   err_msg=name, **GRAD_TOL)
    assert not any("projection" in n for n, _ in mha.named_parameters())


def test_all_masked_task_is_nan_inside_and_gated_to_zero():
    ep = episode(5, shots=(0, 3))
    jmodel, variables = jax_model("attention")
    want = np.asarray(jmodel.apply(variables, ep["ctx_x"], ep["ctx_y"],
                                   ep["qry_x"], ctx_mask=ep["ctx_mask"]).mu)
    model = port_model("attention", variables)
    out = model(t(ep["ctx_x"]), t(ep["ctx_y"]), t(ep["qry_x"]),
                ctx_mask=t(ep["ctx_mask"]))
    np.testing.assert_allclose(out.mu.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL)
    assert np.isfinite(want).all()
    # inside, the empty task's attention divides 0 by 0
    q, k, v = _qkv(6)
    core = kfavor.favor_attention(t(q), t(k), t(v), t(_projection()),
                                  t(ep["ctx_mask"]))
    assert torch.isnan(core[0]).all() and torch.isfinite(core[1]).all()


# -- no CPU fallback for a CUDA launch -----------------------------------------

def test_launchers_refuse_cpu_tensors():
    x = torch.rand(1, 16, 16, 1)
    enc = LiteratureEncoder(8, (16, 16, 1))
    with pytest.raises(TypeError):
        kstem.stem_launch(x, enc[0].weight, enc[0].bias, enc[2].weight,
                          enc[2].bias)
    q, k, v = (t(a) for a in _qkv(0))
    with pytest.raises(TypeError):
        kfavor.favor_launch(q, k, v, t(_projection()))
    with pytest.raises(TypeError):
        kfeatures.features_launch(torch.rand(2, 3, 4, 4, 64),
                                  torch.rand(2, 3, 64, 64, 3, 3),
                                  torch.rand(2, 3, 64), torch.rand(3, 64),
                                  torch.rand(3, 64))
