"""``maml_remat`` against the JAX package on the CPU: for
MAMLShapeNet1D, MAMLMRShapeNet1D (JAX's BBB draws fed to the port),
Pascal1D's VanillaMAML and MMAMLShapeNet1D at the small widths of
``tests/test_torch_port_remat.py``, the second-order outer loss and
gradients under ``step`` and ``dots`` against JAX's under the same mode,
within the parity tests' tolerances in float32 (``test_torch_port_maml.py``'s
``MAML_GRAD_ATOL`` rule); ``_jax_grads`` also serves
``tests/test_torch_port_remat_bf16.py``.
"""

import functools
import re

import jax
import numpy as np
import pytest

from test_torch_port_bf16 import _as_written
from test_torch_port_maml import MAML_GRAD_ATOL
from test_torch_port_mmaml import _jax_bundle
from test_torch_port_mr import _maml_eps
from test_torch_port_remat import METHODS, MODES, _case, one_thread  # noqa: F401
from torch_port_common import GRAD_TOL, RTOL, t, to_numpy
from wmfml_tpu.train.maml import build_maml_outer as jax_maml_outer
from wmfml_tpu.train.mmaml import build_mmaml_outer as jax_mmaml_outer
from wmfml_tpu_torch.ckpt.jax_params import maml_state_dict, mmaml_state_dict
from wmfml_tpu_torch.nn.bbb import EpsFeed
from wmfml_tpu_torch.train.maml import build_maml_outer
from wmfml_tpu_torch.train.mmaml import build_mmaml_outer


@functools.lru_cache(maxsize=None)
def _jax_grads(method, mode, dtype="float32"):
    """JAX's outer loss and gradients (as the port's state_dict) under
    ``maml_remat=mode``, compiled to round where its code rounds."""
    jm, jcfg, params, raw, pm, _ = _case(method, mode, compute_dtype=dtype)
    key = jax.random.PRNGKey(0)
    if method == "MMAMLShapeNet1D":
        outer = jax_mmaml_outer(_jax_bundle(dtype=jax.numpy.bfloat16
                                            if dtype == "bfloat16" else None),
                                jcfg, 2, train=True, test=False)
        loss, grads = _as_written(jax.jit(jax.value_and_grad(
            lambda p, b: outer(p, b, key))), params, raw)
        return float(loss), mmaml_state_dict({"params": to_numpy(grads)})
    outer = jax_maml_outer(jm, jcfg, 2, train=True, test=False)
    (loss, _), grads = _as_written(jax.jit(jax.value_and_grad(
        lambda p, b: outer(p, b, key), has_aux=True)), params, raw)
    return float(loss), maml_state_dict(pm, {"params": to_numpy(grads)})


def _jax_noise(method, case):
    """JAX's BBB draws for MAMLMR (fed to the port), else None."""
    if method != "MAMLMRShapeNet1D":
        return None
    jm, _, net, _, pm, _ = case
    return EpsFeed(_maml_eps(jm, net, 2, pm.encoder_w.flatten_chw))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("method", METHODS)
def test_remat_matches_jax_under_the_same_mode(method, mode):
    """The port under ``maml_remat=mode`` against JAX under the same mode:
    the outer loss within rtol 1e-5, the gradients within the MAML parity
    rule (``GRAD_TOL`` and 1e-3 of each tensor's largest entry; Pascal1D's
    BN-fed conv biases against the largest gradient, as in
    ``test_torch_port_pascal.py``)."""
    case = _case(method, mode)
    want_loss, want = _jax_grads(method, mode)
    *_, raw, model, cfg = case
    batch = {k: t(v) for k, v in raw.items()}
    if method == "MMAMLShapeNet1D":
        loss = build_mmaml_outer(model, cfg, 2, train=True, test=False)(batch)
    else:
        loss = build_maml_outer(model, cfg, 2, train=True, test=False)(
            batch, noise=_jax_noise(method, case))[0]
    np.testing.assert_allclose(loss.item(), want_loss, rtol=RTOL)
    loss.backward()
    _assert_state_grads(model, want, pascal=method == "VanillaMAML")


def _assert_state_grads(model, want, pascal=False):
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(want)
    largest = max(np.abs(w.numpy()).max() for w in want.values())
    for name, p in model.named_parameters():
        w = want[name].numpy()
        atol = max(GRAD_TOL["atol"], MAML_GRAD_ATOL * np.abs(w).max())
        if pascal and re.fullmatch(r"features\.layer\d\.conv\.bias", name):
            atol = MAML_GRAD_ATOL * largest
        np.testing.assert_allclose(p.grad.numpy(), w, err_msg=name,
                                   rtol=GRAD_TOL["rtol"], atol=atol)
