"""Shared set-up of the PyTorch port's parity tests (``test_torch_port_*``).

Inputs come from numpy seeds and go to both frameworks as numpy arrays. The
JAX side runs on the CPU as the JAX package's own tests do; the port's
modules get the JAX model's weights through ``load_jax_variables``, so the
two compute the same function from the same parameters.

Tolerance: float32, rtol 1e-5 / atol 1e-5 unless a test says why not.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from wmfml_tpu.models.neural_process import SmallCNP as JaxSmallCNP
from wmfml_tpu_torch.ckpt.jax_params import jax_to_state_dict, load_jax_variables
from wmfml_tpu_torch.models.neural_process import SmallCNP

RTOL = ATOL = 1e-5
# gradients sum over every pixel of the batch in another order in each
# framework; they keep about five significant digits
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)

# small widths: T tasks, S context rows (padded), Q queries, HW x HW images
T, S, Q, HW = 2, 4, 3, 32
WIDTHS = dict(dim_w=16, n_hidden_units_r=(10, 10), dim_r=12, dim_z=8)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for each test of a module that imports this
    fixture: under ``pytest -n 6`` the workers' threads share the host's
    cores, and at these sizes torch's threads only add synchronisation (a
    ShapeNet3D fused-call test takes 16.7 s alone on one thread and 17.7 s
    on eight, 142 s under six workers of eight threads each); the previous
    count is restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def episode(seed: int, shots=(S, 2), hw: int = HW, t: int = T, s: int = S,
            q: int = Q):
    """A model-facing episode: float images, [cos, sin, a] labels, mask."""
    rng = np.random.RandomState(seed)
    a_ctx = rng.uniform(0, 2 * np.pi, (t, s, 1)).astype(np.float32)
    a_qry = rng.uniform(0, 2 * np.pi, (t, q, 1)).astype(np.float32)
    enc = lambda a: np.concatenate([np.cos(a), np.sin(a), a], -1)  # noqa: E731
    return dict(ctx_x=rng.rand(t, s, hw, hw, 1).astype(np.float32),
                ctx_y=enc(a_ctx).astype(np.float32),
                ctx_mask=np.arange(s)[None, :] < np.asarray(shots)[:, None],
                qry_x=rng.rand(t, q, hw, hw, 1).astype(np.float32),
                qry_y=enc(a_qry).astype(np.float32))


def jax_model(agg_mode: str, hw: int = HW, seed: int = 0):
    """JAX SmallCNP on its main-path lowering (``stem_impl='s2d'``) and its
    variables as numpy."""
    w = WIDTHS
    model = JaxSmallCNP(dim_w=w["dim_w"], n_hidden_units_r=w["n_hidden_units_r"],
                        dim_r=w["dim_r"], dim_z=w["dim_z"], y_dim=2,
                        agg_mode=agg_mode, tanh_out=True, stem_impl="s2d")
    ep = episode(seed, hw=hw)
    variables = model.init(jax.random.PRNGKey(seed), ep["ctx_x"], ep["ctx_y"],
                           ep["qry_x"], ctx_mask=ep["ctx_mask"])
    return model, to_numpy(variables)


def port_model(agg_mode: str, variables, hw: int = HW) -> SmallCNP:
    w = WIDTHS
    model = SmallCNP(dim_w=w["dim_w"], n_hidden_units_r=w["n_hidden_units_r"],
                     dim_r=w["dim_r"], dim_z=w["dim_z"], y_dim=2, label_dim=3,
                     agg_mode=agg_mode, tanh_out=True, img_size=(hw, hw, 1),
                     generator=torch.Generator().manual_seed(0))
    return load_jax_variables(model, variables)


def jax_grads_as_port(model: SmallCNP, grads, variables):
    """JAX parameter gradients in the port's layout (the weight carry is a
    linear re-layout, so it maps gradients as it maps weights)."""
    mapped = jax_to_state_dict(model, {"params": to_numpy(grads),
                                       "favor": variables.get("favor")})
    names = dict(model.named_parameters())
    return {k: v for k, v in mapped.items() if k in names}


def assert_grads_match(model: SmallCNP, want):
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   err_msg=name, **GRAD_TOL)


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


__all__ = ["ATOL", "GRAD_TOL", "HW", "Q", "RTOL", "S", "T", "WIDTHS",
           "assert_grads_match", "episode", "jax_grads_as_port", "jax_model",
           "port_model", "t", "to_numpy"]
