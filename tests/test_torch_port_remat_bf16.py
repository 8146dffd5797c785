"""``maml_remat`` in bfloat16 against the JAX package on the CPU: under
``step``, MAMLShapeNet1D's and MMAMLShapeNet1D's second-order outer loss and
gradients (``compute_dtype: bfloat16``; float32 parameters and gradients)
against JAX's bfloat16 and float32 runs under the same mode, within the
bf16 rule (``test_torch_port_bf16.py``).
"""

import pytest
import torch

from test_torch_port_bf16 import assert_bf16_close, assert_nearer_overall
from test_torch_port_remat import _case, one_thread  # noqa: F401
from test_torch_port_remat_jax import _jax_grads
from torch_port_common import t
from wmfml_tpu_torch.ops.cast import set_compute_dtype
from wmfml_tpu_torch.train.maml import build_maml_outer
from wmfml_tpu_torch.train.mmaml import build_mmaml_outer


@pytest.mark.parametrize("method", ["MAMLShapeNet1D", "MMAMLShapeNet1D"])
def test_remat_in_bf16_follows_the_bf16_rule(method):
    """``compute_dtype: bfloat16`` under ``maml_remat: step``: the outer
    loss and every gradient against JAX's bf16 and f32 runs under the same
    mode, within the bf16 rule (``test_torch_port_bf16.py``)."""
    want = {dt: _jax_grads(method, "step", dt)
            for dt in ("bfloat16", "float32")}
    *_, raw, model, cfg = _case(method, "step", compute_dtype="bfloat16")
    set_compute_dtype(model, torch.bfloat16)
    batch = {k: t(v) for k, v in raw.items()}
    if method == "MMAMLShapeNet1D":
        loss = build_mmaml_outer(model, cfg, 2, train=True, test=False)(batch)
    else:
        loss = build_maml_outer(model, cfg, 2, train=True, test=False)(
            batch)[0]
    assert loss.dtype == torch.float32
    assert_bf16_close(loss, want["bfloat16"][0], want["float32"][0], "loss")
    loss.backward()
    assert_nearer_overall([assert_bf16_close(
        p.grad, want["bfloat16"][1][name], want["float32"][1][name], name,
        nearer=False) for name, p in model.named_parameters()], "gradients")
