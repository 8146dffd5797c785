"""Flax's ``dtype=`` for the port's plain layers (``compute_dtype``).

In the JAX package a layer built with ``dtype=bfloat16`` keeps its
parameters in float32, casts its input and its parameters to bfloat16 and
returns bfloat16: ``nn.Dense`` and ``nn.Conv`` round the product (summed in
float32) to bfloat16, then add the bias, which rounds again. These helpers
compute the same, with explicit casts (``torch.autocast`` keeps some ops in
float32 and rounds elsewhere). In float32 each is the plain PyTorch call the
port makes without them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from wmfml_tpu_torch.parallel import tp

F32 = torch.float32


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           dtype: torch.dtype = F32) -> torch.Tensor:
    """``x @ w.T + b`` in ``dtype`` (``nn.Dense``); w [out, in]. On a
    model shard ``w`` (``parallel/tp.py``) column-parallel: this rank's
    output features, gathered, then the bias."""
    if tp.shard_of(w) is not None:
        if dtype == F32 and x.dtype == F32:
            return tp.column(F.linear, x, w, b, -1)
        return tp.column(lambda x_, w_: torch.matmul(
            x_.to(dtype), w_.to(dtype).t()), x, w, b.to(dtype), -1)
    if dtype == F32 and x.dtype == F32:
        return F.linear(x, w, b)
    return torch.matmul(x.to(dtype), w.to(dtype).t()) + b.to(dtype)


def bmm_bias(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """Per task ``x @ w.transpose(1, 2) + b`` in x's dtype: x [T, N, in],
    w [T, out, in], b [T, out]."""
    if x.dtype == F32:
        return torch.baddbmm(b[:, None, :], x, w.transpose(1, 2))
    return torch.bmm(x, w.to(x.dtype).transpose(1, 2)) + b.to(x.dtype)[:, None]


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
           **kw):
    """``F.conv2d`` (NCHW) in x's dtype (``nn.Conv``): the product rounded
    to it, then the bias added where there is one (``b`` None:
    ``use_bias=False``). On a model shard ``w`` column-parallel: this
    rank's output channels, gathered, then the bias."""
    if tp.shard_of(w) is not None:
        return tp.column(lambda x_, w_: F.conv2d(x_, w_.to(x.dtype), None,
                                                 **kw), x, w,
                         None if b is None else b.to(x.dtype)[:, None, None],
                         1)
    if x.dtype == F32:
        return F.conv2d(x, w, b, **kw)
    y = F.conv2d(x, w.to(x.dtype), None, **kw)
    return y if b is None else y + b.to(x.dtype)[:, None, None]


def rounded(value: float, dtype: torch.dtype) -> float:
    """A Python number as ``dtype`` holds it: JAX casts a Python scalar
    that meets a bfloat16 array to bfloat16 before the operation."""
    return torch.tensor(value, dtype=dtype).item()


def set_compute_dtype(module: torch.nn.Module, dtype: torch.dtype):
    """Set ``compute_dtype`` on every submodule that has one."""
    for m in module.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = dtype
    return module
