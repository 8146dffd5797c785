"""K3: the MAML features block (layers 2-4 of ``MAMLRegressor``), per task.

Replaces ``scripts/proto_maml_pallas_conv.py:96 features_block_pallas``:
per task, L x {3x3 stride-1 same conv with per-task weights and bias,
batch-statistics BN over the task's real context rows, shared scale/bias,
ReLU}. ``csrc/features.cu`` says what bounds the kernel (tensor-core
operations) and how it runs each layer as an implicit GEMM per task on the
tensor cores, in 3xTF32 so that its results keep float32's accuracy; the
``torch.backends`` TF32 flags do not reach it.

bfloat16 (``compute_dtype: bfloat16``): x, the weights, biases, BN scale and
bias all come in as bfloat16 (the model casts them, as the JAX ``nn.Conv``
and ``masked_batch_norm(h, mask, scale.astype(h.dtype), ...)`` do) and the
block returns bfloat16. Each conv sums in float32 and rounds, its bias add
rounds; the statistics sum the bfloat16 values and their rounded squares in
float32 (``wmfml_tpu/models/maml.py:60-67``); the normalisation rounds at
each of its four operations. The kernel applies that BN + ReLU as it loads
the previous layer's bfloat16 output, runs one bfloat16 tensor-core product
a step (summed in float32) and writes bfloat16 with float32 partial sums.

``masked_batch_norm`` is ``wmfml_tpu/models/maml.py:40`` with a task axis:
one pass (E[x^2] - E[x]^2, summed in float32 or wider), var clamped at 0,
denominator ``max(sum(mask) * H * W, 1)``, eps 1e-5. In bfloat16 the mean
and 1/std are rounded to bfloat16 before they meet x, as in the JAX
function.

``maml_features`` is the wrapper the model calls. A CPU tensor takes the
plain twin ``features_plain``; a CUDA tensor launches the kernel or raises.
The JAX package has no backward kernel for this block, so the backward
recomputes through the plain twin on the saved tensors with
``create_graph=torch.is_grad_enabled()``: the inner loop's gradient is
differentiable again, as second-order MAML needs.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
import torch.nn.functional as F

from wmfml_tpu_torch.kernels import build
from wmfml_tpu_torch.kernels.tf32 import gmma_b_layout, tf32_split
from wmfml_tpu_torch.ops.cast import conv2d

C = 64            # the kernel's channel count (num_filters of every shipped YAML)
EPS = 1e-5
TILE = 128        # pixel rows of one block: two warpgroups of 64
MAX_W = 128       # widest image whose staged rows fit a block
DTYPES = (torch.float32, torch.bfloat16)


def masked_batch_norm(x, mask: Optional[torch.Tensor], scale=None, bias=None,
                      eps: float = EPS):
    """BN over (N, H, W) of each task, counting only mask == True rows.

    x [T, N, H, W, C]; mask [T, N] bool or None; scale/bias [C] or None."""
    acc = torch.promote_types(x.dtype, torch.float32)
    t, n, h, w, _ = x.shape
    if mask is None:
        # a true division (a Python divisor multiplies by its reciprocal on
        # the card), by a scalar filled on the device: no host copy
        denom = torch.full((), float(n * h * w), dtype=acc, device=x.device)
        s1 = x.sum((1, 2, 3), dtype=acc)
        s2 = x.square().sum((1, 2, 3), dtype=acc)
    else:
        m = mask[:, :, None, None, None].to(x.dtype)
        denom = (m.sum((1, 2, 3, 4), dtype=acc) * (h * w)).clamp_min(1.0)[:, None]
        s1 = (x * m).sum((1, 2, 3), dtype=acc)
        s2 = (x.square() * m).sum((1, 2, 3), dtype=acc)
    mean = s1 / denom                                        # [T, C]
    var = (s2 / denom - mean.square()).clamp_min(0.0)
    shape = (t, 1, 1, 1, -1)
    y = ((x - mean.to(x.dtype).reshape(shape))
         * torch.rsqrt(var + eps).to(x.dtype).reshape(shape))
    if scale is None:
        return y
    return y * scale + bias


def features_plain(x, w, b, scale, bias, mask: Optional[torch.Tensor] = None):
    """x [T, N, H, W, C] NHWC; w [T, L, C, C, 3, 3] (per task, OIHW per
    layer); b [T, L, C]; scale, bias [L, C] shared; mask [T, N] bool or None.
    Returns ReLU(BN(conv(...))) after L layers, [T, N, H, W, C], in x's
    dtype (``ops/cast.py:conv2d``)."""
    t, n, h, wd, c = x.shape
    for layer in range(w.shape[1]):
        hh = x.permute(1, 0, 4, 2, 3).reshape(n, t * c, h, wd)
        hh = conv2d(hh, w[:, layer].reshape(t * c, c, 3, 3),
                    b[:, layer].reshape(-1), padding=1, groups=t)
        x = hh.reshape(n, t, c, h, wd).permute(1, 0, 3, 4, 2)
        x = F.relu(masked_batch_norm(x, mask, scale[layer], bias[layer]))
    return x


def pack_weights(w):
    """[T, L, Co, Ci, 3, 3] -> float32 [T, L, 9, 2, Co * Ci]: per task,
    layer and tap the weights split big | small, each in wgmma B order;
    bfloat16 [T, L, 9, 1, Co * Ci], as they are, in that order. The plain
    twin of the kernel's own packing launch (``pack_launch``)."""
    t, layers = w.shape[:2]
    taps = w.permute(0, 1, 4, 5, 2, 3).reshape(t, layers, 9, C, C).contiguous()
    parts = tf32_split(taps) if w.dtype == torch.float32 else (taps,)
    return torch.stack([gmma_b_layout(p) for p in parts], 3).reshape(
        t, layers, 9, len(parts), C * C)


def _parts(dtype) -> int:
    return 2 if dtype == torch.float32 else 1


def pack_launch(w):
    """The kernel's weight packing alone, on the card (for tests)."""
    lib = build.load("features")
    w = w.contiguous()
    wk = torch.empty((*w.shape[:2], 9, _parts(w.dtype), C * C),
                     device=w.device, dtype=w.dtype)
    fn = lib.wmfml_features_pack
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(w.data_ptr(), wk.data_ptr(), w.shape[0] * w.shape[1],
             int(w.dtype == torch.bfloat16),
             torch.cuda.current_stream(w.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"features pack launch failed: cudaError {err}")
    return wk


def features_launch(x, w, b, scale, bias, mask: Optional[torch.Tensor] = None):
    """Run the CUDA kernels once (no autograd, no launch count)."""
    tensors = (x, w, b, scale, bias)
    if any(a.device.type != "cuda" or a.dtype != x.dtype for a in tensors) \
            or x.dtype not in DTYPES:
        raise TypeError("features kernel takes CUDA tensors, all float32 or "
                        "all bfloat16")
    if x.dim() != 5 or x.shape[-1] != C:
        raise ValueError(f"features kernel takes x [T, N, H, W, {C}]; "
                         f"got {tuple(x.shape)}")
    t, n, h, wd, _ = x.shape
    layers = w.shape[1] if w.dim() == 6 else 0
    if (layers < 1 or tuple(w.shape) != (t, layers, C, C, 3, 3)
            or tuple(b.shape) != (t, layers, C)
            or tuple(scale.shape) != (layers, C)
            or tuple(bias.shape) != (layers, C)):
        raise ValueError(f"features kernel weights must be [T, L, {C}, {C}, 3, 3] "
                         f"with biases [T, L, {C}] and BN scale/bias [L, {C}]; "
                         f"got {tuple(w.shape)}, {tuple(b.shape)}, "
                         f"{tuple(scale.shape)}, {tuple(bias.shape)}")
    if wd > MAX_W:
        raise ValueError(f"features kernel needs W <= {MAX_W}; got {wd}")
    if mask is not None and (tuple(mask.shape) != (t, n)
                             or mask.device != x.device):
        raise ValueError(f"features mask must be [T, N] = {(t, n)} on the "
                         f"same device; got {tuple(mask.shape)}")
    lib = build.load("features")
    x = x.contiguous()
    if x.data_ptr() % 16:                 # the kernel reads x in 16 bytes
        x = x.clone()
    w, b = w.contiguous(), b.contiguous()
    scale, bias = scale.contiguous(), bias.contiguous()
    # the kernel reads one byte per row, 0 for a padded one: bool as it is
    mask_u8 = None if mask is None else mask.to(torch.bool).contiguous()
    # scratch for the packed weights; fresh, so 16-byte aligned
    wk = torch.empty((t, layers, 9, _parts(x.dtype), C * C), device=x.device,
                     dtype=x.dtype)
    y0 = torch.empty_like(x)
    y1 = torch.empty_like(x) if layers > 1 else y0
    part = torch.empty((layers, t, math.ceil(n * h * wd / TILE), 2, C),
                       device=x.device, dtype=torch.float32)
    out = torch.empty_like(x)
    fn = lib.wmfml_features_fwd
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), w.data_ptr(), wk.data_ptr(), b.data_ptr(),
             scale.data_ptr(), bias.data_ptr(),
             None if mask_u8 is None else mask_u8.data_ptr(),
             y0.data_ptr(), y1.data_ptr(), part.data_ptr(), out.data_ptr(),
             t, n, h, wd, layers, EPS, int(x.dtype == torch.bfloat16),
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"features kernel launch failed: cudaError {err}")
    return out


class _Features(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, scale, bias, mask):
        ctx.save_for_backward(x, w, b, scale, bias, mask)
        out = features_launch(x, w, b, scale, bias, mask)
        maml_features.launches += 1
        maml_features.bf16_launches += x.dtype == torch.bfloat16
        return out

    @staticmethod
    def backward(ctx, g):
        *inputs, mask = ctx.saved_tensors
        need = ctx.needs_input_grad[:5]
        wanted = [a for a, n in zip(inputs, need) if n]
        with torch.enable_grad():
            y = features_plain(*inputs, mask)
        grads = iter(torch.autograd.grad(
            y, wanted, g, create_graph=torch.is_grad_enabled()))
        return (*(next(grads) if n else None for n in need), None)


def maml_features(x, w, b, scale, bias, mask: Optional[torch.Tensor] = None):
    """The features block; shapes as in ``features_plain``."""
    if x.device.type == "cpu":
        return features_plain(x, w, b, scale, bias, mask)
    return _Features.apply(x, w, b, scale, bias, mask)


maml_features.launches = 0            # every launch on the path
maml_features.bf16_launches = 0       # those in bfloat16
