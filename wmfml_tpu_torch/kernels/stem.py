"""K1: the fused literature stem (conv0 + ReLU + conv1 + ReLU + 2x2 max pool).

Replaces ``wmfml_tpu/nn/encoders.py:_s2d_stem`` (+ ``_s2d``) and the
``max_pool2(..., "window")`` that follows it in ``LiteratureEncoder``. The
CUDA source, ``csrc/stem.cu``, says what bounds the kernel and how its
design answers that; in short it keeps the [B, H/2, W/2, 32] conv0 map in
shared memory and is bound by f32 arithmetic.

``literature_stem`` is the wrapper the encoder calls. A CPU tensor takes the
plain PyTorch twin ``stem_plain``; a CUDA tensor launches the kernel or
raises. The JAX package has no backward kernel for the stem (plain
autodiff), so the backward recomputes through the plain twin and returns
gradients for the weights only: images are leaves. ``F.max_pool2d`` routes a
pool gradient to the first maximum in raster order, as ``window`` does.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from wmfml_tpu_torch.kernels import build

C0, C1 = 32, 48


def stem_plain(x, w0, b0, w1, b1):
    """x [B, H, W, Ci]; w0 [32, Ci, 3, 3]; w1 [48, 32, 3, 3] (torch OIHW).
    Returns [B, H/8, W/8, 48] (NHWC, like the JAX stem + pool)."""
    h = x.permute(0, 3, 1, 2)
    h = F.relu(F.conv2d(h, w0, b0, stride=2, padding=1))
    h = F.relu(F.conv2d(h, w1, b1, stride=2, padding=1))
    return F.max_pool2d(h, 2).permute(0, 2, 3, 1)


def _check(x, w0, b0, w1, b1):
    tensors = (x, w0, b0, w1, b1)
    if any(t.device.type != "cuda" or t.dtype != torch.float32
           for t in tensors):
        raise TypeError("fused stem takes float32 CUDA tensors only")
    if x.dim() != 4 or x.shape[1] % 8 or x.shape[2] % 8:
        raise ValueError(f"fused stem needs [B, H, W, C] with H, W % 8 == 0; "
                         f"got {tuple(x.shape)}")
    ci = x.shape[3]
    if (tuple(w0.shape) != (C0, ci, 3, 3) or tuple(b0.shape) != (C0,)
            or tuple(w1.shape) != (C1, C0, 3, 3) or tuple(b1.shape) != (C1,)):
        raise ValueError("fused stem weights must be conv0 [32, Ci, 3, 3] and "
                         "conv1 [48, 32, 3, 3] with matching biases")


def stem_launch(x, w0, b0, w1, b1):
    """Run the CUDA kernel once (no autograd, no launch count)."""
    _check(x, w0, b0, w1, b1)
    lib = build.load("stem")
    x = x.contiguous()
    b, h, w, ci = x.shape
    w0k = w0.permute(1, 2, 3, 0).contiguous()           # [Ci, 3, 3, 32]
    w1k = w1.permute(1, 2, 3, 0).contiguous()           # [32, 3, 3, 48]
    b0c, b1c = b0.contiguous(), b1.contiguous()
    out = torch.empty((b, h // 8, w // 8, C1), device=x.device,
                      dtype=torch.float32)
    tiles = b * ((h // 8 + 3) // 4) * ((w // 8 + 3) // 4)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    grid = max(1, min(tiles, 2 * sms))
    fn = lib.wmfml_stem_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), w0k.data_ptr(), b0c.data_ptr(), w1k.data_ptr(),
             b1c.data_ptr(), out.data_ptr(), b, h, w, ci, grid,
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused stem launch failed: cudaError {err}")
    return out


class _FusedStem(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w0, b0, w1, b1):
        ctx.save_for_backward(x, w0, b0, w1, b1)
        out = stem_launch(x, w0, b0, w1, b1)
        literature_stem.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        x, *weights = ctx.saved_tensors
        with torch.enable_grad():
            ws = [t.detach().requires_grad_(True) for t in weights]
            y = stem_plain(x.detach(), *ws)
        return (None, *torch.autograd.grad(y, ws, g))


def literature_stem(x, w0, b0, w1, b1):
    """conv0 (s2) + ReLU + conv1 (s2) + ReLU + 2x2 max pool, NHWC in/out."""
    if x.device.type == "cpu":
        return stem_plain(x, w0, b0, w1, b1)
    return _FusedStem.apply(x, w0, b0, w1, b1)


literature_stem.launches = 0
