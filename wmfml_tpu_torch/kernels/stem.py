"""K1: the fused literature stem (conv0 + ReLU + conv1 + ReLU + 2x2 max pool).

Replaces ``wmfml_tpu/nn/encoders.py:_s2d_stem`` (+ ``_s2d``) and the
``max_pool2`` that follows it in ``LiteratureEncoder``. The CUDA source,
``csrc/stem.cu``, says what bounds the kernel and how its design answers
that; in short it keeps the [B, H/2, W/2, 32] conv0 map in shared memory and
is bound by arithmetic.

Weights are shared by the whole batch (conv0 [32, Ci, 3, 3], the CNP/ANP
encoder) or per task (conv0 [T, 32, Ci, 3, 3], the MAML inner loop): image
``b`` then uses task ``b // (B / T)``'s weights.

conv1 runs on the tensor cores in 3xTF32 (``kernels/tf32.py``), so its
results keep float32's accuracy; the ``torch.backends`` TF32 flags do not
reach it.

bfloat16 (``compute_dtype: bfloat16``): the images and all four weights come
in as bfloat16 (the encoder casts them, as the JAX stem does,
``wmfml_tpu/nn/encoders.py:266-268``) and the pooled map goes out in
bfloat16. As in the JAX stem each convolution sums in float32 and rounds to
bfloat16, then its bias add rounds again; the pool takes the rounded values.
The kernel runs conv0 on the CUDA cores from the bfloat16 inputs and conv1
as one bfloat16 tensor-core product a step, summed in float32.

``literature_stem`` is the wrapper the encoders call. A CPU tensor takes the
plain PyTorch twin ``stem_plain``; a CUDA tensor launches the kernel or
raises. The JAX package has no backward kernel for the stem (plain
autodiff), so the backward recomputes through the plain twin on the saved
tensors themselves and returns the gradients asked for, the images' among
them. Under ``create_graph`` that recomputation is recorded, so the
gradient is differentiable again, as second-order MAML needs.
``F.max_pool2d`` routes a pool gradient to the first maximum in raster
order; JAX's ``slice`` pool routes ties elsewhere, but ties sit at ReLU
zeros, where the gradient is 0 either way.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from wmfml_tpu_torch.kernels import build
from wmfml_tpu_torch.kernels.tf32 import gmma_b_layout, tf32_split
from wmfml_tpu_torch.ops.cast import conv2d

C0, C1 = 32, 48
DTYPES = (torch.float32, torch.bfloat16)


def stem_plain(x, w0, b0, w1, b1):
    """x [B, H, W, Ci]; w0 [32, Ci, 3, 3] or [T, 32, Ci, 3, 3] per task
    (torch OIHW), likewise b0, w1 [(T,) 48, 32, 3, 3], b1. Returns
    [B, H/8, W/8, 48] (NHWC, like the JAX stem + pool), in x's dtype
    (``ops/cast.py:conv2d``)."""
    if w0.dim() == 4:                     # shared: the one-task case
        w0, b0, w1, b1 = (w.unsqueeze(0) for w in (w0, b0, w1, b1))
    # the tasks side by side on the channel axis, grouped convolutions
    t = w0.shape[0]
    b, hh, ww, ci = x.shape
    n = b // t
    h = x.reshape(t, n, hh, ww, ci).permute(1, 0, 4, 2, 3).reshape(
        n, t * ci, hh, ww)
    h = F.relu(conv2d(h, w0.reshape(t * C0, ci, 3, 3), b0.reshape(-1),
                      stride=2, padding=1, groups=t))
    h = F.relu(conv2d(h, w1.reshape(t * C1, C0, 3, 3), b1.reshape(-1),
                      stride=2, padding=1, groups=t))
    h = F.max_pool2d(h, 2)
    return h.reshape(n, t, C1, hh // 8, ww // 8).permute(1, 0, 3, 4, 2).reshape(
        b, hh // 8, ww // 8, C1)


def _check(x, w0, b0, w1, b1):
    tensors = (x, w0, b0, w1, b1)
    if any(t.device.type != "cuda" or t.dtype != x.dtype for t in tensors) \
            or x.dtype not in DTYPES:
        raise TypeError("fused stem takes CUDA tensors, all float32 or all "
                        "bfloat16")
    if x.dim() != 4 or x.shape[1] % 8 or x.shape[2] % 8:
        raise ValueError(f"fused stem needs [B, H, W, C] with H, W % 8 == 0; "
                         f"got {tuple(x.shape)}")
    ci = x.shape[3]
    lead = tuple(w0.shape[:1]) if w0.dim() == 5 else ()   # (T,) per task
    if (tuple(w0.shape) != (*lead, C0, ci, 3, 3)
            or tuple(b0.shape) != (*lead, C0)
            or tuple(w1.shape) != (*lead, C1, C0, 3, 3)
            or tuple(b1.shape) != (*lead, C1)):
        raise ValueError("fused stem weights must be conv0 [(T,) 32, Ci, 3, 3] "
                         "and conv1 [(T,) 48, 32, 3, 3] with matching biases")
    if lead and x.shape[0] % lead[0]:
        raise ValueError(f"{x.shape[0]} images do not split into {lead[0]} "
                         "tasks")


def pack_conv1(w1, tasks):
    """conv1 [(T,) 48, 32, 3, 3] -> float32 [T, 2, 48 * 288]: K = (kh, kw,
    c_in), split big | small, each in wgmma B order; bfloat16 [T, 1,
    48 * 288], as it is, in that order. The plain twin of the packing the
    kernel does as it stages the weights (``pack_conv1_launch``)."""
    k = w1.reshape(tasks, C1, C0, 3, 3).permute(0, 1, 3, 4, 2).reshape(
        tasks, C1, 9 * C0).contiguous()
    parts = tf32_split(k) if w1.dtype == torch.float32 else (k,)
    return torch.stack([gmma_b_layout(p) for p in parts],
                       1).reshape(tasks, len(parts), C1 * 9 * C0)


def pack_conv1_launch(w1, tasks):
    """The kernel's conv1 packing alone, on the card (for tests)."""
    lib = build.load("stem")
    w1 = w1.contiguous()
    bf16 = w1.dtype == torch.bfloat16
    out = torch.empty((tasks, 1 if bf16 else 2, C1 * 9 * C0),
                      device=w1.device, dtype=w1.dtype)
    fn = lib.wmfml_stem_pack
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(w1.data_ptr(), out.data_ptr(), tasks, int(bf16),
             torch.cuda.current_stream(w1.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stem pack launch failed: cudaError {err}")
    return out


def stem_launch(x, w0, b0, w1, b1):
    """Run the CUDA kernel once (no autograd, no launch count)."""
    _check(x, w0, b0, w1, b1)
    lib = build.load("stem")
    x = x.contiguous()
    b, h, w, ci = x.shape
    tasks = w0.shape[0] if w0.dim() == 5 else 1
    w0, b0, w1, b1 = (a.contiguous() for a in (w0, b0, w1, b1))
    out = torch.empty((b, h // 8, w // 8, C1), device=x.device,
                      dtype=x.dtype)
    fn = lib.wmfml_stem_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), w0.data_ptr(), b0.data_ptr(), w1.data_ptr(),
             b1.data_ptr(), out.data_ptr(), b, h, w, ci, b // tasks,
             int(x.dtype == torch.bfloat16),
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
        literature_stem.bf16_launches += x.dtype == torch.bfloat16
        return out

    @staticmethod
    def backward(ctx, g):
        inputs = ctx.saved_tensors
        need = ctx.needs_input_grad
        wanted = [a for a, n in zip(inputs, need) if n]
        with torch.enable_grad():
            y = stem_plain(*inputs)
        grads = iter(torch.autograd.grad(
            y, wanted, g, create_graph=torch.is_grad_enabled()))
        return tuple(next(grads) if n else None for n in need)


def literature_stem(x, w0, b0, w1, b1):
    """conv0 (s2) + ReLU + conv1 (s2) + ReLU + 2x2 max pool, NHWC in/out;
    weights shared or per task, as in ``stem_plain``."""
    if x.device.type == "cpu":
        return stem_plain(x, w0, b0, w1, b1)
    return _FusedStem.apply(x, w0, b0, w1, b1)


literature_stem.launches = 0          # every launch on the path
literature_stem.bf16_launches = 0     # those in bfloat16
