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

``conv_bwd: phase`` (the JAX package's ``conv3x3_s2_phase``,
``wmfml_tpu/nn/encoders.py:117``): the backward is K1b
(``csrc/stem_bwd.cu``), a kernel of its own that returns the four weight
and bias gradients for the pooled map's gradient, conv1's input gradient
taken by the phase form, its products on the tensor cores. K1's forward
writes the pool's routes for it (``stem_launch(..., route=True)``: each
pooled value's first maximum in raster order, or 4 where it is not
positive), so the gradient follows the forward's own decisions and K1b
recomputes only conv0, with K1's device code (its ReLU mask is K1's). Its
plain twin, ``stem_backward_phase_plain``, recomputes the forward, routes
the pool's gradient to the first maximum in raster order, applies the ReLU
masks and takes conv1's input gradient by the same form
(``conv3x3_s2_phase_input_grad``); fed given decisions (``route``,
``mask0``) it follows those instead; the CPU runs it. K1b covers what the
four small CNP/ANP methods that read the option run: weights shared by the
batch, images without a gradient, a first-order backward. Per-task
weights, an image gradient and a backward under ``create_graph`` raise,
naming the case. ``literature_stem_backward`` counts K1b's launches as
``literature_stem`` counts K1's.
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


def stem_launch(x, w0, b0, w1, b1, route=False):
    """Run the CUDA kernel once (no autograd, no launch count). ``route``:
    also return the pool's routes, uint8 [B, H/8, W/8, 48]: each pooled
    value's window position (0-3, raster order) of its first maximum, or 4
    where the pooled value is not positive (``_first_max_route``'s rule,
    taken on the kernel's own sums; K1b's input)."""
    _check(x, w0, b0, w1, b1)
    lib = build.load("stem")
    x = x.contiguous()
    b, h, w, ci = x.shape
    tasks = w0.shape[0] if w0.dim() == 5 else 1
    w0, b0, w1, b1 = (a.contiguous() for a in (w0, b0, w1, b1))
    out = torch.empty((b, h // 8, w // 8, C1), device=x.device,
                      dtype=x.dtype)
    routes = torch.empty(out.shape, device=x.device,
                         dtype=torch.uint8) if route else None
    fn = lib.wmfml_stem_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), w0.data_ptr(), b0.data_ptr(), w1.data_ptr(),
             b1.data_ptr(), out.data_ptr(),
             None if routes is None else routes.data_ptr(), b, h, w, ci,
             b // tasks, int(x.dtype == torch.bfloat16),
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused stem launch failed: cudaError {err}")
    return (out, routes) if route else out


def conv3x3_s2_phase_input_grad(g, w, size=None):
    """The input gradient of a 3x3, stride-2, pad-1 convolution by the
    phase form (``wmfml_tpu/nn/encoders.py:140-174``): g [B, Co, Ho, Wo]
    (NCHW), w [Co, Ci, 3, 3] (OIHW) -> [B, Ci, 2 Ho, 2 Wo], in g's dtype.
    One stride-1 2x2 convolution over g padded by one at the bottom and
    the right, with a [4 Ci, Co, 2, 2] kernel whose output channel block p
    = 2a + b is the input parity (a, b) and whose entries each take one
    tap of w or zero (even parity: tap 1 at offset 0; odd: tap 2 at offset
    0 and tap 0 at offset 1), then depth-to-space in that order. ``size``,
    the input's (H, W), where it is not (2 Ho, 2 Wo) (an odd size): there,
    as in JAX, the dilated form."""
    co, ci = w.shape[:2]
    b, _, ho, wo = g.shape
    if size is not None and tuple(size) != (2 * ho, 2 * wo):
        return torch.nn.grad.conv2d_input((b, ci, *size), w.to(g.dtype), g,
                                          stride=2, padding=1)
    w = w.to(g.dtype)
    zero = torch.zeros_like(w[:, :, 0, 0])
    taps = {(0, 0): 1, (1, 0): 2, (1, 1): 0}      # (parity, offset) -> tap
    blocks = []
    for a in (0, 1):
        for b_ in (0, 1):
            rows = [[w[:, :, taps[(a, di)], taps[(b_, dj)]]
                     if (a, di) in taps and (b_, dj) in taps else zero
                     for dj in (0, 1)] for di in (0, 1)]
            blocks.append(torch.stack([torch.stack(r, -1) for r in rows],
                                      -2))                # [Co, Ci, 2, 2]
    kern = torch.stack(blocks, 0).permute(0, 2, 1, 3, 4).reshape(
        4 * ci, co, 2, 2)
    ph = conv2d(F.pad(g, (0, 1, 0, 1)), kern, None)       # [B, 4 Ci, Ho, Wo]
    return ph.reshape(b, 2, 2, ci, ho, wo).permute(0, 3, 4, 1, 5, 2).reshape(
        b, ci, 2 * ho, 2 * wo)


def _first_max_route(a1):
    """The pool's routes at conv1's outputs a1 [B, C, h, w] (post-ReLU):
    uint8 [B, C, h/2, w/2], each window's first maximum in raster order
    (0-3), or 4 where that maximum is not positive (the ReLU's mask)."""
    b, c, h, w = a1.shape
    win = a1.reshape(b, c, h // 2, 2, w // 2, 2).permute(
        0, 1, 2, 4, 3, 5).reshape(b, c, h // 2, w // 2, 4)
    top = win.amax(-1, keepdim=True)
    hit = win == top
    first = (hit & (hit.cumsum(-1) == 1)).to(torch.uint8).argmax(-1)
    return torch.where(top[..., 0] > 0, first.to(torch.uint8),
                       torch.full((), 4, dtype=torch.uint8))


def _routed(route, g):
    """The pool's gradient at conv1's outputs: each window's ``g`` [B, C,
    h/2, w/2] at the position ``route`` [B, C, h/2, w/2] names, 0 at the
    others (and at all four where the route is 4)."""
    b, c, hh, ww = g.shape
    pick = route[..., None].long() == torch.arange(4, device=route.device)
    out = torch.where(pick, g[..., None], torch.zeros((), dtype=g.dtype))
    return out.reshape(b, c, hh, ww, 2, 2).permute(
        0, 1, 2, 4, 3, 5).reshape(b, c, 2 * hh, 2 * ww)


def _first_max_routes(a1, g):
    """The pool's gradient at conv1's outputs a1 [B, C, h, w] (post-ReLU):
    each window's ``g`` [B, C, h/2, w/2] at its first maximum in raster
    order, where that maximum is positive (the ReLU's mask), else 0."""
    return _routed(_first_max_route(a1), g)


def _weight_grad(x, shape, gy):
    """A 3x3, stride-2, pad-1 convolution's weight gradient, in x's dtype."""
    return torch.nn.grad.conv2d_weight(x, shape, gy, stride=2, padding=1)


def _forward_maps(x, w0, b0, w1, b1):
    """The twin's conv0 and conv1 outputs, NCHW, post-ReLU, each
    convolution rounded as ``ops/cast.py:conv2d`` rounds it."""
    a0 = F.relu(conv2d(x.permute(0, 3, 1, 2), w0, b0, stride=2, padding=1))
    return a0, F.relu(conv2d(a0, w1.to(x.dtype), b1, stride=2, padding=1))


@torch.no_grad()
def stem_decisions_plain(x, w0, b0, w1, b1):
    """The twin's own decisions on its recomputed forward: the pool's
    routes, uint8 [B, H/8, W/8, 48] (``_first_max_route``), and conv0's
    ReLU mask, bool [B, H/2, W/2, 32] (NHWC, as the images)."""
    a0, a1 = _forward_maps(x, w0, b0, w1, b1)
    return (_first_max_route(a1).permute(0, 2, 3, 1).contiguous(),
            (a0 > 0).permute(0, 2, 3, 1).contiguous())


@torch.no_grad()
def stem_backward_phase_plain(x, w0, b0, w1, b1, g, route=None, mask0=None):
    """K1b's plain twin: (dW0, db0, dW1, db1) of the stem (weights shared
    by the batch, as ``stem_plain`` takes them) for the pooled map's
    gradient g [B, H/8, W/8, 48], in x's dtype. It recomputes the forward
    (each convolution rounded as ``ops/cast.py:conv2d`` rounds it), routes
    g to each window's first maximum in raster order (``F.max_pool2d``'s
    rule, over the rounded values in bfloat16), applies conv1's and conv0's
    ReLU masks and takes conv1's input gradient by the phase form
    (``conv3x3_s2_phase_input_grad``).

    ``route`` (uint8 [B, H/8, W/8, 48], 0-3 or 4 for none) and ``mask0``
    (conv0's ReLU mask, [B, H/2, W/2, 32]) replace the twin's own decisions
    with given ones (those K1b took: ``stem_backward_launch(...,
    debug=True)``); given its own (``stem_decisions_plain``), the result is
    the default's bit for bit."""
    xn = x.permute(0, 3, 1, 2)
    gn = g.to(x.dtype).permute(0, 3, 1, 2)
    if route is None:
        a0, a1 = _forward_maps(x, w0, b0, w1, b1)
        gy1 = _first_max_routes(a1, gn)
    else:
        a0 = F.relu(conv2d(xn, w0, b0, stride=2, padding=1))
        gy1 = _routed(route.permute(0, 3, 1, 2), gn)
    dx1 = conv3x3_s2_phase_input_grad(gy1, w1)
    live = a0 > 0 if mask0 is None else mask0.permute(0, 3, 1, 2).bool()
    gy0 = torch.where(live, dx1, torch.zeros((), dtype=dx1.dtype))
    return (_weight_grad(xn, w0.shape, gy0), gy0.sum((0, 2, 3)),
            _weight_grad(a0, w1.shape, gy1), gy1.sum((0, 2, 3)))


def _check_phase(x, w0):
    if w0.dim() == 5:
        raise NotImplementedError(
            "conv_bwd: phase (K1b) takes weights shared by the batch; "
            "per-task weights (MAML, which does not read conv_bwd) are not "
            "ported to it")


_GRID = {}


def _grid(lib, ci, bf16):
    key = (torch.cuda.current_device(), ci, bf16)
    if key not in _GRID:
        out = ctypes.c_int(0)
        fn = lib.wmfml_stem_bwd_grid
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = fn(ci, bf16, ctypes.addressof(out))
        if err != 0:
            raise RuntimeError(f"stem backward grid: cudaError {err}")
        _GRID[key] = out.value
    return _GRID[key]


def stem_backward_launch(x, w0, b0, w1, b1, g, route, debug=False):
    """Run K1b once (no launch count): (dW0, db0, dW1, db1) in x's dtype.
    ``route``: the pool's routes of K1's forward (``stem_launch(...,
    route=True)``). ``debug``: also return the decisions K1b used, (route,
    conv0's ReLU mask as uint8 [B, H/2, W/2, 32]), as
    ``stem_backward_phase_plain`` takes them."""
    _check(x, w0, b0, w1, b1)
    _check_phase(x, w0)
    lib = build.load("stem_bwd")
    b, h, w, ci = x.shape
    if not 1 <= ci <= lib.wmfml_stem_bwd_max_ci():
        raise ValueError(f"stem backward kernel takes 1 to "
                         f"{lib.wmfml_stem_bwd_max_ci()} input channels, "
                         f"got {ci}")
    if tuple(g.shape) != (b, h // 8, w // 8, C1):
        raise ValueError(f"stem backward: g {tuple(g.shape)} for images "
                         f"{tuple(x.shape)}")
    if (route.dtype != torch.uint8 or route.shape != g.shape
            or route.device != x.device):
        raise ValueError(f"stem backward: route must be uint8 "
                         f"{tuple(g.shape)} on {x.device}")
    bf16 = int(x.dtype == torch.bfloat16)
    x, w0, b0, w1, route = (a.contiguous() for a in (x, w0, b0, w1, route))
    g = g.to(x.dtype).contiguous()
    blocks = _grid(lib, ci, bf16)
    dev = x.device
    partial = torch.empty((blocks, lib.wmfml_stem_bwd_partials(ci)),
                          device=dev)
    mask = torch.zeros((b, h // 2, w // 2, C0), device=dev,
                       dtype=torch.uint8) if debug else None
    outs = [torch.empty_like(a) for a in (w0, b0, w1, b1)]
    fn = lib.wmfml_stem_bwd
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), w0.data_ptr(), b0.data_ptr(), w1.data_ptr(),
             g.data_ptr(), route.data_ptr(),
             None if mask is None else mask.data_ptr(), partial.data_ptr(),
             *(a.data_ptr() for a in outs), b, h, w, ci, blocks, bf16,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stem backward launch failed: cudaError {err}")
    return (tuple(outs), (route, mask)) if debug else tuple(outs)


def literature_stem_backward(x, w0, b0, w1, b1, g, route=None):
    """(dW0, db0, dW1, db1) for the pooled map's gradient g: on a CPU
    tensor the twin ``stem_backward_phase_plain`` (fed ``route`` where
    given), on a CUDA tensor K1b on the pool's routes of K1's forward
    (``route``, required there), which it counts."""
    if x.device.type == "cpu":
        _check_phase(x, w0)
        return stem_backward_phase_plain(x, w0, b0, w1, b1, g, route)
    if route is None:
        raise ValueError("K1b takes the pool's routes of K1's forward "
                         "(stem_launch(..., route=True))")
    out = stem_backward_launch(x, w0, b0, w1, b1, g, route)
    literature_stem_backward.launches += 1
    literature_stem_backward.bf16_launches += x.dtype == torch.bfloat16
    return out


literature_stem_backward.launches = 0        # every K1b launch on the path
literature_stem_backward.bf16_launches = 0   # those in bfloat16


class _PhaseStem(torch.autograd.Function):
    """The stem with ``conv_bwd: phase``: K1 (or, on the CPU, its twin)
    forward, K1b (or its twin) backward."""

    @staticmethod
    def forward(ctx, x, w0, b0, w1, b1):
        if x.device.type == "cpu":
            ctx.save_for_backward(x, w0, b0, w1, b1)
            return stem_plain(x, w0, b0, w1, b1)
        # the pool's routes, for K1b, only where a gradient is wanted
        if any(ctx.needs_input_grad):
            out, route = stem_launch(x, w0, b0, w1, b1, route=True)
            ctx.save_for_backward(x, w0, b0, w1, b1, route)
        else:
            out = stem_launch(x, w0, b0, w1, b1)
            ctx.save_for_backward(x, w0, b0, w1, b1)
        literature_stem.launches += 1
        literature_stem.bf16_launches += x.dtype == torch.bfloat16
        return out

    @staticmethod
    def backward(ctx, g):
        if torch.is_grad_enabled():
            raise NotImplementedError(
                "conv_bwd: phase (K1b) has no backward under create_graph: "
                "a second-order gradient through the stem is not ported to "
                "it")
        x, w0, b0, w1, b1, *route = ctx.saved_tensors
        # no image gradient: ``literature_stem`` refuses images that want one
        return (None, *literature_stem_backward(x, w0, b0, w1, b1, g,
                                                *route))


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


def literature_stem(x, w0, b0, w1, b1, conv_bwd="xla"):
    """conv0 (s2) + ReLU + conv1 (s2) + ReLU + 2x2 max pool, NHWC in/out;
    weights shared or per task, as in ``stem_plain``. ``conv_bwd``
    ``phase``: the backward through K1b (on the CPU its twin); any other
    value: autodiff of the plain twin (on the card after K1's forward)."""
    if conv_bwd == "phase":
        _check_phase(x, w0)
        if x.requires_grad and torch.is_grad_enabled():
            raise NotImplementedError(
                "conv_bwd: phase (K1b) returns no image gradient: the "
                "images it is ported for are leaves (after image DA)")
        return _PhaseStem.apply(x, w0, b0, w1, b1)
    if x.device.type == "cpu":
        return stem_plain(x, w0, b0, w1, b1)
    return _FusedStem.apply(x, w0, b0, w1, b1)


literature_stem.launches = 0          # every launch on the path
literature_stem.bf16_launches = 0     # those in bfloat16
