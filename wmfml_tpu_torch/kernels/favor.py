"""K2: the masked FAVOR+ attention core.

Replaces ``wmfml_tpu/nn/attention.py:softmax_kernel_features``,
``linear_attention`` and ``favor_attention``. ``csrc/favor.cu`` says what
bounds the kernel and how one cooperative launch takes the one global key
max that no single block can see (a grid barrier between the feature
products and the rest).

K2 has two forms, both in ``csrc/favor.cu``, one cooperative launch each:
the narrow kernel for heads of d <= 64 with m <= 512 features (SmallCNP's,
d = 64, m = 266), whose item's features stay in shared memory, and the wide
kernel for d <= 256 at any m and any Nq, Nk (LargeCNP's full-width heads,
d = 256, m = 1419), whose features are never formed: its products run
on ``wgmma`` tile by tile of 64 features, and each tile's epilogue leaves
per-tile partial sums of q' k'^T that the blocks combine after the grid
barrier. ``favor_launch`` picks the form by d and m; a shape neither takes
raises.

``favor_attention`` is the wrapper the attention block calls. A CPU tensor
takes the plain twin (the JAX math, op for op); a CUDA tensor launches the
kernel or raises. The JAX package has no custom VJP here, so the backward
recomputes through the plain twin; gradients flow through both maxima, as
they do under JAX autodiff (``amax`` splits a tie evenly, like ``jnp.max``).

bfloat16 (``compute_dtype: bfloat16``): q, k, v come in as bfloat16 and the
core returns float32, as the JAX core does: there a bfloat16 ``data`` meets
the float32 projection in ``einsum`` and in ``linear_attention`` and
promotes. Two roundings happen in bfloat16 before that, and the twin and
the kernel both take them: ``data_normalizer * data`` (the scalar rounded
to bfloat16 first, as JAX casts a Python scalar) and the diagonal term
``sum(data**2) / 2 * normalizer**2`` (each square, the sum and the product
rounded). Both forms read the bfloat16 rows through their strides (no
float32 copy); their values are exact in TF32, so dash needs no small part
for them.

Under a data-parallel mesh (``parallel/mesh.py``) the key stabiliser is the
max over every rank's keys, as it is under the JAX package's SPMD
partitioning: the twin takes it through ``mesh.global_max`` (its gradient
splits ties over the whole batch); on the card the keys' dash is formed
once more by a plain product for that max, and both forms take it in
place of their own through ``kmax`` (``favor_launch``), while their own
stays the path without a mesh.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from wmfml_tpu_torch.kernels import build
from wmfml_tpu_torch.ops.cast import rounded
from wmfml_tpu_torch.parallel import mesh

EPS = 1e-4
MAX_D = 64             # widest head the narrow kernel takes (padded to 64)
MAX_MP = 512           # most features it takes, m rounded up to 16
WIDE_MAX_D = 256       # the wide kernel: widest head and widest v row
# the kernel's phase clock (csrc/favor.cu: stamp)
PHASES = ("start", "staged", "dash_done", "phase1_done", "barrier_passed",
          "loaded", "features_done", "a_done", "end")
STAMPS = len(PHASES)
# the wide kernel's phase clock (csrc/favor.cu: wide::stamp)
WIDE_PHASES = ("start", "staged", "phase1_done", "barrier_passed", "end")
WIDE_TILE = 64         # features a tile of the wide kernel's phase 1
DTYPES = (torch.float32, torch.bfloat16)


def _normalizers(d: int, dtype):
    """d^-1/4 and (d^-1/4)^2 as ``dtype`` holds them."""
    n = d ** -0.25
    return rounded(n, dtype), rounded(n ** 2, dtype)


def dash(data, projection):
    """The features' products, float32 [..., N, m]: ``data`` scaled by the
    normalizer (rounded in data's dtype) times the projection."""
    data_normalizer, _ = _normalizers(data.shape[-1], data.dtype)
    return torch.matmul((data_normalizer * data).to(projection.dtype),
                        projection.t())


def key_stabiliser(data_dash):
    """ONE max over the whole key tensor; over every rank's under a mesh."""
    ctx = mesh.sharded()
    return data_dash.amax() if ctx is None else ctx.global_max(data_dash)


def softmax_kernel_features(data, projection, is_query: bool, eps=EPS,
                            stab=None):
    """Positive random features; data [..., N, d] (float32 or bfloat16),
    projection [m, d] float32; returns float32 [..., N, m]. ``stab`` gives
    the keys' stabiliser (else ``key_stabiliser``)."""
    _, normalizer_sq = _normalizers(data.shape[-1], data.dtype)
    ratio = projection.shape[0] ** -0.5
    data_dash = dash(data, projection)
    diag_data = (data ** 2).sum(-1, keepdim=True) / 2.0 * normalizer_sq
    if is_query:
        stab = data_dash.amax(-1, keepdim=True)
    elif stab is None:
        stab = key_stabiliser(data_dash)
    return ratio * (torch.exp(data_dash - diag_data - stab) + eps)


def linear_attention(q_prime, k_prime, v):
    k_cumsum = k_prime.sum(-2)
    d_inv = 1.0 / torch.einsum("...nd,...d->...n", q_prime, k_cumsum)
    context = torch.einsum("...nd,...ne->...de", k_prime, v)
    return torch.einsum("...de,...nd,...n->...ne", context, q_prime, d_inv)


def favor_plain(q, k, v, projection, mask: Optional[torch.Tensor] = None,
                kmax: Optional[torch.Tensor] = None):
    """q [T, H, Nq, d], k [T, H, Nk, d], v [T, H, Nk, e], mask [T, Nk] bool
    (True = real context row, shared by all heads) -> [T, H, Nq, e];
    ``kmax`` the key stabiliser, else the keys' own max (over every rank's
    under a mesh)."""
    q_prime = softmax_kernel_features(q, projection, is_query=True)
    k_prime = softmax_kernel_features(k, projection, is_query=False,
                                      stab=kmax)
    if mask is not None:
        k_prime = k_prime * mask[:, None, :, None].to(k_prime.dtype)
    return linear_attention(q_prime, k_prime, v.to(k_prime.dtype))


_fwd = None
_fwd_wide = None


def _kernel():
    """The launch function, its ctypes signature set once, at first load."""
    global _fwd
    if _fwd is None:
        fn = build.load("favor").wmfml_favor_fwd
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_longlong] * 11
                       + [ctypes.c_int] * 8 + [ctypes.c_float] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fwd = fn
    return _fwd


def _kernel_wide():
    """The wide kernel's launch function and its scratch size function."""
    global _fwd_wide
    if _fwd_wide is None:
        lib = build.load("favor")
        fn = lib.wmfml_favor_wide_fwd
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_longlong] * 11
                       + [ctypes.c_int] * 8 + [ctypes.c_float] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        size = lib.wmfml_favor_wide_scratch_floats
        size.argtypes = [ctypes.c_int] * 4
        size.restype = ctypes.c_longlong
        _fwd_wide = fn, size
    return _fwd_wide


def is_wide(d: int, m: int) -> bool:
    """Whether heads of width d with m features take the wide kernel."""
    return d > MAX_D or -(-m // 16) * 16 > MAX_MP


def wide_grid(items: int, m: int) -> int:
    """The wide kernel's grid: items x feature tiles of ``WIDE_TILE``, at
    most the co-resident blocks."""
    blocks = build.load("favor").wmfml_favor_wide_coresident()
    if blocks < 0:
        raise RuntimeError(f"FAVOR wide occupancy query failed: cudaError "
                           f"{-blocks}")
    return min(items * -(-m // WIDE_TILE), blocks)


def _aligned(a):
    """``a`` itself where the kernel can read it four elements at a time
    (unit last stride, other strides multiples of 4, the first element
    aligned to four), else a copy."""
    if (a.stride(-1) == 1 and all(s % 4 == 0 for s in a.stride()[:-1])
            and a.data_ptr() % (4 * a.element_size()) == 0):
        return a
    return a.clone(memory_format=torch.contiguous_format)


def favor_launch(q, k, v, projection, mask: Optional[torch.Tensor] = None,
                 stamps: Optional[torch.Tensor] = None,
                 kmax: Optional[torch.Tensor] = None):
    """Run the CUDA kernel once (no autograd, no launch count): one
    cooperative launch, and nothing else on the card. ``kmax`` (a float32
    scalar on the card) is the key stabiliser the kernel takes in place of
    the keys' own max (a mesh's ``global_max``). ``stamps`` (int64
    [T * H, STAMPS], for ``chip_smoke.py``) turns on the kernel's phase
    clock: block b writes the global timer (ns) to row b at the points
    ``PHASES`` names (those after the grid barrier at its last item); rows
    past the grid are left as they are. The wide kernel's clock is
    ``stamps`` int64 [``wide_grid``, 5], one row a block, at
    ``WIDE_PHASES``."""
    if (any(not t.is_cuda for t in (q, k, v, projection))
            or q.dtype not in DTYPES or k.dtype != q.dtype
            or v.dtype != q.dtype or projection.dtype != torch.float32):
        raise TypeError("FAVOR kernel takes CUDA tensors: q, k, v all float32 "
                        "or all bfloat16, the projection float32")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("FAVOR kernel takes q, k, v as [T, H, N, d]")
    t, h, nq, d = q.shape
    nk, e, m = k.shape[2], v.shape[3], projection.shape[0]
    if (tuple(k.shape) != (t, h, nk, d) or tuple(v.shape[:3]) != (t, h, nk)
            or tuple(projection.shape) != (m, d)):
        raise ValueError(f"FAVOR shapes disagree: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"projection {tuple(projection.shape)}")
    if d % 4 or e % 4:
        raise ValueError(f"FAVOR kernel takes d, e multiples of 4; got "
                         f"d={d}, e={e}")
    if kmax is not None and (kmax.numel() != 1 or kmax.device != q.device
                             or kmax.dtype != torch.float32):
        raise ValueError("FAVOR kmax must be one float32 on the card")
    if mask is not None and (tuple(mask.shape) != (t, nk)
                             or mask.device != q.device
                             or mask.dtype != torch.bool):
        raise ValueError(f"FAVOR mask must be bool [T, Nk] = {(t, nk)} on "
                         f"the same device; got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    wide = is_wide(d, m)
    if stamps is not None:
        shape = ((wide_grid(t * h, m), len(WIDE_PHASES)) if wide
                 else (t * h, STAMPS))
        if (stamps.device != q.device or stamps.dtype != torch.int64
                or tuple(stamps.shape) != shape):
            raise ValueError(f"FAVOR stamps must be int64 {list(shape)} on "
                             f"the card")
    # the kernel reads q, k, v and the mask's bytes through their strides:
    # the attention block passes transposed views, the sampler an expanded
    # mask, and neither is copied
    q, k, v = (_aligned(a) for a in (q, k, v))
    proj = _aligned(projection)
    out = torch.empty((t, h, nq, e), device=q.device, dtype=torch.float32)
    mask_args = ((0, 0, 0) if mask is None
                 else (mask.data_ptr(), *mask.stride()))
    bf16 = q.dtype == torch.bfloat16
    # bfloat16: the kernel scales by the rounded normalizers and rounds
    dn, dn2 = _normalizers(d, q.dtype) if bf16 else (d ** -0.25, d ** -0.5)
    kmax_ptr = 0 if kmax is None else kmax.data_ptr()
    if wide:
        return _wide_launch(q, k, v, proj, mask_args, stamps, out, bf16, dn,
                            dn2, kmax_ptr)
    # dash [T*H, Nq+Nk, m rounded up to 16], then the items' key maxima
    mp = -(-m // 16) * 16
    scratch = torch.empty(t * h * ((nq + nk) * mp + 1),
                          device=q.device, dtype=torch.float32)
    err = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), proj.data_ptr(),
        mask_args[0], scratch.data_ptr(), out.data_ptr(),
        0 if stamps is None else stamps.data_ptr(), kmax_ptr,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *mask_args[1:],
        t, h, nq, nk, d, e, m, int(bf16), dn, dn2, m ** -0.5, EPS,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err == -1:
        raise ValueError(f"FAVOR kernel does not fit Nq={nq}, Nk={nk}, "
                         f"e={e}, m={m} in shared memory")
    if err != 0:
        raise RuntimeError(f"FAVOR cooperative launch failed: cudaError {err}")
    return out


def _wide_launch(q, k, v, proj, mask_args, stamps, out, bf16, dn, dn2,
                 kmax_ptr=0):
    """The wide kernel (``favor_launch``'s checks done, q, k, v aligned,
    ``out`` allocated)."""
    t, h, nq, d = q.shape
    nk, e, m = k.shape[2], v.shape[3], proj.shape[0]
    if d > WIDE_MAX_D or e > WIDE_MAX_D:
        raise ValueError(
            f"the wide FAVOR kernel takes heads of d <= {WIDE_MAX_D} and "
            f"e <= {WIDE_MAX_D}; got d={d}, e={e}")
    fwd, size = _kernel_wide()
    scratch = torch.empty(size(t * h, nq, nk, m), device=q.device,
                          dtype=torch.float32)
    err = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), proj.data_ptr(),
              mask_args[0], scratch.data_ptr(), out.data_ptr(),
              0 if stamps is None else stamps.data_ptr(), kmax_ptr,
              *q.stride()[:3],
              *k.stride()[:3], *v.stride()[:3], *mask_args[1:], t, h, nq, nk,
              d, e, m, int(bf16), dn, dn2, m ** -0.5, EPS,
              torch.cuda.current_stream(q.device).cuda_stream)
    if err == -1:
        raise ValueError(f"the wide FAVOR kernel does not take Nq={nq}, "
                         f"Nk={nk}, d={d}, e={e}, m={m}")
    if err != 0:
        raise RuntimeError(f"FAVOR cooperative launch failed: cudaError {err}")
    return out


class _Favor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, projection, mask, kmax):
        ctx.save_for_backward(q, k, v, projection, mask, kmax)
        out = favor_launch(q, k, v, projection, mask,
                           kmax=None if kmax is None else kmax.detach())
        favor_attention.launches += 1
        favor_attention.bf16_launches += q.dtype == torch.bfloat16
        favor_attention.wide_launches += is_wide(*projection.shape[::-1])
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, projection, mask, kmax = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_(True) for t in (q, k, v)]
            inputs = qkv + ([] if kmax is None
                            else [kmax.detach().requires_grad_(True)])
            out = favor_plain(*qkv, projection.detach(), mask,
                              None if kmax is None else inputs[3])
        grads = torch.autograd.grad(out, inputs, g)
        return (*grads[:3], None, None,
                None if kmax is None else grads[3])


def favor_attention(q, k, v, projection, mask: Optional[torch.Tensor] = None):
    """Masked FAVOR+ attention; shapes as in ``favor_plain``."""
    if q.device.type == "cpu":
        return favor_plain(q, k, v, projection, mask)
    ctx = mesh.sharded()
    kmax = None if ctx is None else ctx.global_max(dash(k, projection))
    return _Favor.apply(q, k, v, projection, mask, kmax)


favor_attention.launches = 0          # every launch on the path
favor_attention.bf16_launches = 0     # those that read bfloat16
favor_attention.wide_launches = 0     # those of the wide kernel
