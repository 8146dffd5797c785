"""K2: the masked FAVOR+ attention core.

Replaces ``wmfml_tpu/nn/attention.py:softmax_kernel_features``,
``linear_attention`` and ``favor_attention``. ``csrc/favor.cu`` says what
bounds the kernel (launch latency: the work is a few microseconds) and how
it takes the one global key max that no single block can see.

``favor_attention`` is the wrapper the attention block calls. A CPU tensor
takes the plain twin (the JAX math, op for op); a CUDA tensor launches the
kernel or raises. The JAX package has no custom VJP here, so the backward
recomputes through the plain twin; gradients flow through both maxima, as
they do under JAX autodiff (``amax`` splits a tie evenly, like ``jnp.max``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from wmfml_tpu_torch.kernels import build

EPS = 1e-4
SMEM_LIMIT = 232_448   # bytes of dynamic shared memory a Hopper block may use


def softmax_kernel_features(data, projection, is_query: bool, eps=EPS):
    """Positive random features; data [..., N, d], projection [m, d]."""
    d = data.shape[-1]
    data_normalizer = d ** -0.25
    ratio = projection.shape[0] ** -0.5
    data_dash = torch.matmul(data_normalizer * data, projection.t())
    diag_data = (data ** 2).sum(-1, keepdim=True) / 2.0 * data_normalizer ** 2
    if is_query:
        stab = data_dash.amax(-1, keepdim=True)
    else:
        stab = data_dash.amax()            # ONE max over the whole key tensor
    return ratio * (torch.exp(data_dash - diag_data - stab) + eps)


def linear_attention(q_prime, k_prime, v):
    k_cumsum = k_prime.sum(-2)
    d_inv = 1.0 / torch.einsum("...nd,...d->...n", q_prime, k_cumsum)
    context = torch.einsum("...nd,...ne->...de", k_prime, v)
    return torch.einsum("...de,...nd,...n->...ne", context, q_prime, d_inv)


def favor_plain(q, k, v, projection, mask: Optional[torch.Tensor] = None):
    """q [T, H, Nq, d], k [T, H, Nk, d], v [T, H, Nk, e], mask [T, Nk] bool
    (True = real context row, shared by all heads) -> [T, H, Nq, e]."""
    q_prime = softmax_kernel_features(q, projection, is_query=True)
    k_prime = softmax_kernel_features(k, projection, is_query=False)
    if mask is not None:
        k_prime = k_prime * mask[:, None, :, None].to(k_prime.dtype)
    return linear_attention(q_prime, k_prime, v)


def favor_launch(q, k, v, projection, mask: Optional[torch.Tensor] = None):
    """Run the CUDA kernels once (no autograd, no launch count)."""
    tensors = (q, k, v, projection)
    if any(t.device.type != "cuda" or t.dtype != torch.float32
           for t in tensors):
        raise TypeError("FAVOR kernel takes float32 CUDA tensors only")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("FAVOR kernel takes q, k, v as [T, H, N, d]")
    t, h, nq, d = q.shape
    nk, e, m = k.shape[2], v.shape[3], projection.shape[0]
    if (tuple(k.shape) != (t, h, nk, d) or tuple(v.shape[:3]) != (t, h, nk)
            or tuple(projection.shape) != (m, d)):
        raise ValueError(f"FAVOR shapes disagree: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"projection {tuple(projection.shape)}")
    if mask is None:
        mask = torch.ones((t, nk), dtype=torch.bool, device=q.device)
    if tuple(mask.shape) != (t, nk) or mask.device != q.device:
        raise ValueError(f"FAVOR mask must be [T, Nk] = {(t, nk)} on the "
                         f"same device; got {tuple(mask.shape)}")
    lib = build.load("favor")
    smem = lib.wmfml_favor_fwd_smem_bytes(nq, nk, d, e, m)
    if smem > SMEM_LIMIT:
        raise ValueError(f"FAVOR kernel needs {smem} B of shared memory "
                         f"(> {SMEM_LIMIT}) at Nq={nq}, Nk={nk}, d={d}, m={m}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    proj = projection.contiguous()
    mask_u8 = mask.to(torch.uint8).contiguous()
    block_maxima = torch.empty(t * h, device=q.device, dtype=torch.float32)
    out = torch.empty((t, h, nq, e), device=q.device, dtype=torch.float32)
    fn = lib.wmfml_favor_fwd
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                   + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), proj.data_ptr(),
             mask_u8.data_ptr(), block_maxima.data_ptr(), out.data_ptr(),
             t * h, h, nq, nk, d, e, m, d ** -0.25, m ** -0.5, EPS,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"FAVOR launch failed: cudaError {err}")
    return out


class _Favor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, projection, mask):
        ctx.save_for_backward(q, k, v, projection, mask)
        out = favor_launch(q, k, v, projection, mask)
        favor_attention.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, projection, mask = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = favor_plain(*qkv, projection.detach(), mask)
        return (*torch.autograd.grad(out, qkv, g), None, None)


def favor_attention(q, k, v, projection, mask: Optional[torch.Tensor] = None):
    """Masked FAVOR+ attention; shapes as in ``favor_plain``."""
    if q.device.type == "cpu":
        return favor_plain(q, k, v, projection, mask)
    return _Favor.apply(q, k, v, projection, mask)


favor_attention.launches = 0
