"""Operands for the tensor-core products of K1, K2 and K3: 3xTF32 for
float32, one bfloat16 product for ``compute_dtype: bfloat16``.

A TF32 tensor-core product reads 10 of a float32's 23 mantissa bits. Split
each operand as ``big = tf32(x)``, ``small = tf32(x - big)`` and accumulate
``big*big + big*small + small*big`` in float32: the dropped ``small*small``
term is 2^-22 of the product, so the sum keeps float32's accuracy (about
seven digits) where one TF32 product keeps three. ``tf32(.)`` rounds to
nearest with ties away from zero, as ``cvt.rna.tf32.f32`` does in the
kernels, which split their activations that way when they load them; the
wrappers split the weights here, once per call.

``gmma_b_layout`` packs a [..., N, K] operand for ``wgmma``'s B descriptor
without swizzle, K-major: "core matrices" of 8 rows of N by 16 bytes of K
(128 contiguous bytes: 4 floats or 8 bfloat16 a row), ordered (k-step of
32 bytes, row group of 8, K half) so that one k-step's B is 64 * N
contiguous bytes with the K halves 128 bytes apart (the descriptor's
leading byte offset) and the row groups 256 bytes apart (its stride byte
offset). A float32 k-step is 8 deep (``.tf32``, k8), a bfloat16 one 16
(``.bf16``, k16); the layout is the same in bytes.
"""

from __future__ import annotations

import torch

TF32_DROPPED_BITS = 13          # float32 mantissa bits a TF32 product ignores


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (nearest, ties away from zero), low 13 bits 0."""
    if x.dtype != torch.float32:
        raise TypeError(f"tf32_round takes float32; got {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    half, low = 1 << (TF32_DROPPED_BITS - 1), (1 << TF32_DROPPED_BITS) - 1
    # sign and magnitude: adding half an ulp to the bit pattern rounds the
    # magnitude up at a tie whatever the sign; a carry moves the exponent
    return ((bits + half) & ~low).view(torch.float32)


def tf32_split(x: torch.Tensor):
    """(big, small) with big = tf32(x), small = tf32(x - big); x - big is
    exact in float32, and big + small is x within 2^-22 of |x|."""
    big = tf32_round(x)
    return big, tf32_round(x - big)


def gmma_b_layout(w: torch.Tensor) -> torch.Tensor:
    """[..., N, K] -> [..., K/(2e), N/8, 2, 8, e] contiguous, e = 16 bytes
    of elements: 4 for float32, 8 for bfloat16 (see module doc)."""
    *lead, n, k = w.shape
    e = 16 // w.element_size()
    if n % 8 or k % (2 * e):
        raise ValueError(f"wgmma B operand needs N % 8 == 0 and K % "
                         f"{2 * e} == 0; got {n}, {k}")
    d = len(lead)
    w = w.reshape(*lead, n // 8, 8, k // (2 * e), 2, e)
    return w.permute(*range(d), d + 2, d, d + 3, d + 1, d + 4).contiguous()
