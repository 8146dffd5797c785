"""Operands for the 3xTF32 tensor-core products of K1 and K3.

A TF32 tensor-core product reads 10 of a float32's 23 mantissa bits. Split
each operand as ``big = tf32(x)``, ``small = tf32(x - big)`` and accumulate
``big*big + big*small + small*big`` in float32: the dropped ``small*small``
term is 2^-22 of the product, so the sum keeps float32's accuracy (about
seven digits) where one TF32 product keeps three. ``tf32(.)`` rounds to
nearest with ties away from zero, as ``cvt.rna.tf32.f32`` does in the
kernels, which split their activations that way when they load them; the
wrappers split the weights here, once per call.

``gmma_b_layout`` packs a [..., N, K] operand for ``wgmma``'s B descriptor
without swizzle, K-major: 8 x 4 float "core matrices" (128 contiguous
bytes: 8 rows of N, 4 consecutive K), ordered (k-step of 8, row group of 8,
K half) so that one k-step's B is 64 * N contiguous bytes with the K halves
128 bytes apart (the descriptor's leading byte offset) and the row groups
256 bytes apart (its stride byte offset).
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
    """[..., N, K] -> [..., K/8, N/8, 2, 8, 4] contiguous (see module doc)."""
    *lead, n, k = w.shape
    if n % 8 or k % 8:
        raise ValueError(f"wgmma B operand needs N, K % 8 == 0; got {n}, {k}")
    d = len(lead)
    w = w.reshape(*lead, n // 8, 8, k // 8, 2, 4)
    return w.permute(*range(d), d + 2, d, d + 3, d + 1, d + 4).contiguous()
