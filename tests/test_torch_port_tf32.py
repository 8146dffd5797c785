"""The 3xTF32 operands of K1 and K3 (``kernels/tf32.py``), on the CPU.

The kernels split their activations with ``cvt.rna.tf32.f32`` as they load
them; the wrappers split the weights with ``tf32_split`` and lay them out for
``wgmma``'s B descriptor. These tests hold the split bit for bit against
integer arithmetic on the float32 bit pattern, and the packed weights
element by element against the weights they came from.
"""

import numpy as np
import pytest
import torch

from wmfml_tpu_torch.kernels import features as kfeatures
from wmfml_tpu_torch.kernels import stem as kstem
from wmfml_tpu_torch.kernels.tf32 import gmma_b_layout, tf32_round, tf32_split
from torch_port_common import one_torch_thread  # noqa: F401


def _values(seed=0, n=20000):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n) * np.exp(rng.uniform(-30, 30, n))).astype(np.float32)
    # exact ties (half a TF32 ulp above 1 and -5), a near tie, zeros, powers
    # of two, and the largest float below a power of two
    ties = np.array([1 + 2 ** -11, 3 * (1 + 2 ** -11), -(5 + 2 ** -9),
                     0.0, -0.0, 2.0 ** -20, 2.0 ** 40,
                     np.nextafter(np.float32(2), np.float32(0))], np.float32)
    return np.concatenate([ties, x])


def _round_reference(x):
    """Round to nearest, ties away from zero, on sign and magnitude bits."""
    u = x.view(np.uint32)
    sign, mag = u & np.uint32(0x80000000), u & np.uint32(0x7FFFFFFF)
    rem, base = mag & np.uint32(0x1FFF), mag & ~np.uint32(0x1FFF)
    up = np.where(rem >= 0x1000, 0x2000, 0).astype(np.uint32)
    return (sign | (base + up)).view(np.float32)


def test_tf32_round_is_round_to_nearest_ties_away():
    x = _values()
    got = tf32_round(torch.from_numpy(x)).numpy()
    assert not (got.view(np.uint32) & 0x1FFF).any()
    np.testing.assert_array_equal(got.view(np.uint32),
                                  _round_reference(x).view(np.uint32))
    # nearest: no TF32 neighbour of x lies closer (checked in float64)
    step = (got.view(np.uint32) & 0x7F800000).view(np.float32).astype(
        np.float64) * 2.0 ** -10
    err = np.abs(got.astype(np.float64) - x.astype(np.float64))
    assert (err <= step / 2).all()
    assert got[0] == np.float32(1 + 2 ** -10)      # a tie goes away from zero
    assert got[2] == np.float32(-(5 + 2 ** -8))


def test_tf32_split_reproduces_float32():
    x = _values(1)
    big, small = (a.numpy() for a in tf32_split(torch.from_numpy(x)))
    assert not (big.view(np.uint32) & 0x1FFF).any()
    assert not (small.view(np.uint32) & 0x1FFF).any()
    x64 = x.astype(np.float64)
    rel = np.abs(big.astype(np.float64) + small - x64) / np.maximum(
        np.abs(x64), np.finfo(np.float32).tiny)
    assert rel.max() <= 2.0 ** -22
    with pytest.raises(TypeError):
        tf32_round(torch.zeros(3, dtype=torch.float64))


def test_gmma_b_layout_places_each_element():
    n, k = 48, 24
    w = torch.arange(n * k, dtype=torch.float32).reshape(n, k)
    flat = gmma_b_layout(w).reshape(-1)
    for ni, ki in [(0, 0), (9, 5), (47, 23), (17, 12), (8, 4)]:
        s, g, kk, r, e = ki // 8, ni // 8, (ki % 8) // 4, ni % 8, ki % 4
        # k-step blocks of 64 N bytes, row groups 256 bytes apart, K halves 128
        idx = s * 8 * n + g * 64 + kk * 32 + r * 4 + e
        assert flat[idx] == w[ni, ki]
    with pytest.raises(ValueError):
        gmma_b_layout(torch.zeros(12, 8))


def _unpack(packed, n, k):
    """Inverse of gmma_b_layout over the last axis: [..., n*k] -> [..., n, k]."""
    lead = packed.shape[:-1]
    p = packed.reshape(*lead, k // 8, n // 8, 2, 8, 4)
    d = len(lead)
    return p.permute(*range(d), d + 1, d + 3, d, d + 2, d + 4).reshape(
        *lead, n, k)


def test_stem_conv1_pack_orders_k_as_tap_then_channel():
    w1 = torch.randn(3, 48, 32, 3, 3, generator=torch.Generator().manual_seed(0))
    packed = kstem.pack_conv1(w1, 3)                      # [T, 2, 48 * 288]
    big, small = (_unpack(packed[:, i], 48, 288) for i in range(2))
    want = w1.permute(0, 1, 3, 4, 2).reshape(3, 48, 288)
    torch.testing.assert_close(big, tf32_split(want)[0], rtol=0, atol=0)
    torch.testing.assert_close(big + small, want, rtol=2 ** -21, atol=0)
    shared = kstem.pack_conv1(w1[0], 1)
    torch.testing.assert_close(shared, packed[:1], rtol=0, atol=0)


def test_features_pack_gives_each_tap_out_by_in():
    w = torch.randn(2, 3, 64, 64, 3, 3, generator=torch.Generator().manual_seed(1))
    packed = kfeatures.pack_weights(w)                    # [T, L, 9, 2, 4096]
    assert tuple(packed.shape) == (2, 3, 9, 2, 64 * 64)
    big, small = (_unpack(packed[:, :, :, i], 64, 64) for i in range(2))
    want = w.permute(0, 1, 4, 5, 2, 3).reshape(2, 3, 9, 64, 64)
    torch.testing.assert_close(big, tf32_split(want)[0], rtol=0, atol=0)
    torch.testing.assert_close(big + small, want, rtol=2 ** -21, atol=0)
    assert torch.equal(want[1, 2, 5], w[1, 2, :, :, 1, 2])   # tap (kh, kw) = (1, 2)
