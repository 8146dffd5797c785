"""The sums of K2's wide form, reassociated, against the JAX FAVOR+.

K2's wide form (``wmfml_tpu_torch/csrc/favor.cu``, namespace ``wide``)
never forms q' and k'. Per 64-feature tile it keeps stabilisers and partial
sums; after its grid barrier it combines them into A = q' k'^T with the
+ eps terms expanded:

    c_q[i, t] = max over the tile's features of dash_q[i]
    c_k[t, c] = max over the tile and k chunk c's rows of dash_k (masked
                rows included)
    S_t[i, n] = sum_j e^(dq_ij - c_q) e^(dk_nj - c_k)
    Q_t[i], K_t[n] = the row sums of those exponentials; cnt_t its features
    A[i, n] = ratio^2 keep_n sum_t (alpha beta S_t + eps alpha Q_t[i]
              + eps beta K_t[n] + eps^2 cnt_t),
    alpha = e^(c_q - max_t c_q - diag_i), beta = e^(c_k - gmax - diag_n),
    gmax the max of every c_k, out = (A v) / rowsum(A).

The diagonal terms are a factor of each row, so they wait for alpha and
beta.

``wide_order`` below is a float32 torch emulation of that order (k chunks
as the kernel pairs its rows, tiles summed in order); it lives here, not in
the package. It is held against ``wmfml_tpu/nn/attention.py:favor_attention``
on inputs from numpy under a seed, within ``TOL["favor_attention_wide"]``
(atol 1e-5, rtol 1e-4), at D1's widths cut to T = 2, at m = 300 and
d = 68, and past 64 rows an item (k chunks): the empty task's NaN, masked
rows inside the key max, and an item whose key maxima lie more than 100
below another item's (its beta underflows to 0 and its k' is eps ratio,
as in the reference). The kernel itself is held to its twin on the card
(``tests/test_torch_port_cuda.py``).
"""

import numpy as np
import pytest
import torch

from wmfml_tpu.nn.attention import favor_attention as jax_favor
from torch_port_common import one_torch_thread  # noqa: F401

ATOL, RTOL = 1e-5, 1e-4                # TOL["favor_attention_wide"]
EPS = 1e-4
TILE, ROWS = 64, 64                    # features a tile, rows a product


def _k_chunk(nq, nk):
    """The k rows of the kernel's row pairs (csrc/favor.cu: wide::layout)."""
    if nq + nk <= ROWS:
        return nk
    return min(nk, max(ROWS - nq, ROWS // 2))


def wide_order(q, k, v, proj, mask):
    """q [T, H, Nq, d], k, v [T, H, Nk, d|e], proj [m, d], mask [T, Nk]
    bool; float32 torch tensors. Returns the output and the betas of every
    (item, tile, k row)."""
    _, _, nq, d = q.shape
    nk, m = k.shape[2], proj.shape[0]
    dn, ratio = d ** -0.25, m ** -0.5
    dash_q, dash_k = (dn * q) @ proj.T, (dn * k) @ proj.T
    diag_q = (q ** 2).sum(-1, keepdim=True) / 2.0 * dn ** 2
    diag_k = (k ** 2).sum(-1, keepdim=True) / 2.0 * dn ** 2
    kc = _k_chunk(nq, nk)
    parts = []
    for t0 in range(0, m, TILE):
        dq, dk = dash_q[..., t0:t0 + TILE], dash_k[..., t0:t0 + TILE]
        cq = dq.amax(-1, keepdim=True)                  # [T, H, Nq, 1]
        eq = torch.exp(dq - cq)
        ck = torch.cat([dk[..., c:c + kc, :].amax((-2, -1), keepdim=True)
                        .expand(-1, -1, min(kc, nk - c), 1)
                        for c in range(0, nk, kc)], -2)  # [T, H, Nk, 1]
        ek = torch.exp(dk - ck)
        parts.append((eq @ ek.transpose(-1, -2), eq.sum(-1), ek.sum(-1),
                      cq[..., 0], ck[..., 0], dq.shape[-1]))
    gmax = torch.stack([c for *_, c, _ in parts]).amax()
    stab = torch.stack([c for *_, c, _, _ in parts]).amax(0)   # [T, H, Nq]
    a = torch.zeros_like(parts[0][0])
    betas = []
    for s, qs, ks, cq, ck, cnt in parts:
        al = torch.exp(cq - stab - diag_q[..., 0])[..., :, None]
        be = torch.exp(ck - gmax - diag_k[..., 0])[..., None, :]
        betas.append(be)
        a = a + (al * be * s + EPS * al * qs[..., :, None]
                 + EPS * be * ks[..., None, :] + EPS * EPS * cnt)
    a = ratio * ratio * mask[:, None, None, :].float() * a
    return (a @ v) / a.sum(-1, keepdim=True), torch.stack(betas)


def _inputs(seed, t, h, nq, nk, d, m, far=False):
    """Normal rows and projection; task 0 empty, task 1 one real row, the
    rest shots 1..Nk; ``far``: the last task's keys x 30, so that every
    other item's key maxima lie more than 100 below its own."""
    rng = np.random.RandomState(seed)
    q = rng.randn(t, h, nq, d).astype(np.float32)
    k = rng.randn(t, h, nk, d).astype(np.float32)
    v = rng.randn(t, h, nk, d).astype(np.float32)
    proj = rng.randn(m, d).astype(np.float32)
    if far:
        k[-1] *= 30.0
    shots = rng.randint(1, nk + 1, t)
    shots[0], shots[1] = 0, 1
    mask = np.arange(nk)[None, :] < shots[:, None]
    return q, k, v, proj, mask


def _check(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], atol=ATOL, rtol=RTOL)


# D1's widths at T = 2 (Nq 18, Nk 15, d 256, m 1419); m = 300 at d = 68;
# past 64 rows (two k chunks of the kernel's row pairs, and two q chunks)
@pytest.mark.parametrize("t,h,nq,nk,d,m", [
    (2, 8, 18, 15, 256, 1419), (3, 3, 5, 4, 68, 300),
    (3, 2, 9, 75, 68, 300), (3, 2, 50, 50, 68, 300)])
def test_wide_order_matches_jax(t, h, nq, nk, d, m):
    q, k, v, proj, mask = _inputs(nq + nk, t, h, nq, nk, d, m)
    got, _ = wide_order(*(torch.from_numpy(a) for a in (q, k, v, proj, mask)))
    want = jax_favor(q, k, v, proj, mask[:, None, :])
    assert np.isnan(np.asarray(want)[0]).all()      # the empty task
    assert not np.isnan(np.asarray(want)[1:]).any()
    _check(got, want)


@pytest.mark.parametrize("d,m", [(256, 1419), (68, 300)])
def test_wide_order_matches_jax_where_beta_underflows(d, m):
    """The last task's keys x 30: its dash_k reaches several hundred, so
    every other item's beta = e^(c_k - gmax - diag_n) underflows to 0 in
    float32 and its k' is eps ratio on every real row, in the reference as
    here."""
    q, k, v, proj, mask = _inputs(7, 3, 4, 6, 5, d, m, far=True)
    dash_k = (d ** -0.25 * k) @ proj.T
    assert dash_k[:2].max() < dash_k[2].max() - 100.0
    got, betas = wide_order(*(torch.from_numpy(a)
                              for a in (q, k, v, proj, mask)))
    assert bool((betas[:, :2] == 0).all())
    want = jax_favor(q, k, v, proj, mask[:, None, :])
    _check(got, want)


def test_masked_rows_count_in_the_key_max():
    """A masked row with the largest key value sets gmax on both sides: the
    same inputs with that row dropped give another output."""
    q, k, v, proj, mask = _inputs(3, 3, 2, 6, 5, 68, 300)
    k[2, :, -1] *= 3.0
    mask[2] = [True, True, True, False, False]
    args = [torch.from_numpy(a) for a in (q, k, v, proj, mask)]
    got, _ = wide_order(*args)
    want = jax_favor(q, k, v, proj, mask[:, None, :])
    _check(got, want)
    dropped = jax_favor(q, k[:, :, :-1], v[:, :, :-1], proj,
                        mask[:, None, :-1])
    assert np.abs(np.asarray(dropped)[2] - np.asarray(want)[2]).max() > 1e-4
