"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked ``cuda``; each test skips where no CUDA device is present, as in a
CPU-only run. On a machine with a card:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q -m cuda

Tolerance: elementwise |kernel - plain| <= atol + rtol * |plain|, the same
as ``chip_smoke.py``: both sides are float32 sums in another order.
"""

import pytest
import torch

from wmfml_tpu_torch.kernels import favor, stem

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, atol, rtol):
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = (got - want).abs() <= atol + rtol * want.abs()
    assert bool(ok[~torch.isnan(want)].all()), (got - want).abs().max()


@pytest.mark.parametrize("b,h,w", [(3, 32, 32), (2, 40, 24), (300, 128, 128)])
def test_stem_kernel_matches_plain(dev, b, h, w):
    g = torch.Generator(device=dev).manual_seed(b)
    x = torch.rand((b, h, w, 1), generator=g, device=dev)
    w0 = 0.3 * torch.randn((32, 1, 3, 3), generator=g, device=dev)
    b0 = 0.1 * torch.randn((32,), generator=g, device=dev)
    w1 = 0.06 * torch.randn((48, 32, 3, 3), generator=g, device=dev)
    b1 = 0.1 * torch.randn((48,), generator=g, device=dev)
    _close(stem.stem_launch(x, w0, b0, w1, b1),
           stem.stem_plain(x, w0, b0, w1, b1), 1e-4, 1e-4)


def test_stem_wrapper_counts_launches_and_backpropagates(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((4, 32, 32, 1), generator=g, device=dev)
    ws = [(0.1 * torch.randn(s, generator=g, device=dev)).requires_grad_(True)
          for s in ((32, 1, 3, 3), (32,), (48, 32, 3, 3), (48,))]
    before = stem.literature_stem.launches
    stem.literature_stem(x, *ws).square().sum().backward()
    assert stem.literature_stem.launches == before + 1
    ref = [w.detach().clone().requires_grad_(True) for w in ws]
    stem.stem_plain(x, *ref).square().sum().backward()
    for a, b in zip(ws, ref):
        _close(a.grad, b.grad, 1e-4, 1e-4)


@pytest.mark.parametrize("t,h,n,d,m", [(2, 3, 4, 8, 20), (10, 8, 15, 64, 266)])
def test_favor_kernel_matches_plain(dev, t, h, n, d, m):
    g = torch.Generator(device=dev).manual_seed(n)
    q, k, v = (torch.randn((t, h, n, d), generator=g, device=dev)
               for _ in range(3))
    proj = torch.randn((m, d), generator=g, device=dev)
    shots = torch.randint(1, n + 1, (t, 1), generator=g, device=dev)
    mask = torch.arange(n, device=dev)[None] < shots
    mask[0] = False                         # an empty task: NaN on both sides
    _close(favor.favor_launch(q, k, v, proj, mask),
           favor.favor_plain(q, k, v, proj, mask), 1e-5, 1e-4)
