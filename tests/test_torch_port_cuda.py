"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked ``cuda``; each test skips where no CUDA device is present, as in a
CPU-only run. On a machine with a card:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q -m cuda

Tolerance: elementwise |kernel - plain| <= atol + rtol * |plain|, the same
as ``chip_smoke.py``: both sides are float32 sums in another order. Second
derivatives compare per tensor, max |difference| <= 1e-3 max |plain|. K6
(image DA) holds its warps to the twin within 1e-5 and its masks, its
parameters and, with every gate off, its x / 255 bit for bit.

bfloat16 (``compute_dtype: bfloat16``): each kernel's bfloat16 path against
its bfloat16 twin on the same inputs. Both round at the same points, after
float32 sums taken in another order, so a sum near a rounding boundary can
round the other way and carry one ulp on: max |kernel - twin| <= 2 max
|twin - twin_f32| + 2^-7 max |twin_f32| (the size of bfloat16's own effect,
twin_f32 the twin on the same inputs in float32; the CPU tests' rule), and
on average the kernel is closer to its twin than the twin is to float32.
A bfloat16 output (K1, K3) also lies within 2 bfloat16 ulps of each element
of the twin, an element below 2^-8 of the twin's largest measured in the
spacing at that size (where a sum cancels, two float32 orders differ by
about 2^-20 of its largest term, more than an ulp of the small result).
K6 in bfloat16: parameters and masks bit for bit, values within 2 bfloat16
ulps of each element, with no floor; its programs 4-7 (LargeCNP's) within
``LARGE_BF16_ULPS`` of each element, programs 6 and 7 differing on at most
``RGB_BF16_SHARE`` of the elements, beside the rule above.

K2's wide form (LargeCNP's heads, d = e = 256, m = 1419) at D1's, D4's,
S1's and S4's shapes, K6's Distractor programs 4 and 5 (the inverted image)
and ShapeNet3D's programs 6 and 7 (float RGB: parameters and masks bit for
bit, values within 1e-5 in ten of the 720 orders and the fixed one),
against their twins at the same tolerances; graph = loop on short D1 and
S1 runs.

The numeric settings the entry points make (``cli/common.py:
set_numerics``, which the ``dev`` fixture calls too, so that every test
runs what the CLIs run): TF32 off after ``train_cli.build_trainer``, and
what two same-seed trainers give with no deterministic switch of their
own.

The fused K-step training call (``train/steps.py:FusedSteps``): its CUDA
graph replays against the same steps issued from the host, bit for bit
under deterministic algorithms (float32 and bfloat16 ANP, bfloat16 MAML);
a run resumed after replays against an unbroken one, bit for bit; K2
captured as one cooperative node and replayed; the capture's launch counts
against the graph's kernel nodes (``debug_dump``'s DOT).
"""

import math
import os
import re
import types

import numpy as np
import pytest
import torch

from torch_port_adam import optax_adam
from wmfml_tpu_torch.aug import image_aug
from wmfml_tpu_torch.cli import train_cli
from wmfml_tpu_torch.configs import Config
from wmfml_tpu_torch.cli.common import set_numerics
from wmfml_tpu_torch.data.synthetic import (generate_distractor,
                                            generate_pascal1d,
                                            generate_shapenet1d,
                                            generate_shapenet3d)
from wmfml_tpu_torch.kernels import favor, features, image_da, stem
from wmfml_tpu_torch.train.state import build_optimizer
from wmfml_tpu_torch.train.steps import KERNELS

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    set_numerics()          # the entry points' settings: TF32 off
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


def test_stem_kernel_takes_several_input_channels(dev):
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.rand((2, 3, 40, 32, 3), generator=g, device=dev).flatten(0, 1)
    ws = [scale * torch.randn((2, *shape), generator=g, device=dev)
          for scale, shape in ((0.3, (32, 3, 3, 3)), (0.1, (32,)),
                               (0.06, (48, 32, 3, 3)), (0.1, (48,)))]
    _close(stem.stem_launch(x, *ws), stem.stem_plain(x, *ws), 1e-4, 1e-4)


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


def _favor_inputs(dev, t, h, nq, nk, d, m, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((t, h, nq, d), generator=g, device=dev)
    k, v = (torch.randn((t, h, nk, d), generator=g, device=dev)
            for _ in range(2))
    proj = torch.randn((m, d), generator=g, device=dev)
    shots = torch.randint(1, nk + 1, (t, 1), generator=g, device=dev)
    mask = torch.arange(nk, device=dev)[None] < shots
    mask[0] = False                         # an empty task: NaN on both sides
    return q, k, v, proj, mask


# T = 64: 512 (task, head) items, more than the co-resident blocks, so the
# persistent blocks loop; Nq 15 against Nk 10
@pytest.mark.parametrize("t,h,nq,nk,d,m", [
    (2, 3, 4, 4, 8, 20), (10, 8, 15, 15, 64, 266), (64, 8, 15, 15, 64, 266),
    (10, 8, 15, 10, 64, 266)])
def test_favor_kernel_matches_plain(dev, t, h, nq, nk, d, m):
    q, k, v, proj, mask = _favor_inputs(dev, t, h, nq, nk, d, m, seed=nq)
    _close(favor.favor_launch(q, k, v, proj, mask),
           favor.favor_plain(q, k, v, proj, mask), 1e-5, 1e-4)


# K2 wide: D1 (ANPDistractor training: T 20, Nq 18, Nk 15) and D4
# (evaluation: Nq 36, Nk 25), a small odd shape (m not a multiple of the
# feature tile, d not of the k-step), and a 1-row context task beside the
# empty one
@pytest.mark.parametrize("t,h,nq,nk,d,m", [
    (20, 8, 18, 15, 256, 1419), (20, 8, 36, 25, 256, 1419),
    (2, 3, 5, 4, 68, 300), (3, 2, 40, 24, 128, 700),
    (20, 8, 15, 15, 256, 1419), (20, 8, 30, 25, 256, 1419),
    (4, 8, 50, 50, 256, 1419), (2, 3, 70, 10, 256, 1419),
    (2, 3, 9, 75, 256, 1419), (2, 2, 130, 3, 68, 300)])
def test_favor_wide_kernel_matches_plain(dev, t, h, nq, nk, d, m):
    """S1 (ANP ShapeNet3D training: Nq 15, Nk 15) and S4 (its evaluation:
    Nq 30, Nk 25, R = 55); then more than 64 rows an item, where phase 2
    takes chunks of 32 q and 32 k rows: R = 100 (two row groups in phase
    1), many q rows against few k rows and the reverse, and R = 133 (three
    row groups)."""
    q, k, v, proj, mask = _favor_inputs(dev, t, h, nq, nk, d, m, seed=nq)
    mask[1] = torch.arange(nk, device=dev) < 1
    assert favor.is_wide(d, m)
    _close(favor.favor_launch(q, k, v, proj, mask),
           favor.favor_plain(q, k, v, proj, mask), 1e-5, 1e-4)


def test_favor_wide_kernel_reads_views_reproducibly_in_one_launch(dev):
    """The attention block's transposed views and an expanded mask at D1's
    shape: no copy needed, two calls bit-equal, one kernel a call, the
    wrapper counting a wide launch."""
    q, k, v, proj, mask = _block_views(dev, t=20, n=15, d=256, m=1419)
    assert not q.is_contiguous() and mask.stride(0) == 0
    a = favor.favor_launch(q, k, v, proj, mask)
    b = favor.favor_launch(q, k, v, proj, mask)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    _close(a, favor.favor_plain(q, k, v, proj, mask), 1e-5, 1e-4)
    before = (favor.favor_attention.launches,
              favor.favor_attention.wide_launches)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        favor.favor_attention(q, k, v, proj, mask)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) <= 1 and all("favor_kernel_wide" in n for n in names)
    assert (favor.favor_attention.launches,
            favor.favor_attention.wide_launches) == (before[0] + 1,
                                                     before[1] + 1)


def test_favor_wide_kernel_phase_clock_orders_its_phases(dev):
    """The wide kernel's clock: one row a block of its grid, each block's
    points in order, the output as without the clock."""
    q, k, v, proj, mask = _favor_inputs(dev, 4, 8, 18, 15, 256, 1419)
    rows = favor.wide_grid(32, 1419)
    assert rows == min(32 * 12, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    st = torch.full((rows, len(favor.WIDE_PHASES)), -1, dtype=torch.int64,
                    device=dev)
    got = favor.favor_launch(q, k, v, proj, mask, stamps=st)
    torch.cuda.synchronize()
    assert bool((st[:, 1:] >= st[:, :-1]).all()) and bool((st >= 0).all())
    assert torch.equal(got.nan_to_num(), favor.favor_launch(
        q, k, v, proj, mask).nan_to_num())
    with pytest.raises(ValueError, match="stamps"):
        favor.favor_launch(q, k, v, proj, mask, stamps=st[:, :3])


def test_favor_wide_kernel_refuses_what_it_does_not_take(dev):
    """Heads wider than 256 and q, k, v of mixed types raise; Nq + Nk > 64
    rows and bfloat16 q, k, v are taken (they raised before the row groups
    and the bfloat16 read)."""
    q, k, v, proj, mask = _favor_inputs(dev, 2, 2, 4, 4, 260, 1419)
    with pytest.raises(ValueError, match="d <= 256"):
        favor.favor_launch(q, k, v, proj, mask)
    q, k, v, proj, mask = _favor_inputs(dev, 2, 2, 40, 30, 256, 1419)
    with pytest.raises(TypeError, match="all float32 or all bfloat16"):
        favor.favor_launch(q.bfloat16(), k, v, proj, mask)
    assert favor.favor_launch(q, k, v, proj, mask).shape == (2, 2, 40, 256)
    got = favor.favor_launch(q.bfloat16(), k.bfloat16(), v.bfloat16(), proj,
                             mask)
    assert got.dtype == torch.float32


def _block_views(dev, t=10, h=8, n=15, d=64, m=266, seed=5):
    """q, k, v as the attention block passes them ([T, N, H, d] transposed
    to [T, H, N, d]) and the mask as the sampler makes it (expanded)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn((t, n, h, d), generator=g, device=dev
                           ).transpose(1, 2) for _ in range(3))
    proj = torch.randn((m, d), generator=g, device=dev)
    mask = (torch.arange(n, device=dev)[None, :] < 7).expand(t, n)
    return q, k, v, proj, mask


def test_favor_kernel_reads_the_attention_blocks_views(dev):
    q, k, v, proj, mask = _block_views(dev)
    assert not q.is_contiguous() and mask.stride(0) == 0
    _close(favor.favor_launch(q, k, v, proj, mask),
           favor.favor_plain(q, k, v, proj, mask), 1e-5, 1e-4)
    _close(favor.favor_launch(q, k, v, proj),
           favor.favor_plain(q, k, v, proj), 1e-5, 1e-4)


def test_favor_kernel_is_bit_reproducible(dev):
    args = _favor_inputs(dev, 64, 8, 15, 15, 64, 266, seed=4)
    first = favor.favor_launch(*args)
    second = favor.favor_launch(*args)
    torch.cuda.synchronize()
    assert torch.equal(first.nan_to_num(), second.nan_to_num())
    assert torch.equal(first.isnan(), second.isnan())


def test_favor_call_issues_one_kernel(dev):
    from torch.profiler import ProfilerActivity, profile

    args = _block_views(dev)
    favor.favor_launch(*args)
    torch.cuda.synchronize()
    calls = 10
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            favor.favor_launch(*args)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    # one kernel a call and nothing else; the profiler may drop an event
    assert len(set(names)) == 1 and calls - 1 <= len(names) <= calls, names


def _favor_one_tf32_product(q, k, v, proj, mask):
    """``favor_plain`` with dash from TF32-rounded operands, as one TF32
    tensor-core product (no split) would compute it."""
    from wmfml_tpu_torch.kernels.tf32 import tf32_round

    def features(x, is_query):
        dn = x.shape[-1] ** -0.25
        dash = torch.matmul(tf32_round((dn * x).contiguous()),
                            tf32_round(proj).t())
        diag = (x ** 2).sum(-1, keepdim=True) / 2.0 * dn ** 2
        stab = dash.amax(-1, keepdim=True) if is_query else dash.amax()
        return proj.shape[0] ** -0.5 * (torch.exp(dash - diag - stab)
                                        + favor.EPS)

    k_prime = features(k, False) * mask[:, None, :, None]
    return favor.linear_attention(features(q, True), k_prime, v)


def test_favor_kernel_keeps_float32_where_dash_spans_20(dev):
    # the exp turns an absolute error of dash into a relative error of the
    # features: with dash spanning 20, one TF32 product misses the
    # tolerance, and the 3xTF32 split keeps float32's accuracy
    q, k, v, proj, mask = _favor_inputs(dev, 10, 8, 15, 15, 64, 266, seed=9)
    dash = torch.matmul(64 ** -0.25 * torch.cat([q, k], 2), proj.t())
    scale = 20.0 / float(dash.max() - dash.min())
    q, k = scale * q, scale * k
    dash = torch.matmul(64 ** -0.25 * torch.cat([q, k], 2), proj.t())
    assert 19.0 < float(dash.max() - dash.min()) < 21.0
    want = favor.favor_plain(q, k, v, proj, mask)
    with pytest.raises(AssertionError):
        _close(_favor_one_tf32_product(q, k, v, proj, mask), want, 1e-5, 1e-4)
    _close(favor.favor_launch(q, k, v, proj, mask), want, 1e-5, 1e-4)


@pytest.mark.parametrize("t,n", [(2, 2), (10, 15)])
def test_per_task_stem_kernel_matches_plain(dev, t, n):
    g = torch.Generator(device=dev).manual_seed(t)
    x = torch.rand((t * n, 128, 128, 1), generator=g, device=dev)
    ws = [scale * torch.randn((t, *shape), generator=g, device=dev)
          for scale, shape in ((0.3, (32, 1, 3, 3)), (0.1, (32,)),
                               (0.06, (48, 32, 3, 3)), (0.1, (48,)))]
    want = torch.cat([stem.stem_plain(x[i * n:(i + 1) * n],
                                      *(w[i] for w in ws)) for i in range(t)])
    _close(stem.stem_launch(x, *ws), want, 1e-4, 1e-4)


def _features_inputs(dev, t, n, s, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.relu(torch.randn((t, n, s, s, 64), generator=g, device=dev))
    w = 0.04 * torch.randn((t, 3, 64, 64, 3, 3), generator=g, device=dev)
    b = 0.1 * torch.randn((t, 3, 64), generator=g, device=dev)
    scale = 1.0 + 0.1 * torch.randn((3, 64), generator=g, device=dev)
    shift = 0.1 * torch.randn((3, 64), generator=g, device=dev)
    shots = torch.randint(1, n + 1, (t, 1), generator=g, device=dev)
    mask = torch.arange(n, device=dev)[None] < shots
    return x, w, b, scale, shift, mask


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("t,n,s", [(2, 3, 6), (3, 4, 13), (10, 15, 14)])
def test_features_kernel_matches_plain(dev, t, n, s, masked):
    *args, mask = _features_inputs(dev, t, n, s)
    mask = mask if masked else None
    _close(features.features_launch(*args, mask),
           features.features_plain(*args, mask), 1e-4, 1e-4)


def test_kernel_functions_count_launches_and_differentiate_twice(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    x, w, b, scale, shift, mask = _features_inputs(dev, 2, 3, 14, seed=1)
    sw = [(0.1 * torch.randn(s, generator=g, device=dev)).requires_grad_(True)
          for s in ((2, 32, 1, 3, 3), (2, 32), (2, 48, 32, 3, 3), (2, 48))]
    img = torch.rand((6, 32, 32, 1), generator=g, device=dev)
    # fixed random read-outs, so no gradient cancels to noise (a sum of
    # squares of batch-normed outputs barely depends on their input); the
    # conv bias b feeds the batch norm, which removes it: not compared
    r_feat = torch.randn(x.shape, generator=g, device=dev)
    r_stem = torch.randn((6, 4, 4, 48), generator=g, device=dev)
    params = [a.requires_grad_(True) for a in (x, w, scale, shift)]

    def second_order(stem_fn, features_fn):
        y = (features_fn(x, w, b, scale, shift, mask) * r_feat).sum()
        y = y + (stem_fn(img, *sw) * r_stem).sum()
        gs = torch.autograd.grad(y, params + sw, create_graph=True)
        return torch.autograd.grad(sum(g.square().sum() for g in gs),
                                   params + sw)

    before = (stem.literature_stem.launches, features.maml_features.launches)
    got = second_order(stem.literature_stem, features.maml_features)
    assert (stem.literature_stem.launches,
            features.maml_features.launches) == (before[0] + 1, before[1] + 1)
    want = second_order(stem.stem_plain, features.features_plain)
    torch.cuda.synchronize()
    for a, b_ in zip(got, want):     # float32 second derivatives, per tensor
        assert float((a - b_).abs().max()) <= 1e-3 * float(b_.abs().max())


# -- 3xTF32 on the tensor cores ------------------------------------------------

@pytest.mark.parametrize("kernel", ["stem", "features"])
def test_kernels_keep_float32_on_inputs_offset_by_100(dev, kernel):
    # x = 100 + unit spread: one TF32 product would err by ~100 * 2^-11 per
    # term, far outside the tolerance; the split keeps float32's accuracy
    g = torch.Generator(device=dev).manual_seed(7)
    if kernel == "stem":
        x = 100.0 + torch.rand((6, 64, 64, 1), generator=g, device=dev)
        ws = [scale * torch.randn((2, *shape), generator=g, device=dev)
              for scale, shape in ((0.3, (32, 1, 3, 3)), (0.1, (32,)),
                                   (0.06, (48, 32, 3, 3)), (0.1, (48,)))]
        _close(stem.stem_launch(x, *ws), stem.stem_plain(x, *ws), 1e-4, 1e-4)
    else:
        x, w, b, scale, shift, mask = _features_inputs(dev, 10, 15, 14, seed=7)
        x = 100.0 + torch.randn(x.shape, generator=g, device=dev)
        # zero-sum filters: the offset cancels inside the image and not at
        # its border, so the batch norm sees a spread, not only a mean
        w = w - w.mean((3, 4, 5), keepdim=True)
        _close(features.features_launch(x, w, b, scale, shift, mask),
               features.features_plain(x, w, b, scale, shift, mask),
               1e-4, 1e-4)


@pytest.mark.parametrize("kernel", ["stem", "features"])
def test_weight_packing_on_the_card_is_its_plain_twin_bit_for_bit(dev, kernel):
    # the kernels split their weights with cvt.rna.tf32.f32 into wgmma B
    # order; kernels/tf32.py's split, held against numpy on the CPU, is the
    # twin
    g = torch.Generator(device=dev).manual_seed(11)
    if kernel == "stem":
        w1 = 0.06 * torch.randn((3, 48, 32, 3, 3), generator=g, device=dev)
        got, want = stem.pack_conv1_launch(w1, 3), stem.pack_conv1(w1, 3)
    else:
        w = 0.04 * torch.randn((2, 3, 64, 64, 3, 3), generator=g, device=dev)
        got, want = features.pack_launch(w), features.pack_weights(w)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_features_kernel_is_bit_reproducible(dev):
    *args, mask = _features_inputs(dev, 10, 15, 14, seed=3)
    first = features.features_launch(*args, mask)
    second = features.features_launch(*args, mask)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_unmasked_batch_norm_divides_as_the_masked_one_does(dev):
    # both divide the channel sums by a tensor (a true division, as the
    # kernel's load_bn and JAX do); a Python divisor would multiply by its
    # reciprocal on the card and miss the quotient in some channels
    x = _features_inputs(dev, 10, 15, 14, seed=5)[0]
    every = torch.ones(x.shape[:2], dtype=torch.bool, device=dev)
    got = features.masked_batch_norm(x, None)
    want = features.masked_batch_norm(x, every)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", ["stem", "favor", "features"])
def test_kernels_run_on_tensor_cores(dev, name):
    import os
    import shutil
    import subprocess

    from wmfml_tpu_torch.kernels import build

    build.load(name)
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    lib = build._lib_path(name)
    assert os.path.exists(lib), lib
    sass = subprocess.run([tool, "--dump-sass", lib], check=True,
                          capture_output=True, text=True).stdout
    assert "HGMMA" in sass


# -- K6 (image DA: the warp chain and the hash masks in one launch) -----------

WARP_TOL = (1e-5, 1e-5)


def _draw(dev, b, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return image_aug.ShapeNet1DAugmenter().sample(b, g, dev)


def _images(dev, shape, seed=1):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, 256, shape, dtype=torch.uint8, generator=g,
                         device=dev)


def _order(dev, order):
    return torch.tensor([order], device=dev)


def _twin_cpu(x, u, keys, order):
    return image_da.image_da_plain(x.cpu(), u.cpu(), keys.cpu(), order.cpu())


@pytest.mark.parametrize("order", range(6))
@pytest.mark.parametrize("shape", [(10, 15, 128, 128, 1), (3, 40, 24, 1)])
def test_image_da_kernel_matches_the_twin_in_every_order(dev, order, shape):
    b = shape[0] * shape[1] if len(shape) == 5 else shape[0]
    u, keys, _ = _draw(dev, b, seed=order)
    u[:, 13:17] = 0.25                 # every gate on
    x = _images(dev, shape)
    got = image_da.image_da_launch(x, u, keys, _order(dev, order))
    _close(got, image_da.image_da_plain(x, u, keys, _order(dev, order)),
           *WARP_TOL)
    _close(got.cpu(), _twin_cpu(x, u, keys, _order(dev, order)), *WARP_TOL)


def test_image_da_kernel_reads_the_samplers_slices_through_their_strides(dev):
    x = _images(dev, (4, 9, 32, 32, 1))
    ctx, qry = x[:, :5], x[:, 5:]
    assert not ctx.is_contiguous()
    for part in (ctx, qry):
        u, keys, order = _draw(dev, part.shape[0] * part.shape[1])
        _close(image_da.image_da_launch(part, u, keys, order),
               image_da.image_da_plain(part.contiguous(), u, keys, order),
               *WARP_TOL)


def _u_for(value, lo, span):
    """A float32 uniform u with fl(fl(u span) + lo) == value, where one
    exists near (value - lo) / span (u may leave [0, 1): the kernel takes
    any)."""
    import numpy as np

    f32 = np.float32
    u0 = f32((value - lo) / span)
    cands = u0 + np.arange(-4096, 4097, dtype=np.float32) * np.spacing(u0)
    vals = f32(cands * f32(span)) + f32(lo)
    hit = np.flatnonzero(vals == f32(value))
    return float(cands[hit[0]] if len(hit) else u0)


def test_image_da_kernel_snaps_nearest_like_the_twin_on_half_boundaries(dev):
    """Affine scales and shifts that put sample positions on .5, where one
    ulp of the position flips a nearest tap to the next pixel (an O(1)
    error)."""
    h = w = 128
    scales = [2.0, 1.25, 0.8, 1.0, 0.5, 1.2, 0.85, 1.1]
    shifts = [0.5, -0.5, 0.25, 0.1, -1.5, 0.3, 2.5, -0.7]
    rows = []
    for sc in scales:
        for sh in shifts:
            r = [0.9] * 19                       # gates off, no dropout
            r[5] = r[6] = _u_for(sc, 0.8, 0.4)
            r[7] = _u_for(sh, -0.1 * w, 0.2 * w)
            r[8] = _u_for(sh, -0.1 * h, 0.2 * h)
            r[9], r[14], r[15] = 0.3, 0.1, 0.1   # Affine on, nearest
            rows.append(r)
    b = len(rows)
    u = torch.tensor(rows, device=dev)
    keys = torch.zeros((b, 2), dtype=torch.int32, device=dev)
    x = _images(dev, (b, h, w, 1), seed=2)
    params = image_aug.params_from_draw(u.cpu(), keys.cpu(), 0, h, w)
    assert float(params.warp[:, 1, 0].eq(2.0).float().sum()) == len(shifts)
    assert bool((params.warp[:, 1, 2] == 0.5).any())
    for crop in (0.9, 0.1):                      # Affine alone, then chained
        u[:, 13] = crop
        for order in (0, 2):
            got = image_da.image_da_launch(x, u, keys, _order(dev, order))
            _close(got.cpu(), _twin_cpu(x, u, keys, _order(dev, order)),
                   *WARP_TOL)


def test_image_da_kernel_with_every_gate_off_is_x_over_255(dev):
    x = _images(dev, (2, 15, 128, 128, 1))
    u, keys, _ = _draw(dev, 30)
    u[:, 13:17] = 0.75
    want = x.cpu().float() / 255.0               # true division on the CPU
    for order in range(6):
        got = image_da.image_da_launch(x, u, keys, _order(dev, order))
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("pick", [0.25, 0.75])    # Dropout, CoarseDropout
@pytest.mark.parametrize("b,h,w", [(150, 128, 128), (5, 40, 24)])
def test_image_da_masks_equal_the_twin_bit_for_bit(dev, pick, b, h, w):
    u, keys, _ = _draw(dev, b, seed=b)
    u[:, 13:15] = 0.75                           # both warps off
    u[:, 16], u[:, 17] = 0.25, pick              # the dropout op on
    u[:, 10], u[:, 11] = 5.0, 9.0                # rates ~.46 and .45
    x = _images(dev, (b, h, w, 1))
    for order in range(6):
        got = image_da.image_da_launch(x, u, keys, _order(dev, order)).cpu()
        want = _twin_cpu(x, u, keys, _order(dev, order))
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert bool((got == 0).any()) and bool((got != 0).any())


@pytest.mark.parametrize("b,h,w", [(150, 128, 128), (5, 46, 24)])
def test_image_da_coarse_dropout_at_its_largest_grid_equals_the_twin(dev, b,
                                                                     h, w):
    u, keys, _ = _draw(dev, b, seed=7)
    u[:, 13:15] = 0.75                           # both warps off
    u[:, 16], u[:, 17] = 0.25, 0.75              # CoarseDropout on
    u[:, 11] = 9.0                               # rate ~.45
    u[:, 12] = 1.0 - 2.0 ** -24                  # the largest size fraction
    x = _images(dev, (b, h, w, 1))
    for order in range(6):
        got = image_da.image_da_launch(x, u, keys, _order(dev, order)).cpu()
        want = _twin_cpu(x, u, keys, _order(dev, order))
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_image_da_reads_the_order_modulo_six_as_the_twin_does(dev):
    u, keys, _ = _draw(dev, 150, seed=8)
    u[:, 13:17] = 0.25                           # every gate on
    x = _images(dev, (10, 15, 128, 128, 1))
    for o in (-7, -1, 6, 11):
        got = image_da.image_da_launch(x, u, keys, _order(dev, o))
        want = image_da.image_da_launch(x, u, keys, _order(dev, o % 6))
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        _close(got.cpu(), _twin_cpu(x, u, keys, _order(dev, o)), *WARP_TOL)


def test_image_da_parameters_equal_params_from_draw_bit_for_bit(dev):
    u, keys, order = _draw(dev, 150, seed=3)
    x = _images(dev, (150, 128, 128, 1))
    out = torch.empty((150, image_da.NPARAMS), device=dev)
    image_da.image_da_launch(x, u, keys, order, params_out=out)
    p = image_aug.params_from_draw(u, keys, order, 128, 128)
    want = torch.cat([p.warp.flatten(1), p.drop], 1)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))


def test_image_da_kernel_is_bit_reproducible(dev):
    u, keys, _ = _draw(dev, 150, seed=5)
    x = _images(dev, (10, 15, 128, 128, 1))
    for order in range(6):
        first = image_da.image_da_launch(x, u, keys, _order(dev, order))
        second = image_da.image_da_launch(x, u, keys, _order(dev, order))
        torch.cuda.synchronize()
        assert torch.equal(first, second)


@pytest.mark.parametrize("order", range(6))
def test_image_da_call_is_one_launch_in_every_order(dev, order):
    from torch.profiler import ProfilerActivity, profile

    u, keys, _ = _draw(dev, 150, seed=order)
    x = _images(dev, (10, 15, 128, 128, 1))
    o = _order(dev, order)
    image_da.image_da(x, u, keys, o)
    torch.cuda.synchronize()
    calls = 10
    for _ in range(3):
        before = image_da.image_da.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                got = image_da.image_da(x, u, keys, o)
            torch.cuda.synchronize()
        assert image_da.image_da.launches == before + calls
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:       # a trace can hold no device event at all: take again
            break
    # K6 and nothing else, never more than one kernel a call; the profiler
    # drops some events of these ctypes launches (8 of 10 seen, and all 10
    # in 2 of 12 traces), so the launch count above, not the trace, says
    # that every call launched
    assert len(set(names)) == 1 and "image_da_kernel" in names[0], names
    assert 1 <= len(names) <= calls, names
    _close(got.cpu(), _twin_cpu(x, u, keys, o), *WARP_TOL)


def test_augmenter_reads_nothing_back_to_the_host(dev):
    aug = image_aug.ShapeNet1DAugmenter()
    g = torch.Generator(device=dev).manual_seed(0)
    x = _images(dev, (10, 15, 128, 128, 1))
    aug(x, g)                                    # builds and loads K6
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            out = aug(x, g)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert out.shape == x.shape and out.dtype == torch.float32


def test_image_da_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    u, keys, order = _draw(dev, 4)
    with pytest.raises(ValueError, match="image DA kernel takes"):
        image_da.image_da(_images(dev, (4, 32, 32, 3)), u, keys, order)
    with pytest.raises(ValueError, match="image DA kernel takes"):
        image_da.image_da(_images(dev, (4, 32, 30, 1)), u, keys, order)
    with pytest.raises(ValueError, match="image DA kernel takes"):
        image_da.image_da(_images(dev, (4, 16, 132, 1)), u, keys, order)
    with pytest.raises(TypeError):
        image_da.image_da(_images(dev, (4, 32, 32, 1)).float(), u, keys,
                          order)


# -- bfloat16 paths -------------------------------------------------------------

BF16 = torch.bfloat16


def _bf16_close(got, want, want_f32, element_ulps=True):
    """The module docstring's bfloat16 rule (``element_ulps`` false leaves
    out the per-element ulp bound)."""
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    g, w, f = got.float(), want.float(), want_f32.float()
    assert bool(torch.isfinite(g).all())
    err, own = (g - w).abs(), (w - f).abs()
    bound = 2 * float(own.max()) + 2.0 ** -7 * float(f.abs().max())
    assert float(err.max()) <= bound, (float(err.max()), bound)
    assert float(err.mean()) <= float(own.mean()), (float(err.mean()),
                                                    float(own.mean()))
    if got.dtype == BF16 and element_ulps:
        ulps = _ulps(got, want, 2.0 ** -8 * float(w.abs().max()))
        assert float(ulps.max()) <= 2.0, float(ulps.max())


def _stem_weights(dev, lead, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [scale * torch.randn((*lead, *shape), generator=g, device=dev)
            for scale, shape in ((0.3, (32, 1, 3, 3)), (0.1, (32,)),
                                 (0.06, (48, 32, 3, 3)), (0.1, (48,)))]


@pytest.mark.parametrize("lead,b", [((), 300), ((10,), 150), ((2,), 6)],
                         ids=["shared", "per_task", "small"])
def test_stem_bf16_kernel_matches_its_twin(dev, lead, b):
    g = torch.Generator(device=dev).manual_seed(b)
    hw = 32 if b == 6 else 128
    x = torch.rand((b, hw, hw, 1), generator=g, device=dev)
    ws = _stem_weights(dev, lead, b)
    args = [a.to(BF16) for a in (x, *ws)]
    got = stem.stem_launch(*args)
    assert got.dtype == BF16
    _bf16_close(got, stem.stem_plain(*args),
                stem.stem_plain(*(a.float() for a in args)))


@pytest.mark.parametrize("t", [10, 64])     # 64: more items than blocks
def test_favor_bf16_kernel_matches_its_twin(dev, t):
    g = torch.Generator(device=dev).manual_seed(t)
    h, n, d, m = 8, 15, 64, 266
    proj = torch.randn((m, d), generator=g, device=dev) * 0.5
    # [T, N, H, d] transposed, as the attention block hands them over
    q, k, v = (torch.randn((t, n, h, d), generator=g, device=dev).to(
        BF16).transpose(1, 2) for _ in range(3))
    shots = torch.randint(1, n + 1, (t, 1), generator=g, device=dev)
    mask = torch.arange(n, device=dev)[None] < shots
    got = favor.favor_launch(q, k, v, proj, mask)
    assert got.dtype == torch.float32
    _bf16_close(got, favor.favor_plain(q, k, v, proj, mask),
                favor.favor_plain(q.float(), k.float(), v.float(), proj,
                                  mask))


# K2 wide in bfloat16: D5 (ANPDistractor: Nq 18, Nk 15), S6 (ANP
# ShapeNet3D: Nq 15, Nk 15), D4's evaluation (Nq 36, Nk 25) and R = 100
@pytest.mark.parametrize("t,nq,nk", [(20, 18, 15), (20, 15, 15),
                                     (20, 36, 25), (4, 50, 50)])
def test_favor_wide_bf16_kernel_matches_its_twin(dev, t, nq, nk):
    """bfloat16 q, k, v as the attention block hands them over ([T, N, H,
    d] transposed), ANPDistractor's width (d = e = 256, m = 1419), shots 1
    .. Nk: float32 out; two calls bit-equal; the wrapper counts a bfloat16
    wide launch. At d = 256 the normalizer 256^-1/4 = 1/4 is exact, so dn
    x rounds nothing and bfloat16 moves only the diagonal term: the twin's
    own distance from float32 lies below float32's summation noise, and
    the kernel is held to the bfloat16 twin within the float32 tolerance
    (atol 1e-5, rtol 1e-4), far inside the bfloat16 rule's bound."""
    g = torch.Generator(device=dev).manual_seed(nq + nk)
    h, d, m = 8, 256, 1419
    proj = torch.randn((m, d), generator=g, device=dev)
    q = torch.randn((t, nq, h, d), generator=g, device=dev).to(
        BF16).transpose(1, 2)
    k, v = (torch.randn((t, nk, h, d), generator=g, device=dev).to(
        BF16).transpose(1, 2) for _ in range(2))
    shots = torch.randint(1, nk + 1, (t, 1), generator=g, device=dev)
    mask = torch.arange(nk, device=dev)[None] < shots
    got = favor.favor_launch(q, k, v, proj, mask)
    assert got.dtype == torch.float32
    assert torch.equal(got, favor.favor_launch(q, k, v, proj, mask))
    _close(got, favor.favor_plain(q, k, v, proj, mask), 1e-5, 1e-4)
    before = (favor.favor_attention.bf16_launches,
              favor.favor_attention.wide_launches)
    favor.favor_attention(q, k, v, proj, mask)
    assert (favor.favor_attention.bf16_launches,
            favor.favor_attention.wide_launches) == (before[0] + 1,
                                                     before[1] + 1)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("t,n,s", [(2, 3, 6), (10, 15, 14)])
def test_features_bf16_kernel_matches_its_twin(dev, t, n, s, masked):
    *args, mask = _features_inputs(dev, t, n, s, seed=s)
    mask = mask if masked else None
    args = [a.to(BF16) for a in args]
    got = features.features_launch(*args, mask)
    assert got.dtype == BF16
    _bf16_close(got, features.features_plain(*args, mask),
                features.features_plain(*(a.float() for a in args), mask))


@pytest.mark.parametrize("kernel", ["stem", "features"])
def test_bf16_weight_packing_on_the_card_is_its_plain_twin_bit_for_bit(
        dev, kernel):
    # bfloat16 weights go to the tensor cores as they are, in the k16 B
    # order of kernels/tf32.py:gmma_b_layout on a bfloat16 tensor
    g = torch.Generator(device=dev).manual_seed(12)
    if kernel == "stem":
        w1 = (0.06 * torch.randn((3, 48, 32, 3, 3), generator=g,
                                 device=dev)).to(BF16)
        got, want = stem.pack_conv1_launch(w1, 3), stem.pack_conv1(w1, 3)
    else:
        w = (0.04 * torch.randn((2, 3, 64, 64, 3, 3), generator=g,
                                device=dev)).to(BF16)
        got, want = features.pack_launch(w), features.pack_weights(w)
    torch.cuda.synchronize()
    assert got.dtype == BF16 and got.shape == want.shape
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_bf16_wrappers_count_their_launches_and_differentiate_twice(dev):
    g = torch.Generator(device=dev).manual_seed(2)
    x, w, b, scale, shift, mask = (a.to(BF16) if a.is_floating_point() else a
                                   for a in _features_inputs(dev, 2, 3, 14,
                                                             seed=2))
    sw = [w_.to(BF16).requires_grad_(True)
          for w_ in _stem_weights(dev, (2,), 3)]
    img = torch.rand((6, 32, 32, 1), generator=g, device=dev).to(BF16)
    r_feat = torch.randn(x.shape, generator=g, device=dev).to(BF16)
    r_stem = torch.randn((6, 4, 4, 48), generator=g, device=dev).to(BF16)
    params = [a.requires_grad_(True) for a in (x, w, scale, shift)]

    def second_order(stem_fn, features_fn):
        y = (features_fn(x, w, b, scale, shift, mask) * r_feat).float().sum()
        y = y + (stem_fn(img, *sw) * r_stem).float().sum()
        gs = torch.autograd.grad(y, params + sw, create_graph=True)
        return torch.autograd.grad(sum(g.float().square().sum() for g in gs),
                                   params + sw)

    before = [(fn.launches, fn.bf16_launches) for fn in (
        stem.literature_stem, features.maml_features)]
    got = second_order(stem.literature_stem, features.maml_features)
    after = [(fn.launches, fn.bf16_launches) for fn in (
        stem.literature_stem, features.maml_features)]
    assert after == [(a + 1, c + 1) for a, c in before]
    # the backward recomputes through the bfloat16 twins either way
    want = second_order(stem.stem_plain, features.features_plain)
    torch.cuda.synchronize()
    for a, b_ in zip(got, want):
        assert a.dtype == BF16
        assert float((a - b_).float().abs().max()) <= 1e-3 * float(
            b_.float().abs().max())


def _ulps(got, want, floor=0.0):
    """|got - want| in units of want's bfloat16 spacing (the gap from |want|
    to the next bfloat16 above it); an element with |want| below ``floor``
    is measured in the spacing at ``floor``."""
    w = want.abs().clamp_min(floor).contiguous()
    gap = (w.view(torch.int16) + 1).view(BF16).float() - w.float()
    return (got.float() - want.float()).abs() / gap


@pytest.mark.parametrize("order", range(6))
def test_image_da_bf16_kernel_matches_the_twin_in_every_order(dev, order):
    u, keys, _ = _draw(dev, 150, seed=order)
    u[:, 13:17] = 0.25                 # every gate on
    x = _images(dev, (10, 15, 128, 128, 1))
    o = _order(dev, order)
    params = torch.empty((150, image_da.NPARAMS), device=dev)
    got = image_da.image_da_launch(x, u, keys, o, BF16, params_out=params)
    assert got.dtype == BF16
    p = image_aug.params_from_draw(u, keys, o, 128, 128)
    torch.cuda.synchronize()
    assert torch.equal(params.view(torch.int32),
                       torch.cat([p.warp.flatten(1), p.drop], 1).view(
                           torch.int32))
    for want in (image_da.image_da_plain(x, u, keys, o, BF16).cpu(),
                 image_da.image_da_plain(x.cpu(), u.cpu(), keys.cpu(),
                                         o.cpu(), BF16)):
        assert want.dtype == BF16
        assert float(_ulps(got.cpu(), want).max()) <= 2.0


@pytest.mark.parametrize("pick", [0.25, 0.75])    # Dropout, CoarseDropout
def test_image_da_bf16_masks_equal_the_twin_bit_for_bit(dev, pick):
    u, keys, _ = _draw(dev, 150, seed=9)
    u[:, 13:15] = 0.75                           # both warps off
    u[:, 16], u[:, 17] = 0.25, pick              # the dropout op on
    u[:, 10], u[:, 11] = 5.0, 9.0                # rates ~.46 and .45
    x = _images(dev, (150, 128, 128, 1))
    for order in range(6):
        o = _order(dev, order)
        got = image_da.image_da_launch(x, u, keys, o, BF16).cpu()
        want = image_da.image_da_plain(x.cpu(), u.cpu(), keys.cpu(), o.cpu(),
                                       BF16)
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
        assert bool((got == 0).any()) and bool((got != 0).any())


def test_bf16_augmenter_counts_its_launches_and_reads_nothing_back(dev):
    aug = image_aug.ShapeNet1DAugmenter(BF16)
    g = torch.Generator(device=dev).manual_seed(0)
    x = _images(dev, (10, 15, 128, 128, 1))
    aug(x, g)
    torch.cuda.synchronize()
    before = (image_da.image_da.launches, image_da.image_da.bf16_launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = aug(x, g)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert (image_da.image_da.launches,
            image_da.image_da.bf16_launches) == (before[0] + 1, before[1] + 1)
    assert out.shape == x.shape and out.dtype == BF16


# -- K6's programs 1-3: Pascal1D's chain and the fixed-order pipelines ------

NEW_PROGRAMS = ("pascal_1d", "shapenet_1d_fixed", "pascal_1d_fixed")
# float32: every term of every sum is nonnegative (taps, fill, windows), so
# kernel and twin differ by a few float32 ulps of each value, powf by a few
# more (the card's and the CPU's pow are not bit-equal), and gamma <= 2 at
# most doubles a relative error: within the warps' 1e-5
PIXEL_TOL = WARP_TOL


def _program_draw(dev, program, b, seed=0, on=True):
    """A call's raw draw for ``program`` with every gate on (``on``: warps,
    gamma, blur at k = 3 for half the images and 2 for the rest, the
    dropout op) or every gate off."""
    aug = image_aug.Augmenter(program=program)
    g = torch.Generator(device=dev).manual_seed(seed)
    u, keys, order = aug.sample(b, g, dev)
    u[:, 13:17] = 0.25 if on else 0.75
    if u.shape[1] > 19:
        u[:, 19] = u[:, 21] = 0.25 if on else 0.75
        u[:, 22] = torch.where(torch.arange(b, device=dev) % 2 == 0, 0.9,
                               0.5)
    return u, keys, order


def _pascal_order(dev, order):
    return torch.tensor([order], device=dev)


@pytest.mark.parametrize("program", NEW_PROGRAMS)
@pytest.mark.parametrize("shape", [(10, 15, 128, 128, 1), (3, 48, 24, 1)])
def test_image_da_new_programs_match_their_twins(dev, program, shape):
    b = shape[0] * shape[1] if len(shape) == 5 else shape[0]
    u, keys, order = _program_draw(dev, program, b, seed=len(shape))
    x = _images(dev, shape)
    orders = [None] if order is None else [_pascal_order(dev, o)
                                           for o in (0, 119, 57)]
    for o in orders:
        got = image_da.image_da_launch(x, u, keys, o, program=program)
        _close(got, image_da.image_da_plain(x, u, keys, o, program=program),
               *PIXEL_TOL)
        _close(got.cpu(), image_da.image_da_plain(
            x.cpu(), u.cpu(), keys.cpu(), None if o is None else o.cpu(),
            program=program), *PIXEL_TOL)
        assert not torch.equal(got.cpu(), image_aug.to_unit(x.cpu()))


@pytest.mark.parametrize("program", NEW_PROGRAMS)
def test_image_da_new_programs_parameters_equal_the_twins_bit_for_bit(
        dev, program):
    u, keys, order = _program_draw(dev, program, 150, seed=3)
    g = torch.Generator(device=dev).manual_seed(4)
    u = torch.where(torch.rand(u.shape, generator=g, device=dev) < 0.5, u,
                    torch.rand(u.shape, generator=g, device=dev))
    x = _images(dev, (150, 128, 128, 1))
    out = torch.empty((150, image_da.nparams(program)), device=dev)
    image_da.image_da_launch(x, u, keys, order, params_out=out,
                             program=program)
    want = image_aug.params_row(image_aug.params_for(program, u, keys, order,
                                                     128, 128))
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("pick", [0.25, 0.75])    # Dropout, CoarseDropout
@pytest.mark.parametrize("program", NEW_PROGRAMS)
def test_image_da_new_programs_masks_equal_the_twin_bit_for_bit(dev, program,
                                                                 pick):
    """Warps, gamma and blur off (the fixed programs' one warp is then the
    identity), the dropout op on: the output is x / 255 masked, bit for
    bit, in float32 and in bfloat16 (the fixed grid's hashed cells, or the
    random-size grid's, or Dropout's pixels)."""
    u, keys, order = _program_draw(dev, program, 150, seed=9, on=False)
    u[:, 16], u[:, 17] = 0.25, pick              # the dropout op on
    u[:, 10], u[:, 11] = 5.0, 9.0                # rates ~.46 and .45
    x = _images(dev, (150, 128, 128, 1))
    orders = [None] if order is None else [_pascal_order(dev, o)
                                           for o in (0, 33, 119)]
    for dtype, bits in ((torch.float32, torch.int32), (BF16, torch.int16)):
        for o in orders:
            got = image_da.image_da_launch(x, u, keys, o, dtype,
                                           program=program).cpu()
            want = image_da.image_da_plain(
                x.cpu(), u.cpu(), keys.cpu(), None if o is None else o.cpu(),
                dtype, program)
            assert torch.equal(got.view(bits), want.view(bits))
            assert bool((got == 0).any()) and bool((got != 0).any())


@pytest.mark.parametrize("program", NEW_PROGRAMS)
def test_image_da_new_programs_with_every_gate_off_are_x_over_255(dev,
                                                                  program):
    u, keys, order = _program_draw(dev, program, 30, seed=2, on=False)
    x = _images(dev, (2, 15, 128, 128, 1))
    got = image_da.image_da_launch(x, u, keys, order, program=program)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), x.cpu().float() / 255.0)


@pytest.mark.parametrize("program", NEW_PROGRAMS)
def test_image_da_new_programs_bf16_match_their_twins(dev, program):
    """Each op rounds to bfloat16 where the JAX op returns img.dtype; the
    kernel and the twin round at the same points after float32 sums in
    another order: the module docstring's bfloat16 rule."""
    u, keys, order = _program_draw(dev, program, 150, seed=6)
    x = _images(dev, (10, 15, 128, 128, 1))
    orders = [None] if order is None else [_pascal_order(dev, o)
                                           for o in (0, 119, 70)]
    for o in orders:
        got = image_da.image_da_launch(x, u, keys, o, BF16, program=program)
        assert got.dtype == BF16
        for dev_ in ("cuda", "cpu"):
            oo = None if o is None else o.to(dev_)
            want = image_da.image_da_plain(x.to(dev_), u.to(dev_),
                                           keys.to(dev_), oo, BF16, program)
            want_f32 = image_da.image_da_plain(x.to(dev_), u.to(dev_),
                                               keys.to(dev_), oo,
                                               torch.float32, program)
            g = got.to(dev_)
            err, own = (g.float() - want.float()).abs(), (
                want.float() - want_f32).abs()
            bound = 2 * float(own.max()) + 2.0 ** -7 * float(
                want_f32.abs().max())
            assert float(err.max()) <= bound, (dev_, float(err.max()), bound)
            assert float(err.mean()) <= float(own.mean())


def test_pascal_program_is_one_launch_in_every_order_sampled(dev):
    """24 orders drawn as the augmenter draws them, the identity and the
    reverse added: each call one launch (the counters, by program) and the
    twin's result."""
    from torch.profiler import ProfilerActivity, profile

    aug = image_aug.Augmenter(program="pascal_1d")
    g = torch.Generator(device=dev).manual_seed(12)
    x = _images(dev, (10, 15, 128, 128, 1))
    u, keys, _ = _program_draw(dev, "pascal_1d", 150, seed=12)
    orders = [0, 119] + [int(aug.sample(1, g, dev)[2]) for _ in range(24)]
    for o in orders:
        before = dict(image_da.image_da.program_launches)
        total = image_da.image_da.launches
        order = _pascal_order(dev, o)     # its host copy outside the trace
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            got = image_da.image_da(x, u, keys, order, program="pascal_1d")
            torch.cuda.synchronize()
        after = image_da.image_da.program_launches
        assert after["pascal_1d"] == before["pascal_1d"] + 1
        assert image_da.image_da.launches == total + 1
        assert all(after[p] == before[p] for p in after if p != "pascal_1d")
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(names) <= 1 and all("image_da_kernel" in n for n in names)
        _close(got.cpu(), image_da.image_da_plain(
            x.cpu(), u.cpu(), keys.cpu(), torch.tensor([o]),
            program="pascal_1d"), *PIXEL_TOL)


def test_new_augmenters_read_nothing_back_to_the_host(dev):
    x = _images(dev, (10, 15, 128, 128, 1))
    augs = [image_aug.Augmenter(program="pascal_1d"),
            image_aug.Augmenter(BF16, "shapenet_1d_fixed"),
            image_aug.Augmenter(program="pascal_1d_fixed")]
    g = torch.Generator(device=dev).manual_seed(0)
    for aug in augs:
        aug(x, g)                                # builds and loads K6
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [aug(x, g) for aug in augs]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert [o.dtype for o in outs] == [torch.float32, BF16, torch.float32]


def test_fixed_programs_refuse_a_grid_that_does_not_divide_the_image(dev):
    u, keys, _ = _program_draw(dev, "shapenet_1d_fixed", 2)
    with pytest.raises(ValueError, match="image DA kernel takes"):
        image_da.image_da(_images(dev, (2, 50, 48, 1)), u, keys, None,
                          program="shapenet_1d_fixed")


# -- ShapeNet3D's programs 6 and 7: float RGB read from RGBA ----------------

RGB_PROGRAMS = ("shapenet_3d", "shapenet_3d_fixed")


def _rgba(dev, shape, seed=0):
    """Float RGBA [*shape, 4]: alpha 1 (background) on about a third of the
    pixels, some black foreground pixels (brightness's gray branch)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand(shape + (4,), generator=g, device=dev)
    x[..., 3] = torch.where(torch.rand(shape, generator=g, device=dev) < .35,
                            1.0, x[..., 3] * 0.9)
    x[..., :3] *= torch.rand(shape + (1,), generator=g, device=dev) > 0.05
    return x


def _rgb_draw(dev, program, b, seed=0, on=True):
    """``_program_draw`` with brightness's gate too."""
    u, keys, order = _program_draw(dev, program, b, seed, on)
    u[:, 23] = 0.25 if on else 0.75
    return u, keys, order


def _rgb_orders(dev, program):
    """The identity, its reverse and 8 random orders of the 720 (as device
    data), or the fixed program's none."""
    if program == "shapenet_3d_fixed":
        return [None]
    rand = torch.randint(1, 719, (8,), generator=torch.Generator()
                         .manual_seed(7)).tolist()
    return [_pascal_order(dev, o) for o in [0, 719] + rand]


@pytest.mark.parametrize("program", RGB_PROGRAMS)
@pytest.mark.parametrize("shape", [(20, 15, 64, 64), (3, 32, 24),
                                   (2, 32, 96)])
def test_image_da_rgb_programs_match_their_twins(dev, program, shape):
    """S1's context call (300 images of 64 x 64, the RGB view of the RGBA
    batch, read through its strides) and two small shapes (96 columns: four
    a lane), every gate on, in ten orders: within the warps' tolerance of
    the card twin, and of the CPU twin in the first."""
    b = math.prod(shape[:-2])
    x = _rgba(dev, shape, seed=b)[..., :3]
    u, keys, _ = _rgb_draw(dev, program, b, seed=b)
    for i, o in enumerate(_rgb_orders(dev, program)):
        got = image_da.image_da_launch(x, u, keys, o, program=program)
        assert got.shape == x.shape and got.is_contiguous()
        _close(got, image_da.image_da_plain(x, u, keys, o, program=program),
               *WARP_TOL)
        if i == 0:
            _close(got.cpu(), image_da.image_da_plain(
                x.cpu(), u.cpu(), keys.cpu(), None if o is None else o.cpu(),
                program=program), *WARP_TOL)


@pytest.mark.parametrize("program", RGB_PROGRAMS)
def test_image_da_rgb_parameters_equal_the_twins_bit_for_bit(dev, program):
    u, keys, order = _rgb_draw(dev, program, 300, seed=3)
    g = torch.Generator(device=dev).manual_seed(4)
    u = torch.where(torch.rand(u.shape, generator=g, device=dev) < 0.5, u,
                    torch.rand(u.shape, generator=g, device=dev))
    x = _rgba(dev, (300, 64, 64))[..., :3]
    out = torch.empty((300, image_da.nparams(program)), device=dev)
    image_da.image_da_launch(x, u, keys, order, params_out=out,
                             program=program)
    want = image_aug.params_row(image_aug.params_for(program, u, keys, order,
                                                     64, 64))
    torch.cuda.synchronize()
    assert out.shape == (300, 25)
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("pick", [0.25, 0.75])    # Dropout, CoarseDropout
@pytest.mark.parametrize("program", RGB_PROGRAMS)
def test_image_da_rgb_masks_equal_the_twin_bit_for_bit(dev, program, pick):
    """Every op off but the dropout op: the image masked, bit for bit, per
    channel where the draw says so (the random grid's (cell, channel) bits,
    Dropout's (pixel, channel) ids; the fixed grid's one bit a cell), in
    three orders; program 7's geometric at the identity."""
    u, keys, _ = _rgb_draw(dev, program, 300, seed=9, on=False)
    u[:, 16], u[:, 17] = 0.25, pick
    u[:, 10], u[:, 11] = 5.0, 9.0                # rates ~.46 and .45
    x = _rgba(dev, (20, 15, 64, 64), seed=1)[..., :3]
    for o in _rgb_orders(dev, program)[:3]:
        got = image_da.image_da_launch(x, u, keys, o, program=program).cpu()
        want = image_da.image_da_plain(x.cpu(), u.cpu(), keys.cpu(),
                                       None if o is None else o.cpu(),
                                       program=program)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        dropped = (got == 0) & (x.cpu() != 0)
        assert bool(dropped.any()) and bool((got != 0).any())
        if pick == 0.25 or program == "shapenet_3d":
            per_channel = dropped.any(-1) & ~dropped.all(-1)
            assert bool(per_channel.any())


@pytest.mark.parametrize("program", RGB_PROGRAMS)
def test_image_da_rgb_with_every_gate_off_is_the_image(dev, program):
    u, keys, _ = _rgb_draw(dev, program, 30, seed=2, on=False)
    x = _rgba(dev, (2, 15, 64, 64))[..., :3]
    for o in _rgb_orders(dev, program)[:3]:
        got = image_da.image_da_launch(x, u, keys, o, program=program)
        torch.cuda.synchronize()
        assert torch.equal(got, x)


def test_image_da_rgb_programs_take_only_float32_rgba(dev):
    """RGBA of the dtype they write, float32 or bfloat16: float32 images
    into bfloat16 output (or the reverse), uint8 input and a dense RGB
    tensor (pixels 3 elements apart) raise; nothing falls back. (The name
    is from when the programs took float32 only.)"""
    x = _rgba(dev, (4, 32, 32))
    for program in RGB_PROGRAMS:
        u, keys, order = _rgb_draw(dev, program, 4)
        with pytest.raises(TypeError, match="the dtype they write"):
            image_da.image_da(x[..., :3], u, keys, order, BF16, program)
        with pytest.raises(TypeError, match="the dtype they write"):
            image_da.image_da(x.to(BF16)[..., :3], u, keys, order,
                              program=program)
        with pytest.raises(TypeError):
            image_da.image_da(_images(dev, (4, 32, 32, 3)), u, keys, order,
                              program=program)
        with pytest.raises(ValueError, match="image DA kernel takes"):
            image_da.image_da(x[..., :3].contiguous(), u, keys, order,
                              program=program)


def test_rgb_augmenter_is_one_launch_reading_nothing_back(dev):
    aug = image_aug.build_augmenter("shapenet_3d")
    x = _rgba(dev, (20, 15, 64, 64))[..., :3]
    g = torch.Generator(device=dev).manual_seed(0)
    before = image_da.image_da.program_launches["shapenet_3d"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = aug(x, g)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert out.shape == x.shape and out.dtype == torch.float32
    assert image_da.image_da.program_launches["shapenet_3d"] == before + 1


# -- K training steps as one CUDA graph replay (train/steps.py:FusedSteps) --

# -- Distractor's programs 4 and 5: Affine and the dropout op on 1 - x / 255 --

DISTRACTOR_PROGRAMS = ("distractor", "distractor_fixed")


def _distractor_orders(dev, program):
    # 3 reads as order 1, as the twin reads it
    return ([None] if program == "distractor_fixed"
            else [_pascal_order(dev, o) for o in (0, 1, 3)])


@pytest.mark.parametrize("program", DISTRACTOR_PROGRAMS)
@pytest.mark.parametrize("shape", [(20, 15, 128, 128, 1),
                                   (20, 18, 128, 128, 1), (3, 48, 24, 1)])
def test_image_da_distractor_programs_match_their_twins(dev, program, shape):
    """D1's context and query calls (300 and 360 images) and a small shape,
    every gate on, in both orders: within the warps' tolerance of the card
    twin and of the CPU twin."""
    b = shape[0] * shape[1] if len(shape) == 5 else shape[0]
    u, keys, _ = _program_draw(dev, program, b, seed=len(shape) + b)
    x = _images(dev, shape)
    for o in _distractor_orders(dev, program):
        got = image_da.image_da_launch(x, u, keys, o, program=program)
        _close(got, image_da.image_da_plain(x, u, keys, o, program=program),
               *WARP_TOL)
        _close(got.cpu(), image_da.image_da_plain(
            x.cpu(), u.cpu(), keys.cpu(), None if o is None else o.cpu(),
            program=program), *WARP_TOL)


@pytest.mark.parametrize("program", DISTRACTOR_PROGRAMS)
def test_image_da_distractor_parameters_equal_the_twins_bit_for_bit(
        dev, program):
    u, keys, order = _program_draw(dev, program, 300, seed=3)
    g = torch.Generator(device=dev).manual_seed(4)
    u = torch.where(torch.rand(u.shape, generator=g, device=dev) < 0.5, u,
                    torch.rand(u.shape, generator=g, device=dev))
    x = _images(dev, (300, 128, 128, 1))
    out = torch.empty((300, image_da.nparams(program)), device=dev)
    image_da.image_da_launch(x, u, keys, order, params_out=out,
                             program=program)
    want = image_aug.params_row(image_aug.params_for(program, u, keys, order,
                                                     128, 128))
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("pick", [0.25, 0.75])    # Dropout, CoarseDropout
@pytest.mark.parametrize("program", DISTRACTOR_PROGRAMS)
def test_image_da_distractor_masks_equal_the_twin_bit_for_bit(dev, program,
                                                              pick):
    """Affine off, the dropout op on: the output is 1 - x / 255 masked, bit
    for bit (the fixed grid's cells, the random-size grid's, or Dropout's
    pixels), in both orders."""
    u, keys, _ = _program_draw(dev, program, 300, seed=9, on=False)
    u[:, 16], u[:, 17] = 0.25, pick
    u[:, 10], u[:, 11] = 5.0, 9.0                # rates ~.46 and .45
    x = _images(dev, (20, 15, 128, 128, 1))
    for o in _distractor_orders(dev, program):
        got = image_da.image_da_launch(x, u, keys, o, program=program).cpu()
        want = image_da.image_da_plain(x.cpu(), u.cpu(), keys.cpu(),
                                       None if o is None else o.cpu(),
                                       program=program)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert bool((got == 0).any()) and bool((got != 0).any())


@pytest.mark.parametrize("program", DISTRACTOR_PROGRAMS)
def test_image_da_distractor_with_every_gate_off_is_the_inverted_image(
        dev, program):
    """1 - x / 255 bit for bit: the correctly rounded quotient, then the
    subtraction (the card's x / 255.0 misses 126 of the 256 quotients)."""
    u, keys, _ = _program_draw(dev, program, 30, seed=2, on=False)
    x = _images(dev, (2, 15, 128, 128, 1))
    for o in _distractor_orders(dev, program):
        got = image_da.image_da_launch(x, u, keys, o, program=program)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), 1.0 - image_aug.to_unit(x.cpu()))


def test_image_da_distractor_programs_are_float32_only(dev):
    """They write float32 or bfloat16 (compute_dtype: bfloat16) and raise
    on any other output type. (The name is from when they wrote float32
    only.)"""
    x = _images(dev, (4, 32, 32, 1))
    for program in DISTRACTOR_PROGRAMS:
        u, keys, order = _program_draw(dev, program, 4)
        with pytest.raises(TypeError, match="writes one of"):
            image_da.image_da(x, u, keys, order, torch.float16, program)
        assert image_da.image_da(x, u, keys, order, BF16,
                                 program).dtype == BF16


def test_distractor_augmenter_is_one_launch_reading_nothing_back(dev):
    """The Distractor augmenter draws on the card and issues one launch of
    its program, under set_sync_debug_mode("error")."""
    aug = image_aug.build_augmenter("distractor")
    x = _images(dev, (20, 15, 128, 128, 1))
    g = torch.Generator(device=dev).manual_seed(0)
    before = image_da.image_da.program_launches["distractor"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = aug(x, g)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert out.shape == x.shape and out.dtype == torch.float32
    assert image_da.image_da.program_launches["distractor"] == before + 1


# -- programs 4-7 in bfloat16 (compute_dtype: bfloat16) -----------------------

LARGE_PROGRAMS = DISTRACTOR_PROGRAMS + RGB_PROGRAMS
# bfloat16 ulps from the twin, each element: Distractor's programs round once
# (Affine); ShapeNet3D's six rounding ops carry a flipped value on and can
# widen it (gamma's exponent up to 2, the blur's sums rounded at every add),
# on a few elements only
LARGE_BF16_ULPS = {"distractor": 1.0, "distractor_fixed": 1.0,
                   "shapenet_3d": 4.0, "shapenet_3d_fixed": 4.0}
RGB_BF16_SHARE = 1e-4


def _large_call(dev, program, b=300, seed=0, on=True):
    """A DA call of ``program`` at its path's shape: D5's 300 uint8 images
    of 128 x 128, or S5's and S6's RGB of 300 bfloat16 RGBA images of 64 x
    64, read through their strides; its draw and the orders to run
    (program 4: both and 3, read as 1; program 6: ten of the 720)."""
    if program in RGB_PROGRAMS:
        x = _rgba(dev, (20, b // 20, 64, 64), seed=seed).to(BF16)[..., :3]
        u, keys, _ = _rgb_draw(dev, program, b, seed=seed, on=on)
        orders = _rgb_orders(dev, program)
    else:
        x = _images(dev, (20, b // 20, 128, 128, 1), seed=seed + 1)
        u, keys, _ = _program_draw(dev, program, b, seed=seed, on=on)
        orders = _distractor_orders(dev, program)
    return x, u, keys, orders


@pytest.mark.parametrize("program", LARGE_PROGRAMS)
def test_image_da_large_programs_bf16_match_their_twins(dev, program):
    """Every gate on, in each order: parameters bit for bit; bfloat16 out
    against the bfloat16 twin on the card and on the CPU, within the module
    docstring's bfloat16 rule and within ``LARGE_BF16_ULPS`` of each
    element (programs 6 and 7 differing on at most ``RGB_BF16_SHARE`` of
    them). Each op rounds at the points the twin rounds, after float32 sums
    in another order (and the card's powf), so a value near a rounding
    boundary can round the other way."""
    x, u, keys, orders = _large_call(dev, program, seed=4)
    share = RGB_BF16_SHARE if program in RGB_PROGRAMS else 1.0
    for o in orders:
        params = torch.empty((x.shape[0] * x.shape[1],
                              image_da.nparams(program)), device=dev)
        got = image_da.image_da_launch(x, u, keys, o, BF16, params_out=params,
                                       program=program)
        assert got.dtype == BF16 and got.shape == x.shape
        want_p = image_aug.params_row(image_aug.params_for(
            program, u, keys, o, x.shape[-3], x.shape[-2]))
        torch.cuda.synchronize()
        assert torch.equal(params.view(torch.int32), want_p.view(torch.int32))
        cpu = [a.cpu() for a in (x, u, keys)] + [
            None if o is None else o.cpu()]
        for g, args in ((got, (x, u, keys, o)), (got.cpu(), cpu)):
            want = image_da.image_da_plain(*args, BF16, program)
            assert float(_ulps(g, want).max()) <= LARGE_BF16_ULPS[program]
            assert float((g != want).double().mean()) <= share
            _bf16_close(g, want, image_da.image_da_plain(
                *args, torch.float32, program), element_ulps=False)


@pytest.mark.parametrize("pick", [0.25, 0.75])    # Dropout, CoarseDropout
@pytest.mark.parametrize("program", LARGE_PROGRAMS)
def test_image_da_large_programs_bf16_masks_equal_the_twin_bit_for_bit(
        dev, program, pick):
    """Every op off but the dropout op: in bfloat16 the output is the
    twice-rounded 1 - x / 255 (Distractor) or the bfloat16 image
    (ShapeNet3D) masked, bit for bit, in each order."""
    x, u, keys, orders = _large_call(dev, program, seed=9, on=False)
    u[:, 16], u[:, 17] = 0.25, pick
    u[:, 10], u[:, 11] = 5.0, 9.0                # rates ~.46 and .45
    for o in orders[:3]:
        got = image_da.image_da_launch(x, u, keys, o, BF16,
                                       program=program).cpu()
        want = image_da.image_da_plain(x.cpu(), u.cpu(), keys.cpu(),
                                       None if o is None else o.cpu(), BF16,
                                       program)
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
        assert bool((got == 0).any()) and bool((got != 0).any())
    if program in DISTRACTOR_PROGRAMS:          # every gate off: the table
        u[:, 16] = 0.75
        got = image_da.image_da_launch(x, u, keys, orders[0], BF16,
                                       program=program).cpu()
        assert torch.equal(got, image_aug.program_input(program, x.cpu(),
                                                        BF16))


@pytest.mark.parametrize("task", ["distractor", "shapenet_3d"])
def test_large_bf16_augmenters_are_one_launch_reading_nothing_back(dev, task):
    aug = image_aug.build_augmenter(task, BF16)
    x, _, _, _ = _large_call(dev, aug.program)
    g = torch.Generator(device=dev).manual_seed(0)
    before = (image_da.image_da.bf16_launches,
              image_da.image_da.program_launches[task])
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = aug(x, g)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert out.shape == x.shape and out.dtype == BF16
    assert (image_da.image_da.bf16_launches,
            image_da.image_da.program_launches[task]) == (before[0] + 1,
                                                          before[1] + 1)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ANP_YAML = os.path.join(REPO, "cfg", "train", "ANP_DA+TA_ShapeNet1D.yaml")
PERF_MAML_YAML = os.path.join(REPO, "cfg", "train", "perf",
                              "MAML_DA_ShapeNet1D_tpu.yaml")
PERF_ANP_YAML = os.path.join(REPO, "cfg", "train", "perf",
                             "ANP_DA+TA_ShapeNet1D_tpu.yaml")
PASCAL_ANP_YAML = os.path.join(REPO, "cfg", "train", "ANP_DA+TA_Pascal1D.yaml")
DISTRACTOR_ANP_YAML = os.path.join(REPO, "cfg", "train",
                                   "ANP_DA+TA_Distractor.yaml")
S3D_ANP_YAML = os.path.join(REPO, "cfg", "train", "ANP_DA+TA_ShapeNet3D.yaml")
S3D_PERF_YAML = os.path.join(REPO, "cfg", "train", "perf",
                             "CondNeuralProcess_DA+TA_ShapeNet3D_tpu.yaml")
# a kernel wrapper -> the kernel function whose graph nodes count its
# launches (K3's call also packs its weights and runs one conv_kernel a layer)
MR_ANP_YAML = os.path.join(REPO, "cfg", "train", "ANPMR_DA+TA_ShapeNet1D.yaml")
MAMLMR_YAML = os.path.join(REPO, "cfg", "train", "MAMLMR_DA+TA_ShapeNet1D.yaml")
FCLANP_YAML = os.path.join(REPO, "cfg", "train", "contrastive",
                           "FCLANP_DA+TA_ShapeNet3D.yaml")
GRAPH_NODE = {"literature_stem": "stem_fwd_kernel",
              "favor_attention": "favor_kernel",
              "maml_features": "bn_relu_kernel",
              "image_da": "image_da_kernel"}


def _dot_kernels(dot_path):
    """The captured graph's kernel nodes, each node's text from
    ``debug_dump``'s DOT (a node's record label spans several lines)."""
    with open(dot_path) as f:
        text = f.read()
    nodes = re.split(r'^[ \t]*(?="graph_\d+_node_\d+"\[)', text, flags=re.M)
    return [n for n in nodes[1:] if 'label="{KERNEL' in n]


def _kernel_nodes(dot_path):
    """How many of the captured graph's kernel nodes run each of
    ``GRAPH_NODE``'s kernels."""
    nodes = _dot_kernels(dot_path)
    return {k: sum(name in n for n in nodes) for k, name in GRAPH_NODE.items()}


@pytest.fixture(scope="module")
def graph_data(tmp_path_factory):
    """A small synthetic ShapeNet1D split with room for T = 10, 15 + 15."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    root = str(tmp_path_factory.mktemp("sn1d"))
    generate_shapenet1d(root, seed=0, instances=31, val_classes=2,
                        test_classes=2)
    return root


@pytest.fixture(scope="module")
def pascal_data(tmp_path_factory):
    """A small synthetic Pascal1D split with room for 15 + 15."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    root = str(tmp_path_factory.mktemp("pascal"))
    generate_pascal1d(root, seed=5, train_classes=3, val_classes=2,
                      instances=31)
    return root


@pytest.fixture(scope="module")
def distractor_data(tmp_path_factory):
    """A small synthetic Distractor set: one object a category (8 train
    objects), 36 views each, room for 15 + 18."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    root = str(tmp_path_factory.mktemp("distractor"))
    generate_distractor(root, objects_per_categ=1)
    return root


@pytest.fixture(scope="module")
def s3d_data(tmp_path_factory):
    """The small synthetic ShapeNet3D split (30 / 8 / 8 items of 30
    views)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    root = str(tmp_path_factory.mktemp("shapenet3d"))
    generate_shapenet3d(root, small=True)
    return root


def _graph_config(data, yaml, *overrides):
    return Config(yaml, [f"data_path={data}", "data_size=small",
                         "device=cuda", "val_freq=1000", "val_iters=1",
                         *overrides])


def _train_state(trainer):
    opt = trainer.optimizer.state_dict()["state"]
    return ([p.detach().clone() for p in trainer.model.parameters()],
            [v.clone() for s in opt.values() for v in s.values()],
            trainer.generator.get_state())


def _assert_equal_states(a, b):
    for x, y in zip(a[0] + a[1], b[0] + b[1]):
        assert torch.equal(x, y)
    assert len(a[0]) == len(b[0]) and len(a[1]) == len(b[1]) and a[1]
    assert torch.equal(a[2], b[2])


@pytest.mark.parametrize("path", ["anp_f32", "anp_bf16", "maml_bf16",
                                  "pascal_anp", "anp_fixed_bf16",
                                  "distractor_anp", "s3d_anp",
                                  "s3d_cnp_bf16", "distractor_anp_bf16",
                                  "mr_anp", "mamlmr", "fcl_anp"])
def test_graph_replays_equal_the_eager_loop_bit_for_bit(dev, graph_data,
                                                        pascal_data,
                                                        distractor_data,
                                                        s3d_data,
                                                        tmp_path, monkeypatch,
                                                        path):
    """Three calls at K = 4 (one eager warm-up, the capture and its replay,
    one more replay) against the same twelve steps issued from the host,
    under deterministic algorithms: weights, Adam state, generator state
    and each call's metrics, bit for bit.

    A third trainer takes one call first and is dropped: the process's
    first call of cuDNN's bfloat16 grouped convolution [15, 640, 14, 14] x
    [640, 64, 3, 3] (K3's twin, recomputed in its backward) loads its
    kernels lazily and runs another engine than every later call, so the
    first bfloat16 MAML step of a process differs from later ones in the
    last bits, graph or loop alike."""
    monkeypatch.chdir(tmp_path)
    yaml, extra = {"anp_f32": (ANP_YAML, ["steps_per_call=4"]),
                   "anp_bf16": (ANP_YAML, ["steps_per_call=4",
                                           "compute_dtype=bfloat16"]),
                   "maml_bf16": (PERF_MAML_YAML, []),
                   # P1 as shipped (Pascal1D's five-op chain) and P3 (the
                   # perf YAML: bf16, fixed order) at K = 4
                   "pascal_anp": (PASCAL_ANP_YAML, ["steps_per_call=4"]),
                   "anp_fixed_bf16": (PERF_ANP_YAML,
                                      ["steps_per_call=4"]),
                   # D1 as shipped (ANPDistractor, K2 wide, program 4)
                   "distractor_anp": (DISTRACTOR_ANP_YAML,
                                      ["steps_per_call=4"]),
                   # S1 as shipped (ANP ShapeNet3D: backgrounds composited
                   # per batch, program 6, pose noise, K2 wide)
                   "s3d_anp": (S3D_ANP_YAML, ["steps_per_call=4"]),
                   # S5 (the ShapeNet3D perf YAML: bf16, compositing on
                   # bf16 backgrounds) and D5 (D1 in bf16: K2 wide bf16)
                   "s3d_cnp_bf16": (S3D_PERF_YAML, ["steps_per_call=4"]),
                   "distractor_anp_bf16": (DISTRACTOR_ANP_YAML,
                                           ["steps_per_call=4",
                                            "compute_dtype=bfloat16"]),
                   # M1 (ANPMRShapeNet1D: BBB encoder samples drawn inside
                   # the graph), M2 (MAMLMRShapeNet1D, second order, per
                   # task and step), F2 (FCLANP: NT-Xent at t = 0.007)
                   "mr_anp": (MR_ANP_YAML, ["steps_per_call=4"]),
                   "mamlmr": (MAMLMR_YAML, ["steps_per_call=4"]),
                   "fcl_anp": (FCLANP_YAML, ["steps_per_call=4"])}[path]
    data = {"pascal_anp": pascal_data, "distractor_anp": distractor_data,
            "distractor_anp_bf16": distractor_data, "s3d_anp": s3d_data,
            "s3d_cnp_bf16": s3d_data, "fcl_anp": s3d_data}.get(path,
                                                               graph_data)
    torch.use_deterministic_algorithms(True)
    try:
        first, graph, loop = (train_cli.build_trainer(
            _graph_config(data, yaml, *extra)) for _ in range(3))
        first.train_step.loop(first.generator)
        assert graph.train_step.k == 4
        for _ in range(3):
            got = {k: v.clone() if torch.is_tensor(v) else v
                   for k, v in graph.train_step(graph.generator).items()}
            want = loop.train_step.loop(loop.generator)
            torch.cuda.synchronize()
            assert got.keys() == want.keys()
            for k in want:
                assert torch.equal(torch.as_tensor(got[k]),
                                   torch.as_tensor(want[k])), k
        assert graph.train_step.replays == 2 and loop.train_step.graph is None
        _assert_equal_states(_train_state(graph), _train_state(loop))
    finally:
        torch.use_deterministic_algorithms(False)


def test_resumed_run_after_replays_draws_what_an_unbroken_run_draws(
        dev, graph_data, tmp_path, monkeypatch):
    """8 steps at K = 2 (two eager calls, a capture, a replay), then a run
    resumed from their checkpoint to 12, against one unbroken run of 12,
    with image and task augmentation, under deterministic algorithms: the
    checkpoint holds the generator's state after replays and the
    capturable Adam's state, bit for bit."""
    monkeypatch.chdir(tmp_path)
    k = ["steps_per_call=2"]
    torch.use_deterministic_algorithms(True)
    try:
        first = train_cli.train(_graph_config(graph_data, ANP_YAML, *k,
                                              "iterations=8"))
        assert first.train_step.replays == 2
        resumed = train_cli.train(_graph_config(
            graph_data, ANP_YAML, *k, "iterations=12",
            f"checkpoint={first.ckpt.path('model_end_8')}"))
        whole = train_cli.train(_graph_config(graph_data, ANP_YAML, *k,
                                              "iterations=12"))
    finally:
        torch.use_deterministic_algorithms(False)
    assert resumed.step == whole.step == 12 and whole.train_step.replays == 4
    _assert_equal_states(_train_state(resumed), _train_state(whole))


def test_train_cli_sets_tf32_off_itself(dev, graph_data, tmp_path,
                                       monkeypatch):
    """``train_cli.build_trainer`` sets the TF32 flags off (and cuDNN's
    default algorithms), whatever they were: the card's float32 runs
    compute in float32 (ROADMAP.md C1)."""
    monkeypatch.chdir(tmp_path)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.deterministic = True
    try:
        train_cli.build_trainer(_graph_config(graph_data, ANP_YAML))
        assert torch.backends.cudnn.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.deterministic is False
    finally:
        set_numerics()


def test_same_seed_trainers_give_what_the_setting_says(dev, graph_data,
                                                       tmp_path, monkeypatch):
    """Two ANPShapeNet1D trainers from one seed through ``train_cli``, with
    no deterministic switch of their own, each one eager call and one graph
    call of 4 steps (ROADMAP.md C2): cuDNN's default backward may sum in
    another order from run to run, so they must agree within float32's
    reach after 8 Adam steps (rtol 1e-3, atol 1e-6: an update moves a
    weight by at most lr = 1e-4, and rounding by a few ulps of that), and
    their generators bit for bit."""
    monkeypatch.chdir(tmp_path)
    runs = []
    for _ in range(2):
        trainer = train_cli.build_trainer(_graph_config(
            graph_data, ANP_YAML, "steps_per_call=4"))
        losses = [trainer.train_step(trainer.generator)["loss"].clone()
                  for _ in range(2)]
        assert trainer.train_step.replays == 1
        runs.append((losses, _train_state(trainer)))
    (la, sa), (lb, sb) = runs
    for a, b in zip(la + sa[0] + sa[1], lb + sb[0] + sb[1]):
        _close(a, b, 1e-6, 1e-3)
    assert torch.equal(sa[2], sb[2])


def test_favor_kernel_is_captured_and_replayed(dev, tmp_path):
    """K2's cooperative launch inside a CUDA graph: one cooperative kernel
    node, and each replay on new inputs (copied into the captured
    attention-block views) equals an eager launch bit for bit."""
    q, k, v, proj, mask = _block_views(dev)
    favor.favor_launch(q, k, v, proj, mask)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    graph.enable_debug_mode()
    with torch.cuda.graph(graph):
        out = favor.favor_launch(q, k, v, proj, mask)
    graph.instantiate()
    dot = str(tmp_path / "favor.dot")
    graph.debug_dump(dot)
    nodes = _dot_kernels(dot)
    assert len(nodes) == 1 and "favor_kernel" in nodes[0]
    assert "{cooperative | 1}" in nodes[0]
    for seed in (1, 2):
        for dst, src in zip((q, k, v), _block_views(dev, seed=seed)[:3]):
            dst.copy_(src)
        graph.replay()
        want = favor.favor_launch(q, k, v, proj, mask)
        torch.cuda.synchronize()
        assert torch.equal(out, want)


@pytest.mark.parametrize("path", ["anp", "maml"])
def test_captured_launches_match_the_graphs_kernel_nodes(dev, graph_data,
                                                         tmp_path,
                                                         monkeypatch, path):
    """The fused step's ``captured_launches`` (its wrappers' counters over
    the capture) equal the kernel nodes of each kernel in the captured
    graph, and the counters read warm-up + capture."""
    monkeypatch.chdir(tmp_path)
    yaml, extra = {"anp": (ANP_YAML, ["steps_per_call=2", "iterations=6"]),
                   "maml": (PERF_MAML_YAML, ["iterations=8"])}[path]
    trainer = train_cli.build_trainer(_graph_config(graph_data, yaml, *extra))
    fused = trainer.train_step
    fused.dot_path = str(tmp_path / "step.dot")
    before = {name: fn.launches for name, fn in KERNELS.items()}
    trainer.train()
    nodes = _kernel_nodes(fused.dot_path)
    assert fused.replays == 1 and nodes == fused.captured_launches
    per_step = {"anp": {"literature_stem": 1, "favor_attention": 1,
                        "maml_features": 0, "image_da": 2},
                "maml": {"literature_stem": 6, "favor_attention": 0,
                         "maml_features": 6, "image_da": 2}}[path]
    assert fused.captured_launches == {k: n * fused.k
                                       for k, n in per_step.items()}
    warm = fused.warm_calls * fused.k
    for name, fn in KERNELS.items():
        if name == "image_da":      # validation runs no image DA
            assert fn.launches - before[name] == (warm + fused.k) * 2
        else:
            assert fn.launches - before[name] >= (warm + fused.k) * per_step[
                name]


def test_optimizer_is_capturable_on_cuda_parameters(dev):
    for name, want in (("Adam", torch.optim.Adam),
                       ("AdamW", torch.optim.AdamW)):
        p = torch.nn.Parameter(torch.randn(8, device=dev))
        opt = build_optimizer(types.SimpleNamespace(
            optimizer=name, lr=1e-3, weight_decay=False), [p])
        assert type(opt) is want and opt.param_groups[0]["capturable"]
        p.grad = torch.ones_like(p)
        opt.step()
        assert opt.state[p]["step"].device.type == "cuda"


def test_capturable_adam_matches_optax_within_float32_tolerance(dev):
    """The card's Adam (capturable: bias corrections on the device, in
    float32) against optax's update (``torch_port_adam.optax_adam``) over
    10 steps of gradients spanning five decades: rtol = atol = 1e-5."""
    rng = np.random.RandomState(0)
    p0 = rng.randn(256).astype(np.float32)
    grads = [(rng.randn(256) * 10.0 ** rng.uniform(-4, 1, 256)).astype(
        np.float32) for _ in range(10)]
    p = torch.nn.Parameter(torch.from_numpy(p0).to(dev))
    opt = build_optimizer(types.SimpleNamespace(
        optimizer="Adam", lr=1e-3, weight_decay=False), [p])
    for g, want in zip(grads, optax_adam(p0, grads, 1e-3)):
        p.grad = torch.from_numpy(g).to(dev)
        opt.step()
        np.testing.assert_allclose(p.detach().cpu().numpy(), want,
                                   rtol=1e-5, atol=1e-5)


# -- MR (Bayes-by-Backprop) and FCL ---------------------------------------------

@pytest.mark.parametrize("per_task", [False, True])
def test_stem_on_bbb_samples_matches_plain(dev, per_task):
    """K1 on weights sampled as mu + eps softplus(rho) (ANPMR: one sample
    for 300 images; MAMLMR: one per task, 10 x 15 images) against
    ``stem_plain`` on the same samples; the gradients on the stem's
    posteriors through ``create_graph``, and a second derivative through
    K1's backward (its twin recomputed under ``create_graph``)."""
    from wmfml_tpu_torch.nn.bbb import BBBLiteratureEncoder, EpsFeed
    from wmfml_tpu_torch.nn.init import init_parameters

    enc = BBBLiteratureEncoder(196, (128, 128, 1))
    init_parameters(enc, torch.Generator().manual_seed(0))
    enc = enc.to(dev)
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.rand((150 if per_task else 300, 128, 128, 1), generator=g,
                   device=dev)
    lead = (10,) if per_task else ()
    layers = (enc.net.layer1.conv, enc.net.layer2.conv)
    rec = EpsFeed(generator=g)

    def run(fn, noise):
        (w0, b0, _), (w1, b1, _) = (layer.sample(noise, lead)
                                    for layer in layers)
        return fn(x, w0, b0, w1, b1)

    before = stem.literature_stem.launches
    got = run(stem.literature_stem, rec)
    want = run(stem.stem_plain, EpsFeed(rec.draws))
    assert stem.literature_stem.launches == before + 1
    _close(got, want, 1e-4, 1e-4)
    params = [p for layer in layers for p in (layer.W_mu, layer.W_rho,
                                              layer.bias_mu, layer.bias_rho)]
    grads = [torch.autograd.grad(y.square().sum(), params, create_graph=True)
             for y in (got, want)]
    second = [torch.autograd.grad(sum(gr.square().sum() for gr in gs),
                                  [layers[0].W_mu, layers[1].W_rho])
              for gs in grads]
    for a, b in zip(grads[0] + second[0], grads[1] + second[1]):
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())


def test_nt_xent_on_the_card_matches_the_cpu(dev):
    """FCLANP's NT-Xent over 300 query reps of width 256 at t = 0.007, one
    task saturated (its reps one direction) and one row zero, and the
    two-view form at t = 0.07: value and gradient, card against CPU."""
    from wmfml_tpu_torch.losses.losses import (contrastive_loss,
                                               contrastive_loss_anp)

    z = torch.randn((20, 15, 256), generator=torch.Generator().manual_seed(0))
    z[3] = 100.0 * z[3, :1]
    z[5, 2] = 0.0
    for fn in (lambda a: contrastive_loss_anp(a, 0.007),
               lambda a: contrastive_loss(a[:, 0], a[:, 1], 0.07)):
        cpu, card = z.clone().requires_grad_(True), z.to(dev).requires_grad_(True)
        losses = [fn(a) for a in (cpu, card)]
        for loss in losses:
            loss.backward()
        got, want = card.grad.cpu(), cpu.grad
        assert bool(torch.isfinite(losses[1])) and bool(torch.isfinite(got).all())
        assert abs(float(losses[1]) - float(losses[0])) <= 1e-5 * (
            abs(float(losses[0])) + 1.0)
        assert float((got - want).abs().max()) <= 1e-5 * float(
            want.abs().max()) + 1e-7


def _tap(layer):
    """Keep the last weight sample ``layer`` drew (a captured graph's static
    tensor once the capture ran)."""
    seen, sample = {}, layer.sample

    def tapped(noise, lead=()):
        out = sample(noise, lead)
        seen["w"] = out[0]
        return out

    layer.sample = tapped
    return seen


@pytest.mark.parametrize("path", ["mr_anp", "mamlmr"])
def test_captured_mr_replays_draw_new_weights(dev, graph_data, tmp_path,
                                              monkeypatch, path):
    """The trainer's generator is registered with the graph, so each replay
    of a captured MR step draws new BBB weights: the stem's sample after
    two replays differs (the graph = loop check above holds them to what
    the loop draws)."""
    monkeypatch.chdir(tmp_path)
    yaml = {"mr_anp": MR_ANP_YAML, "mamlmr": MAMLMR_YAML}[path]
    trainer = train_cli.build_trainer(_graph_config(graph_data, yaml,
                                                    "steps_per_call=4"))
    model = trainer.model
    enc = model.encoder_w if path == "mamlmr" else model.encoder_w0
    seen = _tap(enc.net.layer1.conv)
    fused = trainer.train_step
    for _ in range(fused.warm_calls):
        fused(trainer.generator)
    samples = []
    for _ in range(2):
        fused(trainer.generator)
        torch.cuda.synchronize()
        samples.append(seen["w"].clone())
    assert fused.replays == 2 and fused.graph is not None
    assert samples[0].shape == ((10, 32, 1, 3, 3) if path == "mamlmr"
                                else (32, 1, 3, 3))
    assert bool(torch.isfinite(samples[0]).all())
    assert not torch.equal(*samples)
