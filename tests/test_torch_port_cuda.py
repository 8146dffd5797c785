"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked ``cuda``; each test skips where no CUDA device is present, as in a
CPU-only run. On a machine with a card:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q -m cuda

Tolerance: elementwise |kernel - plain| <= atol + rtol * |plain|, the same
as ``chip_smoke.py``: both sides are float32 sums in another order. Second
derivatives compare per tensor, max |difference| <= 1e-3 max |plain|. K5
(hash dropout) is integer arithmetic and must equal its twin bit for bit.
"""

import pytest
import torch

from wmfml_tpu_torch.aug import image_aug
from wmfml_tpu_torch.kernels import favor, features, hash_mask, stem, warp

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


# -- K4 (warp chain) and K5 (hash dropout) --------------------------------------

WARP_TOL = (1e-5, 1e-5)


def _da_params(dev, b, h, w, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return image_aug.ShapeNet1DAugmenter(seed).sample((b, h, w, 1), g, dev)


@pytest.mark.parametrize("ops", [(0, 1), (1, 0), (0,), (1,)])
@pytest.mark.parametrize("b,h,w,c", [(150, 128, 128, 1), (3, 40, 24, 2)])
def test_warp_kernel_matches_plain(dev, ops, b, h, w, c):
    p = _da_params(dev, b, h, w, seed=b + len(ops))
    x = torch.rand((b, h, w, c), device=dev,
                   generator=torch.Generator(device=dev).manual_seed(1))
    _close(warp.warp_launch(x, p.warp, ops), warp.warp_plain(x, p.warp, ops),
           *WARP_TOL)


def test_warp_kernel_snaps_nearest_like_the_twin_on_half_boundaries(dev):
    """Scales and shifts that put sample positions on .5, where one ulp of
    the position flips a nearest tap to the next pixel (an O(1) error)."""
    scales = [2.0, 1.25, 0.8, 1.0, 0.5, 1.2, 0.85, 1.1]
    shifts = [0.5, -0.5, 0.25, 0.1, -1.5, 0.3, 2.5, -0.7]
    rows = [[s, s, t, t, 0.3, 1.0, 1.0] for s in scales for t in shifts]
    b = len(rows)
    params = torch.tensor(rows, device=dev)[:, None].repeat(1, 2, 1)
    x = torch.rand((b, 128, 128, 1), device=dev,
                   generator=torch.Generator(device=dev).manual_seed(2))
    for ops in ((1,), (0, 1)):
        _close(warp.warp_launch(x, params, ops),
               warp.warp_plain(x, params, ops), *WARP_TOL)


def test_warp_kernel_gate_off_is_the_identity(dev):
    p = _da_params(dev, 8, 32, 32)
    p.warp[..., 6] = 0.0
    x = torch.rand((8, 32, 32, 1), device=dev)
    assert torch.equal(warp.warp_launch(x, p.warp, (0, 1)), x)


@pytest.mark.parametrize("pick", [1.0, 0.0])
@pytest.mark.parametrize("b,h,w,c", [(150, 128, 128, 1), (5, 40, 24, 3)])
def test_hash_dropout_kernel_equals_plain_bit_for_bit(dev, pick, b, h, w, c):
    p = _da_params(dev, b, h, w, seed=c)
    p.drop[:, 1] = pick
    p.drop[::2, 0] = 1.0                       # at least half the gates on
    p.drop[:, 2] *= 5                          # rates up to .5: masks show
    x = torch.rand((b, h, w, c), device=dev) - 0.25   # signs, -0.0 kept
    got = hash_mask.hash_dropout_launch(x, p.drop, p.keys)
    want = hash_mask.hash_dropout_plain(x, p.drop, p.keys)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert bool((got == 0).any()) and bool((got == x).any())


def test_da_kernels_are_bit_reproducible(dev):
    p = _da_params(dev, 20, 128, 128)
    x = torch.rand((20, 128, 128, 1), device=dev)
    for fn in (lambda: warp.warp_launch(x, p.warp, (1, 0)),
               lambda: hash_mask.hash_dropout_launch(x, p.drop, p.keys)):
        first, second = fn(), fn()
        torch.cuda.synchronize()
        assert torch.equal(first, second)


@pytest.mark.parametrize("order", range(6))
def test_augmenter_on_the_card_counts_its_launches(dev, order):
    aug = image_aug.ShapeNet1DAugmenter()
    p = _da_params(dev, 30, 128, 128, seed=order)
    p.order = order
    x = torch.rand((2, 15, 128, 128, 1), device=dev)
    before = (warp.warp_chain_op.launches, hash_mask.hash_dropout.launches)
    got = aug(x, params=p)
    want = image_aug.ShapeNet1DAugmenter()(x.cpu(), params=image_aug.DAParams(
        order, p.warp.cpu(), p.drop.cpu(), p.keys.cpu()))
    _close(got.cpu(), want, *WARP_TOL)
    n = image_aug.launches_of(order)
    assert (warp.warp_chain_op.launches - before[0],
            hash_mask.hash_dropout.launches - before[1]) == (
                n["warp_chain"], n["hash_dropout"])
