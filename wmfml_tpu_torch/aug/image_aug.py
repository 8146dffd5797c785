"""Image data augmentation for ShapeNet1D, Pascal1D, Distractor and
ShapeNet3D (``wmfml_tpu/aug/image_aug.py``).

The reference pipelines, each op under its ``Sometimes(0.5)`` gate:

  * ``SHAPENET1D_OPS``: CropAndPad, Affine and OneOf(Dropout,
    CoarseDropout) in an op order drawn per augmenter call out of the 3! =
    6 orders (``iaa.Sequential(random_order=True)``); adjacent CropAndPad
    and Affine compose into one warp chain, as the JAX package's
    ``perm_chain`` does;
  * ``PASCAL_OPS``: CropAndPad, GammaContrast, AverageBlur, Affine and the
    dropout op in one of the 5! = 120 orders; with five ops the JAX
    package runs its per-step switch chain (:567-577), each op applied
    alone to the whole batch and returning the image's dtype, no warps
    composed;
  * ``FUSED_PIPELINES`` (``aug_random_order: false``): ``geometric`` (one
    warp with CropAndPad's and Affine's parameters composed), then for
    Pascal1D GammaContrast and AverageBlur, then OneOf(Dropout, the fixed
    16-pixel grid CoarseDropout), in that order;
  * ``DISTRACTOR_OPS``: Affine and the dropout op in one of the 2! orders;
    with one warp op the JAX package's enumerated path runs Affine alone
    (``_affine_warp``), as Pascal1D's chain does; its fixed order
    (``aug_random_order: false``) is Affine, then the fixed-grid dropout
    op. Distractor's images are inverted first (``1 - x / 255``), so its
    programs take the inversion as part of the uint8 -> float step
    (``program_input``);
  * ``SHAPENET3D_OPS`` (``FULL_OPS``): CropAndPad, GammaContrast,
    AddToBrightness, AverageBlur, Affine and the dropout op on float RGB
    in one of the 6! = 720 orders, each op alone as in Pascal1D's chain
    (the JAX package's per-step switch chain, its ops more than
    ``_ENUM_MAX``); its fixed order is ``geometric``, GammaContrast,
    AddToBrightness, AverageBlur, then the fixed-grid dropout op. The
    images are the sampler's float RGBA without its alpha, so the
    uint8 -> float step is a cast.

Two layers:

  * the plain twins, the JAX math op for op on a batch with per-image
    parameters: ``interp_matrix``, ``stage_matrices``, ``affine_warp`` and
    ``warp_chain`` (dense tent matrices and the rank-1 fill terms),
    ``gamma_contrast``, ``brightness`` and ``average_blur``, ``fmix32`` /
    ``hash_keep``
    (murmur3 keep bits, uint32 arithmetic held in int64), the Dropout,
    CoarseDropout and fixed-grid ids and their keep masks;
    ``params_for`` and ``apply_program`` chain them into K6's plain version
    (``kernels/image_da.py:image_da_plain``), one op program each
    (``kernels/image_da.py:PROGRAMS``);
  * the augmenter (``Augmenter``, one per program): one call draws its
    raw draw on the images' device (``sample``: uniforms, key words and
    the op order) and issues one K6 launch (``kernels/image_da.py``),
    which computes the parameters and runs the program on the card.

Parameters of one augmenter call (``DAParams``), per image b:

  * ``warp[b, op]`` for op 0 (CropAndPad) and 1 (Affine):
    ``(sx, sy, tx, ty, cval, nearest, gate)``, booleans as 0/1; in the
    fixed programs row 0 is ``geometric``'s one warp and row 1 is unused;
  * ``drop[b]``: ``(gate, pick, p, sp, per_channel)``; ``pick`` selects
    Dropout (1) or CoarseDropout (0), ``p`` the drop rate, ``sp`` the
    coarse grid's size fraction (unused by the fixed grid);
  * ``keys[b]``: the hash's two 32-bit key words (int32 bit patterns);
  * ``pixel[b]`` (Pascal1D): ``(gamma gate, gamma, blur gate, k)``, and
    for ShapeNet3D ``(..., brightness gate, brightness offset)``;
  * ``order``: an index into the program's orders (``ORDERS``,
    ``PASCAL_ORDERS``, ``DISTRACTOR_ORDERS``, ``SHAPENET3D_ORDERS``),
    shared by the whole call (an int, or a one-element tensor as drawn),
    read modulo their count; None for the fixed programs;
  * ``cells`` (tests only, on the CPU): the fixed grid's keep bits [B, gh,
    gw], in place of the hashed ones.

The draws come from the caller's generator on the images' device (Philox on
the card: the JAX package's threefry bits are not reproduced, their
distribution is), the order too, so the host reads none of them. Under a
data-parallel mesh (``parallel/mesh.py``) a call draws for the whole
batch's images and keeps its own tasks' rows. Tests inject JAX's own draws
as ``DAParams``, on the CPU.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Union

import torch

from wmfml_tpu_torch.kernels import image_da as kda
from wmfml_tpu_torch.kernels.image_da import image_da
from wmfml_tpu_torch.parallel import mesh

# reference declaration order (dataset/shapenet_1d.py:34-71)
CROP, AFFINE, DROP = 0, 1, 2
SHAPENET1D_OPS = ("crop_and_pad", "affine", "one_of_dropout")
ORDERS = tuple(itertools.permutations(range(len(SHAPENET1D_OPS))))
# Pascal1D's ops (utils/augment.py:82-141, no brightness;
# wmfml_tpu/aug/image_aug.py:442) and their 5! orders
P_CROP, P_GAMMA, P_BLUR, P_AFFINE, P_DROP = range(5)
PASCAL_OPS = ("crop_and_pad", "gamma_contrast", "average_blur", "affine",
              "one_of_dropout")
PASCAL_ORDERS = tuple(itertools.permutations(range(len(PASCAL_OPS))))
# Distractor's ops (dataset/shapenet_distractor.py:54-81;
# wmfml_tpu/aug/image_aug.py:444) and their 2! orders
D_AFFINE, D_DROP = range(2)
DISTRACTOR_OPS = ("affine", "one_of_dropout")
DISTRACTOR_ORDERS = tuple(itertools.permutations(range(len(DISTRACTOR_OPS))))
# ShapeNet3D's ops (FULL_OPS, utils/augment.py:34-60;
# wmfml_tpu/aug/image_aug.py:441) and their 6! orders
S_CROP, S_GAMMA, S_BRIGHT, S_BLUR, S_AFFINE, S_DROP = range(6)
SHAPENET3D_OPS = ("crop_and_pad", "gamma_contrast", "brightness",
                  "average_blur", "affine", "one_of_dropout")
SHAPENET3D_ORDERS = tuple(itertools.permutations(range(len(SHAPENET3D_OPS))))
# AddToBrightness(-30..30) on [0, 1] images: offset = u span + lo
BRIGHT_LO, BRIGHT_SPAN = -30.0 / 255.0, 60.0 / 255.0
TASKS = ("shapenet_1d", "pascal_1d", "distractor", "shapenet_3d")


@dataclass
class DAParams:
    order: Union[int, torch.Tensor, None]
    warp: torch.Tensor        # [B, 2, 7] float32
    drop: torch.Tensor        # [B, 5] float32
    keys: torch.Tensor        # [B, 2] int32
    pixel: Optional[torch.Tensor] = None     # [B, 4] float32 (Pascal1D)
    cells: Optional[torch.Tensor] = None     # [B, gh, gw] bool (tests)


def decode_order(index: int, n: int) -> tuple:
    """Permutation number ``index`` of ``itertools.permutations(range(n))``,
    decoded as K6 decodes it (``csrc/pixel_ops.cuh:decode_order``, Lehmer
    code): the digit of position j counts in (n - 1 - j)!."""
    rest, perm = list(range(n)), []
    f = math.factorial(n - 1)
    for j in range(n):
        d, index = divmod(index, f)
        perm.append(rest.pop(d))
        if n - 1 - j > 0:
            f //= n - 1 - j
    return tuple(perm)


def order_runs(order: Sequence[int]) -> List[tuple]:
    """The steps of one op order: maximal runs of adjacent warp ops (one
    warp chain each, stages in order) and the dropout op;
    ``perm_chain``'s grouping (``wmfml_tpu/aug/image_aug.py:510-535``)."""
    runs, i = [], 0
    while i < len(order):
        if order[i] == DROP:
            runs.append((DROP,))
            i += 1
            continue
        run = []
        while i < len(order) and order[i] != DROP:
            run.append(order[i])
            i += 1
        runs.append(tuple(run))
    return runs


def to_unit(x: torch.Tensor) -> torch.Tensor:
    """uint8 -> float32 / 255 as a true division (``_to_float``), also on
    the card, where dividing by a Python scalar multiplies by its
    reciprocal and differs in the last bit for 126 of the 256 values."""
    return x.to(torch.float32) / torch.full((), 255.0, device=x.device)


def program_input(program: str, x: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The float image a program starts from: x / 255 in ``dtype``, for
    Distractor's programs 1 - x / 255 in ``dtype`` (the JAX package inverts
    before DA: ``1.0 - _to_float(x, dtype)``; in bfloat16 the quotient
    rounds, then the difference), and ShapeNet3D's float images cast to
    ``dtype``."""
    if x.is_floating_point():
        return x.to(dtype)
    if program.startswith("distractor"):
        return 1.0 - to_unit(x).to(dtype)
    return to_unit(x).to(dtype)


# -- warp: dense twins of _interp_matrix .. _warp_chain ------------------------

def interp_matrix(n: int, src: torch.Tensor) -> torch.Tensor:
    """[..., n] sample positions -> [..., n, n] tent rows relu(1 - |src_i -
    j|); out-of-range taps get no weight (``_interp_matrix``, :57-70)."""
    j = torch.arange(n, dtype=torch.float32, device=src.device)
    return torch.clamp_min(1.0 - (src[..., :, None] - j).abs(), 0.0)


def _axis_src(n: int, scale, shift, nearest, gate):
    c = (n - 1) / 2.0
    ar = torch.arange(n, dtype=torch.float32, device=scale.device)
    src = (ar - c - shift[:, None]) / scale[:, None] + c
    if nearest is not None:
        src = torch.where(nearest[:, None], torch.floor(src + 0.5), src)
    if gate is not None:
        src = torch.where(gate[:, None], src, ar)
    return src


def stage_matrices(h: int, w: int, scale_xy, translate_xy, nearest=None,
                   gate=None):
    """Per-image axis matrices (wy [B, H, H], wx [B, W, W]) of one
    scale/translate warp; ``gate`` off gives the identity
    (``_stage_matrices``, :73-94). Parameters are [B] tensors."""
    sx, sy = scale_xy
    tx, ty = translate_xy
    wy = interp_matrix(h, _axis_src(h, sy, ty, nearest, gate))
    wx = interp_matrix(w, _axis_src(w, sx, tx, nearest, gate))
    return wy, wx


def affine_warp(img: torch.Tensor, scale_xy, translate_xy, cval,
                nearest=None) -> torch.Tensor:
    """One warp with constant fill (``_affine_warp``, :97-117); img
    [B, H, W, C], computed in float32 and returned in img's dtype."""
    _, h, w, _ = img.shape
    wy, wx = stage_matrices(h, w, scale_xy, translate_xy, nearest)
    out = torch.einsum("bih,bhwc,bjw->bijc", wy, img.float(), wx)
    coverage = wy.sum(-1)[:, :, None] * wx.sum(-1)[:, None, :]
    return (out + (cval[:, None, None] * (1.0 - coverage))[..., None]).to(
        img.dtype)


def warp_chain(img: torch.Tensor, stages: List[dict]) -> torch.Tensor:
    """Sequential warps in one image mix, exact (``_warp_chain``,
    :120-151): ``stages`` are dicts {scale, translate, cval, nearest?,
    gate?} of [B] tensors, applied first to last; each stage's fill field
    cval (1⊗1 - ry⊗rx) is pushed through the later stages' matrices. The
    chain is computed in float32 and rounds once, to img's dtype, at its
    end."""
    b, h, w, _ = img.shape
    ones_h = torch.ones((b, h), device=img.device)
    ones_w = torch.ones((b, w), device=img.device)
    my = mx = None
    terms = []                       # (coeff [B], a [B, H], b [B, W])
    for st in stages:
        wy, wx = stage_matrices(h, w, st["scale"], st["translate"],
                                st.get("nearest"), st.get("gate"))
        ry, rx = wy.sum(-1), wx.sum(-1)
        terms = [(c, (wy @ a[..., None])[..., 0], (wx @ v[..., None])[..., 0])
                 for c, a, v in terms]
        cval = st["cval"]
        terms.append((cval, ones_h, ones_w))
        terms.append((-cval, ry, rx))
        my = wy if my is None else wy @ my
        mx = wx if mx is None else wx @ mx
    out = torch.einsum("bih,bhwc,bjw->bijc", my, img.float(), mx)
    fill = torch.zeros((b, h, w), device=img.device)
    for c, a, v in terms:
        fill = fill + c[:, None, None] * (a[:, :, None] * v[:, None, :])
    return (out + fill[..., None]).to(img.dtype)


def stages_from_params(warp: torch.Tensor, ops: Sequence[int]) -> List[dict]:
    """``DAParams.warp`` rows of ``ops``, in order, as ``warp_chain``
    stages."""
    stages = []
    for op in ops:
        sx, sy, tx, ty, cval, nearest, gate = warp[:, op].unbind(-1)
        stages.append(dict(scale=(sx, sy), translate=(tx, ty), cval=cval,
                           nearest=nearest > 0.5, gate=gate > 0.5))
    return stages


# -- pixel ops: twins of gamma_contrast and average_blur -------------------------

def gamma_contrast(img: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """clip(x, 1e-6, 1) ** gamma in float32, returned in img's dtype
    (``gamma_contrast``, :211-216); ``gamma`` [B]. Black pixels come out as
    1e-6 ** gamma, not 0."""
    out = torch.clamp(img.float(), 1e-6, 1.0) ** gamma[:, None, None, None]
    return out.to(img.dtype)


def brightness(img: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """AddToBrightness as an offset ``b`` [B] of HSV's V (``brightness``,
    :219-240), in float32, returned in img's dtype: gray images take the
    plain clipped add; an RGB pixel with V = max(R, G, B) > 1e-6 scales
    its channels by clip(V + b, 0, 1) / V, a black one turns the gray
    clip(max(b, 0), 0, 1)."""
    xf = img.float()
    bb = b[:, None, None, None]
    if img.shape[-1] == 1:
        return torch.clamp(xf + bb, 0.0, 1.0).to(img.dtype)
    v = xf.amax(-1, keepdim=True)
    on = v > 1e-6
    scale = torch.where(on, torch.clamp(v + bb, 0.0, 1.0)
                        / torch.clamp_min(v, 1e-6), torch.zeros_like(v))
    gray = torch.clamp(torch.zeros_like(xf) + torch.clamp_min(bb, 0.0), 0.0,
                       1.0)
    return torch.where(on, xf * scale, gray).to(img.dtype)


def _divide(x: torch.Tensor, d: float) -> torch.Tensor:
    # a true division, also on the card (see to_unit)
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def average_blur(img: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """k x k mean filter with edge padding, k [B] in {1, 2, 3}; k = 1 is the
    identity and k = 2 takes the pixel and its top and left neighbours
    (``average_blur``, :243-257). The windows are summed in the JAX order
    (dy-major, from the first slice) in img's dtype, so in bfloat16 every
    add rounds, then divided by 9 or 4."""
    _, h, w, _ = img.shape
    ys = torch.clamp(torch.arange(-1, h + 1, device=img.device), 0, h - 1)
    xs = torch.clamp(torch.arange(-1, w + 1, device=img.device), 0, w - 1)
    pad = img[:, ys][:, :, xs]

    def window(n):
        acc = None
        for dy in range(n):
            for dx in range(n):
                t = pad[:, dy:dy + h, dx:dx + w]
                acc = t if acc is None else acc + t
        return _divide(acc, float(n * n))

    kk = k[:, None, None, None]
    return torch.where(kk == 3, window(3), torch.where(kk == 2, window(2),
                                                       img))


def sometimes(gate: torch.Tensor, out: torch.Tensor,
              img: torch.Tensor) -> torch.Tensor:
    """``sometimes`` (:420-426) at the given gates [B] (0/1)."""
    return torch.where((gate > 0.5)[:, None, None, None], out, img)


# -- hash masks: twins of _fmix32 .. coarse_dropout -----------------------------
# uint32 values live in int64 tensors; every product keeps its low 32 bits
# by splitting the constant into 16-bit halves (a full 32 x 32-bit product
# overflows int64), and every operation is masked back to 32 bits

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer (``_fmix32``, :277-284)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def hash_keep(key0, key1, ids: torch.Tensor, p_drop) -> torch.Tensor:
    """Keep bits u(ids) >= p_drop (``_hash_keep``, :287-298); key words and
    ids as uint32 values in int64 tensors that broadcast together."""
    x = (_mul32(ids ^ key0, _GOLDEN) + key1) & _M32
    x = fmix32(fmix32(x))
    # uint32 -> float32 rounds to nearest (exact through float64 first)
    u = x.to(torch.float64).to(torch.float32) * 2.0 ** -32
    return u >= p_drop


def _iota(h: int, w: int, c: int, device):
    ys = torch.arange(h, device=device).view(h, 1, 1)
    xs = torch.arange(w, device=device).view(1, w, 1)
    ch = torch.arange(c, device=device).view(1, 1, c)
    return ys, xs, ch


def dropout_ids(shape, per_channel: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] ids of ``dropout`` (:305-311): the pixel index, or per
    (pixel, channel) where ``per_channel`` [B] is set."""
    _, h, w, c = shape
    ys, xs, ch = _iota(h, w, c, per_channel.device)
    yx = ys * w + xs
    ids = torch.where(per_channel[:, None, None, None], yx * c + ch, yx)
    return ids.expand(*shape)


def coarse_ids(shape, sp: torch.Tensor,
               per_channel: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] low-res cell ids of ``coarse_dropout`` (:333-351) for
    size fractions ``sp`` [B] (float32)."""
    _, h, w, c = shape
    hl = torch.clamp_min(torch.round(h * sp), 1.0)[:, None, None, None]
    wl = torch.clamp_min(torch.round(w * sp), 1.0)[:, None, None, None]
    ys, xs, ch = _iota(h, w, c, sp.device)
    cell = (torch.floor(ys.float() * hl / h) * w
            + torch.floor(xs.float() * wl / w)).to(torch.int64)
    if c == 1:
        return cell.expand(*shape)
    ids = torch.where(per_channel[:, None, None, None], cell * c + ch, cell)
    return ids.expand(*shape)


def dropout_mask(shape, drop: torch.Tensor, keys: torch.Tensor):
    """Keep bits [B, H, W, C] of OneOf(Dropout, CoarseDropout) at ``drop``
    [B, 5] and ``keys`` [B, 2]: ``dropout`` where pick, else
    ``coarse_dropout`` (``one_of_dropout``, :371-375)."""
    gate, pick, p, sp, per_channel = drop.unbind(-1)
    pick, per_channel = pick > 0.5, per_channel > 0.5
    ids = torch.where(pick[:, None, None, None],
                      dropout_ids(shape, per_channel),
                      coarse_ids(shape, sp, per_channel))
    k = keys.to(torch.int64) & _M32         # int32 bit patterns -> uint32
    bcast = (slice(None), None, None, None)
    return hash_keep(k[:, 0][bcast], k[:, 1][bcast], ids, p[bcast])


def one_of_dropout(img: torch.Tensor, drop: torch.Tensor,
                   keys: torch.Tensor) -> torch.Tensor:
    """``sometimes(one_of_dropout)`` (:420-426, :371-375) at the given
    parameters: ``img * keep`` where the gate is on, else ``img``."""
    keep = dropout_mask(img.shape, drop, keys)
    gate = (drop[:, 0] > 0.5)[:, None, None, None]
    return torch.where(gate, img * keep.to(img.dtype), img)


def fixed_grid(h: int, w: int):
    """``coarse_dropout_fixed``'s grid (:365-367): (gh, gw) cells of (h //
    gh, w // gw) pixels; the JAX package's ``jnp.repeat`` only fits the
    image where those divide it, so other sizes raise."""
    gh, gw = max(h // 16, 1), max(w // 16, 1)
    if h % gh or w % gw:
        raise ValueError(f"the fixed dropout grid of {gh} x {gw} cells does "
                         f"not divide a {h} x {w} image")
    return gh, gw


def fixed_cell_ids(h: int, w: int, device) -> torch.Tensor:
    """[H, W] cell ids gy gw + gx of the fixed grid, nearest-upsampled."""
    gh, gw = fixed_grid(h, w)
    rows = torch.arange(h, device=device) // (h // gh)
    cols = torch.arange(w, device=device) // (w // gw)
    return rows[:, None] * gw + cols[None, :]


def dropout_mask_fixed(shape, drop: torch.Tensor, keys: torch.Tensor,
                       cells: Optional[torch.Tensor] = None):
    """Keep bits [B, H, W, C] of OneOf(Dropout, fixed-grid CoarseDropout)
    (``one_of_dropout_fixed``, :378-383): ``dropout`` where pick, else one
    bit a cell of the fixed grid, the same for every channel. A cell keeps
    its bit from the murmur3 hash of its id at the image's key words (the
    JAX package draws ``bernoulli(1 - p)`` a cell: the same distribution);
    ``cells`` [B, gh, gw] (bool) injects the bits instead."""
    b, h, w, c = shape
    pick, p, per_channel = drop[:, 1] > 0.5, drop[:, 2], drop[:, 4] > 0.5
    k = keys.to(torch.int64) & _M32
    bcast = (slice(None), None, None, None)
    k0, k1 = k[:, 0][bcast], k[:, 1][bcast]
    keep_d = hash_keep(k0, k1, dropout_ids(shape, per_channel), p[bcast])
    ids = fixed_cell_ids(h, w, drop.device)
    if cells is None:
        keep_c = hash_keep(k0, k1, ids[None, :, :, None], p[bcast])
    else:
        keep_c = cells.reshape(b, -1)[:, ids][..., None]
    return torch.where(pick[bcast], keep_d, keep_c.expand(*shape))


def one_of_dropout_fixed(img: torch.Tensor, drop: torch.Tensor,
                         keys: torch.Tensor,
                         cells: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``sometimes(one_of_dropout_fixed)`` (:456, :378-383)."""
    keep = dropout_mask_fixed(img.shape, drop, keys, cells)
    return sometimes(drop[:, 0], img * keep.to(img.dtype), img)


# -- the programs' parameters -----------------------------------------------------

def _columns(h: int, w: int):
    """(lo, span) of each of the 19 uniform columns (``sample``'s
    docstring): value = u * span + lo."""
    lo = [0.0] * 4 + [0.0, 0.8, 0.8, -0.1 * w, -0.1 * h, 0.0, 0.01, 0.0,
                      0.02] + [0.0] * 6
    span = [0.05] * 4 + [1.0, 0.4, 0.4, 0.2 * w, 0.2 * h, 1.0, 0.09, 0.05,
                         0.23] + [1.0] * 6
    return lo, span


def _scaled(u: torch.Tensor, h: int, w: int) -> torch.Tensor:
    lo, span = (torch.tensor(c, dtype=torch.float32, device=u.device)
                for c in _columns(h, w))
    return u[:, :19] * span + lo


def params_from_draw(u: torch.Tensor, keys: torch.Tensor, order, h: int,
                     w: int) -> DAParams:
    """The parameters of [B, H, W, C] images from the raw draw (``sample``):
    the formulas of the JAX package's ``_sample_crop_params``,
    ``_sample_affine_params``, ``dropout``, ``coarse_dropout`` and the
    ``sometimes`` gates. One float32 operation a step, none fused (no
    ``addcmul``), so that the card and the CPU round each step alike and K6
    (``csrc/image_da.cu:draw_params``) computes the same bits."""
    v = _scaled(u, h, w)
    n = u.shape[0]
    on = u[:, 13:18] < 0.5
    bits = on.float()
    # CropAndPad then resize back: per axis scale 1 / (1 + both pads),
    # content moved toward the more padded side
    first, second = v[:, 0:2], v[:, 2:4]
    half = torch.tensor([w / 2.0, h / 2.0], device=u.device)
    scale = 1.0 / (1.0 + first + second)
    shift = scale * (first - second) * half
    warp = torch.cat([scale, shift, v[:, 4:5], torch.zeros_like(v[:, :1]),
                      bits[:, 0:1], v[:, 5:10], bits[:, 2:3],
                      bits[:, 1:2]], 1).view(n, 2, 7)
    pick = on[:, 4]
    per_channel = u[:, 18] < torch.where(pick, 0.5, 0.2)
    drop = torch.stack([bits[:, 3], bits[:, 4],
                        torch.where(pick, v[:, 10], v[:, 11]), v[:, 12],
                        per_channel.float()], -1)
    return DAParams(order, warp, drop, keys)


def pixel_from_draw(u: torch.Tensor) -> torch.Tensor:
    """[B, 4] GammaContrast's and AverageBlur's parameters from columns
    19-22 (K6's ``draw_pixel``): the gates (u < .5), gamma = 1.5 u + .5 ~
    U[.5, 2) and k = floor(3 u) + 1 ~ U{1, 2, 3}."""
    return torch.stack([(u[:, 19] < 0.5).float(), u[:, 20] * 1.5 + 0.5,
                        (u[:, 21] < 0.5).float(),
                        torch.clamp(torch.floor(u[:, 22] * 3.0), 0.0, 2.0)
                        + 1.0], -1)


def bright_from_draw(u: torch.Tensor) -> torch.Tensor:
    """[B, 2] AddToBrightness's gate (column 23, u < .5) and offset ~
    U[-30/255, 30/255) (column 24) (K6's ``draw_bright``)."""
    lo, span = (torch.tensor(c, dtype=torch.float32, device=u.device)
                for c in (BRIGHT_LO, BRIGHT_SPAN))
    return torch.stack([(u[:, 23] < 0.5).float(), u[:, 24] * span + lo], -1)


def geometric_from_draw(u: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B, 2, 7]: ``geometric``'s one warp (:386-417) in row 0, row 1 zero
    (K6's ``draw_geometric``). CropAndPad's symmetric pad p (column 0 ~
    U[0, .05)) gives s1 = 1 / (1 + 2 p) where its gate (column 13) is on;
    Affine's scale (5-6) and shift (7-8) apply where its gate (14) is on;
    the warp has scale s1 s per axis, shift t, cval (column 9), bilinear,
    and is applied whatever the gates (off, it is the identity)."""
    v = _scaled(u, h, w)
    one, zero = torch.ones_like(v[:, 0]), torch.zeros_like(v[:, 0])
    s1 = torch.where(u[:, 13] < 0.5, 1.0 / (1.0 + 2.0 * v[:, 0]), one)
    g2 = u[:, 14] < 0.5
    row = torch.stack([s1 * torch.where(g2, v[:, 5], one),
                       s1 * torch.where(g2, v[:, 6], one),
                       torch.where(g2, v[:, 7], zero),
                       torch.where(g2, v[:, 8], zero), v[:, 9], zero, one],
                      -1)
    return torch.stack([row, torch.zeros_like(row)], 1)


def params_for(program: str, u: torch.Tensor, keys: torch.Tensor, order,
               h: int, w: int) -> DAParams:
    """``program``'s parameters from its raw draw, as K6 computes them."""
    p = params_from_draw(u, keys, order, h, w)
    if program in kda.GEOMETRIC:
        p.warp = geometric_from_draw(u, h, w)
    if program != "shapenet_1d":
        nu = kda.PROGRAM_NU[program]
        p.pixel = (pixel_from_draw(u) if nu >= kda.NU_PIXEL
                   else torch.zeros((u.shape[0], 4), device=u.device))
        if nu == kda.NU_RGB:
            p.pixel = torch.cat([p.pixel, bright_from_draw(u)], 1)
    return p


def params_row(p: DAParams) -> torch.Tensor:
    """The kernel's parameter row (``params_out``): warp, drop, pixel."""
    rows = [p.warp.flatten(1), p.drop]
    return torch.cat(rows + ([p.pixel] if p.pixel is not None else []), 1)


# -- the programs -----------------------------------------------------------------

def apply(flat: torch.Tensor, params: DAParams) -> torch.Tensor:
    """One order of ``SHAPENET1D_OPS`` on [B, H, W, C] float images through
    the dense twins, in their dtype. The order index is read modulo 6, as
    K6 reads it."""
    for run in order_runs(ORDERS[int(params.order) % len(ORDERS)]):
        if run == (DROP,):
            flat = one_of_dropout(flat, params.drop, params.keys)
        else:
            flat = warp_chain(flat, stages_from_params(params.warp, run))
    return flat


def _warp_op(flat: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """One warp stage alone (``_affine_warp``) at rows [B, 7]."""
    sx, sy, tx, ty, cval, nearest, _ = row.unbind(-1)
    return affine_warp(flat, (sx, sy), (tx, ty), cval, nearest > 0.5)


def apply_pascal(flat: torch.Tensor, params: DAParams) -> torch.Tensor:
    """One order of ``PASCAL_OPS`` (the JAX package's per-step switch
    chain, :567-577): each op alone on the whole batch under its gate, in
    the image's dtype. The order index is read modulo 120, as K6 reads
    it."""
    g_on, gamma, b_on, k = params.pixel.unbind(-1)
    for op in PASCAL_ORDERS[int(params.order) % len(PASCAL_ORDERS)]:
        if op in (P_CROP, P_AFFINE):
            row = params.warp[:, int(op == P_AFFINE)]
            flat = sometimes(row[:, 6], _warp_op(flat, row), flat)
        elif op == P_GAMMA:
            flat = sometimes(g_on, gamma_contrast(flat, gamma), flat)
        elif op == P_BLUR:
            flat = sometimes(b_on, average_blur(flat, k), flat)
        else:
            flat = one_of_dropout(flat, params.drop, params.keys)
    return flat


def apply_shapenet3d(flat: torch.Tensor, params: DAParams) -> torch.Tensor:
    """One order of ``SHAPENET3D_OPS`` (the per-step switch chain,
    :567-580): each op alone on the whole batch under its gate. The order
    index is read modulo 720 and decoded as K6 decodes it."""
    g_on, gamma, b_on, k, br_on, br = params.pixel.unbind(-1)
    order = decode_order(int(params.order) % len(SHAPENET3D_ORDERS), 6)
    for op in order:
        if op in (S_CROP, S_AFFINE):
            row = params.warp[:, int(op == S_AFFINE)]
            flat = sometimes(row[:, 6], _warp_op(flat, row), flat)
        elif op == S_GAMMA:
            flat = sometimes(g_on, gamma_contrast(flat, gamma), flat)
        elif op == S_BRIGHT:
            flat = sometimes(br_on, brightness(flat, br), flat)
        elif op == S_BLUR:
            flat = sometimes(b_on, average_blur(flat, k), flat)
        else:
            flat = one_of_dropout(flat, params.drop, params.keys)
    return flat


def apply_fixed(flat: torch.Tensor, params: DAParams,
                pixel_ops: bool) -> torch.Tensor:
    """``FUSED_PIPELINES`` (:457-462) for ShapeNet1D or (``pixel_ops``)
    Pascal1D and ShapeNet3D: ``geometric``, [GammaContrast,
    AddToBrightness (ShapeNet3D: a pixel row of 6), AverageBlur], then the
    fixed-grid dropout op."""
    flat = _warp_op(flat, params.warp[:, 0])
    if pixel_ops:
        g_on, gamma, b_on, k = params.pixel[:, :4].unbind(-1)
        flat = sometimes(g_on, gamma_contrast(flat, gamma), flat)
        if params.pixel.shape[1] == 6:
            br_on, br = params.pixel[:, 4:].unbind(-1)
            flat = sometimes(br_on, brightness(flat, br), flat)
        flat = sometimes(b_on, average_blur(flat, k), flat)
    return one_of_dropout_fixed(flat, params.drop, params.keys, params.cells)


def apply_distractor(flat: torch.Tensor, params: DAParams,
                     fixed: bool = False) -> torch.Tensor:
    """One order of ``DISTRACTOR_OPS`` (the order index read modulo 2, as
    K6 reads it) or, ``fixed``, the fixed order (:461): ``sometimes``
    Affine (``_affine_warp`` at ``warp`` row 1), then the dropout op, the
    fixed-grid one when ``fixed``."""
    order = (0 if fixed else
             int(params.order) % len(DISTRACTOR_ORDERS))
    for op in DISTRACTOR_ORDERS[order]:
        if op == D_AFFINE:
            row = params.warp[:, 1]
            flat = sometimes(row[:, 6], _warp_op(flat, row), flat)
        elif fixed:
            flat = one_of_dropout_fixed(flat, params.drop, params.keys,
                                        params.cells)
        else:
            flat = one_of_dropout(flat, params.drop, params.keys)
    return flat


def apply_program(program: str, flat: torch.Tensor,
                  params: DAParams) -> torch.Tensor:
    """K6's program ``program`` on [B, H, W, C] float images (its
    ``program_input``) through the twins."""
    if program == "shapenet_1d":
        return apply(flat, params)
    if program == "pascal_1d":
        return apply_pascal(flat, params)
    if program == "shapenet_3d":
        return apply_shapenet3d(flat, params)
    if program.startswith("distractor"):
        return apply_distractor(flat, params, program == "distractor_fixed")
    return apply_fixed(flat, params, program in ("pascal_1d_fixed",
                                                 "shapenet_3d_fixed"))


# -- the augmenters ---------------------------------------------------------------

class Augmenter:
    """``build_augmenter`` (:537-583) for the port: K6's op program
    ``program`` (``kernels/image_da.py:PROGRAMS``); each call draws its raw
    draw and issues one K6 launch. Images come out in ``dtype``, float32
    or bfloat16: as in the JAX package, x / 255 and the end of every op
    (or ShapeNet1D's warp chain) round to it (the masks are exact);
    Distractor's x / 255 and 1 - x / 255 each round. ShapeNet3D's
    programs read float RGB of ``dtype``."""

    def __init__(self, dtype: torch.dtype = torch.float32,
                 program: str = "shapenet_1d"):
        self.dtype, self.program = dtype, program
        self.nu = kda.PROGRAM_NU[program]           # uniforms per image
        self.orders = kda.PROGRAM_ORDERS[program]   # 1: a fixed order

    def sample(self, n: int, generator: Optional[torch.Generator], device):
        """The raw draw of one call for ``n`` images, on ``device``: one
        ``torch.rand`` of ``nu`` uniforms and one ``torch.randint`` of two
        key words per image, and the op order, uniform over the program's
        orders (``torch.randint``, so exactly uniform; None for a fixed
        order). Columns of the uniforms: 0-3 CropAndPad's pad fractions
        (left, top, right, bottom) ~ U[0, .05) (the fixed programs' one
        symmetric pad: column 0); 4 its cval; 5-6 Affine's scale ~ U[.8,
        1.2) per axis; 7-8 its translation ~ U[-.1, .1) of the width and
        height; 9 its cval (the fixed programs' one cval); 10 Dropout's
        rate ~ U[.01, .1); 11 CoarseDropout's ~ U[0, .05); 12 its size
        fraction ~ U[.02, .25); 13-17 Bernoulli(.5) bits: CropAndPad's gate,
        Affine's gate, Affine's order 0 (nearest), the dropout op's gate,
        Dropout (1) or CoarseDropout (0); 18 per channel, w.p. .5 for
        Dropout and .2 for CoarseDropout; Pascal1D's and ShapeNet3D's
        19-22: GammaContrast's gate and gamma, AverageBlur's gate and k
        (``pixel_from_draw``); ShapeNet3D's 23-24: AddToBrightness's gate
        and offset (``bright_from_draw``)."""
        u = torch.rand((n, self.nu), generator=generator, device=device)
        keys = torch.randint(-2 ** 31, 2 ** 31, (n, 2), dtype=torch.int32,
                             generator=generator, device=device)
        order = (torch.randint(self.orders, (1,), generator=generator,
                               device=device) if self.orders > 1 else None)
        return u, keys, order

    def __call__(self, images: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 params: Optional[DAParams] = None) -> torch.Tensor:
        """Augment [..., H, W, C] uint8 images (ShapeNet3D's: float RGB)
        into ``self.dtype``;
        ``params`` injects a draw (on the CPU only: the card computes the
        parameters in K6)."""
        if params is not None:
            if images.device.type != "cpu":
                raise ValueError("DAParams are injected on the CPU only")
            flat = images.reshape((-1,) + tuple(images.shape[-3:]))
            return apply_program(self.program, program_input(
                self.program, flat, self.dtype), params).reshape(images.shape)
        n = math.prod(images.shape[:-3])
        ctx = mesh.sharded()
        u, keys, order = self.sample(n if ctx is None else ctx.widen(n),
                                     generator, images.device)
        if ctx is not None:       # the whole batch's draw, this rank's rows
            u, keys = ctx.local(u), ctx.local(keys)
        return image_da(images, u, keys, order, self.dtype, self.program)


# program 0's augmenter, under the name of the slices before the others
ShapeNet1DAugmenter = Augmenter


def build_augmenter(task: str, dtype: torch.dtype = torch.float32,
                    random_order: bool = True) -> Augmenter:
    if task not in TASKS:
        raise NotImplementedError(
            f"task {task!r} has no image DA, in the JAX package either")
    return Augmenter(dtype, task if random_order else f"{task}_fixed")
