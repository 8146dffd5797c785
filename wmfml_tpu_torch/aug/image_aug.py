"""Image data augmentation for ShapeNet1D (``wmfml_tpu/aug/image_aug.py``).

The reference pipeline is ``SHAPENET1D_OPS``: ``Sometimes(0.5)`` of
CropAndPad, of Affine and of OneOf(Dropout, CoarseDropout), applied in an
op order drawn per augmenter call out of the 3! = 6 orders
(``iaa.Sequential(random_order=True)``). Adjacent CropAndPad and Affine
compose into one warp chain, as the JAX package's ``perm_chain`` does.

Two layers:

  * the plain twins, the JAX math op for op on a batch with per-image
    parameters: ``interp_matrix``, ``stage_matrices``, ``affine_warp`` and
    ``warp_chain`` (dense tent matrices and the rank-1 fill terms),
    ``fmix32`` / ``hash_keep`` (murmur3 keep bits, uint32 arithmetic held
    in int64), the Dropout and CoarseDropout ids and their keep mask
    (``dropout_mask``, ``one_of_dropout``); ``params_from_draw`` and
    ``apply`` chain them into K6's plain version
    (``kernels/image_da.py:image_da_plain``);
  * ``ShapeNet1DAugmenter``: one call draws its raw draw on the images'
    device (``sample``: uniforms, key words and the op order) and issues
    one K6 launch (``kernels/image_da.py``), which computes the parameters
    and applies the order on the card.

Parameters of one augmenter call (``DAParams``), per image b:

  * ``warp[b, op]`` for op 0 (CropAndPad) and 1 (Affine):
    ``(sx, sy, tx, ty, cval, nearest, gate)``, booleans as 0/1;
  * ``drop[b]``: ``(gate, pick, p, sp, per_channel)``; ``pick`` selects
    Dropout (1) or CoarseDropout (0), ``p`` the drop rate, ``sp`` the
    coarse grid's size fraction;
  * ``keys[b]``: the hash's two 32-bit key words (int32 bit patterns);
  * ``order``: an index into ``ORDERS``, shared by the whole call (an int,
    or a one-element tensor as drawn), read modulo 6.

The draws come from the caller's generator on the images' device (Philox on
the card: the JAX package's threefry bits are not reproduced, their
distribution is), the order too, so the host reads none of them. Tests
inject JAX's own draws as ``DAParams``, on the CPU.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Union

import torch

from wmfml_tpu_torch.kernels.image_da import image_da

# reference declaration order (dataset/shapenet_1d.py:34-71)
CROP, AFFINE, DROP = 0, 1, 2
SHAPENET1D_OPS = ("crop_and_pad", "affine", "one_of_dropout")
ORDERS = tuple(itertools.permutations(range(len(SHAPENET1D_OPS))))
OTHER_TASKS = "DA for {task!r} (FULL/PASCAL/DISTRACTOR ops): ROADMAP.md A12"


@dataclass
class DAParams:
    order: Union[int, torch.Tensor]
    warp: torch.Tensor        # [B, 2, 7] float32
    drop: torch.Tensor        # [B, 5] float32
    keys: torch.Tensor        # [B, 2] int32


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


# -- the augmenter ---------------------------------------------------------------

def _columns(h: int, w: int):
    """(lo, span) of each of the 19 uniform columns (``sample``'s
    docstring): value = u * span + lo."""
    lo = [0.0] * 4 + [0.0, 0.8, 0.8, -0.1 * w, -0.1 * h, 0.0, 0.01, 0.0,
                      0.02] + [0.0] * 6
    span = [0.05] * 4 + [1.0, 0.4, 0.4, 0.2 * w, 0.2 * h, 1.0, 0.09, 0.05,
                         0.23] + [1.0] * 6
    return lo, span


def params_from_draw(u: torch.Tensor, keys: torch.Tensor, order, h: int,
                     w: int) -> DAParams:
    """The parameters of [B, H, W, C] images from the raw draw (``sample``):
    the formulas of the JAX package's ``_sample_crop_params``,
    ``_sample_affine_params``, ``dropout``, ``coarse_dropout`` and the
    ``sometimes`` gates. One float32 operation a step, none fused (no
    ``addcmul``), so that the card and the CPU round each step alike and K6
    (``csrc/image_da.cu:draw_params``) computes the same bits."""
    lo, span = (torch.tensor(c, dtype=torch.float32, device=u.device)
                for c in _columns(h, w))
    v = u * span + lo
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


class ShapeNet1DAugmenter:
    """``build_augmenter("shapenet_1d")`` (:537-565) for the port: each call
    draws its raw draw and issues one K6 launch. Images come out in
    ``dtype``, float32 or bfloat16: as in the JAX package, x / 255 and
    every warp chain round to it (the masks are exact)."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        self.dtype = dtype

    def sample(self, n: int, generator: Optional[torch.Generator], device):
        """The raw draw of one call for ``n`` images, on ``device``: one
        ``torch.rand`` of 19 uniforms and one ``torch.randint`` of two key
        words per image, and the op order, uniform over the six
        (``torch.randint``, so exactly uniform). Columns of the uniforms:
        0-3 CropAndPad's pad fractions (left, top, right, bottom) ~ U[0,
        .05); 4 its cval; 5-6 Affine's scale ~ U[.8, 1.2) per axis; 7-8 its
        translation ~ U[-.1, .1) of the width and height; 9 its cval; 10
        Dropout's rate ~ U[.01, .1); 11 CoarseDropout's ~ U[0, .05); 12 its
        size fraction ~ U[.02, .25); 13-17 Bernoulli(.5) bits: CropAndPad's
        gate, Affine's gate, Affine's order 0 (nearest), the dropout op's
        gate, Dropout (1) or CoarseDropout (0); 18 per channel, w.p. .5 for
        Dropout and .2 for CoarseDropout."""
        u = torch.rand((n, 19), generator=generator, device=device)
        keys = torch.randint(-2 ** 31, 2 ** 31, (n, 2), dtype=torch.int32,
                             generator=generator, device=device)
        order = torch.randint(len(ORDERS), (1,), generator=generator,
                              device=device)
        return u, keys, order

    def __call__(self, images: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 params: Optional[DAParams] = None) -> torch.Tensor:
        """Augment [..., H, W, C] uint8 images into ``self.dtype``;
        ``params`` injects a draw (on the CPU only: the card computes the
        parameters in K6)."""
        if params is not None:
            if images.device.type != "cpu":
                raise ValueError("DAParams are injected on the CPU only")
            flat = images.reshape((-1,) + tuple(images.shape[-3:]))
            return apply(to_unit(flat).to(self.dtype), params).reshape(
                images.shape)
        u, keys, order = self.sample(math.prod(images.shape[:-3]), generator,
                                     images.device)
        return image_da(images, u, keys, order, self.dtype)


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


def build_augmenter(task: str,
                    dtype: torch.dtype = torch.float32) -> ShapeNet1DAugmenter:
    if task != "shapenet_1d":
        raise NotImplementedError(OTHER_TASKS.format(task=task))
    return ShapeNet1DAugmenter(dtype)
