"""Device-side episode processing: normalise, image and task augmentation,
labels.

``build_episode_processor(task, aug_list, train, dtype, aug_random_order)``
returns ``process(batch, generator=None, ta_idx=None, da_params=None)``
that turns a raw episode (uint8 images, raw labels, on any device) into the
model-facing batch, as ``wmfml_tpu/aug/pipeline.py:58-76`` (ShapeNet1D),
``:78-96`` (ShapeNet3D), ``:99-112`` (Distractor) and ``:116-131``
(Pascal1D) do:

  * uint8 images -> x / 255 in the compute dtype ``dtype`` (float32 or
    bfloat16, rounded from the float32 quotient as JAX's
    ``x.astype(dtype) / 255.0`` rounds it), in the augmenter when image DA
    is on; float images (ShapeNet3D's) cast to it; labels and task
    augmentation stay float32 (ShapeNet3D's integer pose noise too: JAX
    casts it to the compute dtype, exactly, and it meets the float32
    quaternions); Distractor's images are inverted first, 1 - x / 255 in
    ``dtype`` (in bfloat16 the quotient rounds, then the difference, as
    JAX's ``1.0 - _to_float(x, dtype)``; in the augmenter's program when
    image DA is on);
  * image data augmentation (train only, ``data_aug`` in ``aug_list``):
    two augmenter calls on the raw uint8 images, context then query, each
    with its own draw (``aug/image_aug.py``: one K6 launch a call on the
    card; ``aug_random_order`` false selects the fixed-order pipeline);
    ``da_params`` (a (context, query) pair of ``DAParams``) feeds a draw in
    on the CPU, else it is drawn from ``generator``;
  * task augmentation (train only, ``task_aug`` in ``aug_list``): one
    offset per task, added to context and query labels: ShapeNet1D's angle
    from ``linspace(0, 2, 16)[:-1]`` mod 2 pi, Pascal1D's from {0, .25,
    .5, .75} mod 1, Distractor's integer pixel shift in [0, 16) per task
    and coordinate, mod 128, ShapeNet3D's Euler noise in degrees, ele ~
    U{-5..9} (0 with ``azimuth_only``) and azi ~ U{-10..19} a task,
    composed onto the quaternions (``utils/quaternion.py:
    task_augment_quat``); ``ta_idx`` ([T] offset indices, Distractor's
    [T, 1, 2] shifts, ShapeNet3D's [T, 2] (ele, azi)) feeds them in (tests
    hand both frameworks the same noise), else they are drawn from
    ``generator``;
  * labels: ShapeNet1D's -> ``[cos a, sin a, a]``; Pascal1D's x 10;
    Distractor's stay pixel centres, ShapeNet3D's quaternions; in training
    and in evaluation alike.

Under a data-parallel mesh (``parallel/mesh.py``) the episode holds this
rank's tasks: the TA offsets (and the augmenter's draws) are drawn for the
whole batch and sliced, so every rank draws what one process draws.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from wmfml_tpu_torch.aug.image_aug import TASKS, build_augmenter, to_unit
from wmfml_tpu_torch.parallel import mesh
from wmfml_tpu_torch.utils.quaternion import task_augment_quat


def _to_float(x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    if x.dtype == torch.uint8:
        return (x.to(torch.float32) / 255.0).to(dtype)
    return x.to(dtype)


def _encode_angle(y: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.cos(y), torch.sin(y), y], dim=-1)


def _pose_noise(ctx_y, qry_y, azimuth_only, generator, ta_idx):
    """ShapeNet3D's task augmentation: ta_idx [T, 2] (ele, azi) degrees,
    drawn on the labels' device unless given."""
    t = ctx_y.shape[0]
    if ta_idx is None:
        ctx = mesh.sharded()
        if ctx is not None:             # the whole batch's, then this rank's
            t = ctx.widen(t)
        ele = (torch.zeros((t,), dtype=torch.int64, device=ctx_y.device)
               if azimuth_only else
               torch.randint(-5, 10, (t,), device=ctx_y.device,
                             generator=generator))
        azi = torch.randint(-10, 20, (t,), device=ctx_y.device,
                            generator=generator)
        if ctx is not None:
            ele, azi = ctx.local(ele), ctx.local(azi)
    else:
        ele, azi = ta_idx.to(ctx_y.device).unbind(-1)
    ele, azi = ele.to(ctx_y.dtype), azi.to(ctx_y.dtype)
    return (task_augment_quat(ctx_y, ele, azi),
            task_augment_quat(qry_y, ele, azi))


def build_episode_processor(task: str, aug_list, train: bool,
                            dtype: torch.dtype = torch.float32,
                            aug_random_order: bool = True) -> Callable:
    if task not in TASKS:
        raise NotImplementedError(
            f"task {task!r} has no episode processing, in the JAX package "
            "either")
    task_aug = train and "task_aug" in aug_list
    augment = (build_augmenter(task, dtype, aug_random_order)
               if train and "data_aug" in aug_list else None)
    if task == "pascal_1d":
        # offsets {0, .25, .5, .75}[randint(4)] mod 1, labels x 10
        n_offsets, modulus, scale = 4, 1.0, 10.0
    elif task == "distractor":
        # shifts randint(0, 16) per task and coordinate, mod 128, raw labels
        n_offsets, modulus, scale = 16, 128.0, 1.0
    else:
        n_offsets, modulus, scale = 15, 2.0 * math.pi, None

    def to_input(x):
        if task == "distractor":        # inverted before any DA
            return 1.0 - (to_unit(x).to(dtype) if x.dtype == torch.uint8
                          else x.to(dtype))
        return _to_float(x, dtype)

    def strip_alpha(x):
        return x[..., :3] if task == "shapenet_3d" else x

    def augment_pair(cx, qx, generator, da_params):
        """DA for ctx and qry: always two calls, as the JAX package makes."""
        if augment is None:
            return to_input(cx), to_input(qx)
        pc, pq = da_params if da_params is not None else (None, None)
        return augment(cx, generator, pc), augment(qx, generator, pq)

    def process(batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None,
                ta_idx: Optional[torch.Tensor] = None,
                da_params=None) -> Dict[str, torch.Tensor]:
        ctx_x, qry_x = augment_pair(strip_alpha(batch["ctx_x"]),
                                    strip_alpha(batch["qry_x"]), generator,
                                    da_params)
        ctx_y, qry_y = batch["ctx_y"], batch["qry_y"]
        if task == "shapenet_3d":
            if task_aug:
                ctx_y, qry_y = _pose_noise(ctx_y, qry_y,
                                           "azimuth_only" in aug_list,
                                           generator, ta_idx)
            return dict(batch, ctx_x=ctx_x, qry_x=qry_x, ctx_y=ctx_y,
                        qry_y=qry_y)
        if task_aug:
            shape = ((ctx_y.shape[0], 1, 2) if task == "distractor"
                     else (ctx_y.shape[0],))
            if ta_idx is None:
                ctx = mesh.sharded()
                whole = shape if ctx is None else (ctx.widen(shape[0]),
                                                   *shape[1:])
                ta_idx = torch.randint(0, n_offsets, whole,
                                       device=ctx_y.device,
                                       generator=generator)
                if ctx is not None:
                    ta_idx = ctx.local(ta_idx)
            idx = ta_idx.to(ctx_y.device)
            if task == "distractor":
                noise = idx.to(torch.float32)
            elif scale is None:
                noise = torch.linspace(0.0, 2.0, 16,
                                       device=ctx_y.device)[:-1][idx]
            else:       # {0, .25, .5, .75}[idx], exactly (no host copy)
                noise = idx.to(torch.float32) * 0.25
            noise = noise.reshape(ctx_y.shape[0], 1, -1)
            ctx_y = torch.remainder(ctx_y + noise, modulus)
            qry_y = torch.remainder(qry_y + noise, modulus)
        if scale is None:
            ctx_y, qry_y = _encode_angle(ctx_y), _encode_angle(qry_y)
        elif scale != 1.0:
            ctx_y, qry_y = ctx_y * scale, qry_y * scale
        return dict(batch, ctx_x=ctx_x, qry_x=qry_x, ctx_y=ctx_y, qry_y=qry_y)

    process.augment = augment
    return process
