"""Device-side episode processing: normalise, image and task augmentation,
labels.

``build_episode_processor(task, aug_list, train, dtype)`` returns
``process(batch, generator=None, ta_idx=None, da_params=None)`` that turns
a raw episode (uint8 images, raw labels, on any device) into the
model-facing batch, as ``wmfml_tpu/aug/pipeline.py:58-76`` does for
ShapeNet1D:

  * uint8 images -> x / 255 in the compute dtype ``dtype`` (float32 or
    bfloat16, rounded from the float32 quotient as JAX's
    ``x.astype(dtype) / 255.0`` rounds it), in the augmenter when image DA
    is on; labels and task augmentation stay float32;
  * image data augmentation (train only, ``data_aug`` in ``aug_list``):
    two augmenter calls on the raw uint8 images, context then query, each
    with its own op order and per-image parameters (``aug/image_aug.py``:
    one K6 launch a call on the card); ``da_params`` (a (context, query)
    pair of ``DAParams``) feeds a draw in on the CPU, else it is drawn from
    ``generator``;
  * task augmentation (train only, ``task_aug`` in ``aug_list``): one angle
    offset per task from ``linspace(0, 2, 16)[:-1]``, added mod 2*pi to
    context and query labels; ``ta_idx`` [T] feeds the offsets' indices in
    (tests hand both frameworks the same noise), else they are drawn from
    ``generator``;
  * labels -> ``[cos a, sin a, a]``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from wmfml_tpu_torch.aug.image_aug import build_augmenter


def _to_float(x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    if x.dtype == torch.uint8:
        return (x.to(torch.float32) / 255.0).to(dtype)
    return x.to(dtype)


def _encode_angle(y: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.cos(y), torch.sin(y), y], dim=-1)


def build_episode_processor(task: str, aug_list, train: bool,
                            dtype: torch.dtype = torch.float32) -> Callable:
    if task != "shapenet_1d":
        raise NotImplementedError(
            f"episode processing for {task!r} is not ported yet "
            "(ROADMAP.md A12)")
    task_aug = train and "task_aug" in aug_list
    augment = (build_augmenter(task, dtype)
               if train and "data_aug" in aug_list else None)

    def augment_pair(cx, qx, generator, da_params):
        """DA for ctx and qry: always two calls, as the JAX package makes."""
        if augment is None:
            return _to_float(cx, dtype), _to_float(qx, dtype)
        pc, pq = da_params if da_params is not None else (None, None)
        return augment(cx, generator, pc), augment(qx, generator, pq)

    def process(batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None,
                ta_idx: Optional[torch.Tensor] = None,
                da_params=None) -> Dict[str, torch.Tensor]:
        ctx_x, qry_x = augment_pair(batch["ctx_x"], batch["qry_x"],
                                    generator, da_params)
        ctx_y, qry_y = batch["ctx_y"], batch["qry_y"]
        if task_aug:
            if ta_idx is None:
                ta_idx = torch.randint(0, 15, (ctx_y.shape[0],),
                                       device=ctx_y.device,
                                       generator=generator)
            noise_vals = torch.linspace(0.0, 2.0, 16,
                                        device=ctx_y.device)[:-1]
            noise = noise_vals[ta_idx.to(ctx_y.device)][:, None, None]
            ctx_y = torch.remainder(ctx_y + noise, 2.0 * math.pi)
            qry_y = torch.remainder(qry_y + noise, 2.0 * math.pi)
        return dict(batch, ctx_x=ctx_x, qry_x=qry_x,
                    ctx_y=_encode_angle(ctx_y), qry_y=_encode_angle(qry_y))

    process.augment = augment
    return process
