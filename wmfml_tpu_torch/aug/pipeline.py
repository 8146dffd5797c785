"""Device-side episode processing: normalise, task augmentation, labels.

``build_episode_processor(task, aug_list, train)`` returns
``process(batch, generator=None, ta_idx=None)`` that turns a raw episode
(uint8 images, raw labels, on any device) into the model-facing batch, as
``wmfml_tpu/aug/pipeline.py:58-76`` does for ShapeNet1D:

  * uint8 images -> float32 / 255;
  * task augmentation (train only, ``task_aug`` in ``aug_list``): one angle
    offset per task from ``linspace(0, 2, 16)[:-1]``, added mod 2*pi to
    context and query labels; ``ta_idx`` [T] feeds the offsets' indices in
    (tests hand both frameworks the same noise), else they are drawn from
    ``generator``;
  * labels -> ``[cos a, sin a, a]``.

Image data augmentation (``data_aug``) is not ported yet and raises: the
port never drops an augmentation silently.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

DA_NOT_PORTED = "DA: ROADMAP A7"


def _to_float(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.uint8:
        return x.to(torch.float32) / 255.0
    return x.to(torch.float32)


def _encode_angle(y: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.cos(y), torch.sin(y), y], dim=-1)


def build_episode_processor(task: str, aug_list, train: bool) -> Callable:
    if task != "shapenet_1d":
        raise NotImplementedError(
            f"episode processing for {task!r} is not ported yet "
            "(ROADMAP.md A12)")
    if "data_aug" in aug_list:
        raise NotImplementedError(DA_NOT_PORTED)
    task_aug = train and "task_aug" in aug_list

    def process(batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None,
                ta_idx: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
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
        return dict(batch, ctx_x=_to_float(batch["ctx_x"]),
                    qry_x=_to_float(batch["qry_x"]),
                    ctx_y=_encode_angle(ctx_y), qry_y=_encode_angle(qry_y))

    return process
