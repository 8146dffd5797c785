"""Device-resident episode sampling: the train split lives on the card.

The train splits are small (ShapeNet1D 60 x 50 x 128 x 128 uint8 = 49 MB,
synthetic Pascal1D 40 x 50 x 128 x 128 = 33 MB, synthetic Distractor 48
objects x 36 views x 128 x 128 = 28 MB, synthetic ShapeNet3D 240 items x
30 views x 64 x 64 x 4 float32 = 472 MB and its 200 backgrounds of 64 x 64
x 3 float32, 9.8 MB), so the split is uploaded
once and every training episode is gathered on the device from a
``torch.Generator`` on that device; no image crosses the host link after
set-up. Semantics of the JAX package's sampler
(``wmfml_tpu/data/device_sampler.py:72-101``):

  * class per task uniform; instances without replacement through one
    argsort of uniforms per task (the first ``max_ctx`` rows are context,
    the next ``query`` rows are queries);
  * shot ~ U[shot_min, max_ctx] once per batch, realised as ``ctx_mask``
    (``shot_min`` 3 for ShapeNet1D, 1 for Distractor; ``max_ctx`` for
    Pascal1D, whose shot is fixed, ``from_dataset`` as ``:125-136``);
  * labels scaled by ``label_scale`` (2*pi for ShapeNet1D; 1 for Pascal1D,
    whose labels the episode processor scales, for Distractor, whose
    labels are the objects' pixel centres, and for ShapeNet3D's
    quaternions);
  * ShapeNet3D with ``gen_bg``: every batch is composited on backgrounds
    drawn for it (``composite``: ``randint(0, 200, [T, N])`` from the
    generator, the context's draw, then the queries'), with the bank
    resident on the card, as ``wmfml_tpu/data/device_sampler.py:96-110``
    composites it; plain elementwise work inside the captured step;
  * a float split (ShapeNet3D's) and its backgrounds are kept in the
    compute dtype: bfloat16 under ``compute_dtype: bfloat16``, as
    ``wmfml_tpu/data/device_sampler.py:53-60`` stores them (236 MB for the
    synthetic split), so compositing runs in bfloat16 (exact: each pixel
    is the image's or the background's) and the batch reaches K6 in the
    dtype it writes; uint8 splits stay uint8.

The draws differ from the JAX package's (Philox against threefry); the
distribution is the same.

Each training step samples its own episode, inside the step. The JAX fused
step draws its K episodes in one ``vmap`` ahead of its ``scan``
(``wmfml_tpu/train/steps.py:200-208``); the port's fused step
(``train/steps.py:FusedSteps``) captures K steps, each drawing as the eager
loop draws, so that a CUDA graph replay draws exactly what K eager steps
draw from the same generator state. ``sample`` reads nothing back to the
host, so it can be captured. Under a data-parallel mesh
(``parallel/mesh.py``) every rank draws the whole batch's classes,
uniforms and backgrounds from the same generator state and gathers its
own tasks' rows only.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from wmfml_tpu_torch.configs.config import torch_dtype
from wmfml_tpu_torch.parallel import mesh

# the JAX package's rule for a split the device takes
# (wmfml_tpu/data/device_sampler.py:33): a split of more bytes on the host
# is streamed; both packages apply it to the host array, so they choose the
# same path
DEVICE_DATA_BYTES_LIMIT = 2_000_000_000


def split_refusal(x: np.ndarray, need: int) -> Optional[str]:
    """Why a dense split [groups, instances, ...] cannot live on the
    device, or None: more than ``DEVICE_DATA_BYTES_LIMIT`` bytes on the
    host, or fewer than ``need`` instances a group."""
    if x.nbytes > DEVICE_DATA_BYTES_LIMIT:
        return (f"the split holds {x.nbytes} bytes on the host, over "
                f"DEVICE_DATA_BYTES_LIMIT = {DEVICE_DATA_BYTES_LIMIT}")
    if x.shape[1] < need:
        return f"{x.shape[1]} instances a class, fewer than {need}"
    return None


def refusal(data, config) -> Optional[str]:
    """Why ``from_dataset`` declines ``data``'s train split, or None
    (``wmfml_tpu/data/device_sampler.py:113-152``): an unknown task, a
    missing train split, or ``split_refusal`` at ``max_ctx_num +
    query_num`` instances a class."""
    task = getattr(data, "task_name", None)
    if task not in DeviceEpisodeSampler.TASKS:
        return f"no device sampler for task {task!r}"
    try:
        x = data.x_train
    except AttributeError:
        return "the dataset has no dense train split"
    return split_refusal(x, config.max_ctx_num + config.query_num)


class DeviceEpisodeSampler:
    """Wraps a dense train split [groups, instances, ...] on ``device``."""

    def __init__(self, x: np.ndarray, y: np.ndarray, max_ctx: int, query: int,
                 shot_min: int, label_scale: float, device,
                 bg: Optional[np.ndarray] = None,
                 store_dtype: torch.dtype = torch.float32):
        self.max_ctx, self.query, self.shot_min = max_ctx, query, shot_min
        self.label_scale = label_scale
        self.n_groups, self.n_inst = x.shape[0], x.shape[1]
        if self.n_inst < max_ctx + query:
            raise ValueError(f"need {max_ctx + query} instances per class, "
                             f"have {self.n_inst}")
        x = torch.from_numpy(np.ascontiguousarray(x))
        self.x = (x.to(store_dtype) if x.is_floating_point() else x).to(device)
        self.y = torch.from_numpy(np.asarray(y, np.float32)).to(device)
        self.bg = (None if bg is None else
                   torch.from_numpy(np.asarray(bg, np.float32)).to(
                       device, store_dtype))

    # task -> (shot_min, label_scale); shot_min None is max_ctx_num
    TASKS = {"shapenet_1d": (3, 2.0 * np.pi), "pascal_1d": (None, 1.0),
             "distractor": (1, 1.0), "shapenet_3d": (1, 1.0)}

    @classmethod
    def from_dataset(cls, data, config,
                     device) -> Optional["DeviceEpisodeSampler"]:
        """The sampler over ``data``'s train split on ``device``, or None
        exactly where the JAX package's ``from_dataset`` gives None
        (``refusal``); the trainer then streams host episodes."""
        if refusal(data, config) is not None:
            return None
        shot_min, label_scale = cls.TASKS[data.task_name]
        gen_bg = data.task_name == "shapenet_3d" and config.gen_bg
        return cls(data.x_train, data.y_train, max_ctx=config.max_ctx_num,
                   query=config.query_num,
                   shot_min=config.max_ctx_num if shot_min is None
                   else shot_min, label_scale=label_scale, device=device,
                   bg=data.bg_imgs if gen_bg else None,
                   store_dtype=torch_dtype(config))

    def composite(self, images: torch.Tensor,
                  idx: torch.Tensor) -> torch.Tensor:
        """RGBA ``images`` [T, N, H, W, 4] on backgrounds ``idx`` [T, N]:
        ``rgb fg + bg[idx] (1 - fg)`` with fg = alpha < 1, alpha kept."""
        fg = (images[..., 3:4] < 1.0).to(images.dtype)
        rgb = images[..., :3] * fg + self.bg[idx] * (1.0 - fg)
        return torch.cat([rgb, images[..., 3:4]], -1)

    def sample(self, tasks_per_batch: int,
               generator: torch.Generator) -> Dict[str, torch.Tensor]:
        t, s, q = tasks_per_batch, self.max_ctx, self.query
        dev = self.x.device
        ctx = mesh.sharded()
        local = (lambda a: a) if ctx is None else ctx.local
        cls = torch.randint(0, self.n_groups, (t,), device=dev,
                            generator=generator)
        u = torch.rand((t, self.n_inst), device=dev, generator=generator)
        cls, u = local(cls), local(u)                          # this rank's
        take = torch.argsort(u, dim=-1)[:, :s + q]             # [T, S+Q]
        xs = self.x[cls[:, None], take]                        # [T, S+Q, H, W, C]
        ys = self.y[cls[:, None], take] * self.label_scale     # [T, S+Q, Dy]
        shot = torch.randint(self.shot_min, s + 1, (), device=dev,
                             generator=generator)
        mask = (torch.arange(s, device=dev)[None, :] < shot).expand(
            cls.shape[0], s)
        ctx_x, qry_x = xs[:, :s], xs[:, s:]
        if self.bg is not None:
            n_bg = self.bg.shape[0]
            ctx_x, qry_x = (self.composite(x, local(torch.randint(
                0, n_bg, (t, x.shape[1]), device=dev, generator=generator)))
                for x in (ctx_x, qry_x))
        return dict(ctx_x=ctx_x, ctx_y=ys[:, :s], ctx_mask=mask,
                    qry_x=qry_x, qry_y=ys[:, s:])


from_dataset = DeviceEpisodeSampler.from_dataset
