"""Dataset factory: config -> episodic sampler.

Data root: ``config.data_path`` if set, else ``./data/ShapeNet1D`` (the
reference layout) when it holds the files, else a generated synthetic
dataset under ``./data_synth/ShapeNet1D``. ``synthetic_data: true`` forces
the synthetic set. Only ``shapenet_1d`` is ported; the other tasks raise.
"""

from __future__ import annotations

import os

from wmfml_tpu_torch.data.shapenet_1d import ShapeNet1D
from wmfml_tpu_torch.data.synthetic import ensure_dataset

NOT_PORTED = {
    "shapenet_3d": "ROADMAP.md A12 (LargeCNP slice)",
    "shapenet_3d_segmentation": "ROADMAP.md A12 (LargeCNP slice)",
    "distractor": "ROADMAP.md A12 (LargeCNP slice)",
    "pascal_1d": "ROADMAP.md A12 (Pascal1D sampler)",
}


def resolve_data_path(config) -> str:
    if config.data_path:
        return config.data_path
    real = os.path.join("data", "ShapeNet1D")
    if not config.synthetic_data and os.path.exists(
            os.path.join(real, "val_data.pkl")):
        return real
    config.logger.info(
        f"real {config.task} data not found under {real}; using synthetic dataset")
    return ensure_dataset(config.task, "data_synth")


def build_data(config):
    """Host sampler for ``config.task`` (seed 42, as in the JAX package)."""
    if config.task != "shapenet_1d":
        raise NotImplementedError(
            f"task {config.task!r} is not ported yet: "
            f"{NOT_PORTED.get(config.task, 'unknown task')}")
    return ShapeNet1D(resolve_data_path(config), img_size=config.img_size,
                      seed=42, data_size=config.data_size,
                      aug=config.aug_list, max_ctx=config.max_ctx_num,
                      query_num=config.query_num)
