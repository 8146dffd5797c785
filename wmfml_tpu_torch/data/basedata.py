"""Episodic dataset base API (host side, numpy).

``get_batch(source, tasks_per_batch, shot)`` returns one padded host
episode; ``reset_eval(source)`` reseeds a split's stream so every
validation sweep draws the same episodes (RandomState 42).
"""

from __future__ import annotations

from typing import List, Optional

from wmfml_tpu_torch.data.episode import EpisodeBatch

KNOWN_AUGS = {"MR", "data_aug", "task_aug", "azimuth_only"}


class BaseData:
    raw_label_dim: int = 1

    def __init__(self, img_size, aug: Optional[List[str]] = None):
        self.img_size = list(img_size)
        aug = list(aug or [])
        unknown = set(aug) - KNOWN_AUGS
        if unknown:
            raise ValueError(f"unknown aug {sorted(unknown)} in {aug}")
        self.aug_list = aug

    def get_batch(self, source: str, tasks_per_batch: int,
                  shot: int) -> EpisodeBatch:
        raise NotImplementedError

    def reset_eval(self, source: str, seed: int = 42):
        """Make the next eval sweep over ``source`` deterministic."""
