"""Pascal1D episodic sampler (pose regression, 128x128x1), host side
(``wmfml_tpu/data/pascal_1d.py``).

Loads ``train_data_ins.pkl`` / ``val_data_ins.pkl``, each ``(x [C, I, 128,
128, 1], y [C, I, K])`` with the label in the last column. Sampling follows
the JAX package draw for draw: one class per task, ``shot + query``
instances without replacement (first ``shot`` = context). The shot is the
caller's (fixed: the device sampler draws ``max_ctx`` context rows every
step) and the query count is ``query_num`` (default ``max_ctx``). Labels
stay raw here; the episode processor adds task augmentation's offset and
multiplies by 10 (``aug/pipeline.py``). There is no test split:
``_split("test")`` raises, and ``reset_eval`` reseeds the validation stream
only.
"""

from __future__ import annotations

import os
import pickle
from typing import List, Optional

import numpy as np

from wmfml_tpu_torch.data.basedata import BaseData
from wmfml_tpu_torch.data.episode import EpisodeBatch, make_episode


class Pascal1D(BaseData):
    raw_label_dim = 1
    task_name = "pascal_1d"

    def __init__(self, path: str, img_size, seed: int,
                 aug: Optional[List[str]] = None, max_ctx: int = 15,
                 query_num: Optional[int] = None):
        super().__init__(img_size, aug)
        self.num_classes = 1
        self.max_ctx = max_ctx
        self.query_num = query_num or max_ctx

        def load(name):
            with open(os.path.join(path, name), "rb") as f:
                x, y = pickle.load(f)
            return np.asarray(x), np.asarray(y)[:, :, -1, None].astype(np.float32)

        self.x_train, self.y_train = load("train_data_ins.pkl")
        self.x_val, self.y_val = load("val_data_ins.pkl")
        self.train_rng = np.random.RandomState(seed)
        self.val_rng = np.random.RandomState(seed)

    def reset_eval(self, source: str, seed: int = 42):
        if source == "validation":
            self.val_rng = np.random.RandomState(seed)

    def _split(self, source: str):
        if source == "train":
            return self.x_train, self.y_train, self.train_rng
        if source == "validation":
            return self.x_val, self.y_val, self.val_rng
        raise TypeError("pascal_1d has no test split")

    def get_batch_indices(self, source: str, tasks_per_batch: int, shot: int):
        """Index-only episode draw: (cls [T], take [T, shot+query], shot),
        consuming the split's stream exactly as ``get_batch`` does."""
        x, _, rng = self._split(source)
        cls_idx = rng.randint(0, x.shape[0], size=tasks_per_batch)
        take = np.stack([rng.choice(x.shape[1], size=shot + self.query_num,
                                    replace=False)
                         for _ in range(tasks_per_batch)])
        return cls_idx, take, shot

    def get_batch(self, source: str, tasks_per_batch: int,
                  shot: int) -> EpisodeBatch:
        x, y, _ = self._split(source)
        cls_idx, take, shot = self.get_batch_indices(source, tasks_per_batch,
                                                     shot)
        xs = x[cls_idx[:, None], take]
        ys = y[cls_idx[:, None], take]
        return make_episode(xs[:, :shot], ys[:, :shot], xs[:, shot:],
                            ys[:, shot:], max_ctx=self.max_ctx, shot=shot)
