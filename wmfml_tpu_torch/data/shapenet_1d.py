"""ShapeNet1D episodic sampler (azimuth regression, 128x128x1), host side.

Loads ``train_data_{size}.pkl`` / ``val_data.pkl`` / ``test_data.pkl``, each
``(x [C, I, 128, 128, 1], y [C, I, K])`` with the angle in the last label
column, scaled to [0, 1]. Sampling follows the JAX package draw for draw:
one class per task, ``shot + query`` instances without replacement (first
``shot`` = context), train shot ~ U[3, max_ctx], labels x 2*pi. Each split
has its own ``RandomState``; ``reset_eval`` reseeds it to 42.

Training samples on the device instead (``data/device_sampler.py``); the
host streams here serve validation and test.
"""

from __future__ import annotations

import os
import pickle
from typing import List, Optional

import numpy as np

from wmfml_tpu_torch.data.basedata import BaseData
from wmfml_tpu_torch.data.episode import EpisodeBatch, make_episode


class ShapeNet1D(BaseData):
    raw_label_dim = 1
    task_name = "shapenet_1d"

    def __init__(self, path: str, img_size, seed: int, data_size: str = "large",
                 aug: Optional[List[str]] = None, max_ctx: int = 15,
                 query_num: Optional[int] = None):
        super().__init__(img_size, aug)
        if max_ctx < 3:
            raise ValueError(
                f"shapenet_1d needs max_ctx_num >= 3 (train shot ~ U[3, "
                f"max]); got {max_ctx}")
        self.data_size = data_size
        self.max_ctx = max_ctx
        self.query_num = query_num or max_ctx

        def load(name):
            with open(os.path.join(path, name), "rb") as f:
                x, y = pickle.load(f)
            return np.asarray(x), np.asarray(y)[:, :, -1, None].astype(np.float32)

        self.x_train, self.y_train = load(f"train_data_{data_size}.pkl")
        self.x_val, self.y_val = load("val_data.pkl")
        self.x_test, self.y_test = load("test_data.pkl")

        self.train_rng = np.random.RandomState(seed)
        self.val_rng = np.random.RandomState(seed)
        self.test_rng = np.random.RandomState(seed)

    def reset_eval(self, source: str, seed: int = 42):
        if source == "validation":
            self.val_rng = np.random.RandomState(seed)
        elif source == "test":
            self.test_rng = np.random.RandomState(seed)

    def _split(self, source: str):
        if source == "train":
            return self.x_train, self.y_train, self.train_rng
        if source == "validation":
            return self.x_val, self.y_val, self.val_rng
        if source == "test":
            return self.x_test, self.y_test, self.test_rng
        raise TypeError("no valid dataset type split!")

    def get_batch_indices(self, source: str, tasks_per_batch: int, shot: int):
        """Index-only episode draw: (cls [T], take [T, shot+query], shot),
        consuming the split's stream exactly as ``get_batch`` does."""
        x, _, rng = self._split(source)
        if source == "train":
            shot = int(rng.randint(3, shot + 1))
        n_cls, n_inst = x.shape[0], x.shape[1]
        cls_idx = rng.randint(0, n_cls, size=tasks_per_batch)
        take = np.stack([rng.choice(n_inst, size=shot + self.query_num,
                                    replace=False)
                         for _ in range(tasks_per_batch)])
        return cls_idx, take, shot

    def get_batch(self, source: str, tasks_per_batch: int,
                  shot: int) -> EpisodeBatch:
        x, y, _ = self._split(source)
        cls_idx, take, shot = self.get_batch_indices(source, tasks_per_batch,
                                                     shot)
        xs = x[cls_idx[:, None], take]
        ys = y[cls_idx[:, None], take] * (2.0 * np.pi)
        return make_episode(xs[:, :shot], ys[:, :shot], xs[:, shot:],
                            ys[:, shot:], max_ctx=self.max_ctx, shot=shot)
