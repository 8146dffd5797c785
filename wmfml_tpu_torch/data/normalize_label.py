"""Offline label statistics (``wmfml_tpu/data/normalize_label.py``, the
reference's ``dataset/normalize_label.py:24-68``).

Per-dimension label mean and std of a dataset stored in the reference's
``(x, y)`` pickle layout, written beside it for optional normalisation.
The main path reads neither; kept for the surface the reference ships.
The pickle is the dataset's own file, read as the loaders read it
(``data/shapenet_1d.py``).
"""

from __future__ import annotations

import os
import pickle

import numpy as np


def compute_label_stats(pkl_path: str):
    with open(pkl_path, "rb") as f:
        _, y = pickle.load(f)
    y = np.asarray(y, np.float64).reshape(-1, np.asarray(y).shape[-1])
    return y.mean(axis=0), y.std(axis=0)


def normalize_labels(pkl_path: str, out_path: str = None):
    """Write (mean, std) stats beside the dataset; return them."""
    mean, std = compute_label_stats(pkl_path)
    out_path = out_path or os.path.join(
        os.path.dirname(pkl_path), "label_stats.npz")
    np.savez(out_path, mean=mean, std=std)
    return mean, std
