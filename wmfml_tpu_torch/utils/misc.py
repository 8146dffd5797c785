"""Small helpers shared across the port (``wmfml_tpu/utils/misc.py``)."""

from __future__ import annotations

import numpy as np


def convert_index_to_angle(index, num_instances_per_item):
    """Index of a view -> (angle in degrees, sin, cos) (the reference's
    ``utils/utils.py:69-79``)."""
    degrees_per_increment = 360.0 / num_instances_per_item
    angle = index * degrees_per_increment
    angle_radians = np.deg2rad(angle)
    return angle, np.sin(angle_radians), np.cos(angle_radians)


def shuffle_batch(*arrays, rng=None):
    """Shuffle arrays by one permutation of axis 0 (``utils/utils.py:
    61-66``)."""
    rng = rng or np.random
    perm = rng.permutation(arrays[0].shape[0])
    out = tuple(a[perm] for a in arrays)
    return out[0] if len(out) == 1 else out


def compute_accuracy(logits, targets):
    """Argmax accuracy (``utils/utils.py:82-87``; the regression path does
    not use it)."""
    preds = np.argmax(np.asarray(logits), axis=1)
    return float(np.mean(preds == np.asarray(targets)))


def mean_confidence_interval(values, confidence: float = 0.95):
    """Mean and half-width of the normal-approximation interval
    (``trainer/mmaml_trainer.py:142-147``): z = 1.96 at 95 %, scipy's
    normal quantile otherwise."""
    a = np.asarray(values, dtype=np.float64)
    n = len(a)
    m = a.mean()
    if n <= 1:
        return float(m), 0.0
    se = a.std(ddof=1) / np.sqrt(n)
    if abs(confidence - 0.95) < 1e-9:
        z = 1.96
    else:
        from scipy.stats import norm
        z = float(norm.ppf(0.5 + confidence / 2.0))
    return float(m), float(z * se)
