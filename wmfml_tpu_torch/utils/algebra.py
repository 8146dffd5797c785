"""Small algebra helpers (``wmfml_tpu/utils/algebra.py``, the reference's
``utils/algebra.py:22-34``)."""

from __future__ import annotations

import numpy as np


def mean_std(values):
    """Mean and (population) std of a sequence."""
    a = np.asarray(values, dtype=np.float64)
    return float(a.mean()), float(a.std())


def line_equation(p1, p2):
    """Slope and intercept of the line through two 2-D points: (m, b) with
    y = m x + b; a vertical line gives (inf, x0)."""
    (x1, y1), (x2, y2) = p1, p2
    if x2 == x1:
        return float("inf"), float(x1)
    m = (y2 - y1) / (x2 - x1)
    return float(m), float(y1 - m * x1)


def point_on_line(m, b, x):
    return m * x + b
