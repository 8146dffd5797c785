"""Task losses and metrics for the ported tasks (``wmfml_tpu/losses/losses.py``).

  * shapenet_1d (train) — sum of squares over [cos, sin], mean over the set;
  * shapenet_1d (test)  — mean angular error in degrees, min over +-360
                          wraps, acos decode with the sin branch, computed
                          in float32 whatever the model's dtype;
  * pascal_1d           — plain MSE;
  * distractor          — mean Euclidean distance in pixels, train and
                          test alike;
  * shapenet_3d         — L1 between the label quaternion and the unit-
                          normalised prediction, the smaller over the
                          prediction's two signs, train and test alike.

As in the JAX package, ``degree_loss`` clips cos into [-1, 1] before acos.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def _masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return x.mean()
    mask = torch.broadcast_to(mask, x.shape).to(x.dtype)
    return (x * mask).sum() / mask.sum().clamp_min(1.0)


def azimuth_loss(q_gt, q_pr, mask=None):
    se = ((q_gt[..., :2] - q_pr) ** 2).sum(-1)
    return _masked_mean(se, mask)


def degree_loss(q_gt, q_pr, mask=None):
    q_gt, q_pr = q_gt.float(), q_pr.float()
    gt_deg = torch.rad2deg(q_gt[..., -1])
    base = torch.arccos(q_pr[..., 0].clamp(-1.0, 1.0))
    pr_rad = torch.where(q_pr[..., 1] >= 0, base, 2.0 * math.pi - base)
    pr_deg = torch.rad2deg(pr_rad)
    errors = torch.stack([(gt_deg - pr_deg).abs(),
                          (gt_deg + 360.0 - pr_deg).abs(),
                          (gt_deg - (pr_deg + 360.0)).abs()], -1)
    return _masked_mean(errors.amin(-1), mask)


def euclidean_distance_loss(gt_y, pr_mu, mask=None):
    """Mean Euclidean distance (pixels). ``sqrt`` as the JAX package takes
    it, with no epsilon: at a zero distance its gradient is not finite
    there either."""
    d = torch.sqrt(((gt_y - pr_mu) ** 2).sum(-1))
    return _masked_mean(d, mask)


def quaternion_loss(q_gt, q_pr, mask=None, eps: float = 1e-12):
    """L1 between ``q_gt`` and ``q_pr`` / max(|q_pr|, eps), min over the
    antipodes."""
    norm = torch.sqrt((q_pr ** 2).sum(-1, keepdim=True))
    q_pr = q_pr / norm.clamp_min(eps)
    pos = (q_gt - q_pr).abs().sum(-1)
    neg = (-q_gt - q_pr).abs().sum(-1)
    return _masked_mean(torch.minimum(pos, neg), mask)


def mean_square_loss(q_gt, q_pr, mask=None):
    se = (q_gt - q_pr) ** 2
    return _masked_mean(se, None if mask is None else mask[..., None])


class LossFunc:
    """Task-dispatch loss, API-compatible with the reference's LossFunc."""

    def __init__(self, loss_type: str, task: str):
        if loss_type != "mse":
            raise NotImplementedError(
                f"loss_type={loss_type!r}: only 'mse' is implemented")
        if task not in ("shapenet_1d", "pascal_1d", "distractor",
                        "shapenet_3d"):
            raise NotImplementedError(
                f"task {task!r} has no loss, in the JAX package either")
        self.task = task

    def calc_loss(self, pr_mu, pr_var, gt_y, test: bool = False, mask=None):
        del pr_var
        if self.task == "distractor":
            return euclidean_distance_loss(gt_y, pr_mu, mask)
        if self.task == "shapenet_3d":
            return quaternion_loss(gt_y, pr_mu, mask)
        if self.task == "shapenet_1d":
            return (degree_loss(gt_y, pr_mu, mask) if test
                    else azimuth_loss(gt_y, pr_mu, mask))
        return mean_square_loss(gt_y, pr_mu, mask)
