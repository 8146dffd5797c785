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
                          prediction's two signs, train and test alike;
  * NT-Xent (``nt_xent``, ``contrastive_loss``, ``contrastive_loss_anp``)
                          for the FCL methods, with the JAX package's
                          numerics (``wmfml_tpu/losses/losses.py:90-146``).

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


# --- contrastive (NT-Xent), pytorch_metric_learning's NTXentLoss ------------


def nt_xent(z: torch.Tensor, labels: torch.Tensor,
            temperature: float = 0.07) -> torch.Tensor:
    """NT-Xent over embeddings ``z`` [N, D] with integer ``labels`` [N]:
    cosine similarity over ``temperature``; for each ordered positive pair
    (a, p) -log(exp(s_ap) / (exp(s_ap) + sum_n exp(s_an))), n over the
    rows of another label than a; the mean over the positive pairs.

    The JAX package's numerics, each of which keeps saturated embeddings
    at t = 0.007 (|s| up to 1 / t ~ 143) finite, forward and backward: the
    squared norm is clamped before the sqrt (a zero row has no infinite
    derivative); excluded entries are set to -inf before the exp (their
    exp and its gradient are 0); every pair is shifted by
    m = max(max over its row's negatives, s_ap)."""
    n = z.shape[0]
    z = z / torch.sqrt(torch.clamp((z * z).sum(-1, keepdim=True), min=1e-24))
    sim = (z @ z.T) / temperature                            # [N, N]
    same = labels[:, None] == labels[None, :]
    eye = torch.eye(n, dtype=torch.bool, device=z.device)
    pos_mask = same & ~eye                                   # ordered pairs
    neg_sim = torch.where(~same, sim, float("-inf"))
    neg_max = neg_sim.amax(1, keepdim=True)
    neg_max = torch.where(torch.isfinite(neg_max), neg_max, 0.0)
    neg_sum = torch.exp(neg_sim - neg_max).sum(1, keepdim=True)
    m = torch.maximum(neg_max, sim)
    per_pair = -(sim - m) + torch.log(torch.exp(sim - m)
                                      + neg_sum * torch.exp(neg_max - m))
    num_pos = torch.clamp(pos_mask.sum(), min=1)
    return torch.where(pos_mask, per_pair, 0.0).sum() / num_pos


def contrastive_loss(z1: torch.Tensor, z2: torch.Tensor,
                     t: float = 0.07) -> torch.Tensor:
    """Two-view NT-Xent: z1[i] and z2[i] are views of one instance."""
    labels = torch.cat([torch.arange(z1.shape[0], device=z1.device),
                        torch.arange(z2.shape[0], device=z2.device)])
    return nt_xent(torch.cat([z1, z2]), labels, temperature=t)


def contrastive_loss_anp(z: torch.Tensor, t: float = 0.07) -> torch.Tensor:
    """Per-task NT-Xent over query representations z [T, Q, D]: a task's
    queries are one another's positives."""
    tasks, q, d = z.shape
    labels = torch.arange(tasks, device=z.device).repeat_interleave(q)
    return nt_xent(z.reshape(tasks * q, d), labels, temperature=t)


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

    # the reference's surface (``wmfml_tpu/losses/losses.py:177-178``)
    contrastive_loss = staticmethod(contrastive_loss)
    contrastive_loss_ANP = staticmethod(contrastive_loss_anp)
