"""Qualitative evaluation: query images with their true and predicted
labels (``wmfml_tpu/eval/plotting.py``), the function behind the three
``evaluate_and_plot_*`` scripts.

``evaluate_and_plot(config, ctx_num)`` builds the data in eval mode (the
Distractor test split cut to category ``04530566``, as the reference's
distractor script does), restores ``config.checkpoint`` through the
evaluator, reseeds the test stream to 42 and scores ``val_iters`` test
episodes of ``ctx_num`` context rows with the test metric
(``LossFunc(..., test=True)``: degrees, pixels or the quaternion L1). It
writes the per-episode losses to ``losses_all.txt`` (``%1.4f``) and, where
matplotlib is installed, ``plots/batch_XXX.png``: the processed query
images of the episode's first task, titled with the true and predicted
azimuth (ShapeNet1D, from [cos, sin]), the ZYX Euler angles
(ShapeNet3D, ``utils/quaternion.py:quat_to_euler_zyx``) or marked with both
centres (Distractor). Without matplotlib it logs that no plot was written.
A Bayes-by-Backprop model draws episode ``i``'s weights from a generator
seeded with ``seed + i`` (the JAX function's ``fold_in(base_key, i)``).
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from wmfml_tpu_torch.aug.pipeline import build_episode_processor
from wmfml_tpu_torch.configs.config import torch_dtype
from wmfml_tpu_torch.data.factory import build_data
from wmfml_tpu_torch.eval.evaluator import ModelEvaluator
from wmfml_tpu_torch.losses.losses import LossFunc
from wmfml_tpu_torch.models.registry import build_model
from wmfml_tpu_torch.train.trainer import episode_to_device
from wmfml_tpu_torch.utils.quaternion import quat_to_euler_zyx


def _angle_deg_from_sincos(cos_v, sin_v):
    base = np.arccos(np.clip(cos_v, -1.0, 1.0))
    return np.rad2deg(np.where(sin_v >= 0, base, 2.0 * math.pi - base))


def plot_queries(task: str, images, gt_y, pr_y, out_dir: str,
                 batch_idx: int) -> bool:
    """``plots/batch_{batch_idx:03d}.png`` of the first task's first 8
    queries (numpy [T, Q, H, W, C] images, [T, Q, Dy] labels); False, and
    nothing written, where matplotlib is missing."""
    try:
        import matplotlib
    except ImportError:
        return False
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    t = 0
    n = min(images.shape[1], 8)
    fig, axes = plt.subplots(1, n, figsize=(2.2 * n, 2.8))
    if n == 1:
        axes = [axes]
    for i in range(n):
        img = images[t, i]
        if img.shape[-1] == 1:
            axes[i].imshow(1.0 - img[..., 0], cmap="gray")
        else:
            axes[i].imshow(np.clip(img[..., :3], 0, 1))
        axes[i].axis("off")
        if task == "shapenet_1d":
            gt = np.rad2deg(gt_y[t, i, -1])
            pr = _angle_deg_from_sincos(pr_y[t, i, 0], pr_y[t, i, 1])
            axes[i].set_title(f"gt {gt:.0f}\npr {pr:.0f}", fontsize=8)
        elif task == "shapenet_3d":
            gt_e = quat_to_euler_zyx(torch.from_numpy(gt_y[t, i])).numpy()
            q = pr_y[t, i] / max(np.linalg.norm(pr_y[t, i]), 1e-8)
            pr_e = quat_to_euler_zyx(torch.from_numpy(q)).numpy()
            axes[i].set_title(
                f"gt {gt_e[0]:.0f}/{gt_e[2]:.0f}\npr {pr_e[0]:.0f}/{pr_e[2]:.0f}",
                fontsize=8)
        elif task == "distractor":
            axes[i].scatter([gt_y[t, i, 0]], [gt_y[t, i, 1]], c="lime", s=14,
                            label="gt")
            axes[i].scatter([pr_y[t, i, 0]], [pr_y[t, i, 1]], c="red", s=14,
                            label="pred")
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, f"batch_{batch_idx:03d}.png"), dpi=110)
    plt.close(fig)
    return True


def evaluate_and_plot(config, ctx_num: int = 15):
    """The ``val_iters`` test losses; writes ``losses_all.txt`` and the
    plots."""
    test_categ = ["04530566"] if config.task == "distractor" else None
    data = build_data(config, mode="eval", test_categ=test_categ)
    config.query_num = getattr(data, "query_num", config.query_num)
    evaluator = ModelEvaluator(build_model(config), config, data)
    model, device = evaluator.model.eval(), evaluator.device
    process = build_episode_processor(config.task, [], train=False,
                                      dtype=torch_dtype(config))
    loss_func = LossFunc(config.loss_type, config.task)
    out_dir = os.path.join(config.save_path, "plots")
    losses, plotted = [], 0
    data.reset_eval("test", 42)
    with torch.no_grad():
        for i in range(config.val_iters):
            pbatch = process(episode_to_device(data.get_batch(
                "test", config.tasks_per_batch, ctx_num), device))
            evaluator.generator.manual_seed(int(config.seed) + i)
            out = model(pbatch["ctx_x"], pbatch["ctx_y"], pbatch["qry_x"],
                        ctx_mask=pbatch["ctx_mask"],
                        generator=evaluator.generator)
            mu = out.mu.float()
            losses.append(float(loss_func.calc_loss(mu, out.var,
                                                    pbatch["qry_y"],
                                                    test=True)))
            plotted += plot_queries(
                config.task, pbatch["qry_x"].float().cpu().numpy(),
                pbatch["qry_y"].cpu().numpy(), mu.cpu().numpy(), out_dir, i)
    np.savetxt(os.path.join(config.save_path, "losses_all.txt"),
               np.asarray(losses), fmt="%1.4f")
    if not plotted:
        config.logger.info("matplotlib is not installed: no plots written")
    config.logger.info(
        f"mean test loss over {len(losses)} batches: {np.mean(losses):.4f}")
    return losses
