"""Evaluate-and-plot CLI of the port: the one counterpart of the JAX
package's ``evaluate_and_plot_shapenet1d.py``, ``_shapenet3d.py`` and
``_distractor.py``, which differ only in their description.

Usage::

    python -m wmfml_tpu_torch.cli.eval_and_plot_cli \\
        --config cfg/evaluation/eval_and_plot/ANP_ShapeNet1D.yaml \\
        checkpoint=<run>/models/model_end_<N>.pt [key=value ...]

``val_iters`` test episodes of ``min(15, max_ctx_num)`` context rows
(``eval/plotting.py:evaluate_and_plot``): ``losses_all.txt`` and, where
matplotlib is installed, ``plots/batch_XXX.png`` under
``results/{mode}/{method}/...`` (an empty or ``train`` mode becomes
``eval_and_plot``). Runs on ``cuda``; ``device=cpu`` runs on the CPU.
"""

from __future__ import annotations

from wmfml_tpu_torch.cli.common import parse_args, set_numerics
from wmfml_tpu_torch.configs import Config
from wmfml_tpu_torch.eval.plotting import evaluate_and_plot
from wmfml_tpu_torch.train.steps import require_device


def evaluate(config: Config):
    """The test losses of the ``val_iters`` plotted episodes."""
    require_device(config.device)        # before any data is generated
    set_numerics()
    return evaluate_and_plot(config, ctx_num=min(15, config.max_ctx_num))


def main(argv=None):
    args = parse_args("evaluate and plot (PyTorch port)", argv)
    config = Config(args.config, overrides=args.overrides)
    if not config.mode or config.mode == "train":
        config.mode = "eval_and_plot"
    return evaluate(config)


if __name__ == "__main__":
    main()
