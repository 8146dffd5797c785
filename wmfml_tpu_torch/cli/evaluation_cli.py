"""Statistical evaluation CLI of the port (``wmfml_tpu/cli/evaluation_cli.py``).

Usage::

    python -m wmfml_tpu_torch.cli.evaluation_cli \\
        --config cfg/evaluation/ANP_ShapeNet1D.yaml \\
        checkpoint=<run>/models/model_end_<N>.pt [key=value ...]

The loss against the context count over ctx in 1..max_ctx_num,
``val_iters`` episodes per point (``eval/evaluator.py``); writes
``{val,test}_losses.txt`` and, where matplotlib is installed,
``loss_vs_ctx_num.png`` under ``results/{mode}/{method}/...`` (``mode: eval``
in the shipped YAMLs; an empty or ``train`` mode becomes ``evaluation``,
as in the JAX package). ``checkpoint`` takes a port checkpoint or a bare
reference ``state_dict``. The data are built in eval mode, as the JAX
package builds them (``build_data(config, mode="eval")``): Distractor's
validation split then comes from its test categories and its queries are
all 36 views. Runs on ``cuda``; ``device=cpu`` runs on the CPU. Methods the
port lacks raise, as in training. Under ``torchrun`` (or with
``mesh_shape``) each sweep shards its task axis over the ranks and averages
their losses, as the JAX package's sharded ``eval_step`` does; rank 0
writes the files.
"""

from __future__ import annotations

from wmfml_tpu_torch.cli.common import (launch_rank, parse_args,
                                        set_numerics, start_mesh, stop_mesh)
from wmfml_tpu_torch.configs import Config
from wmfml_tpu_torch.data.factory import build_data
from wmfml_tpu_torch.eval.evaluator import ModelEvaluator
from wmfml_tpu_torch.models.registry import build_model
from wmfml_tpu_torch.train.steps import require_device


def build_evaluator(config: Config) -> ModelEvaluator:
    """The evaluator over eval-mode data, its checkpoint restored."""
    require_device(config.device)        # before any data is generated
    set_numerics()
    return ModelEvaluator(build_model(config), config,
                          build_data(config, mode="eval"))


def evaluate(config: Config):
    """(validation losses, test losses) over ctx = 1..max_ctx_num."""
    return build_evaluator(config).evaluate()


def main(argv=None):
    args = parse_args("statistical evaluation (PyTorch port)", argv)
    config = Config(args.config, overrides=args.overrides,
                    make_dirs=launch_rank() == 0)
    if not config.mode or config.mode == "train":
        config.mode = "evaluation"
    ctx = start_mesh(config)
    try:
        if ctx is None or ctx.active:
            return evaluate(config)
    finally:
        stop_mesh(ctx)


if __name__ == "__main__":
    main()
