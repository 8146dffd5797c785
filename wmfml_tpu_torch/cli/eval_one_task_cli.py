"""Single-task evaluation CLI of the port
(``wmfml_tpu/cli/eval_one_task_cli.py``).

Usage::

    python -m wmfml_tpu_torch.cli.eval_one_task_cli \\
        --config cfg/evaluation/eval_one_task/ANP_ShapeNet1D.yaml \\
        checkpoint=<run>/models/model_end_<N>.pt [key=value ...]

A trained model on ONE frozen test task (``data/refinement.py:
RefinementSampler`` with ``max_ctx_num`` context rows, seed 42), the
test sweep over ctx 1..``max_ctx_num`` (``eval/evaluator.py:
evaluate_one_task``), to set against refinement: ``test_losses.txt``
(index, loss, std) under ``results/{mode}/{method}/...`` (an empty or
``train`` mode becomes ``eval_one_task``). The sampler ignores the point's
context count, so every point scores the same batch and the curve is flat,
as the JAX package's is. Runs on ``cuda``; ``device=cpu`` runs on the CPU.
"""

from __future__ import annotations

from wmfml_tpu_torch.cli.common import parse_args, set_numerics
from wmfml_tpu_torch.configs import Config
from wmfml_tpu_torch.data.factory import build_data
from wmfml_tpu_torch.data.refinement import RefinementSampler
from wmfml_tpu_torch.eval.evaluator import ModelEvaluator
from wmfml_tpu_torch.models.registry import build_model
from wmfml_tpu_torch.train.steps import require_device


def evaluate(config: Config):
    """The test losses over ctx = 1..max_ctx_num on the frozen task."""
    require_device(config.device)        # before any data is generated
    set_numerics()
    data = RefinementSampler(build_data(config, mode="eval"),
                             ctx_num=config.max_ctx_num, seed=42,
                             source="test")
    config.query_num = data.task_qry_x.shape[0]
    return ModelEvaluator(build_model(config), config,
                          data).evaluate_one_task()


def main(argv=None):
    args = parse_args("single-task evaluation (PyTorch port)", argv)
    config = Config(args.config, overrides=args.overrides)
    if not config.mode or config.mode == "train":
        config.mode = "eval_one_task"
    return evaluate(config)


if __name__ == "__main__":
    main()
