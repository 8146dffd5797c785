"""Single-task refinement CLI of the port (``wmfml_tpu/cli/refinement_cli.py``).

Usage::

    python -m wmfml_tpu_torch.cli.refinement_cli \\
        --config cfg/refinement/Refine_DA_ShapeNet1D.yaml \\
        checkpoint=<run>/models/model_end_<N>.pt [key=value ...]

For each context count 1..``max_ctx_num``: one frozen test task
(``data/refinement.py:RefinementSampler``, seed 42, over the eval-mode
data), ``query_num`` set to its query count, a model built from ``seed``
and restored from ``checkpoint`` anew, and an evaluator's ``refine()``
(``eval/evaluator.py``); then ``loss_vs_ctx.txt``, the best test loss of
each count (``%1.4f``), under ``results/{mode}/{method}/...`` (``mode:
refinement`` in the shipped YAMLs; an empty or ``train`` mode becomes
``refinement``). Every count starts from the same weights and the same
optimizer state, as each JAX evaluator re-initialises and restores them: a
port model keeps its refined weights, so none is reused across counts.
Runs on ``cuda``; ``device=cpu`` runs on the CPU.
"""

from __future__ import annotations

import numpy as np

from wmfml_tpu_torch.cli.common import parse_args, set_numerics
from wmfml_tpu_torch.configs import Config
from wmfml_tpu_torch.data.factory import build_data
from wmfml_tpu_torch.data.refinement import RefinementSampler
from wmfml_tpu_torch.eval.evaluator import ModelEvaluator
from wmfml_tpu_torch.models.registry import build_model
from wmfml_tpu_torch.train.steps import require_device


def refine(config: Config):
    """The best test loss of each context count 1..max_ctx_num."""
    require_device(config.device)        # before any data is generated
    set_numerics()
    base = build_data(config, mode="eval")
    best_per_ctx = []
    for ctx_num in range(1, config.max_ctx_num + 1):
        data = RefinementSampler(base, ctx_num=ctx_num, seed=42, source="test")
        config.query_num = data.task_qry_x.shape[0]
        evaluator = ModelEvaluator(build_model(config), config, data)
        best, step = evaluator.refine()
        config.logger.info(
            f"ctx_num={ctx_num}: best test loss {best:.4f} at iter {step}")
        best_per_ctx.append(best)
    np.savetxt(f"{config.save_path}/loss_vs_ctx.txt",
               np.asarray(best_per_ctx), fmt="%1.4f")
    return best_per_ctx


def main(argv=None):
    args = parse_args("single-task refinement (PyTorch port)", argv)
    config = Config(args.config, overrides=args.overrides)
    if not config.mode or config.mode == "train":
        config.mode = "refinement"
    return refine(config)


if __name__ == "__main__":
    main()
