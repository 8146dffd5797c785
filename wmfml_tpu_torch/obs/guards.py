"""Non-finite loss guard: the reference aborts the run on a NaN/Inf loss;
here a typed exception, which the train CLI turns into exit code 1."""

from __future__ import annotations

import math


class NonFiniteLossError(RuntimeError):
    pass


def check_finite(loss, step: int, logger=None) -> float:
    """Return the loss as a host float; raise NonFiniteLossError if NaN/Inf."""
    loss = float(loss)
    if not math.isfinite(loss):
        msg = f"Loss is NaN or Inf at iteration {step}: {loss}"
        if logger is not None:
            logger.error(msg)
        raise NonFiniteLossError(msg)
    return loss
