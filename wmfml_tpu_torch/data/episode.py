"""Episode batch: the dict every trainer step and evaluator consumes.

Context sets are padded to ``max_ctx_num`` and carry a boolean ``ctx_mask``
(True = real context row), so every step has one shape whatever the shot.
Padding repeats context row 0, exactly as the JAX package does: padded keys
still enter FAVOR's global key max, so what they hold matters.

Layout: images channel-last [T, N, H, W, C], uint8 where the source is.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

# keys: ctx_x [T, S, H, W, C], ctx_y [T, S, Dy] f32, ctx_mask [T, S] bool,
#       qry_x [T, Q, H, W, C], qry_y [T, Q, Dy] f32
EpisodeBatch = Dict[str, np.ndarray]


def make_episode(ctx_x, ctx_y, qry_x, qry_y, max_ctx: Optional[int] = None,
                 shot: Optional[int] = None) -> EpisodeBatch:
    """Assemble an episode, padding context to ``max_ctx`` with a mask."""
    t, s_actual = ctx_x.shape[0], ctx_x.shape[1]
    if shot is None:
        shot = s_actual
    if max_ctx is not None and s_actual != max_ctx:
        if s_actual > max_ctx:
            raise ValueError(f"{s_actual} context rows > max_ctx {max_ctx}")
        pad = max_ctx - s_actual
        ctx_x = np.concatenate(
            [ctx_x, np.repeat(ctx_x[:, :1], pad, axis=1)], axis=1)
        ctx_y = np.concatenate(
            [ctx_y, np.repeat(ctx_y[:, :1], pad, axis=1)], axis=1)
    mask = np.zeros((t, ctx_x.shape[1]), dtype=bool)
    mask[:, :shot] = True
    return dict(ctx_x=ctx_x, ctx_y=np.asarray(ctx_y, np.float32),
                ctx_mask=mask, qry_x=qry_x,
                qry_y=np.asarray(qry_y, np.float32))
