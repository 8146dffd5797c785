"""Model output contract, as in ``wmfml_tpu/models/base.py``.

``ModelOutput(mu, var, kl, extras)``: mu [T, Q, Dy] predicted means, var
the predicted variance or None, kl a scalar (0.0 outside the MR models),
extras a dict of auxiliary tensors.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional


class ModelOutput(NamedTuple):
    mu: Any
    var: Optional[Any] = None
    kl: Any = 0.0
    extras: Dict[str, Any] = {}
