"""Masked set aggregation over padded context sets.

Context sets are padded to ``max_ctx_num`` with a boolean mask, so each op
reproduces the ragged-set math on the masked subset exactly, as
``wmfml_tpu/ops/setops.py`` does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor],
                dim: int = 1) -> torch.Tensor:
    """Mean over ``dim`` counting only mask==True rows. mask: x.shape[:-1]."""
    if mask is None:
        return x.mean(dim)
    m = mask[..., None].to(x.dtype)
    return (x * m).sum(dim) / m.sum(dim).clamp_min(1.0)


def masked_max(x: torch.Tensor, mask: Optional[torch.Tensor],
               dim: int = 1) -> torch.Tensor:
    """Max over ``dim`` on mask==True rows; 0 if the set is empty.

    ``amax`` splits the gradient evenly among tied maxima, as ``jnp.max``
    does."""
    if mask is None:
        return x.amax(dim)
    neg = torch.finfo(x.dtype).min
    out = torch.where(mask[..., None], x, torch.full_like(x, neg)).amax(dim)
    any_valid = mask.any(dim)[..., None]
    return torch.where(any_valid, out, torch.zeros_like(out))


def baco(mu: torch.Tensor, var: torch.Tensor,
         mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bayesian context aggregation with prior N(0, I):
    sigma_z = 1 / (1 + sum 1/var_i), mu_z = sigma_z * sum mu_i / var_i.
    Padded rows contribute zero precision. mu, var [T, S, D] -> [T, D] x2."""
    sigma_inv = 1.0 / var
    if mask is not None:
        sigma_inv = sigma_inv * mask[..., None].to(mu.dtype)
    sigma_z = 1.0 / (1.0 + sigma_inv.sum(1))
    mu_z = sigma_z * (sigma_inv * mu).sum(1)
    return mu_z, sigma_z
