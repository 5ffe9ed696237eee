"""Surgical Adam: per-group learning rates + densification state surgery.

Port of ``gs_tpu/models/optim.py``: the role of
``torch.optim.Adam(l, lr=0.0, eps=1e-15)`` with the reference's six
parameter groups and per-group lrs (``scene/gaussian_model.py:185-197``),
as explicit tensors rather than ``torch.optim.Adam``, because densification
edits the moments slot by slot the way the reference edits optimizer state
(``gaussian_model.py:322-444``):

  - pruned slots: moments masked out (``_prune_optimizer``)
  - new slots: zero moments (``cat_tensors_to_optimizer``)
  - opacity reset: zero moments for that group (``replace_tensor_to_optimizer``)

Numerics of torch.optim.Adam and gs_tpu: lerp-form first moment,
bias corrections through ``expm1`` in float32, denom = sqrt(v) / sqrt(bc2)
+ eps, eps = 1e-15, betas (0.9, 0.999). ``step`` is a per-group Python int
that survives surgery, like torch's per-parameter ``state["step"]``; the
bias-correction scalars are 0-d float32 CPU tensors, so a step issues no
host-device copy.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

ADAM_EPS = 1e-15
BETA1 = 0.9
BETA2 = 0.999
_LOG_BETA1 = math.log(BETA1)
_LOG_BETA2 = math.log(BETA2)
_F32 = torch.float32


class AdamState(NamedTuple):
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]
    step: dict[str, int]


def init(params: dict[str, torch.Tensor]) -> AdamState:
    return AdamState(
        mu={k: torch.zeros_like(v) for k, v in params.items()},
        nu={k: torch.zeros_like(v) for k, v in params.items()},
        step={k: 0 for k in params},
    )


def update(
    params: dict[str, torch.Tensor],
    grads: dict[str, torch.Tensor],
    state: AdamState,
    lrs: dict[str, torch.Tensor],
) -> tuple[dict[str, torch.Tensor], AdamState]:
    """One Adam step with per-group lrs; returns new tensors."""
    new_p, new_mu, new_nu, new_step = {}, {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        t = state.step[k] + 1
        # lerp form: torch's exp_avg.lerp_(grad, 1 - beta1) rounding
        mu = state.mu[k] + (1.0 - BETA1) * (g - state.mu[k])
        nu = BETA2 * state.nu[k] + (1.0 - BETA2) * (g * g)
        tf = torch.tensor(float(t), dtype=_F32)
        # bias corrections via expm1: a plain float32 1 - beta**t loses
        # ~5e-5 relative through cancellation at small t
        bc1 = -torch.expm1(tf * _LOG_BETA1)
        bc2 = -torch.expm1(tf * _LOG_BETA2)
        denom = torch.sqrt(nu) / torch.sqrt(bc2) + ADAM_EPS
        new_p[k] = p - (lrs[k] / bc1) * mu / denom
        new_mu[k], new_nu[k], new_step[k] = mu, nu, t
    return new_p, AdamState(mu=new_mu, nu=new_nu, step=new_step)


def _mask(keep: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return keep.reshape((-1,) + (1,) * (v.dim() - 1))


def mask_slots(state: AdamState, keep: torch.Tensor) -> AdamState:
    """Zero the moments of slots where ``keep`` [C] is False (prune surgery)."""
    def apply(tree):
        return {k: torch.where(_mask(keep, v), v, 0.0) for k, v in tree.items()}

    return AdamState(mu=apply(state.mu), nu=apply(state.nu), step=dict(state.step))


def reset_group(state: AdamState, name: str) -> AdamState:
    """Zero one group's moments (opacity-reset surgery, gaussian_model.py:322-335)."""
    return AdamState(
        mu={**state.mu, name: torch.zeros_like(state.mu[name])},
        nu={**state.nu, name: torch.zeros_like(state.nu[name])},
        step=dict(state.step),
    )


def grow(state: AdamState, new_capacity: int) -> AdamState:
    """Pad every moment with zeros along the capacity axis."""
    def pad(tree):
        return {k: torch.cat([v, v.new_zeros((new_capacity - v.shape[0],) + v.shape[1:])])
                for k, v in tree.items()}

    return AdamState(mu=pad(state.mu), nu=pad(state.nu), step=dict(state.step))


def group_lrs(opt_cfg, xyz_lr) -> dict[str, torch.Tensor]:
    """Per-group lrs as 0-d float32 tensors (gaussian_model.py:185-192):
    f_rest = feature_lr / 20."""
    def f32(x):
        return torch.as_tensor(x, dtype=_F32)

    return {
        "xyz": f32(xyz_lr),
        "f_dc": f32(opt_cfg.feature_lr),
        "f_rest": f32(opt_cfg.feature_lr / 20.0),
        "opacity": f32(opt_cfg.opacity_lr),
        "scaling": f32(opt_cfg.scaling_lr),
        "rotation": f32(opt_cfg.rotation_lr),
    }
