"""Learning-rate schedules (port of ``gs_tpu/utils/schedules.py``).

Log-linear interpolation from lr_init to lr_final over max_steps, with an
optional sine-eased delay multiplier for the first lr_delay_steps
(reference ``utils/general_utils.py:30-69``). Values are 0-d float32 CPU
tensors computed in float32 as gs_tpu computes them; a CUDA tensor takes
such a scalar in an operation without a copy or a sync.
"""

from __future__ import annotations

import math

import torch

_F32 = torch.float32


def expon_lr(
    step,
    lr_init: float,
    lr_final: float,
    lr_delay_steps: int = 0,
    lr_delay_mult: float = 1.0,
    max_steps: int = 1_000_000,
) -> torch.Tensor:
    """``get_expon_lr_func`` evaluated at ``step`` (an int or a 0-d tensor)."""
    step = torch.as_tensor(step, dtype=_F32, device="cpu")
    if lr_init == 0.0 and lr_final == 0.0:
        return torch.zeros_like(step)
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1.0 - lr_delay_mult) * torch.sin(
            0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0.0, 1.0))
    else:
        delay_rate = 1.0
    t = torch.clamp(step / max_steps, 0.0, 1.0)
    log_lerp = torch.exp(torch.log(torch.tensor(lr_init, dtype=_F32)) * (1.0 - t)
                         + torch.log(torch.tensor(lr_final, dtype=_F32)) * t)
    return torch.where(step < 0, 0.0, delay_rate * log_lerp)


def xyz_lr(step, opt_cfg, spatial_lr_scale: float) -> torch.Tensor:
    """The position-lr schedule wired in ``gaussian_model.py:200-205``."""
    return expon_lr(
        step,
        lr_init=opt_cfg.position_lr_init * spatial_lr_scale,
        lr_final=opt_cfg.position_lr_final * spatial_lr_scale,
        lr_delay_mult=opt_cfg.position_lr_delay_mult,
        max_steps=opt_cfg.position_lr_max_steps,
    )
