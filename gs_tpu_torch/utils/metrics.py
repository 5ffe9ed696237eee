"""Image quality metrics: PSNR (port of ``gs_tpu/utils/metrics.py``).

Reference ``utils/image_utils.py:14-19``: per-image MSE over flattened
pixels, PSNR = 20 log10(1 / sqrt(mse)).
"""

from __future__ import annotations

import torch


def mse(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    flat1 = img1.reshape(img1.shape[0], -1) if img1.dim() > 3 else img1.reshape(1, -1)
    flat2 = img2.reshape(img2.shape[0], -1) if img2.dim() > 3 else img2.reshape(1, -1)
    return torch.mean((flat1 - flat2) ** 2, dim=1, keepdim=True)


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """[(B,) 3, H, W] pair in [0, 1] -> per-image PSNR [B, 1] (or [1, 1])."""
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse(img1, img2)))
