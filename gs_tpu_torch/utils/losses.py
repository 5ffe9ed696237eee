"""Training losses: L1 + windowed SSIM (port of ``gs_tpu/utils/losses.py``).

Reference ``utils/loss_utils.py:17-108``: 11x11 separable Gaussian window,
sigma 1.5, C1 = 0.01^2, C2 = 0.03^2, SAME zero padding. The training loss
is ``(1 - lambda) * L1 + lambda * (1 - SSIM)`` with lambda_dssim = 0.2
(``train.py:103-104``).

The blur is gs_tpu's default formulation: per axis, 11 statically shifted
multiply-adds over the zero-padded image, taps summed in index order, all
in float32. A convolution would do the same work, but cuDNN runs float32
convolutions in TF32 by default, which keeps about three decimal digits.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

SSIM_WINDOW = 11
SSIM_SIGMA = 1.5
SSIM_C1 = 0.01**2
SSIM_C2 = 0.03**2


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


@functools.lru_cache(maxsize=4)
def _gaussian_window(window_size: int, sigma: float) -> tuple[float, ...]:
    g = [math.exp(-((x - window_size // 2) ** 2) / (2 * sigma**2)) for x in range(window_size)]
    s = sum(g)
    return tuple(v / s for v in g)


def _blur_axis(x: torch.Tensor, win: torch.Tensor, axis: int) -> torch.Tensor:
    """SAME-zero-padded 1-D window blur of [C, H, W] along axis 1 or 2."""
    k = win.numel()
    r = k // 2
    x = F.pad(x, (r, r, 0, 0) if axis == 2 else (0, 0, r, r))
    out_len = x.shape[axis] - (k - 1)
    acc = None
    for i in range(k):
        term = win[i] * x.narrow(axis, i, out_len)
        acc = term if acc is None else acc + term
    return acc


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = SSIM_WINDOW) -> torch.Tensor:
    """Mean SSIM over a [C, H, W] pair in [0, 1] (reference ``_ssim``)."""
    win = torch.tensor(_gaussian_window(window_size, SSIM_SIGMA), dtype=torch.float32,
                       device=img1.device)
    c = img1.shape[0]
    stacked = torch.cat([img1, img2, img1 * img1, img2 * img2, img1 * img2], dim=0)
    blurred = _blur_axis(_blur_axis(stacked, win, axis=1), win, axis=2)
    mu1, mu2 = blurred[:c], blurred[c:2 * c]
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = blurred[2 * c:3 * c] - mu1_sq
    sigma2_sq = blurred[3 * c:4 * c] - mu2_sq
    sigma12 = blurred[4 * c:] - mu1_mu2
    ssim_map = ((2.0 * mu1_mu2 + SSIM_C1) * (2.0 * sigma12 + SSIM_C2)) / (
        (mu1_sq + mu2_sq + SSIM_C1) * (sigma1_sq + sigma2_sq + SSIM_C2))
    return torch.mean(ssim_map)


def photometric_loss(pred: torch.Tensor, target: torch.Tensor,
                     lambda_dssim: float) -> torch.Tensor:
    """(1 - l) * L1 + l * (1 - SSIM): reference ``train.py:103-104``."""
    return (1.0 - lambda_dssim) * l1_loss(pred, target) + lambda_dssim * (
        1.0 - ssim(pred, target))
