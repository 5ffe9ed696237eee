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


def l2_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


@functools.lru_cache(maxsize=4)
def _gaussian_window(window_size: int, sigma: float) -> tuple[float, ...]:
    g = [math.exp(-((x - window_size // 2) ** 2) / (2 * sigma**2)) for x in range(window_size)]
    s = sum(g)
    return tuple(v / s for v in g)


def _blur_axis(x: torch.Tensor, win: torch.Tensor, axis: int, same: bool = True) -> torch.Tensor:
    """1-D window blur of [C, H, W] along axis 1 or 2: SAME zero padding, or
    VALID (no padding; the output is k - 1 shorter) for ``same=False``."""
    k = win.numel()
    r = k // 2
    if same:
        x = F.pad(x, (r, r, 0, 0) if axis == 2 else (0, 0, r, r))
    out_len = x.shape[axis] - (k - 1)
    acc = None
    for i in range(k):
        term = win[i] * x.narrow(axis, i, out_len)
        acc = term if acc is None else acc + term
    return acc


def _window(window_size: int, device) -> torch.Tensor:
    return torch.tensor(_gaussian_window(window_size, SSIM_SIGMA), dtype=torch.float32,
                        device=device)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = SSIM_WINDOW) -> torch.Tensor:
    """Mean SSIM over a [C, H, W] pair in [0, 1] (reference ``_ssim``)."""
    win = _window(window_size, img1.device)
    stacked = torch.cat([img1, img2, img1 * img1, img2 * img2, img1 * img2], dim=0)
    blurred = _blur_axis(_blur_axis(stacked, win, axis=1), win, axis=2)
    return torch.mean(_ssim_map(blurred, img1.shape[0]))


def _ssim_map(blurred: torch.Tensor, c: int) -> torch.Tensor:
    """SSIM per pixel from the blurred [mu1, mu2, x1^2, x2^2, x1 x2] stack."""
    mu1, mu2 = blurred[:c], blurred[c:2 * c]
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = blurred[2 * c:3 * c] - mu1_sq
    sigma2_sq = blurred[3 * c:4 * c] - mu2_sq
    sigma12 = blurred[4 * c:] - mu1_mu2
    return ((2.0 * mu1_mu2 + SSIM_C1) * (2.0 * sigma12 + SSIM_C2)) / (
        (mu1_sq + mu2_sq + SSIM_C1) * (sigma1_sq + sigma2_sq + SSIM_C2))


def photometric_loss(pred: torch.Tensor, target: torch.Tensor,
                     lambda_dssim: float) -> torch.Tensor:
    """(1 - l) * L1 + l * (1 - SSIM): reference ``train.py:103-104``."""
    return (1.0 - lambda_dssim) * l1_loss(pred, target) + lambda_dssim * (
        1.0 - ssim(pred, target))


def banded_photometric_terms(pred: torch.Tensor, target: torch.Tensor, band_lo: int,
                             band_rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Partial (L1 sum, SSIM-map sum) over image rows [band_lo, band_lo +
    band_rows) (gs_tpu ``losses.banded_photometric_terms``,
    gs_tpu/utils/losses.py:163-215).

    A row partition of :func:`photometric_loss`'s reductions: summed over a
    disjoint cover of [0, H) and divided by C*H*W, the terms give
    ``l1_loss`` and ``ssim`` back. The band takes a halo of the window's
    radius on each side (zero rows outside the image, the SAME padding of
    the full-image blur) and blurs its rows VALID; band rows past H are
    masked out of the SSIM sum (a zero pair's SSIM is 1). Each shard of a
    tile-sharded step takes the loss of its own band of the gathered image.
    """
    c, h, w = pred.shape
    halo = SSIM_WINDOW // 2
    # zero rows above and below, enough for any band_lo <= h
    pp = F.pad(pred, (0, 0, halo, halo + band_rows))
    tt = F.pad(target, (0, 0, halo, halo + band_rows))
    ps = pp.narrow(1, band_lo, band_rows + 2 * halo)
    ts = tt.narrow(1, band_lo, band_rows + 2 * halo)
    l1_sum = torch.sum(torch.abs(ps[:, halo:halo + band_rows] - ts[:, halo:halo + band_rows]))

    win = _window(SSIM_WINDOW, pred.device)
    stacked = torch.cat([ps, ts, ps * ps, ts * ts, ps * ts], dim=0)
    blurred = _blur_axis(_blur_axis(stacked, win, axis=1, same=False), win, axis=2)
    ssim_map = _ssim_map(blurred, c)
    row_valid = (band_lo + torch.arange(band_rows, device=pred.device) < h)[None, :, None]
    ssim_sum = torch.sum(torch.where(row_valid, ssim_map, 0.0))
    return l1_sum, ssim_sum
