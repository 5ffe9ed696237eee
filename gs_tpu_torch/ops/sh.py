"""Real spherical-harmonics evaluation for view-dependent Gaussian color.

Port of ``gs_tpu/ops/sh.py``: degrees 0..4, PlenOctree constants
(``utils/sh_utils.py:26-118`` of the reference). A model of degree 4
(``--sh_degree 4``: 24 rest coefficients a channel, 72 ``f_rest_*`` PLY
fields) renders and trains at every active degree up to its own.
"""

from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)
C4 = (
    2.5033429417967046,
    -1.7701307697799304,
    0.9461746957575601,
    -0.6690465435572892,
    0.10578554691520431,
    -0.6690465435572892,
    0.47308734787878004,
    -1.7701307697799304,
    0.6258357354491761,
)
MAX_DEGREE = 4


def num_sh_coeffs(degree: int) -> int:
    return (degree + 1) ** 2


def _check_degree(deg: int) -> None:
    if not 0 <= deg <= MAX_DEGREE:
        raise ValueError(f"sh degree must be in [0, {MAX_DEGREE}], got {deg}")


def eval_sh_basis(deg: int, dirs: torch.Tensor) -> list[torch.Tensor]:
    """The (deg+1)^2 real SH basis polynomials at ``dirs`` [..., 3], each [..., 1]."""
    _check_degree(deg)
    one = torch.ones_like(dirs[..., 0:1])
    basis = [C0 * one]
    if deg > 0:
        x = dirs[..., 0:1]
        y = dirs[..., 1:2]
        z = dirs[..., 2:3]
        basis += [-C1 * y, C1 * z, -C1 * x]
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            basis += [
                C2[0] * xy,
                C2[1] * yz,
                C2[2] * (2.0 * zz - xx - yy),
                C2[3] * xz,
                C2[4] * (xx - yy),
            ]
            if deg > 2:
                basis += [
                    C3[0] * y * (3.0 * xx - yy),
                    C3[1] * xy * z,
                    C3[2] * y * (4.0 * zz - xx - yy),
                    C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
                    C3[4] * x * (4.0 * zz - xx - yy),
                    C3[5] * z * (xx - yy),
                    C3[6] * x * (xx - 3.0 * yy),
                ]
                if deg > 3:
                    basis += [
                        C4[0] * xy * (xx - yy),
                        C4[1] * yz * (3.0 * xx - yy),
                        C4[2] * xy * (7.0 * zz - 1.0),
                        C4[3] * yz * (7.0 * zz - 3.0),
                        C4[4] * (zz * (35.0 * zz - 30.0) + 3.0),
                        C4[5] * xz * (7.0 * zz - 3.0),
                        C4[6] * (xx - yy) * (7.0 * zz - 1.0),
                        C4[7] * xz * (xx - 3.0 * yy),
                        C4[8] * (xx * (xx - 3.0 * yy) - yy * (3.0 * xx - yy)),
                    ]
    return basis


def eval_sh(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Evaluate SH at unit directions.

    ``sh`` [..., C, K] with K >= (deg+1)^2; ``dirs`` [..., 3]. Returns
    [..., C] (before the +0.5 shift; callers clamp ``result + 0.5`` at 0).
    """
    _check_degree(deg)
    if sh.shape[-1] < num_sh_coeffs(deg):
        raise ValueError(f"sh has {sh.shape[-1]} coeffs; degree {deg} needs {num_sh_coeffs(deg)}")

    result = C0 * sh[..., 0]
    if deg > 0:
        x = dirs[..., 0:1]
        y = dirs[..., 1:2]
        z = dirs[..., 2:3]
        result = result - C1 * y * sh[..., 1] + C1 * z * sh[..., 2] - C1 * x * sh[..., 3]
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (
                result
                + C2[0] * xy * sh[..., 4]
                + C2[1] * yz * sh[..., 5]
                + C2[2] * (2.0 * zz - xx - yy) * sh[..., 6]
                + C2[3] * xz * sh[..., 7]
                + C2[4] * (xx - yy) * sh[..., 8]
            )
            if deg > 2:
                result = (
                    result
                    + C3[0] * y * (3.0 * xx - yy) * sh[..., 9]
                    + C3[1] * xy * z * sh[..., 10]
                    + C3[2] * y * (4.0 * zz - xx - yy) * sh[..., 11]
                    + C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * sh[..., 12]
                    + C3[4] * x * (4.0 * zz - xx - yy) * sh[..., 13]
                    + C3[5] * z * (xx - yy) * sh[..., 14]
                    + C3[6] * x * (xx - 3.0 * yy) * sh[..., 15]
                )
                if deg > 3:
                    result = (
                        result
                        + C4[0] * xy * (xx - yy) * sh[..., 16]
                        + C4[1] * yz * (3.0 * xx - yy) * sh[..., 17]
                        + C4[2] * xy * (7.0 * zz - 1.0) * sh[..., 18]
                        + C4[3] * yz * (7.0 * zz - 3.0) * sh[..., 19]
                        + C4[4] * (zz * (35.0 * zz - 30.0) + 3.0) * sh[..., 20]
                        + C4[5] * xz * (7.0 * zz - 3.0) * sh[..., 21]
                        + C4[6] * (xx - yy) * (7.0 * zz - 1.0) * sh[..., 22]
                        + C4[7] * xz * (xx - 3.0 * yy) * sh[..., 23]
                        + C4[8] * (xx * (xx - 3.0 * yy) - yy * (3.0 * xx - yy)) * sh[..., 24]
                    )
    return result


def rgb_to_sh(rgb: torch.Tensor) -> torch.Tensor:
    """Inverse of the degree-0 SH band (reference ``utils/sh_utils.py:114-115``)."""
    return (rgb - 0.5) / C0


def sh_to_rgb(sh: torch.Tensor) -> torch.Tensor:
    return sh * C0 + 0.5
