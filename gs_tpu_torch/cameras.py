"""Camera model: a dataclass of tensors + numpy matrix builders.

Port of ``gs_tpu/cameras.py``. Same conventions (reference / COLMAP):

- ``R`` is the camera-to-world rotation, ``T`` the world-to-camera
  translation, as produced by the data readers.
- view matrix ``W``: ``p_cam = W @ [p_world, 1]``; the camera looks down +z.
- projection ``P`` maps camera space to clip space with z in [0, 1] after
  the perspective divide; clip w = z_cam.

Matrices are column-vector convention (``p' = M @ p``). The per-camera
scalars (``tan_fovx`` ...) are 0-d float32 tensors, so the projection's
arithmetic on them rounds in float32 exactly as gs_tpu's does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from gs_tpu_torch.device import resolve_device

DEFAULT_ZNEAR = 0.01  # scene/cameras.py:96
DEFAULT_ZFAR = 100.0  # scene/cameras.py:95


def fov_to_focal(fov: float, pixels: float) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


def focal_to_fov(focal: float, pixels: float) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


def make_view_matrix(
    R: np.ndarray,
    T: np.ndarray,
    translate: np.ndarray | None = None,
    scale: float = 1.0,
) -> np.ndarray:
    """World-to-camera 4x4 with optional scene recentering/rescaling
    (``getWorld2View2``, reference ``utils/graphics_utils.py:49-87``)."""
    R = np.asarray(R, dtype=np.float64)
    T = np.asarray(T, dtype=np.float64)
    w2c = np.eye(4, dtype=np.float64)
    w2c[:3, :3] = R.T
    w2c[:3, 3] = T
    if translate is not None or scale != 1.0:
        translate = np.zeros(3) if translate is None else np.asarray(translate, dtype=np.float64)
        c2w = np.linalg.inv(w2c)
        c2w[:3, 3] = (c2w[:3, 3] + translate) * scale
        w2c = np.linalg.inv(c2w)
    return w2c.astype(np.float32)


def make_projection_matrix(znear: float, zfar: float, fovx: float, fovy: float) -> np.ndarray:
    """Symmetric perspective projection, z mapped to [0,1] after the divide
    (``getProjectionMatrix``, reference ``utils/graphics_utils.py:97-133``)."""
    tan_x = math.tan(fovx / 2.0)
    tan_y = math.tan(fovy / 2.0)
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 1.0 / tan_x
    P[1, 1] = 1.0 / tan_y
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    P[3, 2] = 1.0
    return P


@dataclass
class Camera:
    """A renderable viewpoint: tensors on one device + image dimensions.

    ``image`` (ground truth, [3,H,W] in [0,1]) is optional; rendering never
    touches it.
    """

    view: torch.Tensor  # [4,4] world->camera
    full_proj: torch.Tensor  # [4,4] world->clip (P @ W)
    cam_pos: torch.Tensor  # [3] camera center in world space
    tan_fovx: torch.Tensor  # 0-d float32
    tan_fovy: torch.Tensor  # 0-d float32
    width: int
    height: int
    znear: torch.Tensor  # 0-d float32
    zfar: torch.Tensor  # 0-d float32
    image: torch.Tensor | None = None

    @property
    def device(self) -> torch.device:
        return self.view.device

    @property
    def focal_x(self) -> torch.Tensor:
        return self.width / (2.0 * self.tan_fovx)

    @property
    def focal_y(self) -> torch.Tensor:
        return self.height / (2.0 * self.tan_fovy)


def _f32(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(device)


def camera_from_arrays(
    view: np.ndarray,
    full_proj: np.ndarray,
    cam_pos: np.ndarray,
    tan_fovx: float,
    tan_fovy: float,
    width: int,
    height: int,
    *,
    znear: float = DEFAULT_ZNEAR,
    zfar: float = DEFAULT_ZFAR,
    image: np.ndarray | None = None,
    device: str | torch.device = "cuda",
    data_device: str | None = None,
) -> Camera:
    """A :class:`Camera` from numpy matrices and float32 scalars.

    ``data_device`` is the reference's ``--data_device`` staging policy for
    the ground-truth image (gs_tpu ``cameras.py:114-158``): ``"cpu"`` keeps
    it on the CPU, and ``training.run_training`` moves it to the run's
    device when it uses it (the reference's ``.cuda()`` in ``train.py``);
    any other value (None, ``"cuda"``, gs_tpu's ``"tpu"`` from an old
    ``cfg_args``) stages it on ``device``."""
    dev = resolve_device(device)
    image_dev = torch.device("cpu") if data_device == "cpu" else dev
    return Camera(
        view=_f32(view, dev),
        full_proj=_f32(full_proj, dev),
        cam_pos=_f32(cam_pos, dev),
        tan_fovx=_f32(tan_fovx, dev),
        tan_fovy=_f32(tan_fovy, dev),
        width=int(width),
        height=int(height),
        znear=_f32(znear, dev),
        zfar=_f32(zfar, dev),
        image=None if image is None else _f32(image, image_dev),
    )


def make_camera(
    R: np.ndarray,
    T: np.ndarray,
    fovx: float,
    fovy: float,
    width: int,
    height: int,
    image: np.ndarray | None = None,
    translate: np.ndarray | None = None,
    scale: float = 1.0,
    znear: float = DEFAULT_ZNEAR,
    zfar: float = DEFAULT_ZFAR,
    *,
    device: str | torch.device = "cuda",
    data_device: str | None = None,
) -> Camera:
    """Build a :class:`Camera` from COLMAP-convention extrinsics.

    Mirrors ``Camera.__init__`` (reference ``scene/cameras.py:30-121``):
    view matrix via ``getWorld2View2``, projection via
    ``getProjectionMatrix``, camera center from the inverse view matrix.
    ``data_device`` places the image (see :func:`camera_from_arrays`).
    """
    view = make_view_matrix(R, T, translate, scale)
    proj = make_projection_matrix(znear, zfar, fovx, fovy)
    full = (proj @ view).astype(np.float32)
    cam_pos = np.linalg.inv(view)[:3, 3].astype(np.float32)
    return camera_from_arrays(
        view, full, cam_pos, math.tan(fovx / 2.0), math.tan(fovy / 2.0),
        width, height, znear=znear, zfar=zfar, image=image, device=device,
        data_device=data_device,
    )


def camera_from_matrices(
    view: np.ndarray,
    full_proj: np.ndarray,
    fovx: float,
    fovy: float,
    width: int,
    height: int,
    znear: float = DEFAULT_ZNEAR,
    zfar: float = DEFAULT_ZFAR,
    *,
    device: str | torch.device = "cuda",
) -> Camera:
    """Matrices-only camera, the ``MiniCam`` analog (``scene/cameras.py:123-164``;
    gs_tpu ``cameras.camera_from_matrices``): the camera center from the
    inverse view matrix, no image."""
    view = np.asarray(view, dtype=np.float32)
    cam_pos = np.linalg.inv(view)[:3, 3].astype(np.float32)
    return camera_from_arrays(
        view, np.asarray(full_proj, dtype=np.float32), cam_pos, math.tan(fovx / 2.0),
        math.tan(fovy / 2.0), width, height, znear=znear, zfar=zfar, device=device,
    )


def stack_cameras(cams: list[Camera]) -> Camera:
    """Same-resolution cameras stacked along a leading axis into one
    :class:`Camera` (gs_tpu ``cameras.stack_cameras``): every tensor field
    gains a leading [len(cams)] axis; the images are stacked only if every
    camera has one, else dropped."""
    if not cams:
        raise ValueError("empty camera list")
    if len({(c.width, c.height) for c in cams}) != 1:
        raise ValueError("stack_cameras requires uniform resolution")
    has_img = all(c.image is not None for c in cams)

    def stack(name):
        return torch.stack([getattr(c, name) for c in cams])

    return Camera(
        view=stack("view"),
        full_proj=stack("full_proj"),
        cam_pos=stack("cam_pos"),
        tan_fovx=stack("tan_fovx"),
        tan_fovy=stack("tan_fovy"),
        width=cams[0].width,
        height=cams[0].height,
        znear=stack("znear"),
        zfar=stack("zfar"),
        image=stack("image") if has_img else None,
    )
