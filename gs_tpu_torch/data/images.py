"""Image loading and the reference's resolution policy.

The port's own copy of ``gs_tpu/data/images.py`` (reference
``utils/camera_utils.py:19-86``, ``utils/general_utils.py:21-27``):

- ``resolution`` flag in {1,2,4,8}: divide by resolution * resolution_scale
- ``-1``: auto-cap width at 1600 px (warn once), else native
- any other positive value: treat as target width
- images resized with PIL, converted to [C,H,W] float32 in [0,1]
- RGBA inputs: composited over the Blender background where the reader
  gives one (``dataset_readers.py:281-287``), else RGB premultiplied by
  alpha (``scene/cameras.py:84-88``).

PIL is imported where an image is opened, not with this module, so that
``import gs_tpu_torch`` needs no Pillow.
"""

from __future__ import annotations

import numpy as np

_warned_big = False


def load_image(path: str):
    """Open an image file with PIL (a context manager, like ``Image.open``)."""
    from PIL import Image

    return Image.open(path)


def pil_to_array(pil_image, resolution: tuple[int, int]) -> np.ndarray:
    """Resize then convert to [C,H,W] float32 in [0,1] (``PILtoTorch``)."""
    resized = pil_image.resize(resolution)
    arr = np.asarray(resized, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[..., None]
    return np.transpose(arr, (2, 0, 1))


def target_resolution(orig_w: int, orig_h: int, resolution_flag: int,
                      resolution_scale: float = 1.0) -> tuple[int, int]:
    """The loadCam resolution policy (``utils/camera_utils.py:44-63``)."""
    global _warned_big
    if resolution_flag in (1, 2, 4, 8):
        scale = resolution_scale * resolution_flag
        return round(orig_w / scale), round(orig_h / scale)
    if resolution_flag == -1:
        if orig_w > 1600:
            if not _warned_big:
                print("[ INFO ] Encountered quite large input images (>1.6K pixels width), "
                      "rescaling to 1.6K.\n If this is not desired, please explicitly "
                      "specify '--resolution/-r' as 1")
                _warned_big = True
            global_down = orig_w / 1600
        else:
            global_down = 1.0
    else:
        global_down = orig_w / resolution_flag
    scale = global_down * resolution_scale
    return int(orig_w / scale), int(orig_h / scale)


def load_camera_image(pil_image, resolution_flag: int, resolution_scale: float = 1.0,
                      bg: np.ndarray | None = None) -> np.ndarray:
    """A ground-truth image: [3,H,W] float32 in [0,1]. RGBA: composited
    over ``bg`` (Blender datasets), else multiplied by the alpha mask."""
    res = target_resolution(pil_image.width, pil_image.height, resolution_flag,
                            resolution_scale)
    arr = pil_to_array(pil_image, res)
    if arr.shape[0] == 4:
        rgb, alpha = arr[:3], arr[3:4]
        if bg is not None:
            rgb = rgb * alpha + bg.reshape(3, 1, 1) * (1.0 - alpha)
        else:
            rgb = rgb * alpha
        return np.clip(rgb, 0.0, 1.0)
    return np.clip(arr[:3], 0.0, 1.0)
