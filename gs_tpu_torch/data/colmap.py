"""COLMAP sparse-reconstruction parsers (binary and text) and binary writers.

The port's own numpy copy of ``gs_tpu/data/colmap.py`` (reference
``scene/colmap_loader.py``): cameras (intrinsics), images (extrinsics
qvec / tvec) and points3D of a COLMAP ``sparse/<i>`` directory, in the
public COLMAP on-disk formats, .bin and .txt. As in gs_tpu, the binary
readers hand the file to the ctypes library ``native/libgs_native.so``
(``data/native.py``) when it loads, and read it with ``struct`` otherwise.

Only PINHOLE and SIMPLE_PINHOLE camera models are accepted downstream, as in
``scene/dataset_readers.py:113-153`` (run convert/undistort first otherwise).
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass

import numpy as np

from gs_tpu_torch.data import native

# model_id -> (name, num_params) for the COLMAP camera models we may encounter
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
MODEL_NAME_TO_ID = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclass
class ColmapCamera:
    camera_id: int
    model: str
    width: int
    height: int
    params: np.ndarray  # f64


@dataclass
class ColmapImage:
    image_id: int
    qvec: np.ndarray  # [4] (w,x,y,z)
    tvec: np.ndarray  # [3]
    camera_id: int
    name: str


def qvec_to_rotmat(qvec: np.ndarray) -> np.ndarray:
    """COLMAP quaternion (w,x,y,z) to world->camera rotation.

    Same formula as ``scene/colmap_loader.py:43-56``.
    """
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def rotmat_to_qvec(R: np.ndarray) -> np.ndarray:
    """Inverse of qvec_to_rotmat (largest-eigenvector method, as COLMAP)."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = (
        np.array(
            [
                [Rxx - Ryy - Rzz, 0, 0, 0],
                [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
                [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
                [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
            ]
        )
        / 3.0
    )
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


# ----------------------------------------------------------------------------
# binary readers
# ----------------------------------------------------------------------------


def read_cameras_binary(path: str) -> dict[int, ColmapCamera]:
    if native.available():
        return {
            cam_id: ColmapCamera(cam_id, CAMERA_MODELS[model_id][0], w, h, params)
            for cam_id, model_id, w, h, params in native.read_cameras_binary(path)
        }
    out: dict[int, ColmapCamera] = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            cam_id, model_id, w, h = struct.unpack("<iiQQ", f.read(24))
            name, np_params = CAMERA_MODELS[model_id]
            params = np.array(struct.unpack(f"<{np_params}d", f.read(8 * np_params)))
            out[cam_id] = ColmapCamera(cam_id, name, int(w), int(h), params)
    return out


def read_images_binary(path: str) -> dict[int, ColmapImage]:
    if native.available():
        return {
            image_id: ColmapImage(image_id, qvec, tvec, camera_id, name)
            for image_id, qvec, tvec, camera_id, name in native.read_images_binary(path)
        }
    out: dict[int, ColmapImage] = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            image_id = struct.unpack("<i", f.read(4))[0]
            qvec = np.array(struct.unpack("<4d", f.read(32)))
            tvec = np.array(struct.unpack("<3d", f.read(24)))
            camera_id = struct.unpack("<i", f.read(4))[0]
            name_chars = []
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name_chars.append(c)
            name = b"".join(name_chars).decode("utf-8")
            (n_pts2d,) = struct.unpack("<Q", f.read(8))
            f.seek(24 * n_pts2d, os.SEEK_CUR)  # skip 2D observations (x,y,f64 + id i64)
            out[image_id] = ColmapImage(image_id, qvec, tvec, camera_id, name)
    return out


def read_points3d_binary(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (xyz [N,3] f64, rgb [N,3] u8, error [N] f64)."""
    if native.available():
        return native.read_points3d_binary(path)
    xyzs, rgbs, errs = [], [], []
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            rec = f.read(8 + 24 + 3 + 8)
            _, x, y, z, r, g, b, err = struct.unpack("<Q3d3Bd", rec)
            (track_len,) = struct.unpack("<Q", f.read(8))
            f.seek(8 * track_len, os.SEEK_CUR)
            xyzs.append((x, y, z))
            rgbs.append((r, g, b))
            errs.append(err)
    return (
        np.asarray(xyzs, np.float64).reshape(-1, 3),
        np.asarray(rgbs, np.uint8).reshape(-1, 3),
        np.asarray(errs, np.float64),
    )


# ----------------------------------------------------------------------------
# text readers
# ----------------------------------------------------------------------------


def _data_lines(path: str):
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line


def read_cameras_text(path: str) -> dict[int, ColmapCamera]:
    out: dict[int, ColmapCamera] = {}
    for line in _data_lines(path):
        parts = line.split()
        cam_id = int(parts[0])
        model = parts[1]
        w, h = int(parts[2]), int(parts[3])
        params = np.array([float(p) for p in parts[4:]])
        out[cam_id] = ColmapCamera(cam_id, model, w, h, params)
    return out


def read_images_text(path: str) -> dict[int, ColmapImage]:
    out: dict[int, ColmapImage] = {}
    lines = list(_data_lines(path))
    for i in range(0, len(lines), 2):  # every other line is 2D observations
        parts = lines[i].split()
        image_id = int(parts[0])
        qvec = np.array([float(p) for p in parts[1:5]])
        tvec = np.array([float(p) for p in parts[5:8]])
        camera_id = int(parts[8])
        name = parts[9]
        out[image_id] = ColmapImage(image_id, qvec, tvec, camera_id, name)
    return out


def read_points3d_text(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    xyzs, rgbs, errs = [], [], []
    for line in _data_lines(path):
        parts = line.split()
        xyzs.append([float(p) for p in parts[1:4]])
        rgbs.append([int(p) for p in parts[4:7]])
        errs.append(float(parts[7]))
    return (
        np.asarray(xyzs, np.float64).reshape(-1, 3),
        np.asarray(rgbs, np.uint8).reshape(-1, 3),
        np.asarray(errs, np.float64),
    )


# ----------------------------------------------------------------------------
# binary writers (used by tests and the convert tool)
# ----------------------------------------------------------------------------


def write_cameras_binary(cams: dict[int, ColmapCamera], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cam in cams.values():
            model_id = MODEL_NAME_TO_ID[cam.model]
            f.write(struct.pack("<iiQQ", cam.camera_id, model_id, cam.width, cam.height))
            f.write(struct.pack(f"<{len(cam.params)}d", *cam.params))


def write_images_binary(images: dict[int, ColmapImage], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i", im.image_id))
            f.write(struct.pack("<4d", *im.qvec))
            f.write(struct.pack("<3d", *im.tvec))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", 0))


def write_points3d_binary(xyz: np.ndarray, rgb: np.ndarray, path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", xyz.shape[0]))
        for i in range(xyz.shape[0]):
            f.write(struct.pack("<Q3d3Bd", i, *xyz[i], *rgb[i].astype(np.uint8), 0.0))
            f.write(struct.pack("<Q", 0))
