"""Scene readers: COLMAP and Blender datasets -> SceneInfo.

The port's own copy of ``gs_tpu/data/readers.py`` (reference
``scene/dataset_readers.py``):

- COLMAP (``readColmapSceneInfo``, :191-254): read sparse/0 (binary with text
  fallback), PINHOLE / SIMPLE_PINHOLE only, sort by image name, every-8th
  frame to the test split under eval (llffhold=8), points3D converted to
  points3D.ply on first load.
- Blender (``readNerfSyntheticInfo``, :298-332): transforms_{train,test}.json,
  OpenGL->COLMAP axis flip (c2w[:3,1:3] *= -1), alpha composited over
  white/black, random 100k-point init cloud in [-1.3, 1.3]^3.
- camera-bound normalization (``getNerfppNorm``, :85-110): translate = -mean
  of camera centers, radius = 1.1 * max distance from that mean.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass

import numpy as np

from gs_tpu_torch.cameras import focal_to_fov, fov_to_focal, make_view_matrix
from gs_tpu_torch.data import colmap, ply
from gs_tpu_torch.data import images as img_mod

LLFF_HOLD = 8  # dataset_readers.py:191


@dataclass
class CameraInfo:
    uid: int
    R: np.ndarray  # camera-to-world rotation (COLMAP R transposed)
    T: np.ndarray  # world-to-camera translation
    fovx: float
    fovy: float
    image_path: str
    image_name: str
    width: int
    height: int
    # Blender: background already composited at load time via this color
    bg_composite: np.ndarray | None = None


@dataclass
class SceneInfo:
    point_cloud: tuple[np.ndarray, np.ndarray, np.ndarray]  # points, colors, normals
    train_cameras: list[CameraInfo]
    test_cameras: list[CameraInfo]
    nerf_normalization: dict
    ply_path: str


def get_nerfpp_norm(cam_infos: list[CameraInfo]) -> dict:
    """Scene extent from camera bounds (``dataset_readers.py:85-110``)."""
    centers = []
    for cam in cam_infos:
        w2c = make_view_matrix(cam.R, cam.T)
        c2w = np.linalg.inv(w2c)
        centers.append(c2w[:3, 3])
    centers = np.stack(centers, axis=0)
    center = centers.mean(axis=0)
    diagonal = np.linalg.norm(centers - center, axis=1).max()
    radius = float(diagonal * 1.1)
    return {"translate": -center, "radius": radius}


# ----------------------------------------------------------------------------
# COLMAP
# ----------------------------------------------------------------------------


def _read_colmap_cameras(extrinsics, intrinsics, images_folder) -> list[CameraInfo]:
    infos = []
    for idx, key in enumerate(extrinsics):
        extr = extrinsics[key]
        intr = intrinsics[extr.camera_id]
        height, width = intr.height, intr.width

        R = np.transpose(colmap.qvec_to_rotmat(extr.qvec))
        T = np.array(extr.tvec)

        if intr.model == "SIMPLE_PINHOLE":
            focal_x = focal_y = intr.params[0]
        elif intr.model == "PINHOLE":
            focal_x, focal_y = intr.params[0], intr.params[1]
        else:
            raise ValueError(
                "Colmap camera model not handled: only undistorted datasets "
                "(PINHOLE or SIMPLE_PINHOLE cameras) supported!"
            )
        fovx = focal_to_fov(focal_x, width)
        fovy = focal_to_fov(focal_y, height)

        image_path = os.path.join(images_folder, os.path.basename(extr.name))
        infos.append(
            CameraInfo(
                uid=intr.camera_id, R=R, T=T, fovx=fovx, fovy=fovy,
                image_path=image_path,
                image_name=os.path.splitext(os.path.basename(extr.name))[0],
                width=width, height=height,
            )
        )
    return infos


def read_colmap_scene(path: str, images: str = "images", eval_split: bool = False,
                      llffhold: int = LLFF_HOLD) -> SceneInfo:
    sparse = os.path.join(path, "sparse", "0")
    try:
        extr = colmap.read_images_binary(os.path.join(sparse, "images.bin"))
        intr = colmap.read_cameras_binary(os.path.join(sparse, "cameras.bin"))
    except FileNotFoundError:
        extr = colmap.read_images_text(os.path.join(sparse, "images.txt"))
        intr = colmap.read_cameras_text(os.path.join(sparse, "cameras.txt"))

    reading_dir = images if images else "images"
    cam_infos = _read_colmap_cameras(extr, intr, os.path.join(path, reading_dir))
    cam_infos.sort(key=lambda c: c.image_name)

    if eval_split:
        train = [c for i, c in enumerate(cam_infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(cam_infos) if i % llffhold == 0]
    else:
        train, test = cam_infos, []

    norm = get_nerfpp_norm(train)

    ply_path = os.path.join(sparse, "points3D.ply")
    if not os.path.exists(ply_path):
        print("Converting point3d.bin to .ply, will happen only the first time you open the scene.")
        try:
            xyz, rgb, _ = colmap.read_points3d_binary(os.path.join(sparse, "points3D.bin"))
        except FileNotFoundError:
            xyz, rgb, _ = colmap.read_points3d_text(os.path.join(sparse, "points3D.txt"))
        _write_pointcloud_once(ply_path, xyz.astype(np.float32), rgb)
    pcd = ply.read_pointcloud_ply(ply_path)

    return SceneInfo(pcd, train, test, norm, ply_path)


def _write_pointcloud_once(path: str, points: np.ndarray, colors_u8: np.ndarray) -> None:
    """The converted point cloud written to a file of this call's own and
    renamed onto ``path``: the ranks of a mesh run open one dataset at
    once, and none may read another's half-written file."""
    fd, tmp = tempfile.mkstemp(suffix=".tmp", dir=os.path.dirname(path) or ".")
    os.close(fd)
    try:
        ply.write_pointcloud_ply(tmp, points, colors_u8)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


# ----------------------------------------------------------------------------
# Blender / NeRF-synthetic
# ----------------------------------------------------------------------------


def _read_transforms(path: str, transforms_file: str, white_background: bool,
                     extension: str = ".png") -> list[CameraInfo]:
    with open(os.path.join(path, transforms_file)) as f:
        meta = json.load(f)
    fovx = meta["camera_angle_x"]
    bg = np.array([1.0, 1.0, 1.0]) if white_background else np.array([0.0, 0.0, 0.0])

    infos = []
    for idx, frame in enumerate(meta["frames"]):
        image_path = os.path.join(path, frame["file_path"] + extension)
        c2w = np.array(frame["transform_matrix"])
        c2w[:3, 1:3] *= -1  # OpenGL/Blender -> COLMAP axes (dataset_readers.py:269-270)
        w2c = np.linalg.inv(c2w)
        R = np.transpose(w2c[:3, :3])
        T = w2c[:3, 3]

        with img_mod.load_image(image_path) as im:
            width, height = im.size
        fovy = focal_to_fov(fov_to_focal(fovx, width), height)
        infos.append(
            CameraInfo(
                uid=idx, R=R, T=T, fovx=fovx, fovy=fovy,
                image_path=image_path,
                image_name=os.path.splitext(os.path.basename(image_path))[0],
                width=width, height=height, bg_composite=bg,
            )
        )
    return infos


def read_blender_scene(path: str, white_background: bool = False,
                       eval_split: bool = False, extension: str = ".png") -> SceneInfo:
    print("Reading Training Transforms")
    train = _read_transforms(path, "transforms_train.json", white_background, extension)
    print("Reading Test Transforms")
    test = []
    if os.path.exists(os.path.join(path, "transforms_test.json")):
        test = _read_transforms(path, "transforms_test.json", white_background, extension)
    if not eval_split:
        train = train + test
        test = []

    norm = get_nerfpp_norm(train)

    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        num_pts = 100_000
        print(f"Generating random point cloud ({num_pts})...")
        # np.random's global stream, drawn as gs_tpu draws it (dataset_readers.py:313)
        xyz = np.random.random((num_pts, 3)) * 2.6 - 1.3
        shs = np.random.random((num_pts, 3)) / 255.0
        colors_u8 = (_sh_to_rgb(shs) * 255.0).astype(np.uint8)
        _write_pointcloud_once(ply_path, xyz.astype(np.float32), colors_u8)
    pcd = ply.read_pointcloud_ply(ply_path)

    return SceneInfo(pcd, train, test, norm, ply_path)


def _sh_to_rgb(sh):
    return sh * 0.28209479177387814 + 0.5


def detect_scene_type(path: str) -> str:
    """Scene-type sniff (``scene/__init__.py:44-51``)."""
    if os.path.exists(os.path.join(path, "sparse")):
        return "colmap"
    if os.path.exists(os.path.join(path, "transforms_train.json")):
        return "blender"
    raise ValueError(f"Could not recognize scene type for {path}")


def load_scene_info(path: str, images: str = "images", white_background: bool = False,
                    eval_split: bool = False) -> SceneInfo:
    kind = detect_scene_type(path)
    if kind == "colmap":
        return read_colmap_scene(path, images=images, eval_split=eval_split)
    print("Found transforms_train.json file, assuming Blender data set!")
    return read_blender_scene(path, white_background=white_background,
                              eval_split=eval_split)
