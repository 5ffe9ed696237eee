"""Scene orchestration: dataset -> cameras + initial GaussianState + snapshots.

Port of ``gs_tpu/scene.py`` (reference ``scene/__init__.py:21-105``): scene
type detection, cameras at their resolution scales, the scene extent,
Gaussians from the SfM point cloud or from a saved iteration, PLY snapshots,
and the ``cameras.json`` / ``input.ply`` artifacts viewers expect. In a
mesh run the ranks of data row d load only the train images that row owns
(``data_row``, ``multihost.should_load_image``, gs_tpu/scene.py:136-156);
the other train cameras carry their parameters only.
"""

from __future__ import annotations

import json
import os
import random
import shutil

import numpy as np
import torch

from gs_tpu_torch import cameras as cam_mod
from gs_tpu_torch.config import ModelParams
from gs_tpu_torch.data import images as img_mod
from gs_tpu_torch.data import multihost
from gs_tpu_torch.data import ply as ply_mod
from gs_tpu_torch.data import readers
from gs_tpu_torch.device import resolve_device
from gs_tpu_torch.models import gaussians
from gs_tpu_torch.models.gaussians import GaussianState


def search_max_iteration(point_cloud_dir: str) -> int:
    """Largest saved iteration (``utils/system_utils.py:26-29``)."""
    return max(int(d.split("_")[-1]) for d in os.listdir(point_cloud_dir)
               if d.startswith("iteration_"))


def camera_to_json(idx: int, cam: readers.CameraInfo) -> dict:
    """Viewer-facing camera description (``utils/camera_utils.py:99-126``)."""
    rt = np.zeros((4, 4))
    rt[:3, :3] = cam.R.transpose()
    rt[:3, 3] = cam.T
    rt[3, 3] = 1.0
    w2c = np.linalg.inv(rt)
    return {
        "id": idx,
        "img_name": cam.image_name,
        "width": cam.width,
        "height": cam.height,
        "position": w2c[:3, 3].tolist(),
        "rotation": [r.tolist() for r in w2c[:3, :3]],
        "fy": cam_mod.fov_to_focal(cam.fovy, cam.height),
        "fx": cam_mod.fov_to_focal(cam.fovx, cam.width),
    }


def load_camera(info: readers.CameraInfo, resolution_flag: int, resolution_scale: float,
                load_image: bool = True, data_device: str | None = None, *,
                device: str | torch.device = "cuda") -> cam_mod.Camera:
    """CameraInfo -> Camera with its ground truth (``utils/camera_utils.py:19-86``);
    ``data_device`` places the image (``cameras.camera_from_arrays``)."""
    if load_image:
        with img_mod.load_image(info.image_path) as pil:
            gt = img_mod.load_camera_image(pil, resolution_flag, resolution_scale,
                                           bg=info.bg_composite)
        height, width = gt.shape[1], gt.shape[2]
    else:
        gt = None
        width, height = img_mod.target_resolution(info.width, info.height, resolution_flag,
                                                  resolution_scale)
    return cam_mod.make_camera(info.R, info.T, info.fovx, info.fovy, width, height, image=gt,
                               device=device, data_device=data_device)


class Scene:
    """Holds the cameras and the model path; initializes or restores the
    Gaussian state on ``device``. ``write_files=False`` leaves a new model
    directory's ``input.ply`` and ``cameras.json`` to another process (rank
    0 of a mesh run writes them). ``data_row=(d, data)``: this rank's data
    row of a mesh with ``data`` rows, whose train images alone it loads
    (every test image is loaded)."""

    def __init__(
        self,
        args: ModelParams,
        load_iteration: int | None = None,
        shuffle: bool = True,
        resolution_scales: tuple[float, ...] = (1.0,),
        load_images: bool = True,
        *,
        device: str | torch.device = "cuda",
        write_files: bool = True,
        data_row: tuple[int, int] = (0, 1),
    ):
        self.device = resolve_device(device)
        self.model_path = args.model_path
        self.loaded_iter = None
        if load_iteration is not None:
            self.loaded_iter = (search_max_iteration(os.path.join(self.model_path, "point_cloud"))
                                if load_iteration == -1 else load_iteration)
            print(f"Loading trained model at iteration {self.loaded_iter}")

        info = readers.load_scene_info(args.source_path, images=args.images,
                                       white_background=args.white_background,
                                       eval_split=args.eval)
        self.scene_info = info

        if write_files and not self.loaded_iter and self.model_path:
            os.makedirs(self.model_path, exist_ok=True)
            shutil.copyfile(info.ply_path, os.path.join(self.model_path, "input.ply"))
            cam_json = [camera_to_json(i, c)
                        for i, c in enumerate(info.test_cameras + info.train_cameras)]
            with open(os.path.join(self.model_path, "cameras.json"), "w") as f:
                json.dump(cam_json, f)

        if shuffle:
            random.shuffle(info.train_cameras)  # scene/__init__.py:68-70
            random.shuffle(info.test_cameras)

        self.cameras_extent = info.nerf_normalization["radius"]

        self.train_cameras: dict[float, list[cam_mod.Camera]] = {}
        self.test_cameras: dict[float, list[cam_mod.Camera]] = {}
        data_device = getattr(args, "data_device", None)
        for scale in resolution_scales:
            print("Loading Training Cameras")
            # ownership indexes the post-shuffle order, alike on every rank
            self.train_cameras[scale] = [
                load_camera(c, args.resolution, scale,
                            load_images and multihost.should_load_image(i, *data_row),
                            data_device, device=self.device)
                for i, c in enumerate(info.train_cameras)]
            print("Loading Test Cameras")
            self.test_cameras[scale] = [
                load_camera(c, args.resolution, scale, load_images, data_device,
                            device=self.device) for c in info.test_cameras]

        if self.loaded_iter:
            self.gaussians = ply_mod.load_gaussian_ply(
                os.path.join(self.model_path, "point_cloud", f"iteration_{self.loaded_iter}",
                             "point_cloud.ply"), device=self.device)
        else:
            pts, cols, _ = info.point_cloud
            print("Number of points at initialisation : ", pts.shape[0])
            self.gaussians = gaussians.create_from_pcd(pts, cols, args.sh_degree,
                                                       device=self.device)

    def save(self, iteration: int, state: GaussianState | None = None) -> None:
        """PLY snapshot of the alive Gaussians (``scene/__init__.py:97-99``)."""
        ply_mod.save_state_ply(
            os.path.join(self.model_path, "point_cloud", f"iteration_{iteration}",
                         "point_cloud.ply"),
            self.gaussians if state is None else state)

    def get_train_cameras(self, scale: float = 1.0):
        return self.train_cameras[scale]

    def get_test_cameras(self, scale: float = 1.0):
        return self.test_cameras[scale]
