"""gs_tpu_torch's data layer, scene and checkpoints against gs_tpu's, on the CPU.

Twins of ``tests/test_data.py``'s ``TestColmap``, ``TestPly``,
``TestBlender::test_blender_load`` and ``TestResolutionPolicy`` on the same
synthetic fixtures, each result compared field by field with gs_tpu's; then
the ``Scene`` on the COLMAP fixture against gs_tpu's (camera order,
matrices, images bitwise, extent, initial Gaussians), checkpoints written
by each package and loaded by the other (bitwise), a checkpoint directory
round-tripped, ``cfg_args`` read by
each, the ``data_device`` staging policy, and ``gs_tpu_torch.data.images``
imported without PIL. No Blender ``Scene`` is built here: the port's 3-NN
over its 100,000 random points takes most of a minute on this CPU.
"""

import dataclasses
import json
import math
import os
import random
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from gs_tpu import scene as j_scene
from gs_tpu import training as j_training
from gs_tpu.cli import args as j_args
from gs_tpu.config import ModelParams as JModelParams
from gs_tpu.data import colmap as j_colmap
from gs_tpu.data import images as j_images
from gs_tpu.data import ply as j_ply
from gs_tpu.data import readers as j_readers
from gs_tpu.models import gaussians as j_gaussians
from gs_tpu.utils import ckpt as j_ckpt
from gs_tpu_torch import cameras, interop, scene, training
from gs_tpu_torch.cli import args as args_mod
from gs_tpu_torch.config import ModelParams
from gs_tpu_torch.data import colmap, images, ply, readers
from gs_tpu_torch.utils import ckpt
from tests.torch_port_inputs import scene_arrays

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def colmap_scene(tmp_path):
    """test_data.py:16-47's synthetic COLMAP dataset: 10 cameras on a circle
    + 500 random points, written by the port's writers."""
    rng = np.random.default_rng(0)
    sparse = tmp_path / "sparse" / "0"
    sparse.mkdir(parents=True)
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    cams = {1: colmap.ColmapCamera(1, "PINHOLE", 64, 48, np.array([60.0, 60.0, 32.0, 24.0]))}
    imgs = {}
    for i in range(10):
        ang = 2 * math.pi * i / 10
        qvec = np.array([math.cos(ang / 2), 0.0, math.sin(ang / 2), 0.0])
        name = f"img_{i:03d}.png"
        imgs[i + 1] = colmap.ColmapImage(i + 1, qvec, np.array([0.0, 0.0, 4.0]), 1, name)
        Image.fromarray(rng.uniform(0, 255, (48, 64, 3)).astype(np.uint8)).save(img_dir / name)
    colmap.write_cameras_binary(cams, str(sparse / "cameras.bin"))
    colmap.write_images_binary(imgs, str(sparse / "images.bin"))
    xyz = rng.uniform(-1, 1, (500, 3))
    rgb = rng.integers(0, 255, (500, 3))
    colmap.write_points3d_binary(xyz, rgb, str(sparse / "points3D.bin"))
    return tmp_path, xyz, rgb


def _assert_same_dataclass(got, want, what):
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w, err_msg=f"{what}.{f.name}")
            assert np.asarray(g).dtype == w.dtype, f"{what}.{f.name}"
        else:
            assert g == w, f"{what}.{f.name}: {g!r} != {w!r}"


def _assert_same_cam_infos(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _assert_same_dataclass(g, w, w.image_name)


def _assert_same_scene_info(got, want):
    for g, w in zip(got.point_cloud, want.point_cloud):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    _assert_same_cam_infos(got.train_cameras, want.train_cameras)
    _assert_same_cam_infos(got.test_cameras, want.test_cameras)
    np.testing.assert_array_equal(got.nerf_normalization["translate"],
                                  want.nerf_normalization["translate"])
    assert got.nerf_normalization["radius"] == want.nerf_normalization["radius"]
    assert got.ply_path == want.ply_path


class TestColmap:
    def test_binary_roundtrip(self, colmap_scene):
        """The port's writers' files read by both packages' readers, equal."""
        path, xyz, rgb = colmap_scene
        sparse = os.path.join(path, "sparse", "0")
        cams = colmap.read_cameras_binary(os.path.join(sparse, "cameras.bin"))
        j_cams = j_colmap.read_cameras_binary(os.path.join(sparse, "cameras.bin"))
        assert cams[1].model == "PINHOLE" and cams[1].width == 64
        _assert_same_dataclass(cams[1], j_cams[1], "camera")
        imgs = colmap.read_images_binary(os.path.join(sparse, "images.bin"))
        j_imgs = j_colmap.read_images_binary(os.path.join(sparse, "images.bin"))
        assert len(imgs) == 10 and imgs[1].name == "img_000.png"
        assert imgs.keys() == j_imgs.keys()
        for k in imgs:
            _assert_same_dataclass(imgs[k], j_imgs[k], f"image {k}")
        pts = colmap.read_points3d_binary(os.path.join(sparse, "points3D.bin"))
        np.testing.assert_allclose(pts[0], xyz, atol=1e-12)
        np.testing.assert_array_equal(pts[1], rgb.astype(np.uint8))
        for g, w in zip(pts, j_colmap.read_points3d_binary(os.path.join(sparse, "points3D.bin"))):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype

    def test_writers_match_gs_tpu_bytes(self, tmp_path):
        rng = np.random.default_rng(7)
        cams = {3: colmap.ColmapCamera(3, "SIMPLE_PINHOLE", 100, 80, np.array([90.0, 50.0, 40.0]))}
        imgs = {5: colmap.ColmapImage(5, rng.normal(size=4), rng.normal(size=3), 3, "a b.png")}
        xyz, rgb = rng.normal(size=(20, 3)), rng.integers(0, 255, (20, 3))
        for writer, j_writer, arg, j_arg in (
                ("write_cameras_binary", "write_cameras_binary", cams,
                 {3: j_colmap.ColmapCamera(**dataclasses.asdict(cams[3]))}),
                ("write_images_binary", "write_images_binary", imgs,
                 {5: j_colmap.ColmapImage(**dataclasses.asdict(imgs[5]))})):
            getattr(colmap, writer)(arg, str(tmp_path / "port.bin"))
            getattr(j_colmap, j_writer)(j_arg, str(tmp_path / "gs_tpu.bin"))
            assert (tmp_path / "port.bin").read_bytes() == (tmp_path / "gs_tpu.bin").read_bytes()
        colmap.write_points3d_binary(xyz, rgb, str(tmp_path / "port.bin"))
        j_colmap.write_points3d_binary(xyz, rgb, str(tmp_path / "gs_tpu.bin"))
        assert (tmp_path / "port.bin").read_bytes() == (tmp_path / "gs_tpu.bin").read_bytes()

    def test_qvec_rotmat_roundtrip(self):
        rng = np.random.default_rng(1)
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        if q[0] < 0:
            q = -q
        R = colmap.qvec_to_rotmat(q)
        np.testing.assert_array_equal(R, j_colmap.qvec_to_rotmat(q))
        np.testing.assert_allclose(colmap.rotmat_to_qvec(R), q, atol=1e-8)
        np.testing.assert_array_equal(colmap.rotmat_to_qvec(R), j_colmap.rotmat_to_qvec(R))

    def test_scene_info_split_and_norm(self, colmap_scene):
        path, _, _ = colmap_scene
        info = readers.read_colmap_scene(str(path), eval_split=True)
        assert len(info.test_cameras) == 2 and len(info.train_cameras) == 8
        assert 4.0 < info.nerf_normalization["radius"] < 5.5
        assert os.path.exists(info.ply_path)  # bin -> ply conversion happened
        ply_bytes = open(info.ply_path, "rb").read()
        # gs_tpu reads the port's points3D.ply, then writes its own in its place
        _assert_same_scene_info(info, j_readers.read_colmap_scene(str(path), eval_split=True))
        os.remove(info.ply_path)
        want = j_readers.read_colmap_scene(str(path), eval_split=True)
        assert open(want.ply_path, "rb").read() == ply_bytes
        _assert_same_scene_info(readers.read_colmap_scene(str(path), eval_split=True), want)

    def test_text_parsers(self, tmp_path):
        (tmp_path / "cameras.txt").write_text("# comment\n1 SIMPLE_PINHOLE 100 80 90.0 50.0 40.0\n")
        (tmp_path / "images.txt").write_text("# hdr\n1 1 0 0 0 0.5 0.5 2.0 1 foo.png\n0 0 -1\n")
        (tmp_path / "points3D.txt").write_text("7 1.0 2.0 3.0 10 20 30 0.5\n")
        cams = colmap.read_cameras_text(str(tmp_path / "cameras.txt"))
        assert cams[1].model == "SIMPLE_PINHOLE" and cams[1].params[0] == 90.0
        _assert_same_dataclass(cams[1], j_colmap.read_cameras_text(
            str(tmp_path / "cameras.txt"))[1], "camera")
        imgs = colmap.read_images_text(str(tmp_path / "images.txt"))
        assert imgs[1].name == "foo.png"
        np.testing.assert_allclose(imgs[1].tvec, [0.5, 0.5, 2.0])
        _assert_same_dataclass(imgs[1], j_colmap.read_images_text(
            str(tmp_path / "images.txt"))[1], "image")
        pts = colmap.read_points3d_text(str(tmp_path / "points3D.txt"))
        np.testing.assert_allclose(pts[0][0], [1, 2, 3])
        for g, w in zip(pts, j_colmap.read_points3d_text(str(tmp_path / "points3D.txt"))):
            np.testing.assert_array_equal(g, w)

    def test_text_fallback_matches_gs_tpu(self, colmap_scene, tmp_path):
        """A sparse/0 with only .txt files gives the port the scene gs_tpu reads
        from the .bin files. (gs_tpu's own text fallback is not reached while
        its native library loads: that reader raises OSError, not the
        FileNotFoundError gs_tpu's read_colmap_scene catches.)"""
        path, xyz, rgb = colmap_scene
        sparse = path / "sparse" / "0"
        want = j_readers.read_colmap_scene(str(path))
        ply_bytes = open(want.ply_path, "rb").read()
        cams = colmap.read_cameras_binary(str(sparse / "cameras.bin"))
        imgs = colmap.read_images_binary(str(sparse / "images.bin"))
        for f in ("cameras.bin", "images.bin", "points3D.bin", "points3D.ply"):
            os.remove(sparse / f)
        def words(v):
            return " ".join(repr(float(x)) for x in v)

        (sparse / "cameras.txt").write_text("".join(
            f"{c.camera_id} {c.model} {c.width} {c.height} {words(c.params)}\n"
            for c in cams.values()))
        (sparse / "images.txt").write_text("".join(
            f"{im.image_id} {words(im.qvec)} {words(im.tvec)} {im.camera_id} {im.name}\n"
            "0 0 -1\n" for im in imgs.values()))
        (sparse / "points3D.txt").write_text("".join(
            f"{i} {words(p)} {' '.join(str(int(x)) for x in c)} 0.0\n"
            for i, (p, c) in enumerate(zip(xyz, rgb))))
        info = readers.read_colmap_scene(str(path))
        assert len(info.train_cameras) == 10 and info.point_cloud[0].shape == (500, 3)
        _assert_same_scene_info(info, want)
        assert open(info.ply_path, "rb").read() == ply_bytes


def check_gaussian_ply_roundtrip(tmp_path, deg):
    """A Gaussian PLY of SH degree ``deg`` written by each package has the
    same bytes and reads back in either, K inferred from the fields."""
    rng = np.random.default_rng(2)
    n = 17
    k1 = (deg + 1) ** 2 - 1
    arrs = dict(
        xyz=rng.normal(size=(n, 3)).astype(np.float32),
        features_dc=rng.normal(size=(n, 1, 3)).astype(np.float32),
        features_rest=rng.normal(size=(n, k1, 3)).astype(np.float32),
        logit_opacity=rng.normal(size=(n, 1)).astype(np.float32),
        log_scale=rng.normal(size=(n, 3)).astype(np.float32),
        quat=rng.normal(size=(n, 4)).astype(np.float32),
    )
    order = ("xyz", "features_dc", "features_rest", "logit_opacity", "log_scale", "quat")
    ply.save_gaussian_ply(str(tmp_path / "port.ply"), *(arrs[k] for k in order))
    j_ply.save_gaussian_ply(str(tmp_path / "gs_tpu.ply"), *(arrs[k] for k in order))
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "gs_tpu.ply").read_bytes()
    got = ply.read_gaussian_arrays(str(tmp_path / "gs_tpu.ply"))
    want = j_ply.load_gaussian_ply(str(tmp_path / "port.ply"))
    assert want["max_sh_degree"] == deg
    for k in arrs:
        np.testing.assert_array_equal(got[k], arrs[k], err_msg=k)
        np.testing.assert_array_equal(want[k], arrs[k], err_msg=k)


class TestPly:
    def test_gaussian_ply_roundtrip(self, tmp_path):
        check_gaussian_ply_roundtrip(tmp_path, 3)

    def test_pointcloud_roundtrip(self, tmp_path):
        """Byte-compatible with gs_tpu's storePly schema, and read alike."""
        pts = np.random.default_rng(3).normal(size=(9, 3)).astype(np.float32)
        cols = np.random.default_rng(4).integers(0, 255, (9, 3))
        ply.write_pointcloud_ply(str(tmp_path / "port.ply"), pts, cols)
        j_ply.write_pointcloud_ply(str(tmp_path / "gs_tpu.ply"), pts, cols)
        assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "gs_tpu.ply").read_bytes()
        rp, rc, rn = ply.read_pointcloud_ply(str(tmp_path / "gs_tpu.ply"))
        np.testing.assert_array_equal(rp, pts)
        np.testing.assert_allclose(rc, cols / 255.0, atol=1e-6)
        np.testing.assert_array_equal(rn, 0)
        for g, w in zip((rp, rc, rn), j_ply.read_pointcloud_ply(str(tmp_path / "port.ply"))):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype

    def test_pointcloud_without_colors_or_normals(self, tmp_path):
        arr = np.zeros(4, dtype=[("x", "f4"), ("y", "f4"), ("z", "f4")])
        arr["x"] = [1, 2, 3, 4]
        ply.write_ply(str(tmp_path / "bare.ply"), arr)
        for g, w in zip(ply.read_pointcloud_ply(str(tmp_path / "bare.ply")),
                        j_ply.read_pointcloud_ply(str(tmp_path / "bare.ply"))):
            np.testing.assert_array_equal(g, w)


class TestBlender:
    @pytest.fixture
    def blender_scene(self, tmp_path):
        rng = np.random.default_rng(5)
        for split, count in [("train", 6), ("test", 3)]:
            frames = []
            d = tmp_path / split
            d.mkdir()
            for i in range(count):
                c2w = np.eye(4)
                c2w[:3, 3] = [0, 0, 3.0 + i * 0.1]
                frames.append({"file_path": f"./{split}/r_{i}", "transform_matrix": c2w.tolist()})
                rgba = rng.integers(0, 255, (40, 50, 4)).astype(np.uint8)
                Image.fromarray(rgba, "RGBA").save(d / f"r_{i}.png")
            with open(tmp_path / f"transforms_{split}.json", "w") as f:
                json.dump({"camera_angle_x": 0.8, "frames": frames}, f)
        return tmp_path

    @pytest.mark.parametrize("eval_split", [True, False])
    def test_blender_load(self, blender_scene, eval_split):
        """The same SceneInfo as gs_tpu's: cameras, axis flip, and the 100,000
        random points drawn from np.random's global stream."""
        np.random.seed(3)
        info = readers.read_blender_scene(str(blender_scene), white_background=True,
                                          eval_split=eval_split)
        assert len(info.train_cameras) == (6 if eval_split else 9)
        assert len(info.test_cameras) == (3 if eval_split else 0)
        assert info.point_cloud[0].shape == (100_000, 3)
        assert np.abs(info.point_cloud[0]).max() <= 1.3
        cam = info.train_cameras[0]
        assert cam.fovx == 0.8
        assert abs(cam.fovy - 2 * math.atan(math.tan(0.4) * 40 / 50)) < 1e-9
        np.testing.assert_array_equal(cam.bg_composite, [1.0, 1.0, 1.0])
        ply_bytes = open(info.ply_path, "rb").read()
        os.remove(info.ply_path)
        np.random.seed(3)
        want = j_readers.read_blender_scene(str(blender_scene), white_background=True,
                                            eval_split=eval_split)
        assert open(want.ply_path, "rb").read() == ply_bytes
        _assert_same_scene_info(info, want)
        assert readers.detect_scene_type(str(blender_scene)) == "blender"

    def test_blender_images_match(self, blender_scene):
        """RGBA composited over the white background, at resolution 2."""
        info = readers.read_blender_scene(str(blender_scene), white_background=True)
        for c in info.train_cameras[:3]:
            with images.load_image(c.image_path) as im:
                got = images.load_camera_image(im, 2, 1.0, bg=c.bg_composite)
            with j_images.load_image(c.image_path) as im:
                want = j_images.load_camera_image(im, 2, 1.0, bg=c.bg_composite)
            assert got.shape == (3, 20, 25)
            np.testing.assert_array_equal(got, want)
            with images.load_image(c.image_path) as im:  # premultiplied without a background
                np.testing.assert_array_equal(images.load_camera_image(im, 1),
                                              j_images.load_camera_image(im, 1))


class TestResolutionPolicy:
    @pytest.mark.parametrize("args", [(1600, 1200, 2), (1600, 1200, 1, 2.0), (3200, 2400, -1),
                                      (800, 600, -1), (1000, 500, 250), (1001, 333, 4, 1.5)])
    def test_matches_gs_tpu(self, args):
        assert images.target_resolution(*args) == j_images.target_resolution(*args)

    def test_values(self):
        assert images.target_resolution(1600, 1200, 2) == (800, 600)
        assert images.target_resolution(3200, 2400, -1) == (1600, 1200)
        assert images.target_resolution(800, 600, -1) == (800, 600)
        assert images.target_resolution(1000, 500, 250) == (250, 125)


def test_images_module_imports_without_pil():
    code = ("import sys, gs_tpu_torch.data.images, gs_tpu_torch.data.readers, "
            "gs_tpu_torch.scene, gs_tpu_torch.cli.train, gs_tpu_torch.cli.render\n"
            "assert 'PIL' not in sys.modules, sorted(m for m in sys.modules if 'PIL' in m)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# --- the Scene --------------------------------------------------------------------------------


def test_scene_matches_gs_tpu(colmap_scene, tmp_path):
    """Scene on the COLMAP fixture (eval split, resolution 2, SH degree 2),
    shuffled from the same Python seed: the same camera order, matrices and
    images bitwise, the same extent and artifacts, and the same initial
    Gaussians (the 3-NN scales within float rounding)."""
    path, _, _ = colmap_scene
    kw = dict(source_path=str(path), eval=True, sh_degree=2, resolution=2)
    random.seed(11)
    got = scene.Scene(ModelParams(model_path=str(tmp_path / "port"), **kw), device="cpu")
    random.seed(11)
    want = j_scene.Scene(JModelParams(model_path=str(tmp_path / "gs_tpu"), **kw))
    assert got.cameras_extent == want.cameras_extent
    for split in ("get_train_cameras", "get_test_cameras"):
        g_cams, w_cams = getattr(got, split)(), getattr(want, split)()
        assert len(g_cams) == len(w_cams) > 0
        for g, w in zip(g_cams, w_cams):
            assert (g.width, g.height) == (w.width, w.height) == (32, 24)
            for name in ("view", "full_proj", "cam_pos", "tan_fovx", "tan_fovy", "image"):
                np.testing.assert_array_equal(getattr(g, name).numpy(),
                                              np.asarray(getattr(w, name)), err_msg=name)
    order = [c.image_name for c in got.scene_info.train_cameras]
    assert order == [c.image_name for c in want.scene_info.train_cameras]
    assert order != sorted(order)  # shuffled
    for name in ("input.ply", "cameras.json"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "gs_tpu" / name).read_bytes()
    gs, ws = got.gaussians, want.gaussians
    assert gs.capacity == ws.capacity and gs.max_sh_degree == ws.max_sh_degree == 2
    for name in ("xyz", "features_dc", "features_rest", "quat", "logit_opacity", "alive"):
        np.testing.assert_array_equal(getattr(gs, name).numpy(), np.asarray(getattr(ws, name)),
                                      err_msg=name)
    np.testing.assert_allclose(gs.log_scale.numpy(), np.asarray(ws.log_scale), rtol=2e-5)

    # a snapshot, read back by both packages' Scene
    got.save(7)
    want.save(7)
    assert (tmp_path / "port/point_cloud/iteration_7/point_cloud.ply").read_bytes() != b""
    back = scene.Scene(ModelParams(model_path=str(tmp_path / "port"), **kw), load_iteration=-1,
                       shuffle=False, load_images=False, device="cpu")
    j_back = j_scene.Scene(JModelParams(model_path=str(tmp_path / "port"), **kw),
                           load_iteration=-1, shuffle=False, load_images=False)
    assert back.loaded_iter == j_back.loaded_iter == 7
    assert back.get_train_cameras()[0].image is None
    for name in ("xyz", "features_dc", "features_rest", "log_scale", "quat", "logit_opacity",
                 "alive"):
        np.testing.assert_array_equal(getattr(back.gaussians, name).numpy(),
                                      np.asarray(getattr(j_back.gaussians, name)), err_msg=name)
        np.testing.assert_array_equal(getattr(back.gaussians, name).numpy(),
                                      getattr(gs, name).numpy(), err_msg=name)


def test_data_device_policy():
    """data_device="cpu" keeps the image on the CPU whatever the camera's
    device; any other value (gs_tpu's "tpu" from an old cfg_args too)
    stages it with the matrices. The "meta" device stands in for the card."""
    args = dict(R=np.eye(3), T=np.array([0.0, 0.0, 4.0]), fovx=1.0, fovy=0.8, width=8, height=6,
                image=np.ones((3, 6, 8), np.float32))
    cam = cameras.make_camera(**args, device="meta", data_device="cpu")
    assert cam.view.device.type == "meta" and cam.image.device.type == "cpu"
    for data_device in (None, "cuda", "tpu"):
        cam = cameras.make_camera(**args, device="meta", data_device=data_device)
        assert cam.image.device.type == "meta"


# --- checkpoints and cfg_args ----------------------------------------------------------------


def _train_state_arrays(deg=2):
    arr = scene_arrays(n=64, sh_degree=deg, seed=61, dead=5)
    rng = np.random.default_rng(62)
    groups = {"xyz": (3,), "f_dc": (1, 3), "f_rest": ((deg + 1) ** 2 - 1, 3), "opacity": (1,),
              "scaling": (3,), "rotation": (4,)}
    moments = {name: {k: rng.normal(size=(64, *s)).astype(np.float32) for k, s in groups.items()}
               for name in ("mu", "nu")}
    steps = {k: int(v) for k, v in zip(groups, rng.integers(1, 500, size=len(groups)))}
    stats = [rng.uniform(size=64).astype(np.float32) for _ in range(3)]
    return arr, moments, steps, stats


def test_checkpoints_cross_load(tmp_path):
    check_checkpoints_cross_load(tmp_path, 2)


def check_checkpoints_cross_load(tmp_path, deg):
    """A checkpoint of SH degree ``deg`` written by either package loads in
    the other, bitwise, and the two files hold the same keys, dtypes and
    values."""
    arr, moments, steps, stats = _train_state_arrays(deg)
    ts = training.init_train_state(interop.state_from_numpy(arr, "cpu"), 2.5, deg)
    ts.adam = interop.adam_from_numpy(moments["mu"], moments["nu"], steps, "cpu")
    ts.stats = interop.stats_from_numpy(*stats, device="cpu")
    ts.iteration = 1234
    ckpt.save_train_state(str(tmp_path / "port.npz"), ts)
    j_ts = j_ckpt.load_train_state(str(tmp_path / "port.npz"))
    j_ckpt.save_train_state(str(tmp_path / "gs_tpu.npz"), j_ts)
    back = ckpt.load_train_state(str(tmp_path / "gs_tpu.npz"), device="cpu")
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "gs_tpu.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert (j_ts.iteration, j_ts.spatial_lr_scale, j_ts.max_sh_degree) == (1234, 2.5, deg)
    assert (back.iteration, back.spatial_lr_scale, back.max_sh_degree) == (1234, 2.5, deg)
    assert back.state.max_sh_degree == j_ts.state.max_sh_degree == deg
    for f in dataclasses.fields(ts.state):
        np.testing.assert_array_equal(getattr(back.state, f.name).numpy(),
                                      getattr(ts.state, f.name).numpy(), err_msg=f.name)
        np.testing.assert_array_equal(np.asarray(getattr(j_ts.state, f.name)),
                                      getattr(ts.state, f.name).numpy(), err_msg=f.name)
    for name in ("mu", "nu"):
        for k, v in moments[name].items():
            np.testing.assert_array_equal(getattr(back.adam, name)[k].numpy(), v)
            np.testing.assert_array_equal(np.asarray(getattr(j_ts.adam, name)[k]), v)
    assert back.adam.step == steps
    assert {k: int(v) for k, v in j_ts.adam.step.items()} == steps
    for g, w in zip(back.stats, stats):
        np.testing.assert_array_equal(g.numpy(), w)


def test_checkpoint_of_gs_tpu_training_loads(tmp_path):
    """gs_tpu's own TrainState of a fresh point cloud, saved by gs_tpu, loads
    in the port with every leaf equal."""
    pts = np.random.default_rng(63).uniform(-1, 1, (50, 3)).astype(np.float32)
    cols = np.random.default_rng(64).uniform(0, 1, (50, 3)).astype(np.float32)
    j_ts = j_training.init_train_state(j_gaussians.create_from_pcd(pts, cols, 1), 3.0, 1)
    j_ckpt.save_train_state(str(tmp_path / "c.npz"), j_ts)
    ts = ckpt.load_train_state(str(tmp_path / "c.npz"), device="cpu")
    assert ts.state.capacity == 4096 and ts.state.max_sh_degree == 1
    assert int(ts.state.num_alive) == 50 and ts.adam.step == {k: 0 for k in ts.adam.step}
    np.testing.assert_array_equal(ts.state.log_scale.numpy(), np.asarray(j_ts.state.log_scale))
    assert set(ts.adam.mu) == set(j_ts.adam.mu)


def test_checkpoint_directory_round_trip(tmp_path):
    """A path without ``.npz`` is a checkpoint directory (gs_tpu's orbax
    backend, here ``torch.distributed.checkpoint``): it round-trips every
    leaf bitwise, holds the same flat keys, dtypes and values as the
    ``.npz`` of the same state, and loads whole."""
    arr, moments, steps, stats = _train_state_arrays()
    ts = training.init_train_state(interop.state_from_numpy(arr, "cpu"), 2.5, 2)
    ts.adam = interop.adam_from_numpy(moments["mu"], moments["nu"], steps, "cpu")
    ts.stats = interop.stats_from_numpy(*stats, device="cpu")
    ts.iteration = 77
    ckpt.save_train_state(str(tmp_path / "ckpt_dir"), ts)
    assert (tmp_path / "ckpt_dir").is_dir()
    back = ckpt.load_train_state(str(tmp_path / "ckpt_dir"), device="cpu")
    want, got = ckpt.to_flat_dict(ts), ckpt.to_flat_dict(back)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (back.iteration, back.spatial_lr_scale, back.max_sh_degree) == (77, 2.5, 2)
    assert back.adam.step == steps
    # written again over itself, it reads back the newer state
    ts.iteration = 78
    ckpt.save_train_state(str(tmp_path / "ckpt_dir"), ts)
    assert ckpt.load_train_state(str(tmp_path / "ckpt_dir"), device="cpu").iteration == 78


def test_cfg_args_read_by_each(tmp_path):
    """cfg_args written by either package are read by the other."""
    mp = ModelParams(source_path="/some/data", sh_degree=3, eval=True, resolution=2,
                     data_device="cpu")
    args_mod.save_cfg_args(str(tmp_path), mp)
    text = (tmp_path / "cfg_args").read_text()
    assert vars(j_args.parse_saved_namespace(text)) == vars(args_mod.parse_saved_namespace(text))
    assert vars(args_mod.parse_saved_namespace(text)) == dataclasses.asdict(mp)
    jmp = JModelParams(source_path="/other", white_background=True, model_path="/m")
    j_args.save_cfg_args(str(tmp_path), jmp)
    ns = args_mod.parse_saved_namespace((tmp_path / "cfg_args").read_text())
    assert vars(ns) == dataclasses.asdict(jmp)
    assert args_mod.extract(ModelParams, ns).data_device == "tpu"  # staged like "cuda"


# --- on the card -----------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return "cuda"


@pytest.mark.cuda
def test_cuda_scene_and_checkpoint(cuda_device, colmap_scene, tmp_path):
    """The Scene on the card equals the Scene on the CPU (cameras, images,
    initial Gaussians but the 3-NN scales, which the card's sums may round
    otherwise); data_device="cpu" keeps the images on the CPU; a checkpoint
    saved from the card loads on the CPU bitwise."""
    path, _, _ = colmap_scene
    kw = dict(source_path=str(path), eval=True, resolution=2)
    random.seed(5)
    cpu = scene.Scene(ModelParams(model_path=str(tmp_path / "cpu"), **kw), device="cpu")
    random.seed(5)
    card = scene.Scene(ModelParams(model_path=str(tmp_path / "card"), **kw), device=cuda_device)
    random.seed(5)
    staged = scene.Scene(ModelParams(model_path=str(tmp_path / "staged"), data_device="cpu", **kw),
                         device=cuda_device)
    for g, w, h in zip(card.get_train_cameras(), cpu.get_train_cameras(),
                       staged.get_train_cameras()):
        assert g.view.device.type == "cuda" and h.image.device.type == "cpu"
        for name in ("view", "full_proj", "image"):
            np.testing.assert_array_equal(getattr(g, name).cpu().numpy(),
                                          getattr(w, name).numpy(), err_msg=name)
        np.testing.assert_array_equal(h.image.numpy(), w.image.numpy())
    for name in ("xyz", "features_dc", "quat", "logit_opacity", "alive"):
        np.testing.assert_array_equal(getattr(card.gaussians, name).cpu().numpy(),
                                      getattr(cpu.gaussians, name).numpy(), err_msg=name)
    ts = training.init_train_state(card.gaussians, card.cameras_extent, 0)
    ckpt.save_train_state(str(tmp_path / "c.npz"), ts)
    back = ckpt.load_train_state(str(tmp_path / "c.npz"), device="cpu")
    for f in dataclasses.fields(ts.state):
        np.testing.assert_array_equal(getattr(back.state, f.name).numpy(),
                                      getattr(ts.state, f.name).cpu().numpy(), err_msg=f.name)
