"""gs_tpu_torch's loader of the native data-plane library (``data/native.py``).

Twins of ``tests/test_native.py`` through the port's loader (skipped, as
gs_tpu's fixture skips, when the tracked ``native/libgs_native.so`` does not
load); the port's native reads against gs_tpu's native reads and against the
port's Python parsers; and the one kept difference: a missing file raises
``FileNotFoundError``, so ``read_colmap_scene`` reaches its text fallback.
"""

import math
import os

import numpy as np
import pytest
from PIL import Image

from gs_tpu.data import native as j_native
from gs_tpu.data import readers as j_readers
from gs_tpu_torch.data import colmap, native, ply, readers


@pytest.fixture(scope="module")
def native_mod():
    if not native.available():
        pytest.skip("native/libgs_native.so failed to load")
    return native


@pytest.fixture
def colmap_files(tmp_path):
    """test_native.py:28-52's files, written by the port's writers."""
    rng = np.random.default_rng(0)
    cams = {
        1: colmap.ColmapCamera(1, "PINHOLE", 640, 480, np.array([500.0, 501.0, 320.0, 240.0])),
        3: colmap.ColmapCamera(3, "SIMPLE_PINHOLE", 800, 600, np.array([450.0, 400.0, 300.0])),
    }
    images = {
        i: colmap.ColmapImage(i, rng.normal(size=4), rng.normal(size=3), 1 + 2 * (i % 2),
                              f"frame_{i:04d}.jpg")
        for i in range(1, 6)
    }
    xyz = rng.normal(size=(37, 3))
    rgb = rng.integers(0, 255, (37, 3)).astype(np.uint8)
    colmap.write_cameras_binary(cams, str(tmp_path / "cameras.bin"))
    colmap.write_images_binary(images, str(tmp_path / "images.bin"))
    colmap.write_points3d_binary(xyz, rgb, str(tmp_path / "points3D.bin"))
    return tmp_path, cams, images, xyz, rgb


class TestColmapNative:
    def test_points3d_parity(self, native_mod, colmap_files):
        path, _, _, xyz, rgb = colmap_files
        nx, nr, ne = native_mod.read_points3d_binary(str(path / "points3D.bin"))
        np.testing.assert_array_equal(nx, xyz)
        np.testing.assert_array_equal(nr, rgb)
        assert ne.shape == (37,)

    def test_images_parity(self, native_mod, colmap_files):
        path, _, images, _, _ = colmap_files
        got = native_mod.read_images_binary(str(path / "images.bin"))
        assert len(got) == len(images)
        for image_id, qvec, tvec, camera_id, name in got:
            ref = images[image_id]
            np.testing.assert_array_equal(qvec, ref.qvec)
            np.testing.assert_array_equal(tvec, ref.tvec)
            assert camera_id == ref.camera_id
            assert name == ref.name

    def test_cameras_parity(self, native_mod, colmap_files):
        path, cams, _, _, _ = colmap_files
        got = native_mod.read_cameras_binary(str(path / "cameras.bin"))
        assert len(got) == len(cams)
        for cam_id, model_id, w, h, params in got:
            ref = cams[cam_id]
            assert colmap.CAMERA_MODELS[model_id][0] == ref.model
            assert (w, h) == (ref.width, ref.height)
            np.testing.assert_array_equal(params, ref.params)

    def test_dispatch_through_colmap_module(self, native_mod, colmap_files, monkeypatch):
        # the public readers route through native when available
        path, cams, images, xyz, _ = colmap_files
        calls = []
        for name in ("read_cameras_binary", "read_images_binary", "read_points3d_binary"):
            real = getattr(native_mod, name)
            monkeypatch.setattr(native_mod, name,
                                lambda p, _real=real, _n=name: calls.append(_n) or _real(p))
        rcams = colmap.read_cameras_binary(str(path / "cameras.bin"))
        rimgs = colmap.read_images_binary(str(path / "images.bin"))
        rxyz, _, _ = colmap.read_points3d_binary(str(path / "points3D.bin"))
        assert set(rcams) == set(cams) and set(rimgs) == set(images)
        np.testing.assert_array_equal(rxyz, xyz)
        assert calls == ["read_cameras_binary", "read_images_binary", "read_points3d_binary"]


class TestPlyNative:
    def test_gaussian_ply_roundtrip(self, native_mod, tmp_path):
        rng = np.random.default_rng(1)
        names = ["x", "y", "z", "opacity"]
        data = rng.normal(size=(11, 4)).astype(np.float32)
        p = str(tmp_path / "g.ply")
        native_mod.write_ply_f32(p, names, data)
        got_names, got = native_mod.read_ply_f32(p)
        assert got_names == names
        np.testing.assert_array_equal(got, data)
        # the port's python reader agrees on the same bytes
        v = ply.read_ply(p)
        assert list(v.dtype.names) == names
        np.testing.assert_array_equal(np.stack([v[n] for n in names], 1), data)

    def test_native_reads_python_written_snapshot(self, native_mod, tmp_path):
        n, k1 = 7, 3
        rng = np.random.default_rng(2)
        p = str(tmp_path / "snap.ply")
        ply.save_gaussian_ply(
            p,
            rng.normal(size=(n, 3)).astype(np.float32),
            rng.normal(size=(n, 1, 3)).astype(np.float32),
            rng.normal(size=(n, k1, 3)).astype(np.float32),
            rng.normal(size=(n, 1)).astype(np.float32),
            rng.normal(size=(n, 3)).astype(np.float32),
            rng.normal(size=(n, 4)).astype(np.float32),
        )
        names, data = native_mod.read_ply_f32(p)
        ref = ply.read_ply(p)
        assert names == list(ref.dtype.names)
        np.testing.assert_array_equal(data, np.stack([ref[nm] for nm in names], 1))


def _python_read(monkeypatch, reader, path):
    """The port's reader with the library reported unavailable: its struct parser."""
    with monkeypatch.context() as m:
        m.setattr(native, "available", lambda: False)
        return reader(path)


@pytest.mark.parametrize("name", ["cameras", "images", "points3D"])
def test_native_reads_equal_gs_tpu_and_python(native_mod, colmap_files, monkeypatch, name):
    """The port's native read equals gs_tpu's native read (the same library)
    and the port's Python parser, field by field and bitwise."""
    path = str(colmap_files[0] / f"{name}.bin")
    fn = {"cameras": "read_cameras_binary", "images": "read_images_binary",
          "points3D": "read_points3d_binary"}[name]
    ours, theirs = getattr(native_mod, fn)(path), getattr(j_native, fn)(path)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
            assert type(x) is type(y)
    via_native = getattr(colmap, fn)(path)
    via_python = _python_read(monkeypatch, getattr(colmap, fn), path)
    if name == "points3D":
        for x, y in zip(via_native, via_python):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    else:
        assert via_native.keys() == via_python.keys()
        for key in via_native:
            a, b = via_native[key], via_python[key]
            for field in a.__dataclass_fields__:
                np.testing.assert_array_equal(getattr(a, field), getattr(b, field))


@pytest.mark.parametrize("fn", ["read_cameras_binary", "read_images_binary",
                                "read_points3d_binary"])
def test_missing_file_raises_file_not_found(native_mod, tmp_path, fn):
    """The kept difference: the port's loader raises FileNotFoundError for a
    missing file, gs_tpu's an OSError that is not one."""
    path = str(tmp_path / "missing.bin")
    with pytest.raises(FileNotFoundError):
        getattr(native_mod, fn)(path)
    with pytest.raises(OSError) as info:
        getattr(j_native, fn)(path)
    assert not isinstance(info.value, FileNotFoundError)


def test_missing_images_bin_reaches_the_text_fallback(native_mod, tmp_path):
    """With the library loaded, a sparse/0 holding images.txt and cameras.txt
    beside cameras.bin but no images.bin gives the port's text fallback the
    scene the binary files give; gs_tpu's reader raises there instead."""
    rng = np.random.default_rng(4)
    sparse = tmp_path / "sparse" / "0"
    sparse.mkdir(parents=True)
    (tmp_path / "images").mkdir()
    cams = {1: colmap.ColmapCamera(1, "PINHOLE", 32, 24, np.array([30.0, 31.0, 16.0, 12.0]))}
    imgs = {}
    for i in range(6):
        ang = 2 * math.pi * i / 6
        qvec = np.array([math.cos(ang / 2), 0.0, math.sin(ang / 2), 0.0])
        imgs[i + 1] = colmap.ColmapImage(i + 1, qvec, np.array([0.0, 0.1 * i, 4.0]), 1,
                                         f"im_{i}.png")
        Image.fromarray(rng.integers(0, 255, (24, 32, 3)).astype(np.uint8)).save(
            tmp_path / "images" / f"im_{i}.png")
    colmap.write_cameras_binary(cams, str(sparse / "cameras.bin"))
    colmap.write_images_binary(imgs, str(sparse / "images.bin"))
    colmap.write_points3d_binary(rng.uniform(-1, 1, (50, 3)), rng.integers(0, 255, (50, 3)),
                                 str(sparse / "points3D.bin"))
    want = readers.read_colmap_scene(str(tmp_path))

    def words(v):
        return " ".join(repr(float(x)) for x in v)

    (sparse / "cameras.txt").write_text("".join(
        f"{c.camera_id} {c.model} {c.width} {c.height} {words(c.params)}\n"
        for c in cams.values()))
    (sparse / "images.txt").write_text("".join(
        f"{im.image_id} {words(im.qvec)} {words(im.tvec)} {im.camera_id} {im.name}\n0 0 -1\n"
        for im in imgs.values()))
    os.remove(sparse / "images.bin")
    got = readers.read_colmap_scene(str(tmp_path))
    assert len(got.train_cameras) == len(want.train_cameras) == 6
    for a, b in zip(got.train_cameras, want.train_cameras):
        for field in a.__dataclass_fields__:
            x, y = getattr(a, field), getattr(b, field)
            if isinstance(x, np.ndarray):
                np.testing.assert_array_equal(x, y, err_msg=field)
            else:
                assert x == y, field
    with pytest.raises(OSError) as info:
        j_readers.read_colmap_scene(str(tmp_path))
    assert not isinstance(info.value, FileNotFoundError)
