"""gs_tpu_torch's metrics, full-eval and convert CLIs on the CPU.

The metrics CLI against gs_tpu's on the same PNG folders; full_eval and
convert with ``os.system`` patched in both packages (their legs are the
external ``colmap`` / ``magick`` binaries and 30,000-iteration runs); and
the port's train -> render -> metrics run on ``tests/test_cli.py``'s
Blender scene.
"""

import json
import math
import os
import re
import shutil
import sys

import numpy as np
import pytest
from PIL import Image

from gs_tpu.cli import convert as j_convert
from gs_tpu.cli import full_eval as j_full_eval
from gs_tpu.cli import metrics as j_metrics
from gs_tpu.utils import lpips as j_lpips
from gs_tpu_torch.cli import convert, full_eval, metrics
from gs_tpu_torch.utils import lpips
from tests.torch_port_inputs import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def no_lpips_weights(monkeypatch, tmp_path):
    """No weights file, as on both machines: LPIPS is null in both packages."""
    monkeypatch.setenv("GS_TPU_LPIPS_WEIGHTS", str(tmp_path / "no_weights.npz"))
    lpips._load_weights.cache_clear()
    j_lpips._load_weights.cache_clear()
    stdout = sys.stdout
    yield
    sys.stdout = stdout  # gs_tpu's CLIs replace it for good
    lpips._load_weights.cache_clear()
    j_lpips._load_weights.cache_clear()


def _model_dir(root, seed=0, methods=("ours_7", "ours_30"), views=3, size=(30, 40)):
    """<root>/test/<method>/{renders,gt}/*.png: noisy renders of random ground truth."""
    rng = np.random.default_rng(seed)
    for m, method in enumerate(methods):
        for sub in ("renders", "gt"):
            os.makedirs(root / "test" / method / sub)
        for i in range(views):
            gt = rng.integers(0, 256, (*size, 3))
            render = np.clip(gt + rng.normal(0, 8 * (m + 1), gt.shape), 0, 255)
            Image.fromarray(gt.astype(np.uint8)).save(root / "test" / method / "gt" / f"{i:05d}.png")
            Image.fromarray(render.astype(np.uint8)).save(
                root / "test" / method / "renders" / f"{i:05d}.png")
    return root


def _results(root):
    with open(root / "results.json") as f, open(root / "per_view.json") as g:
        return json.load(f), json.load(g)


@pytest.mark.parametrize("views", [1, 3])
def test_metrics_match_gs_tpu(tmp_path, views):
    """results.json / per_view.json: gs_tpu's keys and layout, SSIM and PSNR
    within 1e-5, LPIPS null in both."""
    ours_root = _model_dir(tmp_path / "ours", views=views)
    theirs_root = tmp_path / "theirs"
    shutil.copytree(ours_root, theirs_root)
    full = metrics.main(["-m", str(ours_root)], device="cpu")
    j_metrics.main(["-m", str(theirs_root)])
    (res, per_view), (j_res, j_per_view) = _results(ours_root), _results(theirs_root)
    assert full == {str(ours_root): res}
    assert res.keys() == j_res.keys() == {"ours_7", "ours_30"}
    for method in res:
        assert res[method].keys() == j_res[method].keys() == {"SSIM", "PSNR", "LPIPS"}
        assert res[method]["LPIPS"] is None and j_res[method]["LPIPS"] is None
        for key in ("SSIM", "PSNR"):
            assert res[method][key] == pytest.approx(j_res[method][key], abs=1e-5)
        assert per_view[method].keys() == j_per_view[method].keys()
        assert per_view[method]["LPIPS"] == j_per_view[method]["LPIPS"] == {}
        for key in ("SSIM", "PSNR"):
            assert per_view[method][key].keys() == j_per_view[method][key].keys()
            assert len(per_view[method][key]) == views
            for name, v in per_view[method][key].items():
                assert v == pytest.approx(j_per_view[method][key][name], abs=1e-5)
    assert res["ours_7"]["PSNR"] > res["ours_30"]["PSNR"]  # less noise, higher PSNR


def test_metrics_scene_failure_is_reported_and_the_next_goes_on(tmp_path, capsys):
    """The reference's per-scene handler: a scene without test/ prints
    "Unable to compute metrics ..." and the other scene is still scored."""
    good = _model_dir(tmp_path / "good", views=1, methods=("ours_1",))
    missing = tmp_path / "missing"
    missing.mkdir()
    full = metrics.main(["-m", str(missing), str(good)], device="cpu")
    assert f"Unable to compute metrics for model {missing}" in capsys.readouterr().out
    assert full[str(missing)] == {} and set(full[str(good)]) == {"ours_1"}
    assert not (missing / "results.json").exists() and (good / "results.json").exists()


def test_metrics_default_device_is_the_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        metrics.main(["-m", str(_model_dir(tmp_path / "m", views=1, methods=("ours_1",)))])


def _flags(main, capsys):
    with pytest.raises(SystemExit):
        main(["--help"])
    return set(re.findall(r"(?<![\w-])(--?\w+)", capsys.readouterr().out))


@pytest.mark.parametrize("pair", ["metrics", "full_eval", "convert"])
def test_flags_match_gs_tpu(pair, capsys):
    ours, theirs = {"metrics": (metrics, j_metrics), "full_eval": (full_eval, j_full_eval),
                    "convert": (convert, j_convert)}[pair]
    assert _flags(ours.main, capsys) == _flags(theirs.main, capsys)


def _commands(monkeypatch, main, argv, rc=0):
    """Run ``main(argv)`` with os.system recording its commands."""
    issued = []
    monkeypatch.setattr(os, "system", lambda cmd: issued.append(cmd) or rc)
    main(argv)
    return issued


@pytest.mark.parametrize("argv", [
    ["-m360", "/data/m360"],
    ["-tat", "/data/tat", "--output_path", "/out"],
    ["-db", "/data/db", "--skip_training"],
    ["-m360", "/a", "-tat", "/b", "-db", "/c", "--skip_rendering"],
    ["-tat", "/data/tat", "--skip_training", "--skip_rendering"],
    ["-db", "/data/db", "--skip_metrics"],
])
def test_full_eval_commands_match_gs_tpu(monkeypatch, argv):
    """The same scene lists, flags and legs as gs_tpu's, each leg a
    ``python -m gs_tpu_torch.cli.*`` where gs_tpu runs its root scripts."""
    ours = _commands(monkeypatch, full_eval.main, argv)
    theirs = _commands(monkeypatch, j_full_eval.main, argv)
    assert len(ours) == len(theirs) > 0
    py = sys.executable
    for leg in ("train", "render", "metrics"):
        theirs = [c.replace(f"{py} {REPO}/{leg}.py", f"{py} -m gs_tpu_torch.cli.{leg}")
                  for c in theirs]
    assert ours == theirs
    assert all(c.startswith(f"{py} -m gs_tpu_torch.cli.") for c in ours)


def test_full_eval_needs_a_dataset_root(monkeypatch):
    for main in (full_eval.main, j_full_eval.main):
        with pytest.raises(SystemExit):
            _commands(monkeypatch, main, ["--skip_training"])


def _convert_tree(root):
    """A dataset as convert finds it after colmap's undistorter: input/,
    sparse/ with the model's files, images/."""
    for d in ("input", "sparse", "images"):
        os.makedirs(root / d)
    for f in ("cameras.bin", "images.bin", "points3D.bin"):
        (root / "sparse" / f).write_bytes(f.encode())
    for name in ("a.jpg", "b.jpg"):
        (root / "images" / name).write_bytes(name.encode())
        (root / "input" / name).write_bytes(name.encode())
    return root


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


@pytest.mark.parametrize("flags", [
    [],
    ["--no_gpu", "--camera", "PINHOLE"],
    ["--skip_matching"],
    ["--resize"],
    ["--colmap_executable", "/opt/colmap bin/colmap", "--magick_executable", "/usr/bin/magick",
     "--resize"],
])
def test_convert_matches_gs_tpu(monkeypatch, tmp_path, flags):
    """convert's command strings, the sparse/0 reshuffle and the pyramid
    copies are gs_tpu's."""
    runs = []
    for name, main in (("ours", convert.main), ("theirs", j_convert.main)):
        root = _convert_tree(tmp_path / name)
        cmds = _commands(monkeypatch, main, ["-s", str(root), *flags])
        runs.append(([c.replace(str(root), "<src>") for c in cmds], _tree(root)))
    assert runs[0] == runs[1]
    cmds, tree = runs[0]
    assert "sparse/0/cameras.bin" in tree and "sparse/cameras.bin" not in tree
    assert len(cmds) == (1 if "--skip_matching" in flags else 4) + 6 * ("--resize" in flags)
    if "--resize" in flags:
        assert "images_8/a.jpg" in tree


@pytest.mark.parametrize("fail_at", [0, 3])
def test_convert_failure_exits_like_gs_tpu(monkeypatch, tmp_path, fail_at):
    """A failing colmap step exits with status 1 after the same commands."""
    runs = []
    for name, main in (("ours", convert.main), ("theirs", j_convert.main)):
        root = _convert_tree(tmp_path / name)
        issued = []

        def system(cmd):
            issued.append(cmd.replace(str(root), "<src>"))
            return 1 if len(issued) - 1 == fail_at else 0

        monkeypatch.setattr(os, "system", system)
        with pytest.raises(SystemExit) as info:
            main(["-s", str(root)])
        runs.append((info.value.code, issued))
    assert runs[0] == runs[1] and runs[0][0] == 1 and len(runs[0][1]) == fail_at + 1


@pytest.fixture
def blender_scene(tmp_path):
    """tests/test_cli.py:30-47's Blender scene: 4 train + 2 test RGBA views."""
    rng = np.random.default_rng(5)
    for split, count in [("train", 4), ("test", 2)]:
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


def test_train_render_metrics_end_to_end(blender_scene, tmp_path):
    """test_cli.py:131's run through the port's CLIs on the CPU: train 4
    iterations, render the 2 test views, score them; the scores equal
    gs_tpu's metrics CLI on the same PNGs. The scene's ``points3d.ply`` is
    written first with 2,000 points drawn as the reader draws its 100,000
    (which it writes there on a first load): on the CPU the 100,000-point
    3-NN takes ~40 s and every render of them in one 6x5 tile ~10 s."""
    from gs_tpu_torch.cli import render as render_cli
    from gs_tpu_torch.cli import train as train_cli
    from gs_tpu_torch.data import ply

    rng = np.random.default_rng(6)
    xyz = rng.random((2000, 3)) * 2.6 - 1.3
    colors = ((rng.random((2000, 3)) / 255.0 * 0.28209479177387814 + 0.5) * 255.0)
    ply.write_pointcloud_ply(str(blender_scene / "points3d.ply"), xyz.astype(np.float32),
                             colors.astype(np.uint8))

    out = tmp_path / "model"
    train_cli.main(["-s", str(blender_scene), "-m", str(out), "-r", "8", "-w", "--eval",
                    "--iterations", "4", "--test_iterations", "2", "--save_iterations", "4",
                    "--checkpoint_iterations", "4", "--quiet", "--disable_viewer"],
                   device="cpu")
    assert (out / "cfg_args").exists() and (out / "chkpnt4.npz").exists()
    assert (out / "point_cloud" / "iteration_4" / "point_cloud.ply").exists()
    render_cli.main(["-m", str(out), "--iteration", "4", "--quiet"], device="cpu")
    test_dir = out / "test" / "ours_4"
    assert len(os.listdir(test_dir / "renders")) == len(os.listdir(test_dir / "gt")) == 2

    full = metrics.main(["-m", str(out)], device="cpu")
    (method_metrics,) = full[str(out)].values()
    assert 0.0 < method_metrics["PSNR"] < 60.0 and math.isfinite(method_metrics["PSNR"])
    assert -1.0 <= method_metrics["SSIM"] <= 1.0
    assert method_metrics["LPIPS"] is None
    res, per_view = _results(out)
    j_metrics.main(["-m", str(out)])
    j_res, _ = _results(out)
    assert res.keys() == j_res.keys() == {"ours_4"}
    for key in ("SSIM", "PSNR"):
        assert res["ours_4"][key] == pytest.approx(j_res["ours_4"][key], abs=1e-5)
