"""gs_tpu_torch's train and render CLIs on the CPU.

Twins of ``tests/test_cli.py``'s args tests against gs_tpu's ``cli/args``,
the train flag set against gs_tpu's, the mesh flags of both layouts in a
one-process world, ``--profile_dir``, the default viewer and
autotune, and train -> resume -> render through ``main(argv, device="cpu")`` on
test_cli.py's synthetic COLMAP scene (gs_tpu's CLI is not run here: it
takes minutes on the CPU). The same run on the card is marked ``cuda``.
"""

import json
import math
import os
import re
import sys
from argparse import ArgumentParser

import numpy as np
import pytest
import torch
from PIL import Image

from gs_tpu.cli import args as j_args
from gs_tpu.cli import train as j_train_cli
from gs_tpu.config import ModelParams as JModelParams
from gs_tpu_torch.cli import args as args_mod
from gs_tpu_torch.cli import render as render_cli
from gs_tpu_torch.cli import train as train_cli
from gs_tpu_torch.config import ModelParams, RasterizeConfig
from gs_tpu_torch.data import colmap, ply
from gs_tpu_torch.scene import Scene
from gs_tpu_torch.training import eval_render
from gs_tpu_torch.utils import ckpt


class TestArgsSystem:
    def test_shorthands_and_defaults(self):
        argv = ["-s", "/data", "-m", "/out", "-w", "--eval", "-r", "4", "-i", "imgs"]
        namespaces = []
        for mod, cls in ((args_mod, ModelParams), (j_args, JModelParams)):
            parser = ArgumentParser()
            mod.add_group(parser, cls, "Model Parameters")
            namespaces.append(vars(parser.parse_args(argv)))
        ns, j_ns = namespaces
        assert ns["source_path"] == "/data" and ns["model_path"] == "/out"
        assert ns["white_background"] is True and ns["eval"] is True
        assert ns["sh_degree"] == 0 and ns["resolution"] == 4 and ns["images"] == "imgs"
        # the one default that differs: where images are staged
        assert (ns.pop("data_device"), j_ns.pop("data_device")) == ("cuda", "tpu")
        assert ns == j_ns

    def test_cfg_args_roundtrip(self, tmp_path):
        mp = ModelParams(source_path="/some/data", sh_degree=3, eval=True)
        args_mod.save_cfg_args(str(tmp_path), mp)
        ns = args_mod.parse_saved_namespace((tmp_path / "cfg_args").read_text())
        assert ns.source_path == "/some/data" and ns.sh_degree == 3 and ns.eval is True
        assert args_mod.extract(ModelParams, ns) == mp

    @pytest.mark.parametrize("text", ["__import__('os').system('true')",
                                      "Namespace(x=__import__('os'))"])
    def test_saved_namespace_rejects_code(self, text):
        for mod in (args_mod, j_args):
            with pytest.raises((ValueError, SyntaxError)):
                mod.parse_saved_namespace(text)

    def test_combined_args_match_gs_tpu(self, tmp_path):
        """A saved cfg_args merged with a command line, as gs_tpu merges it."""
        args_mod.save_cfg_args(str(tmp_path), ModelParams(source_path="/d", sh_degree=2,
                                                          model_path=str(tmp_path)))
        argv = ["-m", str(tmp_path), "--iteration", "7", "-r", "2"]
        merged = []
        for mod, cls in ((args_mod, ModelParams), (j_args, JModelParams)):
            parser = ArgumentParser()
            mod.add_group(parser, cls, "Model Parameters", sentinel=True)
            parser.add_argument("--iteration", default=-1, type=int)
            merged.append(vars(mod.get_combined_args(parser, argv)))
        assert merged[0] == merged[1]
        assert merged[0]["resolution"] == 2 and merged[0]["sh_degree"] == 2


def _flags(main, capsys):
    with pytest.raises(SystemExit):
        main(["--help"])
    return set(re.findall(r"(?<![\w-])(--?\w+)", capsys.readouterr().out))


def test_train_flags_match_gs_tpu(capsys):
    """Every flag of gs_tpu's train CLI, and no other, so command lines carry over."""
    assert _flags(train_cli.main, capsys) == _flags(j_train_cli.main, capsys)


@pytest.mark.parametrize("flags", [["--data_parallel", "2"], ["--shard_parallel", "4"],
                                   ["--profile_dir", "trace"]])
def test_unported_flags_raise(tmp_path, flags, colmap_scene, monkeypatch):
    """A mesh larger than the one-process world raises make_mesh's mesh-size
    error before anything is written (training across devices is ported for
    the tile layout, and needs a process a device); ``--profile_dir`` reaches run_training, whose window
    defaults to gs_tpu's iterations 50-60 (shortened here to 2-3 of a
    4-iteration run, so the CPU does not train 60), and writes a trace."""
    out = tmp_path / "model"
    if flags[0] == "--profile_dir":
        import inspect

        from gs_tpu_torch import training

        run = training.run_training
        assert inspect.signature(run).parameters["profile_iters"].default == (50, 60)
        seen = []

        def short_window(*args, **kwargs):
            seen.append(kwargs)
            assert "profile_iters" not in kwargs  # the CLI keeps the default window
            return run(*args, **kwargs, profile_iters=(2, 3))

        monkeypatch.setattr(training, "run_training", short_window)
        trace_dir = tmp_path / flags[1]
        train_cli.main(["-s", str(colmap_scene), "-m", str(out), "--iterations", "4",
                        "--test_iterations", "-1", "--disable_viewer", "--quiet",
                        "--profile_dir", str(trace_dir)], device="cpu")
        assert [k["profile_dir"] for k in seen] == [str(trace_dir)]
        # the Chrome trace, and the window's span table beside it
        spans, traces = sorted(os.listdir(trace_dir))
        assert spans.startswith("spans_") and traces.startswith("trace_")
        assert spans.endswith(".json") and traces.endswith(".json")
        events = json.loads((trace_dir / traces).read_text())["traceEvents"]
        assert any(e.get("name", "").startswith("aten::") for e in events)
        return
    mesh = "2x1" if flags[0] == "--data_parallel" else "1x4"
    with pytest.raises(ValueError, match=f"mesh {mesh} != 1 devices"):
        train_cli.main(["-s", str(tmp_path), "-m", str(out), *flags], device="cpu")
    assert not out.exists()  # raised before anything was written


def test_gauss_layout_checks_the_mesh_first(tmp_path):
    """``--parallel_layout gauss`` trains across processes; in a world of
    one process its 1 x 2 mesh raises make_mesh's error, as the tile
    layout's does, before anything is written."""
    out = tmp_path / "model"
    with pytest.raises(ValueError, match="mesh 1x2 != 1 devices"):
        train_cli.main(["-s", str(tmp_path), "-m", str(out), "--parallel_layout", "gauss",
                        "--shard_parallel", "2"], device="cpu")
    assert not out.exists()


@pytest.fixture
def colmap_scene(tmp_path):
    """test_cli.py:85-112's COLMAP dataset: 9 PINHOLE 64x48 views, 400 points."""
    rng = np.random.default_rng(0)
    root = tmp_path / "colmap"
    sparse = root / "sparse" / "0"
    sparse.mkdir(parents=True)
    img_dir = root / "images"
    img_dir.mkdir()
    cams = {1: colmap.ColmapCamera(1, "PINHOLE", 64, 48, np.array([60.0, 60.0, 32.0, 24.0]))}
    imgs = {}
    for i in range(9):
        ang = 2 * math.pi * i / 9
        qvec = np.array([math.cos(ang / 2), 0.0, math.sin(ang / 2), 0.0])
        name = f"img_{i:03d}.png"
        imgs[i + 1] = colmap.ColmapImage(i + 1, qvec, np.array([0.0, 0.0, 4.0]), 1, name)
        Image.fromarray(rng.integers(0, 255, (48, 64, 3)).astype(np.uint8)).save(img_dir / name)
    colmap.write_cameras_binary(cams, str(sparse / "cameras.bin"))
    colmap.write_images_binary(imgs, str(sparse / "images.bin"))
    colmap.write_points3d_binary(rng.uniform(-1, 1, (400, 3)), rng.integers(0, 255, (400, 3)),
                                 str(sparse / "points3D.bin"))
    return root


def train_resume_render(source, out, device, monkeypatch):
    """train -> resume from the iteration-3 checkpoint -> render, through the
    CLIs' main; checks what chip_smoke.py's CLI phase checks, at this size."""
    stdout = sys.stdout
    common = ["-s", str(source), "--eval", "--sh_degree", "1", "--iterations", "6",
              "--densify_from_iter", "2", "--densification_interval", "2",
              "--opacity_reset_interval", "5", "--disable_viewer", "--kernel_autotune", "off",
              "--quiet"]
    ts = train_cli.main([*common, "-m", str(out), "--test_iterations", "6",
                         "--save_iterations", "3", "--checkpoint_iterations", "3"], device=device)
    assert sys.stdout is stdout
    assert ts.iteration == 6
    for name in ("cfg_args", "input.ply", "cameras.json", "chkpnt3.npz",
                 "point_cloud/iteration_3/point_cloud.ply",
                 "point_cloud/iteration_6/point_cloud.ply"):
        assert (out / name).exists(), name

    restored = []  # the restored state's arrays, taken before training moves it on

    def load_and_record(*a, _load=ckpt.load_train_state, **k):
        ts = _load(*a, **k)
        restored.append(ckpt.to_flat_dict(ts))
        return ts

    monkeypatch.setattr(ckpt, "load_train_state", load_and_record)
    resumed = out.parent / (out.name + "_resumed")
    ts2 = train_cli.main([*common, "-m", str(resumed), "--test_iterations", "-1",
                          "--data_device", "cpu", "--start_checkpoint", str(out / "chkpnt3.npz")],
                         device=device)
    assert sys.stdout is stdout
    assert ts2.iteration == 6 and len(restored) == 1
    assert (resumed / "point_cloud/iteration_6/point_cloud.ply").exists()
    assert not (resumed / "point_cloud/iteration_3").exists()
    with np.load(out / "chkpnt3.npz") as z:
        assert restored[0].keys() == set(z.files)
        for key, value in restored[0].items():
            assert value.dtype == z[key].dtype, key
            np.testing.assert_array_equal(value, z[key], err_msg=key)

    render_cli.main(["-m", str(out), "--iteration", "6", "--quiet"], device=device)
    assert sys.stdout is stdout
    shown = Scene(ModelParams(source_path=str(source), model_path=str(out), eval=True),
                  load_iteration=6, shuffle=False, device=device)
    state = ply.load_gaussian_ply(str(out / "point_cloud/iteration_6/point_cloud.ply"),
                                  device=device)
    for split, cams, count in (("train", shown.get_train_cameras(), 7),
                               ("test", shown.get_test_cameras(), 2)):
        renders = sorted(os.listdir(out / split / "ours_6" / "renders"))
        assert len(renders) == len(os.listdir(out / split / "ours_6" / "gt")) == count
        for name, cam in zip(renders, cams):
            img = eval_render(state, cam, torch.zeros(3, device=state.device),
                              active_sh_degree=state.max_sh_degree, raster_cfg=RasterizeConfig())
            render_cli.save_png(str(out / "again.png"), img)
            assert (out / split / "ours_6" / "renders" / name).read_bytes() == \
                (out / "again.png").read_bytes(), f"{split}/{name}"


def test_train_resume_render(colmap_scene, tmp_path, monkeypatch):
    train_resume_render(colmap_scene, tmp_path / "model", "cpu", monkeypatch)


def test_defaults_report_what_is_not_ported(colmap_scene, tmp_path, capsys, monkeypatch):
    """The viewer and the kernel autotune are on by default, as in gs_tpu:
    the viewer listens (or prints gs_tpu's "Viewer server disabled (...)"
    when its port cannot be bound) and is closed at the end; the autotune is
    skipped silently on the CPU, as gs_tpu's is off its TPU; nothing says
    "not ported"."""
    from gs_tpu_torch.ops import autotune
    from gs_tpu_torch.viewer import network_gui

    servers, tuned = [], []
    real_server, real_tune = network_gui.GuiServer, autotune.autotune_formulation

    def server(*args, **kwargs):
        servers.append(real_server(*args, **kwargs))
        return servers[-1]

    def tune(*args, **kwargs):
        tuned.append(real_tune(*args, **kwargs))
        return tuned[-1]

    monkeypatch.setattr(network_gui, "GuiServer", server)
    monkeypatch.setattr(autotune, "autotune_formulation", tune)
    train_cli.main(["-s", str(colmap_scene), "-m", str(tmp_path / "m"), "--iterations", "1",
                    "--test_iterations", "-1"], device="cpu")
    out = capsys.readouterr().out
    assert "not ported" not in out
    if servers:
        assert (servers[0].host, servers[0].port) == ("127.0.0.1", 6009)
        assert servers[0].listener.fileno() == -1  # closed at the end
    else:
        assert re.search(r"Viewer server disabled \(.+\)", out)
    assert tuned == [None] and "[autotune]" not in out
    assert (tmp_path / "m" / "point_cloud" / "iteration_1" / "point_cloud.ply").exists()


def test_viewer_port_taken_is_reported(colmap_scene, tmp_path, capsys):
    """gs_tpu's message when the viewer's port is taken, and training goes on."""
    import socket

    with socket.socket() as taken:
        taken.bind(("127.0.0.1", 0))
        taken.listen()
        port = taken.getsockname()[1]
        train_cli.main(["-s", str(colmap_scene), "-m", str(tmp_path / "m"), "--iterations", "1",
                        "--test_iterations", "-1", "--port", str(port)], device="cpu")
    assert re.search(r"Viewer server disabled \(.*Address already in use", capsys.readouterr().out)
    assert (tmp_path / "m" / "point_cloud" / "iteration_1" / "point_cloud.ply").exists()


def test_quiet_and_stdout_restored_on_failure(tmp_path):
    """safe_state's stdout is put back even when training raises."""
    stdout = sys.stdout
    with pytest.raises(ValueError, match="scene type"):
        train_cli.main(["-s", str(tmp_path / "nowhere"), "-m", str(tmp_path / "m"), "--quiet",
                        "--disable_viewer"], device="cpu")
    assert sys.stdout is stdout


# --- on the card -----------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return "cuda"


@pytest.mark.cuda
def test_cuda_train_resume_render(cuda_device, colmap_scene, tmp_path, monkeypatch):
    train_resume_render(colmap_scene, tmp_path / "model", cuda_device, monkeypatch)
