"""gs_tpu_torch's SIBR remote-viewer server over a loopback socket.

Twins of ``tests/test_viewer.py``'s roundtrip and idle ping,
``camera_from_matrices`` against gs_tpu's, the frame bytes of both packages
for one state and one message, and ``run_training``'s viewer hook.
"""

import json
import math
import socket
import threading
import time

import numpy as np
import pytest
import torch

from gs_tpu import cameras as j_cameras
from gs_tpu.config import RasterizeConfig as JRasterizeConfig
from gs_tpu.viewer.network_gui import GuiServer as JGuiServer
from gs_tpu_torch import cameras, interop
from gs_tpu_torch.config import OptimizationParams, PipelineParams, RasterizeConfig
from gs_tpu_torch.models import gaussians
from gs_tpu_torch.training import run_training
from gs_tpu_torch.viewer.network_gui import GuiServer
from tests.torch_port_inputs import jax_state, scene_arrays, tiny_synthetic_scene
from tests.torch_port_inputs import one_torch_thread  # noqa: F401 (autouse)

CAMERA_FIELDS = ("view", "full_proj", "cam_pos", "tan_fovx", "tan_fovy", "znear", "zfar")


def _client_message(w, h, view, viewproj, train=True, keep_alive=False, shs_python=False,
                    rot_scale_python=False, fov=math.radians(60)):
    return {
        "resolution_x": w, "resolution_y": h,
        "train": train,
        "fov_y": fov, "fov_x": fov,
        "z_near": 0.01, "z_far": 100.0,
        "shs_python": shs_python, "rot_scale_python": rot_scale_python,
        "keep_alive": keep_alive,
        "scaling_modifier": 1.0,
        "view_matrix": view, "view_projection_matrix": viewproj,
    }


class _FakeTrainState:
    def __init__(self, state, active_sh_degree=0):
        self.state = state
        self.active_sh_degree = active_sh_degree
        self.iteration = 1


def _send(conn, msg):
    data = json.dumps(msg).encode()
    conn.sendall(len(data).to_bytes(4, "little"))
    conn.sendall(data)


def _recv_exact(conn, n):
    buf = b""
    while len(buf) < n:
        part = conn.recv(n - len(buf))
        assert part, "server closed early"
        buf += part
    return buf


def _wire_matrices(distance=4.0, yaw=0.0, fov=math.radians(60), w=16, h=16):
    """A view and view-projection pair in the reference's wire convention
    (transposed, Y/Z columns flipped so that the flips on receipt undo them)."""
    view = np.eye(4, dtype=np.float32)
    c, s = math.cos(yaw), math.sin(yaw)
    view[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    view[:3, 3] = [0.0, 0.0, distance]
    proj = cameras.make_projection_matrix(0.01, 100.0, fov, fov)
    flip = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
    wire_view = view.T @ flip
    flip_y = np.diag([1.0, -1.0, 1.0, 1.0]).astype(np.float32)
    wire_viewproj = (proj @ view).T @ flip_y
    return wire_view.reshape(-1).tolist(), wire_viewproj.reshape(-1).tolist()


def _serve(server, ts, cfg, msg, w, h):
    """One client message through ``server.poll``; returns (frame, verify)."""
    port = server.listener.getsockname()[1]
    received = {}

    def client():
        with socket.create_connection(("127.0.0.1", port), timeout=240) as conn:
            _send(conn, msg)
            try:
                received["image"] = _recv_exact(conn, w * h * 3)
                n = int.from_bytes(_recv_exact(conn, 4), "little")
                received["verify"] = _recv_exact(conn, n).decode("ascii")
            except AssertionError as e:  # the server closed first; poll's caller sees why
                received["error"] = e

    t = threading.Thread(target=client)
    t.start()
    try:
        deadline = time.time() + 60
        while server.conn is None and time.time() < deadline:
            server.try_connect()
            time.sleep(0.02)
        assert server.conn is not None, "client never connected"
        server.poll(ts, cfg)
        t.join(timeout=240)
        assert not t.is_alive() and "error" not in received
    finally:
        server.close()
        t.join(timeout=240)
    return received["image"], received["verify"]


def _port_state(n=32, seed=0):
    rng = np.random.default_rng(seed)
    return gaussians.create_from_pcd(rng.uniform(-1, 1, (n, 3)).astype(np.float32),
                                     rng.uniform(0, 1, (n, 3)).astype(np.float32),
                                     max_sh_degree=0, capacity=n, device="cpu")


class TestGuiServer:
    def test_protocol_roundtrip(self):
        w = h = 16
        view, viewproj = _wire_matrices()
        server = GuiServer("127.0.0.1", 0, source_path="/data/scene")
        image, verify = _serve(server, _FakeTrainState(_port_state()),
                               RasterizeConfig(chunk=32), _client_message(w, h, view, viewproj),
                               w, h)
        assert verify == "/data/scene"
        assert len(image) == w * h * 3

    def test_zero_resolution_is_idle_ping(self):
        server = GuiServer("127.0.0.1", 0)
        port = server.listener.getsockname()[1]
        result = {}

        def client():
            with socket.create_connection(("127.0.0.1", port), timeout=240) as conn:
                _send(conn, _client_message(0, 0, [], []))
                n = int.from_bytes(_recv_exact(conn, 4), "little")
                result["verify"] = _recv_exact(conn, n).decode("ascii")

        t = threading.Thread(target=client)
        t.start()
        try:
            deadline = time.time() + 60
            while server.conn is None and time.time() < deadline:
                server.try_connect()
                time.sleep(0.02)
            assert server.conn is not None
            # directly exercise receive/send for the idle message
            cam, do_training, keep_alive, _ = server.receive("cpu")
            assert cam is None and do_training is None and keep_alive is None
            server.send(None, server.source_path)
            t.join(timeout=240)
            assert not t.is_alive()
        finally:
            server.close()
        assert result["verify"] == ""

    def test_port_in_use_raises_oserror(self):
        with socket.socket() as taken:
            taken.bind(("127.0.0.1", 0))
            taken.listen()
            with pytest.raises(OSError):
                GuiServer("127.0.0.1", taken.getsockname()[1])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_camera_from_matrices_matches_gs_tpu(seed):
    """Every field of the port's matrices-only camera within 1e-6 of gs_tpu's."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    view = np.eye(4)
    view[:3, :3] = q
    view[:3, 3] = rng.normal(size=3) + [0, 0, 4]
    fovx, fovy = rng.uniform(0.4, 1.4, 2)
    proj = cameras.make_projection_matrix(0.05, 50.0, fovx, fovy) @ view
    w, h = int(rng.integers(16, 900)), int(rng.integers(16, 900))
    ours = cameras.camera_from_matrices(view, proj, fovx, fovy, w, h, 0.05, 50.0, device="cpu")
    theirs = j_cameras.camera_from_matrices(view, proj, fovx, fovy, w, h, 0.05, 50.0)
    assert (ours.width, ours.height) == (theirs.width, theirs.height) == (w, h)
    assert ours.image is None and theirs.image is None
    for f in CAMERA_FIELDS:
        got = getattr(ours, f)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(theirs, f)), rtol=0,
                                   atol=1e-6, err_msg=f)


def test_frame_bytes_match_gs_tpu():
    """The same state and message served by both packages: the frames differ
    in at most 0.1% of their bytes, each by one level at most (the packages'
    float32 sums round differently; this input: 0 of 4,320 bytes differ)."""
    w, h = 48, 30
    arrays = scene_arrays(n=512, sh_degree=1, seed=7)
    view, viewproj = _wire_matrices(distance=5.0, yaw=0.3, fov=math.radians(70), w=w, h=h)
    msg = _client_message(w, h, view, viewproj, fov=math.radians(70))
    ours, v1 = _serve(GuiServer("127.0.0.1", 0, "/s"),
                      _FakeTrainState(interop.state_from_numpy(arrays, "cpu"), 1),
                      RasterizeConfig(chunk=32), msg, w, h)
    theirs, v2 = _serve(JGuiServer("127.0.0.1", 0, "/s"),
                        _FakeTrainState(jax_state(arrays), 1),
                        JRasterizeConfig(backend="xla", chunk=32), msg, w, h)
    assert v1 == v2 == "/s"
    a = np.frombuffer(ours, np.uint8).astype(int)
    b = np.frombuffer(theirs, np.uint8).astype(int)
    assert a.shape == b.shape == (w * h * 3,)
    assert (a > 0).mean() > 0.2  # the splats cover the frame
    diff = np.abs(a - b)
    print(f"frame bytes that differ: {(diff > 0).sum()} of {a.size}, max {diff.max()}")
    assert diff.max() <= 1 and (diff > 0).sum() <= 0.001 * a.size


def test_frame_bytes_equal_the_port_render():
    """The served bytes are ``clip(render, 0, 1) * 255`` truncated to uint8, HWC."""
    from gs_tpu_torch.training import eval_render

    w, h = 40, 24
    state = interop.state_from_numpy(scene_arrays(n=256, sh_degree=0, seed=3), "cpu")
    view, viewproj = _wire_matrices(w=w, h=h)
    image, _ = _serve(GuiServer("127.0.0.1", 0), _FakeTrainState(state),
                      RasterizeConfig(chunk=32), _client_message(w, h, view, viewproj), w, h)
    wv = np.array(view, np.float32).reshape(4, 4)
    wv[:, 1:3] *= -1
    vp = np.array(viewproj, np.float32).reshape(4, 4)
    vp[:, 1] *= -1
    cam = cameras.camera_from_matrices(wv.T, vp.T, math.radians(60), math.radians(60), w, h,
                                       0.01, 100.0, device="cpu")
    img = eval_render(state, cam, torch.zeros(3), active_sh_degree=0,
                      raster_cfg=RasterizeConfig(chunk=32))
    want = (img * 255.0).numpy().astype(np.uint8).transpose(1, 2, 0).tobytes()
    assert image == want


def test_run_training_viewer_toggles_reach_pipe(monkeypatch):
    """The CLI's pipe seeds the server's toggles, a client's message overwrites
    them, and the next steps train with them (gs_tpu/training.py:289-302)."""
    from gs_tpu_torch import training

    seen = []
    step = training.train_step

    def recording(*args, pipe, **kwargs):
        seen.append((pipe.convert_SHs_python, pipe.compute_cov3D_python))
        return step(*args, pipe=pipe, **kwargs)

    monkeypatch.setattr(training, "train_step", recording)
    scene = tiny_synthetic_scene()
    server = GuiServer("127.0.0.1", 0)
    polled = []
    poll = server.poll
    monkeypatch.setattr(server, "poll", lambda *a, **k: polled.append(
        (server.convert_SHs_python, server.compute_cov3D_python)) or poll(*a, **k))
    w = h = 16
    view, viewproj = _wire_matrices()
    conn = socket.create_connection(("127.0.0.1", server.listener.getsockname()[1]), timeout=60)
    received = {}

    def client():
        _send(conn, _client_message(w, h, view, viewproj, shs_python=True,
                                    rot_scale_python=False))
        received["image"] = _recv_exact(conn, w * h * 3)
        n = int.from_bytes(_recv_exact(conn, 4), "little")
        received["verify"] = _recv_exact(conn, n)
        conn.close()  # the next poll finds the viewer gone and training goes on

    t = threading.Thread(target=client)
    t.start()
    try:
        opt = OptimizationParams(iterations=4, densify_from_iter=10, position_lr_max_steps=4)
        run_training(scene, opt, PipelineParams(compute_cov3D_python=True),
                     raster_cfg=RasterizeConfig(chunk=32), test_iterations=(),
                     save_iterations=(), gui_server=server)
        t.join(timeout=60)
        assert not t.is_alive()
    finally:
        server.close()
    assert len(received["image"]) == w * h * 3
    assert polled[0] == (False, True)  # seeded from the CLI's pipe
    assert seen == [(True, False)] * 4  # the viewer's toggles, from the first step on
    assert server.conn is None


def test_render_failure_is_not_swallowed(monkeypatch):
    """A failing render propagates out of poll instead of dropping the viewer."""
    def boom(*args, **kwargs):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(GuiServer, "render_bytes", boom)
    w = h = 16
    view, viewproj = _wire_matrices()
    server = GuiServer("127.0.0.1", 0)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        _serve(server, _FakeTrainState(_port_state()), RasterizeConfig(chunk=32),
               _client_message(w, h, view, viewproj), w, h)


def test_malformed_message_drops_the_client():
    """A message without its keys ends the client's session; poll returns."""
    server = GuiServer("127.0.0.1", 0)
    conn = socket.create_connection(("127.0.0.1", server.listener.getsockname()[1]), timeout=60)
    try:
        _send(conn, {"resolution_x": 8, "resolution_y": 8})
        server.poll(_FakeTrainState(_port_state()), RasterizeConfig(chunk=32))
        assert server.conn is None
    finally:
        conn.close()
        server.close()
