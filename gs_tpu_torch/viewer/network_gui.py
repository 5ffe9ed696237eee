"""SIBR remote-viewer protocol server (port of ``gs_tpu/viewer/network_gui.py``,
reference ``network_gui.py:24-90``).

Speaks the wire protocol of ``SIBR_remoteGaussian_app`` so existing viewers
can watch a training run on the card:

  client -> server: 4-byte little-endian length + JSON with keys
    resolution_x/y, train, fov_y, fov_x, z_near, z_far, shs_python,
    rot_scale_python, keep_alive, scaling_modifier, view_matrix,
    view_projection_matrix                        (network_gui.py:61-83)
  server -> client: raw H*W*3 uint8 RGB bytes, then 4-byte length +
    ascii source-path verification string          (network_gui.py:53-59)

Matrix convention: the viewer sends flattened row-major matrices in the
reference's transposed (row-vector) storage with Y/Z sign flips applied on
receipt (network_gui.py:79-82); the same flips and transpose give the
port's column-vector matrices (see ``gs_tpu_torch.cameras``).

Frames render through ``renderer.render`` on the training state's device.
One difference from gs_tpu: a failing client (a socket error, a malformed
message) ends its session as in gs_tpu, but a failure of the render itself
propagates instead of being swallowed with the connection.
"""

from __future__ import annotations

import json
import socket
import traceback

import numpy as np
import torch

from gs_tpu_torch import cameras
from gs_tpu_torch.utils import profiling

# what a client's message can raise, which ends its session and not
# training: the socket failing or the peer closing it (ConnectionError is an
# OSError), a message that is not JSON or has the wrong shape (ValueError),
# or one that lacks a key
CONNECTION_ERRORS = (OSError, ValueError, KeyError)


class GuiServer:
    """Non-blocking listener polled once per training iteration."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6009,
                 source_path: str = ""):
        self.host, self.port = host, port
        self.source_path = source_path
        self.conn = None
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self.listener.bind((host, port))
            self.listener.listen()
        except OSError:
            self.listener.close()
            raise
        self.listener.settimeout(0)  # non-blocking accept (network_gui.py:33)
        # live-toggleable pipeline flags (train.py:66)
        self.convert_SHs_python = False
        self.compute_cov3D_python = False

    def try_connect(self):
        try:
            self.conn, addr = self.listener.accept()
            print(f"\nConnected by {addr}")
            self.conn.settimeout(None)
        except OSError:
            pass

    def _read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            part = self.conn.recv(n - len(buf))
            if not part:
                raise ConnectionError("viewer closed")
            buf += part
        return buf

    def read(self) -> dict:
        n = int.from_bytes(self._read_exact(4), "little")
        return json.loads(self._read_exact(n).decode("utf-8"))

    def send(self, image_bytes: bytes | None, verify: str):
        if image_bytes is not None:
            self.conn.sendall(image_bytes)
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(bytes(verify, "ascii"))

    def receive(self, device: str | torch.device = "cuda"):
        """-> (camera|None, do_training, keep_alive, scaling_modifier).

        The camera's tensors are on ``device``. Also updates the live
        shs/cov python-path toggles, mirroring how the reference patches
        ``pipe`` in the training loop (train.py:66).
        """
        msg = self.read()
        width, height = msg["resolution_x"], msg["resolution_y"]
        if width == 0 or height == 0:
            return None, None, None, None
        try:
            do_training = bool(msg["train"])
            fovy, fovx = msg["fov_y"], msg["fov_x"]
            znear, zfar = msg["z_near"], msg["z_far"]
            self.convert_SHs_python = bool(msg["shs_python"])
            self.compute_cov3D_python = bool(msg["rot_scale_python"])
            keep_alive = bool(msg["keep_alive"])
            scaling_modifier = msg["scaling_modifier"]
            # transposed storage + Y/Z flips (network_gui.py:79-82), then
            # transpose into the column-vector convention
            wvt = np.array(msg["view_matrix"], np.float32).reshape(4, 4)
            wvt[:, 1] = -wvt[:, 1]
            wvt[:, 2] = -wvt[:, 2]
            vpt = np.array(msg["view_projection_matrix"], np.float32).reshape(4, 4)
            vpt[:, 1] = -vpt[:, 1]
            cam = cameras.camera_from_matrices(
                wvt.T, vpt.T, fovx, fovy, width, height, znear, zfar, device=device
            )
        except Exception:
            traceback.print_exc()
            raise
        return cam, do_training, keep_alive, scaling_modifier

    def render_bytes(self, ts, cam, raster_cfg, scaling_modifier) -> memoryview:
        """The frame of ``ts.state`` seen from ``cam`` as the wire's H*W*3
        uint8 bytes: ``clip(image, 0, 1) * 255`` truncated, as gs_tpu sends it.
        Each call is a ``frame`` unit of the recorder; spans: ``gs.frame``
        around it, ``gs.frame.to_host`` (the clamp, the scale and the copy to
        the host) and ``gs.frame.pack`` (the uint8 cast and the transpose)."""
        from gs_tpu_torch.renderer import render

        profiling.begin_unit("frame")
        with profiling.annotate("gs.frame"):
            with torch.no_grad():
                out = render(
                    cam, ts.state, active_sh_degree=ts.active_sh_degree,
                    bg_color=torch.zeros(3, device=ts.state.device),
                    scaling_modifier=scaling_modifier,
                    convert_shs_python=self.convert_SHs_python,
                    compute_cov3d_python=self.compute_cov3D_python,
                    cfg=raster_cfg,
                )
                with profiling.annotate("gs.frame.to_host"):
                    img = (torch.clamp(out.image, 0.0, 1.0) * 255.0).cpu().numpy()
            with profiling.annotate("gs.frame.pack"):
                return memoryview(img.astype(np.uint8).transpose(1, 2, 0).copy())

    def poll(self, ts, raster_cfg, iterations: int | None = None):
        """Per-iteration service loop (train.py:60-74).

        ``ts`` is the TrainState; frames render its current Gaussian state
        on its device. Returns once the viewer releases training (or no
        client is connected).
        """
        if self.conn is None:
            self.try_connect()
        while self.conn is not None:
            try:
                cam, do_training, keep_alive, scaling_mod = self.receive(ts.state.device)
            except CONNECTION_ERRORS:
                self._drop()
                break
            frame = None if cam is None else self.render_bytes(ts, cam, raster_cfg, scaling_mod)
            try:
                self.send(frame, self.source_path)
            except OSError:
                self._drop()
                break
            done = iterations is not None and ts.iteration >= iterations
            if do_training and (not done or not keep_alive):
                break

    def _drop(self):
        self.conn.close()
        self.conn = None

    def close(self):
        if self.conn is not None:
            self.conn.close()
            self.conn = None
        self.listener.close()
