"""ctypes bindings for the native data-plane library (port of
``gs_tpu/data/native.py``; source ``native/gs_native.cpp``).

A host library for the hot file formats (COLMAP binaries, gaussian PLY
snapshots), not a kernel: the port loads the tracked
``native/libgs_native.so`` (or ``$GS_NATIVE_LIB``) and builds nothing.
Loading is lazy and optional: when the library is absent or does not load,
:func:`available` is False and :mod:`gs_tpu_torch.data.colmap` uses its
Python parsers, as gs_tpu does.

One kept difference from gs_tpu: a missing file raises
``FileNotFoundError`` here (gs_tpu's reader raises ``OSError`` from the
library's error code), so ``readers.read_colmap_scene`` reaches its text
fallback when ``images.bin`` is absent.
"""

from __future__ import annotations

import ctypes
import errno
import functools
import os

import numpy as np

_C_INT64 = ctypes.c_int64
_LIB_ENV = "GS_NATIVE_LIB"


def _default_lib_paths():
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(os.path.dirname(here))
    return [
        os.environ.get(_LIB_ENV, ""),
        os.path.join(root, "native", "libgs_native.so"),
    ]


@functools.lru_cache(maxsize=1)
def _lib():
    for path in _default_lib_paths():
        if path and os.path.exists(path):
            try:
                lib = ctypes.CDLL(path)
            except OSError:
                continue
            _declare(lib)
            return lib
    return None


def _declare(lib):
    c = ctypes
    lib.gs_colmap_points3d_count.restype = _C_INT64
    lib.gs_colmap_points3d_count.argtypes = [c.c_char_p]
    lib.gs_colmap_read_points3d.restype = c.c_int
    lib.gs_colmap_read_points3d.argtypes = [
        c.c_char_p, _C_INT64, c.c_void_p, c.c_void_p, c.c_void_p]
    lib.gs_colmap_images_count.restype = _C_INT64
    lib.gs_colmap_images_count.argtypes = [c.c_char_p]
    lib.gs_colmap_read_images.restype = c.c_int
    lib.gs_colmap_read_images.argtypes = [
        c.c_char_p, _C_INT64, c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,
        c.c_char_p, _C_INT64]
    lib.gs_colmap_cameras_count.restype = _C_INT64
    lib.gs_colmap_cameras_count.argtypes = [c.c_char_p]
    lib.gs_colmap_read_cameras.restype = c.c_int
    lib.gs_colmap_read_cameras.argtypes = [
        c.c_char_p, _C_INT64, c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,
        c.c_void_p, c.c_void_p]
    lib.gs_ply_header.restype = _C_INT64
    lib.gs_ply_header.argtypes = [
        c.c_char_p, c.c_void_p, c.c_void_p, c.c_char_p, _C_INT64]
    lib.gs_ply_read_f32.restype = c.c_int
    lib.gs_ply_read_f32.argtypes = [
        c.c_char_p, _C_INT64, _C_INT64, _C_INT64, c.c_void_p]
    lib.gs_ply_write_f32.restype = c.c_int
    lib.gs_ply_write_f32.argtypes = [
        c.c_char_p, _C_INT64, _C_INT64, c.c_char_p, c.c_void_p]


def available() -> bool:
    return _lib() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _existing(path: str) -> bytes:
    """``path`` encoded for the library; FileNotFoundError if it is missing."""
    if not os.path.isfile(path):
        raise FileNotFoundError(errno.ENOENT, os.strerror(errno.ENOENT), path)
    return path.encode()


# ----------------------------------------------------------------------------
# COLMAP
# ----------------------------------------------------------------------------


def read_points3d_binary(path: str):
    """Native points3D.bin -> (xyz f64 [N,3], rgb u8 [N,3], err f64 [N])."""
    lib = _lib()
    cpath = _existing(path)
    n = lib.gs_colmap_points3d_count(cpath)
    if n < 0:
        raise IOError(f"gs_native: cannot read {path} ({n})")
    xyz = np.empty((n, 3), np.float64)
    rgb = np.empty((n, 3), np.uint8)
    err = np.empty((n,), np.float64)
    rc = lib.gs_colmap_read_points3d(cpath, n, _ptr(xyz), _ptr(rgb),
                                     _ptr(err))
    if rc != 0:
        raise IOError(f"gs_native: points3d parse failed ({rc})")
    return xyz, rgb, err


def read_images_binary(path: str):
    """Native images.bin -> list of (image_id, qvec, tvec, camera_id, name)."""
    lib = _lib()
    cpath = _existing(path)
    n = lib.gs_colmap_images_count(cpath)
    if n < 0:
        raise IOError(f"gs_native: cannot read {path} ({n})")
    image_ids = np.empty((n,), np.int32)
    qvecs = np.empty((n, 4), np.float64)
    tvecs = np.empty((n, 3), np.float64)
    camera_ids = np.empty((n,), np.int32)
    # rc -6 = name buffer too small (average path length > the sizing guess):
    # grow and retry instead of failing the whole fast path over long names
    name_bytes = 512
    while True:
        name_buf = ctypes.create_string_buffer(max(n, 1) * name_bytes)
        rc = lib.gs_colmap_read_images(cpath, n, _ptr(image_ids),
                                       _ptr(qvecs), _ptr(tvecs),
                                       _ptr(camera_ids), name_buf,
                                       len(name_buf))
        if rc == -6 and name_bytes < 1 << 16:
            name_bytes *= 8
            continue
        break
    if rc != 0:
        raise IOError(f"gs_native: images parse failed ({rc})")
    names = bytes(name_buf.raw).split(b"\x00")[:n]
    return [
        (int(image_ids[i]), qvecs[i], tvecs[i], int(camera_ids[i]),
         names[i].decode("utf-8"))
        for i in range(n)
    ]


def read_cameras_binary(path: str):
    """Native cameras.bin -> list of (camera_id, model_id, w, h, params)."""
    lib = _lib()
    cpath = _existing(path)
    n = lib.gs_colmap_cameras_count(cpath)
    if n < 0:
        raise IOError(f"gs_native: cannot read {path} ({n})")
    camera_ids = np.empty((n,), np.int32)
    model_ids = np.empty((n,), np.int32)
    widths = np.empty((n,), np.int64)
    heights = np.empty((n,), np.int64)
    params = np.zeros((n, 12), np.float64)
    num_params = np.empty((n,), np.int32)
    rc = lib.gs_colmap_read_cameras(cpath, n, _ptr(camera_ids),
                                    _ptr(model_ids), _ptr(widths),
                                    _ptr(heights), _ptr(params),
                                    _ptr(num_params))
    if rc != 0:
        raise IOError(f"gs_native: cameras parse failed ({rc})")
    return [
        (int(camera_ids[i]), int(model_ids[i]), int(widths[i]),
         int(heights[i]), params[i, : num_params[i]].copy())
        for i in range(n)
    ]


# ----------------------------------------------------------------------------
# gaussian PLY
# ----------------------------------------------------------------------------


def read_ply_f32(path: str):
    """Native all-float32 binary PLY -> (prop_names, data [N, n_props] f32).

    Returns None if the file isn't in the fast-path schema (caller falls back
    to the python reader, which handles arbitrary PLYs).
    """
    lib = _lib()
    n_verts = _C_INT64(0)
    n_props = _C_INT64(0)
    prop_buf = ctypes.create_string_buffer(16384)
    hlen = lib.gs_ply_header(path.encode(), ctypes.byref(n_verts),
                             ctypes.byref(n_props), prop_buf, len(prop_buf))
    if hlen < 0:
        return None
    names = bytes(prop_buf.raw).split(b"\x00")[: n_props.value]
    data = np.empty((n_verts.value, n_props.value), np.float32)
    rc = lib.gs_ply_read_f32(path.encode(), hlen, n_verts.value, n_props.value,
                             _ptr(data))
    if rc != 0:
        raise IOError(f"gs_native: ply read failed ({rc})")
    return [nm.decode() for nm in names], data


def write_ply_f32(path: str, prop_names: list[str], data: np.ndarray) -> None:
    lib = _lib()
    data = np.ascontiguousarray(data, np.float32)
    blob = b"\x00".join(nm.encode() for nm in prop_names) + b"\x00"
    rc = lib.gs_ply_write_f32(path.encode(), data.shape[0], data.shape[1],
                              blob, _ptr(data))
    if rc != 0:
        raise IOError(f"gs_native: ply write failed ({rc})")
