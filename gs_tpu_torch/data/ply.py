"""Self-contained PLY I/O: a small codec, SfM point clouds and the 3DGS Gaussian snapshot schema.

The port's own numpy copy of ``gs_tpu/data/ply.py`` (the port imports
nothing from gs_tpu). The Gaussian snapshot stays byte-compatible with the
reference and the wider 3DGS ecosystem (``scene/gaussian_model.py:218-258``):
binary little-endian, one ``vertex`` element of float32 properties

  x y z nx ny nz f_dc_0..2 f_rest_0..(3K-4) opacity scale_0..2 rot_0..3

all raw (pre-activation) values; f_rest stored channel-major (all K-1
coefficients of R, then G, then B). Loading restores the [N, K-1, 3] layout.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from gs_tpu_torch.models.gaussians import GaussianState, state_from_arrays

_PLY_DTYPES = {
    "char": "i1", "uchar": "u1", "short": "i2", "ushort": "u2",
    "int": "i4", "uint": "u4", "int8": "i1", "uint8": "u1",
    "int16": "i2", "uint16": "u2", "int32": "i4", "uint32": "u4",
    "float": "f4", "double": "f8", "float32": "f4", "float64": "f8",
}
_INV_DTYPES = {"f4": "float", "f8": "double", "u1": "uchar", "i4": "int",
               "i1": "char", "u4": "uint", "i2": "short", "u2": "ushort"}


def read_ply(path: str) -> np.ndarray:
    """Read a single-element PLY into a numpy structured array."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        count = 0
        props: list[tuple[str, str]] = []
        element_seen = False
        while True:
            line = f.readline().strip().decode("ascii")
            if line.startswith("comment"):
                continue
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                if element_seen:
                    raise ValueError("multi-element PLY not supported")
                element_seen = True
                count = int(line.split()[2])
            elif line.startswith("property"):
                parts = line.split()
                if parts[1] == "list":
                    raise ValueError("list properties not supported")
                props.append((parts[2], _PLY_DTYPES[parts[1]]))
            elif line == "end_header":
                break
        if fmt == "binary_little_endian":
            dtype = np.dtype([(n, "<" + t) for n, t in props])
            return np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype, count=count)
        if fmt == "binary_big_endian":
            dtype = np.dtype([(n, ">" + t) for n, t in props])
            return np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype, count=count)
        if fmt == "ascii":
            dtype = np.dtype([(n, t) for n, t in props])
            rows = [tuple(f.readline().split()) for _ in range(count)]
            return np.array(rows, dtype=dtype)
        raise ValueError(f"unsupported PLY format {fmt}")


def write_ply(path: str, data: np.ndarray, element: str = "vertex") -> None:
    """Write a numpy structured array as binary little-endian PLY."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    header = ["ply", "format binary_little_endian 1.0", f"element {element} {len(data)}"]
    le = data.astype(np.dtype([(n, "<" + data.dtype[n].str[1:]) for n in data.dtype.names]))
    for name in data.dtype.names:
        header.append(f"property {_INV_DTYPES[data.dtype[name].str[1:]]} {name}")
    header.append("end_header\n")
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        f.write(le.tobytes())


def read_pointcloud_ply(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """An SfM point cloud (``dataset_readers.py:156-182``): (points [N,3] f32,
    colors [N,3] f32 in [0,1], normals [N,3] f32; 0.5 grey and zero normals
    where the file has none)."""
    v = read_ply(path)
    pts = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
    if "red" in v.dtype.names:
        cols = np.stack([v["red"], v["green"], v["blue"]], 1).astype(np.float32) / 255.0
    else:
        cols = np.full_like(pts, 0.5)
    if "nx" in v.dtype.names:
        normals = np.stack([v["nx"], v["ny"], v["nz"]], 1).astype(np.float32)
    else:
        normals = np.zeros_like(pts)
    return pts, cols, normals


def write_pointcloud_ply(path: str, points: np.ndarray, colors_u8: np.ndarray) -> None:
    """The reference's ``storePly`` schema: x y z and nx ny nz (zero) as
    float32, red green blue as uint8."""
    dtype = [(n, "f4") for n in ("x", "y", "z", "nx", "ny", "nz")] + [
        (n, "u1") for n in ("red", "green", "blue")]
    arr = np.zeros(points.shape[0], dtype=dtype)
    for i, n in enumerate(("x", "y", "z")):
        arr[n] = points[:, i].astype(np.float32)
    for i, n in enumerate(("red", "green", "blue")):
        arr[n] = colors_u8[:, i].astype(np.uint8)
    write_ply(path, arr)


def gaussian_ply_property_names(max_sh_degree: int) -> list[str]:
    k = (max_sh_degree + 1) ** 2
    names = ["x", "y", "z", "nx", "ny", "nz"]
    names += [f"f_dc_{i}" for i in range(3)]
    names += [f"f_rest_{i}" for i in range(3 * (k - 1))]
    names += ["opacity"]
    names += [f"scale_{i}" for i in range(3)]
    names += [f"rot_{i}" for i in range(4)]
    return names


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_gaussian_ply(
    path: str,
    xyz,  # [N,3]
    features_dc,  # [N,1,3]
    features_rest,  # [N,K-1,3]
    logit_opacity,  # [N,1]
    log_scale,  # [N,3]
    quat,  # [N,4]
) -> None:
    """Write raw Gaussian parameters (numpy arrays or tensors) as a 3DGS PLY."""
    xyz, features_dc, features_rest, logit_opacity, log_scale, quat = map(
        _host, (xyz, features_dc, features_rest, logit_opacity, log_scale, quat))
    n = xyz.shape[0]
    k1 = features_rest.shape[1]
    names = gaussian_ply_property_names(int(round((k1 + 1) ** 0.5)) - 1)
    # channel-major flatten: [N,K,3] -> [N,3,K] -> [N,3K]
    f_dc = np.transpose(features_dc, (0, 2, 1)).reshape(n, -1)
    f_rest = np.transpose(features_rest, (0, 2, 1)).reshape(n, -1)
    cols = np.concatenate(
        [xyz, np.zeros_like(xyz), f_dc, f_rest, logit_opacity, log_scale, quat], axis=1
    ).astype(np.float32)
    arr = np.empty(n, dtype=[(nm, "f4") for nm in names])
    for i, nm in enumerate(names):
        arr[nm] = cols[:, i]
    write_ply(path, arr)


def save_state_ply(path: str, state: GaussianState) -> None:
    """PLY snapshot of the alive Gaussians of ``state``."""
    alive = state.alive
    save_gaussian_ply(path, state.xyz[alive], state.features_dc[alive],
                      state.features_rest[alive], state.logit_opacity[alive],
                      state.log_scale[alive], state.quat[alive])


def read_gaussian_arrays(path: str) -> dict[str, np.ndarray]:
    """Raw parameter arrays of a Gaussian PLY (gs_tpu's ``load_gaussian_ply``).

    f_rest_* are sorted by numeric suffix and reshaped channel-major back to
    [N, K-1, 3] (reference ``gaussian_model.py:267-318``).
    """
    v = read_ply(path)
    names = set(v.dtype.names)
    n = len(v)

    def numbered(prefix):
        return sorted((nm for nm in names if nm.startswith(prefix)),
                      key=lambda s: int(s.split("_")[-1]))

    xyz = np.stack([v["x"], v["y"], v["z"]], 1).astype(np.float32)
    opacity = np.asarray(v["opacity"], np.float32)[:, None]
    f_dc = np.stack([v[f"f_dc_{i}"] for i in range(3)], 1).astype(np.float32)
    rest_names = numbered("f_rest_")
    k1 = len(rest_names) // 3
    if rest_names:  # sh_degree 0 writes no f_rest_* columns
        f_rest = np.stack([v[nm] for nm in rest_names], 1).astype(np.float32)
        f_rest = f_rest.reshape(n, 3, k1).transpose(0, 2, 1)
    else:
        f_rest = np.zeros((n, 0, 3), np.float32)
    log_scale = np.stack([v[nm] for nm in numbered("scale_")], 1).astype(np.float32)
    quat = np.stack([v[nm] for nm in numbered("rot_")], 1).astype(np.float32)
    return {
        "xyz": xyz,
        "features_dc": f_dc[:, None, :],
        "features_rest": f_rest,
        "logit_opacity": opacity,
        "log_scale": log_scale,
        "quat": quat,
    }


def load_gaussian_ply(path: str, *, capacity: int | None = None,
                      device: str | torch.device = "cuda") -> GaussianState:
    """Load a trained Gaussian PLY into a :class:`GaussianState` (how a trained
    model reaches the renderer; gs_tpu does this in ``scene.py:160-178``)."""
    return state_from_arrays(read_gaussian_arrays(path), capacity=capacity, device=device)
