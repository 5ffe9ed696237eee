"""Build, load and count the port's hand-written CUDA kernels.

Every kernel lives in its own source, ``gs_tpu_torch/csrc/<name>.cu``, with
a plain C entry point ``gs_<name>`` (device pointers and the stream as
``void*``, sizes as ``int``) that launches on the given stream and returns
``cudaGetLastError()``. ``LIBRARIES`` has one row per kernel: its entry
point's argument types and the extra ``gs_<name>_<symbol>`` functions (no
arguments, returning ``int``) that its wrapper reads, e.g. the compositing
kernels' ``max_pixels``.

Each library is compiled with ``nvcc`` the first time it is needed, from
its source in ``gs_tpu_torch/csrc`` only, into ``build/`` at the
repository root, keyed by a hash of that source, the shared headers
(``csrc/*.cuh``) and the flags. ``build()`` runs one nvcc per source, all
at once. The sources include no PyTorch headers, so a library builds in
seconds.

``LAUNCHES`` counts the launches of each kernel by its wrapper: a wrapper
adds one where it launches its kernel and nowhere else (``chip_smoke.py``
resets and reads them).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

_PTR, _I32 = ctypes.c_void_p, ctypes.c_int


class Library(NamedTuple):
    """One kernel library: its entry point's argtypes and extra int symbols."""

    argtypes: list
    extra: tuple[str, ...] = ()


_FWD_ARGTYPES = [_PTR] * 7 + [_I32] * 5 + [_PTR]  # 7 tensors, m .. chunk, stream
_BWD_ARGTYPES = [_PTR] * 9 + [_I32] * 6 + [_PTR]  # 9 tensors, b, m .. chunk, stream
LIBRARIES = {
    "composite_fwd": Library(_FWD_ARGTYPES, ("max_pixels",)),
    "composite_bwd": Library(_BWD_ARGTYPES, ("max_pixels",)),
    "composite_fwd_tile": Library(_FWD_ARGTYPES, ("max_pixels",)),
    # B2's arguments and the tile order after attr
    "composite_bwd_tile": Library([_PTR] * 10 + [_I32] * 6 + [_PTR], ("max_pixels",)),
    # rows, seg_cum, out; num_rows, n, k; stream
    "segment_reduce": Library([_PTR] * 3 + [_I32] * 3 + [_PTR]),
    # offsets, ends, cols, out; n, k, total; stream
    "expand_intervals": Library([_PTR] * 4 + [_I32] * 3 + [_PTR]),
}

LAUNCHES = {name: 0 for name in LIBRARIES}

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
SOURCES = {name: _CSRC / f"{name}.cu" for name in LIBRARIES}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
# per kernel: library path, nvcc seconds (when built in this process), ptxas report
BUILD_INFO: dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                       "with the CUDA toolkit")


def _library_path(name: str) -> Path:
    # the source, the headers any source may include, and the flags
    parts = [SOURCES[name].read_bytes(), *(h.read_bytes() for h in sorted(_CSRC.glob("*.cuh"))),
             " ".join(NVCC_FLAGS).encode()]
    digest = hashlib.sha256(b"".join(parts)).hexdigest()[:16]
    return BUILD_DIR / f"{name}_{digest}.so"


def build(names=tuple(SOURCES)) -> dict[str, Path]:
    """Compile each named kernel library whose source has not been built,
    one nvcc process per source, all started together; returns the paths.
    ``BUILD_INFO[name]`` gets the build time and nvcc's ptxas report."""
    procs = {}
    for name in names:
        so = _library_path(name)
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, so, time.perf_counter())
    failed = []
    for name, (proc, tmp, so, t0) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {SOURCES[name]}:\n{out}")
            continue
        so.with_suffix(".log").write_text(out)
        os.replace(tmp, so)  # atomic: a concurrent build never sees half a file
        BUILD_INFO.setdefault(name, {})["seconds"] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("\n".join(failed))
    paths = {}
    for name in names:
        so = _library_path(name)
        log = so.with_suffix(".log")
        info = BUILD_INFO.setdefault(name, {})
        info["path"] = str(so)
        info["ptxas"] = log.read_text() if log.exists() else ""
        paths[name] = so
    return paths


def load(name: str) -> ctypes.CDLL:
    """The built library of kernel ``name``, its entry point ``gs_<name>``
    and extra symbols typed from its ``LIBRARIES`` row."""
    if name not in _libs:
        row = LIBRARIES[name]
        lib = ctypes.CDLL(str(build((name,))[name]))
        entry = getattr(lib, f"gs_{name}")
        entry.argtypes = row.argtypes
        entry.restype = _I32
        for symbol in row.extra:
            fn = getattr(lib, f"gs_{name}_{symbol}")
            fn.argtypes = []
            fn.restype = _I32
        _libs[name] = lib
    return _libs[name]


def launch(name: str, *args) -> None:
    """Call kernel ``name``'s entry point with ``args`` (pointers and sizes,
    the stream last), raise if it reports a CUDA error, count the launch."""
    err = getattr(load(name), f"gs_{name}")(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
