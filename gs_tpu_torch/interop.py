"""Weights and training state carried across from gs_tpu, as numpy arrays only.

gs_tpu keeps its state, optimizer and cameras as pytrees of jax arrays;
their leaves converted with ``np.asarray`` are what these functions take.
No jax or gs_tpu import is needed, so the same inputs feed both packages.
A gs_tpu state of the "gauss" layout is carried across from its global
arrays (``np.asarray`` of a sharded array is the whole, in shard order):
``sharded_from_numpy`` cuts the port's copy into the same shards.
"""

from __future__ import annotations

import numpy as np
import torch

from gs_tpu_torch.cameras import DEFAULT_ZFAR, DEFAULT_ZNEAR, Camera, camera_from_arrays
from gs_tpu_torch.device import resolve_device
from gs_tpu_torch.models.densify import DensifyStats
from gs_tpu_torch.models.gaussians import GaussianState, state_from_arrays
from gs_tpu_torch.models.optim import AdamState


def state_from_numpy(d: dict[str, np.ndarray], device: str | torch.device) -> GaussianState:
    """The port's state from the leaves of a gs_tpu ``GaussianState``
    (``xyz``, ``features_dc``, ``features_rest``, ``log_scale``, ``quat``,
    ``logit_opacity``, ``alive``), keeping its capacity."""
    return state_from_arrays(d, capacity=d["xyz"].shape[0], device=device)


def sharded_from_numpy(state: dict, adam: tuple, stats: tuple, n_shard: int,
                       device: str | torch.device) -> dict:
    """``{shard index: (state, adam, stats)}`` of the port from a gs_tpu
    gauss-layout state's global leaves: ``state`` as ``state_from_numpy``
    takes it, ``adam`` as ``adam_from_numpy``'s (mu, nu, step), ``stats`` as
    ``stats_from_numpy``'s three arrays; shard ``s`` holds rows ``[s * L, (s
    + 1) * L)``, as gs_tpu's ``shard_specs`` lays them out."""
    from gs_tpu_torch.parallel.gauss_sharded import shard_rows

    whole = (state_from_numpy(state, device), adam_from_numpy(*adam, device),
             stats_from_numpy(*stats, device))
    return {s: shard_rows(whole, n_shard, s) for s in range(n_shard)}


def camera_from_numpy(d: dict, device: str | torch.device) -> Camera:
    """The port's camera from the fields of a gs_tpu ``Camera`` (``view``,
    ``full_proj``, ``cam_pos``, ``tan_fovx``, ``tan_fovy``, ``width``,
    ``height``; optional ``znear``, ``zfar``, ``image``)."""
    return camera_from_arrays(
        d["view"], d["full_proj"], d["cam_pos"], d["tan_fovx"], d["tan_fovy"],
        d["width"], d["height"], znear=d.get("znear", DEFAULT_ZNEAR),
        zfar=d.get("zfar", DEFAULT_ZFAR), image=d.get("image"), device=device)


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(device)


def adam_from_numpy(mu: dict, nu: dict, step: dict, device: str | torch.device) -> AdamState:
    """The port's Adam state from a gs_tpu ``AdamState``'s leaves: ``mu``
    and ``nu`` keyed by group, ``step`` per group (0-d integers)."""
    dev = resolve_device(device)
    return AdamState(mu={k: _tensor(v, dev) for k, v in mu.items()},
                     nu={k: _tensor(v, dev) for k, v in nu.items()},
                     step={k: int(v) for k, v in step.items()})


def stats_from_numpy(xyz_grad_accum, denom, max_radii2d,
                     device: str | torch.device) -> DensifyStats:
    """The port's densify statistics from a gs_tpu ``DensifyStats``'s leaves."""
    dev = resolve_device(device)
    return DensifyStats(*(_tensor(a, dev) for a in (xyz_grad_accum, denom, max_radii2d)))
