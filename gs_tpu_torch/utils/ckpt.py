"""Full-training-state checkpoints (port of ``gs_tpu/utils/ckpt.py``).

The reference saves ``(gaussians.capture(), iteration)`` with
``torch.save`` (``train.py:144-146``). gs_tpu, and the port with it, keep
one ``.npz`` file of flat {key: array} entries: the Gaussian parameters,
Adam's moments and steps, the densification accumulators, the iteration,
the spatial lr scale and the SH degree, under gs_tpu's key names
(``state.xyz``, ``adam.mu['xyz']``, ``adam.step['xyz']``,
``stats.denom``, ``meta/iteration``, ...). A checkpoint written by either
package loads in the other.

gs_tpu's second backend, an orbax checkpoint directory for sharded
multi-host state, belongs to the multi-device slice (ROADMAP A14): a path
that does not end in ``.npz`` raises.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from gs_tpu_torch.models import densify, gaussians, optim


def _check_npz(path: str) -> None:
    if not path.endswith(".npz"):
        raise NotImplementedError(
            f"{path}: only .npz checkpoints are ported; gs_tpu's orbax checkpoint "
            "directories wait for the multi-device slice (ROADMAP A14)")


def to_flat_dict(ts) -> dict[str, np.ndarray]:
    """gs_tpu's flat layout of a TrainState (its ``_to_flat_dict``)."""
    def host(t):
        return t.detach().cpu().numpy()

    data = {f"state.{f.name}": host(getattr(ts.state, f.name))
            for f in dataclasses.fields(gaussians.GaussianState)}
    for name in ("mu", "nu"):
        for k, v in sorted(getattr(ts.adam, name).items()):
            data[f"adam.{name}['{k}']"] = host(v)
    for k, v in sorted(ts.adam.step.items()):
        data[f"adam.step['{k}']"] = np.int32(v)
    for name in densify.DensifyStats._fields:
        data[f"stats.{name}"] = host(getattr(ts.stats, name))
    data["meta/iteration"] = np.int64(ts.iteration)
    data["meta/spatial_lr_scale"] = np.float64(ts.spatial_lr_scale)
    data["meta/max_sh_degree"] = np.int64(ts.max_sh_degree)
    return data


def from_flat_dict(z, device: str | torch.device):
    """A TrainState on ``device`` from gs_tpu's flat layout."""
    from gs_tpu_torch.training import TrainState

    def tensor(key):
        return torch.from_numpy(np.array(z[key])).to(device)

    state = gaussians.GaussianState(**{f.name: tensor(f"state.{f.name}")
                                       for f in dataclasses.fields(gaussians.GaussianState)})
    groups = sorted(state.params())
    adam = optim.AdamState(
        mu={k: tensor(f"adam.mu['{k}']") for k in groups},
        nu={k: tensor(f"adam.nu['{k}']") for k in groups},
        step={k: int(z[f"adam.step['{k}']"]) for k in groups},
    )
    stats = densify.DensifyStats(*(tensor(f"stats.{name}")
                                   for name in densify.DensifyStats._fields))
    return TrainState(state=state, adam=adam, stats=stats,
                      iteration=int(z["meta/iteration"]),
                      spatial_lr_scale=float(z["meta/spatial_lr_scale"]),
                      max_sh_degree=int(z["meta/max_sh_degree"]))


def save_train_state(path: str, ts) -> None:
    _check_npz(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **to_flat_dict(ts))


def load_train_state(path: str, *, device: str | torch.device = "cuda"):
    _check_npz(path)
    with np.load(path, allow_pickle=False) as z:
        return from_flat_dict(z, device)
