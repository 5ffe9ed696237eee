"""Full-training-state checkpoints (port of ``gs_tpu/utils/ckpt.py``).

The reference saves ``(gaussians.capture(), iteration)`` with
``torch.save`` (``train.py:144-146``). gs_tpu, and the port with it, keep
one ``.npz`` file of flat {key: array} entries: the Gaussian parameters,
Adam's moments and steps, the densification accumulators, the iteration,
the spatial lr scale and the SH degree, under gs_tpu's key names
(``state.xyz``, ``adam.mu['xyz']``, ``adam.step['xyz']``,
``stats.denom``, ``meta/iteration``, ...). A checkpoint written by either
package loads in the other.

A path that does not end in ``.npz`` is a checkpoint directory, as in
gs_tpu, holding the same flat keys. gs_tpu writes it with orbax, which the
port cannot read without orbax; the port writes and reads it through
``torch.distributed.checkpoint`` (one process writes: in a mesh run rank
0 writes the whole, gathered state), and a load gives the whole
TrainState in any world, which a sharded trainer then cuts into shards.
"""

from __future__ import annotations

import dataclasses
import os
import warnings

import numpy as np
import torch

from gs_tpu_torch.models import densify, gaussians, optim


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
    """``ts`` to ``path``: an ``.npz`` file, or else a checkpoint directory."""
    if not path.endswith(".npz"):
        return _save_directory(path, ts)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **to_flat_dict(ts))


def load_train_state(path: str, *, device: str | torch.device = "cuda"):
    """The whole TrainState of an ``.npz`` file or a checkpoint directory."""
    if not path.endswith(".npz"):
        return _load_directory(path, device)
    with np.load(path, allow_pickle=False) as z:
        return from_flat_dict(z, device)


# this process alone reads or writes (``no_dist``): no process group is needed
_NO_GROUP_WARNING = ".*torch.distributed is disabled.*"


def _save_directory(path: str, ts) -> None:
    import torch.distributed.checkpoint as dcp

    flat = {k: torch.from_numpy(np.asarray(v)) for k, v in to_flat_dict(ts).items()}
    os.makedirs(path, exist_ok=True)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=_NO_GROUP_WARNING)
        dcp.save(flat, checkpoint_id=path, no_dist=True)


def _load_directory(path: str, device):
    import torch.distributed.checkpoint as dcp

    meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    flat = {k: torch.empty(m.size, dtype=m.properties.dtype) for k, m in meta.items()}
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=_NO_GROUP_WARNING)
        dcp.load(flat, checkpoint_id=path, no_dist=True)
    return from_flat_dict({k: v.numpy() for k, v in flat.items()}, device)
