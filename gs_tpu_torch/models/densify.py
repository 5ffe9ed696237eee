"""Adaptive density control: clone / split / prune / opacity reset.

Port of ``gs_tpu/models/densify.py``, the reference's density control
(``scene/gaussian_model.py:411-581``) with its semantics kept exactly:

- stats: per-Gaussian accumulated screen-space positional gradient norm
  (NDC-scaled: pixel gradients x 0.5 * extent, the units the reference's
  CUDA backward writes into means2D.grad) and update counts; max 2D radius
  (``add_densification_stats``, ``train.py:127-128``).
- clone: grad >= threshold and max scale <= percent_dense * extent; exact
  copies.
- split: grad >= threshold and max scale > percent_dense * extent; two
  children drawn from N(mean, Sigma), scale shrunk by 1 / (0.8 * 2), the
  original removed.
- prune: opacity < min_opacity, plus the world-size condition when size
  pruning is on. The reference's quirk is kept: ``densification_postfix``
  zeroes ``max_radii2D`` before the prune mask is built, so its screen-size
  condition never fires inside densify_and_prune.
- Adam surgery: new slots get zero moments, freed slots are cleared, the
  opacity reset zeroes that group's moments.

The state keeps a fixed capacity with an ``alive`` mask: children go to
free slots ranked by a stable argsort (dead slots first), in gs_tpu's
order, so both packages place every child in the same slot. Children beyond
the free slots are dropped and reported; the trainer grows capacity before
the next round. The split noise is an explicit [2, C, 3] input, drawn by
:func:`split_noise` from a ``torch.Generator``; a test feeds gs_tpu's draw
in instead.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gs_tpu_torch.models import optim
from gs_tpu_torch.models.gaussians import GaussianState
from gs_tpu_torch.models.optim import AdamState
from gs_tpu_torch.ops import transforms

SPLIT_N = 2  # children per split (gaussian_model.py:446)
SPLIT_SHRINK = 0.8 * SPLIT_N  # scale divisor (gaussian_model.py:490)
WORLD_SIZE_PRUNE = 0.1  # of scene extent (gaussian_model.py:558)
OPACITY_RESET_FLOOR = 0.01  # gaussian_model.py:262
_F32 = torch.float32


class DensifyStats(NamedTuple):
    xyz_grad_accum: torch.Tensor  # [C]
    denom: torch.Tensor  # [C]
    max_radii2d: torch.Tensor  # [C]

    @staticmethod
    def zeros(capacity: int, device) -> "DensifyStats":
        return DensifyStats(*(torch.zeros(capacity, dtype=_F32, device=device) for _ in range(3)))


def add_stats(
    stats: DensifyStats,
    means2d_pixel_grad: torch.Tensor,  # [C, 2] dL/d(pixel-space mean)
    radii: torch.Tensor,  # [C]
    visibility: torch.Tensor,  # [C] bool
    width: int,
    height: int,
) -> DensifyStats:
    """Accumulate the densification signal (``gaussian_model.py:565-581``),
    NDC-scaled so that densify_grad_threshold = 2e-4 carries over."""
    scale = torch.tensor([0.5 * width, 0.5 * height], dtype=_F32, device=radii.device)
    norm = torch.linalg.norm(means2d_pixel_grad * scale, dim=-1)
    return DensifyStats(
        xyz_grad_accum=stats.xyz_grad_accum + torch.where(visibility, norm, 0.0),
        denom=stats.denom + visibility.to(_F32),
        max_radii2d=torch.maximum(stats.max_radii2d,
                                  torch.where(visibility, radii.to(_F32), 0.0)),
    )


class DensifyReport(NamedTuple):
    n_cloned: torch.Tensor
    n_split: torch.Tensor
    n_pruned: torch.Tensor
    n_dropped: torch.Tensor  # children lost to capacity overflow (grow & move on)


def split_noise(generator: torch.Generator, capacity: int, device) -> torch.Tensor:
    """Standard-normal offsets [SPLIT_N, capacity, 3] for split children,
    drawn from ``generator`` (on the generator's device), moved to ``device``."""
    return torch.randn((SPLIT_N, capacity, 3), generator=generator, dtype=_F32,
                       device=generator.device).to(device)


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=_F32)


def _stable_argsort(x: torch.Tensor) -> torch.Tensor:
    return torch.sort(x.to(torch.int8), stable=True).indices


def densify_and_prune(
    state: GaussianState,
    adam: AdamState,
    stats: DensifyStats,
    noise: torch.Tensor,
    *,
    max_grad: float,
    min_opacity: float,
    extent: float,
    percent_dense: float,
    use_size_prune: bool,
) -> tuple[GaussianState, AdamState, DensifyStats, DensifyReport]:
    """One densification round (``densify_and_prune``, gaussian_model.py:536-562).

    ``noise`` [SPLIT_N, C, 3]: the standard-normal draw of each slot's split
    children (:func:`split_noise`). Thresholds are formed in float32 as
    gs_tpu forms them.
    """
    cap = state.capacity
    dev = state.device
    alive = state.alive

    grads = stats.xyz_grad_accum / torch.where(stats.denom > 0, stats.denom, 1.0)
    grads = torch.where(torch.isnan(grads) | (stats.denom == 0), 0.0, grads)

    scaling = state.scaling
    max_scale = scaling.amax(dim=-1)
    opacity = state.opacity[:, 0]
    dense_limit = _f32(percent_dense) * _f32(extent)
    world_limit = WORLD_SIZE_PRUNE * _f32(extent)

    hot = alive & (grads >= max_grad)
    clone_mask = hot & (max_scale <= dense_limit)
    split_mask = hot & (max_scale > dense_limit)

    # prune conditions on original points (the reference quirk: max_radii2D
    # was zeroed before this check, so only opacity + world size fire)
    prune_orig = alive & (opacity < min_opacity)
    if use_size_prune:
        prune_orig = prune_orig | (alive & (max_scale > world_limit))
    keep = alive & ~split_mask & ~prune_orig

    # children actually born (immediately re-pruned ones are not, as in the
    # reference's prune over the concatenated array)
    clone_child_ok = clone_mask & ~prune_orig
    child_scale = scaling / SPLIT_SHRINK
    split_child_prune = opacity < min_opacity
    if use_size_prune:
        split_child_prune = split_child_prune | (child_scale.amax(dim=-1) > world_limit)
    split_child_ok = split_mask & ~split_child_prune

    # ---- slot allocation: dead slots first, children in rank order --------
    n_free = cap - keep.sum()
    free_order = _stable_argsort(keep)
    rank = torch.arange(cap, device=dev)

    def targets_for(mask, rank_offset, dup):
        """Selected slots compacted (src[C]) and their targets (C = dropped)."""
        src = _stable_argsort(~mask)
        n_sel = mask.sum()
        tgts = []
        for d in range(dup):
            r = rank_offset + rank * dup + d
            ok = (rank < n_sel) & (r < n_free)
            tgts.append(torch.where(ok, free_order[torch.clamp(r, max=cap - 1)], cap))
        return src, tgts, n_sel

    clone_src, clone_tgts, n_clone_ok = targets_for(clone_child_ok, 0, 1)
    split_src, split_tgts, n_split_ok = targets_for(split_child_ok, n_clone_ok, SPLIT_N)

    # ---- child parameters -------------------------------------------------
    rot = transforms.quat_to_rotmat(state.quat)  # [C, 3, 3]
    offsets = torch.einsum("nij,knj->kni", rot, noise * scaling[None])
    split_xyz = state.xyz[None] + offsets  # [SPLIT_N, C, 3]
    split_log_scale = torch.log(child_scale)

    def scatter(dst, src_idx, tgt_idx, values):
        ok = tgt_idx < cap
        dst[tgt_idx[ok]] = values[src_idx[ok]]

    new_params = {}
    for name, p in state.params().items():
        out = p.clone()
        scatter(out, clone_src, clone_tgts[0], p)
        for d in range(SPLIT_N):
            vals = split_xyz[d] if name == "xyz" else split_log_scale if name == "scaling" else p
            scatter(out, split_src, split_tgts[d], vals)
        new_params[name] = out

    # ---- alive mask + Adam surgery -----------------------------------------
    all_targets = torch.cat([clone_tgts[0]] + split_tgts)
    placed = all_targets[all_targets < cap]
    new_alive = keep.clone()
    new_alive[placed] = True
    adam = optim.mask_slots(adam, new_alive)  # clear freed slots
    for tree in (adam.mu, adam.nu):
        for m in tree.values():
            m[placed] = 0.0  # zero the new slots

    new_state = state.with_params(new_params).replace(alive=new_alive)
    # postfix parity: all stats reset to zero (gaussian_model.py:441-444)
    new_stats = DensifyStats.zeros(cap, dev)
    report = DensifyReport(
        n_cloned=n_clone_ok,
        n_split=split_mask.sum(),
        n_pruned=(alive & ~keep).sum(),
        n_dropped=n_clone_ok + SPLIT_N * n_split_ok - placed.numel(),
    )
    return new_state, adam, new_stats, report


def reset_opacity(state: GaussianState, adam: AdamState) -> tuple[GaussianState, AdamState]:
    """Clamp opacity to <= 0.01 and zero that group's Adam moments
    (``reset_opacity`` + ``replace_tensor_to_optimizer``,
    gaussian_model.py:261-264,322-335)."""
    new_op = torch.clamp(state.opacity, max=OPACITY_RESET_FLOOR)
    new_logit = transforms.inverse_sigmoid(torch.clamp(new_op, 1e-7, 1.0 - 1e-7))
    return state.replace(logit_opacity=new_logit), optim.reset_group(adam, "opacity")
