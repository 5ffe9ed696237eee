"""Densify on the Gaussian-sharded layout, and shard rebalancing (port of
``gs_tpu/parallel/densify_sharded.py``).

Shards go in and come out as ``{shard index: value}``, as in
``parallel/gauss_sharded.py``.

1. **Sharded densify** (``make_sharded_densify``): each shard runs the
   whole clone / split / prune round (``models.densify.densify_and_prune``)
   on its own rows; decisions are per Gaussian, so they are the one-device
   decisions. gs_tpu draws a split child's noise per *global* slot
   (``fold_in`` of the slot index); here every rank takes the whole
   capacity's ``[2, capacity, 3]`` draw (``densify.split_noise`` from the
   run's generator, or a test's copy of gs_tpu's draw) and uses its own
   rows of it, so the children equal a one-device round fed the same
   noise. Children land in the shard's own free slots; the report is
   summed over ``shard``.
2. **Rebalance** (``make_sharded_rebalance``, ``_rebalance_round``):
   densification fills shards unevenly. One round moves at most
   ``migration_budget`` Gaussians a shard: overfull shards pack their
   topmost alive rows (parameters, both Adam moments and the statistics)
   into a fixed-size buffer, an all-gather over ``shard`` pools them, and
   underfull shards take intervals of the pool into their lowest free
   slots. The intake is allocated across senders first, so no row is ever
   sent that nobody takes.
3. **The loop** (``make_sharded_rebalance_loop``): gs_tpu fuses the rounds
   into one ``lax.while_loop``; here it is a host loop. Its stopping test
   (a round moved rows, fewer than ``max_rounds`` rounds, skew above the
   threshold) reads all-gathered counts (``Mesh.gather_counts``), so every
   rank runs the same rounds and the same collectives.

The round's arithmetic on counts (targets, the prefix allocation, the
pool's index table) runs on the host from those gathered counts; the rows
move on the device. Nothing here reaches a kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from gs_tpu_torch.config import OptimizationParams
from gs_tpu_torch.models import densify, optim
from gs_tpu_torch.parallel.gauss_sharded import shard_owners
from gs_tpu_torch.training import MIN_OPACITY


def make_sharded_densify(mesh, opt_cfg: OptimizationParams, capacity: int,
                         use_size_prune: bool):
    """One densify round over the Gaussian-sharded state (gs_tpu
    ``make_sharded_densify``): ``densify(states, adams, stats, noise,
    extent)`` with ``noise`` the whole capacity's ``[2, capacity, 3]``
    split draw returns the new shards and the report summed over
    ``shard``; ``n_dropped > 0`` means some shard ran out of free slots."""
    n_shard = mesh.shard
    if capacity % n_shard != 0:
        raise ValueError(f"capacity {capacity} % shard={n_shard} != 0")
    local = capacity // n_shard
    owners = shard_owners(mesh)

    def run(states, adams, stats, noise, extent):
        out_states, out_adams, out_stats, reports = {}, {}, {}, {}
        for s, r in owners.items():
            out_states[s], out_adams[s], out_stats[s], rep = densify.densify_and_prune(
                states[s], adams[s], stats[s], noise[:, s * local:(s + 1) * local],
                max_grad=opt_cfg.densify_grad_threshold, min_opacity=MIN_OPACITY,
                extent=extent, percent_dense=opt_cfg.percent_dense,
                use_size_prune=use_size_prune)
            reports[r] = torch.stack([torch.as_tensor(v, dtype=torch.int64) for v in rep])
        total = mesh.sum_shard(reports)[owners[min(owners)]]
        return out_states, out_adams, out_stats, densify.DensifyReport(*total)

    return run


def shard_occupancy(mesh, states) -> list[int]:
    """Alive rows of every shard, in shard order, read on the host alike by
    every rank (a collective over ``shard``)."""
    owners = shard_owners(mesh)
    counts = mesh.gather_counts({r: int(states[s].num_alive) for s, r in owners.items()})
    return counts[owners[min(owners)]]


def _skew(counts) -> np.float32:
    """max / mean of the shard counts in float32, the mean at least 1
    (gs_tpu's ``_skew``)."""
    c = np.asarray(counts, np.float32)
    return np.float32(c.max()) / np.maximum(np.float32(c.sum()) / np.float32(c.size),
                                            np.float32(1.0))


def _bundle(state, adam, stats) -> torch.Tensor:
    """The record that moves with a row: parameters, both Adam moments and
    the statistics, as one [L, W] float32 matrix."""
    cols = [*state.params().values(), *adam.mu.values(), *adam.nu.values(), *stats]
    return torch.cat([c.reshape(c.shape[0], -1) for c in cols], dim=1)


def _unbundle(state, adam, stats, rows: torch.Tensor, recv: torch.Tensor):
    """``state`` / ``adam`` / ``stats`` with ``rows`` [L, W] written wherever
    ``recv`` [L] is set (gs_tpu ``_apply_bundle``)."""
    i = 0

    def take(like):
        nonlocal i
        w = like[0].numel()
        out = like.clone()
        out[recv] = rows[recv, i:i + w].reshape((-1,) + like.shape[1:])
        i += w
        return out

    params = {k: take(v) for k, v in state.params().items()}
    mu = {k: take(v) for k, v in adam.mu.items()}
    nu = {k: take(v) for k, v in adam.nu.items()}
    new_stats = densify.DensifyStats(*(take(v) for v in stats))
    return (state.with_params(params), optim.AdamState(mu=mu, nu=nu, step=dict(adam.step)),
            new_stats)


def _rebalance_round(mesh, states, adams, stats, k: int):
    """One bounded-migration round (gs_tpu ``_rebalance_round``). Returns
    the new shards and the rows moved (every row sent is taken)."""
    n_shard = mesh.shard
    owners = shard_owners(mesh)
    counts = np.asarray(shard_occupancy(mesh, states), np.int64)
    total = int(counts.sum())
    target = -(-total // n_shard)
    excess = np.maximum(counts - target, 0)
    deficit = np.maximum(target - counts, 0)
    # prefix-allocate the receivers' whole intake over the senders in shard
    # order, each capped at its share: a sender never drops a row that no
    # receiver takes
    avail = np.minimum(excess, k)
    want = np.minimum(deficit, k)
    cum_avail = np.cumsum(avail) - avail
    sent = np.clip(int(want.sum()) - cum_avail, 0, avail)
    pool_size = int(sent.sum())
    if pool_size == 0:  # every rank reads the same counts: none gathers
        return states, adams, stats, 0

    buffers, moved_out = {}, {}
    for s, r in owners.items():
        alive = states[s].alive
        a = alive.to(torch.int64)
        above = torch.flip(torch.cumsum(torch.flip(a, (0,)), 0), (0,)) - a  # alive rows above
        move = alive & (above < int(sent[s]))  # my topmost alive rows
        rows = _bundle(states[s], adams[s], stats[s])
        buf = rows.new_zeros((k + 1, rows.shape[1]))
        buf[torch.where(move, above, k)] = rows  # row k takes what stays
        buffers[r], moved_out[s] = buf[:k], move
    pools = mesh.gather_shard(buffers)

    # pool row (s * k + j) holds a record iff j < sent[s]; the r-th record in
    # (shard, rank) order is valid_idx[r]
    pj = np.arange(n_shard * k)
    valid_idx = torch.as_tensor(pj[(pj % k) < sent[pj // k]], device=mesh.device)
    cum_want = np.cumsum(want) - want
    out_states, out_adams, out_stats = {}, {}, {}
    for s, r in owners.items():
        pool = pools[r].reshape(n_shard * k, -1)
        start = min(int(cum_want[s]), pool_size)
        take = min(int(want[s]), pool_size - start)
        alive2 = states[s].alive & ~moved_out[s]
        f = (~alive2).to(torch.int64)
        free_rank = torch.cumsum(f, 0) - f
        recv = ~alive2 & (free_rank < take)  # my lowest free slots
        src = valid_idx[torch.clamp(start + free_rank, max=valid_idx.numel() - 1)]
        state, out_adams[s], out_stats[s] = _unbundle(
            states[s].replace(alive=alive2), adams[s], stats[s], pool[src], recv)
        out_states[s] = state.replace(alive=alive2 | recv)
    return out_states, out_adams, out_stats, pool_size


def make_sharded_rebalance(mesh, migration_budget: int = 4096):
    """One rebalance round (gs_tpu ``make_sharded_rebalance``):
    ``rebalance(states, adams, stats)`` returns the new shards and the
    number of Gaussians moved."""
    def run(states, adams, stats):
        return _rebalance_round(mesh, states, adams, stats, int(migration_budget))

    return run


def make_sharded_rebalance_loop(mesh, migration_budget: int = 4096, max_rounds: int = 8):
    """Rounds until the skew is at most the threshold, a round moves
    nothing, or ``max_rounds`` ran (gs_tpu ``make_sharded_rebalance_loop``,
    the same state): ``loop(states, adams, stats, skew_threshold)`` returns
    the new shards and the rows moved in all."""
    k = int(migration_budget)

    def run(states, adams, stats, skew_threshold):
        threshold = np.float32(skew_threshold)
        go = _skew(shard_occupancy(mesh, states)) > threshold
        rounds = moved_total = 0
        while go:
            states, adams, stats, moved = _rebalance_round(mesh, states, adams, stats, k)
            rounds += 1
            moved_total += moved
            go = (moved > 0 and rounds < max_rounds
                  and _skew(shard_occupancy(mesh, states)) > threshold)
        return states, adams, stats, moved_total

    return run
