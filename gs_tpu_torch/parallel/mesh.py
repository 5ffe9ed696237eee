"""The (data, shard) device mesh on ``torch.distributed`` (port of
``gs_tpu/parallel/mesh.py``).

gs_tpu lays its devices out as a ``jax.sharding.Mesh`` with two axes:

  - ``data``: data parallel over cameras (one camera of the batch a row);
  - ``shard``: image tile columns in the tile layout, reduced over for the
    parameter gradients.

Here one process is one device. Rank ``r`` sits at ``(data_index,
shard_index) = divmod(r, shard)``, as gs_tpu's ``devices.reshape(data,
shard)`` places device ``r``. Each rank joins two process groups: its data
row's ranks (the reductions over ``shard``) and its shard column's ranks
(the reductions over ``data``).

The collectives (``gather_shard``, ``sum_shard``, ``sum_scatter_shard``,
``gather_counts``, ``sum_data``, ``max_data``, ``max_all``) take and
return ``{(data_index, shard_index): tensor}`` for the ranks this process
runs: one on a process-group mesh (``make_mesh``); every rank of the mesh
on an in-process mesh (``in_process_mesh``), where they stack, add and
take maxima over the ranks' tensors in rank order. The sharded steps
(``parallel/sharded.py``, ``parallel/gauss_sharded.py``) are written once
against them, so one process can run every rank of a mesh one after
another with the same per-rank functions: the tests and a one-card
machine do.

Backend: NCCL when every rank (all on one host) has a card of its own;
gloo otherwise, on the CPU or with several ranks on one card (NCCL refuses
two ranks on one device). Gloo reduces CUDA tensors through host buffers
of its own; the step's tensors stay on the card.
"""

from __future__ import annotations

import dataclasses
import itertools

import torch
import torch.distributed as dist

from gs_tpu_torch.device import resolve_device

DATA_AXIS = "data"
SHARD_AXIS = "shard"


def choose_backend(device: str | torch.device, num_processes: int) -> str:
    """"nccl" when each of the ``num_processes`` ranks has a card of its own,
    else "gloo". A CUDA ``device`` without a card raises (``resolve_device``):
    the step never moves to the CPU because a card is missing."""
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= num_processes:
        return "nccl"
    return "gloo"


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, *,
                     device: str | torch.device = "cuda") -> str | None:
    """Join the ``num_processes``-rank world as rank ``process_id``
    (``init_process_group`` with a ``tcp://`` rendezvous at ``coordinator``,
    "host:port", or any init-method URL given whole, e.g. ``file://``); a
    no-op for one process. Returns the backend (see ``choose_backend``),
    which it prints."""
    if not num_processes or num_processes <= 1:
        return None
    backend = choose_backend(device, num_processes)
    method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    print(f"[mesh] rank {process_id} of {num_processes}: {backend} backend, rendezvous {method}",
          flush=True)
    dist.init_process_group(backend, init_method=method, world_size=num_processes,
                            rank=process_id)
    return backend


def world() -> tuple[int, int]:
    """(rank, world size) of the process, (0, 1) outside a distributed world."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def rank_device(device: str | torch.device = "cuda", rank: int | None = None) -> torch.device:
    """The device of ``rank`` (this process's by default): for CUDA, card
    ``rank % device_count``, so ranks share the cards round robin, unless
    ``device`` names its card; else the CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if rank is None:
        rank = world()[0]
    return torch.device("cuda", rank % torch.cuda.device_count())


def mesh_shape(data: int, shard: int | None, n: int) -> tuple[int, int]:
    """(data, shard) of a mesh over ``n`` devices; ``shard`` None takes all
    the devices left. Raises as gs_tpu's ``make_mesh`` does."""
    if shard is None:
        if n % data != 0:
            raise ValueError(f"{n} devices not divisible by data={data}")
        shard = n // data
    if data * shard != n:
        raise ValueError(f"mesh {data}x{shard} != {n} devices")
    return data, shard


def _ordered_sum(xs):
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + x
    return acc


def _ordered_max(xs):
    acc = xs[0]
    for x in xs[1:]:
        acc = torch.maximum(acc, x)
    return acc


@dataclasses.dataclass
class Mesh:
    """A (data, shard) mesh and the ranks of it this process runs.

    ``ranks``: the (data_index, shard_index) of each rank run here.
    ``shard_group``: this rank's data row (ranks reduced over ``shard``);
    ``data_group``: its shard column (reduced over ``data``); both None on
    an in-process mesh. ``device``: where every rank run here computes.
    """

    data: int
    shard: int
    ranks: tuple[tuple[int, int], ...]
    device: torch.device
    shard_group: object = None
    data_group: object = None

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.data, SHARD_AXIS: self.shard}

    @property
    def distributed(self) -> bool:
        """True for a process-group mesh (one rank here, the others in
        other processes)."""
        return self.shard_group is not None

    # -- collectives over {(data_index, shard_index): tensor} --------------

    def gather_shard(self, xs: dict) -> dict:
        """Each rank's [shard, ...] stack of its data row's tensors, in shard
        order (gs_tpu's ``all_gather`` over ``shard``)."""
        if self.distributed:
            (r, x), = xs.items()
            if self.shard == 1:
                return {r: x[None]}
            parts = [torch.empty_like(x) for _ in range(self.shard)]
            dist.all_gather(parts, x.contiguous(), group=self.shard_group)
            return {r: torch.stack(parts)}
        return {(d, s): torch.stack([xs[(d, j)] for j in range(self.shard)]) for d, s in xs}

    def _reduce(self, xs: dict, axis: str, op) -> dict:
        n = self.shard if axis == SHARD_AXIS else self.data
        if self.distributed:
            (r, x), = xs.items()
            if n > 1:
                group = self.shard_group if axis == SHARD_AXIS else self.data_group
                x = x.contiguous()  # NCCL refuses strided tensors (gloo copies them)
                dist.all_reduce(x, op=dist.ReduceOp.SUM if op is _ordered_sum
                                else dist.ReduceOp.MAX, group=group)
            return {r: x}
        if axis == SHARD_AXIS:
            return {(d, s): op([xs[(d, j)] for j in range(n)]) for d, s in xs}
        return {(d, s): op([xs[(j, s)] for j in range(n)]) for d, s in xs}

    def sum_shard(self, xs: dict) -> dict:
        """Sum over the data row (gs_tpu's ``psum`` over ``shard``); a
        process-group mesh reduces a contiguous tensor in place."""
        return self._reduce(xs, SHARD_AXIS, _ordered_sum)

    def sum_scatter_shard(self, xs: dict) -> dict:
        """gs_tpu's ``psum_scatter`` over ``shard``, the transpose of the tiled
        all-gather: each rank's [shard * L, ...] tensor summed over its data
        row, of which the rank keeps its rows [s * L, (s + 1) * L). Written as
        ``sum_shard`` and a slice so that gloo, NCCL and the in-process mesh
        give the same bits; NCCL's ``reduce_scatter_tensor`` would move 1 /
        shard of the bytes (a later optimisation)."""
        out = {}
        for (d, s), x in self.sum_shard(xs).items():
            rows = x.shape[0] // self.shard
            out[(d, s)] = x[s * rows:(s + 1) * rows]
        return out

    def gather_counts(self, counts: dict) -> dict:
        """One host int a rank, all-gathered over its data row: each rank's
        list of the row's ints in shard order. Every rank of the row reads
        the same list, so host decisions taken from it (a loop's rounds, which
        collectives run) stay in lockstep."""
        if self.distributed:
            (r, c), = counts.items()
            if self.shard == 1:
                return {r: [int(c)]}
            t = torch.tensor([int(c)], dtype=torch.int64, device=self.device)
            parts = [torch.empty_like(t) for _ in range(self.shard)]
            dist.all_gather(parts, t, group=self.shard_group)
            return {r: [int(p) for p in parts]}
        return {(d, s): [int(counts[(d, j)]) for j in range(self.shard)] for d, s in counts}

    def sum_data(self, xs: dict) -> dict:
        """Sum over the shard column (``psum`` over ``data``), in place where
        distributed."""
        return self._reduce(xs, DATA_AXIS, _ordered_sum)

    def max_data(self, xs: dict) -> dict:
        """Maximum over the shard column (``pmax`` over ``data``)."""
        return self._reduce(xs, DATA_AXIS, _ordered_max)

    def max_all(self, xs: dict) -> dict:
        """Maximum over the whole mesh (``pmax`` over both axes)."""
        return self._reduce(self._reduce(xs, SHARD_AXIS, _ordered_max), DATA_AXIS, _ordered_max)


def make_mesh(data: int = 1, shard: int | None = None, *,
              device: str | torch.device = "cuda") -> Mesh:
    """The (data, shard) mesh of the process world (``init_distributed``
    first for more than one process); ``shard`` defaults to every rank
    left. Every rank calls ``new_group`` for every row and column, in the
    same order, as torch.distributed requires. Raises ValueError when
    data x shard is not the world size."""
    rank, size = world()
    data, shard = mesh_shape(data, shard, size)
    d, s = divmod(rank, shard)
    shard_group = data_group = None
    if size > 1:
        for row in range(data):
            g = dist.new_group([row * shard + j for j in range(shard)])
            shard_group = g if row == d else shard_group
        for col in range(shard):
            g = dist.new_group([i * shard + col for i in range(data)])
            data_group = g if col == s else data_group
    return Mesh(data, shard, ((d, s),), rank_device(device, rank), shard_group, data_group)


def in_process_mesh(data: int = 1, shard: int = 1, *,
                    device: str | torch.device = "cuda") -> Mesh:
    """A data x shard mesh whose ranks all run in this process, one after
    another, on ``device``."""
    ranks = tuple(itertools.product(range(data), range(shard)))
    return Mesh(data, shard, ranks, resolve_device(device))
