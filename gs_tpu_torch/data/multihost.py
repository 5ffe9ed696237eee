"""Camera ownership, the deterministic batch sampler and the per-row image
split of a mesh run (port of ``gs_tpu/data/multihost.py``).

gs_tpu shuffles the cameras once with a common seed and gives camera
``gi`` to process ``gi % process_count`` (round robin over the global
index), so each host loads only the images it owns; every process draws
the same batches from the shared ``random`` module (``BatchSampler``),
slot i of a batch taking a camera owned by the process that feeds data
row i, which must be one process.

Here a process is one rank, and a data row of ``shard > 1`` ranks spans
several processes, so gs_tpu's rule taken literally would always refuse.
Ownership is by data row instead: the ranks of row d load the train
images that slot d can draw (``owns_camera(i, d, data)``), and the
feeders are ``[0, 1, ..., data - 1]`` with ``process_count = data``:
gs_tpu's world with one process a data row, whose sampler draws the same
batches. Test cameras are loaded by every rank.
"""

from __future__ import annotations

import dataclasses
import random as _random


def process_info() -> tuple[int, int]:
    """(rank, world size) of this process, (0, 1) outside a distributed world
    (gs_tpu's ``jax.process_index()``, ``jax.process_count()``)."""
    from gs_tpu_torch.parallel.mesh import world

    return world()


def owns_camera(global_idx: int, process_id: int, process_count: int) -> bool:
    """Round-robin camera ownership over the global (post-shuffle) index."""
    if process_count <= 1:
        return True
    return global_idx % process_count == process_id


def owned_indices(n: int, process_id: int, process_count: int) -> list[int]:
    return [i for i in range(n) if owns_camera(i, process_id, process_count)]


def should_load_image(global_idx: int, process_id: int, process_count: int, *,
                      is_test: bool = False) -> bool:
    """Whether this rank loads the ground-truth image (gs_tpu
    ``should_load_image``; ``process_id`` / ``process_count`` are the
    rank's data row and the number of rows): train cameras by their owner
    only, test cameras everywhere (the in-training evaluation reads them,
    and test splits are small)."""
    return is_test or owns_camera(global_idx, process_id, process_count)


def data_row_feeders(mesh) -> list[int]:
    """The owner feeding each data row of ``mesh``: row d itself (see the
    module docstring), so slot d always draws a camera its row's ranks
    loaded."""
    return list(range(mesh.data))


def assemble_global_batch(mesh, cams) -> list:
    """The step's camera batch from the sampler's (one camera a data row,
    the same list on every rank): the rows this process runs get their
    image on the mesh's device; the others pass as they are. Raises, as
    gs_tpu's does, if a row run here lacks its image (the sampler handed a
    camera this rank does not own to its slot)."""
    out = list(cams)
    for d in sorted({r[0] for r in mesh.ranks}):
        cam = out[d]
        if cam.image is None:
            raise RuntimeError(
                f"rank {mesh.ranks[0]} must feed batch slot {d} but does not own its "
                f"ground-truth image — the sampler assigned an unowned camera to a locally-fed "
                f"slot (bug)")
        if cam.image.device != mesh.device:
            out[d] = dataclasses.replace(cam, image=cam.image.to(mesh.device))
    return out


class BatchSampler:
    """Deterministic camera batching over the global camera list (gs_tpu
    ``multihost.BatchSampler``, gs_tpu/data/multihost.py:150-223).

    Every process runs it alike, driven by the shared ``random`` module RNG
    after a common seed (or by ``rng``): batch slot i draws from the pool of
    cameras at one resolution OWNED by the process feeding data row i. The
    resolution of a batch is drawn uniformly from those every feeder owns a
    camera at (the reference's shuffled viewpoint stack, per resolution).
    """

    def __init__(self, cams, feeders: list[int], process_count: int,
                 rng: _random.Random | None = None):
        self.cams = list(cams)
        self.feeders = list(feeders)
        self.rng = rng if rng is not None else _random
        procs = sorted(set(self.feeders))
        self._members: dict[tuple[int, tuple[int, int]], list[int]] = {}
        dropped = 0
        for gi, c in enumerate(self.cams):
            owner = gi % process_count
            if owner not in procs:
                dropped += 1  # owner feeds no data row: camera unusable
                continue
            self._members.setdefault((owner, (c.width, c.height)), []).append(gi)
        if dropped:
            print(f"[multihost] {dropped} cameras owned by processes that feed no data row "
                  f"are excluded from training batches (feeders: {procs}, processes: "
                  f"{process_count})")
        by_res: dict[tuple[int, int], set[int]] = {}
        for (p, res) in self._members:
            by_res.setdefault(res, set()).add(p)
        self.resolutions = sorted(r for r, ps in by_res.items() if ps == set(procs))
        # a batch is one resolution with one owned camera per feeder, so a
        # resolution some feeder owns no camera at is never drawn: say so
        for res, ps in sorted(by_res.items()):
            if ps != set(procs):
                n_cams = sum(len(v) for (p, r), v in self._members.items() if r == res)
                print(f"[multihost] WARNING: resolution {res[0]}x{res[1]} ({n_cams} cameras) "
                      f"excluded from training batches — feeder process(es) "
                      f"{sorted(set(procs) - ps)} own no camera at it; the reference trains "
                      f"on all cameras. Consider fewer processes or uniform resolutions.")
        if not self.resolutions:
            raise ValueError("no resolution has cameras owned by every feeding process; "
                             "cannot form same-resolution global batches")
        self._stacks: dict[tuple[int, tuple[int, int]], list[int]] = {}

    def next_batch(self) -> list:
        """One global batch: a camera for each data row."""
        res = self.resolutions[self.rng.randint(0, len(self.resolutions) - 1)]
        out = []
        for f in self.feeders:
            key = (f, res)
            if not self._stacks.get(key):
                pool = list(self._members[key])
                self.rng.shuffle(pool)
                self._stacks[key] = pool
            out.append(self.cams[self._stacks[key].pop()])
        return out
