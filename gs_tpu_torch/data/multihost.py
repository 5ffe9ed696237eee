"""Camera ownership and the deterministic batch sampler of a mesh run (part
of ``gs_tpu/data/multihost.py``).

gs_tpu shuffles the cameras once with a common seed and gives camera
``gi`` to process ``gi % process_count`` (round robin over the global
index), so each host loads only the images it owns. Every process draws
the same batches from the shared ``random`` module (``BatchSampler``):
slot i of a batch takes a camera owned by the process that feeds data row
i.

In this slice every rank loads every image, so a mesh run samples with
gs_tpu's single-process ownership (``process_count=1``, ``feeders=[0] *
data``) and data row d takes slot d: a run draws the same camera batches
as gs_tpu on a mesh of the same shape with the same seed. The per-process
image split (``should_load_image``, ``data_row_feeders``,
``assemble_global_batch``) waits for ROADMAP A14c.
"""

from __future__ import annotations

import random as _random


def owns_camera(global_idx: int, process_id: int, process_count: int) -> bool:
    """Round-robin camera ownership over the global (post-shuffle) index."""
    if process_count <= 1:
        return True
    return global_idx % process_count == process_id


def owned_indices(n: int, process_id: int, process_count: int) -> list[int]:
    return [i for i in range(n) if owns_camera(i, process_id, process_count)]


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
