"""gs_tpu_torch's tile-sharded training across processes, on the CPU.

Every case that spawns processes is here. Each world is 2 gloo ranks in
fresh interpreters with a ``file://`` rendezvous of its own
(``torch_port_inputs.spawn_ranks``), on tests/test_sharding.py's scene
(32x32, 48 Gaussians):

- one (1, 2) and one (2, 1) step: the two ranks' states are bitwise equal
  to each other (the replicated contract) and to the in-process mesh
  running the same per-rank functions;
- ``run_training`` with a 1 x 2 ``ParallelConfig`` over 2 processes,
  resumed from a checkpoint whose capacity (63) the shard count does not
  divide, for 3 iterations against gs_tpu's ``run_training_parallel`` on a
  1 x 2 virtual mesh from the same checkpoint with the same seed (the same
  capacity padding and camera draws), at tests/test_sharding.py's
  tolerances.

Also in one process: carry against the gather in the sharded step (bitwise
under ``GRAD_REDUCE="cuda"``) and against gs_tpu's carry under
``shard_map`` (``test_tile_sharded_carry_matches_gather``; its kernels in
interpret mode), the tile layout's capacity growth against gs_tpu's, and
what ``run_training`` refuses. The same paths on the card are marked
``cuda``.
"""

import dataclasses
import functools
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_tpu import cameras as j_cameras
from gs_tpu import config as j_config
from gs_tpu.models import densify as j_densify
from gs_tpu.models import optim as j_optim
from gs_tpu.ops import rasterize_tiled as j_tiled
from gs_tpu.parallel import mesh as j_mesh
from gs_tpu.parallel import sharded as j_sharded
from gs_tpu.parallel import trainer as j_trainer
from gs_tpu.training import TrainState as JTrainState
from gs_tpu_torch import config, interop, training
from gs_tpu_torch.ops import rasterize_tiled
from gs_tpu_torch.parallel import mesh as mesh_mod
from gs_tpu_torch.parallel import gauss_sharded, sharded, trainer
from tests.test_torch_sharding import (H, J_RCFG, RCFG, W, assert_step_close, j_scene,
                                       j_submesh, port_scene, port_step)
from tests.torch_port_inputs import (STATE_FIELDS, camera_dict, one_torch_thread,  # noqa: F401
                                     spawn_ranks)

OPT = config.OptimizationParams()


def assert_same(a, b, what=""):
    """Bitwise equality of two nested results (states, Adam, stats, dicts)."""
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), what
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            assert_same(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (tuple, list)):
        for i, (x, y) in enumerate(zip(a, b, strict=True)):
            assert_same(x, y, f"{what}[{i}]")
    elif hasattr(a, "__dataclass_fields__"):
        for k in a.__dataclass_fields__:
            assert_same(getattr(a, k), getattr(b, k), f"{what}.{k}")
    else:
        assert a == b, what


# --- spawned gloo worlds ---------------------------------------------------------------------


@pytest.mark.parametrize("data,shard", [(1, 2), (2, 1)])
def test_spawned_step_ranks_bitwise(tmp_path, data, shard):
    """A 2-rank gloo world takes one sharded step: both ranks end with the
    same bits, and with the bits of the in-process mesh of the same shape."""
    state, _ = port_scene()
    cams = [port_scene(seed=s)[1] for s in range(data)]
    inputs = tmp_path / "inputs.pt"
    torch.save((state, cams, OPT, RCFG), inputs)
    ranks = spawn_ranks("sharded_step_rank", 2, tmp_path, str(inputs), data, shard)
    assert_same(ranks[0], ranks[1], "rank 0 vs rank 1")
    _, local = port_step(data, shard, tuple(range(data)))
    assert_same(ranks[0], local, "process-group mesh vs in-process mesh")
    assert float(local[3]["loss"]) > 0 and int(local[3]["num_pairs_max"]) > 0


TRAIN_ITERS, N_VIEWS, RESUME_AT, RESUME_CAP = 4, 4, 1, 63


@functools.lru_cache(maxsize=None)
def training_views():
    """4 views of j_scene's state from around the z axis, each with its own
    random target image, as gs_tpu cameras."""
    rng = np.random.default_rng(7)
    cams = []
    for i in range(N_VIEWS):
        a = 0.3 * (i - 1.5)
        rot = np.array([[math.cos(a), 0, -math.sin(a)], [0, 1, 0],
                        [math.sin(a), 0, math.cos(a)]])
        cams.append(j_cameras.make_camera(
            rot, np.array([0.0, 0.0, 4.0]), fovx=math.radians(60), fovy=math.radians(60),
            width=W, height=H, image=rng.uniform(0, 1, (3, H, W)).astype(np.float32)))
    return cams


class _JScene:
    """The scene interface gs_tpu's trainer reads."""

    cameras_extent = 1.0
    model_path = ""

    def __init__(self, state, cams):
        self.gaussians, self._cams = state, cams

    def get_train_cameras(self):
        return self._cams

    def get_test_cameras(self):
        return []

    def save(self, iteration, state=None):
        pass


def test_parallel_training_matches_gs_tpu(tmp_path, monkeypatch):
    """run_training over a 1 x 2 mesh of processes against gs_tpu's
    run_training_parallel on a 1 x 2 virtual mesh (seed 0, no autotune),
    both resumed from one .npz checkpoint (iteration 1, capacity 63, which
    each pads to 4096 x 2) for iterations 2-4: the ranks end bitwise equal,
    and within test_sharding.py's tolerances of gs_tpu."""
    from gs_tpu_torch.utils import ckpt

    opt = dict(iterations=TRAIN_ITERS)
    state, _ = port_scene()
    resumed = training.init_train_state(
        state.replace(**{k: getattr(state, k)[:RESUME_CAP] for k in STATE_FIELDS}), 1.0, 1)
    resumed.iteration = RESUME_AT
    start = str(tmp_path / "chkpnt1.npz")
    ckpt.save_train_state(start, resumed)

    real = j_mesh.make_mesh
    monkeypatch.setattr(j_mesh, "make_mesh",
                        lambda data=1, shard=None: real(data, shard, devices=jax.devices()[:2]))
    j_st, _ = j_scene()
    j_ts = j_trainer.run_training_parallel(
        _JScene(j_st, training_views()), j_config.OptimizationParams(**opt),
        j_config.PipelineParams(), j_config.ParallelConfig(shard_parallel=2),
        raster_cfg=dataclasses.replace(J_RCFG, autotune=False),
        test_iterations=(), save_iterations=(), log_every=1, start_checkpoint=start)

    cams = [interop.camera_from_numpy(dict(camera_dict(c), image=np.asarray(c.image)), "cpu")
            for c in training_views()]
    inputs = tmp_path / "inputs.pt"
    torch.save((state, cams, config.OptimizationParams(**opt),
                config.RasterizeConfig(chunk=32, tile_w=16, tile_h=16, autotune=False)), inputs)
    ranks = spawn_ranks("parallel_training_rank", 2, tmp_path, str(inputs), 1, 2, start)
    assert_same(ranks[0], ranks[1], "rank 0 vs rank 1")
    got_state, got_adam, got_stats, iteration, *_ = ranks[0]
    assert iteration == TRAIN_ITERS == j_ts.iteration
    assert got_state.capacity == j_ts.state.capacity == 4096 * 2
    assert not got_state.alive[RESUME_CAP:].any()
    # the final iteration skips Adam
    assert got_adam.step["xyz"] == TRAIN_ITERS - RESUME_AT - 1 == int(j_ts.adam.step["xyz"])
    np.testing.assert_allclose(got_state.xyz.numpy(), np.asarray(j_ts.state.xyz),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got_stats.xyz_grad_accum.numpy(),
                               np.asarray(j_ts.stats.xyz_grad_accum), rtol=1e-3, atol=1e-7)
    np.testing.assert_array_equal(got_stats.denom.numpy(), np.asarray(j_ts.stats.denom))
    np.testing.assert_allclose(got_adam.nu["opacity"].numpy(),
                               np.asarray(j_ts.adam.nu["opacity"]), rtol=1e-3, atol=1e-10)


# --- the Gaussian-sharded layout across processes ---------------------------------------------


def test_spawned_gauss_step_ranks_bitwise(tmp_path, monkeypatch):
    """A 2-rank gloo world takes one (1, 2) gauss step under GRAD_REDUCE
    "scatter" and "cuda": the ranks' metrics are bitwise equal, and rank s's
    shard is bitwise equal to shard s of the in-process mesh."""
    from tests.test_torch_gauss_sharded import port_gauss_step

    state, cam = port_scene()
    inputs = tmp_path / "inputs.pt"
    torch.save((state, [cam], OPT, RCFG), inputs)
    ranks = spawn_ranks("gauss_step_rank", 2, tmp_path, str(inputs), 1, 2)
    for reduce in ("scatter", "cuda"):
        monkeypatch.setattr(rasterize_tiled, "GRAD_REDUCE", reduce)
        (states, adams, stats), _, m = port_gauss_step(1, 2)
        assert_same(ranks[0][reduce][3], ranks[1][reduce][3], f"{reduce}: rank 0 vs rank 1")
        assert_same(ranks[0][reduce][3], m, f"{reduce}: ranks vs in-process")
        for s in range(2):
            assert_same(ranks[s][reduce][:3], (states[s], adams[s], stats[s]),
                        f"{reduce}: rank {s} vs in-process shard {s}")
        assert float(m["loss"]) > 0 and int(m["num_visible_max"]) > 0


GAUSS_ITERS, GAUSS_CAPS = 4, (64, 8192)
GAUSS_OPT = dict(iterations=GAUSS_ITERS, densify_from_iter=1, densification_interval=2)


def gs_tpu_split_noise(path, rounds=2, caps=GAUSS_CAPS, seed=0):
    """gs_tpu's trainer's split noise (key = PRNGKey(seed), split at every
    densify round, fold_in of each global slot) for each (round, capacity),
    saved for the ranks' ``split_noise``."""
    key = jax.random.PRNGKey(seed)
    draws = {}
    for rnd in range(rounds):
        key, sub = jax.random.split(key)
        for cap in caps:
            keys = jax.vmap(lambda i: jax.random.fold_in(sub, i))(jnp.arange(cap, dtype=jnp.int32))
            eps = jax.vmap(lambda k: jax.random.normal(k, (2, 3), jnp.float32))(keys)
            draws[(rnd, cap)] = torch.from_numpy(np.array(jnp.swapaxes(eps, 0, 1)))
    torch.save(draws, path)


def test_gauss_training_matches_gs_tpu(tmp_path, monkeypatch):
    """run_training with a 1 x 2 gauss ParallelConfig over 2 processes
    against gs_tpu's run_training_parallel gauss on a 1 x 2 virtual mesh,
    both resumed at iteration 1 from one state (gs_tpu from its .npz, the
    port from a checkpoint directory of the same state), seed 0, densify at
    iterations 2 and 4 with gs_tpu's split noise fed to the port; the
    capacity grows at 4 (64 -> 8192, the new slots all in shard 1) and a
    rebalance follows: the
    ranks' losses bitwise equal, the shards put together within
    test_sharding.py's tolerances of gs_tpu's global arrays, slot by slot,
    the alive masks equal."""
    from gs_tpu_torch.utils import ckpt

    state, _ = port_scene()
    resumed = training.init_train_state(state, 1.0, 1)
    resumed.iteration = RESUME_AT
    ckpt.save_train_state(str(tmp_path / "start.npz"), resumed)
    ckpt.save_train_state(str(tmp_path / "start_dir"), resumed)
    noise = tmp_path / "noise.pt"
    gs_tpu_split_noise(noise)

    real = j_mesh.make_mesh
    monkeypatch.setattr(j_mesh, "make_mesh",
                        lambda data=1, shard=None: real(data, shard, devices=jax.devices()[:2]))
    j_st, _ = j_scene()
    j_ts = j_trainer.run_training_parallel(
        _JScene(j_st, training_views()), j_config.OptimizationParams(**GAUSS_OPT),
        j_config.PipelineParams(), j_config.ParallelConfig(shard_parallel=2, layout="gauss"),
        raster_cfg=dataclasses.replace(J_RCFG, autotune=False), test_iterations=(),
        save_iterations=(), log_every=1, start_checkpoint=str(tmp_path / "start.npz"))

    cams = [interop.camera_from_numpy(dict(camera_dict(c), image=np.asarray(c.image)), "cpu")
            for c in training_views()]
    inputs = tmp_path / "inputs.pt"
    torch.save((state, cams, config.OptimizationParams(**GAUSS_OPT),
                config.RasterizeConfig(chunk=32, tile_w=16, tile_h=16, autotune=False)), inputs)
    ranks = spawn_ranks("parallel_training_rank", 2, tmp_path, str(inputs), 1, 2,
                        str(tmp_path / "start_dir"), "gauss", str(noise))
    losses = [r[4] for r in ranks]
    assert losses[0] == losses[1] and len(losses[0]) == GAUSS_ITERS - RESUME_AT
    assert ranks[0][6] == ranks[1][6]
    moved = [(before, after) for before, after in ranks[0][6] if before != after]
    assert len(moved) == 1, "the growth at iteration 4 leaves shard 1 empty: a rebalance"
    (before, after), = moved
    assert max(before) / (sum(before) / 2) > 1.25 and max(after) - min(after) <= 1
    got_state = gauss_sharded.gather_rows(mesh_mod.in_process_mesh(1, 2, device="cpu"),
                                          {r: (ranks[r][0], ranks[r][1], ranks[r][2])
                                           for r in range(2)})
    state_w, adam_w, stats_w = got_state
    assert ranks[0][3] == GAUSS_ITERS == j_ts.iteration
    assert state_w.capacity == j_ts.state.capacity
    np.testing.assert_array_equal(state_w.alive.numpy(), np.asarray(j_ts.state.alive))
    np.testing.assert_allclose(state_w.xyz.numpy(), np.asarray(j_ts.state.xyz),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(state_w.logit_opacity.numpy(), np.asarray(j_ts.state.logit_opacity),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(stats_w.xyz_grad_accum.numpy(),
                               np.asarray(j_ts.stats.xyz_grad_accum), rtol=1e-3, atol=1e-7)
    np.testing.assert_allclose(adam_w.nu["opacity"].numpy(), np.asarray(j_ts.adam.nu["opacity"]),
                               rtol=1e-3, atol=1e-10)
    assert adam_w.step["xyz"] == int(j_ts.adam.step["xyz"])


def multiproc_inputs(n_points, res, views, seed=0):
    """benchmarks/multiproc_check.py's scene: ``n_points`` Gaussians (SH
    degree 1) and ``views`` cameras of random targets stepping along x."""
    from gs_tpu_torch import cameras
    from gs_tpu_torch.models import gaussians

    rng = np.random.default_rng(seed)
    state = gaussians.create_from_pcd(rng.uniform(-1, 1, (n_points, 3)).astype(np.float32),
                                      rng.uniform(0, 1, (n_points, 3)).astype(np.float32),
                                      max_sh_degree=1, capacity=n_points, device="cpu")
    cams = [cameras.make_camera(np.eye(3), np.array([0.03 * i, 0.0, 4.0]),
                                fovx=math.radians(60), fovy=math.radians(60), width=res,
                                height=res, device="cpu",
                                image=np.random.default_rng(100 + i).uniform(
                                    0, 1, (3, res, res)).astype(np.float32))
            for i in range(views)]
    return state, cams


def run_multiproc_twin(tmp_path, world, data, shard, iters, n_points, res):
    state, cams = multiproc_inputs(n_points, res, 8)
    opt = config.OptimizationParams(iterations=iters, densify_from_iter=2,
                                    densification_interval=2, densify_until_iter=iters - 1,
                                    opacity_reset_interval=100)
    inputs = tmp_path / "inputs.pt"
    torch.save((state, cams, opt, config.RasterizeConfig(chunk=32, tile_w=16, tile_h=16,
                                                         autotune=False)), inputs)
    ranks = spawn_ranks("parallel_training_rank", world, tmp_path, str(inputs), data, shard,
                        None, "gauss", None, True, timeout=600)
    for r in ranks[1:]:
        assert r[4] == ranks[0][4], "the ranks' losses are bitwise equal"
    assert all(np.isfinite(ranks[0][4])) and len(ranks[0][4]) == iters
    assert [r[5] for r in ranks] == [8 // data] * world  # each row's own train images
    assert ranks[0][3] == iters
    return ranks


def test_multiprocess_gauss_with_image_split(tmp_path):
    """A short twin of benchmarks/multiproc_check.py: 2 gloo processes, a
    (2, 1) gauss mesh, densify at iterations 4 and 6, each rank holding only
    its data row's 4 of the 8 train images: the losses of every iteration
    bitwise equal on both ranks, and the same final state."""
    ranks = run_multiproc_twin(tmp_path, 2, 2, 1, 6, 64, 32)
    assert_same(ranks[0][:3], ranks[1][:3], "rank 0 vs rank 1")


@pytest.mark.skipif(os.environ.get("GS_TPU_SLOW") != "1",
                    reason="spawns 4 OS processes for 12 iterations; set GS_TPU_SLOW=1")
def test_multiprocess_gauss_long(tmp_path):
    """benchmarks/multiproc_check.py's run at its size (256 Gaussians, 48x48,
    12 iterations, densify at 4, 6, 8 and 10) on a 2 x 2 gauss mesh of 4 gloo
    processes, each data row's ranks holding its 4 of the 8 train images:
    the losses bitwise equal on every rank, the shards of a data row equal
    to the other row's."""
    ranks = run_multiproc_twin(tmp_path, 4, 2, 2, 12, 256, 48)
    for s in range(2):
        assert_same(ranks[s][:3], ranks[2 + s][:3], f"shard {s}: data row 0 vs 1")


# --- carry in the sharded step ---------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def j_carry_step():
    """gs_tpu's 1 x 2 sharded step with its Pallas kernels in interpret mode
    under PAIR_SOURCE="carry" (tests/test_sharding.py:264-280)."""
    st, cam = j_scene()
    cfg = j_config.RasterizeConfig(backend="pallas", chunk=32, tile_w=16, tile_h=16)
    old = j_tiled.PAIR_SOURCE
    try:
        j_tiled.PAIR_SOURCE = "carry"
        step = j_sharded.make_sharded_train_step(j_submesh(1, 2), j_config.OptimizationParams(),
                                                 cfg, H, W, st.capacity, 1)
        s, a, d, m = step(st, j_optim.init(st.params()), j_densify.DensifyStats.zeros(st.capacity),
                          j_cameras.stack_cameras([cam]), jnp.zeros(3), jnp.int32(0),
                          jnp.float32(1.0), jnp.bool_(True))
        return (np.asarray(s.xyz), np.asarray(a.nu["opacity"]), np.asarray(a.mu["xyz"]),
                np.asarray(d.xyz_grad_accum), np.asarray(d.denom), float(m["loss"]),
                int(m["num_pairs_max"]))
    finally:
        j_tiled.PAIR_SOURCE = old


def test_tile_sharded_carry_matches_gather(monkeypatch):
    """The sharded step under PAIR_SOURCE="carry" (the strips binned with
    their attributes carried, B6 and B5's plain versions) equals the
    gather under GRAD_REDUCE="cuda" bitwise, and gs_tpu's carry step at
    test_sharding.py's tolerances."""
    monkeypatch.setattr(rasterize_tiled, "GRAD_REDUCE", "cuda")
    _, gathered = port_step(1, 2, (0,))
    monkeypatch.setattr(rasterize_tiled, "GRAD_REDUCE", "scatter")
    monkeypatch.setattr(rasterize_tiled, "PAIR_SOURCE", "carry")
    _, carried = port_step(1, 2, (0,))
    assert_same(carried, gathered, "carry vs gather")
    assert_step_close(carried, j_carry_step())


# --- the trainer in one process --------------------------------------------------------------


def test_capacity_growth_matches_gs_tpu():
    """The tile layout's growth (gs_tpu _maybe_grow_parallel, tile branch):
    past the watermark the capacity doubles and rounds up to 4096 x S, the
    new slots dead with zero moments and stats; below it nothing changes."""
    j_st, _ = j_scene()
    state, _ = port_scene()
    for n_shard in (2, 3):
        quantum = 4096 * n_shard
        j_ts = JTrainState(
            state=j_st, adam=j_optim.init(j_st.params()),
            stats=j_densify.DensifyStats.zeros(j_st.capacity))
        j_ts = j_trainer._maybe_grow_parallel(j_ts, None, False, quantum, 0.5, 2.0)
        ts = trainer.maybe_grow_parallel(training.init_train_state(state, 1.0, 1), quantum,
                                         0.5, 2.0)
        assert ts.state.capacity == j_ts.state.capacity == quantum
        for k in STATE_FIELDS:
            np.testing.assert_array_equal(getattr(ts.state, k).numpy(),
                                          np.asarray(getattr(j_ts.state, k)), err_msg=k)
        for k, v in ts.adam.mu.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(j_ts.adam.mu[k]))
        for got, want in zip(ts.stats, j_ts.stats):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        same = trainer.maybe_grow_parallel(ts, quantum, 0.9, 2.0)
        assert same.state.capacity == quantum


def test_run_training_refuses_what_one_process_cannot_run(tmp_path):
    """run_training delegates a ParallelConfig of more than one device: in a
    one-process world the mesh-size error names the mesh, under either
    layout; an unknown layout raises; a 1 x 1 config trains on one device."""
    from gs_tpu_torch import synthetic
    from gs_tpu_torch.config import ParallelConfig, PipelineParams

    state, cam = port_scene()
    scene = synthetic.SyntheticScene(state, [cam], [])
    kw = dict(raster_cfg=RCFG, test_iterations=(), save_iterations=())
    opt = config.OptimizationParams(iterations=1)
    with pytest.raises(ValueError, match="mesh 1x2 != 1 devices"):
        training.run_training(scene, opt, PipelineParams(), parallel=ParallelConfig(
            shard_parallel=2), **kw)
    with pytest.raises(ValueError, match="mesh 1x2 != 1 devices"):
        training.run_training(scene, opt, PipelineParams(), parallel=ParallelConfig(
            shard_parallel=2, layout="gauss"), **kw)
    with pytest.raises(ValueError, match="unknown parallel layout 'rows'"):
        training.run_training(scene, opt, PipelineParams(), parallel=ParallelConfig(
            shard_parallel=2, layout="rows"), **kw)
    ts = training.run_training(scene, opt, PipelineParams(), parallel=ParallelConfig(), **kw)
    assert ts.iteration == 1


# --- on the card -----------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_shard", [2, 4])
def test_cuda_sharded_render_equals_render(cuda_device, n_shard):
    """On the card, the strips (B1 once a strip) reassembled equal the
    unsharded render bitwise."""
    from gs_tpu_torch.renderer import render

    state, cam = (interop.state_from_numpy(
        {k: getattr(port_scene()[0], k).numpy() for k in STATE_FIELDS}, cuda_device),
        interop.camera_from_numpy(dict(camera_dict(j_scene()[1]),
                                       image=np.asarray(j_scene()[1].image)), cuda_device))
    bg = torch.tensor([0.3, 0.2, 0.1], device=cuda_device)
    mesh = mesh_mod.in_process_mesh(1, n_shard, device=cuda_device)
    img = sharded.make_sharded_render(mesh, RCFG, H, W, state.capacity, 1)(state, cam, bg)
    assert torch.equal(img, render(cam, state, active_sh_degree=1, bg_color=bg, cfg=RCFG).image)


@pytest.mark.cuda
def test_cuda_sharded_carry_equals_gather(cuda_device, monkeypatch):
    """On the card, the 1 x 2 sharded step under carry equals the gather
    under GRAD_REDUCE="cuda" bitwise (B5 / B6 inside the strips)."""
    state = interop.state_from_numpy({k: getattr(port_scene()[0], k).numpy()
                                      for k in STATE_FIELDS}, cuda_device)
    cam = interop.camera_from_numpy(dict(camera_dict(j_scene()[1]),
                                         image=np.asarray(j_scene()[1].image)), cuda_device)
    mesh = mesh_mod.in_process_mesh(1, 2, device=cuda_device)

    def run():
        ts = training.init_train_state(state, 1.0, 1)
        step = sharded.make_sharded_train_step(mesh, OPT, RCFG, H, W, state.capacity, 1)
        return step(ts.state, ts.adam, ts.stats, [cam], torch.zeros(3, device=cuda_device), 0,
                    1.0, True)

    monkeypatch.setattr(rasterize_tiled, "GRAD_REDUCE", "cuda")
    gathered = run()
    monkeypatch.setattr(rasterize_tiled, "PAIR_SOURCE", "carry")
    assert_same(run(), gathered)
