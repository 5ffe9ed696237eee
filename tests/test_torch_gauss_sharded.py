"""gs_tpu_torch's Gaussian-sharded step against gs_tpu's on the CPU.

gs_tpu runs ``make_gauss_sharded_train_step`` on sub-meshes of the
8-virtual-device CPU mesh of ``tests/conftest.py`` (``backend="xla"``); the
port runs every rank of an in-process mesh of the same shape through the
plain kernel versions, its state cut into shards (``shard_rows``) and put
back (``gather_rows``). On tests/test_sharding.py's scene (32x32, 48
Gaussians, capacity 64):

- ``TestGaussianSharded``: one step on (1, 2), (1, 4), (2, 2) against
  gs_tpu's at test_sharding.py's tolerances (loss rtol 1e-5, xyz and
  logit opacity rtol 1e-4 / atol 1e-6, stats rtol 1e-3 / atol 1e-7, Adam
  nu rtol 1e-3 / atol 1e-10) and against the port's one-device
  ``train_step`` (the tile layout's step on the same mesh for two data
  rows); the visible-splat budget (enough: the unbudgeted step's bits; too
  small: the overflow reported, as gs_tpu's); the final iteration's
  skipped update; ``compact_visible`` bitwise equal to gs_tpu's, overflow
  included;
- carry equal to the gather under ``GRAD_REDUCE="cuda"`` bitwise in the
  gauss strips;
- the shard layout: ``shard_rows`` equal to gs_tpu's addressable shards
  and ``interop.sharded_from_numpy``, ``gather_rows`` its inverse, the
  mesh's ``sum_scatter_shard`` and ``gather_counts``.

gs_tpu's results are computed once per module.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from gs_tpu import cameras as j_cameras
from gs_tpu import config as j_config
from gs_tpu.models import densify as j_densify
from gs_tpu.models import optim as j_optim
from gs_tpu.parallel import gauss_sharded as j_gauss
from gs_tpu_torch import config, interop, training
from gs_tpu_torch.ops import rasterize_tiled
from gs_tpu_torch.parallel import gauss_sharded, sharded
from gs_tpu_torch.parallel import mesh as mesh_mod
from tests.test_torch_sharding import (H, J_RCFG, RCFG, W, fresh, j_scene, j_submesh, port_scene,
                                       port_step)
from tests.torch_port_inputs import STATE_FIELDS, one_torch_thread  # noqa: F401

OPT = config.OptimizationParams()
MESHES = [(1, 2), (1, 4), (2, 2)]


# --- both packages' steps --------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def j_gauss_fn(data, shard, visible_budget=None):
    st, _ = j_scene()
    return j_gauss.make_gauss_sharded_train_step(
        j_submesh(data, shard), j_config.OptimizationParams(), J_RCFG, H, W, st.capacity, 1,
        visible_budget=visible_budget)


@functools.lru_cache(maxsize=None)
def j_gauss_step(data, shard, visible_budget=None, apply_update=True):
    """gs_tpu's gauss step from fresh Adam and stats, data row d on
    ``j_scene(seed=d)``'s camera; its global arrays as numpy."""
    st, _ = j_scene()
    cams = [j_scene(seed=d)[1] for d in range(data)]
    s, a, d, m = j_gauss_fn(data, shard, visible_budget)(
        st, j_optim.init(st.params()), j_densify.DensifyStats.zeros(st.capacity),
        j_cameras.stack_cameras(cams), jnp.zeros(3), jnp.int32(0), jnp.float32(1.0),
        jnp.bool_(apply_update))
    return dict(xyz=np.asarray(s.xyz), logit_opacity=np.asarray(s.logit_opacity),
                nu_opacity=np.asarray(a.nu["opacity"]), accum=np.asarray(d.xyz_grad_accum),
                denom=np.asarray(d.denom), loss=float(m["loss"]),
                num_visible_max=int(m["num_visible_max"]),
                num_pairs_max=int(m["num_pairs_max"]))


def shards_of(ts, n_shard):
    """{shard index: (state, adam, stats)} of a whole TrainState."""
    return {s: gauss_sharded.shard_rows((ts.state, ts.adam, ts.stats), n_shard, s)
            for s in range(n_shard)}


def port_gauss_step(data, shard, visible_budget=None, apply_update=True):
    """The port's gauss step on an in-process data x shard mesh, the same
    inputs; returns the shards' outputs, the whole (state, adam, stats) and
    the metrics."""
    state, _ = port_scene()
    cams = [port_scene(seed=d)[1] for d in range(data)]
    mesh = mesh_mod.in_process_mesh(data, shard, device="cpu")
    step = gauss_sharded.make_gauss_sharded_train_step(
        mesh, OPT, RCFG, H, W, state.capacity, 1, visible_budget=visible_budget)
    shards = shards_of(fresh(state), shard)
    states, adams, stats, m = step({s: v[0] for s, v in shards.items()},
                                   {s: v[1] for s, v in shards.items()},
                                   {s: v[2] for s, v in shards.items()}, cams, torch.zeros(3),
                                   0, 1.0, apply_update)
    whole = gauss_sharded.gather_rows(mesh, {s: (states[s], adams[s], stats[s])
                                             for s in states})
    return (states, adams, stats), whole, m


def assert_close_to(whole, m, want):
    """tests/test_sharding.py:110-125's tolerances."""
    s, a, d = whole
    np.testing.assert_allclose(float(m["loss"]), want["loss"], rtol=1e-5)
    np.testing.assert_allclose(s.xyz.numpy(), want["xyz"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(s.logit_opacity.numpy(), want["logit_opacity"], rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(d.xyz_grad_accum.numpy(), want["accum"], rtol=1e-3, atol=1e-7)
    np.testing.assert_allclose(a.nu["opacity"].numpy(), want["nu_opacity"], rtol=1e-3,
                               atol=1e-10)
    np.testing.assert_array_equal(d.denom.numpy(), want["denom"])


# --- TestGaussianSharded ---------------------------------------------------------------------


@pytest.mark.parametrize("data,shard", MESHES)
def test_gauss_step_matches_gs_tpu_and_one_device(data, shard):
    """One gauss step against gs_tpu's on the same mesh shape, its
    integer metrics equal; against the port's one-device train_step (one
    data row) or the tile layout's step on the same mesh (two)."""
    (states, _, _), whole, m = port_gauss_step(data, shard)
    want = j_gauss_step(data, shard)
    assert_close_to(whole, m, want)
    assert int(m["num_visible_max"]) == want["num_visible_max"]
    assert 0 < int(m["num_visible_max"]) <= 64 // shard
    assert int(m["num_pairs_max"]) == want["num_pairs_max"] > 0
    assert all(states[s].capacity == 64 // shard for s in range(shard))
    if data == 1:
        state, cam = port_scene()
        ts = fresh(state)
        ref = training.train_step(ts.state, ts.adam, ts.stats, cam, torch.zeros(3), 0, 1.0,
                                  active_sh_degree=1, opt_cfg=OPT, raster_cfg=RCFG,
                                  accumulate_stats=True)
    else:
        _, ref = port_step(data, shard, tuple(range(data)))
    s, a, d = whole
    np.testing.assert_allclose(float(m["loss"]), float(ref[3]["loss"]), rtol=1e-5)
    np.testing.assert_allclose(s.xyz.numpy(), ref[0].xyz.numpy(), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(s.logit_opacity.numpy(), ref[0].logit_opacity.numpy(),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(d.xyz_grad_accum.numpy(), ref[2].xyz_grad_accum.numpy(),
                               rtol=1e-3, atol=1e-7)
    np.testing.assert_allclose(a.nu["opacity"].numpy(), ref[1].nu["opacity"].numpy(),
                               rtol=1e-3, atol=1e-10)


def test_visible_budget_that_holds_every_row_changes_nothing():
    """test_visible_compaction_exact_when_budget_suffices on (1, 4): a budget
    of the local capacity keeps every visible row in order, so the step
    equals the unbudgeted one bitwise, and gs_tpu's budgeted step within
    tolerance."""
    _, exact, m = port_gauss_step(1, 4)
    _, budgeted, mb = port_gauss_step(1, 4, visible_budget=16)
    for k in STATE_FIELDS:
        assert torch.equal(getattr(budgeted[0], k), getattr(exact[0], k)), k
    for k in exact[1].mu:
        assert torch.equal(budgeted[1].mu[k], exact[1].mu[k]), k
        assert torch.equal(budgeted[1].nu[k], exact[1].nu[k]), k
    for got, want in zip(budgeted[2], exact[2]):
        assert torch.equal(got, want)
    assert float(mb["loss"]) == float(m["loss"])
    assert int(mb["num_visible_max"]) == int(m["num_visible_max"])
    assert_close_to(budgeted, mb, j_gauss_step(1, 4, 16))


def test_visible_budget_too_small_reports_overflow():
    """test_visible_compaction_lossy_budget_still_runs on (1, 4): with 2 rows
    a shard, splats are dropped, the overflow is reported and the result is
    finite; the same rows are dropped as by gs_tpu."""
    _, whole, m = port_gauss_step(1, 4, visible_budget=2)
    want = j_gauss_step(1, 4, 2)
    assert np.isfinite(float(m["loss"]))
    assert int(m["num_visible_max"]) == want["num_visible_max"] > 2
    assert bool(torch.isfinite(whole[0].xyz).all())
    assert_close_to(whole, m, want)


@pytest.mark.parametrize("budget", [2, 5, 8, 20])
def test_compact_visible_matches_gs_tpu(budget):
    """test_compact_visible_semantics on its input and on a random one: the
    table and the count bitwise equal to gs_tpu's, overflow included; the
    backward gives each kept row its gradient and the others none."""
    rng = np.random.default_rng(budget)
    packed = rng.normal(size=(16, gauss_sharded.SPLAT_W)).astype(np.float32)
    vis = np.zeros(16, bool)
    vis[[1, 4, 5, 11]] = True
    packed[:, -1] = np.where(vis, 3.0, 0.0)
    rand = rng.normal(size=(40, gauss_sharded.SPLAT_W)).astype(np.float32)
    rand[:, -1] = np.where(rng.uniform(size=40) < 0.4, 2.0, 0.0)
    for rows in (packed, rand):
        got, n = gauss_sharded.compact_visible(torch.from_numpy(rows), budget)
        want, j_n = j_gauss.compact_visible(jnp.asarray(rows), budget)
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(want).view(np.uint32))
        assert int(n) == int(j_n)
    leaf = torch.from_numpy(packed).requires_grad_()
    out, _ = gauss_sharded.compact_visible(leaf, budget)
    g, = torch.autograd.grad(out, leaf, torch.ones_like(out))
    kept = np.flatnonzero(vis)[:budget]
    assert np.array_equal(np.flatnonzero(g[:, 0].numpy()), kept)
    assert float(g.sum()) == len(kept) * gauss_sharded.SPLAT_W


def test_final_iteration_skip_under_gauss():
    """TestFinalIterationSkip under the gauss layout: apply_update=False
    computes the loss and the stats but leaves every shard's parameters and
    Adam as they were."""
    state, _ = port_scene()
    (states, adams, _), whole, m = port_gauss_step(1, 4, apply_update=False)
    want = j_gauss_step(1, 4, apply_update=False)
    np.testing.assert_allclose(float(m["loss"]), want["loss"], rtol=1e-5)
    np.testing.assert_array_equal(whole[0].xyz.numpy(), want["xyz"])
    for k, v in state.params().items():
        assert torch.equal(whole[0].params()[k], v), k
        assert not whole[1].mu[k].any() and not whole[1].nu[k].any()
    assert all(adams[s].step == {k: 0 for k in state.params()} for s in adams)
    np.testing.assert_allclose(whole[2].xyz_grad_accum.numpy(), want["accum"], rtol=1e-3,
                               atol=1e-7)


def test_gauss_carry_equals_gather_cuda(monkeypatch):
    """The gauss strips under PAIR_SOURCE="carry" (B6 and B5's plain
    versions) equal the gather under GRAD_REDUCE="cuda" bitwise, shard by
    shard, on (1, 2) and (2, 2)."""
    for data, shard in ((1, 2), (2, 2)):
        monkeypatch.setattr(rasterize_tiled, "PAIR_SOURCE", "gather")
        monkeypatch.setattr(rasterize_tiled, "GRAD_REDUCE", "cuda")
        gathered, _, gm = port_gauss_step(data, shard)
        monkeypatch.setattr(rasterize_tiled, "GRAD_REDUCE", "scatter")
        monkeypatch.setattr(rasterize_tiled, "PAIR_SOURCE", "carry")
        carried, _, cm = port_gauss_step(data, shard)
        assert float(cm["loss"]) == float(gm["loss"])
        for s in range(shard):
            for k, v in gathered[0][s].params().items():
                assert torch.equal(carried[0][s].params()[k], v), (data, shard, s, k)
            for k, v in gathered[1][s].nu.items():
                assert torch.equal(carried[1][s].nu[k], v), (data, shard, s, k)
            for got, want in zip(carried[2][s], gathered[2][s]):
                assert torch.equal(got, want)


# --- the shard layout ------------------------------------------------------------------------


def test_shard_rows_match_gs_tpu_layout():
    """shard_rows and interop.sharded_from_numpy cut every [capacity, ...]
    leaf as gs_tpu's shard_specs lays it over 4 devices (bitwise equal to
    its addressable shards), Adam's steps whole; gather_rows puts the
    shards back bitwise."""
    st, _ = j_scene()
    mesh = j_submesh(1, 4)
    specs = j_gauss.shard_specs(st, st.capacity)
    j_sharded = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), st, specs)
    state, _ = port_scene()
    ts = fresh(state)
    shards = shards_of(ts, 4)
    carried = interop.sharded_from_numpy(
        {k: np.asarray(getattr(st, k)) for k in STATE_FIELDS},
        ({k: v.numpy() for k, v in ts.adam.mu.items()},
         {k: v.numpy() for k, v in ts.adam.nu.items()}, ts.adam.step),
        [v.numpy() for v in ts.stats], 4, "cpu")
    for k in STATE_FIELDS:
        parts = sorted(getattr(j_sharded, k).addressable_shards, key=lambda p: p.index[0].start)
        for s, part in enumerate(parts):
            np.testing.assert_array_equal(getattr(shards[s][0], k).numpy(),
                                          np.asarray(part.data), err_msg=f"{k} shard {s}")
            assert torch.equal(getattr(carried[s][0], k), getattr(shards[s][0], k))
    assert all(shards[s][1].step == ts.adam.step for s in shards)
    back = gauss_sharded.gather_rows(mesh_mod.in_process_mesh(1, 4, device="cpu"), shards)
    for k in STATE_FIELDS:
        assert torch.equal(getattr(back[0], k), getattr(ts.state, k)), k
    for got, want in zip(back[2], ts.stats):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="not divisible by shard=3"):
        gauss_sharded.shard_rows(ts.state, 3, 0)


def test_mesh_sum_scatter_and_counts():
    """The in-process mesh's sum-then-slice over shard (gs_tpu's
    psum_scatter) and its host all-gather of one int a rank, on 2 x 3."""
    mesh = mesh_mod.in_process_mesh(2, 3, device="cpu")
    xs = {r: torch.arange(6.0) * (10 * r[0] + r[1] + 1) for r in mesh.ranks}
    got = mesh.sum_scatter_shard(xs)
    for d, s in mesh.ranks:
        row = sum(xs[(d, j)] for j in range(3))
        assert torch.equal(got[(d, s)], row[2 * s:2 * s + 2])
    counts = mesh.gather_counts({r: 10 * r[0] + r[1] for r in mesh.ranks})
    assert counts[(1, 2)] == [10, 11, 12] and counts[(0, 0)] == [0, 1, 2]


# --- on the card -----------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_gauss_step_matches_tile_step(cuda_device):
    """On the card, the (1, 2) gauss step (B1 / B2 once a strip) within
    test_sharding.py's tolerances of the tile layout's step."""
    state = interop.state_from_numpy({k: getattr(port_scene()[0], k).numpy()
                                      for k in STATE_FIELDS}, cuda_device)
    _, cam = port_scene()
    cam = interop.camera_from_numpy(
        {k: getattr(cam, k).numpy() if torch.is_tensor(getattr(cam, k)) else getattr(cam, k)
         for k in ("view", "full_proj", "cam_pos", "tan_fovx", "tan_fovy", "width", "height",
                   "image")}, cuda_device)
    mesh = mesh_mod.in_process_mesh(1, 2, device=cuda_device)
    ts = fresh(state)
    bg = torch.zeros(3, device=cuda_device)
    tile = sharded.make_sharded_train_step(mesh, OPT, RCFG, H, W, 64, 1)(
        ts.state, ts.adam, ts.stats, [cam], bg, 0, 1.0, True)
    shards = shards_of(ts, 2)
    out = gauss_sharded.make_gauss_sharded_train_step(mesh, OPT, RCFG, H, W, 64, 1)(
        *({s: v[i] for s, v in shards.items()} for i in range(3)), [cam], bg, 0, 1.0, True)
    whole = gauss_sharded.gather_rows(mesh, {s: (out[0][s], out[1][s], out[2][s])
                                             for s in range(2)})
    np.testing.assert_allclose(float(out[3]["loss"]), float(tile[3]["loss"]), rtol=1e-5)
    np.testing.assert_allclose(whole[0].xyz.cpu().numpy(), tile[0].xyz.cpu().numpy(),
                               rtol=1e-4, atol=1e-6)
