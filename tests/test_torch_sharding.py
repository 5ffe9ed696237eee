"""gs_tpu_torch's tile-sharded layout against gs_tpu's on the CPU.

gs_tpu runs on the 8-virtual-device CPU mesh of ``tests/conftest.py``
(``backend="xla"``); the port runs every rank of a mesh in this process
(``mesh.in_process_mesh``) through the plain kernel versions. On the same
numpy inputs:

- column-strip binning (``col_stride`` / ``col_offset``) for S in {2, 3, 4}
  and every shard, on both step-2 paths and with ``carry_attr``: integer
  outputs equal to gs_tpu's, carried attributes bitwise;
- ``local_to_global_tiles``, ``local_pair_budget`` and ``reassemble_strips``
  equal to gs_tpu's (its gather under ``shard_map``);
- ``banded_photometric_terms`` against gs_tpu's, and band covers summing to
  ``photometric_loss``, H divisible by S or not (rtol 1e-6);
- the sharded render (``tests/test_sharding.py:38-47``: 32x32, 48
  Gaussians) against gs_tpu's ``make_sharded_render`` and the port's
  ``render``, rtol 1e-4 / atol 1e-5 (and bitwise equal to ``render``);
- the sharded train step (``TestShardedTrainStep``,
  ``test_data_parallel_two_cameras``, ``TestFinalIterationSkip``) against
  gs_tpu's step on a mesh of the same shape, at test_sharding.py's
  tolerances (loss rtol 1e-5, xyz rtol 1e-4 / atol 1e-6, stats rtol 1e-3,
  Adam nu rtol 1e-3);
- ``ParallelConfig``, camera ownership and the batch sampler's draws
  (``test_sampler_feeds_slots_from_owner_pools``) equal to gs_tpu's.

gs_tpu's sharded results are computed once per module.
"""

import functools
import math
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from gs_tpu import cameras as j_cameras
from gs_tpu import config as j_config
from gs_tpu.data import multihost as j_multihost
from gs_tpu.models import densify as j_densify
from gs_tpu.models import gaussians as j_gaussians
from gs_tpu.models import optim as j_optim
from gs_tpu.ops import binning as j_binning
from gs_tpu.parallel import mesh as j_mesh
from gs_tpu.parallel import sharded as j_sharded
from gs_tpu.utils import losses as j_losses
from gs_tpu_torch import config, interop, training
from gs_tpu_torch.data import multihost
from gs_tpu_torch.ops import binning
from gs_tpu_torch.parallel import mesh as mesh_mod
from gs_tpu_torch.parallel import sharded
from gs_tpu_torch.renderer import render
from gs_tpu_torch.utils import losses
from tests.test_torch_binning import screen_inputs
from tests.torch_port_inputs import STATE_FIELDS, camera_dict, one_torch_thread  # noqa: F401

H = W = 32
J_RCFG = j_config.RasterizeConfig(backend="xla", chunk=32, tile_w=16, tile_h=16)
RCFG = config.RasterizeConfig(chunk=32, tile_w=16, tile_h=16)
BIN_FIELDS = ("pair_gauss", "valid", "starts", "ends", "depth_order", "gauss_counts")


# --- inputs ----------------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def j_scene(n=48, cap=64, seed=0):
    """tests/test_sharding.py's ``_scene``: gs_tpu's state and camera."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    st = j_gaussians.create_from_pcd(pts, cols, max_sh_degree=1, capacity=cap)
    cam = j_cameras.make_camera(np.eye(3), np.array([0.0, 0, 4.0]), fovx=math.radians(60),
                                fovy=math.radians(60), width=W, height=H,
                                image=rng.uniform(0, 1, (3, H, W)).astype(np.float32))
    return st, cam


def port_scene(seed=0):
    """The same state and camera in the port, carried across as numpy."""
    st, cam = j_scene(seed=seed)
    state = interop.state_from_numpy({k: np.asarray(getattr(st, k)) for k in STATE_FIELDS},
                                     "cpu")
    return state, interop.camera_from_numpy(dict(camera_dict(cam), image=np.asarray(cam.image)),
                                            "cpu")


def j_submesh(data, shard):
    return j_mesh.make_mesh(data=data, shard=shard, devices=jax.devices()[:data * shard])


def fresh(state):
    return training.init_train_state(state, 1.0, 1)


# --- column-strip binning --------------------------------------------------------------------

# 300 splats at 128x96 with 16x16 tiles: 8 tile columns, align 8 (tests/test_torch_carry.py)
N_BIN, W_BIN, H_BIN, TX, TY, ALIGN, BUDGET = 300, 128, 96, 8, 6, 8, 8192


@functools.partial(jax.jit, static_argnums=(3, 4, 5))
def j_strip_bin(m, d, r, col_stride, expand_impl, carry, col_offset, attr):
    return j_binning.bin_gaussians_aligned(
        m, d, r, TX, TY, 16, 16, BUDGET, ALIGN, col_stride=col_stride, col_offset=col_offset,
        count_by_gauss=True, expand_impl=expand_impl, carry_attr=attr if carry else None)


@pytest.mark.parametrize("path", ["scatter", "cuda", "carry"])
@pytest.mark.parametrize("n_shard", [2, 3, 4])
def test_strip_binning_matches_gs_tpu(n_shard, path):
    """Every shard's strip: integer fields equal to gs_tpu's (its "pallas"
    expansion is the port's "cuda"; carry rides it), carried attributes
    bitwise; the strips together hold every pair of the unsharded binning."""
    m, d, r = screen_inputs(N_BIN, W_BIN, H_BIN, seed=5)
    attr = np.random.default_rng(6).normal(size=(N_BIN, 9)).astype(np.float32)
    impl = "scatter" if path == "scatter" else "cuda"
    total = 0
    for me in range(n_shard):
        want = j_strip_bin(jnp.asarray(m), jnp.asarray(d), jnp.asarray(r), n_shard,
                           "scatter" if path == "scatter" else "pallas", path == "carry",
                           jnp.int32(me), jnp.asarray(attr))
        got = binning.bin_gaussians_aligned(
            torch.from_numpy(m), torch.from_numpy(d), torch.from_numpy(r), TX, TY, 16, 16,
            BUDGET, ALIGN, count_by_gauss=True, expand_impl=None if path == "carry" else impl,
            carry_attr=torch.from_numpy(attr) if path == "carry" else None,
            col_stride=n_shard, col_offset=me)
        for field in BIN_FIELDS:
            np.testing.assert_array_equal(getattr(got, field).numpy(),
                                          np.asarray(getattr(want, field)),
                                          err_msg=f"{field} shard {me}")
        assert int(got.num_pairs) == int(want.num_pairs)
        assert got.starts.shape[0] == TY * binning.strip_columns(TX, n_shard)
        if path == "carry":
            np.testing.assert_array_equal(got.pair_attr.numpy().view(np.uint32),
                                          np.asarray(want.pair_attr_t).T.view(np.uint32))
        total += int(got.num_pairs)
    full = binning.bin_gaussians_aligned(torch.from_numpy(m), torch.from_numpy(d),
                                         torch.from_numpy(r), TX, TY, 16, 16, BUDGET, ALIGN)
    assert total == int(full.num_pairs)


# --- the strip layout ------------------------------------------------------------------------


@pytest.mark.parametrize("n_shard", [2, 3, 4])
def test_strip_layout_matches_gs_tpu(n_shard):
    """local_to_global_tiles and local_pair_budget equal gs_tpu's, and
    reassemble_strips equals gs_tpu's (its all_gather under shard_map) on
    the same strips, 61x47 pixels at 16x16 tiles (4 columns, a partial
    last tile)."""
    h, w = 47, 61
    st = sharded.strip_static(RCFG, h, w)
    j_st = j_sharded.CompositeStatic(tiles_x=st.tiles_x, tiles_y=st.tiles_y, tile_w=16,
                                     tile_h=16, chunk=32, tile_batch=256, backend="xla")
    for me in range(n_shard):
        ids, valid = sharded.local_to_global_tiles(st, n_shard, me)
        j_ids, j_valid = j_sharded.local_to_global_tiles(j_st, n_shard, jnp.int32(me))
        np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(j_valid))
    for budget in (64, 1000, 4096, 100_000):
        for chunk in (8, 32, 64):
            assert sharded.local_pair_budget(budget, n_shard, chunk) == \
                j_sharded.local_pair_budget(budget, n_shard, chunk)
    t_local = st.tiles_y * binning.strip_columns(st.tiles_x, n_shard)
    strips = np.random.default_rng(n_shard).normal(
        size=(n_shard, t_local, 256, 3)).astype(np.float32)
    mesh = j_submesh(1, n_shard)
    j_img = jax.shard_map(lambda x: j_sharded.reassemble_strips(j_st, n_shard, x[0], h, w),
                          mesh=mesh, in_specs=P(j_mesh.SHARD_AXIS), out_specs=P(),
                          check_vma=False)(jnp.asarray(strips))
    img = sharded.reassemble_strips(st, n_shard, torch.from_numpy(strips), h, w)
    assert img.shape == (3, h, w)
    np.testing.assert_array_equal(img.numpy(), np.asarray(j_img))


# --- the banded loss -------------------------------------------------------------------------


@pytest.mark.parametrize("h,n_shard", [(32, 2), (47, 3), (47, 4)])
def test_banded_terms_match_gs_tpu_and_cover_the_loss(h, n_shard):
    """Each band's (L1 sum, SSIM sum) equals gs_tpu's; the bands of a cover
    sum to photometric_loss (rtol 1e-6), also with H not divisible by S.
    The sums are float32 reductions taken in different orders, so the image
    is a render near its target, as in training (SSIM near 1 everywhere):
    on unrelated noise images the SSIM map's signs cancel and the two
    orders part at ~1e-6 of the sum."""
    rng = np.random.default_rng(h + n_shard)
    gt = rng.uniform(0, 1, (3, h, 29)).astype(np.float32)
    pred = np.clip(gt + rng.normal(0, 0.1, gt.shape), 0, 1).astype(np.float32)
    band_rows = -(-h // n_shard)
    lam = 0.2
    l1_tot = ssim_tot = 0.0
    for me in range(n_shard):
        l1, ss = losses.banded_photometric_terms(torch.from_numpy(pred), torch.from_numpy(gt),
                                                 me * band_rows, band_rows)
        j_l1, j_ss = j_losses.banded_photometric_terms(jnp.asarray(pred), jnp.asarray(gt),
                                                       me * band_rows, band_rows)
        np.testing.assert_allclose(float(l1), float(j_l1), rtol=1e-6)
        np.testing.assert_allclose(float(ss), float(j_ss), rtol=1e-6)
        l1_tot += float(l1)
        ssim_tot += float(ss)
    denom = 3.0 * h * 29
    full = losses.photometric_loss(torch.from_numpy(pred), torch.from_numpy(gt), lam)
    np.testing.assert_allclose((1 - lam) * l1_tot / denom + lam * (1 - ssim_tot / denom),
                               float(full), rtol=1e-6)


# --- the sharded render ----------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def j_render_1x8():
    st, cam = j_scene()
    render_fn = j_sharded.make_sharded_render(j_mesh.make_mesh(data=1), J_RCFG, H, W,
                                              st.capacity, 1)
    return np.asarray(render_fn(st, cam, jnp.array([0.3, 0.2, 0.1])))


@pytest.mark.parametrize("n_shard", [2, 4, 8])
def test_sharded_render_matches(n_shard):
    """tests/test_sharding.py::TestShardedRender: the strips reassembled
    equal gs_tpu's 1x8 sharded render (rtol 1e-4, atol 1e-5) and the port's
    unsharded render bitwise."""
    state, cam = port_scene()
    bg = torch.tensor([0.3, 0.2, 0.1])
    mesh = mesh_mod.in_process_mesh(1, n_shard, device="cpu")
    img = sharded.make_sharded_render(mesh, RCFG, H, W, state.capacity, 1)(state, cam, bg)
    single = render(cam, state, active_sh_degree=1, bg_color=bg, cfg=RCFG).image
    np.testing.assert_allclose(img.numpy(), j_render_1x8(), rtol=1e-4, atol=1e-5)
    assert torch.equal(img, single)


# --- the sharded train step ------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def j_step(data, shard, seeds, apply_update=True):
    """gs_tpu's sharded step on a data x shard mesh from fresh Adam and stats;
    the camera of data row d is ``j_scene(seed=seeds[d])``'s."""
    st, _ = j_scene()
    cams = [j_scene(seed=s)[1] for s in seeds]
    step = j_sharded.make_sharded_train_step(j_submesh(data, shard), j_config.OptimizationParams(),
                                             J_RCFG, H, W, st.capacity, 1)
    s, a, d, m = step(st, j_optim.init(st.params()), j_densify.DensifyStats.zeros(st.capacity),
                      j_cameras.stack_cameras(cams), jnp.zeros(3), jnp.int32(0),
                      jnp.float32(1.0), jnp.bool_(apply_update))
    return (np.asarray(s.xyz), np.asarray(a.nu["opacity"]), np.asarray(a.mu["xyz"]),
            np.asarray(d.xyz_grad_accum), np.asarray(d.denom), float(m["loss"]),
            int(m["num_pairs_max"]))


def port_step(data, shard, seeds, apply_update=True):
    state, _ = port_scene()
    cams = [port_scene(seed=s)[1] for s in seeds]
    ts = fresh(state)
    step = sharded.make_sharded_train_step(mesh_mod.in_process_mesh(data, shard, device="cpu"),
                                           config.OptimizationParams(), RCFG, H, W,
                                           state.capacity, 1)
    return ts, step(ts.state, ts.adam, ts.stats, cams, torch.zeros(3), 0, 1.0, apply_update)


def assert_step_close(got, want):
    """tests/test_sharding.py:73-80's tolerances."""
    s, a, d, m = got
    xyz, nu_opac, _, accum, denom, loss, pairs = want
    np.testing.assert_allclose(float(m["loss"]), loss, rtol=1e-5)
    np.testing.assert_allclose(s.xyz.numpy(), xyz, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(d.xyz_grad_accum.numpy(), accum, rtol=1e-3, atol=1e-7)
    np.testing.assert_allclose(a.nu["opacity"].numpy(), nu_opac, rtol=1e-3, atol=1e-10)
    np.testing.assert_array_equal(d.denom.numpy(), denom)
    assert int(m["num_pairs_max"]) == pairs > 0


@pytest.mark.parametrize("n_shard", [2, 8])
def test_sharded_step_matches_gs_tpu_and_one_device(n_shard):
    """TestShardedTrainStep: one tile-sharded step (1 x S) against gs_tpu's
    on a 1 x S mesh and against the port's unsharded train_step."""
    ts, got = port_step(1, n_shard, (0,))
    assert_step_close(got, j_step(1, n_shard, (0,)))
    _, cam = port_scene()
    r_state, r_adam, r_stats, r_m = training.train_step(
        ts.state, ts.adam, ts.stats, cam, torch.zeros(3), 0, 1.0, active_sh_degree=1,
        opt_cfg=config.OptimizationParams(), raster_cfg=RCFG, accumulate_stats=True)
    np.testing.assert_allclose(float(got[3]["loss"]), float(r_m["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got[0].xyz.numpy(), r_state.xyz.numpy(), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got[2].xyz_grad_accum.numpy(), r_stats.xyz_grad_accum.numpy(),
                               rtol=1e-3, atol=1e-7)
    np.testing.assert_allclose(got[1].nu["opacity"].numpy(), r_adam.nu["opacity"].numpy(),
                               rtol=1e-3, atol=1e-10)


def test_data_parallel_two_cameras():
    """test_data_parallel_two_cameras: a 2 x 4 mesh, one camera a data row,
    against gs_tpu's 2 x 4 step; the stats count both cameras and the
    gradient is the mean of the two one-camera steps'."""
    _, got = port_step(2, 4, (0, 1))
    assert_step_close(got, j_step(2, 4, (0, 1)))
    s_state, _, s_stats, sm = got
    state, _ = port_scene()
    assert np.isfinite(float(sm["loss"]))
    assert float((s_state.xyz - state.xyz).abs().max()) > 0
    assert float(s_stats.denom.max()) >= 2.0
    # the batch loss is the mean of the cameras' losses
    losses_1 = [float(port_step(1, 4, (seed,))[1][3]["loss"]) for seed in (0, 1)]
    np.testing.assert_allclose(float(sm["loss"]), sum(losses_1) / 2, rtol=1e-6)


def test_final_iteration_skip():
    """TestFinalIterationSkip: apply_update=False computes the loss and the
    stats but leaves the parameters and Adam as they were."""
    state, _ = port_scene()
    ts, (s_state, s_adam, s_stats, sm) = port_step(1, 8, (0,), apply_update=False)
    xyz, _, _, accum, _, loss, _ = j_step(1, 8, (0,), apply_update=False)
    np.testing.assert_allclose(float(sm["loss"]), loss, rtol=1e-5)
    for k, v in state.params().items():
        assert torch.equal(s_state.params()[k], v), k
        assert torch.equal(s_adam.mu[k], ts.adam.mu[k]) and torch.equal(s_adam.nu[k], ts.adam.nu[k])
    assert s_adam.step == ts.adam.step
    np.testing.assert_array_equal(s_state.xyz.numpy(), xyz)
    np.testing.assert_allclose(s_stats.xyz_grad_accum.numpy(), accum, rtol=1e-3, atol=1e-7)


# --- configuration, ownership, sampling, the mesh ------------------------------------------


def test_parallel_config_matches_gs_tpu():
    import dataclasses

    got = {f.name: f.default for f in dataclasses.fields(config.ParallelConfig)}
    want = {f.name: f.default for f in dataclasses.fields(j_config.ParallelConfig)}
    assert got == want


def test_camera_ownership_matches_gs_tpu():
    for count in (1, 2, 3):
        for pid in range(count):
            assert multihost.owned_indices(11, pid, count) == \
                j_multihost.owned_indices(11, pid, count)
            assert [multihost.owns_camera(i, pid, count) for i in range(11)] == \
                [j_multihost.owns_camera(i, pid, count) for i in range(11)]


class _Cam:
    """A camera as the sampler sees it: a resolution and an image."""

    def __init__(self, width, height, image=True):
        self.width, self.height, self.image = width, height, image

    def replace(self, image):
        return _Cam(self.width, self.height, image)


@pytest.mark.parametrize("feeders,count", [([0, 1], 2), ([0, 0], 1), ([0, 0, 0], 1)])
def test_sampler_draws_match_gs_tpu(feeders, count):
    """test_sampler_feeds_slots_from_owner_pools' draws (8 cameras, two of
    them at another resolution) under random.seed(123): the port's
    BatchSampler picks the same cameras in the same slots as gs_tpu's."""
    cams = [_Cam(32, 32) for _ in range(6)] + [_Cam(16, 16) for _ in range(2)]
    by_id = {id(c): i for i, c in enumerate(cams)}

    def draws(mod):
        random.seed(123)
        sampler = mod.BatchSampler(cams, feeders=feeders, process_count=count)
        return [[by_id[id(c)] for c in sampler.next_batch()] for _ in range(12)]

    got = draws(multihost)
    assert got == draws(j_multihost)
    for batch in got:
        assert [gi % count for gi in batch] == [f % count for f in feeders]


def test_mesh_shape_errors_match_gs_tpu():
    """One process is a world of one: make_mesh raises gs_tpu's mesh-size
    errors for anything larger, and a 1 x 1 mesh runs this rank only."""
    one = jax.devices()[:1]
    for data, shard in ((1, 2), (2, 1), (2, None)):
        with pytest.raises(ValueError) as want:
            j_mesh.make_mesh(data=data, shard=shard, devices=one)
        with pytest.raises(ValueError) as got:
            mesh_mod.make_mesh(data, shard, device="cpu")
        assert str(got.value) == str(want.value)
    mesh = mesh_mod.make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "shard": 1} and mesh.ranks == ((0, 0),)
    assert not mesh.distributed


def test_in_process_collectives():
    """The in-process mesh's collectives over a 2 x 3 mesh: gathers in
    shard order, sums and maxima over the row or the column."""
    mesh = mesh_mod.in_process_mesh(2, 3, device="cpu")
    xs = {r: torch.tensor([10.0 * r[0] + r[1]]) for r in mesh.ranks}
    g = mesh.gather_shard(xs)
    assert torch.equal(g[(1, 2)], torch.tensor([[10.0], [11.0], [12.0]]))
    assert float(mesh.sum_shard(xs)[(1, 0)]) == 33.0
    assert float(mesh.sum_data(xs)[(0, 2)]) == 14.0
    assert float(mesh.max_data(xs)[(0, 1)]) == 11.0
    assert all(float(v) == 12.0 for v in mesh.max_all(xs).values())
