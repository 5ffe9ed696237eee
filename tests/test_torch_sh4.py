"""gs_tpu_torch at SH degree 4 against gs_tpu's on the CPU.

gs_tpu evaluates, renders and trains spherical harmonics up to degree 4
(``gs_tpu/ops/sh.py``), and so does the port. The same numpy inputs go
through both packages:

- the degree-4 basis and ``eval_sh`` against gs_tpu's at rtol 1e-5 /
  atol 1e-6, and twins of gs_tpu's ``TestDegree4SH``
  (tests/test_pipeline_flags.py:127-158, its sample sizes and bounds);
  degree 5 raises in both;
- ``render`` at active degree 4, both colour routes, against gs_tpu's
  ``render(backend="xla")`` at atol 1e-4 (tests/test_torch_render.py's
  bound), and its gradients against ``jax.grad`` per group at rtol 1e-3,
  atol 1e-4 x max|want| (tests/test_torch_train.py's);
- one ``train_step`` at active degree 4 against gs_tpu's at
  test_torch_train.py's ``test_train_step_matches`` tolerances, and
  ``TrainState`` reaching degree 4 at iteration 4000;
- densify's split and clone of the 24-row ``features_rest`` against
  gs_tpu's on gs_tpu's split draw (rtol / atol 1e-6);
- a degree-4 PLY and ``.npz`` checkpoint written by either package and
  read by the other, bitwise; the render CLI on a degree-4 PLY;
- a Gaussian-sharded step on the in-process (1, 2) mesh at degree 4
  against the port's one-device step (tests/test_torch_gauss_sharded.py's
  tolerances), and a rebalance round of degree-4 shards (24 rest rows and
  their moments moving with each row) bitwise equal to gs_tpu's.
"""

import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_tpu import cameras as j_cameras
from gs_tpu import training as j_training
from gs_tpu.config import OptimizationParams as JOptimizationParams
from gs_tpu.config import PipelineParams as JPipelineParams
from gs_tpu.config import RasterizeConfig as JRasterizeConfig
from gs_tpu.data import ply as j_ply
from gs_tpu.models import densify as j_densify
from gs_tpu.models import gaussians as j_gaussians
from gs_tpu.models import optim as j_optim
from gs_tpu.parallel import densify_sharded as j_dsh
from gs_tpu.ops import sh as j_sh
from gs_tpu.renderer import render as j_render
from gs_tpu_torch import interop, training
from gs_tpu_torch.cli import render as render_cli
from gs_tpu_torch.cli import train as train_cli
from gs_tpu_torch.config import ModelParams, OptimizationParams, RasterizeConfig
from gs_tpu_torch.data import ply
from gs_tpu_torch.models import densify, gaussians
from gs_tpu_torch.ops import sh
from gs_tpu_torch.parallel import densify_sharded, gauss_sharded
from gs_tpu_torch.parallel import mesh as mesh_mod
from gs_tpu_torch.renderer import render
from gs_tpu_torch.scene import Scene
from tests.test_torch_cli import colmap_scene  # noqa: F401
from tests.test_torch_data import check_checkpoints_cross_load, check_gaussian_ply_roundtrip
from tests.test_torch_densify_sharded import assert_same_slots, port_shards, split, whole
from tests.test_torch_gauss_sharded import assert_close_to, shards_of
from tests.test_torch_render import BG, _compare
from tests.test_torch_sharding import j_submesh
from tests.test_torch_train import (GROUPS, TRAIN_OPT, _close_group, _densify_inputs,
                                    _split_draw, assert_train_step_close)
from tests.torch_port_inputs import (CAMERA_FIELDS, STATE_FIELDS, camera_args, camera_dict,
                                     jax_state, one_torch_thread, scene_arrays)  # noqa: F401

DEG = 4


def unit_dirs(n, seed):
    dirs = np.random.default_rng(seed).normal(size=(n, 3))
    return (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32)


# --- the basis ---------------------------------------------------------------------------


def test_deg4_basis_and_eval_sh_match_gs_tpu():
    dirs = unit_dirs(257, 3)
    coeffs = np.random.default_rng(4).normal(size=(257, 3, 25)).astype(np.float32)
    got = sh.eval_sh_basis(DEG, torch.from_numpy(dirs))
    want = j_sh.eval_sh_basis(DEG, jnp.asarray(dirs))
    assert len(got) == len(want) == 25 and sh.MAX_DEGREE == DEG
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6,
                                   err_msg=f"basis {k}")
    np.testing.assert_allclose(
        sh.eval_sh(DEG, torch.from_numpy(coeffs), torch.from_numpy(dirs)).numpy(),
        np.asarray(j_sh.eval_sh(DEG, jnp.asarray(coeffs), jnp.asarray(dirs))),
        rtol=1e-5, atol=1e-6)
    assert sh.C4 == j_sh.C4


def test_eval_sh_deg4_matches_basis():
    """TestDegree4SH.test_eval_sh_deg4_matches_basis."""
    rng = np.random.default_rng(0)
    dirs = rng.normal(size=(32, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    coeffs = rng.normal(size=(32, 3, 25)).astype(np.float32)
    out = sh.eval_sh(DEG, torch.from_numpy(coeffs), torch.from_numpy(dirs))
    basis = sh.eval_sh_basis(DEG, torch.from_numpy(dirs))
    assert len(basis) == 25
    ref = sum(b.numpy() * coeffs[:, :, k] for k, b in enumerate(basis))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_deg4_band_integrates_to_zero_mean():
    """TestDegree4SH: the real SH bands above 0 integrate to 0 over the sphere."""
    basis = sh.eval_sh_basis(DEG, torch.from_numpy(unit_dirs(200_000, 1)))
    for k in range(16, 25):
        assert abs(float(basis[k].mean())) < 5e-3, k


def test_deg4_orthonormality():
    """TestDegree4SH: 4 pi E[b_i b_j] over the uniform sphere is delta_ij."""
    basis = sh.eval_sh_basis(DEG, torch.from_numpy(unit_dirs(400_000, 2)))
    b = torch.cat(basis[16:25], dim=1).double()  # [M, 9]
    gram = (4 * np.pi * (b.T @ b) / b.shape[0]).numpy()
    np.testing.assert_allclose(gram, np.eye(9), atol=0.05)


def test_degree_5_raises(deg4_scene):
    dirs = unit_dirs(4, 5)
    coeffs = np.zeros((4, 3, 36), np.float32)
    with pytest.raises(ValueError, match="sh degree must be in"):
        sh.eval_sh_basis(5, torch.from_numpy(dirs))
    with pytest.raises(ValueError, match="sh degree must be in"):
        sh.eval_sh(5, torch.from_numpy(coeffs), torch.from_numpy(dirs))
    with pytest.raises(ValueError, match="sh degree must be in"):
        j_sh.eval_sh(5, jnp.asarray(coeffs), jnp.asarray(dirs))
    with pytest.raises(ValueError, match="sh degree must be in"):
        render(deg4_scene["cam"], deg4_scene["state"], active_sh_degree=5,
               bg_color=torch.zeros(3))


# --- render, gradients, train_step -------------------------------------------------------


@pytest.fixture(scope="module")
def deg4_scene():
    """tests/test_torch_render.py's scene at degree 4 (2,048 Gaussians, 61x47)."""
    arr = scene_arrays(n=2048, sh_degree=DEG, seed=4)
    jcam = j_cameras.make_camera(**camera_args(61, 47))
    return dict(arr=arr, jstate=jax_state(arr), jcam=jcam,
                state=interop.state_from_numpy(arr, "cpu"),
                cam=interop.camera_from_numpy(camera_dict(jcam), "cpu"))


@pytest.mark.parametrize("shs_python", [False, True])
def test_render_deg4_matches_gs_tpu(deg4_scene, shs_python):
    assert deg4_scene["state"].max_sh_degree == DEG
    got = _compare(deg4_scene, active_sh_degree=DEG, convert_shs_python=shs_python,
                   compute_cov3d_python=False)
    # the fourth band shows: the degree-3 image differs
    deg3 = render(deg4_scene["cam"], deg4_scene["state"], active_sh_degree=3,
                  bg_color=torch.from_numpy(BG))
    assert float((got.image - deg3.image).abs().max()) > 1e-3


def test_render_gradients_deg4_match_jax(deg4_scene):
    """tests/test_torch_train.py::test_render_gradients_match_jax at degree 4."""
    sc = deg4_scene
    cap = sc["arr"]["xyz"].shape[0]
    rng = np.random.default_rng(6)
    g_img = rng.normal(size=(3, 47, 61)).astype(np.float32)
    g_t = rng.normal(size=(47, 61)).astype(np.float32)
    bg = np.array([0.3, 0.2, 0.1], np.float32)

    def j_loss(params, offset):
        out = j_render(sc["jcam"], sc["jstate"].with_params(params), active_sh_degree=DEG,
                       bg_color=jnp.asarray(bg), means2d_offset=offset,
                       cfg=JRasterizeConfig(backend="xla"))
        return jnp.sum(out.image * g_img) + jnp.sum(out.final_t * g_t)

    want_p, want_o = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(
        sc["jstate"].params(), jnp.zeros((cap, 2), jnp.float32))
    params = {k: v.clone().requires_grad_() for k, v in sc["state"].params().items()}
    offset = torch.zeros((cap, 2), requires_grad=True)
    out = render(sc["cam"], sc["state"].with_params(params), active_sh_degree=DEG, bg_color=bg,
                 means2d_offset=offset)
    loss = (out.image * torch.from_numpy(g_img)).sum() + (out.final_t * torch.from_numpy(g_t)).sum()
    got = dict(zip([*params, "means2d_offset"],
                   torch.autograd.grad(loss, [*params.values(), offset])))
    for name, got_g in got.items():
        want_g = want_o if name == "means2d_offset" else want_p[name]
        assert float(jnp.abs(want_g).max()) > 0, name
        _close_group(got_g.numpy(), want_g, 1e-3, 1e-4, name)
    # the fourth band's 9 coefficients get gradients
    assert float(got["f_rest"][:, 15:].abs().max()) > 0


def test_train_step_deg4_matches(deg4_scene):
    """One train_step at active degree 4 from a fresh TrainState of a
    degree-4 model, against gs_tpu's; the camera's image is a render of a
    perturbed copy of the scene."""
    sc = deg4_scene
    target = dict(sc["arr"], xyz=sc["arr"]["xyz"] + np.random.default_rng(22).normal(
        0, 0.05, sc["arr"]["xyz"].shape).astype(np.float32))
    img = np.array(j_training.eval_render(jax_state(target), sc["jcam"], jnp.zeros(3),
                                            active_sh_degree=DEG,
                                            raster_cfg=JRasterizeConfig(backend="xla")))
    jcam = sc["jcam"].replace(image=jnp.asarray(img))
    cam = dataclasses.replace(sc["cam"], image=torch.from_numpy(img))
    cap = sc["arr"]["xyz"].shape[0]
    j_out = j_training.train_step(
        sc["jstate"], j_optim.init(sc["jstate"].params()), j_densify.DensifyStats.zeros(cap),
        jcam, jnp.zeros(3), jnp.int32(4000), jnp.float32(1.5), active_sh_degree=DEG,
        opt_cfg=JOptimizationParams(**TRAIN_OPT), raster_cfg=JRasterizeConfig(backend="xla"),
        accumulate_stats=True, pipe=JPipelineParams(), apply_update=True)
    ts = training.init_train_state(sc["state"], 1.5, DEG)
    ts.iteration = 4000
    assert ts.active_sh_degree == DEG
    out = training.train_step(ts.state, ts.adam, ts.stats, cam, torch.zeros(3), 4000, 1.5,
                              active_sh_degree=ts.active_sh_degree,
                              opt_cfg=OptimizationParams(**TRAIN_OPT),
                              raster_cfg=RasterizeConfig(), accumulate_stats=True)
    assert_train_step_close(out, j_out)
    assert float(out[1].mu["f_rest"][:, 15:].abs().max()) > 0


def test_densify_and_prune_deg4_matches():
    """tests/test_torch_train.py::test_densify_and_prune_matches ("roomy") on
    a degree-4 state: clones and split children carry all 24 rest rows."""
    cap, n_alive = 96, 40
    arr, stats, adam = _densify_inputs(cap, n_alive, seed=11)
    rng = np.random.default_rng(14)
    arr["features_rest"] = rng.normal(0, 0.2, (cap, 24, 3)).astype(np.float32)
    for moments in adam[:2]:
        moments["f_rest"] = rng.normal(size=(cap, 24, 3)).astype(np.float32)
    adam[1]["f_rest"] = np.abs(adam[1]["f_rest"])
    kw = dict(max_grad=2e-4, min_opacity=0.005, extent=2.0, percent_dense=0.05,
              use_size_prune=False)
    key, noise = _split_draw(cap, 12)
    jadam = j_optim.AdamState(*({k: jnp.asarray(v) for k, v in t.items()} for t in adam))
    jnew, jadam2, _, jrep = j_densify.densify_and_prune(
        jax_state(arr), jadam, j_densify.DensifyStats(*map(jnp.asarray, stats)), key,
        **{**kw, "extent": jnp.float32(2.0)})
    new, adam2, _, rep = densify.densify_and_prune(
        interop.state_from_numpy(arr, "cpu"), interop.adam_from_numpy(*adam, "cpu"),
        interop.stats_from_numpy(*stats, "cpu"), torch.from_numpy(noise), **kw)
    for field in rep._fields:
        assert int(getattr(rep, field)) == int(getattr(jrep, field)), field
    assert int(rep.n_cloned) > 0 and int(rep.n_split) > 0
    assert new.max_sh_degree == DEG
    np.testing.assert_array_equal(new.alive.numpy(), np.asarray(jnew.alive))
    for k, v in new.params().items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jnew.params()[k]), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    for k in GROUPS:
        np.testing.assert_allclose(adam2.mu[k].numpy(), np.asarray(jadam2.mu[k]), rtol=1e-6)
        np.testing.assert_allclose(adam2.nu[k].numpy(), np.asarray(jadam2.nu[k]), rtol=1e-6)


# --- files -------------------------------------------------------------------------------


def test_deg4_ply_cross_package(tmp_path, deg4_scene):
    """72 f_rest fields written by either package, read by the other;
    the port's loaded state is of degree 4 and renders the same bits."""
    check_gaussian_ply_roundtrip(tmp_path, DEG)
    state = deg4_scene["state"]
    path = str(tmp_path / "state.ply")
    ply.save_state_ply(path, state)
    names = ply.read_ply(path).dtype.names
    assert sum(n.startswith("f_rest_") for n in names) == 72
    assert j_ply.load_gaussian_ply(path)["max_sh_degree"] == DEG
    back = ply.load_gaussian_ply(path, capacity=state.capacity, device="cpu")
    assert back.max_sh_degree == DEG
    alive = state.alive
    for name in ("xyz", "features_dc", "features_rest", "log_scale", "quat", "logit_opacity"):
        assert torch.equal(getattr(back, name)[: int(alive.sum())], getattr(state, name)[alive])
    kw = dict(active_sh_degree=DEG, bg_color=torch.zeros(3))
    a = render(deg4_scene["cam"], state, **kw).image
    b = render(deg4_scene["cam"], back, **kw).image
    assert torch.equal(a, b)


def test_deg4_checkpoints_cross_load(tmp_path):
    check_checkpoints_cross_load(tmp_path, DEG)


def test_render_cli_on_a_deg4_ply(colmap_scene, tmp_path):  # noqa: F811
    """A model trained with ``--sh_degree 4`` for one step, its PLY replaced by
    a degree-4 one with a full fourth band: the render CLI writes PNGs equal
    byte for byte to ``save_png(eval_render(...))`` at degree 4, which
    matches gs_tpu's render of the same PLY at atol 1e-4."""
    out = tmp_path / "model"
    train_cli.main(["-s", str(colmap_scene), "-m", str(out), "--eval", "--sh_degree", "4",
                    "--iterations", "1", "--save_iterations", "1", "--test_iterations", "-1",
                    "--disable_viewer", "--kernel_autotune", "off", "--quiet"], device="cpu")
    path = out / "point_cloud" / "iteration_1" / "point_cloud.ply"
    assert ply.load_gaussian_ply(str(path), device="cpu").max_sh_degree == DEG
    arr = scene_arrays(n=300, sh_degree=DEG, seed=31, dead=0)
    arr["xyz"] *= 0.5
    ply.save_gaussian_ply(str(path), *(arr[k] for k in ("xyz", "features_dc", "features_rest",
                                                         "logit_opacity", "log_scale", "quat")))
    render_cli.main(["-m", str(out), "--iteration", "1", "--quiet", "--skip_train"],
                    device="cpu")
    scene = Scene(ModelParams(source_path=str(colmap_scene), model_path=str(out), eval=True),
                  load_iteration=1, shuffle=False, device="cpu")
    state = scene.gaussians
    assert state.max_sh_degree == DEG
    jstate = jax_state({k: getattr(state, k).numpy() for k in STATE_FIELDS})
    cams = scene.get_test_cameras()
    renders = sorted(os.listdir(out / "test" / "ours_1" / "renders"))
    assert len(renders) == len(cams) == 2
    for name, cam in zip(renders, cams):
        img = training.eval_render(state, cam, torch.zeros(3), active_sh_degree=DEG,
                                   raster_cfg=RasterizeConfig())
        render_cli.save_png(str(tmp_path / "again.png"), img)
        assert (out / "test" / "ours_1" / "renders" / name).read_bytes() == \
            (tmp_path / "again.png").read_bytes(), name
        jcam = j_cameras.Camera(**{k: jnp.asarray(getattr(cam, k).numpy())
                                   for k in CAMERA_FIELDS}, width=cam.width, height=cam.height)
        want = j_training.eval_render(jstate, jcam, jnp.zeros(3), active_sh_degree=DEG,
                                      raster_cfg=JRasterizeConfig(backend="xla"))
        assert float(img.max()) > 0
        np.testing.assert_allclose(img.numpy(), np.asarray(want), atol=1e-4, rtol=0)


# --- the Gaussian-sharded layout ---------------------------------------------------------


def test_gauss_step_deg4_matches_one_device():
    """One gauss step on the in-process (1, 2) mesh at active degree 4
    against the port's one-device train_step: 48 Gaussians of capacity 64
    with a random fourth band, 32x32."""
    rng = np.random.default_rng(40)
    pts = rng.uniform(-1, 1, (48, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (48, 3)).astype(np.float32)
    state = gaussians.create_from_pcd(pts, cols, max_sh_degree=DEG, capacity=64, device="cpu")
    state.features_rest[:48] = torch.from_numpy(
        rng.normal(0, 0.2, (48, 24, 3)).astype(np.float32))
    cam = interop.camera_from_numpy(
        dict(camera_dict(j_cameras.make_camera(np.eye(3), np.array([0.0, 0, 4.0]),
                                               fovx=math.radians(60), fovy=math.radians(60),
                                               width=32, height=32)),
             image=rng.uniform(0, 1, (3, 32, 32)).astype(np.float32)), "cpu")
    opt, rcfg = OptimizationParams(), RasterizeConfig(chunk=32, tile_w=16, tile_h=16)
    ts = training.init_train_state(state, 1.0, DEG)
    mesh = mesh_mod.in_process_mesh(1, 2, device="cpu")
    step = gauss_sharded.make_gauss_sharded_train_step(mesh, opt, rcfg, 32, 32, 64, DEG)
    shards = shards_of(ts, 2)
    states, adams, stats, m = step({s: v[0] for s, v in shards.items()},
                                   {s: v[1] for s, v in shards.items()},
                                   {s: v[2] for s, v in shards.items()}, [cam], torch.zeros(3),
                                   0, 1.0, True)
    whole = gauss_sharded.gather_rows(mesh, {s: (states[s], adams[s], stats[s]) for s in states})
    assert whole[0].max_sh_degree == DEG and states[0].features_rest.shape == (32, 24, 3)
    ref = training.train_step(ts.state, ts.adam, ts.stats, cam, torch.zeros(3), 0, 1.0,
                              active_sh_degree=DEG, opt_cfg=opt, raster_cfg=rcfg,
                              accumulate_stats=True)
    assert_close_to(whole, m, dict(
        loss=float(ref[3]["loss"]), xyz=ref[0].xyz.numpy(),
        logit_opacity=ref[0].logit_opacity.numpy(), nu_opacity=ref[1].nu["opacity"].numpy(),
        accum=ref[2].xyz_grad_accum.numpy(), denom=ref[2].denom.numpy()))
    np.testing.assert_allclose(whole[1].nu["f_rest"].numpy(), ref[1].nu["f_rest"].numpy(),
                               rtol=1e-3, atol=1e-10)
    assert float(ref[1].nu["f_rest"][:, 15:].abs().max()) > 0


def test_rebalance_deg4_matches_gs_tpu():
    """test_torch_densify_sharded.py's "skew" case (capacity 64 over 8
    shards, shards 0-1 full) at degree 4 with a random rest band: each of
    gs_tpu's 4 rounds (migration budget 4), slot by slot and bitwise."""
    rng = np.random.default_rng(41)
    alive = np.zeros(64, bool)
    alive[:16] = True
    st = j_gaussians.empty_state(64, DEG).replace(
        xyz=jnp.asarray(rng.normal(size=(64, 3)).astype(np.float32)),
        features_rest=jnp.asarray(rng.normal(size=(64, 24, 3)).astype(np.float32)),
        alive=jnp.asarray(alive))
    adam = j_optim.init(st.params())
    adam = adam._replace(mu={**adam.mu, "f_rest": st.features_rest * 0.5})
    stats = j_densify.DensifyStats(*(jnp.asarray(rng.uniform(size=64).astype(np.float32))
                                     for _ in range(3)))
    states, adams, port_stats = split(port_shards(st, adam, stats, 8))
    mesh = mesh_mod.in_process_mesh(1, 8, device="cpu")
    reb = densify_sharded.make_sharded_rebalance(mesh, migration_budget=4)
    j_reb = j_dsh.make_sharded_rebalance(j_submesh(1, 8), 64, DEG, migration_budget=4)
    for _ in range(4):
        st, adam, stats, j_moved = j_reb(st, adam, stats)
        states, adams, port_stats, moved = reb(states, adams, port_stats)
        assert moved == int(j_moved)
        assert_same_slots(whole(8, states, adams, port_stats), st, adam, stats)
    assert states[0].features_rest.shape == (8, 24, 3)
    assert max(densify_sharded.shard_occupancy(mesh, states)) == 2
