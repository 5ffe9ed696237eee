"""Shared inputs for the gs_tpu_torch tests: one numpy scene fed to both packages.

Everything is made from a numpy seed; gs_tpu gets jax arrays, the port gets
CPU tensors through ``gs_tpu_torch.interop`` (numpy only).
"""

import math
import os

import numpy as np
import pytest
import torch

STATE_FIELDS = ("xyz", "features_dc", "features_rest", "log_scale", "quat",
                "logit_opacity", "alive")
CAMERA_FIELDS = ("view", "full_proj", "cam_pos", "tan_fovx", "tan_fovy", "znear", "zfar")


def scene_arrays(n=2048, sh_degree=3, seed=0, dead=16):
    """A small version of bench.py's scene: uniform cloud in [-2,2]^3 with
    random anisotropic scales, rotations, opacities and SH coefficients.
    The last ``dead`` slots are padding (alive False)."""
    rng = np.random.default_rng(seed)
    k1 = (sh_degree + 1) ** 2 - 1
    alive = np.ones(n, bool)
    alive[n - dead:] = False
    return {
        "xyz": rng.uniform(-2, 2, (n, 3)).astype(np.float32),
        "features_dc": rng.normal(0, 0.6, (n, 1, 3)).astype(np.float32),
        "features_rest": rng.normal(0, 0.2, (n, k1, 3)).astype(np.float32),
        "log_scale": rng.uniform(-5.0, -2.5, (n, 3)).astype(np.float32),
        "quat": rng.normal(0, 1, (n, 4)).astype(np.float32),
        "logit_opacity": rng.uniform(-3, 3, (n, 1)).astype(np.float32),
        "alive": alive,
    }


def camera_args(width=61, height=47):
    """make_camera arguments of bench.py's camera (z=5, fov 70 x 46 deg)."""
    return dict(R=np.eye(3), T=np.array([0.0, 0.0, 5.0]), fovx=math.radians(70),
                fovy=math.radians(46), width=width, height=height)


def jax_state(arrays):
    import jax.numpy as jnp
    from gs_tpu.models.gaussians import GaussianState

    return GaussianState(**{k: jnp.asarray(arrays[k]) for k in STATE_FIELDS})


def camera_dict(jax_camera):
    """numpy fields of a gs_tpu Camera, as interop.camera_from_numpy takes them."""
    d = {k: np.asarray(getattr(jax_camera, k)) for k in CAMERA_FIELDS}
    d.update(width=jax_camera.width, height=jax_camera.height)
    return d


def tiny_synthetic_scene(res=24, views=4, seed=0, chunk=32):
    """A few orbit views (ground truth rendered on the CPU) of a 256-Gaussian
    synthetic scene and a fresh 128-point model: gs_tpu_torch's
    ``synthetic.SyntheticScene``, small enough for run_training on the CPU."""
    import dataclasses

    from gs_tpu_torch import synthetic
    from gs_tpu_torch.config import RasterizeConfig
    from gs_tpu_torch.models import gaussians
    from gs_tpu_torch.training import eval_render

    gt = synthetic.make_gt_scene(256, seed=seed, device="cpu")
    bg = torch.zeros(3)
    cams = []
    for i in range(views):
        cam = synthetic.orbit_camera(2 * np.pi * i / views, 0.3, 3.5, res, device="cpu")
        cams.append(dataclasses.replace(cam, image=eval_render(
            gt, cam, bg, active_sh_degree=0, raster_cfg=RasterizeConfig(chunk=chunk))))
    rng = np.random.default_rng(seed)
    pts = gt.xyz.numpy()[:128] + rng.normal(scale=0.03, size=(128, 3)).astype(np.float32)
    cols = rng.uniform(0.2, 0.8, size=(128, 3)).astype(np.float32)
    model = gaussians.create_from_pcd(pts, cols, max_sh_degree=0, device="cpu")
    return synthetic.SyntheticScene(model, cams, cams[:1])



@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run each test of a module that imports this fixture with one intra-op
    torch thread, then restore the count. The suite runs several workers on
    shared cores; the many small ops of the port's training loop on the CPU
    slow down many times over when every worker starts a thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)



# --- the preprocess's VJP (ops/preprocess_cuda.py) ---------------------------------------------

PREPROCESS_EDGE_KINDS = ("plain", "behind_near_plane", "clamped_x", "clamped_y", "degenerate",
                         "clamped_colour", "dead", "at_camera")
PREPROCESS_LEAVES = ("xyz", "log_scale", "quat", "f_dc", "f_rest")

# A Gaussian's gradient row of a leaf, one VJP against another on the edge
# inputs: the float32 sums run in other orders, and the quaternion's gradient
# is a projection onto the tangent plane of |q| (g - q (q . g)) / |q| that
# cancels, so a row keeps about five digits of its largest entry (up to
# 2.5e-5 against autograd on the CPU, 8.8e-5 for the kernel on an H100).
ROW_RTOL = 1e-4


def preprocess_edge_camera(device):
    """The tests' small camera (camera_args at 61x47) on ``device``."""
    from gs_tpu_torch.cameras import make_camera

    a = camera_args(61, 47)
    return make_camera(a["R"], a["T"], a["fovx"], a["fovy"], a["width"], a["height"],
                       device=device)


def preprocess_edge_inputs(n: int, rest_rows: int, seed: int, device):
    """Leaves (xyz, log_scale, quat, f_dc, f_rest) of ``n`` Gaussians with
    ``rest_rows`` rest rows, cycling through ``PREPROCESS_EDGE_KINDS``: plain
    draws; centres behind the near plane (camera z <= 0.2, culled); x/z or
    y/z past 1.3 tan(fov/2) (clamped); needles of scale e^12 by e^-12, whose
    2D covariance's det rounds to <= 0 for some (culled in front of the
    camera); a colour channel driven below -0.5 (clamped); dead padding
    slots (a fresh slot's values, zero cotangents, as a render gives them);
    a centre on the camera (culled, the view direction's norm 0). Also the
    cotangents of means2d, conics, colours and depths."""
    rng = np.random.default_rng(seed)
    kind = np.arange(n) % len(PREPROCESS_EDGE_KINDS)
    f32 = np.float32
    xyz = rng.uniform(-2, 2, (n, 3)).astype(f32)
    log_scale = rng.uniform(-5.0, -2.5, (n, 3)).astype(f32)
    quat = rng.normal(0, 1, (n, 4)).astype(f32)
    f_dc = rng.normal(0, 0.6, (n, 1, 3)).astype(f32)
    f_rest = rng.normal(0, 0.2, (n, rest_rows, 3)).astype(f32)
    lim = 1.3 * np.array([math.tan(math.radians(35)), math.tan(math.radians(23))])
    k = kind == 1
    xyz[k, 2] = -5.0 + rng.uniform(-3.0, 0.1, k.sum())
    for axis, code in ((0, 2), (1, 3)):
        k = kind == code
        depth = xyz[k, 2] + 5.0
        xyz[k, axis] = (rng.choice([-1, 1], k.sum()) * rng.uniform(1.05, 2.0, k.sum())
                        * lim[axis] * depth)
    k = kind == 4
    log_scale[k] = np.array([12.0, -12.0, -12.0], f32) + rng.uniform(-1, 1, (k.sum(), 3))
    k = kind == 5
    f_dc[k, 0, rng.integers(0, 3, k.sum())] = -3.0
    dead = kind == 6
    xyz[dead], log_scale[dead], f_dc[dead], f_rest[dead] = 0.0, -10.0, 0.0, 0.0
    quat[dead] = np.array([1.0, 0.0, 0.0, 0.0], f32)
    xyz[kind == 7] = np.array([0.0, 0.0, -5.0], f32)
    cots = [rng.normal(0, 1, (n, c)).astype(f32) for c in (2, 3, 3)] + [
        rng.normal(0, 1, n).astype(f32)]
    for c in cots:
        c[dead] = 0.0
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return [as_t(a) for a in (xyz, log_scale, quat, f_dc, f_rest)], [as_t(c) for c in cots]


def row_errors(got, want, keep=None) -> dict:
    """Per leaf of the preprocess: the worst of a Gaussian's max |got - want|
    over its row's max |want| (rows where ``keep`` is False left out), and
    the entries where exactly one side is 0."""
    out = {}
    for name, g, w in zip(PREPROCESS_LEAVES, got, want):
        if keep is not None:
            g, w = g[keep], w[keep]
        if g.numel() == 0:
            out[name] = dict(rel=0.0, zero_mismatch=0)
            continue
        n = g.shape[0]
        d = (g - w).abs().reshape(n, -1).amax(1)
        scale = w.abs().reshape(n, -1).amax(1)
        rel = torch.where(scale > 0, d / scale, torch.where(d > 0, torch.inf, 0.0))
        out[name] = dict(rel=float(rel.max()), zero_mismatch=int(((g == 0) != (w == 0)).sum()))
    return out

# --- worlds of processes ------------------------------------------------------------------------

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spawn_ranks(target: str, world: int, workdir, *args, timeout: float = 180.0) -> list:
    """Run ``target(rank, world, rendezvous, out, *args)`` (a function of this
    module, by name) in ``world`` fresh interpreters that join one gloo world
    through a ``file://`` rendezvous in ``workdir`` (its own, so concurrent
    test workers never meet); each rank ``torch.save``s its result to
    ``out``. Returns the results in rank order; a rank that fails fails the
    call with its output."""
    import subprocess
    import sys

    rdv = f"file://{os.path.join(str(workdir), 'rendezvous')}"
    outs = [os.path.join(str(workdir), f"rank{r}.pt") for r in range(world)]
    procs = []
    for r in range(world):
        code = (f"import sys; sys.path.insert(0, {ROOT!r})\n"
                f"from tests.torch_port_inputs import {target}\n"
                f"{target}({r}, {world}, {rdv!r}, {outs[r]!r}, *{args!r})\n")
        procs.append(subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{logs[r]}"
    return [torch.load(o, weights_only=False) for o in outs]


def _join(rank, world, rdv):
    from gs_tpu_torch.parallel import mesh as mesh_mod

    torch.set_num_threads(1)
    mesh_mod.init_distributed(rdv, world, rank, device="cpu")


def sharded_step_rank(rank, world, rdv, out, inputs, data, shard):
    """One tile-sharded train step on a ``data`` x ``shard`` gloo mesh from
    ``inputs`` (a torch.save of (state, cameras, OptimizationParams,
    RasterizeConfig)); saves this rank's (state, adam, stats, metrics)."""
    import torch.distributed as dist

    from gs_tpu_torch import training
    from gs_tpu_torch.parallel import mesh as mesh_mod
    from gs_tpu_torch.parallel import sharded

    _join(rank, world, rdv)
    try:
        state, cams, opt, rcfg = torch.load(inputs, weights_only=False)
        ts = training.init_train_state(state, 1.0, 1)
        mesh = mesh_mod.make_mesh(data, shard, device="cpu")
        step = sharded.make_sharded_train_step(mesh, opt, rcfg, cams[0].height, cams[0].width,
                                               state.capacity, 1)
        torch.save(step(ts.state, ts.adam, ts.stats, cams, torch.zeros(3), 0, 1.0, True), out)
    finally:
        dist.destroy_process_group()


def gauss_step_rank(rank, world, rdv, out, inputs, data, shard):
    """One Gaussian-sharded train step on a ``data`` x ``shard`` gloo mesh
    from ``inputs`` (a torch.save of (state, cameras, OptimizationParams,
    RasterizeConfig)), under GRAD_REDUCE "scatter" and "cuda"; saves
    {reduce: (this rank's shard of state, adam, stats; metrics)}."""
    import torch.distributed as dist

    from gs_tpu_torch import training
    from gs_tpu_torch.ops import rasterize_tiled
    from gs_tpu_torch.parallel import gauss_sharded
    from gs_tpu_torch.parallel import mesh as mesh_mod

    _join(rank, world, rdv)
    try:
        state, cams, opt, rcfg = torch.load(inputs, weights_only=False)
        ts = training.init_train_state(state, 1.0, 1)
        mesh = mesh_mod.make_mesh(data, shard, device="cpu")
        s = mesh.ranks[0][1]
        mine = gauss_sharded.shard_rows((ts.state, ts.adam, ts.stats), shard, s)
        step = gauss_sharded.make_gauss_sharded_train_step(
            mesh, opt, rcfg, cams[0].height, cams[0].width, state.capacity, 1)
        results = {}
        for reduce in ("scatter", "cuda"):
            rasterize_tiled.GRAD_REDUCE = reduce
            st, ad, sa, m = step(*({s: x} for x in mine), cams, torch.zeros(3), 0, 1.0, True)
            results[reduce] = (st[s], ad[s], sa[s], m)
        torch.save(results, out)
    finally:
        dist.destroy_process_group()


def parallel_training_rank(rank, world, rdv, out, inputs, data, shard, start_checkpoint=None,
                           layout="tile", noise=None, split_images=False):
    """``training.run_training`` with a ``data`` x ``shard`` ParallelConfig
    of ``layout`` on a gloo world, from ``inputs`` (a torch.save of (state,
    train cameras, OptimizationParams, RasterizeConfig)), resumed from
    ``start_checkpoint`` if given. ``noise`` (a torch.save of {(densify
    round, capacity): [2, capacity, 3] draw}) replaces the generator's split
    noise; ``split_images`` keeps only the train images this rank's data row
    owns. Saves this rank's final TrainState fields, the losses of every
    iteration, the train images it held and each rebalance's occupancy
    before and after."""
    import dataclasses

    import torch.distributed as dist

    from gs_tpu_torch import synthetic, training
    from gs_tpu_torch.config import ParallelConfig, PipelineParams
    from gs_tpu_torch.data import multihost
    from gs_tpu_torch.models import densify
    from gs_tpu_torch.parallel import densify_sharded, trainer

    _join(rank, world, rdv)
    try:
        state, cams, opt, rcfg = torch.load(inputs, weights_only=False)
        if split_images:
            d = rank // shard
            cams = [c if multihost.should_load_image(i, d, data)
                    else dataclasses.replace(c, image=None) for i, c in enumerate(cams)]
        if noise is not None:
            draws, rounds = torch.load(noise, weights_only=False), []

            def split_noise(generator, capacity, device):
                rounds.append(capacity)
                return draws[(len(rounds) - 1, capacity)].to(device)
            densify.split_noise = split_noise
        rebalances = []
        real_rebalance = trainer.maybe_rebalance

        def rebalance(mesh, parallel, states, *args):
            after = real_rebalance(mesh, parallel, states, *args)
            rebalances.append((densify_sharded.shard_occupancy(mesh, states),
                               densify_sharded.shard_occupancy(mesh, after[0])))
            return after
        trainer.maybe_rebalance = rebalance
        losses = []
        scene = synthetic.SyntheticScene(state, cams, [])
        scene.cameras_extent = 1.0
        ts = training.run_training(scene, opt, PipelineParams(), raster_cfg=rcfg,
                                   test_iterations=(), save_iterations=(), log_every=1,
                                   start_checkpoint=start_checkpoint,
                                   progress=lambda it, m: losses.append(m["loss"]),
                                   parallel=ParallelConfig(data_parallel=data,
                                                           shard_parallel=shard, layout=layout))
        torch.save((ts.state, ts.adam, ts.stats, ts.iteration, losses,
                    sum(c.image is not None for c in cams), rebalances), out)
    finally:
        dist.destroy_process_group()
