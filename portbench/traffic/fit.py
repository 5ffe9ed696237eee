"""The fit driver: ``training.run_training`` resumed half way through a fit,
as the training CLI resumes it from ``--start_checkpoint``.

Set-up draws the scene, the dataset's views and images and Adam's state
from the seed, writes them as the CLI's checkpoint (the program's own
``.npz`` format) under the run's temporary directory, and hands the loop a
scene of the drawn views. The loop runs with its defaults: the startup
autotune, ``log_every``, the test and save iterations. The window opens at
the first ``progress`` callback ``warmup_steps`` after the resume and
closes at the first past ``--seconds``; both callbacks follow the loop's
own synchronization.

Two stretches of ``check_steps`` steps are watched, each through the
loop's own call and feed (the views it took, the losses, Adam's first
moments after the first step, the parameters after the last): the first
steps after the resume, which start from the seed, and the steps that
follow the window's last, which start from the program's own state as the
window left it (copied at the first of them); after these the loop ends.
After the window the reference repeats both stretches from their starts
and the two are compared (``judge.fit_checks``).
"""

from __future__ import annotations

import dataclasses
import gc
import os
import random
import time

import torch

from portbench import common, judge, roofline, scenes, spans
from portbench.reference import splat

PROFILE_STEPS = 8


class FitScene:
    """What ``run_training`` reads of a ``Scene``: the drawn views."""

    def __init__(self, gaussians, extent, model_path, train, test):
        self.gaussians = gaussians
        self.cameras_extent = extent
        self.model_path = model_path
        self._train, self._test = train, test

    def get_train_cameras(self):
        return self._train

    def get_test_cameras(self):
        return self._test

    def save(self, iteration, state):
        raise RuntimeError(f"the benchmark's window never reaches a save iteration ({iteration})")


def inputs(cfg: dict, traffic: dict, seed: int, device):
    """Everything a fit resumes from, drawn from ``seed``: raw parameters
    (with ``alive``), Adam's moments, the views' poses, the train / test
    split, the images and the camera extent."""
    params = scenes.gaussians(cfg, seed, device)
    mu, nu = scenes.adam_state(cfg, params, seed, device)
    poses = scenes.views(cfg, seed)
    train, test = scenes.split(len(poses), cfg["test_every"])
    return dict(params=params, mu=mu, nu=nu, poses=poses, train=train, test=test,
                extent=scenes.scene_extent([poses[i] for i in train]),
                step=traffic["resume_iteration"])


def write_checkpoint(path: str, cfg: dict, inp: dict) -> None:
    """The drawn state as the CLI's checkpoint, by the program's writer."""
    from gs_tpu_torch import training
    from gs_tpu_torch.models import densify, gaussians, optim
    from gs_tpu_torch.utils import ckpt

    p = inp["params"]
    state = gaussians.GaussianState(xyz=p["xyz"], features_dc=p["f_dc"],
                                    features_rest=p["f_rest"], log_scale=p["scaling"],
                                    quat=p["rotation"], logit_opacity=p["opacity"],
                                    alive=p["alive"])
    adam = optim.AdamState(mu=dict(inp["mu"]), nu=dict(inp["nu"]),
                           step={k: inp["step"] for k in inp["mu"]})
    ts = training.TrainState(state=state, adam=adam,
                             stats=densify.DensifyStats.zeros(state.capacity, state.device),
                             iteration=inp["step"], spatial_lr_scale=inp["extent"],
                             max_sh_degree=cfg["sh_degree"])
    ckpt.save_train_state(path, ts)


class Watch:
    """``steps`` steps of the program through the loop's own call: the
    state they start from (with ``snapshot``, the program's own, copied on
    the device at the first call), the view and the 0-based iteration each
    took, its loss, Adam's first moments after the first step and the
    parameters after the last (on the host). Installed as
    ``training.train_step``, it takes itself off after the last step and,
    with ``stop``, ends the loop there."""

    def __init__(self, training, steps: int, view_of: dict, snapshot: bool = False,
                 stop: bool = False):
        self.training, self.steps, self.view_of = training, steps, view_of
        self.snapshot, self.stop = snapshot, stop
        self.real = training.train_step
        self.views, self.iterations, self.losses = [], [], []
        self.start = self.mu1 = self.params = None
        self.t_first = None
        training.train_step = self

    def __call__(self, state, adam, stats, camera, bg, iteration, spatial_lr_scale, **kwargs):
        if self.t_first is None:
            self.t_first = time.perf_counter()
            if self.snapshot:
                params = {k: v.detach().clone() for k, v in state.params().items()}
                params["alive"] = state.alive.clone()
                self.start = dict(params=params,
                                  mu={k: v.clone() for k, v in adam.mu.items()},
                                  nu={k: v.clone() for k, v in adam.nu.items()},
                                  step=dict(adam.step), extent=float(spatial_lr_scale))
        out = self.real(state, adam, stats, camera, bg, iteration, spatial_lr_scale, **kwargs)
        self.views.append(self.view_of[id(camera.view)])
        self.iterations.append(int(iteration))
        self.losses.append(float(out[3]["loss"]))
        if len(self.losses) == 1:
            self.mu1 = {k: v.detach().cpu() for k, v in out[1].mu.items()}
        if len(self.losses) == self.steps:
            self.params = {k: v.detach().cpu() for k, v in out[0].params().items()}
            self.training.train_step = self.real
            if self.stop:
                raise common.WindowClosed
        return out


def install_spans(rec: spans.Recorder, seconds: float, clock) -> None:
    """The traced window's spans: the step, the render, the loss, Adam, and
    a capture of one step's compositing calls."""
    from gs_tpu_torch import training
    from gs_tpu_torch.models import optim
    from gs_tpu_torch.ops import rasterize_tiled
    from gs_tpu_torch.utils import losses

    def step_span(original):
        def wrapped(*args, **kwargs):
            rec.maybe_start_profile(clock(), seconds)
            unit = rec.begin_unit()
            start = spans._event()
            with torch.profiler.record_function("pb.train_step"):
                out = original(*args, **kwargs)
            unit["step"] = (start, spans._event())
            rec.current = None
            rec.end_unit_capture()
            rec.end_unit_profile()
            return out
        return wrapped

    rec.patches.replace(training, "train_step", step_span)
    rec.patches.replace(training, "render", rec.span("render"))
    rec.patches.replace(losses, "photometric_loss", rec.span("loss"))
    rec.patches.replace(optim, "update", rec.span("adam"))
    for name in ("composite_fwd_cuda", "composite_fwd_tile_cuda"):
        rec.patches.replace(rasterize_tiled, name, rec.capture("fwd"))
    for name in ("composite_bwd_cuda", "composite_bwd_tile_cuda"):
        rec.patches.replace(rasterize_tiled, name, rec.capture("bwd"))


def traced_records(rec: spans.Recorder, device, gaussians: int, pixels: int) -> dict:
    """The traced window's records for the per-layer readers."""
    ms = rec.span_ms()
    out = {"render_ms": ms.get("render", []), "adam_ms": ms.get("adam", []),
           "backward_ms": rec.between_ms("loss", "adam"), "profile": rec.profile,
           "syncs_per_step": rec.syncs_per_unit}
    if rec.profile:
        out["step_s"] = rec.profile["window_s"] / rec.profile["units"]
    if "fwd" in rec.captured and "bwd" in rec.captured:
        fwd_fn, fwd_args, fwd_out = spans.to_device(rec.captured["fwd"], device)
        bwd_fn, bwd_args, _ = spans.to_device(rec.captured["bwd"], device)
        st, sp_attr, tile_ids, starts, ends = fwd_args
        fb = roofline.fwd_bound(st, sp_attr, tile_ids, starts, ends, fwd_out[2])
        bst, b_attr, b_ids, b_starts, b_ends, t_final, ncon, _, _ = bwd_args
        bb = roofline.bwd_bound(bst, b_attr, b_ids, b_starts, b_ends, t_final, ncon)
        out["fwd_bound_ms"], out["bwd_bound_ms"] = fb["bound_ms"], bb["bound_ms"]
        out["fwd_kernel_ms"] = common.cuda_ms(torch, lambda: fwd_fn(*fwd_args), 3)
        out["bwd_kernel_ms"] = common.cuda_ms(torch, lambda: bwd_fn(*bwd_args), 3)
        out["kernels"] = [fwd_fn.__name__, bwd_fn.__name__]
        out["step_ops"] = roofline.step_ops(fb["fp32_ops"], bb["fp32_ops"], gaussians, pixels)
        common.log(f"roofline: forward {fwd_fn.__name__} bound {fb['bound_ms']:.4f} ms "
                   f"({fb['bound_by']}), ran {out['fwd_kernel_ms']:.4f} ms; backward "
                   f"{bwd_fn.__name__} bound {bb['bound_ms']:.4f} ms ({bb['bound_by']}), ran "
                   f"{out['bwd_kernel_ms']:.4f} ms; step needs {out['step_ops']} fp32 ops")
    return out


def run(cell: common.Cell, seed: int, seconds: float, traced: bool, device,
        t0: float) -> common.Outcome:
    """One run of a fit cell. The outcome's ``notes`` keep the watched
    stretches (``phases``) for the control's readings."""
    from gs_tpu_torch import cameras, training
    from gs_tpu_torch.config import OptimizationParams, PipelineParams, RasterizeConfig
    from gs_tpu_torch.models import gaussians
    from gs_tpu_torch.ops import cuda_build
    from gs_tpu_torch.ops.rasterize_tiled import current_pair_budget

    cfg, traffic = cell.config, cell.traffic
    marks = [("imports", time.perf_counter())]
    inp = inputs(cfg, traffic, seed, device)
    marks.append(("scene drawn", time.perf_counter()))
    path = common.scratch_path(f"portbench-{cell.name}-chkpnt.npz")
    write_checkpoint(path, cfg, inp)
    marks.append(("checkpoint written", time.perf_counter()))
    common.log(f"checkpoint: {os.path.getsize(path)} B")
    n_live = int(inp["params"]["alive"].sum())
    cap = inp["params"]["alive"].numel()
    del inp["params"], inp["mu"], inp["nu"]
    gc.collect()

    w, h = cfg["width"], cfg["height"]
    fovx, fovy = scenes.fov(cfg)
    imgs = scenes.images(cfg, seed, len(inp["poses"]), device)
    cams = [dataclasses.replace(cameras.make_camera(r, t, fovx, fovy, w, h, device=device),
                                image=imgs[i]) for i, (r, t) in enumerate(inp["poses"])]
    view_of = {id(c.view): i for i, c in enumerate(cams)}
    scene = FitScene(gaussians.empty_state(scenes.CAPACITY_QUANTUM, cfg["sh_degree"],
                                           device=device),
                     inp["extent"], common.scratch_path(f"portbench-{cell.name}-model"),
                     [cams[i] for i in inp["train"]], [cams[i] for i in inp["test"]])
    opt = OptimizationParams(iterations=traffic["iterations"], **cfg["optimization"])
    raster = RasterizeConfig(autotune=traffic["autotune"])
    first = Watch(training, traffic["check_steps"], view_of)
    marks.append(("images and cameras", time.perf_counter()))

    rec = spans.Recorder(PROFILE_STEPS, count_syncs=True) if traced else None
    if rec is not None:
        rec.warm_profiler(device)
    win = common.Window(seconds, traffic["warmup_steps"])
    pairs = []
    launches = {}
    closing = {}

    def progress(it, m):
        now = time.perf_counter()
        pairs.append(int(m["num_pairs"]))
        if win.t_close is not None:
            return
        was_open = win.is_open
        # a traced window stays open until its layers are read
        hold = rec is not None and not rec.complete
        closed = win.tick(it - traffic["resume_iteration"], now, hold)
        if win.is_open and not was_open:
            launches["open"] = dict(cuda_build.LAUNCHES)
            common.reset_peak_memory(device)
            if rec is not None:
                install_spans(rec, seconds, lambda: time.perf_counter() - win.t_open)
        elif was_open and rec is not None:
            rec.sync_mark(it)
        if closed:
            closing["memory_peak"] = common.peak_memory(device)
            closing["launches"] = dict(cuda_build.LAUNCHES)
            if rec is not None:
                rec.close()
            # the steps after the window's last, from the state it left
            closing["watch"] = Watch(training, traffic["check_steps"], view_of,
                                     snapshot=True, stop=True)

    try:
        training.run_training(
            scene, opt, PipelineParams(), raster_cfg=raster,
            test_iterations=tuple(traffic["test_iterations"]),
            save_iterations=tuple(traffic["save_iterations"]),
            start_checkpoint=path, log_every=traffic["log_every"], progress=progress,
            seed=seed)
        raise RuntimeError("the fit ended before its window closed")
    except common.WindowClosed:
        pass
    finally:
        training.train_step = first.real
        if rec is not None:
            rec.close()
        if os.path.exists(path):
            os.remove(path)
    last = closing["watch"]

    budget = current_pair_budget(raster, cap)
    over = sum(p > budget for p in pairs)
    common.log(f"pairs a view (every {traffic['log_every']}th step, {len(pairs)} read): min "
               f"{min(pairs)} median {sorted(pairs)[len(pairs) // 2]} max {max(pairs)}; budget "
               f"{budget} at the configured factor; {over} read past it "
               f"({'splats dropped' if over else 'none dropped'})")
    marks += [("checkpoint read and the autotune", first.t_first),
              (f"{traffic['warmup_steps']} warm-up steps", win.t_open)]
    common.log("set-up by part (s): " + ", ".join(
        f"{name} {t - prev:.2f}" for (name, t), (_, prev) in zip(marks, [("", t0)] + marks)))
    window_launches = {k: v - launches["open"].get(k, 0)
                       for k, v in closing["launches"].items()}
    common.log(f"kernel launches: whole run {dict(cuda_build.LAUNCHES)}; in the window "
               f"({win.units} steps) {window_launches}")
    trace = None
    if rec is not None:
        trace = traced_records(rec, device, n_live, w * h)
        trace["peak_mem_bytes"] = closing["memory_peak"]
    del scene, cams, imgs, rec
    gc.collect()
    common.free_cached(device)

    t_ref = time.perf_counter()
    phases = [Phase("", None, first), Phase("window_", last.start, last)]
    checks = [("pairs_past_budget", float(over), 0.0)]
    for ph in phases:
        start = phase_start(cfg, traffic, seed, device, ph)
        ref = reference_steps(cfg, seed, device, start, ph.watch.views,
                              ph.watch.iterations, torch.float32)
        prog = program_readings(ph.watch, start)
        common.log(f"{ph.prefix or 'first_'}steps: iterations {ph.watch.iterations} views "
                   f"{ph.watch.views}; losses program {ph.watch.losses} reference "
                   f"{ref['losses']}")
        checks += judge.fit_checks(prog, ref, cell.limits, ph.prefix)
    common.log(f"reference: {sum(len(ph.watch.views) for ph in phases)} steps in "
               f"{time.perf_counter() - t_ref:.2f} s")
    return common.Outcome(end_to_end={"step_ms": win.ms_per_unit(), "setup_s": win.t_open - t0},
                          checks=checks, attempted=win.units, failed=0,
                          memory_peak_bytes=closing["memory_peak"], trace=trace,
                          notes={"phases": phases})


@dataclasses.dataclass
class Phase:
    """A watched stretch: the prefix of its checks' names, the state it
    started from (None: the seed's) and its watch."""

    prefix: str
    start: dict | None
    watch: Watch


def phase_start(cfg: dict, traffic: dict, seed: int, device, phase: Phase) -> dict:
    """The state ``phase`` started from: its snapshot, or the seed's draw."""
    if phase.start is not None:
        return phase.start
    inp = inputs(cfg, traffic, seed, device)
    return dict(params=inp["params"], mu=inp["mu"], nu=inp["nu"],
                step={k: inp["step"] for k in splat.GROUPS}, extent=inp["extent"])


def program_readings(watch: Watch, start: dict) -> dict:
    """The program's losses, first gradient norms (from Adam's first
    moments before and after the first step) and the norms of each group's
    change over the watched steps."""
    grad, change = {}, {}
    for k in splat.GROUPS:
        mu0 = start["mu"][k]
        g = mu0 + (watch.mu1[k].to(mu0.device) - mu0) / (1.0 - splat.BETA1)
        grad[k] = float(torch.linalg.norm(g.double()))
        change[k] = float(torch.linalg.norm((watch.params[k].to(mu0.device)
                                             - start["params"][k]).double()))
    return dict(losses=list(watch.losses), grad=grad, change=change)


def reference_steps(cfg: dict, seed: int, device, start: dict, views: list, iterations: list,
                    dtype) -> dict:
    """The reference's readings over the steps that took ``views`` at the
    0-based ``iterations``, from ``start`` (raw parameters with ``alive``,
    Adam's moments and step counts, the camera extent), in ``dtype``: each
    step's loss, the first step's gradient norms by group and the norms of
    each group's change."""
    splat.no_tf32()
    opt = cfg["optimization"]
    alive = start["params"]["alive"]
    params = {k: start["params"][k].to(dtype) for k in splat.GROUPS}
    mu = {k: start["mu"][k].to(dtype) for k in splat.GROUPS}
    nu = {k: start["nu"][k].to(dtype) for k in splat.GROUPS}
    steps = {k: start["step"][k] for k in splat.GROUPS}
    poses = scenes.views(cfg, seed)
    fovx, fovy = scenes.fov(cfg)
    imgs = scenes.images(cfg, seed, len(poses), device, which=views)
    bg = torch.zeros(3, device=device)
    losses, first_grad = [], None
    for i, (v, it) in enumerate(zip(views, iterations)):
        r, t = poses[v]
        cam = splat.camera(r, t, fovx, fovy, cfg["width"], cfg["height"], device)
        loss, grads = splat.loss_and_grads(params, alive, cam, cfg["sh_degree"], bg,
                                           imgs[i], opt["lambda_dssim"])
        losses.append(float(loss))
        if first_grad is None:
            first_grad = {k: float(torch.linalg.norm(grads[k].double())) for k in grads}
        xyz_lr = splat.expon_lr(it, opt["position_lr_init"], opt["position_lr_final"],
                                opt["position_lr_max_steps"])
        lrs = dict(xyz=xyz_lr * start["extent"], f_dc=opt["feature_lr"],
                   f_rest=opt["feature_lr"] / 20.0, opacity=opt["opacity_lr"],
                   scaling=opt["scaling_lr"], rotation=opt["rotation_lr"])
        params, mu, nu, steps = splat.adam(params, grads, mu, nu, steps, lrs)
    change = {k: float(torch.linalg.norm((params[k].float() - start["params"][k]).double()))
              for k in splat.GROUPS}
    return dict(losses=losses, grad=first_grad, change=change)


def camera_order(seed: int, train_views: list, steps: int) -> list:
    """The views the loop's first ``steps`` steps take: ``run_training``
    seeds Python's ``random`` with the run's seed and pops a random view
    off a fresh list of the train views."""
    random.seed(seed)
    stack = list(train_views)
    return [stack.pop(random.randint(0, len(stack) - 1)) for _ in range(steps)]


# -- the readings a limit is set from (portbench/control.py) ---------------------
FAULTS = ("half_batch", "answer_altered")


def control(cell: common.Cell, seed: int, device, dtype, outcome: common.Outcome) -> dict:
    """The control's numbers of a run: over each watched stretch, the
    reference in ``dtype`` put in the program's place, against the
    reference in float32."""
    return _against_reference(cell, seed, device, outcome, dtype, None)


def fault(cell: common.Cell, seed: int, device, name: str, outcome: common.Outcome) -> dict:
    """A fault's numbers of a run: over each watched stretch, the float32
    reference with the fault ``name`` planted (half of the image left out
    of the loss, its mean taken over the rest; the rendered colour altered
    by 1%), against the reference."""
    return _against_reference(cell, seed, device, outcome, torch.float32, name)


def _against_reference(cell, seed, device, outcome, dtype, planted) -> dict:
    saved = splat.photometric_loss, splat.composite_group

    def half(img, gt, lam=0.2):
        w = img.shape[-1] // 2
        return saved[0](img[..., :w], gt[..., :w], lam)

    def altered(*args):
        return saved[1](*args) * 1.01

    out = {}
    for ph in outcome.notes["phases"]:
        start = phase_start(cell.config, cell.traffic, seed, device, ph)
        args = (cell.config, seed, device, start, ph.watch.views, ph.watch.iterations)
        ref = reference_steps(*args, torch.float32)
        if planted == "half_batch":
            splat.photometric_loss = half
        elif planted == "answer_altered":
            splat.composite_group = altered
        elif planted is not None:
            raise ValueError(f"unknown fault {planted!r}")
        try:
            other = reference_steps(*args, dtype)
        finally:
            splat.photometric_loss, splat.composite_group = saved
        out.update({ph.prefix + k: v for k, v in judge.fit_numbers(other, ref).items()})
    return out
