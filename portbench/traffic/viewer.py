"""The viewer driver: one closed-loop client of the live SIBR viewer
protocol's frame path, ``GuiServer.render_bytes``, on a trained state.

Set-up draws the trained scene from the seed as the ``TrainState`` a fit
leaves at ``iteration`` (active SH degree 3) and opens a ``GuiServer`` on
port 0 with no client connected. Each request builds the next camera of an
orbit of novel views (between the dataset's views) and asks the server
for the frame's uint8 bytes; the next request goes out when they are on
the host. A frame's latency runs from the request to the bytes. After
``warmup_frames`` the window opens and closes at the first frame done
past ``--seconds``. Frames drawn from the seed (one in ``sample_every``)
are kept and, after the window, compared byte for byte with the
reference's (``judge.frame_checks``).
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from portbench import common, judge, roofline, scenes, spans
from portbench.reference import splat

PROFILE_FRAMES = 20
SAMPLE_SLOTS = 1 << 16


def frame_poses(cfg: dict, traffic: dict) -> list:
    """(R, T) of the orbit's frames: ``orbit_frames`` poses a turn, half a
    dataset view's step off the dataset's views, rising and falling by
    ``lift`` over the turn, aimed at the scene's middle."""
    n = traffic["orbit_frames"]
    offset = math.pi / cfg["views"]
    return [scenes.orbit_pose(cfg["orbit"], 2 * math.pi * i / n + offset,
                              traffic["lift"] * math.sin(2 * math.pi * i / n), np.zeros(3))
            for i in range(n)]


def sampled(seed: int, every: int) -> torch.Tensor:
    """[SAMPLE_SLOTS] bool: the frames kept for the comparison, one at a
    seeded place in each block of ``every`` frames."""
    gen = scenes.generator(seed, "sample", "cpu")
    blocks = SAMPLE_SLOTS // every
    keep = torch.zeros(SAMPLE_SLOTS, dtype=torch.bool)
    keep[torch.arange(blocks) * every + torch.randint(0, every, (blocks,), generator=gen)] = True
    return keep


def install_spans(rec: spans.Recorder) -> None:
    """The render span, the host's conversion after it, and a capture of
    one frame's compositing call."""
    from gs_tpu_torch import renderer
    from gs_tpu_torch.ops import rasterize_tiled
    from gs_tpu_torch.viewer.network_gui import GuiServer

    def render_span(original):
        def wrapped(*args, **kwargs):
            unit = rec.current
            start = spans._event()
            with torch.profiler.record_function("pb.render"):
                out = original(*args, **kwargs)
            end = spans._event()
            if unit is not None:
                unit["render"] = (start, end)
                end.synchronize()
                unit["render_done"] = time.perf_counter()
            return out
        return wrapped

    def bytes_span(original):
        def wrapped(*args, **kwargs):
            with torch.profiler.record_function("pb.render_bytes"):
                out = original(*args, **kwargs)
            if rec.current is not None and "render_done" in rec.current:
                rec.current["convert_ms"] = (time.perf_counter()
                                             - rec.current["render_done"]) * 1e3
            return out
        return wrapped

    rec.patches.replace(renderer, "render", render_span)
    rec.patches.replace(GuiServer, "render_bytes", bytes_span)
    for name in ("composite_fwd_cuda", "composite_fwd_tile_cuda"):
        rec.patches.replace(rasterize_tiled, name, rec.capture("fwd"))


def traced_records(rec: spans.Recorder, device, gaussians: int) -> dict:
    out = {"render_ms": rec.span_ms().get("render", []), "profile": rec.profile,
           "convert_ms": [u["convert_ms"] for u in rec.records if "convert_ms" in u]}
    if rec.profile:
        out["frame_s"] = rec.profile["window_s"] / rec.profile["units"]
    if "fwd" in rec.captured:
        fn, args, res = spans.to_device(rec.captured["fwd"], device)
        st, sp_attr, tile_ids, starts, ends = args
        fb = roofline.fwd_bound(st, sp_attr, tile_ids, starts, ends, res[2])
        out["fwd_bound_ms"] = fb["bound_ms"]
        out["fwd_kernel_ms"] = common.cuda_ms(torch, lambda: fn(*args), 5)
        out["frame_ops"] = roofline.frame_ops(fb["fp32_ops"], gaussians)
        common.log(f"roofline: forward {fn.__name__} bound {fb['bound_ms']:.4f} ms "
                   f"({fb['bound_by']}), ran {out['fwd_kernel_ms']:.4f} ms; a frame needs "
                   f"{out['frame_ops']} fp32 ops")
    return out


def run(cell: common.Cell, seed: int, seconds: float, traced: bool, device,
        t0: float) -> common.Outcome:
    from gs_tpu_torch import cameras, training
    from gs_tpu_torch.config import RasterizeConfig
    from gs_tpu_torch.models import gaussians
    from gs_tpu_torch.ops import cuda_build
    from gs_tpu_torch.viewer.network_gui import GuiServer

    cfg, traffic = cell.config, cell.traffic
    marks = [("imports", time.perf_counter())]
    p = scenes.gaussians(cfg, seed, device)
    n_live = int(p["alive"].sum())
    state = gaussians.GaussianState(xyz=p["xyz"], features_dc=p["f_dc"],
                                    features_rest=p["f_rest"], log_scale=p["scaling"],
                                    quat=p["rotation"], logit_opacity=p["opacity"],
                                    alive=p["alive"])
    del p
    ts = training.init_train_state(state, scenes.scene_extent(scenes.views(cfg, seed)),
                                   cfg["sh_degree"])
    ts.iteration = traffic["iteration"]
    raster = RasterizeConfig()
    poses = frame_poses(cfg, traffic)
    fovx, fovy = scenes.fov(cfg)
    w, h = cfg["width"], cfg["height"]
    keep = sampled(seed, traffic["sample_every"])
    server = GuiServer("127.0.0.1", 0, source_path="")

    def frame(i: int):
        r, t = poses[i % len(poses)]
        cam = cameras.make_camera(r, t, fovx, fovy, w, h, device=device)
        return server.render_bytes(ts, cam, raster, traffic["scaling_modifier"])

    rec = spans.Recorder(PROFILE_FRAMES, count_syncs=False) if traced else None
    if rec is not None:
        rec.warm_profiler(device)
    win = common.Window(seconds, traffic["warmup_frames"])
    kept, latencies = {}, []
    marks.append(("scene drawn, state and server", time.perf_counter()))
    try:
        for i in range(traffic["warmup_frames"]):
            frame(i)
            if i == 0:
                marks.append(("first frame", time.perf_counter()))
        i = traffic["warmup_frames"]
        opened = dict(cuda_build.LAUNCHES)
        if device.type == "cuda":
            torch.cuda.synchronize()
        common.reset_peak_memory(device)
        if rec is not None:
            install_spans(rec)
        win.tick(i, time.perf_counter())
        marks.append((f"{traffic['warmup_frames'] - 1} more warm-up frames", win.t_open))
        common.log("set-up by part (s): " + ", ".join(
            f"{name} {t - prev:.2f}" for (name, t), (_, prev) in zip(marks, [("", t0)] + marks)))
        while True:
            if rec is not None:
                rec.maybe_start_profile(time.perf_counter() - win.t_open, seconds)
                rec.begin_unit()
            t_req = time.perf_counter()
            buf = frame(i)
            t_done = time.perf_counter()
            latencies.append(t_done - t_req)
            if i < SAMPLE_SLOTS and keep[i]:
                kept[i] = buf
            if rec is not None:
                rec.current = None
                rec.end_unit_capture()
                rec.end_unit_profile()
            i += 1
            # a traced window stays open until its layers are read
            if win.tick(i, t_done, hold=rec is not None and not rec.complete):
                break
    finally:
        if rec is not None:
            rec.close()
        server.close()
    memory_peak = common.peak_memory(device)
    common.log(f"frames: {win.units} in {win.t_close - win.t_open:.3f} s; latency ms median "
               f"{1e3 * common.percentile(latencies, 50):.3f} p95 "
               f"{1e3 * common.percentile(latencies, 95):.3f} max {1e3 * max(latencies):.3f}; "
               f"kernel launches in the window "
               f"{ {k: v - opened.get(k, 0) for k, v in cuda_build.LAUNCHES.items()} }")
    e2e = {"frames_per_s": win.units_per_s(),
           "frame_ms_p95": 1e3 * common.percentile(latencies, 95),
           "setup_s": win.t_open - t0}
    trace = None
    if rec is not None:
        trace = traced_records(rec, device, n_live)
    del ts, state, server, rec
    gc.collect()
    common.free_cached(device)

    chosen = sorted(kept)[:traffic["compare_frames"]]
    t_ref = time.perf_counter()
    refs = reference_frames(cfg, seed, device, [poses[i % len(poses)] for i in chosen])
    common.log(f"reference: {len(chosen)} frames {chosen} in {time.perf_counter() - t_ref:.2f} s")
    got = [torch.from_numpy(np.frombuffer(kept[i], dtype=np.uint8).reshape(h, w, 3).copy())
           for i in chosen]
    checks = judge.frame_checks(got, refs, cell.limits)
    failed = sum(judge.frame_numbers([g], [r])["byte_gap"] > cell.limits["byte_gap"]
                 for g, r in zip(got, refs))
    return common.Outcome(end_to_end=e2e, checks=checks, attempted=win.units, failed=failed,
                          memory_peak_bytes=memory_peak, trace=trace,
                          notes={"compared": chosen})


def reference_frames(cfg: dict, seed: int, device, poses: list, dtype=torch.float32) -> list:
    """The reference's frame bytes [H, W, 3] (on the host) for ``poses``."""
    splat.no_tf32()
    p = scenes.gaussians(cfg, seed, device)
    params = {k: p[k].to(dtype) for k in splat.GROUPS}
    fovx, fovy = scenes.fov(cfg)
    bg = torch.zeros(3, device=device)
    out = []
    for r, t in poses:
        cam = splat.camera(r, t, fovx, fovy, cfg["width"], cfg["height"], device)
        out.append(splat.to_bytes(splat.render(params, p["alive"], cam, cfg["sh_degree"],
                                                bg)).cpu())
    return out


def control(cell: common.Cell, seed: int, device, dtype, outcome: common.Outcome) -> dict:
    """The control's numbers of a run: the reference's frames in ``dtype``
    against its frames in float32, for the frames the run compared."""
    poses = frame_poses(cell.config, cell.traffic)
    chosen = [poses[i % len(poses)] for i in outcome.notes["compared"]]
    want = reference_frames(cell.config, seed, device, chosen)
    got = reference_frames(cell.config, seed, device, chosen, dtype)
    return judge.frame_numbers(got, want)
