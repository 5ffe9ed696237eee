"""gs_tpu_torch's startup kernel autotune (``ops/autotune.py``) against gs_tpu's.

Twins of ``tests/test_autotune.py``'s cases that are not TPU formulations,
with a fake timer and ``force=True``; the sweep's choices against gs_tpu's
under the same timing of (kernel form, chunk, pair source); the kernel-form
rule against gs_tpu's ``_pick_kernel_mode``; and the sweep on the CPU: off
by the gate in ``run_training``, through the plain versions when forced.
"""

import math

import pytest
import torch

from gs_tpu.config import RasterizeConfig as JRasterizeConfig
from gs_tpu.ops import autotune as j_autotune
from gs_tpu.ops import rasterize_pallas as rp
from gs_tpu.ops import rasterize_tiled as j_rt
from gs_tpu_torch.config import OptimizationParams, PipelineParams, RasterizeConfig
from gs_tpu_torch.ops import autotune
from gs_tpu_torch.ops import rasterize_tiled as rt
from gs_tpu_torch.renderer import render
from gs_tpu_torch.training import run_training
from tests.torch_port_inputs import tiny_synthetic_scene
from tests.torch_port_inputs import one_torch_thread  # noqa: F401 (autouse)

QUIET = dict(log=lambda s: None)


@pytest.fixture(autouse=True)
def restore_globals():
    snap = (rt.KERNEL_MODE, rt.PAIR_SOURCE, rp.get_formulation(), rp.KERNEL_MODE,
            j_rt.PAIR_SOURCE)
    yield
    rt.KERNEL_MODE, rt.PAIR_SOURCE = snap[0], snap[1]
    rp.apply_formulation(snap[2])
    rp.KERNEL_MODE, j_rt.PAIR_SOURCE = snap[3], snap[4]


def _fake_timer(times, carry=1.0, chunks=None):
    """A timer reading the port's globals: the form's time, scaled by the
    chunk's factor and, under carry, by ``carry``."""
    calls = []

    def timer(state, camera, cfg, steps):
        calls.append((rt.KERNEL_MODE, cfg.chunk, rt.PAIR_SOURCE))
        t = times[rt.KERNEL_MODE] * (chunks or {}).get(cfg.chunk, 1.0)
        return t * (carry if rt.PAIR_SOURCE == "carry" else 1.0)

    return timer, calls


# --- twins of tests/test_autotune.py ---------------------------------------------------------


def test_picks_winner_and_sets_globals():
    timer, calls = _fake_timer({"chunk": 0.02, "tile": 0.08})
    res = autotune.autotune_formulation(None, None, RasterizeConfig(), timer=timer, force=True,
                                        tune_chunk=False, tune_movement=False, **QUIET)
    assert res["winner"] == "chunk"
    assert res["cfg"].chunk == 64
    assert calls == [("chunk", 64, "gather"), ("tile", 64, "gather")]
    assert rt.KERNEL_MODE == "chunk" and rt.PAIR_SOURCE == "gather"


def test_movement_phase_keeps_faster_carry():
    assert rt.PAIR_SOURCE == "gather"
    timer, _ = _fake_timer({"chunk": 0.02, "tile": 0.08}, carry=0.7)
    res = autotune.autotune_formulation(None, None, RasterizeConfig(), timer=timer, force=True,
                                        tune_chunk=False, **QUIET)
    assert res["winner"] == "chunk+carry"
    assert rt.PAIR_SOURCE == "carry"


def test_movement_phase_restores_when_slower():
    timer, _ = _fake_timer({"chunk": 0.02, "tile": 0.08}, carry=1.4)
    res = autotune.autotune_formulation(None, None, RasterizeConfig(), timer=timer, force=True,
                                        tune_chunk=False, **QUIET)
    assert res["winner"] == "chunk"
    assert rt.PAIR_SOURCE == "gather"


def test_tile_winner_sets_kernel_mode():
    timer, _ = _fake_timer({"chunk": 0.05, "tile": 0.01})
    res = autotune.autotune_formulation(None, None, RasterizeConfig(), timer=timer, force=True,
                                        tune_chunk=False, **QUIET)
    assert res["winner"] == "tile"
    assert rt.KERNEL_MODE == "tile"


def test_chunk_phase_picks_faster_chunk():
    # chunk 32 is 2x faster on the winning form
    timer, calls = _fake_timer({"chunk": 0.05, "tile": 0.08}, chunks={32: 0.5})
    res = autotune.autotune_formulation(None, None, RasterizeConfig(), timer=timer, force=True,
                                        **QUIET)
    assert res["winner"] == "chunk-c32"
    assert res["cfg"].chunk == 32
    assert rt.KERNEL_MODE == "chunk"
    assert calls == [("chunk", 64, "gather"), ("tile", 64, "gather"), ("chunk", 32, "gather"),
                     ("chunk", 128, "gather"), ("chunk", 32, "carry")]


def test_skips_off_the_card_and_other_backends():
    boom = lambda *a: (_ for _ in ()).throw(AssertionError("timed"))  # noqa: E731
    # the plain backends: skipped whatever the device
    for backend in ("torch", "oracle"):
        assert autotune.autotune_formulation(None, None, RasterizeConfig(backend=backend),
                                             timer=boom) is None
    # the CUDA backend with the state on the CPU: the plain versions would be timed
    state = tiny_synthetic_scene().gaussians
    for backend in ("auto", "cuda"):
        assert autotune.autotune_formulation(state, None, RasterizeConfig(backend=backend),
                                             timer=boom) is None
    assert rt.KERNEL_MODE == "chunk" and rt.PAIR_SOURCE == "gather"


def test_all_candidates_failing_restores_and_continues():
    def timer(state, camera, cfg, steps):
        raise RuntimeError("launch failed")

    rt.KERNEL_MODE = "tile"  # a configured form that is not the first candidate
    logs = []
    res = autotune.autotune_formulation(None, None, RasterizeConfig(), timer=timer, force=True,
                                        log=logs.append)
    assert res is None
    assert rt.KERNEL_MODE == "tile" and rt.PAIR_SOURCE == "gather"
    assert any("every candidate failed" in line for line in logs)
    assert sum("failed (RuntimeError: launch failed)" in line for line in logs) == 2


def test_one_failing_candidate_is_skipped_not_fatal():
    def timer(state, camera, cfg, steps):
        if rt.KERNEL_MODE == "tile":
            raise RuntimeError("too much shared memory")
        return 0.05

    logs = []
    res = autotune.autotune_formulation(None, None, RasterizeConfig(), timer=timer, force=True,
                                        tune_chunk=False, log=logs.append)
    assert res["winner"] == "chunk"
    assert res["tile"] == float("inf")
    assert rt.KERNEL_MODE == "chunk"
    assert any("tile failed" in line for line in logs)


# --- the same choices as gs_tpu's --------------------------------------------------------------

# (form times, chunk factors, carry factor, failing (form, chunk, source) keys)
SWEEPS = {
    "chunk": ({"chunk": 0.02, "tile": 0.08}, {}, 1.0, ()),
    "tile": ({"chunk": 0.05, "tile": 0.01}, {}, 1.0, ()),
    "tile_c128_carry": ({"chunk": 0.05, "tile": 0.04}, {128: 0.9, 32: 1.2}, 0.5, ()),
    "chunk_c32": ({"chunk": 0.03, "tile": 0.04}, {32: 0.8, 128: 0.9}, 1.1, ()),
    "carry_only": ({"chunk": 0.03, "tile": 0.04}, {32: 1.5, 128: 1.01}, 0.99, ()),
    "tile_fails": ({"chunk": 0.06, "tile": 0.01}, {32: 0.7}, 0.8, (("tile", 64, "gather"),)),
    "c32_and_carry_fail": ({"chunk": 0.02, "tile": 0.03}, {32: 0.1, 128: 0.9}, 0.1,
                           (("chunk", 32, "gather"), ("chunk", 128, "carry"))),
    "all_fail": ({"chunk": 0.02, "tile": 0.03}, {}, 1.0,
                 (("chunk", 64, "gather"), ("tile", 64, "gather"))),
}


def _timing(form_times, chunks, carry, failing, mode_of, source_of):
    def timer(state, camera, cfg, steps):
        key = (mode_of(), cfg.chunk, source_of())
        if key in failing:
            raise RuntimeError(f"candidate {key} failed")
        t = form_times[key[0]] * chunks.get(cfg.chunk, 1.0)
        return t * (carry if key[2] == "carry" else 1.0)

    return timer


@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_choices_match_gs_tpu(name):
    """Under the same timing of (kernel form, chunk, pair source), the port's
    sweep leaves the form, chunk and pair source that gs_tpu's leaves (its
    MXU / VPU formulations timed alike, so phases 1.5 / 1.6 change nothing)."""
    form_times, chunks, carry, failing = SWEEPS[name]
    res = autotune.autotune_formulation(
        None, None, RasterizeConfig(), force=True, **QUIET,
        timer=_timing(form_times, chunks, carry, failing, lambda: rt.KERNEL_MODE,
                      lambda: rt.PAIR_SOURCE))
    j_res = j_autotune.autotune_formulation(
        None, None, JRasterizeConfig(backend="pallas"), force=True, **QUIET,
        timer=_timing(form_times, chunks, carry, failing, lambda: rp.KERNEL_MODE,
                      lambda: j_rt.PAIR_SOURCE))
    ours = (rt.KERNEL_MODE, rt.PAIR_SOURCE, None if res is None else res["cfg"].chunk)
    theirs = (rp.KERNEL_MODE, j_rt.PAIR_SOURCE, None if j_res is None else j_res["cfg"].chunk)
    assert ours == theirs
    assert (res is None) == (j_res is None) == (name == "all_fail")
    if res is not None:
        assert res[res["winner"]] == min(v for k, v in j_res.items() if k not in ("winner", "cfg"))


# --- the kernel form ------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["chunk", "tile"])
def test_pick_kernel_mode_matches_gs_tpu(mode):
    """``pick_kernel_mode`` equals gs_tpu's ``_pick_kernel_mode`` under both
    KERNEL_MODE values over budgets on both sides of the 700 KiB rule."""
    rt.KERNEL_MODE, rp.KERNEL_MODE = mode, mode
    seen = set()
    for budget in (1 << 14, 1 << 18, 2_097_152, 2_867_200, 2_900_000, 10_473_600, 14_896_000):
        for chunk in (32, 64, 128):
            for tiles in (1, 510, 8160):
                got = rt.pick_kernel_mode("cuda", budget, chunk, tiles)
                assert got == j_rt._pick_kernel_mode("pallas", budget, chunk, tiles)
                assert rt.pick_kernel_mode("auto", budget, chunk, tiles) == got
                seen.add(got)
    assert seen == ({"chunk", "tile"} if mode == "chunk" else {"tile"})
    assert rt.pick_kernel_mode("torch", 1 << 14, 64, 1) is None
    assert j_rt._pick_kernel_mode("xla", 1 << 14, 64, 1) is None


def test_unknown_kernel_mode_raises():
    rt.KERNEL_MODE = "mxu-chunk"
    with pytest.raises(ValueError, match="KERNEL_MODE"):
        rt.pick_kernel_mode("cuda", 1 << 14, 64, 1)


def _render_forms(monkeypatch, scene, cfg):
    """Render the first camera, recording (kernel form, chunk, starts) of each
    compositing call."""
    calls = []
    composite = rt.composite_tiles

    def recording(st, sp_attr, tile_ids, starts, ends):
        calls.append((st.kernel_mode, st.chunk, starts.clone()))
        return composite(st, sp_attr, tile_ids, starts, ends)

    monkeypatch.setattr(rt, "composite_tiles", recording)
    cam = scene.get_train_cameras()[0]
    out = render(cam, scene.gaussians, active_sh_degree=0, bg_color=torch.zeros(3), cfg=cfg)
    monkeypatch.setattr(rt, "composite_tiles", composite)
    return out.image, calls


@pytest.mark.parametrize("chunk", [32, 64, 128])
def test_tile_mode_gives_the_tile_aligned_layout(monkeypatch, chunk):
    """KERNEL_MODE="tile" composites in the tile form on lcm(chunk, 128)-aligned
    ranges (gs_tpu ``binning_align``), to the chunk form's image."""
    scene = tiny_synthetic_scene(res=40)
    cfg = RasterizeConfig(chunk=chunk)
    img_chunk, (call_chunk,) = _render_forms(monkeypatch, scene, cfg)
    rt.KERNEL_MODE = "tile"
    img_tile, (call_tile,) = _render_forms(monkeypatch, scene, cfg)
    assert call_chunk[:2] == ("chunk", chunk) and call_tile[:2] == ("tile", chunk)
    align = math.lcm(chunk, 128)
    assert j_rt.binning_align(chunk, "pallas", "tile") == align
    assert bool((call_tile[2] % align == 0).all()) and bool((call_chunk[2] % chunk == 0).all())
    torch.testing.assert_close(img_tile, img_chunk, rtol=0, atol=0)


# --- on the CPU -------------------------------------------------------------------------------


def _train(scene, raster_cfg):
    opt = OptimizationParams(iterations=5, densify_from_iter=1, densification_interval=2,
                             densify_until_iter=5, position_lr_max_steps=5)
    return run_training(scene, opt, PipelineParams(), raster_cfg=raster_cfg,
                        test_iterations=(), save_iterations=())


def test_run_training_autotune_is_skipped_on_the_cpu(monkeypatch, capsys):
    """autotune=True on the CPU: the sweep is asked, skips (None) and changes
    no global; training equals autotune=False's bit for bit."""
    asked = []
    real = autotune.autotune_formulation

    def recording(*args, **kwargs):
        asked.append(real(*args, **kwargs))
        return asked[-1]

    monkeypatch.setattr(autotune, "autotune_formulation", recording)
    on = _train(tiny_synthetic_scene(), RasterizeConfig(chunk=32, autotune=True))
    assert asked == [None] and "[autotune]" not in capsys.readouterr().out
    assert rt.KERNEL_MODE == "chunk" and rt.PAIR_SOURCE == "gather"
    off = _train(tiny_synthetic_scene(), RasterizeConfig(chunk=32, autotune=False))
    assert len(asked) == 1
    for name in ("xyz", "features_dc", "features_rest", "log_scale", "quat", "logit_opacity",
                 "alive"):
        assert torch.equal(getattr(on.state, name), getattr(off.state, name)), name


def test_forced_default_timer_runs_each_candidate_in_its_form(monkeypatch):
    """The real timer, forced on the CPU (plain versions): every candidate
    composites in its own form, chunk and pair source, once for the warm-up
    and once a timed pass, forward and backward; the state is unchanged."""
    scene = tiny_synthetic_scene(res=32)
    before = {k: v.clone() for k, v in scene.gaussians.params().items()}
    seen = []
    composite = rt.composite_tiles

    def recording(st, *args):
        seen.append((st.kernel_mode, st.chunk, rt.PAIR_SOURCE))
        return composite(st, *args)

    monkeypatch.setattr(rt, "composite_tiles", recording)
    res = autotune.autotune_formulation(scene.gaussians, scene.get_train_cameras()[0],
                                        RasterizeConfig(), steps=1, force=True, **QUIET)
    names = [k for k in res if k not in ("winner", "cfg")]
    assert len(names) == 5 and all(math.isfinite(res[k]) and res[k] > 0 for k in names)
    form = rt.KERNEL_MODE
    assert form == min(("chunk", "tile"), key=lambda k: res[k])
    assert seen[::2] == seen[1::2]  # a warm-up and one timed pass a candidate
    assert seen[::2] == [("chunk", 64, "gather"), ("tile", 64, "gather"), (form, 32, "gather"),
                         (form, 128, "gather"), (form, res["cfg"].chunk, "carry")]
    assert rt.PAIR_SOURCE == ("carry" if res["winner"].endswith("+carry") else "gather")
    for k, v in scene.gaussians.params().items():
        assert torch.equal(v, before[k]), k
