"""gs_tpu_torch's spans and counters (``utils/profiling.py``) on the CPU: the
layers a recorded step, frame and loop open, their parents and units, host
syncs counted by the line that made them (the card's sync warnings stood in
for, as the CPU makes none), the off path (no event, no profiler range),
the Chrome trace and span table of ``profiling.trace``, and results bitwise
equal with recording on and off. On the card the backward's spans run on
autograd's device thread and get device times; ``portbench/inside.py``
reads them there."""

import dataclasses
import inspect
import json
import os
import types
import warnings

import pytest
import torch
from torch.autograd import DeviceType

from gs_tpu_torch import training
from gs_tpu_torch.config import OptimizationParams, PipelineParams, RasterizeConfig
from gs_tpu_torch.ops import binning, cuda_build, rasterize_tiled
from gs_tpu_torch.utils import profiling
from gs_tpu_torch.viewer.network_gui import GuiServer
from tests.torch_port_inputs import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_port_inputs import tiny_synthetic_scene

GROUPS = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")
RENDER_PARENTS = {
    "gs.render.preprocess": "gs.render",
    "gs.render.project": "gs.render.preprocess",
    "gs.render.sh": "gs.render.preprocess",
    "gs.render.bin": "gs.render",
    "gs.render.composite": "gs.render",
}
STEP_PARENTS = {
    "gs.step": None,
    "gs.render": "gs.step",
    **RENDER_PARENTS,
    "gs.loss": "gs.step",
    "gs.backward": "gs.step",
    "gs.backward.composite": "gs.backward",
    "gs.backward.preprocess": "gs.backward",
    "gs.adam": "gs.step",
    **{f"gs.adam.{g}": "gs.adam" for g in GROUPS},
    "gs.densify.stats": "gs.step",
}
# (PAIR_SOURCE, GRAD_REDUCE) -> the pair reduction's span
PATHS = {
    ("gather", "scatter"): {},
    ("gather", "cuda"): {"gs.backward.pair_reduce": "gs.backward"},
    ("carry", "scatter"): {"gs.backward.pair_reduce": "gs.backward"},
}
FRAME_PARENTS = {"gs.frame": None, "gs.render": "gs.frame", **RENDER_PARENTS,
                 "gs.frame.to_host": "gs.frame", "gs.frame.pack": "gs.frame"}


@pytest.fixture(scope="module")
def scene():
    return tiny_synthetic_scene()


def _cfg():
    return RasterizeConfig(chunk=32)


def _steps(scene, n):
    """``n`` train_steps of a fresh state on the first view; the last
    step's metrics and the state."""
    ts = training.init_train_state(scene.gaussians, scene.cameras_extent, 0)
    cam = scene.get_train_cameras()[0]
    m = None
    for i in range(n):
        ts.state, ts.adam, ts.stats, m = training.train_step(
            ts.state, ts.adam, ts.stats, cam, torch.zeros(3), i, ts.spatial_lr_scale,
            active_sh_degree=0, opt_cfg=OptimizationParams(), raster_cfg=_cfg(),
            accumulate_stats=True)
    return ts, m


def _frames(scene, n):
    ts = training.init_train_state(scene.gaussians, scene.cameras_extent, 0)
    server = GuiServer("127.0.0.1", 0)
    try:
        return [bytes(server.render_bytes(ts, cam, _cfg(), 1.0))
                for cam in scene.get_train_cameras()[:n]]
    finally:
        server.close()


def _parents(table_unit):
    return {name: row["parent"] for name, row in table_unit["spans"].items()}


@pytest.mark.parametrize("source,reduce", sorted(PATHS))
def test_recorded_steps_give_the_layers(monkeypatch, scene, source, reduce):
    """Two recorded train_steps: units ``step 1`` and ``step 2``, each with
    every layer's span under its parent, once; nothing in ``setup``, and no
    sync counted (the CPU makes none)."""
    monkeypatch.setattr(rasterize_tiled, "PAIR_SOURCE", source)
    monkeypatch.setattr(rasterize_tiled, "GRAD_REDUCE", reduce)
    extra_spans = PATHS[(source, reduce)]
    rec = profiling.Recorder()
    with profiling.recording(rec):
        _steps(scene, 2)
    table = rec.table()
    assert list(table) == ["setup", "step 1", "step 2"]
    assert table["setup"]["spans"] == {} and table["setup"]["counters"] == {}
    for unit in ("step 1", "step 2"):
        assert _parents(table[unit]) == {**STEP_PARENTS, **extra_spans}
        assert {row["calls"] for row in table[unit]["spans"].values()} == {1}
        assert table[unit]["counters"] == {} and table[unit]["sync_spans"] == {}
        assert all(row["device_ms"] is None for row in table[unit]["spans"].values())
    assert all(s.t0_ns <= s.t1_ns for s in rec.spans)


def test_recorded_frames_are_numbered_units(scene):
    """render_bytes opens ``frame <n>`` units in turn, each with the
    frame's spans."""
    rec = profiling.Recorder()
    with profiling.recording(rec):
        _frames(scene, 2)
    table = rec.table()
    assert list(table) == ["setup", "frame 0", "frame 1"]
    for unit in ("frame 0", "frame 1"):
        assert _parents(table[unit]) == FRAME_PARENTS
        assert table[unit]["counters"] == {}


def test_recorded_loop_reads_restore_and_save(tmp_path, scene):
    """run_training's own spans: the log points' reads (the loop's and the
    progress values'), none around the checkpoint's save, and the restore
    in ``setup`` of the resumed run."""
    opt = OptimizationParams(iterations=4, densify_until_iter=0, position_lr_max_steps=4)
    scene.model_path = str(tmp_path)
    kwargs = dict(test_iterations=(), save_iterations=(), log_every=2,
                  raster_cfg=_cfg(), progress=lambda it, m: None)
    first, second = profiling.Recorder(), profiling.Recorder()
    try:
        with profiling.recording(first):
            training.run_training(scene, opt, PipelineParams(), checkpoint_iterations=(2,),
                                  **kwargs)
        with profiling.recording(second):
            training.run_training(scene, dataclasses.replace(opt, iterations=3),
                                  PipelineParams(),
                                  start_checkpoint=str(tmp_path / "chkpnt2.npz"), **kwargs)
    finally:
        scene.model_path = ""
    table = first.table()
    assert list(table) == ["setup", "step 1", "step 2", "step 3", "step 4"]
    for unit in ("step 2", "step 4"):
        assert table[unit]["spans"]["gs.loop.read"]["calls"] == 2
    assert "gs.loop.read" not in table["step 3"]["spans"]
    assert (tmp_path / "chkpnt2.npz").exists()
    assert set(table["step 2"]["spans"]) == set(table["step 1"]["spans"]) | {"gs.loop.read"}
    resumed = second.table()
    assert list(resumed) == ["setup", "step 3"]
    assert set(resumed["setup"]["spans"]) == {"gs.restore"}


def test_no_recorder_records_nothing(monkeypatch, scene):
    """With no recorder a step and a frame make no CUDA event and open no
    profiler range (both would raise here), every ``annotate`` is the one
    null context, and a CPU profiler over a step shows no ``gs.`` range."""
    def boom(*args, **kwargs):
        raise AssertionError("made on the off path")

    monkeypatch.setattr(torch.cuda, "Event", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    assert profiling.annotate("gs.a") is profiling.annotate("gs.b")
    profiling.count("gs.sync.x")
    profiling.begin_unit("frame")
    _steps(scene, 1)
    _frames(scene, 1)
    monkeypatch.undo()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _steps(scene, 1)
    names = {e.name for e in prof.events()}
    assert any(n.startswith("aten::") for n in names)
    assert not any(n.startswith("gs.") for n in names)


def test_trace_carries_the_layers(tmp_path, scene):
    """Under ``profiling.trace`` the Chrome trace holds ``gs.render.preprocess``
    around aten ops of its thread, and the span table beside it has the
    step's unit with its spans."""
    folder = tmp_path / "trace"
    with profiling.trace(str(folder)):
        _steps(scene, 1)
    files = sorted(os.listdir(folder))
    assert [f.split("_")[0] for f in files] == ["spans", "trace"]
    with open(folder / files[1]) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    pre = [e for e in events if e["name"] == "gs.render.preprocess"]
    assert len(pre) == 1
    lo, hi = pre[0]["ts"], pre[0]["ts"] + pre[0]["dur"]
    inside = [e for e in events if e["name"].startswith("aten::") and e["tid"] == pre[0]["tid"]
              and lo <= e["ts"] <= hi]
    assert inside
    with open(folder / files[0]) as f:
        spans = json.load(f)
    assert _parents(spans["units"]["step 1"]) == STEP_PARENTS
    assert set(spans["kernel_ms_by_span"]) <= set(STEP_PARENTS) | {"(none)"}
    assert profiling._RECORDER is None


def _state_tensors(ts):
    return {**{f"param_{k}": v for k, v in ts.state.params().items()},
            **{f"mu_{k}": v for k, v in ts.adam.mu.items()},
            **{f"nu_{k}": v for k, v in ts.adam.nu.items()}}


@pytest.mark.parametrize("what", ["steps", "frames"])
def test_recording_changes_no_result(scene, what):
    """Loss, parameters and Adam's moments after two steps, and a frame's
    bytes, are bitwise the same with recording on and off."""
    def run():
        if what == "frames":
            return _frames(scene, 2)
        ts, m = _steps(scene, 2)
        return {"loss": m["loss"], **_state_tensors(ts)}

    off = run()
    with profiling.recording(profiling.Recorder()):
        on = run()
    if what == "frames":
        assert on == off
    else:
        assert on.keys() == off.keys()
        for k in off:
            assert torch.equal(on[k], off[k]), k


def _span(name, parent, unit, t0, t1, device_ms):
    return profiling.SpanRecord(name, parent, unit, int(t0 * 1e6), int(t1 * 1e6), device_ms)


@pytest.mark.parametrize("device", [True, False])
def test_self_time_is_the_parent_less_its_children(device):
    """On a hand-built table: a parent's self time is its time less its
    children's (both calls of a child summed), per unit; without device
    times every device field is None."""
    d = (lambda ms: ms) if device else (lambda ms: None)
    spans = [
        _span("gs.backward", "gs.step", "step 1", 0.0, 10.0, d(8.0)),
        _span("gs.backward.composite", "gs.backward", "step 1", 1.0, 3.0, d(1.5)),
        _span("gs.backward.pair_reduce", "gs.backward", "step 1", 3.0, 4.0, d(0.5)),
        _span("gs.backward.composite", "gs.backward", "step 1", 5.0, 6.0, d(1.0)),
        _span("gs.backward", "gs.step", "step 2", 0.0, 4.0, d(3.0)),
    ]
    table = profiling.span_table(spans)
    row = table["step 1"]["gs.backward"]
    assert row["host_ms"] == pytest.approx(10.0)
    assert row["self_host_ms"] == pytest.approx(10.0 - 2.0 - 1.0 - 1.0)
    assert table["step 1"]["gs.backward.composite"]["calls"] == 2
    assert table["step 2"]["gs.backward"]["self_host_ms"] == pytest.approx(4.0)
    if device:
        assert row["device_ms"] == 8.0
        assert row["self_device_ms"] == pytest.approx(8.0 - 1.5 - 0.5 - 1.0)
        assert table["step 2"]["gs.backward"]["self_device_ms"] == 3.0
    else:
        assert row["device_ms"] is None and row["self_device_ms"] is None


def _event(name, start, end, device=DeviceType.CPU, id=0):
    return types.SimpleNamespace(name=name, device_type=device, id=id,
                                 time_range=types.SimpleNamespace(start=start, end=end))


def _kernel(name, launch_id, us, at=1000):
    return _event(name, at, at + us, device=DeviceType.CUDA, id=launch_id)


def test_kernel_time_goes_to_the_span_of_its_launch():
    """A kernel counts under the shortest ``gs.`` range open on the host at
    the runtime call that launched it (matched by correlation id), on
    whatever thread: autograd's device thread launches the backward's, and
    a ctypes kernel has no operator around its launch. Launches outside
    every range, and kernels whose launch is missing, count under
    ``(none)``; the ranges' mirrors on the device are not kernels."""
    events = [
        _event("gs.step", 0, 100), _event("gs.render", 10, 40),
        _event("gs.backward", 50, 90), _event("gs.backward.pair_reduce", 60, 70),
        _event("cudaLaunchKernel", 12, 13, id=1), _event("cudaLaunchKernel", 14, 15, id=2),
        _event("cudaLaunchKernel", 41, 42, id=3), _event("cudaLaunchKernel", 55, 56, id=4),
        _event("cuLaunchKernel", 61, 62, id=5), _event("cudaMemcpyAsync", 120, 121, id=6),
        _kernel("mul", 1, 200), _kernel("add", 2, 100), _kernel("fill", 3, 50),
        _kernel("index_put", 4, 1000), _kernel("segment_reduce", 5, 430),
        _kernel("Memcpy DtoH", 6, 7), _kernel("orphan", 99, 9),
        _event("gs.render", 2000, 2300, device=DeviceType.CUDA, id=1),
    ]
    assert profiling.kernel_ms_by_span(events) == pytest.approx(
        {"gs.backward": 1.0, "gs.backward.pair_reduce": 0.43, "gs.render": 0.3,
         "gs.step": 0.05, "(none)": 0.016})
    assert ("gs.render", "mul", 0.2) in profiling.span_kernels(events)


def test_units_take_the_change_of_the_launch_counts(monkeypatch):
    """Each unit's ``launches`` is LAUNCHES' change over it; LAUNCHES itself
    keeps counting."""
    rec = profiling.Recorder()
    with profiling.recording(rec):
        profiling.begin_unit("step", 1)
        monkeypatch.setitem(cuda_build.LAUNCHES, "segment_reduce",
                            cuda_build.LAUNCHES["segment_reduce"] + 2)
        profiling.begin_unit("step", 2)
        profiling.count("gs.sync.x", 3)
    table = rec.table()
    assert table["step 1"]["launches"] == {"segment_reduce": 2}
    assert table["step 2"]["launches"] == {}
    assert table["step 2"]["counters"] == {"gs.sync.x": 3}


def test_recording_restores_the_recorder_before_it():
    outer, inner = profiling.Recorder(), profiling.Recorder()
    with profiling.recording(outer):
        with profiling.recording(inner):
            with profiling.annotate("gs.a"):
                pass
        with profiling.annotate("gs.b"):
            pass
    assert profiling._RECORDER is None
    assert [s.name for s in inner.spans] == ["gs.a"]
    assert [s.name for s in outer.spans] == ["gs.b"]


def _line(fn, text):
    """The file line of ``fn``'s source line holding ``text``."""
    lines, first = inspect.getsourcelines(fn)
    return first + next(i for i, line in enumerate(lines) if text in line)


def _warns_sync(fn):
    """``fn``, first warning as the card's sync debug mode does at a
    synchronizing call: at the Python line that called it."""
    def wrapped(*args, **kwargs):
        warnings.warn(profiling.SYNC_WARNING, stacklevel=2)
        return fn(*args, **kwargs)
    return wrapped


def test_binning_counts_its_reads(monkeypatch):
    """bin_gaussians_aligned's syncs are counted at the lines that make
    them, by path: bincount on both, the scatter expansion's
    repeat_interleave on the gather path only."""
    monkeypatch.setattr(torch, "bincount", _warns_sync(torch.bincount))
    monkeypatch.setattr(torch, "repeat_interleave", _warns_sync(torch.repeat_interleave))
    bincount = f"ops/binning.py:{_line(binning.bin_gaussians_aligned, 'torch.bincount(')}"
    repeat = f"ops/binning.py:{_line(binning.repeat_owner_fields, 'torch.repeat_interleave(')}"
    g = torch.Generator().manual_seed(0)
    n = 40
    means = torch.rand(n, 2, generator=g) * 32
    depths = torch.rand(n, generator=g)
    radii = torch.randint(0, 6, (n,), generator=g, dtype=torch.int32)
    attr = torch.rand(n, 3, generator=g)
    got = []
    for carry in (None, attr):
        rec = profiling.Recorder()
        with profiling.recording(rec):
            binning.bin_gaussians_aligned(means, depths, radii, 2, 2, 16, 16, 512, 32,
                                          carry_attr=carry)
        got.append(rec.table()["setup"])
    assert [u["counters"] for u in got] == [
        {f"gs.sync.{bincount}": 1, f"gs.sync.{repeat}": 1}, {f"gs.sync.{bincount}": 1}]
    assert got[0]["sync_spans"] == {bincount: None, repeat: None}


@pytest.mark.parametrize("recorded", [True, False])
def test_sync_warnings_are_counted_by_site_and_span(recorded):
    """Under a recording a sync warning is counted at its file and line in
    the current unit, beside the innermost open span, and consumed; other
    warnings pass on. After it, and without one, sync warnings pass on."""
    rec = profiling.Recorder()
    ctx = profiling.recording(rec) if recorded else profiling._NULL
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        with ctx:
            profiling.begin_unit("step", 7)
            with profiling.annotate("gs.render"), profiling.annotate("gs.render.bin"):
                warnings.warn(profiling.SYNC_WARNING)
                line = _line(test_sync_warnings_are_counted_by_site_and_span,
                             "warnings.warn(profiling.SYNC_WARNING)")
                warnings.warn("another warning")
        warnings.warn(profiling.SYNC_WARNING)
    site = f"tests/test_torch_tracing.py:{line}"
    passed = [str(w.message) for w in seen]
    if recorded:
        unit = rec.table()["step 7"]
        assert unit["counters"] == {f"gs.sync.{site}": 1}
        assert unit["sync_spans"] == {site: "gs.render.bin"}
        assert passed == ["another warning", profiling.SYNC_WARNING]
    else:
        assert rec.table()["setup"]["counters"] == {}
        assert passed == [profiling.SYNC_WARNING, "another warning", profiling.SYNC_WARNING]
