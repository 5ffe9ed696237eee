"""gs_tpu_torch's profiling hooks on the CPU: ``utils/profiling.py`` against
gs_tpu's, and ``run_training``'s ``profile_dir`` / ``progress`` timing."""

import json
import os
import re
import time

import pytest
import torch

from gs_tpu.utils import profiling as j_profiling
from gs_tpu_torch.config import OptimizationParams, PipelineParams, RasterizeConfig
from gs_tpu_torch.training import run_training
from gs_tpu_torch.utils import profiling
from tests.torch_port_inputs import tiny_synthetic_scene
from tests.torch_port_inputs import one_torch_thread  # noqa: F401 (autouse)

TIMER_FIELDS = ("ema_decay", "ema_s", "last_s", "total_s", "steps")

# (step seconds, synced) sequences: every step synced, every third, a run that
# ends between syncs, and one sync only at the end
SEQUENCES = {
    "every": [(0.5, True), (0.25, True), (0.125, True), (1.0, True)],
    "every_third": [(0.01, False), (0.02, False), (0.3, True)] * 4,
    "open_tail": [(0.2, True), (0.1, False), (0.4, True), (0.05, False), (0.07, False)],
    "last_only": [(0.003, False)] * 9 + [(0.9, True)],
}


@pytest.mark.parametrize("decay", [0.9, 0.5])
@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_step_timer_matches_gs_tpu(monkeypatch, name, decay):
    """The same (dt, synced) stops, with the clock patched, give both
    packages' timers equal fields and pixels/s after every stop."""
    clock = [100.0]
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])
    timers = (profiling.StepTimer(ema_decay=decay), j_profiling.StepTimer(ema_decay=decay))
    for dt, synced in SEQUENCES[name]:
        got = []
        for timer in timers:
            clock[0] = 100.0
            timer.start()
            clock[0] = 100.0 + dt
            got.append(timer.stop(synced=synced))
        assert got[0] == got[1]
        ours, theirs = ({f: getattr(t, f) for f in TIMER_FIELDS} for t in timers)
        assert ours == theirs
        assert timers[0].pixels_per_s(1920 * 1080) == timers[1].pixels_per_s(1920 * 1080)


def _read_trace(folder):
    """The events of the one Chrome trace in ``folder``, which also holds
    the window's span table (``spans_<pid>_<ns>.json``) beside it."""
    files = sorted(os.listdir(folder))
    assert len(files) == 2 and files[0].startswith("spans_") and files[1].startswith("trace_")
    assert all(f.endswith(".json") for f in files)
    with open(os.path.join(folder, files[1])) as f:
        return json.load(f)["traceEvents"]


def test_trace_writes_a_file_on_the_cpu(tmp_path):
    with profiling.trace(str(tmp_path / "trace")):
        with profiling.annotate("port_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    names = {e.get("name") for e in _read_trace(tmp_path / "trace")}
    assert "port_region" in names and "aten::mm" in names


def test_trace_none_is_a_no_op(tmp_path):
    with profiling.trace(None):
        torch.ones(3).sum()
    assert not os.listdir(tmp_path)


def train_tiny(scene, iterations, **kwargs):
    opt = OptimizationParams(iterations=iterations, densify_from_iter=2,
                             densification_interval=3, densify_until_iter=iterations,
                             position_lr_max_steps=iterations)
    return run_training(scene, opt, PipelineParams(), raster_cfg=RasterizeConfig(chunk=32),
                        test_iterations=(), save_iterations=(), **kwargs)


def test_run_training_profile_dir_writes_a_trace(tmp_path, capsys):
    """Tracing starts at profile_iters[0] and stops after profile_iters[1]
    (gs_tpu/training.py:308-309,373-375), with the steps' ops inside."""
    folder = tmp_path / "prof"
    train_tiny(tiny_synthetic_scene(), 6, profile_dir=str(folder), profile_iters=(2, 4))
    events = _read_trace(folder)
    assert any(e.get("name", "").startswith("aten::") for e in events)
    assert re.search(r"\[iter 4\] wrote profiler trace to .*\.json", capsys.readouterr().out)


def test_run_training_trace_ending_with_the_run(tmp_path, capsys):
    """A run that ends inside the profiled iterations still writes its trace."""
    folder = tmp_path / "prof"
    train_tiny(tiny_synthetic_scene(), 3, profile_dir=str(folder), profile_iters=(2, 60))
    assert _read_trace(folder)
    assert "[iter 3] wrote profiler trace" in capsys.readouterr().out


def test_progress_gets_step_time_and_pixel_rate():
    """progress carries gs_tpu's keys (gs_tpu/training.py:376-382): step_s is
    the StepTimer's EMA and pix_per_s = W * H / step_s."""
    seen = []
    train_tiny(tiny_synthetic_scene(), 6, log_every=2, progress=lambda it, m: seen.append((it, m)))
    assert [it for it, _ in seen] == [2, 4, 6]
    for _, m in seen:
        assert {"ema_loss", "step_s", "pix_per_s", "loss", "n_visible", "num_pairs",
                "xyz_lr"} <= m.keys()
        assert m["step_s"] > 0
        assert m["pix_per_s"] == pytest.approx(24 * 24 / m["step_s"], rel=1e-12)

