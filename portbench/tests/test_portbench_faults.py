"""What ``correct`` catches: the control (the reference in bfloat16, put in
the program's place) and a run with its timed path broken underneath
both come out not correct, at a size the CPU holds; a sound run comes out
correct (test_portbench_reference)."""

import pytest
import torch

from portbench import common
from portbench.traffic import fit, viewer
from portbench.tests.small import SEED, small_cell

CPU = torch.device("cpu")


def fails(numbers: dict, limits: dict) -> bool:
    return any(numbers[k] > limits[k] for k in limits)


@pytest.fixture(scope="module")
def fit_run():
    cell = small_cell("mipnerf360-train")
    return cell, fit.run(cell, SEED, 1.0, False, CPU, 0.0)


def test_fit_control_fails(fit_run):
    cell, out = fit_run
    numbers = fit.control(cell, SEED, CPU, torch.bfloat16, out)
    assert set(numbers) == set(cell.limits)
    assert fails(numbers, cell.limits)


@pytest.mark.parametrize("name", fit.FAULTS)
def test_fit_faults_planted_in_the_reference_fail(fit_run, name):
    cell, out = fit_run
    numbers = fit.fault(cell, SEED, CPU, name, out)
    # each stretch, the first steps and those after the window, fails alone
    assert fails(numbers, {k: v for k, v in cell.limits.items() if k.startswith("window_")})
    assert fails(numbers, {k: v for k, v in cell.limits.items()
                           if not k.startswith("window_")})


def test_view_control_fails():
    cell = small_cell("tandt-view")
    out = viewer.run(cell, SEED, 1.0, False, CPU, 0.0)
    assert fails(viewer.control(cell, SEED, CPU, torch.bfloat16, out), cell.limits)


def broken_fit(monkeypatch, fault: str) -> bool:
    """Run the small fit cell with ``fault`` planted in the program; True if
    the run comes out correct."""
    from gs_tpu_torch import training
    from gs_tpu_torch.ops import rasterize_tiled
    from gs_tpu_torch.utils import losses

    if fault in ("state_unchanged", "stale_after_warmup"):
        real = training.train_step
        calls = [0]
        # the stale fault leaves the first steps whole and then returns the
        # state it is given: what a step reusing last step's work might do
        whole = 0 if fault == "state_unchanged" else small_cell(
            "mipnerf360-train").traffic["check_steps"] + 2

        def step(state, adam, stats, *args, **kwargs):
            calls[0] += 1
            new_state, new_adam, stats2, m = real(state, adam, stats, *args, **kwargs)
            if calls[0] <= whole:
                return new_state, new_adam, stats2, m
            return state, adam, stats2, m

        monkeypatch.setattr(training, "train_step", step)
    elif fault == "half_batch":
        real_loss = losses.photometric_loss

        def half(pred, target, lam):
            w = pred.shape[-1] // 2
            return real_loss(pred[..., :w], target[..., :w], lam)

        monkeypatch.setattr(losses, "photometric_loss", half)
    elif fault == "answer_altered":
        real = rasterize_tiled.composite_tiles

        def altered(*args):
            color, t, ncon = real(*args)
            return color * 1.01, t, ncon

        monkeypatch.setattr(rasterize_tiled, "composite_tiles", altered)
    out = fit.run(small_cell("mipnerf360-train"), SEED, 1.0, False, CPU, 0.0)
    return common.result_line(out, small_cell("mipnerf360-train"), False, {"kind": "cpu"})[1]


@pytest.mark.parametrize("fault", ["state_unchanged", "stale_after_warmup", "half_batch",
                                   "answer_altered"])
def test_broken_fit_is_not_correct(monkeypatch, fault):
    assert not broken_fit(monkeypatch, fault)


def broken_view(monkeypatch, fault: str) -> bool:
    from gs_tpu_torch import renderer
    from gs_tpu_torch.viewer.network_gui import GuiServer

    if fault == "half_frame":
        real = renderer.render

        def half(*args, **kwargs):
            out = real(*args, **kwargs)
            img = out.image.clone()
            img[:, :, img.shape[-1] // 2:] = 0.0
            return out._replace(image=img)

        monkeypatch.setattr(renderer, "render", half)
    elif fault == "answer_altered":
        real = GuiServer.render_bytes

        def altered(self, *args, **kwargs):
            buf = bytearray(real(self, *args, **kwargs))
            buf[len(buf) // 2] = (buf[len(buf) // 2] + 9) % 256
            return memoryview(bytes(buf))

        monkeypatch.setattr(GuiServer, "render_bytes", altered)
    cell = small_cell("tandt-view")
    out = viewer.run(cell, SEED, 1.0, False, CPU, 0.0)
    return common.result_line(out, cell, False, {"kind": "cpu"})[1]


@pytest.mark.parametrize("fault", ["half_frame", "answer_altered"])
def test_broken_viewer_is_not_correct(monkeypatch, fault):
    assert not broken_view(monkeypatch, fault)
