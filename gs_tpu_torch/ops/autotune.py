"""Startup kernel autotune: measure, don't guess (port of ``gs_tpu/ops/autotune.py``).

At training start, time each candidate on the real scene for a few
forward + backward passes and set the module globals to the winner, in
gs_tpu's phase order:

  1. the compositing kernel form, ``rasterize_tiled.KERNEL_MODE``: the
     chunk-grid kernels B1 / B2 against the tile-walk kernels B3 / B4
     (gs_tpu's three candidates are its MXU / VPU formulations x chunk /
     tile; the port has one formulation a form);
  2. chunk sizes 32 and 128 on the winning form (``tune_chunk``);
  3. the pair source, ``rasterize_tiled.PAIR_SOURCE``: the gather against
     the carry pipeline (B6 in binning, B5 in the backward)
     (``tune_movement``).

gs_tpu's phases 1.5 (``_SCAN_PREC``, the precision of its triangular
matrix-unit contraction) and 1.6 (``SUF_MXU``, a matrix-unit suffix sum)
tune TPU formulations that have no counterpart in the port, and are left
out. The globals stay set for the process, as gs_tpu's do.

The sweep runs only with the CUDA backend on a CUDA device: the gate reads
the backend and the state's device, never a failure. Inside the sweep a
candidate that fails is disqualified and logged; if every candidate of
phase 1 fails, the configured globals are restored and the caller trains
with its own configuration.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from gs_tpu_torch.ops import rasterize_tiled as rt
from gs_tpu_torch.utils import profiling

# phase 1's candidates: rasterize_tiled.KERNEL_MODE values
CANDIDATES = ("chunk", "tile")
CHUNKS = (32, 128)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def default_timer(state, camera, raster_cfg, steps: int) -> float:
    """Seconds per forward + backward of ``render`` plus L1 against zeros at
    the real scene shape (gs_tpu ``_default_timer``): one warm-up, then
    ``steps`` timed passes between two synchronizations. No Adam step; the
    state is not changed."""
    from gs_tpu_torch.renderer import render
    from gs_tpu_torch.utils import losses

    dev = state.device
    target = torch.zeros((3, camera.height, camera.width), dtype=torch.float32, device=dev)
    bg = torch.zeros(3, dtype=torch.float32, device=dev)
    params = {k: v.detach().requires_grad_() for k, v in state.params().items()}

    def fwd_bwd():
        with torch.enable_grad():
            out = render(camera, state.with_params(params),
                         active_sh_degree=state.max_sh_degree, bg_color=bg, cfg=raster_cfg)
            loss = losses.l1_loss(out.image, target)
            torch.autograd.grad(loss, list(params.values()), allow_unused=True)

    fwd_bwd()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        fwd_bwd()
    _sync(dev)
    return (time.perf_counter() - t0) / steps


def autotune_formulation(
    state,
    camera,
    raster_cfg,
    *,
    steps: int = 3,
    timer: Callable | None = None,
    force: bool = False,
    tune_chunk: bool = True,
    tune_movement: bool = True,
    log: Callable[[str], None] = print,
) -> dict | None:
    """Time each candidate at the real scene shape; keep the winner.

    Sets ``rasterize_tiled.KERNEL_MODE`` and ``PAIR_SOURCE`` to the fastest
    candidate and returns ``{candidate: seconds}`` plus ``"winner"`` and
    ``"cfg"`` (the raster config to train with: it differs from the input
    only in ``chunk``). Returns None when skipped (not the CUDA backend, or
    the state not on a CUDA device) or when every kernel form failed.

    ``timer`` / ``force`` exist for the plumbing tests: inject a fake timer
    and bypass the gate.

    Spans: ``gs.autotune`` around the sweep, ``gs.autotune.<candidate>``
    around each candidate's timing.
    """
    if not force:
        if rt.resolve_backend(raster_cfg.backend) != "cuda":
            return None
        if state.device.type != "cuda":
            return None
    timer = timer or default_timer
    with profiling.annotate("gs.autotune"):
        snap_mode = rt.KERNEL_MODE

        def try_time(name, ccfg):
            """Time one candidate; a failure disqualifies it only (+inf, never
            the winner) and is logged, and the sweep goes on."""
            try:
                with profiling.annotate(f"gs.autotune.{name}"):
                    return timer(state, camera, ccfg, steps)
            except Exception as e:  # noqa: BLE001 - any candidate failure
                log(f"[autotune] candidate {name} failed ({type(e).__name__}: {e}); skipping it")
                return float("inf")

        results: dict = {}
        for mode in CANDIDATES:
            rt.KERNEL_MODE = mode
            results[mode] = try_time(mode, raster_cfg)
        winner = min(results, key=results.get)
        if results[winner] == float("inf"):
            # every candidate failed: restore the configured form and train with it
            rt.KERNEL_MODE = snap_mode
            log("[autotune] every candidate failed; keeping the configured kernel form")
            return None
        rt.KERNEL_MODE = winner
        best_cfg = raster_cfg
        if tune_chunk:
            for chunk in CHUNKS:
                if chunk == raster_cfg.chunk:
                    continue
                ccfg = dataclasses.replace(raster_cfg, chunk=chunk)
                name = f"{winner}-c{chunk}"
                results[name] = try_time(name, ccfg)
                if results[name] < results[winner]:
                    winner, best_cfg = name, ccfg
        if tune_movement:
            other = "carry" if rt.PAIR_SOURCE == "gather" else "gather"
            snap_src = rt.PAIR_SOURCE
            rt.PAIR_SOURCE = other
            name = f"{winner}+{other}"
            results[name] = try_time(name, best_cfg)
            if results[name] < results[winner]:
                winner = name
            else:
                rt.PAIR_SOURCE = snap_src
        results["winner"] = winner
        results["cfg"] = best_cfg
        log("[autotune] kernel formulation: "
            + ", ".join(f"{k}={v * 1e3:.1f}ms" for k, v in results.items()
                        if k not in ("winner", "cfg"))
            + f" -> {winner}")
        return results
