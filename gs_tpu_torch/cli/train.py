"""Training CLI (port of ``gs_tpu/cli/train.py``, reference ``train.py:295-327``).

    python -m gs_tpu_torch.cli.train -s <dataset> [-m <model_dir>] [--eval] ...

It takes gs_tpu's whole flag set, so command lines carry over, and trains
on the card; from Python, ``main(argv, device="cpu")`` trains on the CPU
(``--data_device cpu`` keeps only the ground-truth images there). As in
gs_tpu, the SIBR viewer server listens on ``--ip`` / ``--port`` unless
``--disable_viewer`` (a port it cannot bind prints "Viewer server disabled
(...)" and training goes on), ``--kernel_autotune on`` (the default) runs
the startup kernel sweep on the card, and ``--profile_dir`` writes a
profiler trace of iterations 50-60 that carries the program's ``gs.*``
layers, with their span table beside it (``utils/profiling.py``).

``--data_parallel D --shard_parallel S`` trains across a D x S mesh of
processes, one a device (``parallel/``): tile-sharded, or with
``--parallel_layout gauss`` Gaussian-sharded (each rank holds its shard's
rows of the state and Adam; ``--visible_budget`` rows a shard compact
the gathered splat table). Each process runs this command with the
environment gs_tpu's CLI reads: ``GS_TPU_NUM_PROCESSES`` (the world size),
``GS_TPU_PROCESS_ID`` (its rank) and ``GS_TPU_COORDINATOR`` (the
rendezvous host:port, default 127.0.0.1:8476). The ranks of data row d
load only the train images that row owns; rank 0 alone writes the model
directory. A mesh that is not the world size raises before anything is
written. The kernel paths come from gs_tpu's environment switches
(``ops/switches.py``); the startup autotune runs in one-process worlds
only.
"""

from __future__ import annotations

import os
import sys
import uuid
from argparse import ArgumentParser

import torch

from gs_tpu_torch.cli import args as args_mod
from gs_tpu_torch.config import (ModelParams, OptimizationParams, ParallelConfig, PipelineParams,
                                 RasterizeConfig)
from gs_tpu_torch.ops.rasterize_tiled import BACKENDS
from gs_tpu_torch.parallel import mesh as mesh_mod


def prepare_output(model_params: ModelParams) -> str:
    """Model dir + cfg_args dump (``prepare_output_and_logger``, train.py:148-168)."""
    if not model_params.model_path:
        unique = os.getenv("OAR_JOB_ID", str(uuid.uuid4()))
        model_params.model_path = os.path.join("./output/", unique[0:10])
    print("Output folder:", model_params.model_path)
    args_mod.save_cfg_args(model_params.model_path, model_params)
    return model_params.model_path


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description="Training script parameters")
    args_mod.add_group(parser, ModelParams, "Model Parameters")
    args_mod.add_group(parser, OptimizationParams, "Optimization Parameters")
    args_mod.add_group(parser, PipelineParams, "Pipeline Parameters")
    parser.add_argument("--ip", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6009)
    parser.add_argument("--debug_from", type=int, default=-1)
    parser.add_argument("--detect_anomaly", action="store_true", default=False,
                        help="torch.autograd.set_detect_anomaly for the run")
    parser.add_argument("--test_iterations", nargs="+", type=int, default=[7_000, 30_000])
    parser.add_argument("--save_iterations", nargs="+", type=int, default=[7_000, 30_000])
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int, default=[])
    parser.add_argument("--start_checkpoint", type=str, default=None)
    parser.add_argument("--disable_viewer", action="store_true", default=False)
    parser.add_argument("--raster_backend", type=str, default="auto", choices=BACKENDS)
    parser.add_argument("--kernel_autotune", type=str, default="on", choices=["on", "off"],
                        help="time the kernel forms, chunk sizes and pair sources on the "
                             "scene at startup and train with the fastest")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler trace of iterations 50-60 here, with "
                             "the program's gs.* layers, and their span table beside it")
    parser.add_argument("--data_parallel", type=int, default=1,
                        help="mesh data axis: cameras per step")
    parser.add_argument("--shard_parallel", type=int, default=1,
                        help="mesh shard axis: tiles or gaussians")
    parser.add_argument("--parallel_layout", type=str, default="tile", choices=["tile", "gauss"],
                        help="shard axis meaning: image tiles or Gaussians")
    parser.add_argument("--visible_budget", type=int, default=None,
                        help="gauss layout: per-shard visible-splat budget")
    return parser


def parallel_config(args) -> ParallelConfig:
    return ParallelConfig(data_parallel=args.data_parallel, shard_parallel=args.shard_parallel,
                          layout=args.parallel_layout, visible_budget=args.visible_budget)


def init_from_env(device) -> bool:
    """Join the process world the environment describes (gs_tpu
    cli/train.py:70-80); a no-op for one process. True if it joined one."""
    n_proc = int(os.environ.get("GS_TPU_NUM_PROCESSES", "1"))
    return mesh_mod.init_distributed(
        coordinator=os.environ.get("GS_TPU_COORDINATOR", "127.0.0.1:8476"),
        num_processes=n_proc, process_id=int(os.environ.get("GS_TPU_PROCESS_ID", "0")),
        device=device) is not None


def main(argv=None, *, device: str | torch.device = "cuda"):
    """Train as ``python train.py`` does; returns the final TrainState."""
    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)
    args.save_iterations.append(args.iterations)
    print("Optimizing " + (args.model_path or "<auto>"))

    # the process world first, before any device use
    joined = init_from_env(device)
    try:
        return _train(args, device)
    finally:
        if joined:
            torch.distributed.destroy_process_group()


def _train(args, device):
    from gs_tpu_torch.scene import Scene
    from gs_tpu_torch.training import run_training
    from gs_tpu_torch.utils.console import safe_state
    from gs_tpu_torch.viewer.network_gui import GuiServer

    rank, n_proc = mesh_mod.world()
    parallel = None
    if args.data_parallel * args.shard_parallel > 1:
        parallel = parallel_config(args)
        # the mesh must be the world: raise before anything is written
        mesh_mod.mesh_shape(parallel.data_parallel, parallel.shard_parallel, n_proc)
    if n_proc > 1:
        device = mesh_mod.rank_device(device, rank)
    lead = rank == 0

    with safe_state(args.quiet), torch.autograd.set_detect_anomaly(args.detect_anomaly):
        model = args_mod.extract(ModelParams, args)
        opt = args_mod.extract(OptimizationParams, args)
        pipe = args_mod.extract(PipelineParams, args)
        if lead:
            prepare_output(model)
        args.model_path = model.model_path
        gui_server = None
        if lead and not args.disable_viewer:
            try:
                gui_server = GuiServer(args.ip, args.port, model.source_path)
            except OSError as e:
                print(f"Viewer server disabled ({e})")
        try:
            # the ranks of data row d load only the train images it owns
            scene = Scene(model, device=device, write_files=lead,
                          data_row=(rank // args.shard_parallel, args.data_parallel))
            test_iters = [] if args.test_iterations == [-1] else args.test_iterations

            def progress(it, m):
                if not args.quiet:
                    print(f"[{it:6d}] loss {m['ema_loss']:.5f}  "
                          f"visible {int(m.get('n_visible', 0))}", flush=True)

            ts = run_training(
                scene, opt, pipe,
                raster_cfg=RasterizeConfig(backend=args.raster_backend,
                                           autotune=args.kernel_autotune == "on"),
                white_background=model.white_background,
                test_iterations=tuple(test_iters),
                save_iterations=tuple(args.save_iterations),
                checkpoint_iterations=tuple(args.checkpoint_iterations),
                start_checkpoint=args.start_checkpoint,
                progress=progress,
                gui_server=gui_server,
                profile_dir=args.profile_dir,
                debug_from=args.debug_from,
                parallel=parallel,
            )
        finally:
            if gui_server is not None:
                gui_server.close()
        print("\nTraining complete.")
    return ts


if __name__ == "__main__":
    main()
