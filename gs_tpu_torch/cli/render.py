"""Offline render CLI (port of ``gs_tpu/cli/render.py``, reference ``render.py:24-66``).

    python -m gs_tpu_torch.cli.render -m <model_dir> [--iteration N] [--skip_train] ...

Loads a trained iteration and renders every train and test camera to PNG
under ``<model>/{train,test}/ours_<iter>/{renders,gt}``. It runs on the
card; from Python, ``main(argv, device="cpu")`` runs it on the CPU.
"""

from __future__ import annotations

import os
import sys
from argparse import ArgumentParser

import numpy as np
import torch


def save_png(path: str, img) -> None:
    """[3,H,W] float in [0,1] (tensor or array) -> 8-bit RGB PNG."""
    from PIL import Image

    if isinstance(img, torch.Tensor):
        img = img.detach().cpu().numpy()
    arr = (np.clip(np.asarray(img), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    Image.fromarray(arr.transpose(1, 2, 0)).save(path)


def render_set(model_path, name, iteration, views, state, sh_degree, bg, raster_cfg):
    """Per-camera render + ground-truth dump (``render_set``, render.py:24-35)."""
    from gs_tpu_torch.training import eval_render

    render_path = os.path.join(model_path, name, f"ours_{iteration}", "renders")
    gts_path = os.path.join(model_path, name, f"ours_{iteration}", "gt")
    os.makedirs(render_path, exist_ok=True)
    os.makedirs(gts_path, exist_ok=True)
    for idx, view in enumerate(views):
        img = eval_render(state, view, bg, active_sh_degree=sh_degree, raster_cfg=raster_cfg)
        save_png(os.path.join(render_path, f"{idx:05d}.png"), img)
        if view.image is not None:
            save_png(os.path.join(gts_path, f"{idx:05d}.png"), torch.clamp(view.image, 0.0, 1.0))


def main(argv=None, *, device: str | torch.device = "cuda"):
    from gs_tpu_torch.cli import args as args_mod
    from gs_tpu_torch.config import ModelParams, PipelineParams, RasterizeConfig
    from gs_tpu_torch.ops.rasterize_tiled import BACKENDS
    from gs_tpu_torch.scene import Scene
    from gs_tpu_torch.utils.console import safe_state

    parser = ArgumentParser(description="Testing script parameters")
    args_mod.add_group(parser, ModelParams, "Model Parameters", sentinel=True)
    args_mod.add_group(parser, PipelineParams, "Pipeline Parameters")
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--raster_backend", type=str, default="auto", choices=BACKENDS)
    args = args_mod.get_combined_args(parser, sys.argv[1:] if argv is None else argv)
    print("Rendering " + args.model_path)

    with safe_state(args.quiet):
        model = args_mod.extract(ModelParams, args)
        scene = Scene(model, load_iteration=args.iteration, shuffle=False, device=device)
        state = scene.gaussians
        bg = torch.tensor([1.0, 1.0, 1.0] if model.white_background else [0.0, 0.0, 0.0],
                          device=scene.device)
        raster_cfg = RasterizeConfig(backend=args.raster_backend)
        if not args.skip_train:
            render_set(model.model_path, "train", scene.loaded_iter, scene.get_train_cameras(),
                       state, state.max_sh_degree, bg, raster_cfg)
        if not args.skip_test:
            render_set(model.model_path, "test", scene.loaded_iter, scene.get_test_cameras(),
                       state, state.max_sh_degree, bg, raster_cfg)


if __name__ == "__main__":
    main()
