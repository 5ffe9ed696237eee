"""Metrics CLI (port of ``gs_tpu/cli/metrics.py``, reference ``metrics.py:24-103``).

    python -m gs_tpu_torch.cli.metrics -m <model_dir> [<model_dir> ...]

For each ``<model>/test/ours_*`` directory, loads the render / ground-truth
PNG pairs and computes SSIM / PSNR (the port's ``utils/losses.ssim`` and
``utils/metrics.psnr``) and LPIPS (``utils/lpips``) on the card, writing
``results.json`` and ``per_view.json`` in gs_tpu's layout; from Python,
``main(argv, device="cpu")`` runs on the CPU. Without the LPIPS weights file
the LPIPS column is null, as in gs_tpu. A scene that fails prints "Unable
to compute metrics ..." and the next one goes on: the reference's
per-scene handler.
"""

from __future__ import annotations

import json
import os
import sys
from argparse import ArgumentParser
from pathlib import Path

import numpy as np
import torch


def read_image(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im.convert("RGB"), dtype=np.float32) / 255.0
    return arr.transpose(2, 0, 1)  # [3,H,W]


def read_images(renders_dir: Path, gt_dir: Path):
    renders, gts, names = [], [], []
    for fname in sorted(os.listdir(renders_dir)):
        renders.append(read_image(str(renders_dir / fname)))
        gts.append(read_image(str(gt_dir / fname)))
        names.append(fname)
    return renders, gts, names


def evaluate(model_paths, device: str | torch.device = "cuda") -> dict:
    from gs_tpu_torch.device import resolve_device
    from gs_tpu_torch.utils import losses
    from gs_tpu_torch.utils import metrics as metrics_mod
    from gs_tpu_torch.utils.lpips import lpips_fn

    dev = resolve_device(device)
    lpips = lpips_fn(dev)  # None if the VGG weights are unavailable offline
    full_dict, per_view_dict = {}, {}
    for scene_dir in model_paths:
        try:
            print("Scene:", scene_dir)
            full_dict[scene_dir] = {}
            per_view_dict[scene_dir] = {}
            test_dir = Path(scene_dir) / "test"

            for method in sorted(os.listdir(test_dir)):
                print("Method:", method)
                method_dir = test_dir / method
                renders, gts, names = read_images(method_dir / "renders", method_dir / "gt")
                ssims, psnrs, lpipss = [], [], []
                for r, g in zip(renders, gts):
                    rt, gt = torch.from_numpy(r).to(dev), torch.from_numpy(g).to(dev)
                    ssims.append(float(losses.ssim(rt, gt)))
                    psnrs.append(float(metrics_mod.psnr(rt, gt)[0, 0]))
                    if lpips is not None:
                        lpipss.append(float(lpips(rt, gt)))
                print(f"  SSIM : {np.mean(ssims):>12.7f}")
                print(f"  PSNR : {np.mean(psnrs):>12.7f}")
                if lpipss:
                    print(f"  LPIPS: {np.mean(lpipss):>12.7f}")

                full_dict[scene_dir][method] = {
                    "SSIM": float(np.mean(ssims)),
                    "PSNR": float(np.mean(psnrs)),
                    "LPIPS": float(np.mean(lpipss)) if lpipss else None,
                }
                per_view_dict[scene_dir][method] = {
                    "SSIM": dict(zip(names, map(float, ssims))),
                    "PSNR": dict(zip(names, map(float, psnrs))),
                    "LPIPS": dict(zip(names, map(float, lpipss))) if lpipss else {},
                }

            with open(os.path.join(scene_dir, "results.json"), "w") as f:
                json.dump(full_dict[scene_dir], f, indent=True)
            with open(os.path.join(scene_dir, "per_view.json"), "w") as f:
                json.dump(per_view_dict[scene_dir], f, indent=True)
        except Exception as e:  # noqa: BLE001 - the reference's per-scene handler
            print(f"Unable to compute metrics for model {scene_dir}: {e}")
    return full_dict


def main(argv=None, *, device: str | torch.device = "cuda") -> dict:
    parser = ArgumentParser(description="Training script parameters")
    parser.add_argument("--model_paths", "-m", required=True, nargs="+", type=str)
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    return evaluate(args.model_paths, device=device)


if __name__ == "__main__":
    main()
