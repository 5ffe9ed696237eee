"""Full evaluation harness (port of ``gs_tpu/cli/full_eval.py``, reference
``full_eval.py:15-75``).

    python -m gs_tpu_torch.cli.full_eval -m360 <root> -tat <root> -db <root> [--output_path ./eval]

Runs train -> render (7k and 30k) -> metrics over the paper's 13 scenes
(MipNeRF360 outdoor / indoor, Tanks&Temples, DeepBlending), with gs_tpu's
scene lists and flags. Each leg is a child process,
``python -m gs_tpu_torch.cli.{train,render,metrics}`` (the repository's
root scripts run gs_tpu), started from the caller's working directory, so
the child imports the package exactly where the caller did.
"""

from __future__ import annotations

import os
import sys
from argparse import ArgumentParser

# scene lists (full_eval.py:15-18)
MIPNERF360_OUTDOOR = ["bicycle", "flowers", "garden", "stump", "treehill"]
MIPNERF360_INDOOR = ["room", "counter", "kitchen", "bonsai"]
TANKS_AND_TEMPLES = ["truck", "train"]
DEEP_BLENDING = ["drjohnson", "playroom"]


def main(argv=None):
    parser = ArgumentParser(description="Full evaluation script parameters")
    parser.add_argument("--skip_training", action="store_true")
    parser.add_argument("--skip_rendering", action="store_true")
    parser.add_argument("--skip_metrics", action="store_true")
    parser.add_argument("--output_path", default="./eval")
    parser.add_argument("--mipnerf360", "-m360", default="", type=str)
    parser.add_argument("--tanksandtemples", "-tat", default="", type=str)
    parser.add_argument("--deepblending", "-db", default="", type=str)
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)

    scenes = []
    if args.mipnerf360:
        scenes += [(args.mipnerf360, s, "-i images_4") for s in MIPNERF360_OUTDOOR]
        scenes += [(args.mipnerf360, s, "-i images_2") for s in MIPNERF360_INDOOR]
    if args.tanksandtemples:
        scenes += [(args.tanksandtemples, s, "") for s in TANKS_AND_TEMPLES]
    if args.deepblending:
        scenes += [(args.deepblending, s, "") for s in DEEP_BLENDING]
    if not scenes:
        parser.error("no dataset roots given (-m360 / -tat / -db)")

    cli = f"{sys.executable} -m gs_tpu_torch.cli"

    if not args.skip_training:
        common = " --quiet --eval --test_iterations -1"
        for root, scene, extra in scenes:
            src = os.path.join(root, scene)
            out = os.path.join(args.output_path, scene)
            os.system(f"{cli}.train -s {src} {extra} -m {out}{common}")

    if not args.skip_rendering:
        for root, scene, _ in scenes:
            src = os.path.join(root, scene)
            out = os.path.join(args.output_path, scene)
            for it in (7000, 30000):
                os.system(f"{cli}.render --iteration {it} -s {src} -m {out}"
                          " --quiet --eval --skip_train")

    if not args.skip_metrics:
        paths = " ".join(
            '"' + os.path.join(args.output_path, scene) + '"'
            for _, scene, _ in scenes
        )
        os.system(f"{cli}.metrics -m {paths}")


if __name__ == "__main__":
    main()
