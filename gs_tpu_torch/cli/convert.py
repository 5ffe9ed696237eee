"""COLMAP conversion CLI (port of ``gs_tpu/cli/convert.py``, reference ``convert.py:31-122``).

    python -m gs_tpu_torch.cli.convert -s <dataset> [--resize] [--camera OPENCV] ...

Wraps the external ``colmap`` binary: feature extraction -> exhaustive
matching -> mapping -> undistortion to PINHOLE, plus optional ImageMagick
1/2, 1/4, 1/8 image pyramids.
"""

from __future__ import annotations

import logging
import os
import shutil
import sys
from argparse import ArgumentParser


def main(argv=None):
    parser = ArgumentParser("Colmap converter")
    parser.add_argument("--no_gpu", action="store_true")
    parser.add_argument("--skip_matching", action="store_true")
    parser.add_argument("--source_path", "-s", required=True, type=str)
    parser.add_argument("--camera", default="OPENCV", type=str)
    parser.add_argument("--colmap_executable", default="", type=str)
    parser.add_argument("--resize", action="store_true")
    parser.add_argument("--magick_executable", default="", type=str)
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)

    colmap = (f'"{args.colmap_executable}"' if args.colmap_executable else "colmap")
    magick = (f'"{args.magick_executable}"' if args.magick_executable else "magick")
    use_gpu = 0 if args.no_gpu else 1
    src = args.source_path

    if not args.skip_matching:
        os.makedirs(src + "/distorted/sparse", exist_ok=True)

        feat_extraction = (
            f"{colmap} feature_extractor"
            f" --database_path {src}/distorted/database.db"
            f" --image_path {src}/input"
            " --ImageReader.single_camera 1"
            f" --ImageReader.camera_model {args.camera}"
            f" --SiftExtraction.use_gpu {use_gpu}"
        )
        if os.system(feat_extraction):
            logging.error("Feature extraction failed. Exiting.")
            sys.exit(1)

        feat_matching = (
            f"{colmap} exhaustive_matcher"
            f" --database_path {src}/distorted/database.db"
            f" --SiftMatching.use_gpu {use_gpu}"
        )
        if os.system(feat_matching):
            logging.error("Feature matching failed. Exiting.")
            sys.exit(1)

        mapper = (
            f"{colmap} mapper"
            f" --database_path {src}/distorted/database.db"
            f" --image_path {src}/input"
            f" --output_path {src}/distorted/sparse"
            " --Mapper.ba_global_function_tolerance=0.000001"
        )
        if os.system(mapper):
            logging.error("Mapper failed. Exiting.")
            sys.exit(1)

    img_undist = (
        f"{colmap} image_undistorter"
        f" --image_path {src}/input"
        f" --input_path {src}/distorted/sparse/0"
        f" --output_path {src}"
        " --output_type COLMAP"
    )
    if os.system(img_undist):
        logging.error("Undistortion failed. Exiting.")
        sys.exit(1)

    # reshuffle sparse/0 (convert.py:80-90)
    files = os.listdir(src + "/sparse")
    os.makedirs(src + "/sparse/0", exist_ok=True)
    for file in files:
        if file == "0":
            continue
        shutil.move(
            os.path.join(src, "sparse", file),
            os.path.join(src, "sparse", "0", file),
        )

    if args.resize:
        print("Copying and resizing...")
        for pct, sub in ((50, "images_2"), (25, "images_4"), (12.5, "images_8")):
            os.makedirs(f"{src}/{sub}", exist_ok=True)
        files = os.listdir(src + "/images")
        for file in files:
            source_file = os.path.join(src, "images", file)
            for pct, sub in ((50, "images_2"), (25, "images_4"), (12.5, "images_8")):
                dest = os.path.join(src, sub, file)
                shutil.copy2(source_file, dest)
                if os.system(f'{magick} mogrify -resize {pct}% "{dest}"'):
                    logging.error(f"{pct}% resize failed. Exiting.")
                    sys.exit(1)

    print("Done.")


if __name__ == "__main__":
    main()
