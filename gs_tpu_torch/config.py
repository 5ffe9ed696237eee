"""Configuration dataclasses (port of ``gs_tpu/config.py``).

Same fields and defaults as gs_tpu, except in ``RasterizeConfig``: the
compositing constants (1/255 skip, 1e-4 stop, 0.99 cap) are constants of
``ops/rasterize_oracle.py``, as gs_tpu's kernels use them (its config
fields for them are read by nothing), and ``backend`` names the port's
compositing backends:

- ``"auto"``: the CUDA kernel for CUDA tensors, the plain PyTorch version
  for CPU tensors (``rasterize_cuda.composite_fwd_cuda`` decides by the
  tensor's device, never by catching a failure);
- ``"cuda"``: the same wrapper, named explicitly;
- ``"torch"``: the plain PyTorch compositor on whatever device the inputs
  are on (the kernel's reference);
- ``"oracle"``: the dense closed-form rasterizer.

``ParallelConfig`` has gs_tpu's fields and defaults; the port trains both
its layouts, ``"tile"`` and ``"gauss"`` (``parallel/``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=False)
class ModelParams:
    """Data/model paths and representation settings (gs_tpu/config.py:17-37)."""

    sh_degree: int = 0  # the fork's default: 0, not 3
    source_path: str = ""  # shorthand -s
    model_path: str = ""  # shorthand -m
    images: str = "images"  # shorthand -i
    resolution: int = -1  # shorthand -r
    white_background: bool = False  # shorthand -w
    data_device: str = "cuda"
    eval: bool = False

    _shorthands = {
        "source_path": "s",
        "model_path": "m",
        "images": "i",
        "resolution": "r",
        "white_background": "w",
    }


@dataclass(frozen=True)
class PipelineParams:
    """Render-pipeline toggles (gs_tpu/config.py:40-50).

    The *_python flags select the independently formulated SH / covariance
    paths instead of the fused fast path.
    """

    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False


@dataclass(frozen=True)
class OptimizationParams:
    """Training schedule and densification knobs (gs_tpu/config.py:53-73,
    reference arguments/__init__.py:76-96)."""

    iterations: int = 30_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    random_background: bool = False


@dataclass(frozen=True)
class RasterizeConfig:
    """Rasterizer knobs (gs_tpu/config.py:76-109).

    tile_w/tile_h define the screen-space binning tile; the compositor
    walks each tile's depth-ordered pairs in chunks of ``chunk``.
    ``tile_batch`` bounds the plain compositor's [tiles, chunk, pixels]
    temporaries.
    """

    tile_w: int = 16
    tile_h: int = 16
    chunk: int = 64
    tile_batch: int = 256
    pair_budget_factor: float = 8.0  # pair budget = factor * capacity
    min_pair_budget: int = 1 << 14
    backend: str = "auto"  # "auto" | "cuda" | "torch" | "oracle"
    # exact-conservative per-tile dead-tail truncation
    # (rasterize_tiled.effective_ends): output-identical
    truncate_tiles: bool = True
    # startup kernel autotune (ops/autotune.py): time the kernel forms, chunk
    # sizes and pair sources on the real scene when training starts and keep
    # the winner. Runs only with the CUDA backend on a CUDA device.
    autotune: bool = True


@dataclass(frozen=True)
class ParallelConfig:
    """Device-mesh layout (gs_tpu/config.py:112-132): data-parallel cameras
    x tile or Gaussian sharding.

    ``layout`` picks the shard axis's meaning:
      - "tile": parameters replicated, image tile columns sharded
        (``gs_tpu_torch.parallel.sharded``);
      - "gauss": parameters, Adam and stats sharded over Gaussians with a
        visible-splat all-gather (``gs_tpu_torch.parallel.gauss_sharded``),
        densify and shard rebalancing on the shards
        (``gs_tpu_torch.parallel.densify_sharded``).
    """

    data_axis: str = "data"
    shard_axis: str = "shard"  # shards tiles (fwd) and gaussians (params/grads)
    data_parallel: int = 1
    shard_parallel: int = 1
    layout: str = "tile"  # "tile" | "gauss"
    visible_budget: int | None = None  # gauss layout: per-shard splat budget
    rebalance_skew: float = 1.25  # gauss layout: rebalance when max/mean exceeds
    migration_budget: int = 4096  # rows per shard per rebalance round


def asdict_shallow(cfg) -> dict:
    """A config's fields by name, values as they are (not copied recursively)."""
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
