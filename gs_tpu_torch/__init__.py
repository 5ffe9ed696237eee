"""gs_tpu_torch: the PyTorch/CUDA port of gs_tpu for NVIDIA Hopper.

Module layout and names mirror ``gs_tpu`` so each module's counterpart is
found at the same path. The port imports ``torch`` and never ``jax`` or
``gs_tpu``. Plain tensor code is PyTorch; every Pallas TPU kernel on a
ported path is a hand-written CUDA kernel under ``csrc/``, built with
``nvcc`` the first time it is used (see :mod:`gs_tpu_torch.ops.rasterize_cuda`).

Every module of gs_tpu has its counterpart here: the render and training
paths with the six kernels, the data layer and the CLIs, the evaluation
and tooling surface, and training across devices in both of gs_tpu's
layouts (``parallel/``). ``tests/test_torch_surface.py`` holds the
public surface to gs_tpu's, name by name and parameter by parameter.
"""

__version__ = "0.1.0"
