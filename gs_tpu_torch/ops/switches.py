"""gs_tpu's path switches, read from the environment at import.

gs_tpu sets four trace-time globals from environment variables; the port
reads the same names into its counterparts:

  ============================  =====================  ========  ==============
  variable                      port global            default   values
  ============================  =====================  ========  ==============
  ``GS_TPU_GRAD_REDUCE``        rasterize_tiled         scatter   scatter, cuda
                                ``.GRAD_REDUCE``
  ``GS_TPU_PAIR_SOURCE``        rasterize_tiled         gather    gather, carry
                                ``.PAIR_SOURCE``
  ``GS_TPU_PALLAS_KERNEL``      rasterize_tiled         chunk     chunk, tile
                                ``.KERNEL_MODE``
  ``GS_TPU_BIN_EXPAND``         binning.EXPAND_IMPL     scatter   scatter, cuda
  ============================  =====================  ========  ==============

gs_tpu's ``"pallas"`` (its kernel) is the port's ``"cuda"`` for the two
switches that pick a kernel path. gs_tpu's ``"segsum"`` reduction is not
ported, and it and any other value raise ``ValueError``. The globals stay
plain module attributes: a caller (the autotune, a test) may still set them.
"""

from __future__ import annotations

import os
from collections.abc import Mapping

# port global -> (environment variable, default, values)
SWITCHES = {
    "GRAD_REDUCE": ("GS_TPU_GRAD_REDUCE", "scatter", ("scatter", "cuda")),
    "PAIR_SOURCE": ("GS_TPU_PAIR_SOURCE", "gather", ("gather", "carry")),
    "KERNEL_MODE": ("GS_TPU_PALLAS_KERNEL", "chunk", ("chunk", "tile")),
    "EXPAND_IMPL": ("GS_TPU_BIN_EXPAND", "scatter", ("scatter", "cuda")),
}
# the switches whose gs_tpu value "pallas" names the port's "cuda" kernels
PALLAS_IS_CUDA = ("GRAD_REDUCE", "EXPAND_IMPL")
# gs_tpu values with no port, and why
NOT_PORTED = {("GRAD_REDUCE", "segsum"): "gs_tpu's matrix-unit cumsum reduction, whose sums "
                                         "B5 ('cuda') computes, is not ported"}


def values(name: str) -> tuple[str, ...]:
    return SWITCHES[name][2]


def read(name: str, environ: Mapping[str, str] | None = None) -> str:
    """The value of the port global ``name`` from its environment variable
    (``os.environ`` unless ``environ`` is given), or its default."""
    var, default, allowed = SWITCHES[name]
    raw = (os.environ if environ is None else environ).get(var, default)
    value = "cuda" if raw == "pallas" and name in PALLAS_IS_CUDA else raw
    if (name, value) in NOT_PORTED:
        raise ValueError(f"{var}={raw!r}: {NOT_PORTED[(name, value)]}; expected one of {allowed}")
    if value not in allowed:
        raise ValueError(f"unknown {name} {raw!r} from {var}; expected one of {allowed}")
    return value
