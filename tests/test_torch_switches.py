"""gs_tpu's four path switches, read from the environment by the port.

gs_tpu reads ``GS_TPU_GRAD_REDUCE`` (gs_tpu/ops/rasterize_tiled.py:128),
``GS_TPU_PAIR_SOURCE`` (:139), ``GS_TPU_BIN_EXPAND``
(gs_tpu/ops/binning.py:37) and ``GS_TPU_PALLAS_KERNEL``
(gs_tpu/ops/rasterize_pallas.py:59) at import; the port reads the same
names into its globals through ``ops/switches.read``. These cases call it
with an explicit environment (no re-import), and one child interpreter
checks the globals a real environment resolves to.
"""

import os
import subprocess
import sys

import pytest

from gs_tpu_torch.ops import binning, rasterize_tiled, switches
from tests.torch_port_inputs import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# port global -> (its module, variable, default)
GLOBALS = {
    "GRAD_REDUCE": (rasterize_tiled, "GS_TPU_GRAD_REDUCE", "scatter"),
    "PAIR_SOURCE": (rasterize_tiled, "GS_TPU_PAIR_SOURCE", "gather"),
    "KERNEL_MODE": (rasterize_tiled, "GS_TPU_PALLAS_KERNEL", "chunk"),
    "EXPAND_IMPL": (binning, "GS_TPU_BIN_EXPAND", "scatter"),
}


@pytest.mark.parametrize("name", sorted(GLOBALS))
def test_defaults_and_values(name):
    """Without its variable a switch takes gs_tpu's default; each of its
    values reads back as itself; the module's value list is the helper's."""
    module, var, default = GLOBALS[name]
    assert switches.SWITCHES[name][0] == var
    assert switches.read(name, {}) == default
    for value in switches.values(name):
        assert switches.read(name, {var: value}) == value
    values_global = {"GRAD_REDUCE": "GRAD_REDUCES", "PAIR_SOURCE": "PAIR_SOURCES",
                     "KERNEL_MODE": "KERNEL_MODES", "EXPAND_IMPL": "EXPAND_IMPLS"}[name]
    assert getattr(module, values_global) == switches.values(name)


@pytest.mark.parametrize("name", ["GRAD_REDUCE", "EXPAND_IMPL"])
def test_pallas_is_cuda(name):
    """gs_tpu's "pallas" kernel path is the port's "cuda" one."""
    assert switches.read(name, {GLOBALS[name][1]: "pallas"}) == "cuda"


@pytest.mark.parametrize("name", ["KERNEL_MODE", "PAIR_SOURCE"])
def test_pallas_is_no_value_of_the_others(name):
    """GS_TPU_PALLAS_KERNEL takes chunk / tile, and the pair source gather /
    carry: "pallas" is neither's value and raises."""
    with pytest.raises(ValueError, match=f"unknown {name} 'pallas'"):
        switches.read(name, {GLOBALS[name][1]: "pallas"})


def test_segsum_is_not_ported():
    with pytest.raises(ValueError, match="GS_TPU_GRAD_REDUCE='segsum'.*not ported"):
        switches.read("GRAD_REDUCE", {"GS_TPU_GRAD_REDUCE": "segsum"})


@pytest.mark.parametrize("name", sorted(GLOBALS))
def test_unknown_value_raises(name):
    with pytest.raises(ValueError, match=f"unknown {name} 'bogus' from {GLOBALS[name][1]}"):
        switches.read(name, {GLOBALS[name][1]: "bogus"})


def test_environment_sets_the_globals():
    """A child interpreter with all four variables set (gs_tpu's spellings)
    imports the port and finds them resolved; one with segsum fails its
    import with the error naming it."""
    code = ("from gs_tpu_torch.ops import binning, rasterize_tiled as rt\n"
            "print(rt.GRAD_REDUCE, rt.PAIR_SOURCE, rt.KERNEL_MODE, binning.EXPAND_IMPL)\n")
    env = dict(os.environ, GS_TPU_GRAD_REDUCE="pallas", GS_TPU_PAIR_SOURCE="carry",
               GS_TPU_PALLAS_KERNEL="tile", GS_TPU_BIN_EXPAND="pallas")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["cuda", "carry", "tile", "cuda"]
    env["GS_TPU_GRAD_REDUCE"] = "segsum"
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0 and "segsum" in proc.stderr and "not ported" in proc.stderr
