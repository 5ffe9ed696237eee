"""The port's public surface against gs_tpu's, read from source with ``ast``.

Neither package is imported, so the audit takes about a second. For each
module ``gs_tpu/<path>.py``, each public top-level ``def`` or ``class`` of
gs_tpu must either

- be defined by ``gs_tpu_torch/<path>.py`` (a ``def``, a ``class``, an
  assignment or an import from another port module), taking each of
  gs_tpu's parameters (a class: each annotated field, and each public
  method with its parameters; the port may add parameters), or
- stand in ``KEPT`` with a counterpart elsewhere in the port, which must
  exist (``Port``: a name in a port module; ``Param``: the parameter the
  port's function takes in its place), or a one-line reason (``Why``).

The same holds for every ``GS_TPU_*`` environment variable gs_tpu reads.
The six ``pl.pallas_call`` sites of gs_tpu map one to one onto
``cuda_build.LIBRARIES``, each with its ``.cu`` source and its wrapper,
and the libraries that replace no site (``PORT_ONLY_LIBRARIES``) have
theirs too;
every gs_tpu test module names its ``tests/test_torch_*.py`` twins or a
reason. ``KEPT`` holds nothing that is not needed.
"""

import ast
import functools
import re
from pathlib import Path
from typing import NamedTuple

import pytest

ROOT = Path(__file__).resolve().parents[1]
GS_TPU, PORT = ROOT / "gs_tpu", ROOT / "gs_tpu_torch"
MODULES = sorted(str(p.relative_to(GS_TPU)) for p in GS_TPU.rglob("*.py"))


class Port(NamedTuple):
    """The counterpart ``gs_tpu_torch/<module>.py::<name>``, and why it stands in."""

    target: str
    why: str = ""


class Param(NamedTuple):
    """The parameter (or field) the port's function (or class) takes instead."""

    name: str
    why: str = ""


class Why(NamedTuple):
    """Kept as it is in gs_tpu, for this reason."""

    why: str


FORMULATION = Why("a TPU matrix-unit formulation of B1-B4's contract (rasterize_pallas.py:53-123)")
SHARDING_SPEC = Why("a JAX sharding spec; the port's ranks hold their shards as tensors")
TPU_PACKING = Why("the TPU's packed [16, B] f32 kernel layout; the port's kernels take int32 "
                  "bounds and row-major columns")
PER_RANK = Why("gs_tpu's shard_map needs it for its output specs; the port's per-rank "
               "functions read it from the shards they are given")
NOT_READ = Why("no code in gs_tpu reads it")

KEPT = {
    # the Pallas kernels: their wrappers' counterparts, the formulation knobs
    "ops/rasterize_pallas.py::composite_fwd_pallas":
        Port("ops/rasterize_cuda.py::composite_fwd_cuda", "B1, csrc/composite_fwd.cu"),
    "ops/rasterize_pallas.py::composite_bwd_pallas":
        Port("ops/rasterize_cuda.py::composite_bwd_cuda", "B2, csrc/composite_bwd.cu"),
    "ops/rasterize_pallas.py::set_formulation": FORMULATION,
    "ops/rasterize_pallas.py::get_formulation": FORMULATION,
    "ops/rasterize_pallas.py::apply_formulation": FORMULATION,
    "env:GS_TPU_SCAN_MXU": FORMULATION,
    "env:GS_TPU_POWER_MXU": FORMULATION,
    "env:GS_TPU_MOMENT_MXU": FORMULATION,
    "env:GS_TPU_SUF_MXU": FORMULATION,
    "env:GS_TPU_PALLAS_DMA_CHUNKS": FORMULATION,
    "env:GS_TPU_SCAN_PREC": FORMULATION,
    "env:GS_TPU_DOT_PREC": FORMULATION,
    "env:GS_TPU_PALLAS_INTERPRET": Why("Pallas's interpret mode; a port wrapper runs its plain "
                                       "version on CPU tensors"),
    "env:GS_TPU_SSIM_BLUR": Why("its 'matmul' value is the blur on the TPU's matrix unit; the "
                                "port's SSIM is the default 'shift' formulation"),
    # GRAD_REDUCE="segsum": B5 computes the same sums
    "ops/rasterize_tiled.py::gather_pairs_segsum":
        Port("ops/rasterize_tiled.py::GatherPairsSegsum", "GRAD_REDUCE='cuda' (sort + B5)"),
    # orbax: torch.distributed.checkpoint directories stand in
    "utils/ckpt.py::save_train_state_orbax":
        Port("utils/ckpt.py::save_train_state", "a path without .npz is a directory"),
    "utils/ckpt.py::load_train_state_orbax":
        Port("utils/ckpt.py::load_train_state", "a path without .npz is a directory"),
    # JAX sharding specs
    "parallel/mesh.py::replicated": SHARDING_SPEC,
    "parallel/mesh.py::data_sharded": SHARDING_SPEC,
    "parallel/gauss_sharded.py::shard_specs": SHARDING_SPEC,
    "config.py::RasterizeConfig(alpha_threshold)": NOT_READ,
    "config.py::RasterizeConfig(transmittance_eps)": NOT_READ,
    "config.py::RasterizeConfig(max_alpha)": NOT_READ,
    # parameters, one at a time
    "models/densify.py::densify_and_prune(key)":
        Param("noise", "the split draw itself (densify.split_noise of a torch.Generator)"),
    "models/densify.py::densify_and_prune(slot_offset)":
        Why("the port passes each shard its rows of the whole capacity's drawn noise"),
    "training.py::densify_step(key)": Param("generator"),
    "ops/binning.py::bin_gaussians_aligned(sort_payload)":
        Why("no gs_tpu caller; a caller takes payload[depth_order]"),
    "ops/binning.py::AlignedBinningOut(payload_ds)": Why("sort_payload's result, not kept"),
    "ops/binning.py::AlignedBinningOut(pair_attr_t)":
        Param("pair_attr", "[AB, K] row-major, gs_tpu's is [K, AB]"),
    "ops/pairmove.py::segment_reduce_packed":
        Port("ops/pairmove.py::segment_reduce_sorted", "B5's one entry point"),
    "ops/pairmove.py::pack_sorted_columns": TPU_PACKING,
    "ops/pairmove.py::pack_interval_columns": TPU_PACKING,
    "ops/pairmove.py::expand_intervals(packed)": TPU_PACKING,
    "ops/pairmove.py::expand_intervals(rblk)": Why("a TPU block size; B6's is fixed in its source"),
    "ops/pairmove.py::expand_intervals(wchunk)": Why("a TPU window size; B6 sizes its windows"),
    "ops/pairmove.py::segment_reduce_sorted(grads)": Param("rows"),
    "ops/pairmove.py::segment_reduce_sorted(ids_sorted)":
        Why("the segments are seg_cum's; the ids only filled the TPU packing"),
    "ops/pairmove.py::segment_reduce_sorted(window)":
        Why("a TPU window size; B5 walks its segments"),
    "ops/rasterize_tiled.py::bin_carry_pairs(statics)": Param("cs"),
    "ops/rasterize_tiled.py::ncon_trimmed_ends(ncon_all)": Param("ncon"),
    "parallel/densify_sharded.py::make_sharded_densify(max_sh_degree)": PER_RANK,
    "parallel/densify_sharded.py::make_sharded_rebalance(capacity)": PER_RANK,
    "parallel/densify_sharded.py::make_sharded_rebalance(max_sh_degree)": PER_RANK,
    "parallel/densify_sharded.py::make_sharded_rebalance_loop(capacity)": PER_RANK,
    "parallel/densify_sharded.py::make_sharded_rebalance_loop(max_sh_degree)": PER_RANK,
    "parallel/densify_sharded.py::shard_occupancy(state)":
        Param("states", "the shards by index, counted over the mesh"),
    "parallel/densify_sharded.py::shard_occupancy(n_shard)": Param("mesh"),
    "parallel/mesh.py::make_mesh(devices)":
        Why("the mesh is the process world; a rank's device is rank_device's"),
    "parallel/sharded.py::reassemble_strips(tile_color)":
        Param("strips", "the strips already gathered"),
    "training.py::evaluate_and_report(metrics_mod)": Why("the port uses its own utils.metrics"),
    "viewer/network_gui.py::GuiServer.poll(render_fn)": Why("gs_tpu's poll never calls it"),
}

# gs_tpu's pl.pallas_call sites (module, enclosing function) -> the port's kernel
# library in cuda_build.LIBRARIES and its wrapper
PALLAS_SITES = {
    ("ops/rasterize_pallas.py", "composite_fwd_pallas"):
        ("composite_fwd", "ops/rasterize_cuda.py::composite_fwd_cuda"),
    ("ops/rasterize_pallas.py", "composite_bwd_pallas"):
        ("composite_bwd", "ops/rasterize_cuda.py::composite_bwd_cuda"),
    ("ops/rasterize_pallas.py", "_composite_fwd_pallas_tile"):
        ("composite_fwd_tile", "ops/rasterize_cuda.py::composite_fwd_tile_cuda"),
    ("ops/rasterize_pallas.py", "_composite_bwd_pallas_tile"):
        ("composite_bwd_tile", "ops/rasterize_cuda.py::composite_bwd_tile_cuda"),
    ("ops/pairmove.py", "segment_reduce_packed"):
        ("segment_reduce", "ops/pairmove.py::segment_reduce_sorted"),
    ("ops/pairmove.py", "expand_intervals"):
        ("expand_intervals", "ops/pairmove.py::expand_intervals"),
}

# the port's kernel libraries that replace no pallas_call site (gs_tpu leaves
# their work to XLA) -> their wrapper
PORT_ONLY_LIBRARIES = {"preprocess_bwd": "ops/preprocess_cuda.py::preprocess_bwd",
                       "preprocess_fwd": "ops/preprocess_cuda.py::preprocess_fwd"}

# gs_tpu's test modules -> their twins in the port's tests, or a reason
TWINS = {
    "test_autotune.py": ("test_torch_autotune.py",),
    "test_cli.py": ("test_torch_cli.py", "test_torch_eval_cli.py"),
    "test_data.py": ("test_torch_data.py",),
    "test_densify_train.py": ("test_torch_train.py",),
    "test_e2e_quality.py": ("test_torch_recovery.py",),
    "test_golden.py": ("test_torch_raster.py", "test_torch_train.py"),
    "test_losses_optim.py": ("test_torch_train.py", "test_torch_math.py"),
    "test_lpips.py": ("test_torch_lpips.py",),
    "test_math_core.py": ("test_torch_math.py",),
    "test_multiproc.py": ("test_torch_parallel_train.py",),
    "test_native.py": ("test_torch_native.py",),
    "test_oracle.py": ("test_torch_raster.py", "test_torch_render.py"),
    "test_pairmove.py": ("test_torch_pairmove.py", "test_torch_carry.py"),
    "test_pallas.py": ("test_torch_raster.py", "test_torch_train.py", "test_torch_tile.py",
                       "test_torch_cull.py"),
    "test_pallas_variants.py": FORMULATION,
    "test_pipeline_flags.py": ("test_torch_render.py", "test_torch_train.py",
                               "test_torch_sh4.py"),
    "test_sharding.py": ("test_torch_sharding.py", "test_torch_gauss_sharded.py",
                         "test_torch_densify_sharded.py", "test_torch_multihost.py",
                         "test_torch_switches.py"),
    "test_tiled.py": ("test_torch_binning.py", "test_torch_raster.py", "test_torch_pairmove.py"),
    "test_viewer.py": ("test_torch_viewer.py",),
}


# --- reading source ----------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def tree(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def params(fn: ast.FunctionDef) -> set[str]:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    return set(names) - {"self", "cls"}


def fields(cls: ast.ClassDef) -> set[str]:
    return {n.target.id for n in cls.body
            if isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name)}


def methods(cls: ast.ClassDef) -> dict[str, ast.FunctionDef]:
    return {n.name: n for n in cls.body
            if isinstance(n, ast.FunctionDef) and not n.name.startswith("_")}


def public_defs(path: Path) -> dict:
    return {n.name: n for n in tree(path).body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef)) and not n.name.startswith("_")}


def port_definition(module: str, name: str):
    """The port's ``def`` / ``class`` node of ``name`` in ``module`` (imports
    from other port modules followed), True for a name bound otherwise,
    None if the module does not bind it."""
    path = PORT / module
    if not path.exists():
        return None
    for node in tree(path).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and node.name == name:
            return node
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            if any(isinstance(t, ast.Name) and t.id == name for t in targets):
                return True
        if isinstance(node, ast.ImportFrom) and (node.module or "").startswith("gs_tpu_torch"):
            for alias in node.names:
                if (alias.asname or alias.name) == name:
                    source = node.module.split(".", 1)[1].replace(".", "/") + ".py"
                    return port_definition(source, alias.name) or True
    return None


def resolve(key: str) -> None:
    """Assert that KEPT[key]'s counterpart exists in the port."""
    entry = KEPT[key]
    if isinstance(entry, Why):
        assert entry.why, key
    elif isinstance(entry, Port):
        module, name = entry.target.split("::")
        assert port_definition(module, name) is not None, f"{key}: {entry.target} is missing"
    else:
        module, rest = key.split("::")
        owner = rest.split("(")[0]
        node = port_definition(module, owner.split(".")[0])
        if "." in owner:
            node = methods(node)[owner.split(".")[1]]
        have = fields(node) | {p for m in methods(node).values() for p in params(m)} \
            if isinstance(node, ast.ClassDef) else params(node)
        assert entry.name in have, f"{key}: the port's {owner} has no {entry.name!r}"


def gaps(module: str) -> list[str]:
    """The gs_tpu names and parameters of ``module`` the port does not have, as KEPT keys."""
    out = []
    for name, node in public_defs(GS_TPU / module).items():
        mine = port_definition(module, name)
        if mine is None:
            out.append(f"{module}::{name}")
            continue
        if isinstance(node, ast.FunctionDef):
            if isinstance(mine, ast.FunctionDef):
                out += [f"{module}::{name}({p})" for p in sorted(params(node) - params(mine))]
            continue
        if isinstance(mine, ast.ClassDef):
            out += [f"{module}::{name}({f})" for f in sorted(fields(node) - fields(mine))]
            for meth, fn in methods(node).items():
                theirs = methods(mine).get(meth)
                if theirs is None:
                    out.append(f"{module}::{name}.{meth}")
                else:
                    out += [f"{module}::{name}.{meth}({p})"
                            for p in sorted(params(fn) - params(theirs))]
    return out


def env_vars(package: Path) -> set[str]:
    """The GS_TPU_* names that appear as whole string constants in a package."""
    return {n.value for p in package.rglob("*.py") for n in ast.walk(tree(p))
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and re.fullmatch(r"GS_TPU_[A-Z0-9_]+", n.value)}


def pallas_sites() -> set[tuple[str, str]]:
    out = set()
    for p in GS_TPU.rglob("*.py"):
        for top in tree(p).body:
            for n in ast.walk(top):
                if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                        and n.func.attr == "pallas_call":
                    out.add((str(p.relative_to(GS_TPU)), top.name))
    return out


def all_gaps() -> set[str]:
    found = {g for m in MODULES for g in gaps(m)}
    return found | {f"env:{v}" for v in env_vars(GS_TPU) - env_vars(PORT)}


# --- the audit ---------------------------------------------------------------------------


@pytest.mark.parametrize("module", MODULES)
def test_module_surface(module):
    """Every public name and parameter of gs_tpu's module is the port's, or KEPT."""
    missing = [g for g in gaps(module) if g not in KEPT]
    assert not missing, f"missing from the port and not in KEPT: {missing}"
    for key in KEPT:
        if key.startswith(f"{module}::"):
            resolve(key)


def test_environment_variables():
    """Every GS_TPU_* variable gs_tpu reads is read by the port, or KEPT."""
    theirs, mine = env_vars(GS_TPU), env_vars(PORT)
    assert {"GS_TPU_GRAD_REDUCE", "GS_TPU_LPIPS_WEIGHTS", "GS_TPU_NUM_PROCESSES"} <= theirs
    assert not [v for v in sorted(theirs - mine) if f"env:{v}" not in KEPT]
    for v in theirs - mine:
        resolve(f"env:{v}")


def test_kept_holds_only_what_is_needed():
    """Each KEPT entry stands for a gap that exists: a name or parameter the
    port lacks. A KEPT name the port has since gained fails here."""
    stale = sorted(set(KEPT) - all_gaps())
    assert not stale, f"KEPT entries the port no longer needs: {stale}"


def test_pallas_sites_map_onto_the_kernel_libraries():
    """The six pallas_call sites, one CUDA library each, every library used
    once (or listed in PORT_ONLY_LIBRARIES), its source and its wrapper in
    the port."""
    assert pallas_sites() == set(PALLAS_SITES) and len(PALLAS_SITES) == 6
    build = tree(PORT / "ops" / "cuda_build.py")
    libraries = next(n.value for n in build.body if isinstance(n, ast.Assign)
                     and any(getattr(t, "id", None) == "LIBRARIES" for t in n.targets))
    names = [k.value for k in libraries.keys]
    assert sorted(names) == sorted([*(lib for lib, _ in PALLAS_SITES.values()),
                                    *PORT_ONLY_LIBRARIES])
    for lib, wrapper in [*PALLAS_SITES.values(), *PORT_ONLY_LIBRARIES.items()]:
        assert (PORT / "csrc" / f"{lib}.cu").is_file(), lib
        module, name = wrapper.split("::")
        assert isinstance(port_definition(module, name), ast.FunctionDef), wrapper


def test_every_gs_tpu_test_module_has_a_twin():
    theirs = sorted(p.name for p in (ROOT / "tests").glob("test_*.py")
                    if not p.name.startswith("test_torch_"))
    assert sorted(TWINS) == theirs
    for name, twins in TWINS.items():
        if isinstance(twins, Why):
            continue
        for twin in twins:
            assert twin.startswith("test_torch_") and (ROOT / "tests" / twin).is_file(), twin
