"""Nothing a run executes loads JAX or the JAX package: the top-level
module name (the part before the first dot) is compared whole, since the
port's name begins with the JAX package's."""

import ast
import subprocess
import sys
from pathlib import Path

from portbench import common

HERE = Path(__file__).resolve().parents[1]
SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


def imported_names(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    assert SOURCES
    for path in SOURCES:
        bad = imported_names(path) & set(common.FORBIDDEN_MODULES)
        assert not bad, (path, bad)
    # the port itself is imported, and its name is not the JAX package's
    assert "gs_tpu_torch" in imported_names(HERE / "traffic" / "fit.py")


def test_a_cells_code_loads_neither(tmp_path):
    """Import every module of the benchmark and of the port that a cell's
    run reaches, in a fresh interpreter, and list the loaded top-level
    names."""
    code = (
        "import sys, importlib\n"
        f"sys.path.insert(0, {str(HERE.parent)!r})\n"
        "from portbench import common, control, judge, roofline, scenes, spans\n"
        "from portbench.traffic import fit, viewer\n"
        "import portbench.run\n"
        "from portbench.reference import splat\n"
        "import gs_tpu_torch.training, gs_tpu_torch.viewer.network_gui, gs_tpu_torch.renderer\n"
        "import gs_tpu_torch.utils.ckpt, gs_tpu_torch.ops.autotune, gs_tpu_torch.cameras\n"
        "for w in common.manifest()['workloads']:\n"
        "    common.driver(common.cell(w['name']))\n"
        "    for m in common.cell(w['name']).per_layer:\n"
        "        common.metric_reader(m['name'])\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=tmp_path).stdout
    loaded = set(ast.literal_eval(out.strip().splitlines()[-1]))
    assert "gs_tpu_torch" in loaded
    assert not loaded & set(common.FORBIDDEN_MODULES), loaded & set(common.FORBIDDEN_MODULES)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "gs_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxlike", sys)
    assert not {"gs_tpu_torch_x", "jaxlike"} & set(common.forbidden_modules())
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax.numpy" in common.forbidden_modules()


def test_run_without_a_card_prints_no_result(tmp_path):
    """``run.py`` without a CUDA card exits non-zero with nothing on stdout."""
    proc = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload", "tandt-view",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=tmp_path,
                          env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "{" not in proc.stdout
