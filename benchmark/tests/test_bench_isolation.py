"""The benchmark loads neither JAX nor the JAX package, its yardstick takes
nothing from the program, and a run exits with no result where it cannot
measure."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "deflicker_tpu")
# the yardstick: none of it may import the measured program
STANDALONE = ("reference", "counts", "data", "core")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_module_imports_jax_or_the_jax_package():
    bad = [f"{p.relative_to(ROOT)}: {n}" for p in BENCH.rglob("*.py")
           for n in _imports(p) if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_the_yardstick_imports_nothing_of_the_program():
    bad = [f"{p.relative_to(ROOT)}: {n}" for d in STANDALONE
           for p in (BENCH / d).rglob("*.py") for n in _imports(p)
           if n.split(".")[0] == "deflicker_torch"]
    assert not bad, bad


def test_the_flow_layer_reaches_a_model_only_through_its_module():
    """The flow driver, the calibration and the flow readers import nothing
    of one flow model: they reach it through `benchmark.flowmodels`, so a
    second model is new files."""
    files = [BENCH / "drivers" / "flow.py", BENCH / "calibrate.py",
             *(BENCH / "metrics").glob("*.flow.py")]
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names]
                names += [node.module] if getattr(node, "module", None) else []
                bad += [f"{path.name}: {n}" for n in names
                        if any(part in ("raft", "gma") for part in n.split("."))]
    assert not bad, bad


def test_whole_top_level_names_are_compared():
    from benchmark import run

    sys.modules["deflicker_tpu_lookalike"] = sys.modules["json"]
    try:
        assert "deflicker_tpu_lookalike" not in run.forbidden_modules()
    finally:
        del sys.modules["deflicker_tpu_lookalike"]
    assert all(m.split(".")[0] in FORBIDDEN for m in run.forbidden_modules())


def test_importing_every_module_and_the_program_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import benchmark, deflicker_torch.atlas, deflicker_torch.flow\n"
        "for m in pkgutil.walk_packages(benchmark.__path__, 'benchmark.'):\n"
        "    if '.tests' not in m.name:\n"
        "        importlib.import_module(m.name)\n"
        "from benchmark import run\n"
        "print(json.dumps(run.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", "import json\n" + code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _run(cwd: Path, *extra):
    return subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "single-fit",
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})


def test_no_result_without_a_card():
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_no_result_from_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
