"""What the benchmark's modules may import: nothing of JAX, of the
reference package ``repro`` or of the JAX benchmark folder, compared by
whole top-level name (``repro_torch`` begins with ``repro``); the plain
reference and the generators nothing of the program either. And a run
without a card fails, printing no result."""
import ast
import json
import subprocess
import sys

import pytest
import torch

import _ccbench_tiny as tiny

BENCH = tiny.ROOT / "ccbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
HARNESS_FILES = sorted(p for p in BENCH.rglob("*.py")
                       if "tests" not in p.relative_to(BENCH).parts)


def top_level_imports(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", HARNESS_FILES,
                         ids=[str(p.relative_to(BENCH)) for p in HARNESS_FILES])
def test_no_harness_module_imports_jax_or_repro(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("name", ["reference.py", "generators/grid_road.py",
                                  "generators/rmat.py"])
def test_reference_and_generators_import_nothing_of_the_program(name):
    assert top_level_imports(BENCH / name) <= {"__future__", "torch"}


def test_whole_names_are_compared():
    # the harness runs the port, whose name begins with the reference's
    names = top_level_imports(BENCH / "harness.py")
    assert "repro_torch" in names and not names & FORBIDDEN


def test_a_run_loads_no_forbidden_module(tmp_path):
    root = tiny.tiny_tree(tmp_path)
    code = (
        "import sys, time, json\n"
        f"sys.path[:0] = [{str(tiny.ROOT / 'src')!r}, {str(tiny.ROOT)!r}]\n"
        "from pathlib import Path\n"
        "from ccbench import harness\n"
        f"root = Path({str(root)!r})\n"
        "for cell in ('usa-road.solve', 'kron-logn21.churn'):\n"
        "    for trace in (False, True):\n"
        "        harness.run_cell(root, cell, 3, 0.2, trace, 'cpu',\n"
        "                         time.perf_counter())\n"
        "print(json.dumps(harness.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    assert json.loads(out.strip().splitlines()[-1]) == []


def test_forbidden_modules_reads_whole_names(monkeypatch):
    from ccbench import harness
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    assert "repro_torch_fake" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.fake", object())
    assert harness.forbidden_modules() == ["repro.fake"]


def test_run_without_a_card_fails_with_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run the cell")
    proc = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "usa-road.solve", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tiny.ROOT)
    assert proc.returncode != 0
    assert "{" not in proc.stdout
