"""Pass ``kernel-ast`` — source-level companion lint, the port of
``repro.analysis.astlint`` (its ``pallas-ast`` pass) with the rules
that carry over:

* **ops / ref / source triple** — every kernel package under
  ``repro_torch.kernels`` ships ``ops.py`` (the wrapper, a public
  function), ``ref.py`` (the plain version, a public function) and the
  ``csrc/<name>.cu`` its ``ops.py`` builds (each ``Kernel("<name>",
  ...)`` it declares names the source). The parity tests diff kernel
  against plain version; a package missing either half, or a wrapper
  naming a source that is not there, has nothing holding it to its
  semantics (errors ``kernel-missing-ops``, ``kernel-missing-ref``,
  ``kernel-missing-source``);
* **no facade bypass** — engine entry points (``solve_*``,
  ``build_distributed_cc``, ``IncrementalCC``, ``DynamicCC``) are
  imported only by ``repro_torch.core`` / ``api`` / ``analysis``;
  anything else under ``src/repro_torch`` importing them dodges the
  plan / registry layer the ``Solver`` contracts are enforced through
  (error ``facade-bypass``);
* **no JAX and no reference** — a module of the port that imports
  ``jax``, ``jaxlib``, ``ml_dtypes`` or anything of ``repro`` (error
  ``forbidden-import``): the card's machine has none of them.

The reference's other two rules have no counterpart: a CUDA launch's
grid is computed in C, not passed to ``pallas_call``, and the port uses
int64 on purpose wherever torch indexes.

Pure ``ast``: no imports of the linted modules, so a broken module
still gets linted. Findings anchor to real lines, so the standard
``# analysis: ok[kernel-ast]`` pragma applies.
"""
from __future__ import annotations

import ast
from pathlib import Path

from repro_torch.analysis.findings import Finding

PASS_ID = "kernel-ast"

_ENGINE_ENTRIES = {
    "solve_static", "solve_pallas", "solve_hostloop", "solve_batched",
    "solve_forest", "solve_sampled", "build_distributed_cc",
    "IncrementalCC", "DynamicCC",
}
_ENGINE_MODULES = ("repro_torch.core",)
# packages allowed to touch engine entries directly
_ENGINE_CLIENTS = ("src/repro_torch/core/", "src/repro_torch/api/",
                   "src/repro_torch/analysis/")
_FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")


def _rel(path: Path, root: Path) -> str:
    return path.relative_to(root).as_posix()


def _parse(path: Path):
    try:
        return ast.parse(path.read_text())
    except (OSError, SyntaxError):
        return None


def _has_public_function(tree) -> bool:
    return tree is not None and any(
        isinstance(n, ast.FunctionDef) and not n.name.startswith("_")
        for n in tree.body)


def _sources_built(tree) -> list:
    """(source name, line) of each ``Kernel("<source>", ...)`` call."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) == "Kernel" \
                and node.args and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            out.append((node.args[0].value, node.lineno))
    return out


def lint_kernel_package(pkg: Path, root: Path) -> list[Finding]:
    out = []
    rel = _rel(pkg, root)
    trees = {}
    for part in ("ops", "ref"):
        path = pkg / f"{part}.py"
        trees[part] = _parse(path) if path.exists() else None
        if not _has_public_function(trees[part]):
            out.append(Finding(
                PASS_ID, rel, "error", f"kernel-missing-{part}",
                f"kernel package has no public function in {part}.py — "
                "the kernel / plain-version parity contract requires the "
                "ops + ref pair",
                f"{rel}/{part}.py", 1))
    csrc = pkg.parent / "csrc"
    for source, line in _sources_built(trees["ops"]) if trees["ops"] \
            else []:
        if not (csrc / f"{source}.cu").exists():
            out.append(Finding(
                PASS_ID, rel, "error", "kernel-missing-source",
                f"ops.py builds `{source}`, but csrc/{source}.cu is not "
                "in the tree",
                f"{rel}/ops.py", line))
    return out


def lint_imports(path: Path, rel: str) -> list[Finding]:
    """The facade-bypass and forbidden-import rules of one file."""
    tree = _parse(path)
    if tree is None:
        return []
    client = rel.startswith(_ENGINE_CLIENTS)
    out = []
    for node in ast.walk(tree):
        mods, names = [], set()
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            mods = [node.module]
            names = {a.name for a in node.names}
        for mod in mods:
            if mod.split(".")[0] in _FORBIDDEN:
                out.append(Finding(
                    PASS_ID, rel, "error", "forbidden-import",
                    f"imports `{mod}`: the port loads neither JAX nor the "
                    "reference package",
                    rel, node.lineno))
        hit = names & _ENGINE_ENTRIES
        if hit and not client and any(
                m.startswith(_ENGINE_MODULES) for m in mods):
            out.append(Finding(
                PASS_ID, rel, "error", "facade-bypass",
                f"imports engine entry {sorted(hit)} from `{mods[0]}` "
                "outside repro_torch.core / api — go through "
                "`repro_torch.api` (Solver / BACKENDS) so plans, counters "
                "and contracts apply",
                rel, node.lineno))
    return out


def run(src_root: Path) -> list[Finding]:
    """Lint ``src/repro_torch`` under ``src_root`` (the repo root)."""
    pkg_root = src_root / "src" / "repro_torch"
    findings: list[Finding] = []
    kernels = pkg_root / "kernels"
    if kernels.is_dir():
        for pkg in sorted(p for p in kernels.iterdir() if p.is_dir()):
            if any(pkg.glob("*.py")):
                findings.extend(lint_kernel_package(pkg, src_root))
    for path in sorted(pkg_root.rglob("*.py")):
        findings.extend(lint_imports(path, _rel(path, src_root)))
    return findings
