"""repro_torch.analysis's passes, on the CPU: every seeded-bug fixture
fires at its bucket and every clean twin stays quiet; the int32 edge
key flags at the scale bucket only, as the reference's int32 pass does
on its own fixture; suppression pragmas and the baseline round-trip,
and the reference's ``load_baseline`` reads the port's file; the
recorder sees host reads, data-dependent shapes and host-built
constants; the AST lint on synthetic sources."""
import json

import pytest
import torch

from repro.analysis import analyze as janalyze
from repro.analysis.findings import load_baseline as jload_baseline
from repro.analysis.fixtures import fixture_entries as jfixture_entries
from repro_torch.analysis import BUCKETS, analyze, selftest
from repro_torch.analysis import astlint
from repro_torch.analysis.findings import (Finding, apply_suppressions,
                                           load_baseline, write_baseline)
from repro_torch.analysis.fixtures import CLEAN, EXPECTED, fixture_entries
from repro_torch.analysis.graph_utils import repo_root, trace, untraced
from repro_torch.api.registry import TraceEntry, VarInfo

from _threads import one_thread  # noqa: F401  (the scale bucket)

SMALL = {"small": BUCKETS["small"]}
SCALE = {"scale": BUCKETS["scale"]}
_TF = frozenset({"transfer_free", "bucketed"})


def _fixture(name):
    return next(e for e in fixture_entries() if e.name == name)


def _codes(report):
    return {(f.pass_id, f.code) for f in report.findings}


def test_fixture_tables_match_the_reference_and_the_registry():
    names = {e.name for e in fixture_entries()}
    assert names == {e.name for e in jfixture_entries()}
    assert set(EXPECTED) <= names and CLEAN <= names
    assert not (set(EXPECTED) & CLEAN)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_every_expected_fixture_fires_at_its_bucket(name):
    pass_id, code, where = EXPECTED[name]
    buckets = SCALE if where == "scale" else SMALL
    rep = analyze([_fixture(name)], buckets=buckets, run_astlint=False,
                  device="cpu")
    assert (pass_id, code) in _codes(rep), [f.render() for f in rep.findings]
    hit = next(f for f in rep.findings if f.code == code)
    assert hit.severity == "error" and hit.entry == name


@pytest.mark.parametrize("name", sorted(CLEAN))
def test_every_clean_twin_is_quiet_at_both_buckets(name):
    rep = analyze([_fixture(name)], run_astlint=False, device="cpu")
    assert not rep.findings, [f.render() for f in rep.findings]


def test_int32_edge_key_flags_at_scale_only_as_the_references_does():
    """Quiet at the reference's small bucket (1024, 4096), flagged at its
    scale bucket (2^20, 2^22), anchored at the packed key's line."""
    entry = _fixture("fixture.int32_edge_key")
    at_small = analyze([entry], buckets=SMALL, run_astlint=False,
                       device="cpu")
    at_scale = analyze([entry], buckets=SCALE, run_astlint=False,
                       device="cpu")
    assert ("int32", "mul-overflow") not in _codes(at_small)
    assert ("int32", "mul-overflow") in _codes(at_scale)
    f = next(f for f in at_scale.findings if f.code == "mul-overflow")
    assert f.file == "src/repro_torch/analysis/fixtures.py"
    line = (repo_root() / f.file).read_text().splitlines()[f.line - 1]
    assert "lo * v + hi" in line
    assert BUCKETS == {"small": (1024, 4096), "scale": (1 << 20, 1 << 22)}


def test_selftest_is_green():
    assert selftest(device="cpu") == []


def test_recorder_sees_reads_dynamic_shapes_and_host_constants():
    def build(v, e):
        def fn(edges, true_edges):
            with untraced():
                edges.sum().item()          # setup: not recorded
            n = int(edges[0, 0])            # __int__
            keep = edges[:, 0] > 3
            picked = edges[keep]            # a mask index: data-dependent
            table = torch.as_tensor(range(e))      # an arange: exempt
            big = torch.tensor([1] * (1 << 19))    # 4 MiB of int64
            return n, picked, table, big
        return (fn, (torch.empty((e, 2), dtype=torch.int32, device="meta"),
                     e), [VarInfo(range=(0, v - 1)),
                          VarInfo(range=(0, e), mask=True)])
    entry = TraceEntry("probe", build, _TF)
    t = trace(entry, BUCKETS["small"], device="cpu")
    assert t.failure is None
    assert [h.method for h in t.record.host if h.kind == "read"] == \
        ["__int__"]
    rep = analyze([entry], buckets=SMALL, run_astlint=False, device="cpu")
    codes = _codes(rep)
    assert {("transfer", "host-read-__int__"),
            ("transfer", "dynamic-shape-index"),
            ("transfer", "dynamic-shape-_local_scalar_dense"),
            ("transfer", "large-host-put"),
            ("retrace", "python-scalar-arg1"),
            ("retrace", "large-captured-const")} <= codes, codes
    consts = [f for f in rep.findings if f.code == "large-captured-const"]
    assert len(consts) == 1 and "4096 KiB" in consts[0].message


def test_a_failing_entry_is_reported():
    def build(v, e):
        def fn(x):
            raise ValueError("boom")
        return fn, (torch.empty((8,), device="meta"),), [VarInfo()]
    rep = analyze([TraceEntry("broken", build, _TF)], buckets=SMALL,
                  run_astlint=False, device="cpu")
    assert ("transfer", "trace-failed") in _codes(rep)
    assert "boom" in rep.findings[0].message


# ---------------------------------------------------------------------------
# Suppression pragmas + baseline gating
# ---------------------------------------------------------------------------

def test_suppression_pragma_round_trip(tmp_path):
    src = tmp_path / "mod.py"
    src.write_text(
        "x = 1\n"
        "y = overflowing_thing()  # analysis: ok[int32]\n"
        "z = other_thing()\n")
    anchored = Finding("int32", "e", "error", "mul-overflow", "m",
                       "mod.py", 2)
    wrong_pass = Finding("padmask", "e", "error", "c", "m", "mod.py", 2)
    unanchored = Finding("int32", "e", "error", "c", "m", "mod.py", 3)
    kept, suppressed = apply_suppressions(
        [anchored, wrong_pass, unanchored], tmp_path)
    assert suppressed == [anchored]          # pragma is pass-scoped
    assert kept == [wrong_pass, unanchored]
    src.write_text("# analysis: ok[int32, padmask]\nq = thing()\n")
    above = Finding("padmask", "e", "error", "c", "m", "mod.py", 2)
    kept, suppressed = apply_suppressions([above], tmp_path)
    assert suppressed == [above]


def test_baseline_round_trip_and_the_reference_reads_it(tmp_path):
    rep = analyze([_fixture("fixture.unmasked_padded_sum")],
                  buckets=SMALL, run_astlint=False, device="cpu")
    assert rep.findings
    path = tmp_path / "baseline.json"
    write_baseline(path, rep)
    keys = load_baseline(path)
    assert keys == {f.key for f in rep.findings}
    assert rep.new_vs(keys) == []            # baselined == not new
    assert json.loads(path.read_text())["keys"] == sorted(keys)
    assert jload_baseline(path) == keys
    # and the reference's findings' report format round-trips the same
    jrep = janalyze([], run_astlint=False)
    assert jrep.to_json().keys() == rep.to_json().keys()


def test_finding_key_is_line_stable():
    a = Finding("int32", "e", "error", "c", "msg 123", "f.py", 10)
    b = Finding("int32", "e", "error", "c", "msg 456", "f.py", 99)
    assert a.key == b.key


# ---------------------------------------------------------------------------
# The AST lint on synthetic sources
# ---------------------------------------------------------------------------

def _package(root, name, ops=True, ref=True, source=True):
    pkg = root / "src" / "repro_torch" / "kernels" / name
    pkg.mkdir(parents=True)
    (root / "src" / "repro_torch" / "kernels" / "csrc").mkdir(exist_ok=True)
    if ops:
        (pkg / "ops.py").write_text(
            f'K = Kernel("{name}", "sym", [])\n\ndef run(x):\n    return x\n')
    if ref:
        (pkg / "ref.py").write_text("def ref_run(x):\n    return x\n")
    if source:
        (root / "src" / "repro_torch" / "kernels" / "csrc" /
         f"{name}.cu").write_text("// kernel\n")
    return pkg


def test_astlint_flags_a_kernel_package_missing_a_part(tmp_path):
    _package(tmp_path, "good")
    _package(tmp_path, "noref", ref=False)
    _package(tmp_path, "noops", ops=False)
    _package(tmp_path, "nosrc", source=False)
    found = {(f.entry.rsplit("/", 1)[-1], f.code)
             for f in astlint.run(tmp_path)}
    assert found == {("noref", "kernel-missing-ref"),
                     ("noops", "kernel-missing-ops"),
                     ("nosrc", "kernel-missing-source")}


def test_astlint_flags_facade_bypass_and_forbidden_imports(tmp_path):
    f = tmp_path / "rogue.py"
    f.write_text("from repro_torch.core.cc import solve_static\n"
                 "import jax.numpy as jnp\n"
                 "from repro.core import cc\n")
    hits = astlint.lint_imports(f, "src/repro_torch/bench/rogue.py")
    assert [(h.code, h.line) for h in hits] == [
        ("facade-bypass", 1), ("forbidden-import", 2),
        ("forbidden-import", 3)]
    # engine packages themselves may import engine entries
    assert [h.code for h in astlint.lint_imports(
        f, "src/repro_torch/api/rogue.py")] == ["forbidden-import"] * 2


def test_real_tree_astlint_is_quiet_outside_suppressions():
    findings = astlint.run(repo_root())
    kept, suppressed = apply_suppressions(findings, repo_root())
    assert not kept, [f.render() for f in kept]
    assert {f.code for f in suppressed} == {"facade-bypass"}
