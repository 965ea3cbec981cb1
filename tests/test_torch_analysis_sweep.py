"""repro_torch.analysis's sweep, on the CPU: every port ``BACKENDS`` key
has a trace entry; the entry names and contracts equal the reference's
``all_entries()``; the sweep groups of ``tests/_analysis_sweep.py``
cover every entry once, and the service group (the ticks) is clean at
both buckets against the committed ``analysis_baseline_torch.json``
(the other groups: ``test_torch_analysis_sweep_<group>.py``);
``python -m repro_torch.analysis`` sweeps with the AST
lint, carrying the audited facade-bypass suppressions, and exits 0; its
selftest exits 0 and a new finding exits 1."""
import json

from repro.analysis.entries import all_entries as jall_entries
from repro_torch.analysis import __main__ as cli
from repro_torch.analysis import runner as runner_mod
from repro_torch.analysis.entries import all_entries
from repro_torch.analysis.fixtures import fixture_entries
from repro_torch.api.registry import BACKENDS

from _analysis_sweep import GROUPS, check_group_is_clean, group_entries
from _threads import one_thread  # noqa: F401


def test_every_backend_has_a_trace_entry():
    covered = {e.backend for e in all_entries() if e.backend}
    assert covered == set(BACKENDS), (
        f"backends without a trace spec: {set(BACKENDS) - covered}")
    assert len(BACKENDS) == 14


def test_entry_names_and_contracts_equal_the_references():
    got = {e.name: (e.contracts, e.backend) for e in all_entries()}
    want = {e.name: (e.contracts, e.backend) for e in jall_entries()}
    assert got == want
    assert len(got) == 33


def test_sweep_groups_cover_every_entry_once():
    names = [e.name for g in GROUPS for e in group_entries(g)]
    assert sorted(names) == sorted(e.name for e in all_entries())


def test_sweep_group_is_clean_vs_committed_baseline():
    check_group_is_clean("service")


def test_cli_sweep_exits_zero_with_the_audited_suppressions(tmp_path):
    """The CLI over the query and fleet entries, with
    the AST lint: exit 0 against the baseline, the two audited
    facade-bypass imports suppressed by their pragmas."""
    out = tmp_path / "report.json"
    assert cli.main(["--entry", "queries.", "--entry", "fleet.",
                     "--json", str(out), "--device", "cpu"]) == 0
    report = json.loads(out.read_text())
    assert len(report["entries"]) == 7
    assert set(report["passes"]) == {"transfer", "int32", "retrace",
                                     "padmask", "kernel-ast"}
    assert report["findings"] == []
    bypass = [f for f in report["suppressed"]
              if f["code"] == "facade-bypass"]
    assert {f["file"] for f in bypass} == {"src/repro_torch/__init__.py",
                                           "src/repro_torch/launch/steps.py"}


def test_cli_selftest_exits_zero(capsys):
    assert cli.main(["--selftest", "--device", "cpu"]) == 0
    assert "all seeded fixtures caught" in capsys.readouterr().out


def test_cli_gates_on_new_findings(tmp_path, capsys, monkeypatch):
    """Empty baseline + a seeded violation => exit 1 and a NEW line;
    baselining the same report => exit 0."""
    bad = next(e for e in fixture_entries()
               if e.name == "fixture.unmasked_padded_sum")
    orig = runner_mod.analyze

    def patched(entries=None, **kw):
        kw.setdefault("run_astlint", False)
        return orig([bad], buckets={"small": (1024, 4096)}, **kw)
    monkeypatch.setattr(cli, "analyze", patched)
    baseline = tmp_path / "b.json"
    assert cli.main(["--baseline", str(baseline), "--device", "cpu"]) == 1
    assert "NEW error[padmask]" in capsys.readouterr().out
    assert cli.main(["--baseline", str(baseline), "--write-baseline",
                     "--device", "cpu"]) == 0
    assert cli.main(["--baseline", str(baseline), "--device", "cpu"]) == 0
    assert cli.main(["--entry", "no-such-entry", "--device", "cpu"]) == 2
