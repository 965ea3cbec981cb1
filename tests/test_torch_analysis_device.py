"""The analysis entry points run on the card unless asked for the CPU,
as every entry point of the port does: ``graph_utils.trace``,
``runner.analyze``, ``runner.selftest`` and ``python -m
repro_torch.analysis`` default to CUDA and raise without it unless
given ``device="cpu"`` (``--device cpu``)."""
import pytest
import torch

from repro_torch.analysis import BUCKETS, analyze, selftest
from repro_torch.analysis import __main__ as cli
from repro_torch.analysis.fixtures import fixture_entries
from repro_torch.analysis.graph_utils import trace

SMALL = {"small": BUCKETS["small"]}


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _entry():
    return next(e for e in fixture_entries()
                if e.name == "fixture.masked_padded_sum")


@pytest.mark.parametrize("call", ("trace", "analyze", "selftest", "cli",
                                  "cli_selftest"))
def test_the_default_device_is_the_card(no_cuda, call):
    run = {"trace": lambda: trace(_entry(), BUCKETS["small"]),
           "analyze": lambda: analyze([_entry()], buckets=SMALL,
                                      run_astlint=False),
           "selftest": selftest,
           "cli": lambda: cli.main(["--entry", "queries.count"]),
           "cli_selftest": lambda: cli.main(["--selftest"])}[call]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run()


def test_asked_for_the_cpu_they_run_there(no_cuda, tmp_path):
    t = trace(_entry(), BUCKETS["small"], device="cpu")
    assert t.failure is None and t.device == "cpu"
    rep = analyze([_entry()], buckets=SMALL, run_astlint=False,
                  device="cpu")
    assert rep.entries_checked == ["fixture.masked_padded_sum"]
    assert not rep.findings
    assert cli.main(["--entry", "queries.count", "--device", "cpu",
                     "--json", str(tmp_path / "r.json")]) == 0
