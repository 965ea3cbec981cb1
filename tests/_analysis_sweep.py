"""The sweep of ``repro_torch.analysis`` split by entry group, so that
each ``tests/test_torch_analysis_sweep*.py`` runs one group at both
buckets on one worker: the scale bucket runs the engines on real
inputs of 2^22 edges, some minutes of host time in all. The files take
``_threads.one_thread``: the sweep's large CPU ops would otherwise take
every core from the other test workers."""
from repro_torch.analysis import analyze
from repro_torch.analysis.entries import all_entries
from repro_torch.analysis.findings import load_baseline
from repro_torch.analysis.graph_utils import repo_root

# entry-name prefixes of each group: together every entry, once; a
# group ~50 s of one thread at most here (the scale bucket's heaviest
# entries alone: the batched scan's, the fused scan's and the forest
# deletes' plain versions on 2^22 edges)
GROUPS = {
    "service": ("service.",),
    "service_forest": ("service.tick.delete_forest",),
    "obs": ("obs.", "queries.", "fleet."),
    "static": ("backend.soman", "backend.multijump", "backend.atomic_hook",
               "backend.adaptive", "backend.labelprop", "backend.pallas"),
    "fused": ("backend.pallas_fused",),
    "dynamic": ("backend.dynamic.absorb", "backend.dynamic.delete",
                "backend.incremental."),
    "forest": ("backend.dynamic.delete_forest",),
    "batched": ("backend.batched",),
    "sampled": ("backend.sampled", "backend.hostloop.",
                "backend.distributed"),
}


def group_entries(group: str) -> list:
    """The entries of ``group``: their names start with one of its
    prefixes, and with none of a longer prefix another group holds."""
    mine = GROUPS[group]
    other = [q for g, ps in GROUPS.items() if g != group for q in ps]

    def owner(name: str) -> bool:
        best = max((q for q in mine + tuple(other) if name.startswith(q)),
                   key=len, default=None)
        return best in mine
    return [e for e in all_entries() if owner(e.name)]


def check_group_is_clean(group: str) -> None:
    """Every entry of ``group`` at both buckets, every pass but the AST
    lint: no finding beyond ``analysis_baseline_torch.json``, and none
    of the contracts but transfer-freedom broken."""
    entries = group_entries(group)
    assert entries
    rep = analyze(entries, run_astlint=False)
    baseline = load_baseline(repo_root() / "analysis_baseline_torch.json")
    new = rep.new_vs(baseline)
    assert not new, "NEW findings:\n" + "\n".join(f.render() for f in new)
    assert rep.entries_checked == sorted(e.name for e in entries)
    codes = {f.code for f in rep.findings}
    assert not any(c.endswith("-overflow") or c in (
        "unmasked-padded-sum", "trace-failed") for c in codes), codes
