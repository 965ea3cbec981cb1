"""The fused group of the analysis sweep (``tests/_analysis_sweep.py``):
every entry at both buckets is clean against
``analysis_baseline_torch.json``."""
from _analysis_sweep import check_group_is_clean
from _threads import one_thread  # noqa: F401


def test_sweep_group_is_clean_vs_committed_baseline():
    check_group_is_clean("fused")
