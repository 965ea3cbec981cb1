"""repro_torch.analysis — invariant checking over recorded runs, the
port of ``repro.analysis``.

Every registered backend (plus the service tick, the instrumented tick,
the query kernels and the fleet's batched queries) runs once under a
recording mode at two shape buckets, and its record is held to the
repo's contracts: transfer-freedom on tick paths, int32 range safety at
scale-tier shapes, pow2 bucket hygiene, and the padding-mask
discipline; plus an AST-level lint of the kernel packages and the
facade boundaries. ``python -m repro_torch.analysis`` is the gate,
against ``analysis_baseline_torch.json``.
"""
from repro_torch.analysis.findings import (PASS_IDS, Finding, Report,
                                           load_baseline, write_baseline)
from repro_torch.analysis.runner import BUCKETS, analyze, selftest

__all__ = ["PASS_IDS", "Finding", "Report", "load_baseline",
           "write_baseline", "BUCKETS", "analyze", "selftest"]
