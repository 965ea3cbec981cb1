"""The share of the traced window's delete seconds (the Solver.delete
spans, each ending in a synchronise) spent in deletes that the policy
routed to the maintained spanning forest (``tombstone-delete-forest``),
in percent; the rest went to the scoped recompute. Nothing when the
window deleted nothing."""

FOREST = "tombstone-delete-forest"


def read(ctx):
    by_route = ctx["counters"].get("delete_s_by_route") or {}
    total = sum(by_route.values())
    return 100.0 * by_route.get(FOREST, 0.0) / total if total > 0 else None
