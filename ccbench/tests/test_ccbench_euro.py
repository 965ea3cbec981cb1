"""``euro-road.solve`` on the CPU in the tiny tree (its grid cut to the
tiny side, as every configuration there): correct, the metrics that
``usa-road.solve`` reports, untraced and traced, and its control not
correct."""
import pytest

import _ccbench_tiny as tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.tiny_tree(tmp_path_factory.mktemp("ccbench"))


@pytest.mark.parametrize("trace", [False, True])
def test_euro_road_solve_is_correct_with_usa_road_solves_metrics(root, trace):
    res = tiny.run(root, "euro-road.solve", trace=trace)
    usa = tiny.run(root, "usa-road.solve", trace=trace)
    assert res["correct"] is True
    assert res["checks"]["label_mismatches"] == {"value": 0, "limit": 0}
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == set(usa["metrics"])
    if trace:
        # 3 hook_ops an edge for the scan, 3 more for each cleanup round
        assert res["metrics"]["hook_ops_per_edge.solve"]["value"] >= 3


def test_euro_road_solve_control_is_not_correct(root):
    res = tiny.run(root, "euro-road.solve", control="truncated")
    assert res["correct"] is False
    assert res["checks"]["label_mismatches"]["value"] > 0
