"""repro_torch's ``Solver`` against repro.api's on the usa-osm stand-in
at scale 0.002: the same plan, and equal labels and WorkCounters on
every registered backend (``tests/_api_common.py``)."""
import pytest

from _api_common import GRAPHS, solver_plans_and_solves_match_reference

CASES = [g for g in GRAPHS if g[0] in ("usa-osm@0.002",)]


@pytest.mark.parametrize("name,n,edges", CASES,
                         ids=[g[0] for g in CASES])
def test_solver_plans_and_solves_match_reference(name, n, edges):
    solver_plans_and_solves_match_reference(name, n, edges)
