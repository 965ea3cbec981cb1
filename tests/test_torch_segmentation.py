"""repro_torch's segmentation plans against the reference's, field by
field: ``plan_segmentation``, ``_plan_for`` and the plans a DeviceGraph
carries (padded graphs included). Integer planning: the tolerance is 0."""
import dataclasses

import numpy as np
import pytest

from _graphgen import corpus
from repro.core import segmentation as jseg
from repro.graphs import device as jdev
from repro_torch.core import segmentation as tseg
from repro_torch.graphs import device as tdev

EDGE_COUNTS = (0, 1, 7, 8, 9, 100, 1023, 1024, 4097)
NODE_COUNTS = (0, 1, 2, 13, 64, 1000)
SEGMENTS = (None, 1, 3, 7, 5000)
CASES = corpus()


def _fields(plan) -> dict:
    return dataclasses.asdict(plan)


@pytest.mark.parametrize("e", EDGE_COUNTS)
def test_plan_segmentation_matches_reference(e):
    for v in NODE_COUNTS:
        assert tseg.adaptive_num_segments(e, v) == \
            jseg.adaptive_num_segments(e, v)
        for s in SEGMENTS:
            got = tseg.plan_segmentation(e, v, s)
            assert _fields(got) == _fields(jseg.plan_segmentation(e, v, s))
            assert got.avg_degree == jseg.plan_segmentation(e, v, s).avg_degree


@pytest.mark.parametrize("e", EDGE_COUNTS)
def test_plan_for_matches_reference(e):
    for v in NODE_COUNTS:
        for true in sorted({e, e // 2, 0}):
            for s in SEGMENTS:
                assert _fields(tdev._plan_for(e, v, true, s)) == \
                    _fields(jdev._plan_for(e, v, true, s))


@pytest.mark.parametrize("name,n,edges", CASES, ids=[c[0] for c in CASES])
def test_device_graph_plans_match_reference(name, n, edges):
    jg = jdev.DeviceGraph.from_edges(edges, n)
    tg = tdev.DeviceGraph.from_edges(edges, n, device="cpu")
    assert _fields(tg.plan) == _fields(jg.plan)
    assert tg.degree_skew == jg.degree_skew
    assert (tg.num_edges, tg.density) == (jg.num_edges, jg.density)
    for jp, tp in ((jg.pad_pow2(), tg.pad_pow2()),
                   (jg.pad_rows(edges.shape[0] + 5),
                    tg.pad_rows(edges.shape[0] + 5))):
        assert _fields(tp.plan) == _fields(jp.plan)
        assert tp.true_edges == jp.true_edges_static
        np.testing.assert_array_equal(tp.edges.numpy(), np.asarray(jp.edges))


@pytest.mark.parametrize("s", (None, 1, 2, 5))
def test_as_device_graph_segment_override_matches_reference(s):
    _, n, edges = CASES[10]                       # er-mid
    jg = jdev.as_device_graph(edges, n, num_segments=s)
    tg = tdev.as_device_graph(edges, n, num_segments=s, device="cpu")
    assert _fields(tg.plan) == _fields(jg.plan)
    jg2 = jdev.as_device_graph(jg, num_segments=3)
    tg2 = tdev.as_device_graph(tg, num_segments=3)
    assert _fields(tg2.plan) == _fields(jg2.plan)
