"""repro_torch's ``cc-adaptive`` cell against repro.launch.steps: the
cell's argument spec equals the reference's ``cc_graphs.input_specs``
padded to ``per * n_shards`` rows for every Table I shape and slot
count, building it allocates nothing, and its step (on a shrunken spec)
gives the reference cell's labels and the oracle's. Integer work: the
tolerance is exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import cc_graphs as jcfg
from repro.graphs import generators as jgen
from repro.launch import steps as jsteps
from repro_torch.configs import cc_graphs as tcfg
from repro_torch.core.unionfind import connected_components_oracle
from repro_torch.graphs import generators as tgen
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import make_mesh


def _ref_mesh():
    """A one-device reference mesh over the cell's axes."""
    return jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))


def test_cc_config_matches_reference():
    assert (tcfg.ARCH_ID, tcfg.FAMILY, tcfg.SHAPES) == \
        (jcfg.ARCH_ID, jcfg.FAMILY, jcfg.SHAPES)
    for shape in jcfg.SHAPES:
        want, got = jcfg.input_specs(shape), tcfg.input_specs(shape)
        assert got["num_nodes"] == want["num_nodes"]
        assert got["edges"] == (tuple(want["edges"].shape), torch.int32)
        assert want["edges"].dtype == jnp.int32
        assert tcfg.step_kind(shape) == jcfg.step_kind(shape) == "cc"
        assert tcfg.skip_reason(shape) is jcfg.skip_reason(shape) is None


@pytest.mark.parametrize("k", (1, 3, 8))
@pytest.mark.parametrize("shape", jcfg.SHAPES)
def test_cc_cell_specs_match_reference_after_padding(shape, k):
    cell = tsteps.build_cell("cc-adaptive", shape,
                             mesh=make_mesh(k, device="cpu"))
    e = jcfg.input_specs(shape)["edges"].shape[0]
    per = -(-e // k)
    assert (cell.arch, cell.shape, cell.kind) == ("cc-adaptive", shape, "cc")
    assert cell.args == (((per * k, 2), torch.int32),)
    assert cell.step.engine.rows == per * k
    if k == 1:
        want = jsteps.build_cell("cc-adaptive", shape, _ref_mesh())
        assert cell.args[0][0] == tuple(want.args[0].shape)
        assert want.args[0].dtype == jnp.int32


def test_cc_cell_defaults_to_one_slot_and_refuses_cpu_fallback(monkeypatch):
    cell = tsteps.build_cell("cc-adaptive", "usa-osm", device="cpu")
    assert cell.step.engine.slots == (torch.device("cpu"),)
    with pytest.raises(ValueError, match="mesh= is for the cc-adaptive"):
        tsteps.build_cell("dcn-v2", "serve_p99", device="cpu",
                          mesh=make_mesh(2, device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsteps.build_cell("cc-adaptive", "usa-osm")


@pytest.mark.parametrize("k", (1, 2, 5))
def test_cc_cell_step_matches_reference_cell(monkeypatch, k):
    """Both cells on one shrunken usa-osm spec (a grid road stand-in of
    |V| 400, padded with (0, 0) rows to the spec's 1,000): the port's
    step on host edges against the reference cell's step on the padded
    edges, and the oracle."""
    g = tgen.grid_road(20, extra_prob=0.02, seed=1, name="usa-osm")
    jg = jgen.grid_road(20, extra_prob=0.02, seed=1, name="usa-osm")
    spec = (g.num_nodes, 1000, 2.41, "road")
    monkeypatch.setitem(tgen.TABLE1_FULL, "usa-osm", spec)
    monkeypatch.setitem(jgen.TABLE1_FULL, "usa-osm", spec)
    cell = tsteps.build_cell("cc-adaptive", "usa-osm",
                             mesh=make_mesh(k, device="cpu"))
    got = cell.step(g.edges)
    assert got.device.type == "cpu" and got.dtype == torch.int32
    want = connected_components_oracle(g.edges, g.num_nodes)
    np.testing.assert_array_equal(got.numpy(), want)
    jcell = jsteps.build_cell("cc-adaptive", "usa-osm", _ref_mesh())
    padded = np.zeros(jcell.args[0].shape, np.int32)
    padded[:jg.num_edges] = jg.edges
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jcell.step(jnp.asarray(padded))))
    assert 1 <= cell.step.engine.last_rounds <= 8
    with pytest.raises(ValueError, match="exceed the cell's"):
        cell.step(np.zeros((cell.args[0][0][0] + 1, 2), np.int32))
