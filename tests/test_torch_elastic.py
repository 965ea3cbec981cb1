"""repro_torch's elastic rescale against the reference's
(``repro.launch.elastic``), on the CPU: ``ElasticController`` decides as
the reference does on one sequence of (step, healthy hosts, slow
streak); ``reshard_plan`` gives the reference's tree; a state saved and
rescaled onto a CPU mesh comes back bit-equal; a checkpoint the
reference wrote restores through the port's ``rescale``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh, PartitionSpec as P

from repro.configs import get_arch as jget
from repro.launch import elastic as jel
from repro.models.gnn import gin as JI
from repro.train import checkpoint as jck
from repro.train import train_state as jts
from repro.train.optimizer import AdamWConfig as JAdamWConfig, \
    adamw as jadamw
from repro_torch.configs import get_arch as tget
from repro_torch.launch import elastic as tel
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.gnn import gin as TI
from repro_torch.train import checkpoint as tck
from repro_torch.train import train_state as tts
from repro_torch.train.optimizer import AdamWConfig, adamw, named


def _events(n: int = 400, seed: int = 0) -> list:
    """(step, healthy hosts, slow streak): steps that advance by 1-60,
    host counts that drop and return, straggler streaks of 0-5."""
    rng = np.random.default_rng(seed)
    steps = np.cumsum(rng.integers(1, 60, n))
    hosts = np.clip(16 - np.abs(rng.normal(0, 5, n)).astype(int), 1, 16)
    streak = rng.integers(0, 6, n)
    return [(int(s), int(h), int(k)) for s, h, k in zip(steps, hosts,
                                                           streak)]


@pytest.mark.parametrize("width,gap", [(16, 100), (8, 10), (1, 0)])
def test_elastic_controller_decides_as_the_reference(width, gap):
    want = jel.ElasticController(dp_width=width, min_steps_between=gap)
    got = tel.ElasticController(dp_width=width, min_steps_between=gap)
    decisions = 0
    for step, hosts, streak in _events():
        w = want.decide(step, healthy_hosts=hosts, slow_streak=streak)
        assert got.decide(step, healthy_hosts=hosts,
                          slow_streak=streak) == w, (step, hosts, streak)
        assert got.dp_width == want.dp_width
        decisions += w is not None
    assert decisions > 5


def test_elastic_controller_policy():
    c = tel.ElasticController(dp_width=16, min_steps_between=10)
    assert c.decide(100, healthy_hosts=16) is None      # no change
    assert c.decide(200, healthy_hosts=9) == 8          # shrink
    assert c.decide(205, healthy_hosts=16) is None      # hysteresis
    assert c.decide(400, healthy_hosts=16) == 16        # recover
    assert c.decide(500, healthy_hosts=16, slow_streak=3) == 8  # straggler


def _reference_state(seed: int = 2) -> dict:
    """gin-tu's smoke TrainState as the reference makes it, with random
    moments and step 7 (host arrays)."""
    jcfg = jget("gin-tu").make_smoke_config()
    params = JI.init(jax.random.PRNGKey(0), jcfg)
    state = jax.tree.map(np.asarray, jts.create(params,
                                                jadamw(JAdamWConfig())))
    rng = np.random.default_rng(seed)
    for key in ("m", "v"):
        state["opt"][key] = jax.tree.map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32),
            state["opt"][key])
    state["step"] = np.int32(7)
    return state


def _port_state() -> dict:
    cfg = tget("gin-tu").make_smoke_config()
    return tts.create(TI.init(cfg, device="cpu", requires_grad=True),
                      adamw(AdamWConfig()))


def _paths(tree) -> set:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path) for path, _ in leaves}


def test_reshard_plan_gives_the_reference_tree():
    """The same keys, the same leaves by name (the reference's paths
    joined by dots), every leaf on the target mesh's device."""
    ref = _reference_state()
    jmesh = JMesh(np.asarray(jax.devices()[:1]), ("data",))
    specs = jax.tree.map(lambda _: P(), ref["params"])
    want = jel.reshard_plan(ref, jmesh, specs)
    state = _port_state()
    got = tel.reshard_plan(state, make_mesh(2, device="cpu"))
    assert got.keys() == want.keys() == {"params", "opt", "step"}
    assert got["opt"].keys() == want["opt"].keys() == {"m", "v"}
    assert set(got["params"]) == _paths(want["params"])
    for key in ("m", "v"):
        assert set(got["opt"][key]) == _paths(want["opt"][key])
    dev = torch.device("cpu")
    leaves = [got["step"], *got["params"].values(),
              *(d for k in ("m", "v") for d in got["opt"][k].values())]
    assert all(d == dev for d in leaves)


def _randomized(state: dict) -> dict:
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for t in [*named(state["params"]).values(),
                  *state["opt"]["m"].values(), *state["opt"]["v"].values()]:
            t.copy_(torch.randn(t.shape, generator=g))
        state["step"].fill_(11)
    return state


def test_rescale_round_trip_on_the_cpu_is_bit_equal(tmp_path):
    state = _randomized(_port_state())
    tck.save(str(tmp_path), state, 11)
    back = tel.rescale(str(tmp_path), state, make_mesh(1, device="cpu"))
    assert back is not state
    assert int(back["step"]) == 11 and back["step"].dtype == torch.int32
    for key in ("m", "v"):
        for n, t in state["opt"][key].items():
            assert torch.equal(back["opt"][key][n], t), (key, n)
    got = named(back["params"])
    for n, t in named(state["params"]).items():
        assert got[n].requires_grad and got[n].dtype == t.dtype
        assert torch.equal(got[n].detach(), t.detach()), n


def test_reference_checkpoint_restores_through_rescale(tmp_path):
    """A TrainState the reference saved restores through the port's
    ``rescale`` into every leaf's bits, as ``state_from_reference``
    carries it."""
    ref = _reference_state()
    jck.save(str(tmp_path), jax.tree.map(jnp.asarray, ref), 7)
    tcfg = tget("gin-tu").make_smoke_config()
    back = tel.rescale(str(tmp_path), _port_state(),
                       make_mesh(1, device="cpu"))
    want = TI.state_from_reference(ref, tcfg, adamw(AdamWConfig()),
                                   device="cpu")
    assert int(back["step"]) == 7
    for key in ("m", "v"):
        assert back["opt"][key].keys() == want["opt"][key].keys()
        for n, t in want["opt"][key].items():
            assert torch.equal(back["opt"][key][n], t), (key, n)
    got = named(back["params"])
    for n, t in named(want["params"]).items():
        assert torch.equal(got[n].detach(), t.detach()), n
