"""repro_torch's GNN training against the reference's, on the CPU: the
configs (shapes, specs, configs of every shape), the train cells
(built without allocating), whole AdamW steps of all four GNNs from a
carried reference TrainState. The launcher with a restart is in
``test_torch_gnn_launcher*.py``.

AdamW steps (float32), each from the same carried state on both sides:
loss and grad norm within 1e-6 relative (the same fp32 terms in other
orders); m within 1e-5 of its largest |value| and v within 2e-5 (the
gradient's 1e-5 of its leaf's largest carried into m = b1 m + (1 - b1)
g and v = b2 v + (1 - b2) g^2); a parameter within the move those errors
make in the update lr m^ / (sqrt(v^) + eps), worked out element by
element from the reference's m and v, plus its own ulp, as in
``tests/test_torch_lm_train.py``. The reference's AdamW decays every
leaf with ``ndim >= 2``: with the layers stacked as the reference
stacks them, that is GatedGCN's layer biases and LayerNorm weights and
NequIP's ``radial.b1`` and ``gate_b`` too, and the parameter gate
would miss a skipped decay.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget
from repro.configs import gnn_common as JGC
from repro.launch import train as jlaunch
from repro.train import train_state as jts
from repro.train.optimizer import AdamWConfig as JAdamWConfig, \
    adamw as jadamw
from repro_torch.configs import get_arch as tget
from repro_torch.configs import gnn_common as TGC
from repro_torch.launch import steps
from repro_torch.launch import train as launch_train
from repro_torch.models.gnn import model_of
from repro_torch.train.optimizer import AdamWConfig, adamw, named

from test_torch_gnn import MODS, _j, _np, port_leaves, reference_tree

ARCHS = tuple(MODS)
DTYPES = {jnp.float32: torch.float32, jnp.int32: torch.int32}


def _batch(arch: str, cfg, i: int) -> dict:
    """Step ``i``'s batch: the launcher's smoke stream, GraphSAGE's as
    layered blocks (its ``forward_sampled``)."""
    b = launch_train._gnn_batch(arch, cfg, 1, i)
    if arch == "graphsage-reddit":
        rng = np.random.default_rng((1, i, 3))
        v = b["x"].shape[0]
        b = {"x": b["x"], "y": b["y"], "node_mask": b["node_mask"],
             "src_0": b["src"], "dst_0": b["dst"],
             "src_1": rng.integers(0, v, 64).astype(np.int32),
             "dst_1": rng.integers(0, 16, 64).astype(np.int32)}
    return b


def test_port_smoke_stream_is_the_reference():
    """The launcher's GNN batches equal the reference launcher's
    stream, batch for batch."""
    for arch in ARCHS:
        cfg = jget(arch).make_smoke_config()
        stream = jlaunch._smoke_stream(arch, cfg, 4, 8)(2)
        for i in (2, 3):
            want = next(stream)
            got = launch_train._gnn_batch(arch, tget(arch).make_smoke_config(),
                                          4, i)
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])


# --------------------------------------------------------------------------
# Whole train steps from a carried reference TrainState
# --------------------------------------------------------------------------

def _reference_steps(arch: str, n_steps: int):
    """The reference's ``_build_gnn`` step (AdamW lr 1e-3) on the smoke
    config, run ``n_steps`` times: (port config, the states before and
    after each step as host arrays, each step's metrics)."""
    J = MODS[arch][0]
    jcfg = jget(arch).make_smoke_config()
    tree = reference_tree(arch, jcfg)
    opt = jadamw(JAdamWConfig(lr=1e-3))
    state = jts.create(jax.tree.map(jnp.asarray, tree), opt)
    step = jax.jit(jts.make_train_step(lambda p, b: J.loss_fn(p, b, jcfg),
                                       opt))
    states, metrics = [jax.tree.map(np.asarray, state)], []
    for i in range(n_steps):
        state, m = step(state, _j(_batch(arch, jcfg, i)))
        states.append(jax.tree.map(np.asarray, state))
        metrics.append({k: float(v) for k, v in m.items()})
    return tget(arch).make_smoke_config(), states, metrics


def _leaves(tree: dict) -> dict:
    return {"params": port_leaves(tree["params"]),
            "m": port_leaves(tree["opt"]["m"]),
            "v": port_leaves(tree["opt"]["v"])}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference(arch, monkeypatch):
    """3 steps of ``build_cell(arch, shape)``'s step (on the smoke
    config), each from the reference's state before it
    (``state_from_reference``), against the reference's steps under
    ``jax.jit``: loss, grad norm, params, m and v under the module's
    gates."""
    n_steps, lr = 3, 1e-3
    tcfg, states, jm = _reference_steps(arch, n_steps)
    mod = tget(arch)
    monkeypatch.setattr(mod, "make_config", lambda shape=None: tcfg)
    M = model_of(arch)
    cell = steps.build_cell(arch, "molecule", device="cpu")
    opt = adamw(AdamWConfig(lr=lr))
    for i in range(n_steps):
        state = M.state_from_reference(states[i], tcfg, opt, device="cpu")
        state, m = cell.step(state, _batch(arch, tcfg, i))
        assert int(state["step"]) == i + 1
        assert float(m["loss"]) == pytest.approx(jm[i]["loss"], rel=1e-6)
        assert float(m["grad_norm"]) == pytest.approx(jm[i]["grad_norm"],
                                                      rel=1e-6)
        before, after = _leaves(states[i]), _leaves(states[i + 1])
        got = {"params": named(state["params"]), **state["opt"]}
        bc1, bc2 = 1 - 0.9 ** (i + 1), 1 - 0.95 ** (i + 1)
        for part in ("m", "v", "params"):
            assert got[part].keys() == after[part].keys()
            for n, t in got[part].items():
                g, w = _np(t), _np(after[part][n])
                m_, v_ = (_np(after[k][n]).astype(np.float64)
                          for k in ("m", "v"))
                dm = 1e-5 * np.abs(m_).max() + np.zeros_like(m_)
                dv = 2e-5 * np.abs(v_).max() + np.zeros_like(v_)
                if part == "m":
                    gate = dm
                elif part == "v":
                    gate = dv
                else:
                    root = np.sqrt(v_ / bc2)
                    gate = lr * (dm / bc1 / (root + 1e-8) + np.abs(m_ / bc1)
                                 * (dv / bc2) / (2 * np.maximum(root, 1e-30)
                                                 * (root + 1e-8) ** 2)) \
                        + np.spacing(np.abs(w))
                assert np.all(np.abs(g - w) <= gate), (i, part, n, float(
                    (np.abs(g - w) / np.maximum(gate, 1e-38)).max()))
        for n, t in got["params"].items():
            moved = np.abs(_np(after["params"][n])
                           - _np(before["params"][n])).sum()
            assert np.abs(_np(t) - _np(after["params"][n])).sum() <= \
                0.25 * moved, (i, n)
    # the default rule decays the leaves with ndim >= 2, the stacked
    # layers' biases and norms among them: a skipped decay moves a leaf
    # by lr * 0.1 * |p|, beyond the parameter gate above
    matrices = {n for n, t in named(state["params"]).items() if t.dim() >= 2}
    stacked = {"gatedgcn": {"layers.U.b", "layers.ln_h", "layers.ln_e"},
               "nequip": {"layers.radial.b1", "layers.gate_b"}}
    assert stacked.get(arch, set()) <= matrices
    if arch in ("graphsage-reddit", "gin-tu"):
        assert not any(n.endswith((".b", ".eps", ".ln")) for n in matrices)


@pytest.mark.parametrize("arch", ("nequip", "gin-tu"))
def test_state_from_reference_carries_every_bit(arch):
    """A reference TrainState with random moments and step 7: every leaf
    the reference's bits, each trainable; a moment of another dtype is
    refused."""
    J, T = MODS[arch]
    jcfg = jget(arch).make_smoke_config()
    tcfg = tget(arch).make_smoke_config()
    tree = jax.tree.map(np.asarray, J.init(jax.random.PRNGKey(0), jcfg))
    start = jax.tree.map(np.asarray, jts.create(
        jax.tree.map(jnp.asarray, tree), jadamw(JAdamWConfig())))
    rng = np.random.default_rng(2)
    for key in ("m", "v"):
        start["opt"][key] = jax.tree.map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32),
            start["opt"][key])
    start["step"] = np.int32(7)
    state = T.state_from_reference(start, tcfg, adamw(AdamWConfig()),
                                   device="cpu")
    assert all(p.requires_grad for p in named(state["params"]).values())
    assert int(state["step"]) == 7 and state["step"].dtype == torch.int32
    for key in ("params", "m", "v"):
        sub = start["params"] if key == "params" else start["opt"][key]
        want = port_leaves(sub)
        got = named(state["params"]) if key == "params" else \
            state["opt"][key]
        assert got.keys() == want.keys()
        for n, t in got.items():
            assert torch.equal(t.detach(), want[n]), (key, n)
    start["opt"]["m"] = jax.tree.map(lambda a: a.astype(np.float64),
                                     start["opt"]["m"])
    with pytest.raises(ValueError, match="float64, the optimizer makes"):
        T.state_from_reference(start, tcfg, adamw(AdamWConfig()),
                               device="cpu")


# --------------------------------------------------------------------------
# Configs, cells and the launcher
# --------------------------------------------------------------------------

def _fields(cfg) -> dict:
    out = dataclasses.asdict(cfg)
    out["dtype"] = str(np.dtype(cfg.dtype)) if not isinstance(
        cfg.dtype, torch.dtype) else str(cfg.dtype).removeprefix("torch.")
    out.pop("dist_axes", None)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_reference(arch):
    """Ids, shapes, ``SHAPE_DEFS``, every shape's ``make_config``, the
    smoke config, ``input_specs`` (shapes and mapped dtypes),
    ``step_kind`` and ``skip_reason``, as the reference's."""
    mod, ref = tget(arch), jget(arch)
    assert (mod.ARCH_ID, mod.FAMILY, mod.SHAPES) == (ref.ARCH_ID, ref.FAMILY,
                                                     ref.SHAPES)
    assert TGC.SHAPE_DEFS == JGC.SHAPE_DEFS and TGC.SHAPES == JGC.SHAPES
    assert _fields(mod.make_smoke_config()) == _fields(
        ref.make_smoke_config())
    for shape in mod.SHAPES:
        assert _fields(mod.make_config(shape)) == _fields(
            ref.make_config(shape))
        want = ref.input_specs(shape)["batch"]
        got = mod.input_specs(shape)["batch"]
        assert got == {k: (tuple(s.shape), DTYPES[s.dtype.type])
                       for k, s in want.items()}, shape
        assert mod.step_kind(shape) == ref.step_kind(shape) == "train"
        assert mod.skip_reason(shape) == ref.skip_reason(shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cell_builds_without_allocating(arch, monkeypatch):
    """``build_cell(arch, shape)`` on the full config of every shape:
    the state's specs (params as ``param_shapes``, m and v alike), the
    batch spec, the step (no accumulation), and no tensor made on the
    way."""
    made, built = [], []
    for name in ("zeros", "empty", "full", "randn", "ones", "tensor"):
        real = getattr(torch, name)
        monkeypatch.setattr(torch, name, lambda *a, _r=real, **k: (
            made.append(a), _r(*a, **k))[1])
    make_step = steps.train_state.make_train_step
    monkeypatch.setattr(steps.train_state, "make_train_step",
                        lambda *a, **k: (built.append(k),
                                         make_step(*a, **k))[1])
    mod, M = tget(arch), model_of(arch)
    for shape in mod.SHAPES:
        cell = steps.build_cell(arch, shape, device="cpu")
        state, bspec = cell.args
        cfg = mod.make_config(shape)
        assert (cell.kind, cell.arch, cell.shape) == ("train", arch, shape)
        assert bspec == mod.input_specs(shape)["batch"]
        assert state["params"] == {n: (s, torch.float32) for n, s in
                                   M.param_shapes(cfg).items()}
        assert state["opt"] == {"m": state["params"], "v": state["params"]}
        assert state["step"] == ((), torch.int32)
        assert callable(cell.init_state)
    assert made == []
    assert built == [{}] * len(mod.SHAPES)
    assert M.param_shapes(mod.make_config("ogb_products"))
