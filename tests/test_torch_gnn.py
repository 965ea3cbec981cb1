"""repro_torch's GNN family against the reference's, on the CPU: the
message passing of ``models/gnn/common.py`` (``scatter_sum``,
``scatter_mean``, ``scatter_softmax``, the linear and the loss), and
the four models on their smoke configs from carried reference weights
(GraphSAGE full-graph and over sampled blocks, GIN graph- and
node-level, GatedGCN with remat on and off, NequIP's energy and
forces), with NequIP's Gaunt tables, spherical harmonics, Bessel
basis and its physics (rotation and translation invariance, force
equivariance, chunking invariance) in the port.

The reference's constant leaves (zero biases, eps, ones LayerNorm
weights, NequIP's 1e-2 head) are moved by a seeded normal, the same
numbers for both packages, so every parameter takes part.

Tolerances (float32; on the CPU the port's segment sums run the
segment-reduce kernel's plain version, an fp32 ``index_add_``): values
within 1e-5 of the largest |value| of the output compared, gradients
within 1e-5 of the leaf's largest |gradient| (the same fp32 terms
summed in other orders). The Gaunt tables and coupling paths are
equal exactly (the same numpy quadrature). The physics gates are the
reference's own (``tests/test_models_gnn.py``): rotation 5e-4,
translation 1e-5, forces under rotation 5e-3, chunking 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget
from repro.models.gnn import common as JC
from repro.models.gnn import gatedgcn as JG, gin as JI, graphsage as JS, \
    nequip as JN
from repro_torch.configs import get_arch as tget
from repro_torch.models.gnn import common as TC
from repro_torch.models.gnn import gatedgcn as TG, gin as TI, \
    graphsage as TS, nequip as TN
from repro_torch.models.gnn import model_of
from repro_torch.train.optimizer import named

MODS = {"graphsage-reddit": (JS, TS), "gin-tu": (JI, TI),
        "gatedgcn": (JG, TG), "nequip": (JN, TN)}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _t(tree) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _j(tree) -> dict:
    return {k: jnp.asarray(v) for k, v in tree.items()}


def close(got, want, rel: float = 1e-5, what: str = ""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30) if want.size else 1.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= rel * scale, (what, err, scale)


def graph_batch(seed: int, v: int = 48, e: int = 160, d: int = 16,
                classes: int = 5, d_edge: int = 8) -> dict:
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((v, d)).astype(np.float32),
            "src": rng.integers(0, v, e).astype(np.int32),
            "dst": rng.integers(0, v, e).astype(np.int32),
            "edge_attr": rng.standard_normal((e, d_edge)).astype(np.float32),
            "y": rng.integers(0, classes, v).astype(np.int32),
            "node_mask": (rng.random(v) < 0.7).astype(np.float32)}


def mol_batch(seed: int, g: int = 4, v_per: int = 6, e_per: int = 10,
              n_species: int = 4) -> dict:
    rng = np.random.default_rng(seed)
    v = g * v_per
    e = rng.integers(0, v, (g * e_per, 2))
    return {"positions": (rng.standard_normal((v, 3)) * 1.5).astype(
                np.float32),
            "species": rng.integers(0, n_species, v).astype(np.int32),
            "src": e[:, 0].astype(np.int32), "dst": e[:, 1].astype(np.int32),
            "graph_ids": np.repeat(np.arange(g), v_per).astype(np.int32),
            "energy": rng.standard_normal(g).astype(np.float32)}


def reference_tree(arch: str, jcfg, seed: int = 0) -> dict:
    """The reference's init (PRNGKey 0) as host arrays, each constant
    leaf moved by a seeded normal."""
    rng = np.random.default_rng(seed + 11)
    J = MODS[arch][0]

    def move(a):
        a = np.asarray(a)
        if a.size and np.all(a == a.reshape(-1)[0]):
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return jax.tree.map(move, jax.tree.map(np.asarray, J.init(
        jax.random.PRNGKey(0), jcfg)))


def _cfgs(arch: str, **change) -> tuple:
    jcfg = jget(arch).make_smoke_config()
    tcfg = tget(arch).make_smoke_config()
    if change:
        jcfg = dataclasses.replace(jcfg, **change)
        tcfg = dataclasses.replace(tcfg, **change)
    return jcfg, tcfg


def port_leaves(tree) -> dict:
    """A reference tree (host arrays) by the port's dotted names."""
    return named(TC.tree_map(lambda a: torch.from_numpy(
        np.array(a, np.float32)), tree))


# --------------------------------------------------------------------------
# Message passing
# --------------------------------------------------------------------------

def _scatter_case(case: str, n: int = 10, e: int = 40):
    rng = np.random.default_rng(3)
    dst = rng.integers(0, n, e).astype(np.int32)
    if case == "empty_segment":
        dst[dst == 4] = 5
        n = n + 3                       # segments 4, 10, 11, 12 get no row
    elif case == "out_of_range":
        dst[[0, 7, 19]] = [n, -1, n + 2]
    vals = rng.standard_normal((e, 3)).astype(np.float32)
    cot = rng.standard_normal((n, 3)).astype(np.float32)
    return vals, dst, n, cot


@pytest.mark.parametrize("case", ("random", "empty_segment",
                                  "out_of_range"))
@pytest.mark.parametrize("op", ("sum", "mean", "softmax"))
def test_scatter_matches_reference(op, case):
    """Values and the gradient to the values (through a seeded
    cotangent) against the reference's; ids outside [0, n) are dropped
    by the sums and gathered by ``jnp``'s clamp in the softmax."""
    vals, dst, n, cot = _scatter_case(case)
    jfn = {"sum": JC.scatter_sum, "mean": JC.scatter_mean,
           "softmax": JC.scatter_softmax}[op]
    tfn = {"sum": TC.scatter_sum, "mean": TC.scatter_mean,
           "softmax": TC.scatter_softmax}[op]
    if op == "softmax":
        cot = np.random.default_rng(4).standard_normal(vals.shape).astype(
            np.float32)
    want, vjp = jax.vjp(lambda x: jfn(x, jnp.asarray(dst), n),
                        jnp.asarray(vals))
    (want_g,) = vjp(jnp.asarray(cot))
    x = torch.from_numpy(vals).requires_grad_(True)
    got = tfn(x, torch.from_numpy(dst), n)
    (got_g,) = torch.autograd.grad(got, x, torch.from_numpy(cot))
    close(got, want, what="value")
    close(got_g, want_g, what="gradient")
    if case == "empty_segment" and op != "softmax":
        assert not _np(got)[[4, 10, 11, 12]].any()


@pytest.mark.parametrize("masked", ("none", "half", "zero"))
def test_linear_and_nll_loss_match_reference(masked):
    rng = np.random.default_rng(5)
    p = {"w": rng.standard_normal((6, 4)).astype(np.float32),
         "b": rng.standard_normal(4).astype(np.float32)}
    x = rng.standard_normal((9, 6)).astype(np.float32)
    y = rng.integers(0, 4, 9).astype(np.int32)
    mask = {"none": None, "half": (np.arange(9) % 2).astype(np.float32),
            "zero": np.zeros(9, np.float32)}[masked]
    close(TC.linear(_t(p), torch.from_numpy(x)), JC.linear(_j(p), x))
    logits = JC.linear(_j(p), x)
    want = JC.nll_loss(logits, jnp.asarray(y),
                       None if mask is None else jnp.asarray(mask))
    got = TC.nll_loss(torch.from_numpy(np.asarray(logits)),
                      torch.from_numpy(y),
                      None if mask is None else torch.from_numpy(mask))
    assert float(got) == pytest.approx(float(want), rel=1e-6, abs=1e-7)


# --------------------------------------------------------------------------
# The four models from carried weights
# --------------------------------------------------------------------------

def _sampled_batch(cfg, seed: int = 2) -> dict:
    rng = np.random.default_rng(seed)
    v = 32
    return {"x": rng.standard_normal((v, cfg.d_in)).astype(np.float32),
            "src_0": rng.integers(0, v, 64).astype(np.int32),
            "dst_0": rng.integers(0, v, 64).astype(np.int32),
            "src_1": rng.integers(0, v, 32).astype(np.int32),
            "dst_1": rng.integers(0, v, 32).astype(np.int32),
            "y": rng.integers(0, cfg.n_classes, v).astype(np.int32),
            "node_mask": (np.arange(v) < 8).astype(np.float32)}


VARIANTS = {
    # name: (arch, config change, batch builder)
    "sage_full": ("graphsage-reddit", {}, lambda c: graph_batch(
        1, d=c.d_in, classes=c.n_classes)),
    "sage_sampled": ("graphsage-reddit", {}, _sampled_batch),
    "gin_graph": ("gin-tu", {}, lambda c: {
        **graph_batch(1, v=c.num_graphs * 6, d=c.d_in, classes=c.n_classes),
        "graph_ids": np.repeat(np.arange(c.num_graphs), 6).astype(np.int32),
        "y": np.random.default_rng(6).integers(
            0, c.n_classes, c.num_graphs).astype(np.int32)}),
    "gin_node": ("gin-tu", {"graph_level": False}, lambda c: graph_batch(
        1, d=c.d_in, classes=c.n_classes)),
    "gatedgcn_remat": ("gatedgcn", {}, lambda c: graph_batch(
        1, d=c.d_in, classes=c.n_classes, d_edge=c.d_edge_in)),
    "gatedgcn_no_remat": ("gatedgcn", {"remat": False}, lambda c: graph_batch(
        1, d=c.d_in, classes=c.n_classes, d_edge=c.d_edge_in)),
    "nequip": ("nequip", {}, lambda c: mol_batch(1, n_species=c.n_species)),
}


def _forward(M, arch: str, params, batch, cfg):
    if arch == "graphsage-reddit" and "src_0" in batch:
        return M.forward_sampled(params, batch, cfg)
    return M.forward(params, batch, cfg)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_loss_fn_matches_reference(variant):
    """Forward, ``loss_fn`` and every gradient against the reference's
    (``jax.value_and_grad``) from the same carried weights."""
    arch, change, make = VARIANTS[variant]
    J, T = MODS[arch]
    jcfg, tcfg = _cfgs(arch, **change)
    tree = reference_tree(arch, jcfg)
    batch = make(tcfg)
    jl, jg = jax.value_and_grad(lambda p: J.loss_fn(p, _j(batch), jcfg))(
        jax.tree.map(jnp.asarray, tree))
    params = T.params_from_reference(tree, tcfg, device="cpu",
                                     requires_grad=True)
    close(_forward(T, arch, params, _t(batch), tcfg),
          _forward(J, arch, jax.tree.map(jnp.asarray, tree), _j(batch), jcfg),
          what="forward")
    loss = T.loss_fn(params, _t(batch), tcfg)
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-5)
    leaves = named(params)
    want = port_leaves(jax.tree.map(np.asarray, jg))
    assert leaves.keys() == want.keys()
    for n, g in zip(leaves, torch.autograd.grad(loss, list(leaves.values()))):
        close(g, want[n], what=n)


def test_gatedgcn_remat_gives_equal_gradients():
    """Per-layer ``checkpoint`` recomputes the same layer: loss and
    every gradient bit-equal to the stored run."""
    out = {}
    for remat in (True, False):
        cfg = dataclasses.replace(tget("gatedgcn").make_smoke_config(),
                                  remat=remat)
        params = TG.init(cfg, generator=torch.Generator().manual_seed(3),
                         device="cpu", requires_grad=True)
        b = _t(graph_batch(2, d=cfg.d_in, classes=cfg.n_classes))
        loss = TG.loss_fn(params, b, cfg)
        out[remat] = (loss, torch.autograd.grad(
            loss, list(named(params).values())))
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(out[True][1], out[False][1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", list(MODS))
def test_init_and_shapes_match_reference(arch):
    """``param_shapes`` and the port's ``init`` give the reference
    tree's leaves by name (shapes, dtype, the layers stacked where the
    reference stacks them); a tree of another shape is refused."""
    J, T = MODS[arch]
    jcfg, tcfg = _cfgs(arch)
    ref = port_leaves(jax.tree.map(np.asarray, J.init(jax.random.PRNGKey(0),
                                                      jcfg)))
    assert T.param_shapes(tcfg) == {n: tuple(t.shape) for n, t in
                                    ref.items()}
    got = named(T.init(tcfg, generator=torch.Generator().manual_seed(0),
                       device="cpu", requires_grad=True))
    assert {n: tuple(t.shape) for n, t in got.items()} == \
        T.param_shapes(tcfg)
    assert all(t.dtype == torch.float32 and t.requires_grad
               for t in got.values())
    assert model_of(arch) is T
    tree = jax.tree.map(np.asarray, J.init(jax.random.PRNGKey(0), jcfg))
    bad = jax.tree.map(lambda a: a[..., :1] if a.ndim else a, tree)
    with pytest.raises(ValueError, match="do not match"):
        T.params_from_reference(bad, tcfg, device="cpu")
    f64 = jax.tree.map(lambda a: a.astype(np.float64), tree)
    with pytest.raises(ValueError, match="float64"):
        T.params_from_reference(f64, tcfg, device="cpu")


# --------------------------------------------------------------------------
# NequIP
# --------------------------------------------------------------------------

def test_gaunt_tables_and_paths_equal_reference():
    for l_max in (0, 1, 2):
        jt, tt = JN.gaunt_tables(l_max), TN.gaunt_tables(l_max)
        assert list(jt) == list(tt)
        for k in jt:
            assert tt[k].dtype == torch.float32
            np.testing.assert_array_equal(tt[k].numpy(), np.asarray(jt[k]))
        assert TN.coupling_paths(l_max) == JN.coupling_paths(l_max)
    assert len(TN.coupling_paths(2)) == 11


def test_spherical_harmonics_and_bessel_match_reference():
    rng = np.random.default_rng(8)
    vec = rng.standard_normal((50, 3)).astype(np.float32)
    unit = vec / np.linalg.norm(vec, axis=-1, keepdims=True)
    for l_max in (0, 1, 2):
        for a, b in zip(TN.spherical_harmonics(torch.from_numpy(unit), l_max),
                        JN.spherical_harmonics(jnp.asarray(unit), l_max)):
            close(a, b)
    r = np.concatenate([[0.0, 1e-12, 5.0, 6.5],
                        rng.uniform(0, 5, 40)]).astype(np.float32)
    close(TN.bessel_basis(torch.from_numpy(r), 8, 5.0),
          JN.bessel_basis(jnp.asarray(r), 8, 5.0))
    np.testing.assert_array_equal(
        TN._sh_np(unit.astype(np.float64), 2)[2],
        JN._sh_np(unit.astype(np.float64), 2)[2])


@pytest.fixture(scope="module")
def nq():
    jcfg, tcfg = _cfgs("nequip")
    tree = reference_tree("nequip", jcfg)
    params = TN.params_from_reference(tree, tcfg, device="cpu",
                                      requires_grad=True)
    return jcfg, tcfg, tree, params, mol_batch(9, n_species=tcfg.n_species)


def _rotation(seed: int) -> np.ndarray:
    q, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal((3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return q


def test_nequip_forces_match_reference(nq):
    jcfg, tcfg, tree, params, b = nq
    want = JN.forces(jax.tree.map(jnp.asarray, tree), _j(b), jcfg)
    got = TN.forces(params, _t(b), tcfg)
    close(got, want, what="forces")
    assert np.isfinite(_np(got)).all()


def test_nequip_rotation_and_translation_invariance(nq):
    _, cfg, _, params, b = nq
    e0 = _np(TN.forward(params, _t(b), cfg))
    q = _rotation(10)
    rot = {**b, "positions": (b["positions"] @ q.T).astype(np.float32)}
    np.testing.assert_allclose(_np(TN.forward(params, _t(rot), cfg)), e0,
                               atol=5e-4)
    moved = {**b, "positions": b["positions"] + np.float32(11.7)}
    np.testing.assert_allclose(_np(TN.forward(params, _t(moved), cfg)), e0,
                               atol=1e-5)


def test_nequip_force_equivariance(nq):
    _, cfg, _, params, b = nq
    f0 = _np(TN.forces(params, _t(b), cfg))
    q = _rotation(12)
    rot = {**b, "positions": (b["positions"] @ q.T).astype(np.float32)}
    np.testing.assert_allclose(_np(TN.forces(params, _t(rot), cfg)),
                               f0 @ q.T, atol=5e-3)


def test_nequip_chunking_invariance(nq):
    """``edge_chunk`` 7 (six chunks, the last padded with masked edges)
    against one chunk of the whole edge list: energies and gradients."""
    _, cfg, _, params, b = nq
    out = {}
    for chunk in (1 << 20, 7):
        c = dataclasses.replace(cfg, edge_chunk=chunk)
        loss = TN.loss_fn(params, _t(b), c)
        out[chunk] = (TN.forward(params, _t(b), c), torch.autograd.grad(
            loss, list(named(params).values())))
    np.testing.assert_allclose(_np(out[7][0]), _np(out[1 << 20][0]),
                               atol=1e-5)
    for a, w in zip(out[7][1], out[1 << 20][1]):
        close(a, w)


def test_nequip_self_loops_break_rotation_invariance_in_both_packages(nq):
    """A self-loop edge (i, i) has r = sqrt(0 + 1e-18) = 1e-9 > 0, so it
    passes the cutoff mask, and its unit vector is 0: Y_2(0) = (0, 0,
    -c, 0, 0) is an l = 2 message that does not rotate. With six
    self-loops both packages' energies move under a rotation by more
    than 1e-6 (about 1.6e-5 here), the same in both; with those edges
    masked (``edge_mask``) by less than 1e-6 (rounding, ~1e-8)."""
    jcfg, cfg, tree, params, b = nq
    b = {**b, "dst": b["dst"].copy()}
    b["dst"][:6] = b["src"][:6]
    q = _rotation(10)
    rot = {**b, "positions": (b["positions"].astype(np.float64)
                              @ q.T).astype(np.float32)}
    jt = jax.tree.map(jnp.asarray, tree)
    for masked in (False, True):
        if masked:
            keep = (b["src"] != b["dst"]).astype(np.float32)
            b, rot = {**b, "edge_mask": keep}, {**rot, "edge_mask": keep}
        with torch.no_grad():
            t = float((TN.forward(params, _t(rot), cfg)
                       - TN.forward(params, _t(b), cfg)).abs().max())
        j = float(jnp.abs(JN.forward(jt, _j(rot), jcfg)
                          - JN.forward(jt, _j(b), jcfg)).max())
        if masked:
            assert t < 1e-6 and j < 1e-6, (t, j)
        else:
            assert t > 1e-6 and j > 1e-6, (t, j)
            assert t == pytest.approx(j, rel=0.05)
