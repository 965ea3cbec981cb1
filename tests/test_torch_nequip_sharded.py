"""repro_torch's sharded NequIP (``dist_axes``, the reference's
``shard_map`` mode played over a mesh's slots) on the CPU: the
collectives it runs (``all_gather``, ``psum_scatter``, ``psum``),
forward and backward against hand-written sums; ``forward``,
``loss_fn``, ``forces`` and the step's gradient at 1, 2, 4 and 8 slots
of the smoke config against the port's plain path and the reference's
single-device path, from carried reference weights; three AdamW steps
of ``build_cell("nequip", ..., mesh=...)`` from a carried state against
the reference's single-device steps; the refusal of a |V| or |E| that
does not divide into the slots; and one subprocess that runs the
reference's ``shard_map`` on 4 forced host devices.

Tolerances (float32): values within 1e-5 of the largest |value| of the
output compared, gradients within 1e-5 of the leaf's largest |gradient|
(``test_torch_gnn.close``): the same fp32 terms, summed in other orders
when the edges are cut into slots and chunks. The steps are held to
``test_torch_gnn_train``'s step gates. On one slot the sharded path runs
the plain path's ops, so its loss, gradient and forces are bit-equal.

The reference's sharded gradient and forces are k times its
single-device ones (the transpose of its energy ``psum`` under
``check_rep=False`` hands every shard the whole cotangent, and the
gradient ``psum`` adds the k copies); the subprocess pins that factor at
k = 4 (ROADMAP, reference-side). The port follows the reference's stated
contract (``_build_gnn_shardmap``'s docstring: each shard's gradient is
a partial sum), so its sharded gradient equals the single-device one.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget
from repro.models.gnn import nequip as JN
from repro_torch.configs import get_arch as tget
from repro_torch.launch import collectives, steps
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.gnn import nequip as TN
from repro_torch.train.optimizer import AdamWConfig, adamw, named

from test_distributed import run_sub
from test_torch_gnn import _j, _np, close, port_leaves, reference_tree
from test_torch_gnn_train import _batch, _reference_steps, check_step
from _threads import one_thread  # noqa: F401

SLOTS = (1, 2, 4, 8)
AXES = ("data",)


def _cpu(k: int):
    return make_mesh(k, device="cpu")


# --------------------------------------------------------------------------
# The collectives, against hand-written sums
# --------------------------------------------------------------------------

def _slot_tensors(k: int, rows: int = 8, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((rows, 3)).astype(
        np.float64)).requires_grad_(True) for _ in range(k)]


@pytest.mark.parametrize("k", (1, 2, 3, 4))
def test_all_gather_forward_and_backward(k):
    """Every slot holds the concatenation; the gradient to slot i's
    tensor is its block of the summed cotangents of every slot's
    copy."""
    xs = _slot_tensors(k)
    cots = _slot_tensors(k, rows=8 * k, seed=1)
    out = collectives.all_gather(xs)
    want = torch.cat([x.detach() for x in xs])
    assert len(out) == k and all(torch.equal(o, want) for o in out)
    cots = [c.detach() for c in cots]
    grads = torch.autograd.grad(out, xs, cots)
    total = sum(cots)
    for i, g in enumerate(grads):
        assert torch.allclose(g, total[8 * i:8 * (i + 1)], rtol=0,
                              atol=1e-12)


@pytest.mark.parametrize("k", (1, 2, 4))
def test_psum_scatter_forward_and_backward(k):
    """Slot i holds block i of the sum; every slot's tensor gets the
    slots' cotangents concatenated; axis 0 must divide by k."""
    xs = _slot_tensors(k, rows=4 * k)
    out = collectives.psum_scatter(xs)
    total = sum(x.detach() for x in xs)
    for i, o in enumerate(out):
        assert torch.allclose(o, total[4 * i:4 * (i + 1)], rtol=0,
                              atol=1e-12)
    cots = [c.detach() for c in _slot_tensors(k, rows=4, seed=2)]
    grads = torch.autograd.grad(out, xs, cots)
    for g in grads:
        assert torch.equal(g, torch.cat(cots))
    if k > 1:
        with pytest.raises(ValueError, match="does not split into"):
            collectives.psum_scatter(_slot_tensors(k, rows=4 * k + 1))


@pytest.mark.parametrize("k", (1, 2, 4))
def test_psum_forward_and_backward_once(k):
    """Every slot holds the sum (one shared tensor on one device); a
    loss read from one slot's copy gives every input its cotangent once,
    and reading all k copies adds their cotangents."""
    xs = _slot_tensors(k)
    out = collectives.psum(xs)
    total = sum(x.detach() for x in xs)
    assert all(torch.allclose(o, total, rtol=0, atol=1e-12) for o in out)
    cot = torch.ones_like(total)
    once = torch.autograd.grad(out[0], xs, cot, retain_graph=True)
    assert all(torch.equal(g, cot) for g in once)
    every = torch.autograd.grad(sum(o.sum() for o in out), xs)
    assert all(torch.equal(g, k * cot) for g in every)


# --------------------------------------------------------------------------
# The model at 1, 2, 4 and 8 slots
# --------------------------------------------------------------------------

def _mol(v: int = 32, e: int = 64, g: int = 4, seed: int = 0,
         n_species: int = 4) -> dict:
    """The batch of the reference's own sharded-NequIP test
    (``tests/test_distributed.py``): |V| 32, |E| 64, 4 graphs."""
    rng = np.random.default_rng(seed)
    return {"positions": (rng.standard_normal((v, 3)) * 1.5).astype(
                np.float32),
            "species": rng.integers(0, n_species, v).astype(np.int32),
            "src": rng.integers(0, v, e).astype(np.int32),
            "dst": rng.integers(0, v, e).astype(np.int32),
            "graph_ids": np.repeat(np.arange(g), v // g).astype(np.int32),
            "energy": rng.standard_normal(g).astype(np.float32)}


@pytest.fixture(scope="module")
def ref():
    """Carried reference weights, the batch, and the reference's
    single-device energies, loss, gradient (by port name) and forces;
    the port's plain ones beside them."""
    jcfg = jget("nequip").make_smoke_config()
    tcfg = tget("nequip").make_smoke_config()
    tree = reference_tree("nequip", jcfg)
    b = _mol(n_species=tcfg.n_species)
    jt = jax.tree.map(jnp.asarray, tree)
    jl, jg = jax.value_and_grad(lambda p: JN.loss_fn(p, _j(b), jcfg))(jt)
    want = {"energy": np.asarray(JN.forward(jt, _j(b), jcfg)),
            "loss": float(jl),
            "grads": port_leaves(jax.tree.map(np.asarray, jg)),
            "forces": np.asarray(JN.forces(jt, _j(b), jcfg))}
    params = TN.params_from_reference(tree, tcfg, device="cpu",
                                      requires_grad=True)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    loss = TN.loss_fn(params, tb, tcfg)
    plain = {"energy": TN.forward(params, tb, tcfg).detach(),
             "loss": loss.detach(),
             "grads": dict(zip(named(params), torch.autograd.grad(
                 loss, list(named(params).values())))),
             "forces": TN.forces(params, tb, tcfg)}
    return tcfg, tree, params, b, want, plain


def _sharded_cfg(cfg, **change):
    return dataclasses.replace(cfg, dist_axes=AXES, **change)


@pytest.mark.parametrize("chunk", (1 << 18, 5))
@pytest.mark.parametrize("k", SLOTS)
def test_sharded_forward_loss_and_forces(ref, k, chunk):
    """Every slot's energies and loss, and the slots' force shards
    concatenated, against the plain path and the reference's
    single-device path; one edge chunk a slot, and chunks of 5 (the
    last padded)."""
    cfg, _, params, b, want, plain = ref
    dcfg = _sharded_cfg(cfg, edge_chunk=chunk)
    bs = TN.shard_batch(b, _cpu(k), AXES)
    assert [s["src"].shape[0] for s in bs] == [64 // k] * k
    assert [s["positions"].shape[0] for s in bs] == [32 // k] * k
    assert all(s["energy"].shape == (4,) for s in bs)
    energies = TN.forward(params, bs, dcfg)
    losses = TN.loss_fn(params, bs, dcfg)
    forces = TN.forces(params, bs, dcfg)
    assert len(energies) == len(losses) == len(forces) == k
    for e, loss in zip(energies, (x.detach() for x in losses)):
        close(e, plain["energy"], what="energy vs plain")
        close(e, want["energy"], what="energy vs reference")
        assert float(loss) == pytest.approx(float(plain["loss"]), rel=1e-5)
        assert float(loss) == pytest.approx(want["loss"], rel=1e-5)
    assert [f.shape for f in forces] == [(32 // k, 3)] * k
    close(torch.cat(forces), plain["forces"], what="forces vs plain")
    close(torch.cat(forces), want["forces"], what="forces vs reference")
    if k == 1 and chunk == 1 << 18:
        assert torch.equal(energies[0], plain["energy"])
        assert torch.equal(losses[0].detach(), plain["loss"])
        assert torch.equal(forces[0], plain["forces"])


@pytest.mark.parametrize("k", SLOTS)
def test_step_gradient_matches_plain_and_reference(ref, k, monkeypatch):
    """The sharded cell's gradient (per-slot replicas, each slot's part,
    their ``psum``) and loss (``pmean``) against the plain path's and the
    reference's single-device ones; bit-equal on one slot."""
    cfg, _, params, b, want, plain = ref
    monkeypatch.setattr(tget("nequip"), "make_config",
                        lambda shape=None: cfg)
    cell = steps.build_cell("nequip", "molecule", mesh=_cpu(k))
    loss, grads = cell.step.loss_and_grads(params, b)
    assert grads.keys() == plain["grads"].keys() == want["grads"].keys()
    assert float(loss) == pytest.approx(want["loss"], rel=1e-5)
    for n, g in grads.items():
        close(g, plain["grads"][n], what=f"{n} vs plain")
        close(g, want["grads"][n], what=f"{n} vs reference")
        if k == 1:
            assert torch.equal(g, plain["grads"][n]), n
    if k == 1:
        assert torch.equal(loss, plain["loss"])


@pytest.fixture(scope="module")
def reference_steps():
    return _reference_steps("nequip", 3)


@pytest.mark.parametrize("k", (2, 4, 8))
def test_sharded_train_steps_match_reference(reference_steps, k,
                                             monkeypatch):
    """3 steps of ``build_cell("nequip", ..., mesh=<k CPU slots>)`` on
    the smoke config, each from the reference's state before it, against
    the reference's single-device steps under ``jax.jit``, with
    ``test_torch_gnn_train``'s gates (loss and grad norm 1e-6 relative,
    m, v and the parameters derived from them)."""
    tcfg, states, jm = reference_steps
    monkeypatch.setattr(tget("nequip"), "make_config",
                        lambda shape=None: tcfg)
    cell = steps.build_cell("nequip", "molecule", mesh=_cpu(k))
    opt = adamw(AdamWConfig(lr=1e-3))
    for i in range(3):
        b = _batch("nequip", tcfg, i)
        assert b["positions"].shape[0] % k == b["src"].shape[0] % k == 0
        state = TN.state_from_reference(states[i], tcfg, opt, device="cpu")
        state, m = cell.step(state, b)
        check_step(i, state, m, states, jm, 1e-3)


def test_build_cell_takes_a_mesh_only_for_nequip_and_cc():
    mesh = _cpu(2)
    cell = steps.build_cell("nequip", "molecule", mesh=mesh)
    assert cell.step.mesh is mesh and cell.kind == "train"
    assert steps.build_cell("nequip", "molecule", device="cpu").step.mesh \
        .slot_devices() == (torch.device("cpu"),)
    with pytest.raises(ValueError, match="cc-adaptive and nequip cells"):
        steps.build_cell("gin-tu", "molecule", mesh=mesh)


# --------------------------------------------------------------------------
# The reference on 4 forced host devices
# --------------------------------------------------------------------------

_REFERENCE_4 = """
    import json
    import dataclasses as dc
    from repro.configs import get_arch
    from repro.models.gnn import nequip
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    assert len(jax.devices()) == 8
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]), ("data",))
    cfg = get_arch("nequip").make_smoke_config()
    dcfg = dc.replace(cfg, dist_axes=("data",))
    data = np.load(PATH)
    treedef = jax.tree.structure(nequip.init(jax.random.PRNGKey(0), cfg))
    params = jax.tree.unflatten(treedef, [jnp.asarray(data[f"leaf{i}"])
                                          for i in range(treedef.num_leaves)])

    def bspec(batch):
        v = batch["positions"].shape[0]
        return {k: (P("data") if k in ("src", "dst") else
                    P("data", *(None,) * (x.ndim - 1))
                    if x.shape[0] == v else P())
                for k, x in batch.items()}

    def local(p, b):
        e = nequip.forward(p, b, dcfg)
        l, g = jax.value_and_grad(lambda q: nequip.loss_fn(q, b, dcfg))(p)
        g = jax.tree.map(lambda x: jax.lax.psum(x, ("data",)), g)
        return e, jax.lax.pmean(l, ("data",)), g, nequip.forces(p, b, dcfg)

    def run(batch):
        f = shard_map(local, mesh=mesh,
                      in_specs=(jax.tree.map(lambda _: P(), params),
                                bspec(batch)),
                      out_specs=(P(), P(), jax.tree.map(lambda _: P(),
                                                        params), P("data")),
                      check_rep=False)
        return jax.jit(f)(params, batch)

    batch = {k[6:]: jnp.asarray(data[k]) for k in data.files
             if k.startswith("batch.")}
    e, l, g, f = run(batch)
    single_l, single_g = jax.value_and_grad(
        lambda q: nequip.loss_fn(q, batch, cfg))(params)
    out = {"energy": np.asarray(e).tolist(), "loss": float(l),
           "single_loss": float(single_l),
           "single_energy": np.asarray(nequip.forward(params, batch,
                                                      cfg)).tolist(),
           "grads": [np.asarray(x).tolist() for x in jax.tree.leaves(g)],
           "single_grads": [np.asarray(x).tolist()
                            for x in jax.tree.leaves(single_g)],
           "forces": np.asarray(f).tolist(),
           "single_forces": np.asarray(nequip.forces(params, batch,
                                                     cfg)).tolist()}
    errors = {}
    for what, cut in (("nodes", {"positions": 30, "species": 30,
                                 "graph_ids": 30}),
                      ("edges", {"src": 62, "dst": 62})):
        odd = {k: (x[:cut[k]] if k in cut else x) for k, x in batch.items()}
        try:
            run(odd)
        except ValueError as err:
            errors[what] = str(err)
    out["errors"] = errors
    print("REF_NEQUIP_4 " + json.dumps(out))
"""


def test_reference_sharded_on_4_host_devices(ref, tmp_path):
    """The reference's ``shard_map`` NequIP (``jax.jit``) on 4 forced
    host devices: its energies and loss equal the port's 4-slot ones
    and its own single-device ones within 1e-5; its gradient and forces
    are 4 times its single-device ones (the reference-side factor k),
    while the port's 4-slot ones equal the single-device ones. A |V| or
    |E| that does not divide into 4 raises ``ValueError`` in both, with
    the same 'does not evenly divide' phrase."""
    cfg, tree, params, b, want, plain = ref
    leaves = jax.tree.leaves(tree)
    path = tmp_path / "nequip.npz"
    np.savez(path, **{f"leaf{i}": np.asarray(x) for i, x in
                      enumerate(leaves)},
             **{f"batch.{k}": v for k, v in b.items()})
    out = run_sub(f"    PATH = {str(path)!r}\n" + _REFERENCE_4)
    line = [ln for ln in out.splitlines() if ln.startswith("REF_NEQUIP_4 ")]
    got = json.loads(line[0][len("REF_NEQUIP_4 "):])
    dcfg = _sharded_cfg(cfg)
    bs = TN.shard_batch(b, _cpu(4), AXES)
    port_e = TN.forward(params, bs, dcfg)
    port_l = TN.loss_fn(params, bs, dcfg)
    port_f = torch.cat(TN.forces(params, bs, dcfg))
    energy = np.asarray(got["energy"], np.float32)
    for e, loss in zip(port_e, (x.detach() for x in port_l)):
        close(e, energy, what="port 4 slots vs reference 4 devices")
        assert float(loss) == pytest.approx(got["loss"], rel=1e-5)
    close(energy, got["single_energy"], what="reference sharded vs single")
    assert got["loss"] == pytest.approx(got["single_loss"], rel=1e-5)
    # the reference-side factor: 4x the single-device gradient and forces
    for sharded, single in zip(got["grads"], got["single_grads"]):
        close(np.asarray(sharded, np.float32),
              4 * np.asarray(single, np.float32), what="reference grad")
    close(np.asarray(got["forces"], np.float32),
          4 * np.asarray(got["single_forces"], np.float32),
          what="reference forces")
    close(port_f, np.asarray(got["single_forces"], np.float32),
          what="port forces vs reference single")
    assert not np.allclose(got["forces"], got["single_forces"], rtol=0.5)
    # the refusal of a cut that does not divide
    for what, cut in (("nodes", {"positions": 30, "species": 30,
                                 "graph_ids": 30}),
                      ("edges", {"src": 62, "dst": 62})):
        n = next(iter(cut.values()))
        odd = {k: (x[:cut[k]] if k in cut else x) for k, x in b.items()}
        phrase = f"but 4 does not evenly divide {n}"
        assert phrase in got["errors"][what], got["errors"]
        with pytest.raises(ValueError, match=phrase):
            TN.shard_batch(odd, _cpu(4), AXES)
