"""DCN-v2 training in repro_torch against the reference's: the gradients
of the two kernel Functions (the embedding-bag lookup, whose table
gradient is a segment sum on the segment-reduce kernel, and the segment
sum, whose gradient is a gather on the embedding-bag kernel), whole
train steps from a carried reference TrainState, the train cell and the
launcher. On the CPU the wrappers run the kernels' plain versions.

Tolerances. float32: 1e-6 (sums of the same terms in another order).
bfloat16, the table's gradient: a row looked up c times gets c
output-gradient rows; the port sums them in fp32 and rounds once, the
reference's ``jnp.take`` transpose scatter-adds them in bfloat16 and
rounds after each of its c - 1 adds, each rounding at most half an ulp
of a partial sum, and no partial sum exceeds S = sum|g|. So the two
differ by at most (c/2) ulp(S) per element (0 when c = 1: one term is
exact on both sides).

bfloat16, three whole train steps: the tower's gradients also differ.
Its bias and ``dense_norm`` gradients are sums over the B rows of the
batch, which the reference rounds in bfloat16 along the way and torch
sums in fp32: by the same argument at most (B/2) ulps, which we take
against the leaf's largest |gradient|, eps = (B/2) 2^-8 of it (B = 16:
3.1%; seen: up to 1.8%). Carried through AdamW for t steps: m (a
convex mix of the gradients) within eps of its leaf's largest |m|, v
(of squared gradients) within 2 eps of its largest |v|, each plus t
ulps of its own rounding; a parameter moves by at most lr a step along
m/sqrt(v), which the gradient error moves by at most 2 eps, so within
t (ulp(p) + 2 eps lr); the loss and the gradient norm within eps.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dcn_v2 as jdcn
from repro.data import pipeline as jdp
from repro.models import recsys as jrecsys
from repro.train import train_state as jts
from repro.train.optimizer import AdamWConfig as JAdamWConfig, \
    adamw as jadamw
from repro_torch.configs import dcn_v2 as tdcn
from repro_torch.kernels import autograd as ag
from repro_torch.kernels.embedding_bag.ref import ref_embedding_bag
from repro_torch.launch import steps
from repro_torch.launch import train as launch_train
from repro_torch.models import recsys as trecsys
from repro_torch.models.layers import from_numpy
from repro_torch.train.optimizer import named

JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
LR = 1e-3


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bfloat16 ulp at |x| (7 stored mantissa bits)."""
    return np.spacing(np.abs(x).astype(np.float32)) * 65536.0


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _table_gate(flat: np.ndarray, g_rows: np.ndarray, rows: int,
                dtype) -> np.ndarray:
    """The per-element gate of a table gradient: ``flat`` [N] row ids,
    ``g_rows`` [N, D] the gradient row each lookup adds (float32
    values)."""
    count = np.bincount(flat, minlength=rows).astype(np.float32)[:, None]
    mag = np.zeros((rows, g_rows.shape[1]), np.float32)
    np.add.at(mag, flat, np.abs(g_rows))
    if dtype == torch.float32:
        return count * 2.0 ** -23 * mag + 1e-7
    return 0.5 * count * bf16_ulp(mag) * (count > 1)


def _smoke(dtype):
    j = dataclasses.replace(jdcn.make_smoke_config(),
                            dtype=JAX_DTYPE[dtype])
    t = dataclasses.replace(tdcn.make_smoke_config(), dtype=dtype)
    return j, t


# --------------------------------------------------------------------------
# The two Functions
# --------------------------------------------------------------------------

LOOKUPS = [  # (hot, combine, repeated): one-hot, multi-hot, one hot row
    (0, "sum", False), (3, "sum", False), (3, "mean", False),
    (0, "sum", True), (4, "mean", True)]


def _lookup_case(cfg, b: int, hot: int, repeated: bool, seed: int):
    rng = np.random.default_rng(seed)
    shape = (b,) if not hot else (b, hot)
    idx = np.stack([rng.integers(0, s, shape) for s in cfg.table_sizes], 1)
    if repeated:
        idx[: b // 2] = 3              # half the batch on one row a table
    cot = rng.standard_normal((b, cfg.n_sparse, cfg.embed_dim))
    return idx.astype(np.int32), cot.astype(np.float32)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("hot,combine,repeated", LOOKUPS)
def test_lookup_gradient_matches_reference(hot, combine, repeated, dtype):
    """``fused_lookup``'s table gradient (the embedding-bag Function)
    against ``jax.grad`` of the reference's ``fused_lookup`` on the
    smoke config, and against torch.autograd through the plain lookup,
    under the gate derived above."""
    jcfg, tcfg = _smoke(dtype)
    jtable = jrecsys.init(jax.random.PRNGKey(1), jcfg)["table"]
    table = from_numpy(np.asarray(jtable)).requires_grad_(True)
    idx, cot = _lookup_case(tcfg, 64, hot, repeated, seed=hot + 7)
    offs = tcfg.row_offsets
    jcot = jnp.asarray(cot, JAX_DTYPE[dtype])
    want = jax.grad(lambda t: jnp.sum(jrecsys.fused_lookup(
        t, jnp.asarray(idx), jnp.asarray(offs), combine).astype(
        jnp.float32) * jcot.astype(jnp.float32)))(jtable)
    tcot = from_numpy(np.asarray(jcot))
    out = trecsys.fused_lookup(table, torch.from_numpy(idx),
                               torch.from_numpy(offs.astype(np.int32)),
                               combine)
    (got,) = torch.autograd.grad((out.float() * tcot.float()).sum(), table)
    assert got.dtype == dtype and got.shape == table.shape

    flat = (idx + (offs[None, :, None] if hot else offs[None, :])
            ).reshape(-1)
    g_rows = _np(tcot).reshape(-1, tcfg.embed_dim)
    if hot:
        g_rows = np.repeat(g_rows / (hot if combine == "mean" else 1), hot,
                           0)
    gate = _table_gate(flat, g_rows, tcfg.total_rows, dtype)
    assert np.all(np.abs(_np(got) - _np(want)) <= gate)
    assert np.all(_np(got)[np.bincount(flat, minlength=table.shape[0])
                           == 0] == 0)

    # torch.autograd through the plain lookup: the same function
    plain = ref_embedding_bag(table, torch.from_numpy(
        flat.astype(np.int32)).reshape(-1, max(hot, 1)), combine)
    (want_t,) = torch.autograd.grad(
        (plain.float() * tcot.reshape(plain.shape).float()).sum(), table)
    assert np.all(np.abs(_np(got) - _np(want_t)) <= gate)


@pytest.mark.parametrize("combine", ("sum", "mean"))
def test_table_grad_is_a_sorted_segment_sum(combine):
    """``table_grad`` launches the gather and the sorted body (here their
    plain versions) and equals an fp32 index_add_ of the repeated rows,
    rounded once: the same terms in the same order."""
    rng = np.random.default_rng(4)
    idx = torch.from_numpy(rng.integers(0, 40, (300, 5)).astype(np.int32))
    g = torch.from_numpy(rng.standard_normal((300, 8)).astype(
        np.float32)).bfloat16()
    got = ag.table_grad(g, idx, 40, combine)
    rows = (g / 5 if combine == "mean" else g).repeat_interleave(5, 0)
    want = torch.zeros((40, 8)).index_add_(
        0, idx.reshape(-1).long(), rows.float()).bfloat16()
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def _segment_case(n: int, d: int, segs: int, sort: bool, seed: int):
    rng = np.random.default_rng(seed)
    ids = rng.integers(-2, segs + 2, n)          # both ends drop rows
    ids = np.sort(ids) if sort else ids
    shape = (n, d) if d else (n,)
    return (rng.standard_normal(shape).astype(np.float32),
            ids.astype(np.int32),
            rng.standard_normal((segs, d) if d else (segs,)).astype(
                np.float32))


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("n,d,segs,sort", [(200, 8, 30, True),
                                           (200, 8, 30, False),
                                           (150, 0, 20, False)])
def test_segment_sum_gradient_matches_reference(n, d, segs, sort, dtype):
    """The segment-sum Function's gradient (a gather; 0 for a dropped
    row) equals ``jax.grad`` of ``jax.ops.segment_sum`` exactly: a
    gather rounds nothing."""
    data, ids, cot = _segment_case(n, d, segs, sort, seed=n + segs)
    jd = jnp.asarray(data, JAX_DTYPE[dtype])
    jc = jnp.asarray(cot, JAX_DTYPE[dtype])
    want = jax.grad(lambda x: jnp.sum(jax.ops.segment_sum(
        x, jnp.asarray(ids), segs).astype(jnp.float32)
        * jc.astype(jnp.float32)))(jd)
    x = from_numpy(np.asarray(jd)).requires_grad_(True)
    out = ag.segment_reduce(x, torch.from_numpy(ids), segs,
                            indices_are_sorted=sort)
    (got,) = torch.autograd.grad(
        (out.float() * from_numpy(np.asarray(jc)).float()).sum(), x)
    assert got.dtype == dtype
    np.testing.assert_array_equal(_np(got), _np(want))


def test_segment_sum_gradient_without_segments_is_zero():
    """No segment: every row is dropped, so every row's gradient is 0
    (the reference's gather refuses this shape)."""
    x = torch.ones((5, 4), requires_grad=True)
    out = ag.segment_reduce(x, torch.arange(5, dtype=torch.int32), 0)
    (got,) = torch.autograd.grad(out.sum(), x, allow_unused=True)
    assert got is None or torch.equal(got, torch.zeros((5, 4)))
    assert torch.equal(ag.gather_rows(torch.zeros((0, 4)), torch.arange(
        5, dtype=torch.int32), 0), torch.zeros((5, 4)))


@pytest.mark.parametrize("op", ("min", "max"))
def test_segment_min_max_have_no_gradient(op):
    x = torch.ones((4, 2), requires_grad=True)
    ids = torch.tensor([0, 0, 1, 1], dtype=torch.int32)
    with pytest.raises(NotImplementedError, match=op):
        ag.segment_reduce(x, ids, 2, op=op)
    with torch.no_grad():                         # no gradient asked: runs
        assert ag.segment_reduce(x, ids, 2, op=op).shape == (2, 2)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("combine", ("sum", "mean"))
def test_ragged_embedding_bag_gradient_matches_reference(combine, dtype):
    """``recsys.embedding_bag`` (the lookup, then the segment sum) on
    shuffled ragged bags: its table gradient against the reference's
    ``jax.grad``, under the lookup's gate (each lookup adds its bag's
    gradient row, divided by the bag's length for mean)."""
    rng = np.random.default_rng(9)
    lengths = rng.integers(0, 5, 40)
    bag_ids = rng.permutation(np.repeat(np.arange(40), lengths)).astype(
        np.int32)
    idx = rng.integers(0, 60, bag_ids.shape[0]).astype(np.int32)
    jtable = jnp.asarray(rng.standard_normal((60, 8)), JAX_DTYPE[dtype])
    jcot = jnp.asarray(rng.standard_normal((40, 8)), JAX_DTYPE[dtype])
    want = jax.grad(lambda t: jnp.sum(jrecsys.embedding_bag(
        t, jnp.asarray(idx), jnp.asarray(bag_ids), 40, combine).astype(
        jnp.float32) * jcot.astype(jnp.float32)))(jtable)
    table = from_numpy(np.asarray(jtable)).requires_grad_(True)
    out = trecsys.embedding_bag(table, torch.from_numpy(idx),
                                torch.from_numpy(bag_ids), 40, combine)
    tcot = from_numpy(np.asarray(jcot))
    (got,) = torch.autograd.grad((out.float() * tcot.float()).sum(), table)
    g_rows = _np(tcot)[bag_ids]
    if combine == "mean":
        g_rows = g_rows / np.maximum(lengths, 1)[bag_ids, None]
    gate = _table_gate(idx, g_rows, 60, dtype)
    if combine == "mean" and dtype == torch.bfloat16:
        gate = gate + bf16_ulp(_np(want))    # g / count rounds on each side
    assert np.all(np.abs(_np(got) - _np(want)) <= gate)


# --------------------------------------------------------------------------
# Whole train steps
# --------------------------------------------------------------------------

def _reference_run(jcfg, steps_: int, b: int, seed: int = 0):
    opt = jadamw(JAdamWConfig(lr=LR))
    state = jts.create(jrecsys.init(jax.random.PRNGKey(seed), jcfg), opt)
    start = jax.tree.map(np.asarray, state)
    step = jax.jit(jts.make_train_step(
        lambda p, bb: jrecsys.loss_fn(p, bb, jcfg), opt))
    metrics = []
    for i in range(steps_):
        batch = jdp.recsys_batch(1, i, b, jcfg.n_dense, jcfg.table_sizes)
        state, m = step(state, jax.tree.map(jnp.asarray, batch))
        metrics.append({k: float(v) for k, v in m.items()})
    return start, jax.tree.map(np.asarray, state), metrics


@pytest.mark.parametrize("seed", (0, 1))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_train_steps_match_reference(dtype, seed):
    """``state_from_reference``, then 3 steps of the ``train_batch``
    cell's step on the smoke config (B = 16): loss, grad norm, params,
    m and v against 3 reference steps under ``jax.jit``."""
    jcfg, tcfg = _smoke(dtype)
    n_steps, b = 3, 16
    start, want, jm = _reference_run(jcfg, n_steps, b, seed)
    state = trecsys.state_from_reference(start, tcfg, device="cpu")
    cell = steps.build_cell("dcn-v2", "train_batch", device="cpu")
    tm = []
    for i in range(n_steps):
        batch = jdp.recsys_batch(1, i, b, tcfg.n_dense, tcfg.table_sizes)
        state, m = cell.step(state, batch)
        tm.append({k: float(v) for k, v in m.items()})
    assert int(state["step"]) == n_steps and state["step"].dtype == \
        torch.int32
    eps = 1e-6 if dtype == torch.float32 else (b / 2) * 2.0 ** -8
    for got, exp in zip(tm, jm):
        for k in ("loss", "grad_norm"):
            assert got[k] == pytest.approx(exp[k], rel=eps, abs=1e-6), k
    parts = {"params": (named(state["params"]), named(want["params"])),
             "m": (state["opt"]["m"], named(want["opt"]["m"])),
             "v": (state["opt"]["v"], named(want["opt"]["v"]))}
    for part, (got_leaves, want_leaves) in parts.items():
        assert got_leaves.keys() == want_leaves.keys()
        for n, got in got_leaves.items():
            g, w = _np(got), _np(want_leaves[n])
            assert got.dtype == dtype, (part, n)
            if dtype == torch.float32:
                np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-6,
                                           err_msg=f"{part} {n}")
                continue
            own = n_steps * bf16_ulp(np.maximum(np.abs(g), np.abs(w)))
            top = np.abs(w).max()
            gate = own + {"params": n_steps * 2 * eps * LR,
                          "m": eps * top, "v": 2 * eps * top}[part]
            assert np.all(np.abs(g - w) <= gate), (part, n)
            if part != "params":
                continue
            # At |p| >= 1/8 the gate's t ulps exceed all that t steps at
            # lr 1e-3 can move p, so it alone would pass a port that
            # skipped the update. The change from the start is held to
            # the reference's, summed over the leaf: a skipped update is
            # off by all of it, while a rounding flip or the gradient's
            # error moves a few elements by a few ulps (seen: under 0.5%
            # of the leaf's movement).
            moved = np.abs(w - _np(named(start["params"])[n])).sum()
            if moved > 0:
                assert np.abs(g - w).sum() <= 0.25 * moved, (part, n)


def test_state_from_reference_carries_every_bit():
    jcfg, tcfg = _smoke(torch.bfloat16)
    start, _, _ = _reference_run(jcfg, 0, 8)
    state = trecsys.state_from_reference(start, tcfg, device="cpu")
    assert all(p.requires_grad for p in state["params"].parameters())
    for part, got in (("params", named(state["params"])),
                      ("m", state["opt"]["m"]), ("v", state["opt"]["v"])):
        want = named(start["params"] if part == "params"
                     else start["opt"][part])
        for n, t in got.items():
            assert t.dtype == torch.bfloat16
            assert torch.equal(t.detach(), from_numpy(want[n])), (part, n)
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0


def test_train_cell_builds_and_allocates_nothing():
    cell = steps.build_cell("dcn-v2", "train_batch", device="cpu")
    assert (cell.arch, cell.shape, cell.kind) == ("dcn-v2", "train_batch",
                                                  "train")
    state, bspec = cell.args
    assert state["params"]["table"] == ((19_297_856, 16), torch.bfloat16)
    assert state["opt"]["m"] == state["opt"]["v"] == state["params"]
    assert state["step"] == ((), torch.int32)
    assert bspec["sparse_idx"] == ((65536, 26), torch.int32)
    assert callable(cell.init_state)
    assert steps.build_cell("dcn-v2", "serve_p99",
                            device="cpu").init_state is None


def test_train_cell_refuses_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        steps.build_cell("dcn-v2", "train_batch")


def test_launcher_trains_and_recovers(tmp_path, capsys):
    rc = launch_train.main(["--arch", "dcn-v2", "--steps", "30",
                            "--batch", "8", "--ckpt", str(tmp_path / "ck"),
                            "--ckpt-every", "10", "--fail-at", "15",
                            "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert re.search(r"35 steps, 1 restarts", out), out
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "step_00000010", "step_00000020", "step_00000030"]


@pytest.mark.parametrize("arch", ("nequip", "gin-tu", "gatedgcn",
                                  "graphsage-reddit"))
def test_launcher_refuses_the_unported_families(arch, capsys):
    """No family is unported any more: the launcher trains every GNN id
    (two steps of its smoke config) and refuses only an unknown id."""
    assert launch_train.main(["--arch", arch, "--steps", "2", "--device",
                              "cpu"]) == 0
    assert re.search(rf"\[train\] {re.escape(arch)} on cpu: 2 steps, 0 "
                     r"restarts", capsys.readouterr().out)
    with pytest.raises(KeyError, match="unknown arch"):
        launch_train.main(["--arch", "no-such-arch", "--device", "cpu"])
