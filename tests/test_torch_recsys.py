"""repro_torch's DCN-v2 against the reference's, with the reference's
weights carried across (``params_from_reference``): the lookups, the
forward pass, the loss and the retrieval scores, on the smoke config
and on the full dense widths (tables cut to a few thousand rows), plus
the serving entry points (``build_cell``).

Tolerances: float32, atol = rtol = 1e-5 (matmul sums are taken in
another order by XLA and by torch); bfloat16 forward, atol = rtol =
2e-2 (the two frameworks round intermediate products at other places);
one-hot lookups are gathers, bit-equal. A multi-hot bfloat16 lookup:
the port rounds a bag of H rows once, the reference's model rounds each
of its H - 1 partial sums in a bfloat16 segment_sum, each rounding at
most half an ulp of the bag's magnitude S = sum|row|; so the two differ
by at most (H/2) ulp(S) for sum and ulp(S)/2 plus the final division's
ulp for mean. Seen: up to 2 ulp(S) at H = 4 and 8, where the rows
cancel and the result is small, so one ulp OF THE RESULT does not hold.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dcn_v2 as jdcn
from repro.models import recsys as jrecsys
from repro_torch.configs import dcn_v2 as tdcn
from repro_torch.launch import steps
from repro_torch.models import recsys as trecsys

JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bfloat16 ulp at |x| (7 stored mantissa bits)."""
    return np.spacing(np.abs(x).astype(np.float32)) * 65536.0


def _configs(kind: str, dtype: torch.dtype):
    """(reference config, port config) of the same fields."""
    if kind == "smoke":
        j, t = jdcn.make_smoke_config(), tdcn.make_smoke_config()
    else:   # the full dense widths, tables cut to at most 3,000 rows
        j, t = jdcn.make_config(), tdcn.make_config()
        sizes = tuple(min(s, 3000) for s in t.table_sizes)
        j = dataclasses.replace(j, table_sizes=sizes)
        t = dataclasses.replace(t, table_sizes=sizes)
    return (dataclasses.replace(j, dtype=JAX_DTYPE[dtype]),
            dataclasses.replace(t, dtype=dtype))


@functools.cache
def _models(kind: str, dtype: torch.dtype, seed: int = 0):
    """Reference params and the port's model carrying them (shared by
    the tests, which only read them)."""
    jcfg, tcfg = _configs(kind, dtype)
    jparams = jrecsys.init(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, tcfg, trecsys.params_from_reference(
        tree, tcfg, device="cpu")


def _batch(cfg, b: int, seed: int, hot: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    shape = (b,) if not hot else (b, hot)
    idx = np.stack([rng.integers(0, s, shape) for s in cfg.table_sizes], 1)
    return {"dense": rng.standard_normal((b, cfg.n_dense)).astype(np.float32),
            "sparse_idx": idx.astype(np.int32),
            "label": rng.integers(0, 2, b).astype(np.int32)}


def _both(batch: dict):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("combine", ("sum", "mean"))
def test_embedding_bag_ragged_matches_reference(combine):
    rng = np.random.default_rng(5)
    table = rng.standard_normal((300, 16)).astype(np.float32)
    lengths = rng.integers(0, 6, 40)              # empty bags included
    bag_ids = np.repeat(np.arange(40), lengths).astype(np.int32)
    idx = rng.integers(0, 300, bag_ids.shape[0]).astype(np.int32)
    want = jrecsys.embedding_bag(jnp.asarray(table), jnp.asarray(idx),
                                 jnp.asarray(bag_ids), 40, combine)
    got = trecsys.embedding_bag(torch.from_numpy(table),
                                torch.from_numpy(idx),
                                torch.from_numpy(bag_ids), 40, combine)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("hot", (0, 3))
@pytest.mark.parametrize("combine", ("sum", "mean"))
def test_fused_lookup_matches_reference(dtype, hot, combine):
    jcfg, jparams, tcfg, model = _models("full", dtype)
    batch = _batch(tcfg, 64, seed=hot + 1, hot=hot)
    offs = np.asarray(tcfg.row_offsets)
    want = jrecsys.fused_lookup(jparams["table"],
                                jnp.asarray(batch["sparse_idx"]),
                                jnp.asarray(offs), combine)
    got = trecsys.fused_lookup(model.table,
                               torch.from_numpy(batch["sparse_idx"]),
                               model.row_offsets, combine)
    assert got.dtype == dtype and got.shape == want.shape
    if hot == 0 or dtype == torch.float32:
        np.testing.assert_array_equal(_np(got), _np(want))
        return
    flat = batch["sparse_idx"] + tcfg.row_offsets[None, :, None]
    mag = np.abs(_np(model.table)[flat]).sum(axis=2)           # S
    tol = 0.5 * hot * bf16_ulp(mag) / (hot if combine == "mean" else 1) \
        + bf16_ulp(_np(want))
    assert np.all(np.abs(_np(got) - _np(want)) <= tol)


@pytest.mark.parametrize("kind,dtype,tol", [
    ("smoke", torch.float32, 1e-5),
    ("full", torch.float32, 1e-5),
    ("full", torch.bfloat16, 2e-2)])
def test_forward_and_loss_match_reference(kind, dtype, tol):
    jcfg, jparams, tcfg, model = _models(kind, dtype)
    jb, tb = _both(_batch(tcfg, 64 if kind == "full" else 16, seed=7))
    want = jrecsys.forward(jparams, jb, jcfg)
    got = trecsys.forward(model, tb)
    assert got.dtype == dtype and got.shape == want.shape
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
    np.testing.assert_array_equal(_np(model(tb)), _np(got))
    np.testing.assert_allclose(float(trecsys.loss_fn(model, tb)),
                               float(jrecsys.loss_fn(jparams, jb, jcfg)),
                               atol=tol, rtol=tol)


def test_forward_multi_hot_matches_reference():
    jcfg, jparams, tcfg, model = _models("full", torch.float32, seed=1)
    jb, tb = _both(_batch(tcfg, 32, seed=8, hot=4))
    np.testing.assert_allclose(
        trecsys.forward(model, tb).numpy(),
        np.asarray(jrecsys.forward(jparams, jb, jcfg)), atol=1e-5,
        rtol=1e-5)


@pytest.mark.parametrize("kind,dtype,tol", [
    ("smoke", torch.float32, 1e-5),
    ("full", torch.float32, 1e-5),
    ("full", torch.bfloat16, 2e-2)])
def test_retrieval_scores_match_reference(kind, dtype, tol):
    jcfg, jparams, tcfg, model = _models(kind, dtype)
    jb, tb = _both(_batch(tcfg, 1, seed=9))
    cand = np.random.default_rng(10).integers(
        0, tcfg.table_sizes[0], 500).astype(np.int32)
    want = jrecsys.retrieval_scores(jparams, jb, jcfg, jnp.asarray(cand))
    got = trecsys.retrieval_scores(model, tb, torch.from_numpy(cand))
    assert got.dtype == torch.float32 and got.shape == (500,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)


def test_init_shapes_dtypes_and_determinism():
    cfg = tdcn.make_smoke_config()
    a = trecsys.init(cfg, generator=torch.Generator().manual_seed(3),
                     device="cpu")
    b = trecsys.init(cfg, generator=torch.Generator().manual_seed(3),
                     device="cpu")
    shapes = trecsys.param_shapes(cfg)
    got = dict(a.named_parameters())
    assert {n: tuple(p.shape) for n, p in got.items()} == shapes
    for n, p in b.named_parameters():
        assert p.dtype == cfg.dtype and not p.requires_grad
        assert torch.equal(p, got[n]), n
    assert torch.equal(a.dense_norm["w"], torch.ones(cfg.n_dense))
    assert a.row_offsets.dtype == torch.int32


def test_init_refuses_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trecsys.init(tdcn.make_smoke_config())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        steps.build_cell("dcn-v2", "serve_p99")


def test_params_from_reference_checks_dtype():
    jcfg, tcfg = _configs("smoke", torch.float32)
    tree = jax.tree.map(np.asarray, jrecsys.init(jax.random.PRNGKey(0),
                                                 jcfg))
    with pytest.raises(ValueError, match="bfloat16"):
        trecsys.params_from_reference(
            tree, dataclasses.replace(tcfg, dtype=torch.bfloat16),
            device="cpu")


@pytest.mark.parametrize("shape,kind,batch,extra", [
    ("serve_p99", "serve", 512, None),
    ("serve_bulk", "serve", 262144, None),
    ("retrieval_cand", "retrieval", 1, 1_000_000)])
def test_build_cell_kinds_and_specs(shape, kind, batch, extra):
    cell = steps.build_cell("dcn-v2", shape, device="cpu")
    assert (cell.arch, cell.shape, cell.kind) == ("dcn-v2", shape, kind)
    params, bspec = cell.args[:2]
    assert params["table"] == ((19_297_856, 16), torch.bfloat16)
    assert params["cross.2.w"] == ((429, 429), torch.bfloat16)
    assert params["head"] == ((429 + 512, 1), torch.bfloat16)
    assert bspec == {"dense": ((batch, 13), torch.float32),
                     "sparse_idx": ((batch, 26), torch.int32),
                     "label": ((batch,), torch.int32)}
    if extra is None:
        assert len(cell.args) == 2
    else:
        assert cell.args[2] == ((extra,), torch.int32)


def test_cell_steps_run_the_model_on_host_batches():
    jcfg, jparams, tcfg, model = _models("smoke", torch.float32)
    batch = _batch(tcfg, 16, seed=11)
    serve = steps.build_cell("dcn-v2", "serve_p99", device="cpu")
    np.testing.assert_array_equal(
        serve.step(model, batch).numpy(),
        trecsys.forward(model, _both(batch)[1]).numpy())
    one = _batch(tcfg, 1, seed=12)
    cand = np.arange(50, dtype=np.int32)
    retrieval = steps.build_cell("dcn-v2", "retrieval_cand", device="cpu")
    np.testing.assert_allclose(
        retrieval.step(model, one, cand).numpy(),
        np.asarray(jrecsys.retrieval_scores(
            jparams, _both(one)[0], jcfg, jnp.asarray(cand))),
        atol=1e-5, rtol=1e-5)


def test_unported_cells_raise():
    """No cell is left unported: every GNN id builds a train cell for
    each of its shapes, and refuses a recsys shape. The recsys train
    cell and the MLA and MoE LMs' train and serving cells build."""
    assert steps.build_cell("dcn-v2", "train_batch",
                            device="cpu").kind == "train"
    for arch in ("minicpm3-4b", "grok-1-314b"):
        assert steps.build_cell(arch, "train_4k",
                                device="cpu").kind == "train"
        assert steps.build_cell(arch, "decode_32k",
                                device="cpu").kind == "decode"
    for arch in ("nequip", "gatedgcn", "graphsage-reddit", "gin-tu"):
        for shape in ("full_graph_sm", "minibatch_lg", "ogb_products",
                      "molecule"):
            assert steps.build_cell(arch, shape,
                                    device="cpu").kind == "train"
        with pytest.raises(KeyError, match="train_batch"):
            steps.build_cell(arch, "train_batch", device="cpu")
    # the multi-shard CC cell is ported: it builds, allocating nothing
    cell = steps.build_cell("cc-adaptive", "usa-osm", device="cpu")
    assert (cell.kind, cell.args) == ("cc", (((58_000_000, 2),
                                              torch.int32),))
