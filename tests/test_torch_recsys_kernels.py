"""The plain versions behind repro_torch's embedding_bag and
segment_reduce kernels against the reference's Pallas kernels, run as
the reference's own tests run them on the CPU (``interpret=True``).
Same numpy inputs through both, through the port's wrappers (which take
the plain version for a CPU tensor). The kernels themselves run only on
the card: ``tests/test_torch_cuda.py``.

Tolerances: a bag of 1 is a gather, bit-equal. A float32 bag sum may be
taken in another order by XLA: atol = rtol = 1e-6 on the reference's
grid (bags of 4 and 8); a bag of 26 runs past that (1.5e-6 seen on sums
of partial magnitude ~10), so it is held to the bound of two float32
summation orders, 2 * bag * 2^-24 * sum|row|. A bfloat16 bag is
summed in fp32 and rounded once on both sides: at most one bfloat16 ulp
(bit-equal expected). A float32 segment sum: atol = rtol = 1e-5 (the
reference's own tolerance); min and max are exact: bit-equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag import ops as jeb_ops
from repro.kernels.segment_reduce import ops as jsr_ops
from repro_torch.kernels.embedding_bag import ops as eb_ops
from repro_torch.kernels.segment_reduce import ops as sr_ops
from repro_torch.kernels.segment_reduce.ref import reduce_identity
from repro_torch.models import recsys
from repro_torch.models.layers import from_numpy

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, DTYPES[dtype][0])
    return j, from_numpy(np.asarray(j))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bfloat16 ulp at |x| (7 stored mantissa bits)."""
    return np.spacing(np.abs(x).astype(np.float32)) * 65536.0


def assert_within_bf16_ulp(got: np.ndarray, want: np.ndarray) -> None:
    err = np.abs(got - want)
    assert np.all(err <= bf16_ulp(want)), float(err.max())


# the grid of tests/test_kernels.py::test_embedding_bag, plus a bag of
# 26 (the feature count)
EB_GRID = [(100, 16, 256, 4), (1000, 32, 512, 1), (64, 8, 256, 8),
           (500, 16, 256, 26)]


@pytest.mark.parametrize("dtype", tuple(DTYPES))
@pytest.mark.parametrize("combine", ("sum", "mean"))
@pytest.mark.parametrize("rows,dim,bags,hot", EB_GRID)
def test_embedding_bag_plain_matches_pallas_interpret(rows, dim, bags, hot,
                                                      combine, dtype):
    rng = np.random.default_rng(rows + hot)
    jt, tt = _pair(rng.standard_normal((rows, dim)), dtype)
    idx = rng.integers(0, rows, (bags, hot)).astype(np.int32)
    want = np.asarray(jeb_ops.embedding_bag_pallas(
        jt, jnp.asarray(idx), combine=combine, interpret=True), np.float32)
    got = eb_ops.embedding_bag(tt, torch.from_numpy(idx), combine=combine)
    assert got.dtype == tt.dtype and got.shape == (bags, dim)
    if hot == 1:
        np.testing.assert_array_equal(_np(got), want)
    elif dtype == "float32" and hot <= 8:
        np.testing.assert_allclose(_np(got), want, atol=1e-6, rtol=1e-6)
    elif dtype == "float32":
        bound = 2 * hot * 2.0 ** -24 * np.abs(
            np.asarray(jt)[idx]).sum(axis=1)
        assert np.all(np.abs(_np(got) - want) <= bound)
    else:
        assert_within_bf16_ulp(_np(got), want)


@pytest.mark.parametrize("bags", (1, 255, 300))
def test_embedding_bag_wrapper_needs_no_tile_padding(bags):
    """The reference's wrapper pads B to its bag tile; the port's has no
    tile, and any B gives the reference's rows."""
    rng = np.random.default_rng(bags)
    table = rng.standard_normal((40, 8)).astype(np.float32)
    idx = rng.integers(0, 40, (bags, 3)).astype(np.int32)
    want = np.asarray(jeb_ops.embedding_bag(
        jnp.asarray(table), jnp.asarray(idx), combine="mean",
        interpret=True))
    got = eb_ops.embedding_bag(torch.from_numpy(table),
                               torch.from_numpy(idx), combine="mean")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


def test_embedding_bag_wrapper_rejects_bad_arguments():
    table = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="combine"):
        eb_ops.embedding_bag(table, torch.zeros((2, 1), dtype=torch.int32),
                             combine="max")
    with pytest.raises(ValueError, match=r"\[B, bag\]"):
        eb_ops.embedding_bag(table, torch.zeros((2,), dtype=torch.int32))
    with pytest.raises(ValueError, match=r"\[B, bag\]"):
        eb_ops.embedding_bag(table, torch.zeros((2, 0), dtype=torch.int32))


# the grid of tests/test_kernels.py::test_segment_reduce
SR_GRID = [(256, 16, 16, 128), (1024, 32, 64, 1024), (512, 8, 1, 256)]


@pytest.mark.parametrize("op", ("sum", "min", "max"))
@pytest.mark.parametrize("n,d,segs,tile", SR_GRID)
def test_segment_reduce_plain_matches_pallas_interpret(op, n, d, segs, tile):
    rng = np.random.default_rng(n + d)
    vals = rng.standard_normal((n, d)).astype(np.float32)
    ids = np.sort(rng.integers(0, segs, n)).astype(np.int32)
    want = np.asarray(jsr_ops.segment_reduce_pallas(
        jnp.asarray(vals), jnp.asarray(ids), segs, op=op, tile=tile,
        interpret=True))
    got = sr_ops.segment_reduce(torch.from_numpy(vals),
                                torch.from_numpy(ids), segs, op=op).numpy()
    if op == "sum":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op", ("sum", "min", "max"))
def test_segment_reduce_empty_segments_hold_identity(op):
    rng = np.random.default_rng(1)
    vals = rng.standard_normal((128, 4)).astype(np.float32)
    ids = np.full((128,), 3, np.int32)             # all in one segment
    want = np.asarray(jsr_ops.segment_reduce_pallas(
        jnp.asarray(vals), jnp.asarray(ids), 8, op=op, tile=128,
        interpret=True))
    got = sr_ops.segment_reduce(torch.from_numpy(vals),
                                torch.from_numpy(ids), 8, op=op).numpy()
    np.testing.assert_array_equal(np.delete(got, 3, axis=0),
                                  np.full((7, 4), reduce_identity(op),
                                          np.float32))
    if op == "sum":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op", ("sum", "min", "max"))
def test_segment_reduce_1d_data_matches_reference_wrapper(op):
    """1-D data (the reference's wrapper squeezes it through [N, 1]),
    with a ragged N that the reference pads to its tile."""
    rng = np.random.default_rng(2)
    vals = rng.standard_normal(300).astype(np.float32)
    ids = np.sort(rng.integers(0, 20, 300)).astype(np.int32)
    want = np.asarray(jsr_ops.segment_reduce(
        jnp.asarray(vals), jnp.asarray(ids), 24, op=op, tile=128,
        interpret=True))
    got = sr_ops.segment_reduce(torch.from_numpy(vals),
                                torch.from_numpy(ids), 24, op=op).numpy()
    assert got.shape == (24,)
    if op == "sum":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op", ("min", "max"))
def test_segment_reduce_bf16_min_max_bit_equal(op):
    rng = np.random.default_rng(3)
    jv, tv = _pair(rng.standard_normal((256, 16)), "bfloat16")
    ids = np.sort(rng.integers(0, 40, 256)).astype(np.int32)
    want = np.asarray(jsr_ops.segment_reduce_pallas(
        jv, jnp.asarray(ids), 48, op=op, tile=128, interpret=True),
        np.float32)
    got = sr_ops.segment_reduce(tv, torch.from_numpy(ids), 48, op=op)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("op", ("sum", "min", "max"))
def test_segment_reduce_drops_out_of_range_ids(op):
    rng = np.random.default_rng(4)
    vals = rng.standard_normal((64, 3)).astype(np.float32)
    ids = rng.integers(-3, 12, 64).astype(np.int32)
    fn = {"sum": jax.ops.segment_sum, "min": jax.ops.segment_min,
          "max": jax.ops.segment_max}[op]
    want = np.asarray(fn(jnp.asarray(vals), jnp.asarray(ids),
                         num_segments=10))
    got = sr_ops.segment_reduce(torch.from_numpy(vals),
                                torch.from_numpy(ids), 10, op=op).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_segment_reduce_wrapper_rejects_bad_arguments():
    data = torch.zeros((4, 2))
    with pytest.raises(ValueError, match="op"):
        sr_ops.segment_reduce(data, torch.zeros(4, dtype=torch.int32), 2,
                              op="mean")
    with pytest.raises(ValueError, match="segment_ids"):
        sr_ops.segment_reduce(data, torch.zeros(3, dtype=torch.int32), 2)


# sorted ids (the ragged embedding bag's), some segments empty: (n, d,
# segments); d = 1 runs the wrapper's 1-D path
SORTED_GRID = [(256, 16, 40), (1000, 8, 300), (300, 1, 24)]
JAX_SEGMENT_OPS = {"sum": jax.ops.segment_sum, "min": jax.ops.segment_min,
                   "max": jax.ops.segment_max}


def _sorted_case(n: int, d: int, segs: int, lo: int, hi: int, dtype: str):
    rng = np.random.default_rng(n + d + segs)
    ids = np.sort(rng.integers(lo, hi, n)).astype(np.int32)
    shape = (n,) if d == 1 else (n, d)
    jv, tv = _pair(rng.standard_normal(shape), dtype)
    return ids, jv, tv


def _both_bodies(tv, ids, segs, op):
    """The sorted and the unsorted call, which must agree."""
    got = sr_ops.segment_reduce(tv, torch.from_numpy(ids), segs, op=op,
                                indices_are_sorted=True)
    unsorted = sr_ops.segment_reduce(tv, torch.from_numpy(ids), segs, op=op)
    assert got.dtype == tv.dtype and got.shape == unsorted.shape
    assert torch.equal(got, unsorted)
    return got


@pytest.mark.parametrize("dtype", tuple(DTYPES))
@pytest.mark.parametrize("op", ("sum", "min", "max"))
@pytest.mark.parametrize("n,d,segs", SORTED_GRID)
def test_segment_reduce_sorted_matches_unsorted_and_reference(n, d, segs,
                                                              op, dtype):
    """``indices_are_sorted=True`` gives the unsorted call's result and
    the reference kernel's (interpret): float32 sums within 1e-5, bf16
    sums within one ulp of the fp32 sum (the reference kernel sums bf16
    rows in bf16, so it is held to min / max only), min / max
    bit-equal."""
    ids, jv, tv = _sorted_case(n, d, segs, 0, segs, dtype)
    got = _np(_both_bodies(tv, ids, segs, op))
    if op != "sum" or dtype == "float32":
        want = np.asarray(jsr_ops.segment_reduce(
            jv, jnp.asarray(ids), segs, op=op, tile=128, interpret=True),
            np.float32)
        if op == "sum":
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        else:
            np.testing.assert_array_equal(got, want)
    if op == "sum" and dtype == "bfloat16":
        assert_within_bf16_ulp(got, np.asarray(jax.ops.segment_sum(
            jv.astype(jnp.float32), jnp.asarray(ids), num_segments=segs,
            indices_are_sorted=True)))


@pytest.mark.parametrize("dtype", tuple(DTYPES))
@pytest.mark.parametrize("op", ("sum", "min", "max"))
def test_segment_reduce_sorted_drops_out_of_range_ids_at_both_ends(op,
                                                                   dtype):
    """Sorted ids that start below 0 and end at or past S: those rows are
    dropped, as ``jax.ops.segment_*(indices_are_sorted=True)`` drops
    them."""
    ids, jv, tv = _sorted_case(200, 4, 10, -3, 14, dtype)
    assert ids[0] < 0 and ids[-1] >= 10
    got = _np(_both_bodies(tv, ids, 10, op))
    want = np.asarray(JAX_SEGMENT_OPS[op](
        jv.astype(jnp.float32), jnp.asarray(ids), num_segments=10,
        indices_are_sorted=True))
    if op == "sum" and dtype == "bfloat16":
        assert_within_bf16_ulp(got, want)
    elif op == "sum":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op", ("sum", "min", "max"))
def test_segment_reduce_sorted_empty_input(op):
    """N = 0 rows: every segment holds the identity."""
    got = _both_bodies(torch.empty((0, 3)), np.empty(0, np.int32), 4, op)
    assert torch.equal(got, torch.full((4, 3), reduce_identity(op)))


def test_embedding_bag_takes_the_sorted_body(monkeypatch):
    """``recsys.embedding_bag`` promises sorted bag ids for both of its
    segment sums (the rows, and for ``mean`` the counts), as the
    reference's ``segment_sum`` over them assumes."""
    seen = []

    def record(*args, **kw):
        seen.append(kw)
        return sr_ops.segment_reduce(*args, **kw)

    monkeypatch.setattr(recsys, "segment_reduce", record)
    table = torch.arange(40, dtype=torch.float32).reshape(10, 4)
    idx = torch.tensor([1, 2, 3, 4, 5], dtype=torch.int32)
    bags = torch.tensor([0, 0, 1, 3, 3], dtype=torch.int32)
    for combine in ("sum", "mean"):
        out = recsys.embedding_bag(table, idx, bags, 4, combine)
        want = torch.stack([table[1] + table[2], table[3],
                            torch.zeros(4), table[4] + table[5]])
        if combine == "mean":
            want = want / torch.tensor([2.0, 1.0, 1.0, 2.0])[:, None]
        assert torch.equal(out, want)
    assert len(seen) == 3
    assert all(kw.get("indices_are_sorted") is True for kw in seen)
