"""repro_torch's recsys data pipeline and configs against the
reference's: the same batches bit for bit per ``(seed, step)``, the same
config fields (dtypes mapped), offsets, widths and input shapes."""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import dcn_v2 as jdcn
from repro.data import pipeline as jpipe
from repro.models import recsys as jrecsys
from repro_torch import configs as tconfigs
from repro_torch.configs import dcn_v2 as tdcn
from repro_torch.data import pipeline as tpipe
from repro_torch.models import recsys as trecsys

TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16,
               "int32": torch.int32}


def _torch_dtype(jax_dtype) -> torch.dtype:
    return TORCH_DTYPE[np.dtype(jax_dtype).name]


def _assert_batches_equal(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("seed,step,batch", [(0, 0, 16), (1, 0, 512),
                                             (1, 7, 512), (42, 3, 1),
                                             (7, 100, 33)])
def test_recsys_batch_bit_identical(seed, step, batch):
    sizes = jrecsys.CRITEO_TABLE_SIZES
    _assert_batches_equal(tpipe.recsys_batch(seed, step, batch, 13, sizes),
                          jpipe.recsys_batch(seed, step, batch, 13, sizes))


def test_recsys_batches_and_stream_bit_identical():
    sizes = (100, 50, 80, 30)
    want = list(itertools.islice(
        jpipe.recsys_batches(3, 8, 5, sizes, start_step=2), 4))
    got = list(itertools.islice(
        tpipe.recsys_batches(3, 8, 5, sizes, start_step=2), 4))
    streamed = list(itertools.islice(
        tpipe.make_stream(tpipe.recsys_batches, 3, 8, 5, sizes,
                          start_step=2), 4))
    for g, s, w in zip(got, streamed, want):
        _assert_batches_equal(g, w)
        _assert_batches_equal(s, w)


def test_prefetcher_ends_and_reraises():
    assert list(tpipe.Prefetcher(iter([{"a": 1}, {"a": 2}]))) == [
        {"a": 1}, {"a": 2}]

    def broken():
        yield {"a": 1}
        raise ValueError("data failure")

    it = tpipe.Prefetcher(broken())
    assert next(it) == {"a": 1}
    with pytest.raises(ValueError, match="data failure"):
        next(it)


@pytest.mark.parametrize("make", ("make_config", "make_smoke_config"))
def test_configs_field_equal(make):
    want = getattr(jdcn, make)()
    got = getattr(tdcn, make)()
    for f in dataclasses.fields(want):
        w, g = getattr(want, f.name), getattr(got, f.name)
        if f.name == "dtype":
            assert _torch_dtype(w) == g
        else:
            assert w == g, f.name
    assert got.padded_table_sizes == want.padded_table_sizes
    assert got.total_rows == want.total_rows
    np.testing.assert_array_equal(got.row_offsets, want.row_offsets)
    assert got.d_interact == want.d_interact
    assert trecsys.param_count(got) == jrecsys.param_count(want)


def test_full_config_sizes():
    cfg = tdcn.make_config()
    assert cfg.total_rows == 19_297_856
    assert cfg.d_interact == 429
    assert cfg.dtype == torch.bfloat16
    assert trecsys.param_count(cfg) == 311_334_793


@pytest.mark.parametrize("shape", jdcn.SHAPES)
def test_input_specs_match(shape):
    want = jdcn.input_specs(shape)
    got = tdcn.input_specs(shape)
    assert got.keys() == want.keys()
    assert got["batch"].keys() == want["batch"].keys()
    for k, s in want["batch"].items():
        assert got["batch"][k] == (s.shape, _torch_dtype(s.dtype))
    if "candidate_ids" in want:
        assert got["candidate_ids"] == (want["candidate_ids"].shape,
                                        torch.int32)
    assert tdcn.step_kind(shape) == jdcn.step_kind(shape)
    assert tdcn.skip_reason(shape) == jdcn.skip_reason(shape)


def test_registry_ids_and_unported_archs():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert tconfigs.get_arch("dcn-v2") is tdcn
    assert (tdcn.ARCH_ID, tdcn.FAMILY, tdcn.SHAPES, tdcn.SHAPE_DEFS) == (
        jdcn.ARCH_ID, jdcn.FAMILY, jdcn.SHAPES, jdcn.SHAPE_DEFS)
    # every id is ported: each resolves to its module, in the reference's
    # family
    for arch in tconfigs.ARCH_IDS:
        mod = tconfigs.get_arch(arch)
        assert (mod.ARCH_ID, mod.FAMILY) == (arch,
                                             jconfigs.get_arch(arch).FAMILY)
    with pytest.raises(KeyError):
        tconfigs.get_arch("no-such-arch")
