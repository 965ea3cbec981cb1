"""repro_torch's dry-run (``launch.dryrun``) against the reference's, on
the CPU: ``all_cells`` and ``_model_flops`` equal the reference's for
every cell; full-width dry-runs of gemma2-2b ``train_4k``, DCN-v2 and
gin-tu run on ``meta`` (nothing allocated) with the record the
reference writes; the LM train cell's counted FLOPs sit in the band
remat predicts; the CLI exits 1 when a cell fails and under
``--multi-pod``."""
import json
import os

import pytest
import torch

from repro.configs import all_cells as jall_cells
from repro.configs import cc_graphs as jcc_graphs
from repro.roofline import analysis as JR
from repro_torch.configs import all_cells
from repro_torch.launch import dryrun
from repro_torch.roofline.analysis import cost


@pytest.fixture(scope="module")
def jdry():
    """``repro.launch.dryrun``: importing it sets ``XLA_FLAGS`` for its
    own process, which must not leak to this one's later subprocesses."""
    saved = os.environ.get("XLA_FLAGS")
    import repro.launch.dryrun as mod
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    return mod


def test_all_cells_equal_the_reference():
    assert all_cells() == jall_cells()
    assert dryrun.cells_of("all")[-4:] == [
        ("cc-adaptive", s, None) for s in jcc_graphs.SHAPES]
    assert dryrun.cells_of("gin-tu") == [c for c in jall_cells()
                                         if c[0] == "gin-tu"]


def test_model_flops_equal_the_reference_for_every_cell(jdry):
    for arch, shape, _ in dryrun.cells_of("all"):
        assert dryrun._model_flops(arch, shape) == \
            jdry._model_flops(arch, shape), (arch, shape)


def _check_record(rec: dict, jdry) -> None:
    assert rec["chips"] == 1 and rec["mesh"] == dryrun.MESH
    assert rec["roofline"].keys() == JR.Roofline(
        "a", "s", 1, 0, 0, 0, 0, 0, 0, "memory", {}).as_dict().keys()
    assert rec["model_flops"] == jdry._model_flops(rec["arch"],
                                                   rec["shape"])
    assert rec["roofline"]["model_gflops"] == rec["model_flops"] / 1e9
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] == mem["state_bytes"] \
        + mem["batch_bytes"] > 0
    assert rec["ops"] > 0 and rec["roofline"]["t_memory"] > 0


def test_gemma2_train_dry_run_at_full_width(jdry, capsys):
    """One full-width AdamW step of gemma2-2b ``train_4k`` (B = 256 x
    4096, 4 microbatches, remat) on ``meta``: 2.6B bf16 parameters,
    bf16 moments and the batch as argument bytes, K6 launched as the
    forward and the remat recompute of every layer (26 x 4 x 2), and the
    counted FLOPs on remat's band. Attention is counted apart: K6's
    launches, and the backward's ``flash_attention_backward`` range, the
    blocked recompute in fp32 torch ops, 3.5 dense attention forwards a
    layer and microbatch (the forward, each block's checkpoint
    recompute, the products of its backward). The rest is forward 2N +
    recompute 2N + backward 4N a token where the model counts 6N (the
    tied embedding is the head's matmul): 8/6, to 1e-3."""
    rec = dryrun.run_cell("gemma2-2b", "train_4k")
    _check_record(rec, jdry)
    n = 2_614_341_888
    assert rec["memory"]["params_bytes"] == 2 * n
    assert rec["memory"]["state_bytes"] == 3 * 2 * n + 4
    assert rec["memory"]["batch_bytes"] == 256 * 4097 * 4
    k6 = rec["kernels"]["flash_attention_wgmma"]
    assert k6["launches"] == 26 * 4 * 2
    backward = rec["ranges"]["flash_attention_backward"]["flops"]
    b, s, hq, d = 64, 4096, 8, 256
    assert backward == 3.5 * 4 * d * hq * b * s * s * 26 * 4
    counted = rec["roofline"]["hlo_gflops_per_chip"] * 1e9
    model = rec["model_flops"]
    dense = counted - k6["flops"] - backward
    assert dense / model == pytest.approx(8 / 6, rel=1e-3)
    ratio = rec["roofline"]["useful_flop_ratio"]
    assert ratio == pytest.approx(model / counted, abs=1e-4)
    lo = model / (8 / 6 * model + k6["flops"] + backward)
    hi = model / (model + k6["flops"] + backward)
    assert lo - 1e-4 <= ratio <= hi
    assert "gemma2-2b x train_4k on 1xgpu: OK" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ("dcn-v2", "gin-tu"))
def test_full_width_cells_dry_run_on_meta(arch, jdry, tmp_path):
    out = tmp_path / "dry.jsonl"
    assert dryrun.main(["--arch", arch, "--out", str(out)]) == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    want = [(a, s) for a, s, skip in jall_cells()
            if a == arch and skip is None]
    assert [(r["arch"], r["shape"]) for r in recs] == want
    for rec in recs:
        _check_record(rec, jdry)
    if arch == "dcn-v2":
        train = recs[0]
        assert train["kind"] == "train"
        # the table's lookup (K5), its gradient (K5's gather, K4 sorted)
        assert set(train["kernels"]) == {"embedding_bag",
                                         "segment_reduce_sorted"}
        assert train["kernels"]["embedding_bag"]["launches"] == 2


def test_cc_cells_record_a_round_of_the_bound_model(tmp_path):
    out = tmp_path / "cc.jsonl"
    assert dryrun.main(["--arch", "cc-adaptive", "--shape", "usa-osm",
                        "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["kind"] == "cc" and rec["model_flops"] == 0.0
    assert rec["roofline_per"] == "round"
    rows, v = 58_000_000, 24_000_000
    assert rec["memory"]["state_bytes"] == rows * 8 + v * 4
    assert rec["roofline"]["hlo_gbytes_per_chip"] == \
        pytest.approx((8 * rows + 8 * v) / 1e9)
    # --skip-existing: the cell is cached
    assert dryrun.main(["--arch", "cc-adaptive", "--shape", "usa-osm",
                        "--out", str(out), "--skip-existing"]) == 0
    assert len(out.read_text().splitlines()) == 1


def test_cli_exits_1_when_a_cell_fails(monkeypatch, capsys):
    real = dryrun._run_model_cell

    def flaky(arch, shape):
        if shape == "molecule":
            raise RuntimeError("Tensor.item() cannot be called on meta "
                               "tensors")
        return real(arch, shape)
    monkeypatch.setattr(dryrun, "_run_model_cell", flaky)
    assert dryrun.main(["--arch", "gin-tu"]) == 1
    assert "FAILURES: [('gin-tu', 'molecule'" in capsys.readouterr().out
    assert dryrun.main(["--arch", "gin-tu", "--shape",
                        "full_graph_sm"]) == 0


def test_cli_multi_pod_fails_with_the_mesh_message(capsys):
    assert dryrun.main(["--arch", "cc-adaptive", "--shape", "usa-osm",
                        "--multi-pod"]) == 1
    err = capsys.readouterr()
    assert "2x16x16 chips) has no one-GPU analogue" in err.err + err.out


def test_a_hidden_read_back_fails_the_cell():
    """On ``meta`` a host read raises, as the reference fails to compile
    one: the dry-run cannot hide it."""
    def step(x):
        if x.sum() > 0:
            return x
        return -x
    with pytest.raises(RuntimeError, match="meta"):
        cost(step, torch.empty(4, device="meta"))
