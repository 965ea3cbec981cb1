"""repro_torch's roofline (``roofline.analysis``), on the CPU: the cost
model counts exactly 2MNK FLOPs for a matmul and k times that for a
loop of k, on the CPU and on ``meta`` (where repeated ops are
memoized); an elementwise op's bytes are its input plus its output; the
kernel wrappers report their work on ``meta``; the ``Roofline`` record
has the reference's ``as_dict`` keys; the bound model holds the values
``chip_smoke.py`` printed before it moved here."""
import sys
from pathlib import Path

import pytest
import torch

from repro.roofline import analysis as JR
from repro_torch.kernels.embedding_bag import ops as eb_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.segment_reduce import ops as sr_ops
from repro_torch.roofline import analysis as RA

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("device", ("cpu", "meta"))
@pytest.mark.parametrize("k", (1, 5))
def test_matmul_flops_exact_and_loop_multiplies(device, k):
    m, n, kk = 48, 40, 24
    a = torch.empty((m, kk), device=device)
    b = torch.empty((kk, n), device=device)

    def loop():
        for _ in range(k):
            out = a @ b
        return out
    out, c = RA.cost(loop)
    assert out.shape == (m, n) and out.device.type == device
    assert c.flops == {"float32": 2.0 * m * n * kk * k}
    assert c.ops == k
    assert c.bytes == k * 4 * (m * kk + kk * n + m * n)


def test_bf16_flops_go_to_the_tensor_core_peak():
    a = torch.zeros((64, 32), dtype=torch.bfloat16)
    b = torch.zeros((32, 16), dtype=torch.bfloat16)
    _, c = RA.cost(lambda: a @ b)
    assert c.flops == {"bfloat16": 2.0 * 64 * 32 * 16}
    assert c.t_compute == pytest.approx(2.0 * 64 * 32 * 16 / 989e12)


@pytest.mark.parametrize("device", ("cpu", "meta"))
def test_elementwise_bytes_are_input_plus_output(device):
    x = torch.zeros(1000, device=device)
    y = torch.zeros(1000, device=device)
    _, c = RA.cost(lambda: x * 2)
    assert c.bytes == 2 * 4000 and c.total_flops == 0
    _, c = RA.cost(lambda: x + y)
    assert c.bytes == 3 * 4000
    _, c = RA.cost(lambda: x.add_(1))           # in place: read and write
    assert c.bytes == 2 * 4000
    _, c = RA.cost(lambda: x.view(10, 100).t())  # views move nothing
    assert c.bytes == 0 and c.ops == 2


def test_gathers_and_scatters_count_rows_moved_not_the_table():
    table = torch.zeros((10_000, 16))
    idx = torch.zeros(50, dtype=torch.long)
    _, c = RA.cost(lambda: table[idx])
    assert c.bytes == 8 * 50 + 2 * 50 * 16 * 4
    rows = torch.zeros((50, 16))
    _, c = RA.cost(lambda: table.index_add_(0, idx, rows))
    assert c.bytes == 8 * 50 + 3 * 50 * 16 * 4


def test_backward_on_meta_counts_forward_and_backward():
    a = torch.empty((64, 32), device="meta", requires_grad=True)
    b = torch.empty((32, 16), device="meta")

    def step():
        (a @ b).sum().backward()
    _, c = RA.cost(step)
    # forward 2MNK, backward dA = dY @ B^T another 2MNK
    assert c.flops == {"float32": 2 * 2.0 * 64 * 32 * 16}


def test_kernel_wrappers_report_their_work_on_meta():
    table = torch.empty((1000, 16), dtype=torch.bfloat16, device="meta")
    ids = torch.empty((64, 3), dtype=torch.int32, device="meta")
    out, c = RA.cost(lambda: eb_ops.embedding_bag(table, ids))
    assert out.shape == (64, 16) and out.device.type == "meta"
    assert c.kernels == {"embedding_bag": {
        "launches": 1, "bytes": 64 * 3 * (4 + 32) + 64 * 32, "flops": 0.0}}
    data = torch.empty((100, 8), device="meta")
    seg = torch.empty(100, dtype=torch.int32, device="meta")
    out, c = RA.cost(lambda: sr_ops.segment_reduce(data, seg, 30))
    assert out.shape == (30, 8)
    assert c.kernels["segment_reduce"]["bytes"] == 100 * (32 + 4) + 30 * 32
    q = torch.empty((2, 256, 8, 64), dtype=torch.bfloat16, device="meta")
    k = torch.empty((2, 256, 4, 64), dtype=torch.bfloat16, device="meta")
    out, c = RA.cost(lambda: fa_ops.flash_attention(q, k, k, window=100))
    pairs = fa_ops.causal_pairs(256, 256, 100)
    assert pairs == 100 * 101 // 2 + 156 * 100
    assert c.flops == {"bfloat16": 4.0 * 64 * 8 * 2 * pairs}
    assert c.kernels["flash_attention_wgmma"]["launches"] == 1
    assert c.bytes == 2 * (q.numel() + k.numel()) * 2


def test_causal_pairs_counts_the_mask():
    for sq, sk, w in ((7, 7, 0), (7, 7, 3), (5, 9, 0), (9, 5, 4)):
        want = sum(1 for i in range(sq) for j in range(sk)
                   if j <= i and (w <= 0 or i - j < w))
        assert fa_ops.causal_pairs(sq, sk, w) == want, (sq, sk, w)


def test_as_dict_keys_equal_the_reference():
    c = RA.Cost(flops={"bfloat16": 4e12}, bytes=3e9)
    got = RA.analyze(c, arch="a", shape="s", model_flops=2e12)
    want = JR.Roofline("a", "s", 1, 1.0, 1.0, 0.0, 1.0, 1.0, 0.0,
                       "compute", {}, 2.0)
    assert got.as_dict().keys() == want.as_dict().keys()
    d = got.as_dict()
    assert d["chips"] == 1 and d["collectives"] == {}
    assert d["wire_gbytes_per_chip"] == d["t_collective"] == 0.0
    assert d["hlo_gflops_per_chip"] == 4000.0
    assert d["hlo_gbytes_per_chip"] == 3.0
    assert d["useful_flop_ratio"] == 0.5
    assert d["bottleneck"] == "compute"
    assert d["step_time_bound_s"] == pytest.approx(4e12 / 989e12)


def test_bound_model_holds_chip_smokes_values():
    assert (RA.HBM_BYTES_PER_S, RA.FP32_OPS_PER_S, RA.BF16_OPS_PER_S,
            RA.SECTOR) == (3.35e12, 67e12, 989e12, 32)
    assert RA.bound_ms(3.35e9) == pytest.approx(1.0)
    assert RA.bound(3.35e9, 67e9 / 2) == (pytest.approx(1.0), "bytes")
    assert RA.bound(3.35e8, 67e9) == (pytest.approx(1.0), "operations")
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    for name in ("HBM_BYTES_PER_S", "FP32_OPS_PER_S", "BF16_OPS_PER_S",
                 "SECTOR", "bound_ms", "bound"):
        assert getattr(chip_smoke, name) is getattr(RA, name), name


def test_memoized_meta_ops_never_stand_in_for_real_ones():
    """A factory op has no tensor argument to tell its device by: after
    the same call made a ``meta`` tensor, a real one is still real."""
    def f():
        a = torch.zeros(5, device="meta") + 1
        b = torch.zeros(5) + 1
        c = torch.zeros(5, device="meta") + 1
        return a, b, c
    (a, b, c), cost = RA.cost(f)
    assert (a.device.type, b.device.type, c.device.type) == (
        "meta", "cpu", "meta")
    assert torch.equal(b, torch.ones(5)) and cost.ops == 6
    assert cost.bytes == 3 * 20 + 3 * 40
