"""Package rules of repro_torch: it loads neither JAX nor the reference
package, its host-side copies (generators, format, oracles) give exactly
the reference's output, and its entry points never fall back to the CPU
unasked."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.graphs import device as jdev
from repro.graphs import format as jfmt
from repro.graphs import generators as jgen
from repro.core import unionfind as juf
import repro_torch
from repro_torch.core import unionfind as tuf
from repro_torch.graphs import device as tdev
from repro_torch.graphs import format as tfmt
from repro_torch.graphs import generators as tgen

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|repro|ml_dtypes)\b(?!_torch)", re.MULTILINE)


def test_import_loads_no_jax_and_no_reference():
    code = ("import sys\n"
            "import repro_torch, repro_torch.core.cc, repro_torch.core.labelprop\n"
            "import repro_torch.kernels.cc_fused.ops, repro_torch.kernels.hook.ops\n"
            "import repro_torch.kernels.multi_jump.ops\n"
            "import repro_torch.graphs.generators, repro_torch.core.unionfind\n"
            "import repro_torch.models.recsys, repro_torch.configs\n"
            "import repro_torch.configs.dcn_v2, repro_torch.data.pipeline\n"
            "import repro_torch.launch.steps\n"
            "import repro_torch.kernels.embedding_bag.ops\n"
            "import repro_torch.kernels.segment_reduce.ops\n"
            "import repro_torch.kernels.autograd\n"
            "import repro_torch.kernels.flash_attention.ops\n"
            "import repro_torch.models.transformer, repro_torch.serving.engine\n"
            "import repro_torch.configs.gemma2_2b, repro_torch.configs.qwen2_5_32b\n"
            "import repro_torch.api, repro_torch.connectivity, repro_torch.obs\n"
            "import repro_torch.core.sampled, repro_torch.core.batch\n"
            "import repro_torch.connectivity.policy, repro_torch.api.solver\n"
            "import repro_torch.core.incremental, repro_torch.obs.metrics\n"
            "import repro_torch.connectivity.registry, repro_torch.obs.slo\n"
            "import repro_torch.connectivity.service, repro_torch.obs.__main__\n"
            "import repro_torch.core.distributed, repro_torch.launch.mesh\n"
            "import repro_torch.fleet, repro_torch.configs.cc_graphs\n"
            "import repro_torch.models.moe, repro_torch.configs.minicpm3_4b\n"
            "import repro_torch.configs.grok_1_314b\n"
            "import repro_torch.configs.phi3_5_moe\n"
            "import repro_torch.train.optimizer, repro_torch.train.loop\n"
            "import repro_torch.train.train_state\n"
            "import repro_torch.train.checkpoint\n"
            "import repro_torch.train.fault_tolerance\n"
            "import repro_torch.train.compression\n"
            "import repro_torch.launch.train\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.elastic\n"
            "import repro_torch.roofline.analysis, repro_torch.analysis\n"
            "import repro_torch.analysis.entries, repro_torch.analysis.__main__\n"
            "repro_torch.analysis.entries.all_entries()\n"
            "bad = [m for m in sys.modules\n"
            "       if m.split('.')[0] in ('jax', 'jaxlib', 'repro',\n"
            "                              'ml_dtypes')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_source_imports_jax_or_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        hits = FORBIDDEN.findall(f.read_text())
        assert not hits, f"{f} imports {hits}"


def test_exports():
    assert set(repro_torch.__all__) == {
        "CCResult", "DeviceGraph", "WorkCounters", "solve_hostloop",
        "solve_pallas", "solve_static", "Solver", "solve", "ExecutionPlan",
        "Backend", "Capabilities", "BACKENDS", "register_backend",
        "get_backend", "available_backends", "capability_matrix"}
    for name in repro_torch.__all__:
        assert getattr(repro_torch, name) is not None
    import repro_torch.api as api
    assert repro_torch.Solver is api.Solver
    assert repro_torch.BACKENDS is api.BACKENDS


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    edges = np.array([[0, 1], [2, 3]], np.int32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdev.DeviceGraph.from_edges(edges, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.solve_static(edges, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.solve_pallas(edges, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.solve_hostloop(edges, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.solve(edges, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.Solver.open(edges, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.Solver.solve_batch([(edges, 4)])
    from repro_torch.connectivity import ConnectivityService, GraphRegistry
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GraphRegistry()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ConnectivityService()
    g = tdev.DeviceGraph.from_edges(edges, 4, device="cpu")
    assert g.device.type == "cpu"
    assert g.edges.dtype == torch.int32


@pytest.mark.parametrize("pad_rows", (None, 64, 1000))
def test_from_reference_round_trips_plan(pad_rows):
    rng = np.random.default_rng(3)
    edges = rng.integers(0, 50, (37, 2)).astype(np.int32)
    jg = jdev.DeviceGraph.from_edges(edges, 50)
    jg = jg.pad_pow2() if pad_rows is None else jg.pad_rows(pad_rows)
    tg = tdev.DeviceGraph.from_reference(
        np.asarray(jg.edges), jg.num_nodes, jg.true_edges_static,
        jg.plan.num_segments, device="cpu")
    assert vars(tg.plan) == vars(jg.plan)
    assert tg.true_edges == jg.true_edges_static == 37
    np.testing.assert_array_equal(tg.edges.numpy(), np.asarray(jg.edges))


GENERATORS = [
    ("grid_road", lambda m: m.grid_road(23, extra_prob=0.05, seed=4)),
    ("random_uniform", lambda m: m.random_uniform(100, 300, seed=5)),
    ("rmat", lambda m: m.rmat(9, 8, seed=6)),
    ("star", lambda m: m.star(11, center=3)),
    ("chain", lambda m: m.chain(9)),
    ("disjoint_cliques", lambda m: m.disjoint_cliques(3, 5)),
    ("molecule_batch", lambda m: m.molecule_batch(4, 7, 9, d_feat=3,
                                                  seed=7)),
] + [(f"table1-{n}", lambda m, n=n: m.table1_scaled(n, scale=0.002, seed=1))
     for n in ("usa-osm", "euro-osm-karls", "soc-live-journal",
               "kron-logn21")]


@pytest.mark.parametrize("name,make", GENERATORS, ids=[g[0] for g in GENERATORS])
def test_generators_bit_identical(name, make):
    got, want = make(tgen), make(jgen)
    assert (got.num_nodes, got.name) == (want.num_nodes, want.name)
    np.testing.assert_array_equal(got.edges, want.edges)
    assert got.edges.dtype == want.edges.dtype
    if want.node_feat is not None:
        np.testing.assert_array_equal(got.node_feat, want.node_feat)
    assert got.stats() == want.stats()


def test_format_and_oracles_match_reference():
    rng = np.random.default_rng(9)
    edges = rng.integers(0, 40, (60, 2)).astype(np.int32)
    t, j = tfmt.build_csr(edges, 40), jfmt.build_csr(edges, 40)
    np.testing.assert_array_equal(t.indptr, j.indptr)
    np.testing.assert_array_equal(t.indices, j.indices)
    g = tfmt.Graph(edges=edges, num_nodes=40).pad_edges(16)
    np.testing.assert_array_equal(
        g.edges, jfmt.Graph(edges=edges, num_nodes=40).pad_edges(16).edges)
    want = juf.connected_components_oracle(edges, 40)
    np.testing.assert_array_equal(tuf.connected_components_oracle(edges, 40),
                                  want)
    np.testing.assert_array_equal(tuf.connected_components_scipy(edges, 40),
                                  want)
    assert tuf.num_components(want) == juf.num_components(want)


def test_dynamic_entry_points_refuse_cpu_fallback(monkeypatch):
    from repro_torch.core import incremental
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: incremental.IncrementalCC(4),
                 lambda: incremental.DynamicCC(4),
                 lambda: tdev.EdgeLog(4),
                 lambda: repro_torch.Solver.open(None, 4).insert([[0, 1]])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    s = incremental.DynamicCC(4, device="cpu")
    s.insert([[0, 1]])
    assert s.labels.device.type == s.log.device.type == "cpu"
