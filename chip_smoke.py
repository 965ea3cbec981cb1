#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU. Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):

1. card and build: the card's name and power limit from ``nvidia-smi``;
   ``nvcc`` builds the six kernels from ``src/repro_torch/kernels/csrc``;
2. kernels against their plain PyTorch versions on the card, at the
   shapes the main path gives them, bit-equal (integer work, tolerance
   0), each timed with CUDA events (median of 3 after a warm-up); K1's
   scan and its first cleanup launch (pi after the scan, the whole edge
   list), each also at fuel 1 (the hooks and one sweep), which splits
   its time into hook and sweeps; K2 on segment 0 of each graph: the
   snapshot body (``solve_pallas``'s hook) against ``hook_edges``,
   beside the one-block tiled body; K3 on the main path's compress input
   of each graph (pi after segment 0's hook): ``full_compress``'s
   fixpoint body beside the sequential fixpoint body, both equal to
   ``ref_full_compress``, and the one-sweep ``multi_jump``;
3. the main path at full scale: ``solve_static(method="pallas_fused")``
   and ``solve_pallas`` on the Table I stand-ins usa-osm and kron-logn21
   at scale 1.0 (seed 1), with the launch counts of every kernel set to
   0 just before and read just after; labels equal the scipy oracle,
   ``pallas_fused`` WorkCounters equal the torch-ops ``adaptive`` solve,
   the fused kernel launches once per scan plus once per cleanup round,
   ``solve_pallas`` launches K2's snapshot body once per ``adaptive``
   hook round, and every K3 launch is on the fixpoint body; then each
   solve once under ``torch.profiler``: every kernel's summed device
   time and launches, and K1's and K2's device time launch by launch
   (the scan or each segment, then each cleanup round);
4. parity constants: the four stand-ins at scale 0.002 reproduce the
   reference's WorkCounters and summed scan sweeps on the card;
5. end-to-end solve times (median of 3 after a warm-up);

then the recsys serving slice, DCN-v2 at full width (26 Criteo tables,
19,297,856 x 16 bf16 rows, random weights from a seeded generator):

6. ``embedding_bag`` against its plain version on the full table at the
   path's shapes (serve_p99 13,312 bags of 1, serve_bulk 6,815,744,
   retrieval_cand 1,000,000, and a multi-hot B=512 x 26 x H=4, sum and
   mean): bags of 1 bit-equal, larger bags within one bfloat16 ulp;
   timed by CUDA events (the wrapper included) and by device time
   (``torch.profiler``, 5 calls) beside its plain version and, at bags
   of 1, ``F.embedding`` (an index_select: the same function, checked
   bit-equal) and ``F.embedding_bag``, at larger bags
   ``F.embedding_bag``;
7. the ragged EmbeddingBag path (``recsys.embedding_bag``, bags of 1-8
   rows, ascending ids passed with ``indices_are_sorted=True``, launches
   counted, all on ``segment_reduce``'s sorted body; the same bags with
   their rows shuffled through the default call, on the atomic body) and
   both bodies of ``segment_reduce`` against its plain version on the
   gathered rows: sum within 1e-5 (1 + |ref|) in fp32 and one bfloat16
   ulp after the cast, min / max bit-equal, the sorted body's sum equal
   across two calls; timed per call over 20 back-to-back calls (a call
   this small costs its host work), beside ``index_add_`` (bf16, and
   fp32 then the cast: the same function) / ``scatter_reduce``, with
   each call's CUDA kernels and device time from ``torch.profiler`` (the
   sorted body: exactly one kernel);
8. the serving path through ``build_cell``: 8 ``serve_p99`` requests
   from a prefetched stream, one ``serve_bulk`` batch and one
   ``retrieval_cand`` query against 1,000,000 candidates, launch counts
   set to 0 just before and read just after; logits and scores finite
   and bit-equal to the same tower fed the plain lookup, the
   embedding-bag kernel launched once per request and twice per query;
9. serving times (CUDA events, median after a warm-up, host batch to
   logits);
10. where each serving cell's time goes: the host-to-device copy, the
    lookup (``interact``) and the tower timed apart, and the device's
    idle share of a step from ``torch.profiler``: one minus the device
    time of its kernels and copies (and of its kernels alone) over the
    step time of phase 9;

then the LM serving slice, gemma2-2b at full width (26 layers, d_model
2304, 8 query / 4 kv heads of dim 256, vocab 256,000, bf16, random
weights from a seeded generator):

11. ``flash_attention`` against its plain version on the card. First
    the Hopper body as built: each instantiation's ptxas line
    (registers, spills: none allowed) and the HGMMA instructions in the
    library's SASS (``cuobjdump -sass``: at least one). Then, on the
    Hopper body (bfloat16, d = 64, 128, 256), within
    ``ref.p_rounding_bound`` of the fp32 plain output at every element
    (one ulp + 2^-8 (P @ |V|) + 1e-5: that body rounds P to bfloat16 for
    the PV product, as the reference model does) and within
    ``ref.p_rounding_norm_bound`` as a whole (that worst case grows with
    the row's length, the normwise bound does not): the actual layer-0
    (local, window 4096) and layer-1 (global) q, k, v of an 8192-token
    prefill;
    qwen2.5-32b's grouping at d = 128 (random [1, 8192, 40/8, 128],
    global, softcap 0); at the per-layer ``prefill_32k`` shape (B = 1,
    S = 32768) the last 256 query rows against the plain attention of
    those rows. On the FMA body: float32 at a small GQA shape within
    1e-5, bfloat16 at d = 32 within one bfloat16 ulp + 1e-5. Each row
    timed (CUDA events, median of 3 after a warm-up) with its achieved
    TFLOP/s, its share of the bound and the body that ran; at softcap 0
    and window 0 beside ``F.scaled_dot_product_attention``, at softcap
    50 beside ``flex_attention`` (compiled, a tanh softcap ``score_mod``
    and a causal / window block mask: the same function);
12. the serving path: ``Engine(slots=4, prompt_buf=8192,
    cache_buf=8256)`` serves six requests (prompts of 17 to 8192 tokens,
    two admitted mid-flight), the kernel's launch counts set to 0 just
    before and read just after (26 per prefill, all on the Hopper
    body); every emitted token within epsilon (8 bfloat16 ulps of the
    row's largest |logit|) of the argmax of the teacher-forced
    ``forward`` over prompt + emitted tokens; agreement with
    ``generate`` printed, not gated;
13. serving times: time to first token per prompt length (prefill plus
    splice), decode ms per step with 4 slots active, tokens/s over the
    run, the kernel's share of the prefill's device time and the decode
    step's device time and idle share from ``torch.profiler``, peak
    device memory.

then the front door of the CC system (``repro_torch.api``), on phase
3's graphs and oracle labels:

14. on usa-osm and kron-logn21 at scale 1.0: ``solve_forest(method=
    "adaptive")`` (labels equal the oracle; labels and WorkCounters
    equal ``solve_static(method="adaptive")``; ``spanning_forest_stats``
    consistent; host-side, scipy over the recorded rows finds C
    components in |V| - C rows, so the forest is acyclic, and its
    partition equals the labels); ``sampled`` and ``sampled_fused``
    (labels equal the oracle, equal counters, the fused kernel's
    launches counted from 0 over the ``sampled_fused`` solve and at
    least 1); ``Solver.open(g, policy_cache=AutotuneCache(None))``: the
    cold plan (``explain()`` printed; the heuristic's backend and
    reason: ``adaptive`` on usa, ``sampled`` on kron), its labels, the
    ``pallas`` backend through the session (K2's snapshot body launched
    once per hook round); then ``cache.measure`` over adaptive,
    atomic_hook, pallas_fused and sampled (``labelprop`` is left out at
    this scale: on the road graph it runs towards its 4096-round cap),
    after which the plan reports ``autotune`` and its labels equal the
    oracle; the queries against numpy over the oracle labels
    (``same_component`` on 1,000,000 seeded pairs, ``component_size``,
    ``count_components``, ``component_histogram``); then times (CUDA
    events, median of 3 after a warm-up) of the forest, sampled,
    sampled_fused and warm-cache ``solve()`` solves and of each query,
    and each solve's device time by kernel and op from
    ``torch.profiler``;
15. parity constants: the four stand-ins at scale 0.002 give the
    reference's ``sampled`` / ``sampled_fused`` hook_ops, n_residue and
    giant_size on the card;

then the dynamic engine (``Solver.insert`` / ``delete`` over
``DynamicCC``), on phase 3's graphs:

16. the reference benchmark's dynamic stream at delete:insert 0.05 on
    usa-osm and kron-logn21 at scale 1.0: the edges permuted by
    default_rng(0) in 6 insert rounds, after each k = max(1, round(0.05
    |chunk|)) kills drawn by default_rng(1) from the live set (the
    numpy ``DynamicConnectivityOracle``), one delete batch a round on
    usa, micro-batches of max(64, ceil(k / 8)) on kron (the policy's
    tree-edge ratio routes kron to the forest, not usa). Replayed
    through ``Solver.open(num_nodes=n, delete_route=r)`` for
    ``tombstone-delete`` and ``tombstone-delete-fused`` on both graphs
    and ``tombstone-delete-forest`` on kron. Gates: every route's final
    labels equal scipy over the survivors; after every tick, labels and
    version equal the first route's, and the fused route's
    WorkCounters equal the torch-op route's; the fused kernel's
    launches over the fused stream (counts set to 0 just before) are at
    least the ticks that retired an edge; on kron one all-non-tree
    batch of 16 alive edges bills 0 hook_ops. Printed: ms per insert
    and delete tick (CUDA events), then one more insert and delete tick
    of the last batch's size: the host syncs of each
    (``torch.cuda.set_sync_debug_mode("warn")``) and a delete tick's
    device time by op (``torch.profiler``); the tombstone step's byte
    bound; peak device memory; then K1 against its plain version on
    each fused stream's last scoped scan (pi and sweeps equal), timed;
17. parity constants: the same schedule at scale 0.002 on the four
    stand-ins gives, on every route, the reference's end hook_ops,
    delete-side hook_ops, num_edges_deleted, version and
    ``delete_route_counts`` (computed with ``repro.api.Solver``), and
    labels equal to scipy over the survivors;

then the batched engine and the connectivity service:

18. ``Solver.solve_batch`` on the reference benchmark's fleets
    (``benchmarks/run.py``, ``batched``: molecules-64, mixed-48,
    medium-16): labels equal scipy and the per-graph ``solve(method=
    "adaptive")``, per-graph WorkCounters equal ``BATCHED_PARITY``
    (computed with ``repro.api.Solver.solve_batch``), and the batched
    scan launches once per bucket scan plus once per cleanup round, all
    on the block body (``cc_fused_scan_batched_block``), counts set to 0
    just before. Then 2,048 graphs ``rmat(8 + i % 5, 8, seed=i)``
    (256-4,096 vertices, 3.2M vertices and 26M edges in all, five
    buckets): labels equal scipy on every graph, launches counted the
    same way, by body; the largest bucket's scan on both bodies (the
    grid body forced) bit-equal to ``ref_segment_scan_batched`` (pi and
    sweeps), timed beside it against its byte bound (each true edge read
    once, each graph's pi read and written once); a synthetic bucket
    above the block body's limit (V_pad 32,768) on the grid body,
    bit-equal; every batched launch of one ``solve_batch`` by device
    time (``torch.profiler``) against its byte bound, on the block body
    and with the grid body forced, the old per-sweep byte count
    (``sweep_bytes_ms``: pi read and written once per sweep a hooked
    graph needed) beside it, and the device ops whose launches differ
    between the two runs; ``solve_batch`` ms on the host fleet and on
    the same graphs as ``DeviceGraph``s (CUDA events, median of 3 after
    a warm-up), split into stacking, bucket solves and results; graphs/s;
    host syncs a call; ms per graph of a per-graph ``pallas_fused`` loop
    over the first 256 graphs;
19. the reference benchmark's ``service`` table at scale 1.0: tenants
    social ``rmat(22, 7, a=0.45, b=0.22, c=0.22, seed=1)`` and road
    ``grid_road(4898, extra_prob=0.02, seed=1)``; each tenant's bucket
    measured once on a fresh ``AutotuneCache(None)`` over the phase-14
    candidates (the warm start); ``ConnectivityService(slots=32)`` with
    tracing on; 6 rounds, each tenant 1 insert of a sixth of its edges
    (permuted by default_rng(0)), 4 ``same_component`` requests of 64
    pairs and 1 ``count_components``, then one round that deletes 5% of
    each tenant's edges (default_rng(1)) with the same queries. Gates:
    one tick a round; every ``same_component`` answer equals numpy over
    the labels the registry held after its tick, every count the roots
    of those labels; the final labels equal scipy over the survivors;
    the service's hook_ops stay below a per-query recompute's. Printed:
    ms and host syncs of each tick, queries/s, p50/p99 query latency
    per tenant and global from the service's ``SLORecorder``, the
    routes, K1-K3 launches;

then the multi-shard engine and the fleet (``repro_torch.core.
distributed``, ``launch.mesh``, ``repro_torch.fleet``):

20. ``Solver.open(g, mesh=make_mesh(k)).solve()`` on phase 3's graphs
    for k = 1, 2 and 4 slots on the card. Gates: every slot on the card;
    the plan is ``distributed`` (``sharded``); labels equal the scipy
    oracle and ``pallas_fused``'s; at most 8 rounds; with the counts set
    to 0 just before, K1 launched k x rounds and K3 rounds times, all
    on its fixpoint body; slot 0's K1 scan equal to its plain version
    at that slot's shapes (pi and sweeps). Printed: solve ms (CUDA
    events, median of 3 after a warm-up), device ms by kernel
    (``torch.profiler``), read backs a solve (sync debugging); at k = 4
    slot 0's scan timed beside its plain version against its byte
    bound. Then the ``cc-adaptive`` cell over 4 slots: its spec on the
    four Table I shapes, and the usa-osm cell's step on the usa
    stand-in's edges padded with (0, 0) rows to the spec's 58,000,000
    rows at |V| 24,000,000: labels equal scipy's, K1 4 x rounds;
21. the reference benchmark's ``fleet`` table at scale 1.0
    (``benchmarks/run.py``): 512 tenants of 200,000 vertices with
    100,000 base edges each, and the chain whale, on
    ``FleetService(devices=[cuda:0] * 4)``; 6 ticks of 128 pairs a
    ``same_component`` and 128 vertices a ``component_size`` request
    per tenant, round-robin inserts of 24 edges, 128 whale pairs a tick.
    One cut: the table's chain reaches vertex 4n = 800,000, one past its
    ``whale_nodes``, so the whale is admitted with 800,001 vertices (the
    shard threshold stays 800,000, so the tenants stay packed). Gates:
    every slot owns 128 tenants; the whale is placed on the mesh; every
    answer equals the single-device ``ConnectivityService`` baseline's
    (holding every tenant) request by request; every tenant's and the
    whale's final labels equal scipy's; K1 and K3 launched on the
    fleet's main path (admission, preload, stream; counts set to 0 just
    before). Printed: both paths' requests/s (tracing on for both),
    query p50 / p99 from the merged SLO, syncs and event waits per tick
    from a replay on a fresh fleet under sync debugging, K1 and K3
    launches;

then the MLA and MoE LMs at full width (random weights from seed 0, the
norm weights N(1, 0.1²) from seed 1), one model on the card at a time:

22. minicpm3-4b at full depth (62 layers, d_model 2560, 40 heads, MLA:
    q / k head dim 96, v 64; 4,262,025,728 parameters, 8.52 GB bf16).
    First K6 on the real layer-0 q, k, v of an 8192-token prefill as the
    model hands them over, zero-padded to d = 128 (the Hopper body):
    within ``ref.p_rounding_bound`` / ``p_rounding_norm_bound`` of its
    plain version (by groups of kv heads), the padded columns 0, the
    plain version of the unpadded tensors equal to the padded one's
    first 64 columns within f32 1e-5; timed beside the plain version,
    the route (pads, kernel, slice) and
    ``F.scaled_dot_product_attention`` on the unpadded shapes, its bound
    given for the padded and for the true work. Then phase 12's six
    requests through ``Engine(slots=4, prompt_buf=8192,
    cache_buf=8256)``, K6's launches counted (62 per prefill, all on the
    Hopper body), every token within 8 bf16 ulps of the teacher-forced
    ``forward`` argmax; TTFT, decode ms/step, tokens/s, peak memory and
    the 8192-token prefill's device ms by op (``torch.profiler``);
23. phi3.5-moe (24 of 32 layers, 31,471,636,480 parameters, 62.9 GB)
    and grok-1 (6 of 64 layers, 31,130,499,072 parameters, 62.3 GB):
    the same K6 check at their grouping (32 / 8 and 48 / 8 heads of 128)
    beside SDPA, then 4 requests (prompts 17, 1000, 4097, 8192) through
    the same engine with the same gates (K6 launches = layers x
    prefills). The engine's routing (experts and keep mask of every
    token) is recorded on the device during the run, and the
    teacher-forced ``forward`` takes it: capacity depends on the batch a
    token was routed in (cap = 1 at a 4-slot decode step, padding rows
    of a prefill take capacity), which a single forward of the request
    does not reproduce. The capacity drops of one prefill (the 17-token
    prompt, padded to 8192) equal a numpy recount from the same router
    probabilities, layer by layer, and the experts equal numpy's stable
    top-2. The prefill's device ms by op: the expert ``bmm``s, the
    dispatch / combine index ops, K6.

then DCN-v2 training at full width (the ``train_batch`` cell: B =
65,536, 311,334,793 bf16 parameters, AdamW lr 1e-3; ``recsys.init``
seed 0, ``recsys_batch(1, i, ...)``):

24. one K5-forward / K4-backward pass against the plain route (the
    plain lookup, the same tower, the table's gradient as a
    deterministic ``index_add_`` into fp32, then the cast): the loss and
    the tower's gradients equal, the table gradient on K4's sorted body
    bit-equal and equal call to call, K4's atomic body on the same rows
    within one bf16 ulp; K5 (the forward lookup, and the backward's
    gather of the gradient rows with its own bound) timed as in phase 6,
    both K4 bodies beside their plain versions and ``index_add_``
    (default and deterministic). Then six train steps, launch counts
    set to 0 just before and read just after (K5 twice a step, K4's
    sorted body once, its atomic body never), every loss and grad norm
    printed, finite, the last loss below the first; ``run_with_restarts``
    with a ``SimulatedFailure`` at step 4 and checkpoints every 3 (keep
    1): one restart, params, m, v and step bit-equal to the
    uninterrupted run; one full-width save and restore timed and
    compared; the step timed (CUDA events, median of 3 after a warm-up,
    host batch in) with samples/s, its device ms by op and idle share
    (``torch.profiler``) and peak memory; last, ``python -m
    repro_torch.launch.train --arch dcn-v2 --steps 30 --fail-at 15``
    in-process on the card returns 0 after one restart;

then gemma2-2b training at full width and depth (the ``train_4k``
cell: 2,614,341,888 bf16 parameters, bf16 moments, AdamW lr 3e-4, 4
microbatches, remat on; ``transformer.init`` seed 0, ``lm_batch(0, i,
8, 4096, ...)``: the global batch cut from 256 sequences to 8):

25. the flash kernel's autograd wrapper on the first two layers' q, k,
    v of a microbatch (local, window 4096, and global; softcap 50): one
    Hopper-body launch, the forward within the p-rounding gates of the
    plain version, dq, dk, dv bit-equal to ``torch.autograd.grad`` of
    ``attention_blocked``; forward and forward + backward timed beside
    the plain version, the all-plain blocked pair and compiled
    ``flex_attention`` (forward, and forward + backward). Then one
    microbatch's loss, grad norm, whole gradient and worst leaf through
    the kernel route against the all-plain route (every attention
    ``attention_blocked``), within ``LM_TRAIN_GATE_FACTOR`` times what
    three rounding controls show (the all-plain route with 256- or
    1024-key blocks, or P kept in fp32): the whole gradient and the
    worst leaf their widest gap, the loss their spread, the grad norm
    what the whole gradient's gate implies. The kernel route with a
    1024-key window on every layer must break that gate; one without its
    softcap is read beside it. Then four train steps on
    one repeated batch, launch counts set to 0 just before and read just
    after (the Hopper body 2 x 26 x 4 = 208 times a step: the forward
    and the checkpoint's recompute of each layer in each microbatch),
    every loss and grad norm finite, the last loss below the first; the
    step's ms, tokens/s, model TFLOP/s and share of the bf16 peak from
    ``model_flops_per_token``, device ms by op (K6, the backward's
    blocked recompute, GEMMs, the optimizer), idle share and peak
    memory; last, ``python -m repro_torch.launch.train --arch gemma2-2b
    --steps 30 --fail-at 15`` in-process on the card returns 0 after one
    restart;

then the GNN family's training at full width (AdamW lr 1e-3, each
model's ``init`` seed 0, batches from seed 26):

26. a synthetic Reddit at its published size (232,965 nodes, 114,615,892
    undirected edges: a power-law CSR of 229,231,784 entries built with
    no sort), the ported sampler's layered minibatch over it (1,024 seeds
    from the train split's ids, fanouts 15 / 10), mapped to local rows
    (seeds first) and padded to ``minibatch_lg``'s static shapes (self
    edges spread over the masked padding rows). Five cells: graphsage-
    reddit ``minibatch_lg`` (the layered blocks), gin-tu ``molecule``,
    gatedgcn ``full_graph_sm`` and ``minibatch_lg`` (the blocks' edge
    union), nequip ``molecule`` (batches from ``data.pipeline``'s
    generators at the specs' shapes). For each: loss-and-gradient
    passes through the kernels (K4's atomic body for every message sum,
    K5 for each of their gradients, counted and held to the count
    reckoned from the model, ``gnn_launches``) and through the all-plain
    route on the card, each on the batch and on ``GNN_CLOUD`` - 1 edge
    permutations of it (the same sums in other fp32 orders); the kernel
    runs' nearest gap to a plain run within ``GNN_GATE_FACTOR`` times
    the widest gap between two plain runs, on the loss, the whole
    gradient and the worst leaf (a ReLU input within rounding of 0 flips
    a gradient term on some runs only); the kernel route without one
    node's in-edges must break that gate. NequIP: forces finite, the energies under a random
    rotation within the factor times what two rounding controls move
    (positions one ulp off, edges permuted), self-loop edges masked
    (the unmasked gap printed beside it). Then ``GNN_STEPS`` AdamW steps
    on one repeated batch, launch counts set to 0 just before and read
    just after, every loss finite, the last below the first; the step
    timed (CUDA events, median of 3 after a warm-up, the batch on the
    card; its host copy apart), device ms by op (K4, K5, GEMMs, the
    optimizer, the rest), idle share and peak memory. At GraphSAGE's
    layer 0, K4 on [168,960, 602] f32 rows into 180,224 (the largest
    call) beside its plain version and ``index_add_``, and K5's
    ``gather_rows`` at that shape beside ``index_select``. Last, ``python
    -m repro_torch.launch.train --arch gin-tu --steps 30 --fail-at 15``
    in-process on the card returns 0 after one restart.

``--only GROUP[,GROUP...]`` runs some phase groups (``GROUPS``; the
CC phases 2-5 come with the groups that reuse their graphs). It prints
informative lines, then one JSON line of per-kernel numbers, then, as
its last line, ``{"ok": true, "device": {...}}``. Without a
CUDA device, or away from the repository, it exits non-zero and prints
no result.
"""
from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
sys.path.insert(0, str(SRC))
# the H100 bound model of PERF.md §3, the port's roofline module's
from repro_torch.roofline.analysis import (  # noqa: E402
    BF16_OPS_PER_S, FP32_OPS_PER_S, HBM_BYTES_PER_S, SECTOR, bound,
    bound_ms)
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    causal_pairs)

DEVICE = "cuda"
SCALE = 1.0                        # of the full-scale stand-ins
K4_BATCH = 20                      # back-to-back calls per timing of K4
FULL_SCALE = ("usa-osm", "kron-logn21")
# table1_scaled(name, scale=0.002, seed=1): (|V|, |E|, s), the reference's
# adaptive WorkCounters, and the summed per-segment sweeps of its scan
PARITY = {
    "usa-osm": ((47961, 62909, 3), (566181, 1390869, 29, 5, 1), 20),
    "euro-osm-karls": ((346921, 456990, 3),
                       (4112910, 11448393, 33, 5, 1), 22),
    "soc-live-journal": ((8192, 57344, 14), (344064, 270336, 33, 15, 1), 32),
    "kron-logn21": ((2048, 88064, 86), (528384, 204800, 100, 87, 1), 99),
}
COUNTERS = ("hook_ops", "jump_ops", "jump_sweeps", "hook_rounds",
            "sync_rounds")
# table1_scaled(name, scale=0.002, seed=1), the sampled engines:
# (hook_ops, n_residue, giant_size), the reference's
SAMPLED_PARITY = {
    "usa-osm": (547122, 2069, 6917),
    "euro-osm-karls": (3969060, 15445, 25936),
    "soc-live-journal": (85488, 0, 7514),
    "kron-logn21": (22092, 0, 1911),
}
# the autotune candidates timed at full scale: AUTOTUNE_METHODS without
# labelprop, which on the road graph runs towards its 4096-round cap
MEASURED = ("adaptive", "atomic_hook", "pallas_fused", "sampled")
QUERY_PAIRS = 1_000_000


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {msg}")


def time_ms(torch, fn, reps: int = 3, batch: int = 1) -> float:
    """Median of ``reps`` CUDA-event timings after one warm-up call, each
    over ``batch`` back-to-back calls and given per call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def max_abs_err(got, want) -> int:
    return int((got.long() - want.long()).abs().max()) if got.numel() else 0


def float_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()) \
        if got.numel() else 0.0


def top_device_ops(events, reps: int, n: int = 6) -> dict:
    """The ``n`` largest device ops, ms per repetition, by name cut to 60
    characters; ops whose cut names meet are summed, not overwritten."""
    ms = {}
    for e in events:
        ms[e.key[:60]] = ms.get(e.key[:60], 0.0) + \
            e.self_device_time_total / (1e3 * reps)
    return dict(sorted(ms.items(), key=lambda kv: -kv[1])[:n])


def profiled(torch, fn, reps: int = 1):
    """Runs ``fn`` ``reps`` times under ``torch.profiler`` and returns
    the profile. A profile that holds no device event at all (the device
    trace of a session can come back empty) is taken again, up to three
    times; the launch checks stay with the callers."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        if any(e.device_type != DeviceType.CPU for e in prof.events()):
            break
    return prof


def device_kernels(torch, fn, reps: int = 1) -> tuple[dict, float]:
    """Runs ``fn`` ``reps`` times under ``torch.profiler``. Returns
    ({kernel name cut to 60 characters: {"ms": summed device ms,
    "launches": count}} per repetition, the device time of all kernels
    and copies per repetition)."""
    from torch.autograd import DeviceType
    prof = profiled(torch, fn, reps)
    ev = [e for e in prof.key_averages()
          if e.device_type != DeviceType.CPU and e.self_device_time_total > 0]
    out = {}
    for e in ev:
        k = out.setdefault(e.key[:60], {"ms": 0.0, "launches": 0})
        k["ms"] += e.self_device_time_total / (1e3 * reps)
        k["launches"] += e.count // reps
    total = sum(e.self_device_time_total for e in ev) / (1e3 * reps)
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["ms"])), total


def launch_ms(torch, fn, symbol: str) -> list:
    """The device ms of each launch of the kernels whose name holds
    ``symbol``, in launch order, over one call of ``fn`` under
    ``torch.profiler``."""
    from torch.autograd import DeviceType
    prof = profiled(torch, fn)
    ev = sorted((e for e in prof.events()
                 if e.device_type != DeviceType.CPU and symbol in e.name),
                key=lambda e: e.time_range.start)
    return [e.time_range.elapsed_us() / 1e3 for e in ev]


def kernel_share(per_kernel: dict, symbol: str) -> dict:
    """The summed device ms and launches of the kernels whose name holds
    ``symbol``."""
    hits = [v for k, v in per_kernel.items() if symbol in k]
    return {"ms": sum(v["ms"] for v in hits),
            "launches": sum(v["launches"] for v in hits)}


def device_ms(torch, fn, reps: int = 5):
    """Device ms per call of ``fn``: its kernels and copies summed over
    ``reps`` calls under ``torch.profiler``; None where the profile came
    back without device time (the trace can lose its device events)."""
    return device_kernels(torch, fn, reps)[1] or None


def k5_times(torch, F, eb_ops, eb_ref, table, idx, combine: str) -> dict:
    """K5 at one shape: CUDA-event ms a call (the wrapper included) and
    device ms a call (``torch.profiler``) of the kernel, its plain
    version and the library call. At bag 1 the library call is
    ``F.embedding`` (an index_select: the same function bit for bit,
    checked here), with ``F.embedding_bag`` beside it; at larger bags
    ``F.embedding_bag``."""
    calls = {"": lambda: eb_ops.embedding_bag(table, idx, combine=combine),
             "plain_": lambda: eb_ref.ref_embedding_bag(table, idx,
                                                        combine)}
    idx64 = idx.long()
    bag_call = lambda: F.embedding_bag(idx64, table, mode=combine)
    if idx.shape[1] == 1:
        flat = idx.view(-1)
        calls["library_"] = lambda: F.embedding(flat, table)
        calls["embedding_bag_"] = bag_call
        check(torch.equal(calls["library_"](), calls[""]()),
              "K5 at bag 1 differs from F.embedding")
        out = {"library": "F.embedding"}
    else:
        calls["library_"] = bag_call
        out = {"library": f"F.embedding_bag(mode={combine!r})"}
    for k, fn in calls.items():
        out[f"{k}ms"] = time_ms(torch, fn)
        out[f"{k}device_ms"] = device_ms(torch, fn)
    return out


def recsys_phases(torch, np, dev, rows: dict, card: str) -> dict:
    """Phases 6-10: DCN-v2 at full width. Adds the ``embedding_bag`` and
    ``segment_reduce`` rows to ``rows``; returns the serving times."""
    import torch.nn.functional as F

    from repro_torch.configs import dcn_v2
    from repro_torch.data.pipeline import (make_stream, recsys_batch,
                                           recsys_batches)
    from repro_torch.kernels.embedding_bag import ops as eb_ops, \
        ref as eb_ref
    from repro_torch.kernels.flash_attention.ref import ulp_bf16
    from repro_torch.kernels.segment_reduce import ops as sr_ops, \
        ref as sr_ref
    from repro_torch.launch import steps
    from repro_torch.models import recsys

    t0 = time.perf_counter()
    cfg = dcn_v2.make_config()
    shapes = dcn_v2.SHAPE_DEFS
    model = recsys.init(cfg, generator=torch.Generator(dev).manual_seed(0),
                        device=dev)
    torch.cuda.synchronize()
    table, offsets = model.table, model.row_offsets
    print(f"dcn-v2: {recsys.param_count(cfg)} parameters, table "
          f"{tuple(table.shape)} {table.dtype}, d_interact "
          f"{cfg.d_interact}; init {time.perf_counter() - t0:.1f} s")

    def on_dev(batch):
        return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}

    def flat_idx(batch):
        return (batch["sparse_idx"] + offsets).reshape(
            batch["sparse_idx"].shape[0] * cfg.n_sparse, -1).contiguous()

    host = {s: recsys_batch(1, 0, shapes[s]["batch"], cfg.n_dense,
                            cfg.table_sizes)
            for s in ("serve_p99", "serve_bulk", "retrieval_cand")}
    cand_host = np.random.default_rng(1).integers(
        0, cfg.table_sizes[0], shapes["retrieval_cand"]["candidates"]
    ).astype(np.int32)
    rng = np.random.default_rng(1)
    multi = torch.from_numpy(np.stack(
        [rng.integers(0, s, (512, 4)) for s in cfg.table_sizes],
        1).astype(np.int32)).to(dev)
    multi = (multi + offsets[None, :, None]).reshape(-1, 4).contiguous()

    # -- 6. embedding_bag vs plain on the full table -----------------------
    esize = table.element_size()
    cases = {
        "serve_p99": (flat_idx(on_dev(host["serve_p99"])), "sum"),
        "serve_bulk": (flat_idx(on_dev(host["serve_bulk"])), "sum"),
        "retrieval_cand": (torch.from_numpy(cand_host).to(dev)[:, None]
                           .contiguous(), "sum"),
        "multi_hot_sum": (multi, "sum"),
        "multi_hot_mean": (multi, "mean"),
    }
    eb = {}
    for name, (idx, combine) in cases.items():
        got = eb_ops.embedding_bag(table, idx, combine=combine)
        want = eb_ref.ref_embedding_bag(table, idx, combine)
        torch.cuda.synchronize()
        b, bag = idx.shape
        equal = torch.equal(got, want)
        if bag == 1:
            check(equal, f"embedding_bag {name} differs from the gather")
        ulps = float(((got.float() - want.float()).abs()
                      / ulp_bf16(want)).max())
        check(ulps <= 1.0, f"embedding_bag {name}: {ulps} ulp from plain")
        ms_bound, by = bound(b * bag * (4 + cfg.embed_dim * esize)
                             + b * cfg.embed_dim * esize,
                             b * bag * cfg.embed_dim)
        eb[name] = dict(
            shape=f"{name}: {b} bags x {bag}, table "
                  f"{table.shape[0]}x{table.shape[1]} {combine}",
            equal=equal, max_abs_err=float_err(got, want), max_ulp=ulps,
            **k5_times(torch, F, eb_ops, eb_ref, table, idx, combine),
            bound_ms=ms_bound, bound_by=by)
        print(f"embedding_bag {name} ({card}): {eb[name]}")
        del got, want

    # -- 7. the ragged EmbeddingBag path and segment_reduce ----------------
    rng = np.random.default_rng(1)
    lengths = rng.integers(1, 9, 512 * cfg.n_sparse)
    feat = np.tile(np.arange(cfg.n_sparse), 512)
    sizes = np.asarray(cfg.table_sizes)
    rows_per = [rng.integers(0, sizes[f], n) + cfg.row_offsets[f]
                for f, n in zip(feat, lengths)]
    nnz_idx = torch.from_numpy(np.concatenate(rows_per).astype(
        np.int32)).to(dev)
    bag_ids = torch.from_numpy(np.repeat(
        np.arange(lengths.size), lengths).astype(np.int32)).to(dev)
    num_bags = int(lengths.size)
    sr_ops.KERNEL.launches = 0
    ragged = {c: recsys.embedding_bag(table, nnz_idx, bag_ids, num_bags, c,
                                      indices_are_sorted=True)
              for c in ("sum", "mean")}
    torch.cuda.synchronize()
    sr_launches = sr_ops.KERNEL.launches
    check(sr_launches == 3, f"segment_reduce launched {sr_launches} times "
                            "on the ragged path, expected 1 (sum) + 2 (mean)")
    sr_bodies = {"sorted": sr_ops.SORTED.launches,
                 "atomic": sr_ops.ATOMIC.launches}
    check(sr_bodies["sorted"] == sr_launches,
          f"the ragged path did not take segment_reduce's sorted body: "
          f"{sr_bodies}")
    gathered = table[nnz_idx.long()]
    perm = torch.randperm(nnz_idx.shape[0], device=dev,
                          generator=torch.Generator(dev).manual_seed(2))
    for c, got in ragged.items():
        want = sr_ref.ref_segment_reduce(gathered, bag_ids, num_bags, "sum")
        if c == "mean":
            cnt = torch.from_numpy(lengths).to(dev).to(want.dtype)
            want = want / cnt[:, None]
        ulps = float(((got.float() - want.float()).abs()
                      / ulp_bf16(want)).max())
        # sum: one rounding of two fp32 orders, 1 ulp; mean: that ulp
        # divided by a count that is not a power of two, plus the
        # division's own rounding, 2 ulp
        check(ulps <= (1.0 if c == "sum" else 2.0),
              f"recsys.embedding_bag {c}: {ulps} ulp")
        print(f"ragged embedding_bag {c}: {ulps} ulp from plain")
        # the same bags with their rows shuffled (ids in no order), through
        # the default call: segment_reduce's atomic body, the same bags.
        # mean: one ulp of the sum over the count is under two ulps of the
        # mean, and the division rounds once on each side, 3 ulp
        before = (sr_ops.SORTED.launches, sr_ops.ATOMIC.launches)
        shuffled = recsys.embedding_bag(table, nnz_idx[perm], bag_ids[perm],
                                        num_bags, c)
        torch.cuda.synchronize()
        check((sr_ops.SORTED.launches, sr_ops.ATOMIC.launches)
              == (before[0], before[1] + (1 if c == "sum" else 2)),
              "shuffled bags did not take segment_reduce's atomic body")
        s_ulps = float(((shuffled.float() - want.float()).abs()
                        / ulp_bf16(want)).max())
        check(s_ulps <= (1.0 if c == "sum" else 3.0),
              f"recsys.embedding_bag {c}, shuffled bag ids: {s_ulps} ulp")
        print(f"ragged embedding_bag {c}, shuffled bag ids: {s_ulps} ulp "
              "from plain")
    print(f"ragged embedding_bag: {num_bags} bags, nnz "
          f"{nnz_idx.shape[0]}, lengths 1-8; segment_reduce launches "
          f"{sr_launches}")

    n, d = gathered.shape
    ids64 = bag_ids.long()
    ids2 = ids64[:, None].expand(n, d)

    def per_call(fn) -> dict:
        """Device ops (kernels, and memsets or copies apart) and device
        ms per call of ``fn``, from torch.profiler over 3 calls."""
        per_kernel, total = device_kernels(torch, fn, reps=3)
        mem = sum(v["launches"] for k, v in per_kernel.items()
                  if k.startswith("Mem"))
        return {"cuda_kernels": sum(v["launches"] for v in
                                    per_kernel.values()) - mem,
                "memsets_or_copies": mem, "device_ms": total}

    sr = {}
    for op in ("sum", "min", "max"):
        # the sorted body (the path's), the atomic body, the plain version:
        # fp32 rows give the accumulator's own numbers, bf16 rows the cast
        calls = {
            "sorted": lambda x, op=op: sr_ops.segment_reduce(
                x, bag_ids, num_bags, op=op, indices_are_sorted=True),
            "atomic": lambda x, op=op: sr_ops.segment_reduce(
                x, bag_ids, num_bags, op=op),
            "plain": lambda x, op=op: sr_ref.ref_segment_reduce(
                x, bag_ids, num_bags, op)}
        out = {k: (f(gathered.float()), f(gathered))
               for k, f in calls.items()}
        again = calls["sorted"](gathered)
        torch.cuda.synchronize()
        want32, want = out["plain"]
        for body in ("sorted", "atomic"):
            got32, got = out[body]
            if op == "sum":
                check(bool(((got32 - want32).abs()
                            <= 1e-5 * (1 + want32.abs())).all()),
                      f"segment_reduce sum (fp32, {body}) out of tolerance")
                check(bool(((got.float() - want.float()).abs()
                            <= ulp_bf16(want)).all()),
                      f"segment_reduce sum (bf16, {body}) over 1 ulp")
            else:
                check(torch.equal(got32, want32) and torch.equal(got, want),
                      f"segment_reduce {op} ({body}) not bit-equal to plain")
        check(torch.equal(again, out["sorted"][1]),
              f"segment_reduce {op}: two calls of the sorted body differ")
        if op == "sum":
            library = lambda: torch.zeros(
                (num_bags, d), dtype=gathered.dtype, device=dev).index_add_(
                0, ids64, gathered)
            library32 = lambda: torch.zeros(
                (num_bags, d), dtype=torch.float32, device=dev).index_add_(
                0, ids64, gathered.float()).to(gathered.dtype)
        else:
            library = lambda op=op: torch.full(
                (num_bags, d), sr_ref.reduce_identity(op),
                dtype=gathered.dtype, device=dev).scatter_reduce_(
                0, ids2, gathered, "amin" if op == "min" else "amax")
            library32 = None
        ms_bound, by = bound(n * d * esize + 4 * n + num_bags * d * esize,
                             n * d)
        got32, got = out["sorted"]
        sr[op] = dict(
            op=op,
            shape=f"{op}: N={n} rows x {d} bf16 into S={num_bags} (ragged "
                  "bags of 1-8, sorted ids)",
            equal=torch.equal(got, want), max_abs_err=float_err(got, want),
            max_abs_err_fp32=float_err(got32, want32),
            atomic_max_abs_err=float_err(out["atomic"][1], want),
            deterministic=True,
            ms=time_ms(torch, lambda: calls["sorted"](gathered),
                       batch=K4_BATCH),
            atomic_ms=time_ms(torch, lambda: calls["atomic"](gathered),
                              batch=K4_BATCH),
            plain_ms=time_ms(torch, lambda: calls["plain"](gathered),
                             batch=K4_BATCH),
            library_ms=time_ms(torch, library, batch=K4_BATCH),
            library="index_add_ on a bf16 zeros" if op == "sum" else
                    "scatter_reduce_ on an identity-filled bf16 tensor",
            bound_ms=ms_bound, bound_by=by,
            per_call={"sorted": per_call(lambda: calls["sorted"](gathered)),
                      "atomic": per_call(lambda: calls["atomic"](gathered)),
                      "library": per_call(library)})
        if library32 is not None:
            sr[op].update(
                library_fp32_ms=time_ms(torch, library32, batch=K4_BATCH),
                library_fp32="index_add_ of fp32 rows on fp32 zeros, then "
                             "the cast to bf16 (the same function)")
            sr[op]["per_call"]["library_fp32"] = per_call(library32)
        check(sr[op]["per_call"]["sorted"]["cuda_kernels"] == 1,
              f"segment_reduce {op}: the sorted body ran "
              f"{sr[op]['per_call']['sorted']} per call, not one kernel")
        print(f"segment_reduce {op}: {sr[op]}")
    del gathered, ids2, ragged, out, again

    # -- 8. the serving path at full width, launches counted ---------------
    cells = {s: steps.build_cell("dcn-v2", s, device=dev)
             for s in ("serve_p99", "serve_bulk", "retrieval_cand")}
    stream = make_stream(recsys_batches, 1, shapes["serve_p99"]["batch"],
                         cfg.n_dense, cfg.table_sizes)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eb_ops.KERNEL.launches = 0
    t0 = time.perf_counter()
    served, per_request = [], []
    for _ in range(8):
        batch = next(stream)
        before = eb_ops.KERNEL.launches
        served.append((batch, cells["serve_p99"].step(model, batch)))
        per_request.append(eb_ops.KERNEL.launches - before)
    bulk = cells["serve_bulk"].step(model, host["serve_bulk"])
    before = eb_ops.KERNEL.launches
    scores = cells["retrieval_cand"].step(model, host["retrieval_cand"],
                                          cand_host)
    retrieval_launches = eb_ops.KERNEL.launches - before
    torch.cuda.synchronize()
    eb_launches = eb_ops.KERNEL.launches
    print(f"serving path (8 x serve_p99, serve_bulk, retrieval_cand): "
          f"{time.perf_counter() - t0:.2f} s, embedding_bag launches "
          f"{eb_launches} (per request {per_request}, retrieval "
          f"{retrieval_launches}); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(per_request == [1] * 8, "embedding_bag not launched once per "
                                  "serve_p99 request")
    check(retrieval_launches == 2, "embedding_bag not launched twice for "
                                   "the retrieval query")
    check(eb_launches == 11, f"embedding_bag launches {eb_launches} != 11")

    def plain_x0(batch):
        b = on_dev(batch)
        dense = b["dense"].to(cfg.dtype) * model.dense_norm["w"] \
            + model.dense_norm["b"]
        emb = eb_ref.ref_embedding_bag(table, flat_idx(b))
        return torch.cat([dense, emb.reshape(dense.shape[0], -1)], dim=-1)

    for i, (batch, logits) in enumerate(served):
        check(logits.shape == (512,) and bool(logits.isfinite().all()),
              f"serve_p99 request {i}: logits not finite")
        check(torch.equal(logits, recsys.tower(model, plain_x0(batch))),
              f"serve_p99 request {i}: logits differ from the plain route")
    check(bulk.shape == (shapes["serve_bulk"]["batch"],)
          and bool(bulk.isfinite().all()), "serve_bulk logits not finite")
    check(torch.equal(bulk, recsys.tower(model, plain_x0(host["serve_bulk"]))),
          "serve_bulk logits differ from the plain route")
    cand = torch.from_numpy(cand_host).to(dev)
    want = recsys.project_scores(
        model, recsys.cross_deep(model, plain_x0(host["retrieval_cand"])),
        eb_ref.ref_embedding_bag(table, cand[:, None]))
    check(scores.dtype == torch.float32 and scores.shape == cand.shape
          and bool(scores.isfinite().all()), "retrieval scores malformed")
    check(torch.equal(scores, want), "retrieval scores differ from the "
                                     "plain route")
    print(f"serving outputs: 8 x 512 logits, {bulk.shape[0]} bulk logits "
          f"and {scores.shape[0]} fp32 scores finite and bit-equal to the "
          "plain-lookup route")

    # -- 9. serving times ----------------------------------------------------
    req = host["serve_p99"]
    times = {
        "serve_p99_ms": time_ms(torch, lambda: cells["serve_p99"].step(
            model, req), reps=10),
        "serve_bulk_ms": time_ms(torch, lambda: cells["serve_bulk"].step(
            model, host["serve_bulk"])),
        "retrieval_cand_ms": time_ms(torch, lambda: cells[
            "retrieval_cand"].step(model, host["retrieval_cand"], cand_host),
            reps=5),
    }
    times["serve_bulk_samples_per_s"] = \
        shapes["serve_bulk"]["batch"] / times["serve_bulk_ms"] * 1e3
    print("recsys serving: " + ", ".join(f"{k} {v:.3f}"
                                         for k, v in times.items()))

    # -- 10. where the serving time goes -----------------------------------
    from torch.autograd import DeviceType
    for s in ("serve_p99", "serve_bulk", "retrieval_cand"):
        b = host[s]
        args = (b, cand_host) if s == "retrieval_cand" else (b,)
        bd = on_dev(b)
        x0 = recsys.interact(model, bd)
        parts = {
            "h2d_ms": time_ms(torch, lambda: (on_dev(b), torch.from_numpy(
                cand_host).to(dev) if len(args) == 2 else None)),
            "interact_ms": time_ms(torch, lambda: recsys.interact(model,
                                                                  bd)),
            "tower_ms": time_ms(torch, lambda: recsys.tower(model, x0)
                                if len(args) == 1 else recsys.project_scores(
                model, recsys.cross_deep(model, x0), eb_ops.embedding_bag(
                    table, cand[:, None]))),
        }
        prof = profiled(torch, lambda: cells[s].step(model, *args), 3)
        # device-side events only (kernels, copies): a CPU op's device
        # time repeats the time of the kernels it launched
        ev = [e for e in prof.key_averages()
              if e.device_type != DeviceType.CPU
              and e.self_device_time_total > 0]
        device_ms = sum(e.self_device_time_total for e in ev) / 3e3
        kernel_ms = sum(e.self_device_time_total for e in ev
                        if not e.key.startswith("Mem")) / 3e3
        step_ms = times[f"{s}_ms"]
        parts.update(device_ms_per_step=device_ms,
                     kernel_ms_per_step=kernel_ms,
                     idle_share=1 - device_ms / step_ms if ev else None,
                     kernel_idle_share=1 - kernel_ms / step_ms if ev
                     else None,
                     top_device_ops=top_device_ops(ev, 3))
        times[f"{s}_breakdown"] = parts
        print(f"breakdown {s}: {parts}")

    rows["embedding_bag"] = dict(
        name="embedding_bag", route="cuda",
        source="src/repro_torch/kernels/csrc/embedding_bag.cu",
        replaces="src/repro/kernels/embedding_bag/embedding_bag.py:44",
        **eb["serve_bulk"], launches=eb_launches,
        also=[eb[k] for k in eb if k != "serve_bulk"])
    k4 = dict(route="cuda",
              source="src/repro_torch/kernels/csrc/segment_reduce.cu",
              replaces="src/repro/kernels/segment_reduce/segment_reduce.py:62")
    rows["segment_reduce"] = dict(
        name="segment_reduce", body="segment_reduce_sorted", **k4,
        **sr["sum"], launches=sr_bodies["sorted"],
        also=[sr["min"], sr["max"]])

    def atomic(row: dict) -> dict:
        return {**row, "shape": row["shape"].replace("sorted ids",
                                                     "the atomic body"),
                "body": "segment_reduce", "ms": row["atomic_ms"],
                "max_abs_err": row["atomic_max_abs_err"],
                "deterministic": row["op"] != "sum"}
    rows["segment_reduce_atomic"] = dict(
        name="segment_reduce_atomic", **k4, **atomic(sr["sum"]),
        launches=sr_bodies["atomic"],
        also=[atomic(sr["min"]), atomic(sr["max"])])
    return {"dcn-v2": times}


# LM serving slice (phases 11-13): the requests of phase 12, the buffers
# of its engine, the long prefill shape of phase 11
LM_PROMPTS = (17, 1000, 4095, 4097, 6000, 8192)
LM_MAX_NEW = (8, 32, 16, 32, 24, 32)
LM_PROMPT_BUF, LM_CACHE_BUF = 8192, 8256
LM_LONG = 32768
LM_TAIL = 256                      # rows of the long shape held to plain
LM_EPS_ULPS = 8                    # teacher-forced check, bf16 ulps


def attention_flops(q, window: int) -> int:
    """4 d flops (QK and PV) per unmasked pair and query head."""
    b, s, hq, d = q.shape
    return 4 * d * hq * b * causal_pairs(s, s, window)


def attention_bound(q, k, window: int) -> tuple[float, str]:
    """The least time (ms) of one attention call: q, k, v, o moved once
    over the memory rate, its flops over the bf16 tensor-core peak."""
    nbytes = 2 * q.numel() * q.element_size() + 2 * k.numel() * \
        k.element_size()
    by_bytes = bound_ms(nbytes)
    by_ops = attention_flops(q, window) / BF16_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def wgmma_build_report(torch, kernels) -> dict:
    """The Hopper attention body as built: each instantiation's ptxas
    lines (registers, spills) and the HGMMA instructions in the
    library's SASS. Fails on a spill or on SASS without HGMMA."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    lines = kernels.ptxas_report("flash_attention").splitlines()
    report = {}
    for i, line in enumerate(lines):
        if "Function properties for" in line and "flash_wgmma_kernel" in line:
            name = line.split("flash_wgmma_kernelILi")[1].split("E")[0]
            spill, regs = lines[i + 1].strip(), lines[i + 2].strip()
            regs = regs.removeprefix("ptxas info    : ")
            print(f"  ptxas flash_wgmma_kernel<{name}>: {spill}; {regs}")
            report[f"d{name}"] = f"{spill}; {regs}"
            check(" 0 bytes spill stores, 0 bytes spill loads" in spill,
                  f"flash_wgmma_kernel<{name}> spills: {spill}")
    check(sorted(report) == sorted(f"d{d}" for d in fa_ops.WGMMA_HEAD_DIMS),
          f"ptxas report lacks a Hopper body: {sorted(report)}")
    for line in lines:
        if "Performance Loss" in line and "flash_wgmma" in line:
            print(f"  ptxas: {line.strip()}")
    cuobjdump = Path(kernels._nvcc()).parent / "cuobjdump"
    lib = kernels.build_dir() / "libflash_attention.so"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    hgmma = [ln.split()[1] for ln in sass.splitlines() if "HGMMA." in ln]
    kinds = sorted(set(hgmma))
    print(f"  SASS of libflash_attention.so: {len(hgmma)} HGMMA "
          f"instructions ({', '.join(kinds)})")
    check(len(hgmma) > 0, "no HGMMA instruction in the attention library")
    report["hgmma"] = len(hgmma)
    return report


def attention_check(fa_ref, got, want, what: str, bound=None,
                    norm_bound=None) -> dict:
    """Within ``bound`` at every element and within ``norm_bound`` in
    the 2-norm (the Hopper body's ``p_rounding_bound`` and
    ``p_rounding_norm_bound``) or, where none is given, within one bf16
    ulp of plain plus the fp32 order term 1e-5 (the FMA body)."""
    err = (got.float() - want.float()).abs()
    u = err / fa_ref.ulp_bf16(want)
    gate = fa_ref.ulp_bf16(want) + 1e-5 if bound is None else bound
    res = dict(max_abs_err=float(err.max()), max_ulp=float(u.max()),
               n_over_1_ulp=int((u > 1).sum()),
               gate="1 bf16 ulp + 1e-5" if bound is None else
               "p_rounding_bound and p_rounding_norm_bound",
               max_err_over_gate=float((err / gate).max()),
               finite=bool(got.isfinite().all()))
    ok = bool((err <= gate).all()) and res["finite"]
    if norm_bound is not None:
        res["norm_err_over_gate"] = float(err.norm()) / norm_bound
        ok = ok and res["norm_err_over_gate"] <= 1.0
    check(ok, f"flash_attention {what}: {res}")
    return res


def prefill_attention_inputs(torch, np, dev, cfg, params, n_layers: int
                             ) -> list:
    """The (q, k, v, keywords) that the first ``n_layers`` layers of an
    ``LM_PROMPT_BUF``-token prefill (seed 1 tokens) hand the flash
    kernel, as the model hands them over (MLA's already padded)."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    prompt = np.random.default_rng(1).integers(0, cfg.vocab, LM_PROMPT_BUF)
    toks = torch.from_numpy(prompt.astype(np.int32)).to(dev)[None]
    captured = []
    launch = L.flash_attention

    def capture(q, k, v, **kw):
        captured.append((q, k, v, kw))
        return launch(q, k, v, **kw)

    L.flash_attention = capture
    try:
        T.forward_hidden({**params, "layers": params["layers"][:n_layers]},
                         toks, cfg)
    finally:
        L.flash_attention = launch
    check(len(captured) == n_layers, f"{cfg.name}: {n_layers} layers made "
                                     f"{len(captured)} flash calls")
    return captured


def argmax_margin(torch, fa_ref, logits, out):
    """How far below each row's largest logit the emitted token's logit
    lies, in bf16 ulps of the row's largest |logit|."""
    top = logits.max(dim=-1).values
    chosen = logits[torch.arange(len(out), device=logits.device),
                    torch.from_numpy(out).long().to(logits.device)]
    return (top - chosen) / fa_ref.ulp_bf16(logits.abs().max(dim=-1).values)


_FLEX = []                         # compiled flex_attention, made once


def flex_library(torch, q, k, v, scale: float, window: int, softcap: float,
                 cot=None):
    """One call of ``flex_attention`` (compiled, not used by the port)
    for the flash kernel's function: causal, the window as a block mask
    (a window that reaches every key is none), cap * tanh(s / cap) as a
    ``score_mod``, GQA in place, on [B, H, S, d] copies. Returns (the
    call, its output as [B, S, H, d]). Given ``cot``, the output's
    gradient [B, S, H, d], the copies require grad and a third item is
    the forward + backward call, which returns the copies' gradients."""
    from torch.nn.attention.flex_attention import create_block_mask, \
        flex_attention
    if not _FLEX:
        _FLEX.append(torch.compile(flex_attention, dynamic=False))
    flex = _FLEX[0]
    qt, kt, vt = (x.detach().transpose(1, 2).contiguous()
                  .requires_grad_(cot is not None) for x in (q, k, v))
    if window >= q.shape[1]:
        window = 0

    def keep(b, h, qi, ki):
        return (qi >= ki) & (qi - ki < window) if window else qi >= ki

    def cap(score, b, h, qi, ki):
        return softcap * torch.tanh(score / softcap)

    mask = create_block_mask(keep, None, None, q.shape[1], k.shape[1],
                             device=q.device)

    def call():
        return flex(qt, kt, vt, score_mod=cap, block_mask=mask,
                    scale=scale, enable_gqa=True)

    out = call()
    if cot is None:
        return call, out.transpose(1, 2)
    cot_t = cot.transpose(1, 2).contiguous()

    def pair():
        return torch.autograd.grad(call(), (qt, kt, vt), cot_t)

    return call, out.detach().transpose(1, 2), pair


def lm_phases(torch, np, dev, rows: dict, card: str) -> dict:
    """Phases 11-13: gemma2-2b serving at full width. Adds the
    ``flash_attention`` row to ``rows``; returns the serving numbers."""
    import torch.nn.functional as F

    from repro_torch import kernels
    from repro_torch.configs import gemma2_2b
    from repro_torch.kernels.flash_attention import ops as fa_ops, \
        ref as fa_ref
    from repro_torch.models import transformer as T
    from repro_torch.serving import engine as E

    t0 = time.perf_counter()
    cfg = gemma2_2b.make_config()
    params = T.init(cfg, generator=torch.Generator(dev).manual_seed(0),
                    device=dev)
    torch.cuda.synchronize()
    print(f"gemma2-2b: {T.param_count(cfg)} parameters, {cfg.dtype}, "
          f"init {time.perf_counter() - t0:.1f} s")
    cap = cfg.attn_softcap

    def ulps(got, want):
        return (got.float() - want.float()).abs() / fa_ref.ulp_bf16(want)

    def add_flex(row: dict, call, out, want, bound) -> None:
        lib_ms = time_ms(torch, call)
        row.update(library_ms=lib_ms, library_ratio=row["ms"] / lib_ms,
                   library="flex_attention (torch.compile; tanh softcap "
                           "score_mod, causal / window block mask, "
                           "enable_gqa) on [B, H, S, d] copies",
                   library_max_err_over_gate=float(
                       ((out.float() - want.float()).abs() / bound).max()))

    def body(q) -> str:
        return "wgmma" if fa_ops.body_of(q.dtype, q.shape[-1]) is \
            fa_ops.WGMMA else "fma"

    def rates(q, window: int, ms: float, b_ms: float) -> dict:
        return dict(tflops=attention_flops(q, window) / ms / 1e9,
                    share_of_bound=b_ms / ms, body=body(q))

    # -- 11. flash_attention vs plain at the path's shapes -----------------
    wgmma_build = wgmma_build_report(torch, kernels)
    captured = prefill_attention_inputs(torch, np, dev, cfg, params, 2)
    check([c[3]["window"] for c in captured] == [cfg.window, 0],
          "layers 0 and 1 are not the local and global layer")
    fa = {}
    for name, (q, k, v, kw) in zip(("local_8192", "global_8192"), captured):
        got = fa_ops.flash_attention(q, k, v, **kw)
        pkw = dict(sm_scale=kw["sm_scale"], causal=True,
                   window=kw["window"], softcap=kw["softcap"])
        want = fa_ref.ref_flash_attention(q, k, v, **pkw)
        bound = fa_ref.p_rounding_bound(q, k, v, **pkw)
        norm_bound = fa_ref.p_rounding_norm_bound(q, k, v, **pkw)
        torch.cuda.synchronize()
        b_ms, by = attention_bound(q, k, kw["window"])
        ms = time_ms(torch, lambda: fa_ops.flash_attention(q, k, v, **kw))
        fa[name] = dict(
            shape=f"{name}: q {tuple(q.shape)} k {tuple(k.shape)} bf16, "
                  f"window {kw['window']}, softcap {kw['softcap']}, layer "
                  f"{0 if kw['window'] else 1} of a {LM_PROMPT_BUF}-token "
                  "prefill",
            **attention_check(fa_ref, got, want, name, bound, norm_bound),
            ms=ms,
            plain_ms=time_ms(torch, lambda: fa_ref.ref_flash_attention(
                q, k, v, **pkw)),
            bound_ms=b_ms, bound_by=by, **rates(q, kw["window"], ms, b_ms))
        add_flex(fa[name], *flex_library(torch, q, k, v, kw["sm_scale"],
                                         kw["window"], kw["softcap"]),
                 want, bound)
        print(f"flash_attention {name} ({card}): {fa[name]}")
        del got, want, bound

    # softcap 0, window 0: the function scaled_dot_product_attention computes
    q, k, v, _ = captured[1]
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    scale = q.shape[-1] ** -0.5
    got = fa_ops.flash_attention(q, k, v)
    want = fa_ref.ref_flash_attention(q, k, v, sm_scale=scale)
    bound = fa_ref.p_rounding_bound(q, k, v, sm_scale=scale)
    norm_bound = fa_ref.p_rounding_norm_bound(q, k, v, sm_scale=scale)
    lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                         enable_gqa=True).transpose(1, 2)
    torch.cuda.synchronize()
    b_ms, by = attention_bound(q, k, 0)
    ms = time_ms(torch, lambda: fa_ops.flash_attention(q, k, v))
    fa["global_8192_nocap"] = dict(
        shape="global_8192_nocap: layer-1 q, k, v, window 0, softcap 0",
        **attention_check(fa_ref, got, want, "global_8192_nocap", bound,
                          norm_bound),
        library_max_ulp=float(ulps(lib, want).max()),
        library_max_err_over_gate=float(((lib.float() - want.float()).abs()
                                         / bound).max()),
        ms=ms,
        plain_ms=time_ms(torch, lambda: fa_ref.ref_flash_attention(
            q, k, v, sm_scale=scale)),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)),
        library="F.scaled_dot_product_attention(is_causal=True, "
                "enable_gqa=True) on [B, H, S, d] copies",
        bound_ms=b_ms, bound_by=by, **rates(q, 0, ms, b_ms))
    fa["global_8192_nocap"]["library_ratio"] = \
        ms / fa["global_8192_nocap"]["library_ms"]
    print(f"flash_attention global_8192_nocap ({card}): "
          f"{fa['global_8192_nocap']}")
    del captured, got, want, bound, lib, qt, kt, vt

    # qwen2.5-32b's grouping at head dim 128 (40 query / 8 kv heads),
    # random bf16, global, softcap 0, checked one kv head's group at a time
    g = torch.Generator(dev).manual_seed(4)
    qq = torch.randn((1, LM_PROMPT_BUF, 40, 128), generator=g,
                     device=dev).bfloat16()
    kq, vq = (torch.randn((1, LM_PROMPT_BUF, 8, 128), generator=g,
                          device=dev).bfloat16() for _ in range(2))
    got = fa_ops.flash_attention(qq, kq, vq)
    groups = [(qq[:, :, 5 * h:5 * h + 5], kq[:, :, h:h + 1],
               vq[:, :, h:h + 1]) for h in range(8)]

    def by_group(fn):
        return torch.cat([fn(*x, sm_scale=128 ** -0.5) for x in groups],
                         dim=2)

    want = by_group(fa_ref.ref_flash_attention)
    bound = by_group(fa_ref.p_rounding_bound)
    # the groups' errors are disjoint, so their bounds add in squares
    norm_bound = sum(fa_ref.p_rounding_norm_bound(*x, sm_scale=128 ** -0.5)
                     ** 2 for x in groups) ** 0.5
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (qq, kq, vq))
    b_ms, by = attention_bound(qq, kq, 0)
    ms = time_ms(torch, lambda: fa_ops.flash_attention(qq, kq, vq))
    fa["qwen_global_8192"] = dict(
        shape=f"qwen_global_8192: q {tuple(qq.shape)} k {tuple(kq.shape)} "
              "bf16 (random), window 0, softcap 0; the plain version one kv "
              "head's group at a time",
        **attention_check(fa_ref, got, want, "qwen_global_8192", bound,
                          norm_bound),
        ms=ms,
        plain_ms=time_ms(torch, lambda: by_group(
            fa_ref.ref_flash_attention)),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)),
        library="F.scaled_dot_product_attention(is_causal=True, "
                "enable_gqa=True) on [B, H, S, d] copies",
        bound_ms=b_ms, bound_by=by, **rates(qq, 0, ms, b_ms))
    fa["qwen_global_8192"]["library_ratio"] = \
        ms / fa["qwen_global_8192"]["library_ms"]
    print(f"flash_attention qwen_global_8192 ({card}): "
          f"{fa['qwen_global_8192']}")
    del qq, kq, vq, got, want, bound, groups, qt, kt, vt

    # the FMA body: float32 at a small GQA shape with ragged tails within
    # 1e-5, bfloat16 at head dim 32 within one ulp + 1e-5
    g = torch.Generator(dev).manual_seed(2)
    q32, k32, v32 = (torch.randn((2, 300, h, 256), generator=g, device=dev)
                     for h in (8, 4, 4))
    for window in (0, 64):
        got = fa_ops.flash_attention(q32, k32, v32, window=window,
                                     softcap=cap)
        want = fa_ref.ref_flash_attention(q32, k32, v32, sm_scale=1 / 16,
                                          window=window, softcap=cap)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(err <= 1e-5, f"flash_attention f32 window {window}: {err}")
        print(f"flash_attention f32 [2, 300, 8/4, 256] window {window} "
              f"(body {body(q32)}): "
              f"max_abs_err {err}")
    qs, ks, vs = (torch.randn((2, 300, h, 32), generator=g,
                              device=dev).bfloat16() for h in (8, 4, 4))
    for window in (0, 64):
        got = fa_ops.flash_attention(qs, ks, vs, window=window, softcap=cap)
        want = fa_ref.ref_flash_attention(qs, ks, vs, sm_scale=32 ** -0.5,
                                          window=window, softcap=cap)
        torch.cuda.synchronize()
        res = attention_check(fa_ref, got, want, f"bf16 d32 window {window}")
        print(f"flash_attention bf16 [2, 300, 8/4, 32] window {window} "
              f"(body {body(qs)}): {res}")
    del q32, k32, v32, qs, ks, vs

    # the per-layer prefill_32k shape, the tail held to plain
    g = torch.Generator(dev).manual_seed(3)
    ql = torch.randn((1, LM_LONG, 8, 256), generator=g, device=dev).bfloat16()
    kl, vl = (torch.randn((1, LM_LONG, 4, 256), generator=g,
                          device=dev).bfloat16() for _ in range(2))
    for name, window, c in (("local_32768", cfg.window, cap),
                            ("global_32768", 0, cap),
                            ("global_32768_nocap", 0, 0.0)):
        got = fa_ops.flash_attention(ql, kl, vl, window=window, softcap=c)
        tkw = dict(sm_scale=256 ** -0.5, window=window, softcap=c,
                   q_offset=LM_LONG - LM_TAIL)
        want = fa_ref.ref_flash_attention(ql[:, -LM_TAIL:], kl, vl, **tkw)
        bound = fa_ref.p_rounding_bound(ql[:, -LM_TAIL:], kl, vl, **tkw)
        norm_bound = fa_ref.p_rounding_norm_bound(ql[:, -LM_TAIL:], kl, vl,
                                                  **tkw)
        torch.cuda.synchronize()
        b_ms, by = attention_bound(ql, kl, window)
        ms = time_ms(torch, lambda: fa_ops.flash_attention(
            ql, kl, vl, window=window, softcap=c))
        fa[name] = dict(
            shape=f"{name}: q {tuple(ql.shape)} k {tuple(kl.shape)} bf16 "
                  f"(random), window {window}, softcap {c}; last {LM_TAIL} "
                  "rows held to plain",
            **attention_check(fa_ref, got[:, -LM_TAIL:], want, name,
                              bound, norm_bound), ms=ms,
            plain_ms=None, plain="not measured: the plain score matrix "
                                 "would take 34 GB",
            bound_ms=b_ms, bound_by=by, **rates(ql, window, ms, b_ms),
            library_ms=None)
        if c > 0:
            call, out = flex_library(torch, ql, kl, vl, 256 ** -0.5, window,
                                     c)
            add_flex(fa[name], call, out[:, -LM_TAIL:], want, bound)
            del call, out
        elif window == 0:
            qt, kt, vt = (x.transpose(1, 2).contiguous()
                          for x in (ql, kl, vl))
            fa[name]["library_ms"] = time_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True))
            fa[name]["library_ratio"] = ms / fa[name]["library_ms"]
            del qt, kt, vt
        print(f"flash_attention {name} ({card}): {fa[name]}")
        del got, want, bound
    del ql, kl, vl

    # -- 12. the serving path at full width, launches counted --------------
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in LM_PROMPTS]
    eng = E.Engine(params, cfg, slots=4, prompt_buf=LM_PROMPT_BUF,
                   cache_buf=LM_CACHE_BUF)
    for p, n in zip(prompts, LM_MAX_NEW):
        eng.submit(p, max_new=n)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa_ops.KERNEL.launches = 0
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    fa_launches = fa_ops.KERNEL.launches
    fa_bodies = {"wgmma": fa_ops.WGMMA.launches, "fma": fa_ops.FMA.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_tokens = sum(len(r.out_tokens) for r in done)
    print(f"serving run ({card}): {len(done)} requests, {n_tokens} tokens in "
          f"{run_s:.2f} s; flash_attention launches {fa_launches} "
          f"(by body {fa_bodies}); peak "
          f"device memory {peak:.2f} GiB")
    check(len(done) == len(LM_PROMPTS), "not every request finished")
    check(fa_launches == cfg.n_layers * len(LM_PROMPTS),
          f"flash_attention launched {fa_launches} times, expected "
          f"{cfg.n_layers} per prefill")
    check(fa_bodies["wgmma"] == fa_launches,
          f"not every prefill attention took the Hopper body: {fa_bodies}")
    by_uid = sorted(done, key=lambda r: r.uid)
    worst, agree = 0.0, []
    for r in by_uid:
        out = np.asarray(r.out_tokens, np.int32)
        check(len(out) == r.max_new and bool(((out >= 0) & (
            out < cfg.padded_vocab)).all()), f"request {r.uid} tokens")
        seq = np.concatenate([r.prompt, out[:-1]])
        logits = T.forward(params, torch.from_numpy(seq).to(dev)[None],
                           cfg)[0, len(r.prompt) - 1:]
        check(bool(logits.isfinite().all()), f"request {r.uid}: logits "
                                             "not finite")
        margin = argmax_margin(torch, fa_ref, logits, out)
        worst = max(worst, float(margin.max()))
        check(bool((margin <= LM_EPS_ULPS).all()),
              f"request {r.uid}: a token {float(margin.max())} bf16 ulps "
              "below the teacher-forced argmax")
        del logits
        gen = E.generate(params, cfg, r.prompt[None], max_new=len(out))[0]
        agree.append(float((gen == out).mean()))
    print(f"teacher-forced check: every token within {LM_EPS_ULPS} bf16 "
          f"ulps of the argmax; worst margin {worst:.3f} ulps; agreement "
          f"with generate per request {agree}")

    # -- 13. serving times --------------------------------------------------
    from torch.autograd import DeviceType
    ttft = {}
    for p in prompts:
        def first_token(p=p):
            toks = np.zeros((1, LM_PROMPT_BUF), np.int32)
            toks[0, :len(p)] = p
            one = T.init_cache(cfg, 1, LM_CACHE_BUF, device=dev)
            logits, one = E._prefill(
                params, torch.from_numpy(toks).to(dev), one,
                torch.tensor([len(p)], dtype=torch.int32, device=dev), cfg)
            E._void_padding(one, [len(p)])
            E._splice(eng.cache, one, 0)
            return int(E.greedy(logits[:, len(p) - 1])[0])
        ttft[len(p)] = time_ms(torch, first_token)
    lengths = torch.tensor([LM_PROMPTS[i] + LM_MAX_NEW[i] for i in
                            range(4)], dtype=torch.int32, device=dev)
    last = torch.zeros(4, dtype=torch.int32, device=dev)

    def decode_step():
        logits, _ = E._decode(params, last, eng.cache, lengths, cfg)
        return E.greedy(logits).cpu()
    decode_ms = time_ms(torch, decode_step, reps=10)
    toks = np.zeros((1, LM_PROMPT_BUF), np.int32)

    def prefill():
        E._prefill(params, torch.from_numpy(toks).to(dev),
                   T.init_cache(cfg, 1, LM_CACHE_BUF, device=dev),
                   torch.tensor([LM_PROMPT_BUF], dtype=torch.int32,
                                device=dev), cfg)

    def device_profile(fn, reps: int):
        """Device time per call of ``fn`` (kernels and copies, device-side
        events only), that of the flash kernel, and the top ops."""
        prof = profiled(torch, fn, reps)
        ev = [e for e in prof.key_averages()
              if e.device_type != DeviceType.CPU
              and e.self_device_time_total > 0]
        total = sum(e.self_device_time_total for e in ev) / (1e3 * reps)
        flash = sum(e.self_device_time_total for e in ev
                    if "flash_wgmma_kernel" in e.key
                    or "flash_kernel" in e.key) / (1e3 * reps)
        return total, flash, top_device_ops(ev, reps)

    device_ms, flash_ms, top_prefill = device_profile(prefill, 1)
    decode_device_ms, _, top_decode = device_profile(decode_step, 3)
    times = {
        "ttft_ms": ttft, "decode_ms_per_step_4_slots": decode_ms,
        "run_s": run_s, "tokens": n_tokens, "tokens_per_s": n_tokens / run_s,
        "prefill_device_ms": device_ms, "prefill_flash_ms": flash_ms,
        "flash_share_of_prefill": flash_ms / device_ms if device_ms else None,
        "prefill_top_device_ops": top_prefill,
        "decode_device_ms_per_step": decode_device_ms,
        "decode_idle_share": 1 - decode_device_ms / decode_ms,
        "decode_top_device_ops": top_decode,
        "peak_gib": peak, "worst_margin_ulps": worst,
        "generate_agreement": agree, "card": card}
    print(f"lm serving ({card}): {times}")

    rows["flash_attention"] = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:102",
        **fa["global_8192_nocap"], launches=fa_launches,
        launches_by_body=fa_bodies, build=wgmma_build,
        also=[fa[k] for k in fa if k != "global_8192_nocap"])
    return {"gemma2-2b": times}


def numpy_histogram(np, labels):
    """Components per power-of-two size bin, from host labels."""
    census = np.bincount(labels, minlength=labels.shape[0])
    sizes = census[census > 0]
    nbins = max(int(labels.shape[0] - 1).bit_length() + 1, 1)
    bins = np.array([int(x).bit_length() - 1 for x in sizes], np.int64)
    return np.bincount(bins, minlength=nbins).astype(np.int32)


def front_door_phases(torch, np, dev, rows: dict, card: str, graphs: dict,
                      oracles: dict) -> dict:
    """Phases 14-15: the forest, the sampled engines, ``Solver`` with
    its policy and autotune cache, and the queries, on phase 3's graphs
    and oracle labels."""
    from repro_torch.api import Solver
    from repro_torch.connectivity import policy, queries
    from repro_torch.core import cc, sampled
    from repro_torch.core.unionfind import connected_components_scipy
    from repro_torch.graphs.device import DeviceGraph
    from repro_torch.graphs.generators import table1_scaled
    from repro_torch.kernels.cc_fused import ops as cc_ops
    from repro_torch.kernels.hook import ops as hook_ops
    from repro_torch.kernels.multi_jump import ops as mj_ops

    # -- 14. the front door at full scale -------------------------------------
    out = {}
    fused_launches = {}
    t_phase = time.perf_counter()
    for name, g in graphs.items():
        want = oracles[name]
        v = g.num_nodes
        ncomp = len(np.unique(want))
        res = {}
        forest = cc.solve_forest(g, method="adaptive")
        adaptive = cc.solve_static(g, method="adaptive")
        check(np.array_equal(forest.labels.cpu().numpy(), want),
              f"solve_forest labels differ from the oracle on {name}")
        check(torch.equal(forest.labels, adaptive.labels)
              and forest.work.as_ints() == adaptive.work.as_ints(),
              f"solve_forest labels or counters differ from adaptive's "
              f"on {name}")
        fstats = {k: int(x) for k, x in queries.spanning_forest_stats(
            forest.labels, forest.parents).items()}
        check(fstats["count_consistent"] == 1
              and fstats["edges_intra_component"] == 1,
              f"spanning_forest_stats of {name}: {fstats}")
        parents = forest.parents.cpu().numpy()
        recorded = parents[parents[:, 0] >= 0]
        check(recorded.shape[0] == v - ncomp,
              f"the forest of {name} has {recorded.shape[0]} rows, not "
              f"|V| - C = {v - ncomp}")
        check(np.array_equal(connected_components_scipy(recorded, v), want),
              f"the forest's partition differs from the labels on {name}")
        print(f"forest {name}: labels == oracle, == adaptive (counters "
              f"{adaptive.work.as_ints()}); {recorded.shape[0]} rows = "
              f"|V| - C, acyclic, partition == labels; stats {fstats}")

        plain = sampled.solve_sampled(g, fused=False)
        cc_ops.KERNEL.launches = 0
        fused = sampled.solve_sampled(g, fused=True)
        torch.cuda.synchronize()
        fused_launches[name] = cc_ops.KERNEL.launches
        for label, r in (("sampled", plain), ("sampled_fused", fused)):
            check(np.array_equal(r.labels.cpu().numpy(), want),
                  f"{label} labels differ from the oracle on {name}")
        check(plain.work.as_ints() == fused.work.as_ints(),
              f"sampled and sampled_fused counters differ on {name}")
        check(fused_launches[name] >= 1,
              f"sampled_fused did not launch cc_fused on {name}")
        st = {k: int(x) for k, x in fused.stats.items()}
        check(st == {k: int(x) for k, x in plain.stats.items()},
              f"sampled and sampled_fused stats differ on {name}")
        print(f"sampled {name}: labels == oracle (both); counters "
              f"{plain.work.as_ints()}; n_sampled {st['n_sampled']} "
              f"n_residue {st['n_residue']} giant_size {st['giant_size']}; "
              f"cc_fused launches under sampled_fused "
              f"{fused_launches[name]}")
        res["sampled_stats"] = st

        s = Solver.open(g, policy_cache=policy.AutotuneCache(None))
        plan = s.plan()
        print(f"plan {name} (cold cache):\n{plan.explain()}")
        expect = policy.heuristic_method(policy.extract_features(
            v, g.num_edges, degree_skew=g.degree_skew))
        check((plan.backend, plan.reason) == (expect, "heuristic")
              and expect == {"usa-osm": "adaptive",
                             "kron-logn21": "sampled"}[name],
              f"cold plan on {name}: {plan.backend} ({plan.reason}), "
              f"heuristic {expect}")
        check(np.array_equal(s.solve().labels.cpu().numpy(), want),
              f"Solver.solve labels differ from the oracle on {name}")
        hook_ops.KERNEL.launches = 0
        mj_ops.KERNEL.launches = 0
        per_round = s.solve(backend="pallas")
        torch.cuda.synchronize()
        rounds_ = adaptive.work.as_ints()["hook_rounds"]
        check(hook_ops.SNAPSHOT.launches == hook_ops.KERNEL.launches
              == rounds_ and mj_ops.ROOTS.launches == rounds_
              and np.array_equal(per_round.labels.cpu().numpy(), want),
              f"Solver backend pallas on {name}: hook launches "
              f"{hook_ops.SNAPSHOT.launches}/{hook_ops.KERNEL.launches}, "
              f"compress {mj_ops.ROOTS.launches}, hook rounds {rounds_}")

        winner = s.policy_cache.measure(g, methods=MEASURED, reps=2)
        tuned = s.plan()
        check((tuned.backend, tuned.reason) == (winner, "autotune"),
              f"warm plan on {name}: {tuned.backend} ({tuned.reason}), "
              f"measured winner {winner}")
        check(np.array_equal(s.solve().labels.cpu().numpy(), want),
              f"autotuned Solver.solve labels differ on {name}")
        res["autotune_ms"] = dict(s.policy_cache.last_timings)
        res["autotune_winner"] = winner
        print(f"autotune {name} ({card}): {res['autotune_ms']} -> "
              f"{winner}; plan {tuned.backend} ({tuned.reason}); labels "
              f"== oracle")

        labels = s.labels
        rng = np.random.default_rng(7)
        pairs = rng.integers(0, v, (QUERY_PAIRS, 2)).astype(np.int32)
        pairs_d = torch.from_numpy(pairs).to(dev)
        verts_d = pairs_d[:, 0].contiguous()
        census = np.bincount(want, minlength=v)
        got = queries.to_host(queries.same_component(labels, pairs_d))
        check(np.array_equal(got, want[pairs[:, 0]] == want[pairs[:, 1]]),
              f"same_component differs from numpy on {name}")
        got = queries.to_host(queries.component_size(labels, verts_d))
        check(np.array_equal(got, census[want[pairs[:, 0]]]),
              f"component_size differs from numpy on {name}")
        check(int(queries.count_components(labels)) == ncomp,
              f"count_components differs from the oracle on {name}")
        hist = queries.to_host(queries.component_histogram(labels))
        check(np.array_equal(hist, numpy_histogram(np, want)),
              f"component_histogram differs from numpy on {name}")
        print(f"queries {name}: same_component ({QUERY_PAIRS} pairs), "
              f"component_size, count_components ({ncomp}), "
              f"component_histogram == numpy")

        solves = {
            "solve_forest": lambda: cc.solve_forest(g, method="adaptive"),
            "sampled": lambda: sampled.solve_sampled(g, fused=False),
            "sampled_fused": lambda: sampled.solve_sampled(g, fused=True),
            "solve_auto_warm": lambda: s.solve(),
        }
        res["ms"] = {k: time_ms(torch, fn) for k, fn in solves.items()}
        res["query_ms"] = {
            "same_component": time_ms(torch, lambda: queries.same_component(
                labels, pairs_d)),
            "component_size": time_ms(torch, lambda: queries.component_size(
                labels, verts_d)),
            "count_components": time_ms(
                torch, lambda: queries.count_components(labels)),
            "component_histogram": time_ms(
                torch, lambda: queries.component_histogram(labels)),
        }
        print(f"front door {name} ({card}): solves {res['ms']}; queries "
              f"{res['query_ms']}")
        res["device_ms"], res["top_device_ops"] = {}, {}
        for k, fn in solves.items():
            per_kernel, total = device_kernels(torch, fn)
            res["device_ms"][k] = total
            res["top_device_ops"][k] = dict(list(per_kernel.items())[:8])
            print(f"profile {name} {k} ({card}): device {total:.3f} ms; top "
                  f"{res['top_device_ops'][k]}")
            if k == "sampled_fused":
                rows["cc_fused"].setdefault("main_path_device_ms", {})[
                    f"{name} sampled_fused"] = kernel_share(
                        per_kernel, "cc_fused_kernel")
        out[f"front_door {name}"] = res
    rows["cc_fused"]["launches_sampled_fused"] = fused_launches
    print(f"front door: {time.perf_counter() - t_phase:.1f} s")

    # -- 15. parity constants of the sampled engines at scale 0.002 ----------
    for name, (hook_ops_, n_residue, giant) in SAMPLED_PARITY.items():
        g = DeviceGraph.from_host(table1_scaled(name, scale=0.002, seed=1),
                                  device=dev)
        want = connected_components_scipy(g.edges.cpu().numpy(),
                                          g.num_nodes)
        works = []
        for fused in (False, True):
            r = sampled.solve_sampled(g, fused=fused)
            got = (int(r.work.hook_ops), int(r.stats["n_residue"]),
                   int(r.stats["giant_size"]))
            check(got == (hook_ops_, n_residue, giant),
                  f"{name} sampled (fused={fused}) constants {got}")
            check(np.array_equal(r.labels.cpu().numpy(), want),
                  f"{name} sampled (fused={fused}) labels")
            works.append(r.work.as_ints())
        check(works[0] == works[1], f"{name} sampled counters differ")
        print(f"parity {name} @0.002: sampled / sampled_fused hook_ops "
              f"{hook_ops_}, n_residue {n_residue}, giant_size {giant} "
              "reproduced")
    return out


# the dynamic stream (phases 16-17): the reference benchmark's schedule
# (benchmarks/run.py, ``dynamic``) at delete:insert 0.05
DYN_RATIO = 0.05
DYN_ROUNDS = 6
DYN_MICRO = 64
# table1_scaled(name, scale=0.002, seed=1) through repro.api.Solver on
# that schedule, each route on a fresh in-memory autotune cache: (end
# hook_ops, delete-side hook_ops, num_edges_deleted, version,
# (nontree_shortcircuit, tree_scoped, rebuild)), the reference's
DYNAMIC_PARITY = {
    "usa-osm": {
        "tombstone-delete": (2092149, 1525965, 3109, 12, (0, 0, 0)),
        "tombstone-delete-fused": (2092149, 1525965, 3109, 12, (0, 0, 0)),
    },
    "euro-osm-karls": {
        "tombstone-delete": (17093340, 12523440, 22613, 12, (0, 0, 0)),
        "tombstone-delete-fused": (17093340, 12523440, 22613, 12, (0, 0, 0)),
    },
    "soc-live-journal": {
        "tombstone-delete": (9733719, 9418323, 2885, 46, (0, 0, 0)),
        "tombstone-delete-fused": (9733719, 9418323, 2885, 46, (0, 0, 0)),
        "tombstone-delete-forest": (1370089, 968671, 2885, 46, (0, 48, 1)),
    },
    "kron-logn21": {
        "tombstone-delete": (8772396, 8464170, 13524, 34, (0, 0, 0)),
        "tombstone-delete-fused": (8772396, 8464170, 13524, 34, (0, 0, 0)),
        "tombstone-delete-forest": (818169, 421875, 13524, 34, (1, 47, 1)),
    },
}


def count_syncs(torch, fn) -> tuple:
    """(``fn()``'s result, the synchronizing CUDA operations it made, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them)."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def event_ms(torch, fn) -> float:
    """Device-timeline ms of one ``fn()`` (CUDA events; the host work
    and read-backs inside ``fn`` are on that timeline too)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def dynamic_schedule(np, edges, n: int):
    """The benchmark's schedule: the edges permuted by default_rng(0) in
    ``DYN_ROUNDS`` insert chunks; after each, k = max(1, round(ratio *
    chunk)) kills drawn by default_rng(1) from the live set, in one
    batch, or in micro-batches of max(64, ceil(k / 8)) on a graph the
    policy routes to the forest. Returns (rounds of (chunk, delete
    batches), routed, the survivors)."""
    from repro_torch.connectivity import policy
    from repro_torch.core.unionfind import DynamicConnectivityOracle
    order = np.random.default_rng(0).permutation(edges.shape[0])
    routed = policy.extract_features(n, edges.shape[0]).tree_edge_ratio \
        <= policy.FOREST_TREE_RATIO
    rng = np.random.default_rng(1)
    oracle = DynamicConnectivityOracle(n)
    sched = []
    for s in np.array_split(order, DYN_ROUNDS):
        chunk = edges[s]
        oracle.insert(chunk)
        k = max(1, int(round(DYN_RATIO * chunk.shape[0])))
        live = oracle.alive()
        kills = live[rng.integers(0, live.shape[0], k)].astype(np.int32)
        step = max(DYN_MICRO, -(-k // 8)) if routed else k
        batches = [kills[lo:lo + step] for lo in range(0, k, step)]
        for b in batches:
            oracle.delete(b)
        sched.append((chunk, batches))
    return sched, routed, oracle.alive()


def dynamic_routes(routed: bool) -> tuple:
    from repro_torch.connectivity import policy
    return (policy.DYNAMIC_DELETE, policy.DYNAMIC_DELETE_FUSED) + (
        (policy.DYNAMIC_DELETE_FOREST,) if routed else ())


def run_stream(torch, dev, n: int, sched, route: str, on_tick=None,
               timed: bool = False):
    """Replays the schedule through ``Solver.open(num_nodes=n,
    delete_route=route)`` (a fresh in-memory autotune cache), as the
    benchmark does: the forest route repairs its forest on the insert
    side (``ensure_forest``). ``on_tick(kind, session)`` runs after
    every insert and delete tick; with ``timed`` every tick is timed.
    Returns (session, delete-side hook_ops, {"insert": [ms], "delete":
    [ms]})."""
    from repro_torch.api import Solver
    from repro_torch.connectivity import policy
    s = Solver.open(num_nodes=n, delete_route=route, device=dev,
                    policy_cache=policy.AutotuneCache(None))
    ms = {"insert": [], "delete": []}
    del_ops = 0

    def tick(kind, fn):
        if timed:
            ms[kind].append(event_ms(torch, fn))
        else:
            fn()
        if on_tick is not None:
            on_tick(kind, s)

    for chunk, batches in sched:
        def ins(chunk=chunk):
            s.insert(chunk)
            if route == policy.DYNAMIC_DELETE_FOREST:
                s.state.ensure_forest()
        tick("insert", ins)
        for b in batches:
            before = s.work["hook_ops"]
            tick("delete", lambda b=b: s.delete(b))
            del_ops += s.work["hook_ops"] - before
    return s, del_ops, ms


def dynamic_phases(torch, np, dev, rows: dict, card: str, graphs: dict) -> dict:
    """Phases 16-17: the dynamic stream on phase 3's graphs at full
    scale, then its parity constants at scale 0.002."""
    from repro_torch.connectivity import policy
    from repro_torch.core.unionfind import connected_components_scipy
    from repro_torch.graphs.generators import table1_scaled
    from repro_torch.kernels.cc_fused import ops as cc_ops, ref as cc_ref
    from repro_torch.kernels.hook import ops as hook_ops
    from repro_torch.kernels.multi_jump import ops as mj_ops

    FUSED, FOREST = policy.DYNAMIC_DELETE_FUSED, policy.DYNAMIC_DELETE_FOREST
    ks = {"cc_fused": cc_ops.KERNEL, "hook": hook_ops.KERNEL,
          "multi_jump": mj_ops.KERNEL}
    out = {}
    # the last scoped scan of each fused stream (K1's inputs on the path),
    # held against the plain version after the stream
    scans = {}
    kernel_scan = cc_ops.fused_segment_scan

    def recording_scan(pi, segments, true_counts, **kw):
        if segments.shape[0] > 1:
            scans[current] = (pi, segments, true_counts)
        return kernel_scan(pi, segments, true_counts, **kw)

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    # -- 16. the dynamic stream at full scale ---------------------------------
    for name, g in graphs.items():
        n = g.num_nodes
        t0 = time.perf_counter()
        sched, routed, survivors = dynamic_schedule(
            np, g.edges[:g.true_edges].cpu().numpy(), n)
        want = connected_components_scipy(survivors, n)
        n_ticks = sum(len(b) for _, b in sched)
        print(f"dynamic {name}: schedule {time.perf_counter() - t0:.1f} s, "
              f"{DYN_ROUNDS} inserts, {n_ticks} delete ticks, forest "
              f"routed {routed}")
        res = {"routed": routed, "delete_ticks": n_ticks, "ms": {},
               "syncs": {}, "device_ms": {}, "top_device_ops": {}}
        # after every tick: the first route's labels and version, its
        # counters (the fused route must equal the torch-op one)
        ref_ticks = []
        for route in dynamic_routes(routed):
            state = {"tick": 0, "killed": 0, "deleted": 0}

            def on_tick(kind, s, route=route, state=state):
                i = state["tick"]
                w, labels, version = s.work, s.labels, s.version
                if not i < len(ref_ticks):
                    ref_ticks.append((w, labels.clone(), version))
                else:
                    rw, rl, rv = ref_ticks[i]
                    check(torch.equal(labels, rl) and version == rv,
                          f"{name} {route} tick {i}: labels or version "
                          "differ from the first route's")
                    if route == FUSED:
                        check(w == rw, f"{name} fused tick {i} counters "
                                       f"{w} != torch-op scoped {rw}")
                d = s.state.num_edges_deleted
                state["killed"] += kind == "delete" and d > state["deleted"]
                state["deleted"] = d
                state["tick"] += 1

            current = name
            cc_ops.fused_segment_scan = recording_scan
            for k in ks.values():
                k.launches = 0
            t0 = time.perf_counter()
            try:
                s, del_ops, ms = run_stream(torch, dev, n, sched, route,
                                            on_tick=on_tick, timed=True)
                torch.cuda.synchronize()
            finally:
                cc_ops.fused_segment_scan = kernel_scan
            launches = {k: kern.launches for k, kern in ks.items()}
            wall = time.perf_counter() - t0
            got = s.labels.cpu().numpy()
            check(np.array_equal(got, want),
                  f"{name} {route}: labels differ from scipy over the "
                  "survivors")
            if route == FUSED:
                check(launches["cc_fused"] >= state["killed"] > 0,
                      f"{name} fused stream: cc_fused launched "
                      f"{launches['cc_fused']} times, {state['killed']} "
                      "ticks retired an edge")
                rows["cc_fused"].setdefault("launches_dynamic", {})[
                    name] = launches["cc_fused"]
            res["ms"][route] = {
                "wall_s": wall, "insert_ms": ms["insert"],
                "delete_ms_median": statistics.median(ms["delete"]),
                "delete_ms_total": sum(ms["delete"]),
                "delete_hook_ops": del_ops, "work": s.work,
                "version": s.version,
                "num_edges_deleted": s.state.num_edges_deleted,
                "routes": s.state.delete_route_counts(flush_obs=False),
                "launches": launches}
            print(f"dynamic {name} {route} ({card}): {wall:.1f} s; insert "
                  f"ms {[round(t, 2) for t in ms['insert']]}; delete ms "
                  f"median {res['ms'][route]['delete_ms_median']:.2f} total "
                  f"{res['ms'][route]['delete_ms_total']:.1f}; "
                  f"{res['ms'][route]['routes']}; launches {launches}")
            if route == FOREST:
                # one all-non-tree batch of 16 alive non-forest edges bills
                # no hook work (the short circuit)
                st = s.state
                st.ensure_forest()
                parents = st.forest[0].cpu().numpy()
                tree = parents[parents[:, 0] >= 0].astype(np.int64)
                tkeys = np.minimum(tree[:, 0], tree[:, 1]) << 32 | \
                    np.maximum(tree[:, 0], tree[:, 1])
                sample = survivors[np.random.default_rng(2).integers(
                    0, survivors.shape[0], 4096)]
                skeys = np.minimum(sample[:, 0], sample[:, 1]) << 32 | \
                    np.maximum(sample[:, 0], sample[:, 1])
                non_tree = sample[~np.isin(skeys, tkeys)][:16]
                check(non_tree.shape[0] == 16, f"{name}: 16 non-tree edges")
                before = s.work["hook_ops"]
                s.delete(non_tree)
                check(s.work["hook_ops"] == before,
                      f"{name}: an all-non-tree batch moved hook_ops")
                print(f"dynamic {name} forest: an all-non-tree batch of 16 "
                      "billed 0 hook_ops")
            # one more insert and delete tick of the last batch's size:
            # host syncs of each, then a delete tick's device time by op
            extra = sched[-1][1][-1]
            _, res["syncs"][f"{route} insert"] = count_syncs(
                torch, lambda: s.insert(extra))
            _, res["syncs"][f"{route} delete"] = count_syncs(
                torch, lambda: s.delete(extra))
            s.insert(extra)
            per_kernel, total = device_kernels(torch, lambda: s.delete(extra))
            res["device_ms"][route] = total
            res["top_device_ops"][route] = dict(list(per_kernel.items())[:8])
            print(f"profile {name} {route} delete tick ({card}): device "
                  f"{total:.3f} ms; top {res['top_device_ops'][route]}; "
                  f"syncs insert {res['syncs'][route + ' insert']} delete "
                  f"{res['syncs'][route + ' delete']}")
            if route == FUSED:
                rows["cc_fused"].setdefault("main_path_device_ms", {})[
                    f"{name} dynamic fused delete tick"] = kernel_share(
                        per_kernel, "cc_fused_kernel")
            # the tombstone step reads the log's edges and alive mask once
            res["log_capacity"] = s.state.log.capacity
            res["tombstone_bound_ms"] = bound_ms(9 * s.state.log.capacity)
            del s
            torch.cuda.empty_cache()
        del ref_ticks
        out[f"dynamic {name}"] = res
    print(f"dynamic peak device memory: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # K1 against its plain version on each fused stream's last scoped scan
    for name, (pi, segs, counts) in scans.items():
        got = cc_ops.fused_segment_scan(pi, segs, counts)
        want = cc_ref.ref_segment_scan(pi, segs, counts)
        torch.cuda.synchronize()
        err = max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]))
        check(err == 0, f"cc_fused differs from its plain version on "
                        f"{name}'s last scoped scan")
        sweeps = int(got[1].sum())
        n_edges = segs.shape[0] * segs.shape[1]
        entry = dict(
            shape=f"{name} last scoped scan of the fused stream: "
                  f"V={pi.shape[0]}, S={segs.shape[0]}x{segs.shape[1]}, "
                  f"{int(counts.sum())} scoped edges, {sweeps} sweeps",
            max_abs_err=err,
            ms=time_ms(torch, lambda: cc_ops.fused_segment_scan(
                pi, segs, counts)),
            plain_ms=time_ms(torch, lambda: cc_ref.ref_segment_scan(
                pi, segs, counts), reps=1),
            bound_ms=bound_ms(8 * int(counts.sum()) + 8 * pi.shape[0]
                              * (sweeps + 1)))
        rows["cc_fused"].setdefault("dynamic_scan", {})[name] = entry
        print(f"cc_fused {name} scoped scan ({card}): {entry}")
    scans.clear()
    out["dynamic_s"] = time.perf_counter() - t_phase
    print(f"dynamic: {out['dynamic_s']:.1f} s")

    # -- 17. parity constants at scale 0.002 ---------------------------------
    t_phase = time.perf_counter()
    for name, consts in DYNAMIC_PARITY.items():
        host = table1_scaled(name, scale=0.002, seed=1)
        n = host.num_nodes
        sched, routed, survivors = dynamic_schedule(np, host.edges, n)
        check(dynamic_routes(routed) == tuple(consts),
              f"{name} @0.002: routes {dynamic_routes(routed)}")
        want = connected_components_scipy(survivors, n)
        for route, c in consts.items():
            s, del_ops, _ = run_stream(torch, dev, n, sched, route)
            got = (s.work["hook_ops"], del_ops, s.state.num_edges_deleted,
                   s.version, tuple(s.state.delete_route_counts(
                       flush_obs=False).values()))
            check(got == c, f"{name} @0.002 {route}: {got} != {c}")
            check(np.array_equal(s.labels.cpu().numpy(), want),
                  f"{name} @0.002 {route}: labels differ from scipy")
        print(f"parity {name} @0.002: {dict(consts)} reproduced")
    out["dynamic_parity_s"] = time.perf_counter() - t_phase
    return out


# the batched engine (phase 18): the reference benchmark's fleets
# (benchmarks/run.py, ``batched``), then BATCH_FULL R-MAT graphs of
# 256-4,096 vertices, rmat(8 + i % 5, 8, seed=i), in five buckets
BATCH_FULL = 2048
BATCH_LOOP = 256                   # graphs of the per-graph solve loop
# the fleets through repro.api.Solver.solve_batch: per graph (hook_ops,
# jump_ops, jump_sweeps, hook_rounds, sync_rounds), the reference's
BATCHED_PARITY = {
    "molecules-64": (
        (288,384,12,8,1), (288,352,11,8,1), (576,320,10,9,1), (288,288,9,8,1),
        (288,320,10,8,1), (288,320,10,8,1), (288,352,11,8,1),
        (576,384,12,9,1), (288,352,11,8,1), (288,352,11,8,1),
        (288,384,12,8,1), (288,352,11,8,1), (288,352,11,8,1),
        (288,352,11,8,1), (288,352,11,8,1), (288,416,13,8,1),
        (288,352,11,8,1), (288,352,11,8,1), (576,416,13,9,1),
        (288,320,10,8,1), (288,352,11,8,1), (576,384,12,9,1),
        (288,352,11,8,1), (288,352,11,8,1), (288,352,11,8,1),
        (288,320,10,8,1), (288,352,11,8,1), (288,352,11,8,1),
        (288,384,12,8,1), (288,352,11,8,1), (576,384,12,9,1),
        (288,448,14,8,1), (288,320,10,8,1), (288,320,10,8,1),
        (288,352,11,8,1), (288,352,11,8,1), (576,416,13,9,1),
        (288,352,11,8,1), (288,352,11,8,1), (288,384,12,8,1),
        (288,352,11,8,1), (288,352,11,8,1), (576,416,13,9,1),
        (288,416,13,8,1), (288,320,10,8,1), (288,416,13,8,1),
        (288,352,11,8,1), (288,384,12,8,1), (288,352,11,8,1),
        (288,352,11,8,1), (288,320,10,8,1), (288,352,11,8,1),
        (288,352,11,8,1), (288,352,11,8,1), (288,352,11,8,1),
        (288,352,11,8,1), (288,352,11,8,1), (288,352,11,8,1),
        (288,320,10,8,1), (288,320,10,8,1), (288,352,11,8,1),
        (288,352,11,8,1), (288,416,13,8,1), (288,352,11,8,1)
    ),
    "mixed-48": (
        (117,400,10,2,1), (120,410,10,2,1), (123,462,11,2,1),
        (126,473,11,2,1), (129,484,11,2,1), (132,495,11,2,1),
        (135,506,11,2,1), (138,517,11,2,1), (141,528,11,2,1),
        (144,539,11,2,1), (147,600,12,2,1), (150,612,12,2,1),
        (153,624,12,2,1), (156,636,12,2,1), (159,648,12,2,1),
        (162,660,12,2,1), (54,48,4,4,1), (90,60,4,4,1), (135,72,4,4,1),
        (54,48,4,4,1), (90,60,4,4,1), (135,72,4,4,1), (54,48,4,4,1),
        (90,60,4,4,1), (135,72,4,4,1), (54,48,4,4,1), (90,60,4,4,1),
        (135,72,4,4,1), (54,48,4,4,1), (90,60,4,4,1), (135,72,4,4,1),
        (54,48,4,4,1), (492,896,14,5,1), (684,1024,16,6,1), (438,832,13,5,1),
        (480,960,15,5,1), (498,896,14,5,1), (474,832,13,5,1),
        (474,896,14,5,1), (468,896,14,5,1), (648,960,15,6,1),
        (474,896,14,5,1), (657,960,15,6,1), (390,768,12,5,1),
        (444,832,13,5,1), (792,960,15,6,1), (456,896,14,5,1), (462,896,14,5,1)
    ),
    "medium-16": (
        (6144,6656,26,16,1), (6144,5376,21,16,1), (6144,5376,21,16,1),
        (6144,5888,23,16,1), (12288,6144,24,17,1), (6144,5888,23,16,1),
        (6144,5888,23,16,1), (6144,5888,23,16,1), (6144,5888,23,16,1),
        (6144,6144,24,16,1), (6144,5632,22,16,1), (6144,6400,25,16,1),
        (6144,5888,23,16,1), (6144,5632,22,16,1), (6144,5376,21,16,1),
        (6144,5632,22,16,1)
    ),
}


def batch_fleets() -> dict:
    """The reference benchmark's fleets (``benchmarks/run.py``,
    ``batched``), from the port's generators."""
    from repro_torch.graphs.generators import (chain, disjoint_cliques,
                                               grid_road, rmat)
    return {
        "molecules-64": [rmat(5, 3, seed=s) for s in range(64)],
        "mixed-48": ([chain(40 + s) for s in range(16)]
                     + [disjoint_cliques(3, 4 + s % 3, seed=s)
                        for s in range(16)]
                     + [grid_road(8, seed=s) for s in range(16)]),
        "medium-16": [rmat(8, 8, seed=s) for s in range(16)],
    }


def batched_launches(graphs, works) -> tuple[int, int]:
    """(buckets, launches of the batched scan) a fleet with these
    per-graph counters needs: one per bucket scan, plus one per cleanup
    round, a bucket running as many rounds as its slowest graph
    (hook_rounds - S)."""
    from repro_torch.core.batch import bucket_shape
    from repro_torch.core.segmentation import plan_segmentation
    cleanup = {}
    for g, w in zip(graphs, works):
        v_pad, e_pad = bucket_shape(g.num_nodes, g.num_edges)
        s = plan_segmentation(e_pad, v_pad).num_segments
        cleanup[(v_pad, e_pad)] = max(cleanup.get((v_pad, e_pad), 0),
                                      w[3] - s)
    return len(cleanup), sum(1 + r for r in cleanup.values())


def scan_bytes(counts, v_pad: int) -> int:
    """The least bytes of one batched scan launch: each true edge read
    once (8 B), each graph's pi read and written once (8 B a vertex)."""
    return 8 * int(counts.sum()) + 8 * v_pad * counts.shape[0]


def sweep_bytes(counts, sweeps, v_pad: int) -> int:
    """The bytes of one batched scan launch that keeps pi in device
    memory: each true edge read once, and for every (graph, segment)
    that hooks an edge, that graph's pi read and written once per sweep
    it needed (8 B a vertex a sweep)."""
    return 8 * int(counts.sum()) + 8 * v_pad * int(
        (sweeps * (counts > 0)).sum())


@contextlib.contextmanager
def forced_body(cc_ops, body: str):
    """Every batched scan on ``body`` ("block" or "grid"), whatever its
    shape, while the context is open: the within-call before / after of
    the batched scan's two bodies."""
    choose = cc_ops.batched_body
    cc_ops.batched_body = lambda v_pad: body
    try:
        yield
    finally:
        cc_ops.batched_body = choose


def batched_phases(torch, np, dev, rows: dict, card: str) -> dict:
    """Phase 18: ``Solver.solve_batch`` on the benchmark's fleets
    against the reference's constants, then at full size."""
    from repro_torch.api import Solver, solve
    from repro_torch.core import batch as batch_mod, cc
    from repro_torch.core.unionfind import connected_components_scipy
    from repro_torch.graphs.device import DeviceGraph
    from repro_torch.graphs.generators import rmat
    from repro_torch.kernels.cc_fused import ops as cc_ops, ref as cc_ref

    out = {}
    t_phase = time.perf_counter()
    # -- 18a. parity: the benchmark's fleets -------------------------------
    for name, graphs in batch_fleets().items():
        consts = BATCHED_PARITY[name]
        cc_ops.BATCHED.launches = 0
        res = Solver.solve_batch(graphs)
        torch.cuda.synchronize()
        launches = cc_ops.BATCHED.launches
        buckets, want = batched_launches(graphs, consts)
        check(launches == want, f"batched {name}: {launches} launches, "
                                f"{buckets} buckets need {want}")
        check(cc_ops.BLOCK.launches == launches,
              f"batched {name}: {cc_ops.GRID.launches} launches on the "
              "grid body, the fleet's graphs fit the block body")
        for i, (g, r) in enumerate(zip(graphs, res)):
            oracle = connected_components_scipy(g.edges, g.num_nodes)
            check(np.array_equal(r.labels.numpy(), oracle),
                  f"batched {name} graph {i}: labels differ from scipy")
            solo = solve(g.edges, g.num_nodes, method="adaptive")
            check(np.array_equal(solo.labels.cpu().numpy(), oracle),
                  f"batched {name} graph {i}: per-graph adaptive differs")
            got = tuple(int(x) for x in r.work)
            check(got == consts[i], f"batched {name} graph {i}: counters "
                                    f"{got} != the reference's {consts[i]}")
        print(f"batched {name}: labels == scipy == per-graph adaptive, "
              f"counters == the reference's on {len(graphs)} graphs; "
              f"{launches} launches for {buckets} buckets")

    # -- 18b. full size ------------------------------------------------------
    t0 = time.perf_counter()
    fleet = [rmat(8 + i % 5, 8, seed=i) for i in range(BATCH_FULL)]
    n_v = sum(g.num_nodes for g in fleet)
    n_e = sum(g.num_edges for g in fleet)
    oracles = [connected_components_scipy(g.edges, g.num_nodes)
               for g in fleet]
    print(f"batched fleet: {BATCH_FULL} graphs, |V| {n_v}, |E| {n_e}; "
          f"generate and scipy {time.perf_counter() - t0:.1f} s")
    # the main path, counts set to 0 just before and read just after
    cc_ops.BATCHED.launches = 0
    res = Solver.solve_batch(fleet)
    torch.cuda.synchronize()
    launches = cc_ops.BATCHED.launches
    by_body = {"block": cc_ops.BLOCK.launches, "grid": cc_ops.GRID.launches}
    works = [tuple(int(x) for x in r.work) for r in res]
    buckets, want = batched_launches(fleet, works)
    check(launches == want, f"batched fleet: {launches} launches, "
                            f"{buckets} buckets need {want}")
    check(by_body["block"] == launches, f"batched fleet: launches by body "
                                        f"{by_body}, all fit the block body")
    for i, (r, oracle) in enumerate(zip(res, oracles)):
        check(np.array_equal(r.labels.numpy(), oracle),
              f"batched fleet graph {i}: labels differ from scipy")
    print(f"batched fleet: labels == scipy on all {BATCH_FULL} graphs; "
          f"{launches} launches for {buckets} buckets, by body {by_body}")

    # the largest bucket's scan against the plain version, timed
    dfleet = [DeviceGraph.from_host(g, device=dev) for g in fleet]
    big = max(batch_mod.stack_device_graphs(dfleet),
              key=lambda b: b.edges.numel())
    segs, counts, plan = batch_mod.bucket_segments(
        big.edges, torch.from_numpy(big.true_edges).to(dev), big.num_nodes)
    b, v_pad = segs.shape[0], big.num_nodes
    pi0 = torch.arange(v_pad, dtype=torch.int32, device=dev) \
        .expand(b, v_pad).contiguous()
    want_ = cc_ref.ref_segment_scan_batched(pi0, segs, counts)
    scan = {}
    for body in ("block", "grid"):
        with forced_body(cc_ops, body):
            before = cc_ops.GRID.launches
            got = cc_ops.fused_segment_scan_batched(pi0, segs, counts)
            torch.cuda.synchronize()
            check((cc_ops.GRID.launches - before == 1) == (body == "grid"),
                  f"the largest bucket did not take the {body} body")
            err = max(max_abs_err(got[0], want_[0]),
                      max_abs_err(got[1], want_[1]))
            check(err == 0, f"cc_fused_batched's {body} body differs from "
                            "its plain version on the largest bucket")
            # its device time is the fleet profile's launch of this bucket
            scan[body] = time_ms(
                torch, lambda: cc_ops.fused_segment_scan_batched(
                    pi0, segs, counts))
    entry = dict(
        shape=f"largest bucket scan: B={b} x V_pad={v_pad}, "
              f"S={plan.num_segments}x{plan.segment_size}, "
              f"{int(counts.sum())} edges, {int(got[1].sum())} graph "
              "sweeps",
        max_abs_err=err, ms=scan["block"], grid_body_ms=scan["grid"],
        plain_ms=time_ms(torch, lambda: cc_ref.ref_segment_scan_batched(
            pi0, segs, counts), reps=1),
        bound_ms=bound_ms(scan_bytes(counts, v_pad)),
        sweep_bytes_ms=bound_ms(sweep_bytes(counts, got[1], v_pad)))
    print(f"cc_fused_batched ({card}): both bodies equal to plain; {entry}")
    del got, want_, segs, counts, pi0, big

    # a bucket above the block body's limit: the grid body, against plain
    big_vp = 2 * cc_ops.BLOCK_MAX_V_PAD
    rng = np.random.default_rng(18)
    segs = torch.from_numpy(rng.integers(0, big_vp, (4, 3, 20000, 2))
                            .astype(np.int32)).to(dev)
    counts = torch.from_numpy(np.array([[20000, 7000, 0], [0, 0, 0],
                                        [20000, 20000, 20000],
                                        [1, 19999, 5]], np.int32)).to(dev)
    pi0 = torch.arange(big_vp, dtype=torch.int32, device=dev) \
        .expand(4, big_vp).contiguous()
    check(cc_ops.batched_body(big_vp) == "grid", "V_pad 32,768 should take "
                                                 "the grid body")
    before = cc_ops.GRID.launches
    got = cc_ops.fused_segment_scan_batched(pi0, segs, counts)
    want_ = cc_ref.ref_segment_scan_batched(pi0, segs, counts)
    torch.cuda.synchronize()
    check(cc_ops.GRID.launches == before + 1, "the V_pad 32,768 bucket did "
                                              "not take the grid body")
    check(torch.equal(got[0], want_[0]) and torch.equal(got[1], want_[1]),
          "cc_fused_batched's grid body differs from its plain version at "
          "V_pad 32,768")
    print(f"cc_fused_batched grid body ({card}): B=4 x V_pad={big_vp}, "
          f"S=3x20000, sweeps {got[1].tolist()}: pi and sweeps equal to "
          "plain")
    del got, want_, segs, counts, pi0

    # every batched launch of one solve_batch: its device ms (profiler)
    # against its byte bound (recorded inputs and sweeps)
    calls = []
    kernel_scan = cc_ops.fused_segment_scan_batched

    def recording(pi, segments, true_counts, **kw):
        p, sw = kernel_scan(pi, segments, true_counts, **kw)
        calls.append((true_counts, sw, pi.shape[1]))
        return p, sw

    profile = {}
    cc_ops.fused_segment_scan_batched = recording
    try:
        for body in ("block", "grid"):
            with forced_body(cc_ops, body):
                per_launch = launch_ms(torch, lambda: (
                    calls.clear(), Solver.solve_batch(dfleet)),
                    "cc_fused_batched")
                check(len(per_launch) == len(calls) == launches,
                      f"profile holds {len(per_launch)} batched launches "
                      f"({body} body), {len(calls)} calls, the main path "
                      f"{launches}")
                profile[body] = dict(
                    per_launch_ms=per_launch, ms=sum(per_launch),
                    bounds=[bound_ms(scan_bytes(c, v)) for c, _, v in calls],
                    sweep_bytes_ms=sum(bound_ms(sweep_bytes(c, sw, v))
                                       for c, sw, v in calls))
                per_kernel, device_total = device_kernels(
                    torch, lambda: Solver.solve_batch(dfleet))
            profile[body].update(
                device_ms=device_total,
                ops={k: v["launches"] for k, v in per_kernel.items()})
            print(f"profile batched fleet, {body} body ({card}): device "
                  f"{device_total:.3f} ms; batched "
                  f"launches ms {[round(t, 4) for t in per_launch]} "
                  f"against bounds "
                  f"{[round(t, 4) for t in profile[body]['bounds']]} "
                  f"(sweep bytes {profile[body]['sweep_bytes_ms']:.4f}); "
                  f"top {dict(list(per_kernel.items())[:6])}")
    finally:
        cc_ops.fused_segment_scan_batched = kernel_scan
    # the grid body's wrapper fills flags and copies pi a launch; the block
    # body's allocates no flags and reads pi in place
    ops = {b: profile[b].pop("ops") for b in profile}
    differ = {k: (ops["block"].get(k, 0), ops["grid"].get(k, 0))
              for k in ops["block"].keys() | ops["grid"].keys()
              if ops["block"].get(k, 0) != ops["grid"].get(k, 0)}
    print(f"fleet device ops whose launches differ (block, grid): {differ}")
    per_launch, bounds = profile["block"]["per_launch_ms"], \
        profile["block"]["bounds"]

    # times: the host fleet end to end, the DeviceGraph fleet and its
    # split (stacking, the bucket solves, the rest: the per-graph
    # results), syncs, and the per-graph loop of pallas_fused solves
    host_ms = time_ms(torch, lambda: Solver.solve_batch(fleet))
    dev_ms = time_ms(torch, lambda: Solver.solve_batch(dfleet))
    stacked = batch_mod.stack_device_graphs(dfleet)
    stack_ms = time_ms(torch, lambda: batch_mod.stack_device_graphs(dfleet))
    counts_dev = [(torch.from_numpy(bt.true_edges).to(dev),
                   torch.from_numpy(bt.true_nodes).to(dev)) for bt in stacked]
    solve_ms = time_ms(torch, lambda: [batch_mod.solve_bucket(
        bt.edges, te, tn, bt.num_nodes)
        for bt, (te, tn) in zip(stacked, counts_dev)])
    del stacked, counts_dev
    _, syncs_dev = count_syncs(torch, lambda: Solver.solve_batch(dfleet))
    _, syncs_host = count_syncs(torch, lambda: Solver.solve_batch(fleet))
    loop = dfleet[:BATCH_LOOP]
    loop_ms = time_ms(torch, lambda: [cc.solve_static(
        g, method="pallas_fused") for g in loop], reps=1)
    for g, o in zip(loop, oracles):
        check(np.array_equal(cc.solve_static(g, method="pallas_fused")
                             .labels.cpu().numpy(), o),
              "per-graph pallas_fused labels differ from scipy")
    res = {"graphs": BATCH_FULL, "nodes": n_v, "edges": n_e,
           "buckets": buckets, "launches": launches,
           "solve_batch_host_ms": host_ms,
           "solve_batch_device_graphs_ms": dev_ms,
           "device_graphs_split_ms": {"stack": stack_ms,
                                      "bucket_solves": solve_ms,
                                      "rest": dev_ms - stack_ms - solve_ms},
           "graphs_per_s_host": BATCH_FULL / host_ms * 1e3,
           "graphs_per_s_device_graphs": BATCH_FULL / dev_ms * 1e3,
           "syncs_host": syncs_host, "syncs_device_graphs": syncs_dev,
           "pergraph_pallas_fused_ms_per_graph": loop_ms / len(loop),
           "batched_ms_per_graph": dev_ms / BATCH_FULL,
           "device_ms": profile["block"]["device_ms"],
           "batched_kernel_ms": sum(per_launch),
           "batched_kernel_bound_ms": sum(bounds),
           "batched_kernel_sweep_bytes_ms":
               profile["block"]["sweep_bytes_ms"],
           "launches_by_body": by_body,
           "grid_body_forced": {k: profile["grid"][k] for k in (
               "ms", "device_ms", "per_launch_ms")},
           "device_ops_that_differ": differ}
    print(f"batched fleet ({card}): {json.dumps(res)}")
    out["batched"] = res
    rows["cc_fused_batched"] = dict(
        name="cc_fused_batched", route="cuda",
        source="src/repro_torch/kernels/csrc/cc_fused.cu",
        replaces="src/repro/kernels/cc_fused/cc_fused.py:122",
        launches=launches, launches_by_body=by_body, equal=True, **entry,
        bound_by="bytes", library_ms=None,
        main_path_device_ms={"ms": sum(per_launch),
                             "launches": len(per_launch),
                             "bound_ms": sum(bounds),
                             "grid_body_forced_ms": profile["grid"]["ms"]},
        per_launch_ms=per_launch)
    out["batched_s"] = time.perf_counter() - t_phase
    print(f"batched: {out['batched_s']:.1f} s")
    return out


# the service stream (phase 19): the reference benchmark's ``service``
# table at scale 1.0 (benchmarks/run.py), then one delete round at its
# dynamic ratio
SERVICE_ROUNDS = 6
SERVICE_QUERIES = 4                # same_component requests a round, tenant
SERVICE_PAIRS = 64
SERVICE_SLOTS = 32
SERVICE_SOCIAL_SCALE = 22          # rmat(22, 7): 4,194,304 vertices
SERVICE_ROAD_SIDE = 4898           # grid_road(4898): 23,990,404 vertices


def service_phases(torch, np, dev, rows: dict, card: str) -> dict:
    """Phase 19: two tenants behind ``ConnectivityService(slots=32)``,
    tracing on: the stream timed (ticks, SLOs) and its kernel launches
    counted, then replayed on a fresh registry to count each tick's
    syncs."""
    from repro_torch import obs
    from repro_torch.api import solve
    from repro_torch.connectivity.policy import AutotuneCache
    from repro_torch.connectivity.registry import GraphRegistry
    from repro_torch.connectivity.service import (QUERY_KINDS,
                                                  ConnectivityService)
    from repro_torch.core.unionfind import connected_components_scipy
    from repro_torch.graphs.generators import grid_road, rmat
    from repro_torch.kernels.cc_fused import ops as cc_ops
    from repro_torch.kernels.hook import ops as hook_ops
    from repro_torch.kernels.multi_jump import ops as mj_ops

    t_phase = time.perf_counter()
    tenants = {
        "social": rmat(SERVICE_SOCIAL_SCALE, 7, a=0.45, b=0.22, c=0.22,
                       seed=1, name="social"),
        "road": grid_road(SERVICE_ROAD_SIDE, extra_prob=0.02, seed=1,
                          name="road"),
    }
    for name, g in tenants.items():
        print(f"service tenant {name}: |V| {g.num_nodes} |E| {g.num_edges}")
    print(f"service generate: {time.perf_counter() - t_phase:.1f} s")
    # warm start: each tenant's bucket measured once, over the candidates
    # phase 14 times (labelprop left out, as there)
    t0 = time.perf_counter()
    cache = AutotuneCache(None)
    warm = {}
    for name, g in tenants.items():
        won = cache.measure(g, methods=MEASURED)
        warm[name] = {"winner": won, "ms": dict(cache.last_timings)}
    print(f"service warm start ({card}): {warm}, "
          f"{time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(0)
    splits = {name: np.array_split(rng.permutation(g.num_edges),
                                   SERVICE_ROUNDS)
              for name, g in tenants.items()}
    # the delete round: k = round(0.05 |E|) rows drawn by default_rng(1),
    # each retiring every copy of its undirected edge
    drng = np.random.default_rng(1)
    dels, survivors = {}, {}
    for name, g in tenants.items():
        e = g.edges.astype(np.int64)
        k = int(round(DYN_RATIO * g.num_edges))
        dels[name] = g.edges[drng.integers(0, g.num_edges, k)]
        d = dels[name].astype(np.int64)
        keys = np.minimum(e[:, 0], e[:, 1]) << 32 | np.maximum(e[:, 0],
                                                               e[:, 1])
        dkeys = np.minimum(d[:, 0], d[:, 1]) << 32 | np.maximum(d[:, 0],
                                                                d[:, 1])
        survivors[name] = g.edges[~np.isin(keys, dkeys)]
    # the stream, drawn once and submitted alike by both runs below:
    # per round, (tenant, kind, payload) in submission order
    stream = []
    for rnd in range(SERVICE_ROUNDS + 1):
        subs = []
        for name, g in tenants.items():
            subs.append((name, "insert", g.edges[splits[name][rnd]])
                        if rnd < SERVICE_ROUNDS else
                        (name, "delete", dels[name]))
            subs += [(name, "same_component",
                      rng.integers(0, g.num_nodes, (SERVICE_PAIRS, 2)))
                     for _ in range(SERVICE_QUERIES)]
            subs.append((name, "count_components", None))
        stream.append(subs)

    def open_service():
        registry = GraphRegistry(policy_cache=cache, device=dev)
        for name, g in tenants.items():
            registry.create(name, g.num_nodes)
        return registry, ConnectivityService(registry, slots=SERVICE_SLOTS)

    def submit(svc, subs) -> dict:
        pairs = {}
        for name, kind, payload in subs:
            if kind == "insert":
                svc.submit_insert(name, payload)
            elif kind == "delete":
                svc.submit_delete(name, payload)
            else:
                uid = svc.submit_query(name, kind, payload)
                if payload is not None:
                    pairs[uid] = payload
        return pairs

    # the timed, counted run: tracing on (the SLOs record), no sync
    # debugging; each tick's kernel counts set to 0 just before its
    # ``svc.run`` and read just after
    ks = {"cc_fused": cc_ops.KERNEL, "hook": hook_ops.KERNEL,
          "multi_jump": mj_ops.KERNEL}
    launches = dict.fromkeys(ks, 0)
    registry, svc = open_service()
    tracer = obs.enable(capacity=1 << 14)
    tracer.reset()
    ticks, checked = [], 0
    try:
        for rnd, subs in enumerate(stream):
            kind = "insert" if rnd < SERVICE_ROUNDS else "delete"
            pairs = submit(svc, subs)
            before = svc.stats["ticks"]
            torch.cuda.synchronize()
            for k in ks.values():
                k.launches = 0
            t0 = time.perf_counter()
            done = svc.run()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            for k, kern in ks.items():
                launches[k] += kern.launches
            check(svc.stats["ticks"] == before + 1,
                  f"service round {rnd}: not one tick")
            labels = {name: registry.get(name).labels.cpu().numpy()
                      for name in tenants}
            for r in done:
                check(r.error is None and r.done,
                      f"service round {rnd}: request {r.uid} failed "
                      f"({r.error})")
                lab = labels[r.tenant]
                if r.kind == "same_component":
                    p = pairs[r.uid]
                    check(np.array_equal(r.result, lab[p[:, 0]]
                                         == lab[p[:, 1]]),
                          f"service round {rnd}: same_component {r.uid} "
                          "differs from numpy over the tick's labels")
                    checked += 1
                elif r.kind == "count_components":
                    roots = int((lab == np.arange(lab.shape[0])).sum())
                    check(int(r.result) == roots,
                          f"service round {rnd}: count_components "
                          f"{int(r.result)} != {roots}")
            ticks.append({"kind": kind, "ms": ms,
                          "routes": {name: registry.get(name).last_method
                                     for name in tenants}})
    finally:
        obs.disable()
    stream_s = sum(t["ms"] for t in ticks) / 1e3
    check(launches["cc_fused"] > 0 or not any(
        "fused" in r for t in ticks for r in t["routes"].values()),
        "service: a fused route ran but K1 never launched")
    final = {}
    for name, g in tenants.items():
        final[name] = registry.get(name).labels.cpu().numpy()
        want = connected_components_scipy(survivors[name], g.num_nodes)
        check(np.array_equal(final[name], want),
              f"service {name}: final labels differ from scipy over the "
              "survivors")
    # the counterfactual, priced as the reference benchmark prices it:
    # every query request recomputes the accumulated edge set with
    # method="adaptive"
    counter_ops = 0
    for rnd in range(SERVICE_ROUNDS + 1):
        for name, g in tenants.items():
            acc = survivors[name] if rnd == SERVICE_ROUNDS else g.edges[
                np.concatenate(splits[name][: rnd + 1])]
            w = solve(acc, g.num_nodes, method="adaptive").work
            counter_ops += (SERVICE_QUERIES + 1) * int(w.hook_ops)
    stats = registry.stats()
    service_ops = sum(s["hook_ops"] for s in stats.values())
    check(service_ops < counter_ops,
          f"service hook_ops {service_ops} not below the per-query "
          f"recompute's {counter_ops}")

    def q_ms(q, tenant=None):
        return svc.slo.percentile(q, tenant=tenant, kinds=QUERY_KINDS) * 1e3

    quantiles = {**{f"p{int(q * 100)}_ms_query_{name}": q_ms(q, name)
                    for name in tenants for q in (0.50, 0.99)},
                 "p50_ms_query_global": q_ms(0.50),
                 "p99_ms_query_global": q_ms(0.99)}
    latency = svc.obs_summary()["latency"]
    svc_stats = dict(svc.stats)
    del registry, svc
    torch.cuda.empty_cache()
    # the syncs: a replay of the same stream on a fresh registry, each
    # tick under sync debugging, whose warnings would weigh on the timed
    # run's ticks and SLOs
    registry, svc = open_service()
    obs.enable(capacity=1 << 14).reset()
    try:
        for rnd, subs in enumerate(stream):
            submit(svc, subs)
            _, ticks[rnd]["syncs"] = count_syncs(torch, svc.run)
            check({name: registry.get(name).last_method for name in tenants}
                  == ticks[rnd]["routes"],
                  f"service replay round {rnd}: routes differ from the "
                  "timed run's")
    finally:
        obs.disable()
    for name in tenants:
        check(np.array_equal(registry.get(name).labels.cpu().numpy(),
                             final[name]),
              f"service replay {name}: final labels differ")
    del registry, svc
    torch.cuda.empty_cache()

    res = {
        "queries": svc_stats["queries_served"],
        "same_component_checked": checked,
        "stream_ms": stream_s * 1e3,
        "queries_per_s": svc_stats["queries_served"] / stream_s,
        "tick_ms": {t["kind"] + str(i): t["ms"]
                    for i, t in enumerate(ticks)},
        "tick_syncs": {t["kind"] + str(i): t["syncs"]
                       for i, t in enumerate(ticks)},
        "routes": [t["routes"] for t in ticks],
        "hook_ops_service": service_ops,
        "hook_ops_perquery_recompute": counter_ops,
        **quantiles,
        "launches": launches,
        "tenant_stats": {n: {k: s[k] for k in (
            "absorbs", "scoped_deletes", "rebuilds", "cache_hits",
            "version", "num_edges_deleted")} for n, s in stats.items()},
        "stats": svc_stats,
    }
    print(f"service ({card}): {json.dumps(res)}")
    print(f"service latency ({card}): {json.dumps(latency)}")
    rows["cc_fused"]["launches_service"] = launches["cc_fused"]
    out = {"service": res, "service_s": time.perf_counter() - t_phase}
    print(f"service: {out['service_s']:.1f} s")
    return out


# the multi-shard engine (phase 20): meshes of 1, 2 and 4 slots on the
# card over phase 3's graphs, then the cc-adaptive cell
DIST_SLOTS = (1, 2, 4)
CELL_SLOTS = 4


def distributed_phases(torch, np, dev, rows: dict, card: str, graphs: dict,
                       oracles: dict) -> dict:
    """Phase 20: ``Solver.open(g, mesh=make_mesh(k)).solve()`` on phase
    3's graphs for k = 1, 2 and 4 slots, then the ``cc-adaptive`` cell
    on the four Table I shapes and the usa-osm cell's step."""
    from repro_torch.api import Solver
    from repro_torch.configs import cc_graphs
    from repro_torch.core import cc, distributed, rounds
    from repro_torch.kernels.cc_fused import ops as cc_ops, ref as cc_ref
    from repro_torch.kernels.multi_jump import ops as mj_ops
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh

    t_phase = time.perf_counter()
    res, shard_rows = {}, []
    total = {"cc_fused": 0, "multi_jump": 0}
    for name, g in graphs.items():
        fused = cc.solve_static(g, method="pallas_fused").labels
        for k in DIST_SLOTS:
            mesh = make_mesh(k)
            check(all(d.type == dev.type for d in mesh.slot_devices()),
                  f"the {k}-slot mesh landed off the card: {mesh}")
            s = Solver.open(g, mesh=mesh)
            plan = s.plan()
            check((plan.backend, plan.reason) == ("distributed", "sharded"),
                  f"{name} mesh session plans {plan.backend} "
                  f"({plan.reason})")
            # the main path, counts set to 0 just before, read just after
            torch.cuda.synchronize()
            cc_ops.KERNEL.launches = 0
            mj_ops.KERNEL.launches = 0
            out = s.solve()
            torch.cuda.synchronize()
            k1, roots = cc_ops.KERNEL.launches, mj_ops.ROOTS.launches
            seq = mj_ops.SEQUENTIAL.launches
            n_rounds = s.last_plan.artifacts["rounds"]
            check(1 <= n_rounds <= distributed._MAX_ROUNDS,
                  f"{name} k={k}: {n_rounds} rounds")
            check(k1 == k * n_rounds, f"{name} k={k}: K1 launched {k1} "
                                      f"times, {k} x {n_rounds} rounds")
            check(roots == n_rounds and seq == 0,
                  f"{name} k={k}: K3 launched {roots} times on the "
                  f"fixpoint body and {seq} on the sequential one, "
                  f"{n_rounds} rounds")
            total["cc_fused"] += k1
            total["multi_jump"] += roots
            check(out.labels.device.type == dev.type
                  and torch.equal(out.labels, fused),
                  f"{name} k={k}: labels differ from pallas_fused's")
            check(np.array_equal(out.labels.cpu().numpy(), oracles[name]),
                  f"{name} k={k}: labels differ from the scipy oracle")
            # slot 0's scan against the plain version at its shapes
            sharded = g.shard(mesh)
            fn = distributed.build_distributed_cc(sharded, mesh)
            segs = rounds.pad_and_segment(sharded.shards[0], fn.plan)
            counts = torch.full((segs.shape[0],), segs.shape[1],
                                dtype=torch.int32, device=dev)
            pi0 = torch.arange(g.num_nodes, dtype=torch.int32, device=dev)
            got = cc_ops.fused_segment_scan(pi0, segs, counts)
            want = cc_ref.ref_segment_scan(pi0, segs, counts)
            torch.cuda.synchronize()
            err = max(max_abs_err(got[0], want[0]),
                      max_abs_err(got[1], want[1]))
            check(err == 0, f"{name} k={k}: slot 0's K1 scan differs from "
                            "its plain version")
            sweeps = int(got[1].sum())
            entry = {"name": name, "slots": k, "rounds": n_rounds,
                     "k1_launches": k1, "k3_launches": roots,
                     "solve_ms": time_ms(torch, s.solve)}
            per_kernel, device_total = device_kernels(torch, s.solve)
            _, syncs = count_syncs(torch, s.solve)
            entry.update(
                device_ms=device_total,
                k1_device_ms=kernel_share(per_kernel, "cc_fused_kernel"),
                k3_device_ms=kernel_share(per_kernel,
                                          "compress_roots_kernel"),
                top_device_ms={k_: v["ms"] for k_, v in
                               list(per_kernel.items())[:6]},
                syncs=syncs)
            if k == max(DIST_SLOTS):
                n_edges = segs.shape[0] * segs.shape[1]
                shard_rows.append(dict(
                    shape=f"{name} slot 0 of {k}: V={g.num_nodes}, "
                          f"S={segs.shape[0]}x{segs.shape[1]}, "
                          f"{sweeps} sweeps",
                    max_abs_err=err,
                    ms=time_ms(torch, lambda: cc_ops.fused_segment_scan(
                        pi0, segs, counts)),
                    plain_ms=time_ms(torch, lambda: cc_ref.ref_segment_scan(
                        pi0, segs, counts)),
                    bound_ms=bound_ms(8 * n_edges
                                      + 8 * g.num_nodes * (sweeps + 1))))
            res[f"{name} k={k}"] = entry
            print(f"distributed {name} k={k} ({card}): labels == scipy == "
                  f"pallas_fused; slot 0's scan == plain; {json.dumps(entry)}")
            del s, out, sharded, fn, segs, got, want
    torch.cuda.empty_cache()

    # the cc-adaptive cell: its spec on every Table I shape, then the
    # usa-osm cell's step on the usa stand-in padded to the spec's rows
    specs = {}
    for shape in cc_graphs.SHAPES:
        cell = steps.build_cell("cc-adaptive", shape,
                                mesh=make_mesh(CELL_SLOTS))
        specs[shape] = {"input": cc_graphs.input_specs(shape)["edges"][0],
                        "num_nodes": cc_graphs.input_specs(shape)[
                            "num_nodes"],
                        "padded": cell.args[0][0]}
    print(f"cc-adaptive cells over {CELL_SLOTS} slots: "
          f"{json.dumps(specs)}")
    cell = steps.build_cell("cc-adaptive", "usa-osm",
                            mesh=make_mesh(CELL_SLOTS))
    g = graphs["usa-osm"]
    rows_in, v = specs["usa-osm"]["input"][0], specs["usa-osm"]["num_nodes"]
    host = np.zeros((rows_in, 2), np.int32)
    host[:g.true_edges] = g.edges[:g.true_edges].cpu().numpy()
    torch.cuda.synchronize()
    cc_ops.KERNEL.launches = 0
    mj_ops.KERNEL.launches = 0
    t0 = time.perf_counter()
    labels = cell.step(host)
    torch.cuda.synchronize()
    cell_ms = (time.perf_counter() - t0) * 1e3
    n_rounds = cell.step.engine.last_rounds
    check(cc_ops.KERNEL.launches == CELL_SLOTS * n_rounds
          and mj_ops.ROOTS.launches == n_rounds,
          f"cc-adaptive usa-osm: K1 {cc_ops.KERNEL.launches}, K3 "
          f"{mj_ops.ROOTS.launches} launches for {n_rounds} rounds")
    total["cc_fused"] += cc_ops.KERNEL.launches
    total["multi_jump"] += mj_ops.ROOTS.launches
    want = np.concatenate([oracles["usa-osm"],
                           np.arange(g.num_nodes, v, dtype=np.int32)])
    check(labels.device.type == dev.type
          and np.array_equal(labels.cpu().numpy(), want),
          "cc-adaptive usa-osm: labels differ from scipy's")
    cell_res = {"rows": specs["usa-osm"]["padded"][0], "num_nodes": v,
                "true_edges": g.true_edges, "rounds": n_rounds,
                "step_ms": cell_ms}
    print(f"cc-adaptive usa-osm step ({card}): labels == scipy; "
          f"{json.dumps(cell_res)}")
    del labels, host, cell
    torch.cuda.empty_cache()
    rows["cc_fused"]["launches_distributed"] = total["cc_fused"]
    rows["cc_fused"]["distributed_shard_scan"] = shard_rows
    rows["multi_jump"]["launches_distributed"] = total["multi_jump"]
    out = {"distributed": res, "cc_cell": cell_res,
           "distributed_s": time.perf_counter() - t_phase}
    print(f"distributed: {out['distributed_s']:.1f} s")
    return out


# the fleet (phase 21): the reference benchmark's ``fleet`` table at
# scale 1.0 (benchmarks/run.py) on four slots of the card
FLEET_SLOTS = 4
FLEET_TENANTS = 128                # per slot
FLEET_N = 200_000                  # vertices a tenant
FLEET_TICKS = 6
FLEET_PAIRS = 128
FLEET_INSERT = 24


def fleet_schedule(np, names, n: int):
    """The table's tenants and open-loop arrivals, drawn as it draws
    them: (base edges per tenant, the whale's chain, ticks of (tenant,
    kind, payload))."""
    rng = np.random.default_rng(0)
    base = {t: rng.integers(0, n, (n // 2, 2)).astype(np.int32)
            for t in names}
    chain = np.stack([np.arange(4 * n, dtype=np.int32),
                      np.arange(1, 4 * n + 1, dtype=np.int32)], axis=1)
    schedule = []
    for tick in range(FLEET_TICKS):
        arrivals = []
        for i, t in enumerate(names):
            if i % 256 == tick % 256:
                arrivals.append((t, "insert", rng.integers(
                    0, n, (FLEET_INSERT, 2)).astype(np.int32)))
            arrivals.append((t, "same_component", rng.integers(
                0, n, (FLEET_PAIRS, 2)).astype(np.int32)))
            arrivals.append((t, "component_size", rng.integers(
                0, n, (FLEET_PAIRS,)).astype(np.int32)))
        # the table draws the whale's pairs below its whale_nodes = 4n
        arrivals.append(("whale", "same_component", rng.integers(
            0, 4 * n, (FLEET_PAIRS, 2)).astype(np.int32)))
        schedule.append(arrivals)
    return base, chain, schedule


def fleet_phases(torch, np, dev, rows: dict, card: str) -> dict:
    """Phase 21: the benchmark's fleet stream through ``FleetService``
    over four slots of the card and through one ``ConnectivityService``
    holding every tenant; answers cross-checked request by request."""
    from repro_torch import obs
    from repro_torch.connectivity.service import (QUERY_KINDS,
                                                  ConnectivityService)
    from repro_torch.core.unionfind import connected_components_scipy
    from repro_torch.fleet import FleetService
    from repro_torch.kernels.cc_fused import ops as cc_ops
    from repro_torch.kernels.multi_jump import ops as mj_ops

    t_phase = time.perf_counter()
    n = FLEET_N
    names = [f"t{i:04d}" for i in range(FLEET_TENANTS * FLEET_SLOTS)]
    # the table's whale_nodes = max(1 << 11, 4n) = 4n, but its chain
    # reaches vertex 4n: the one cut, the whale gets 4n + 1 vertices
    # and the shard threshold stays 4n
    threshold, whale_nodes = 4 * n, 4 * n + 1
    base, chain, schedule = fleet_schedule(np, names, n)
    n_requests = sum(len(a) for a in schedule)
    probe = np.zeros((FLEET_PAIRS, 2), np.int32)
    print(f"fleet: {len(names)} tenants of |V| {n}, |E| {n // 2} + a whale "
          f"of |V| {whale_nodes}, |E| {chain.shape[0]}; {n_requests} "
          f"requests in {FLEET_TICKS} ticks; generate "
          f"{time.perf_counter() - t_phase:.1f} s")

    def preload(submit, submit_insert, run):
        for t in names:
            submit_insert(t, base[t])
        submit_insert("whale", chain)
        run()
        for t in names:
            submit(t, "same_component", probe)
        submit("whale", "same_component", probe)
        run()

    def drive(submit, step, run, on_step=None):
        """Replays the schedule; returns {(tenant, kind, i): i-th answer
        of that kind}, the table's cross-check key."""
        retired = []
        for arrivals in schedule:
            for t, kind, payload in arrivals:
                submit(t, kind, payload)
            retired.extend(step() if on_step is None else on_step(step))
        retired.extend(run())
        answers, seq = {}, {}
        for r in retired:
            check(r.error is None, f"fleet: {r.tenant} {r.kind} failed "
                                   f"({r.error})")
            if r.kind in QUERY_KINDS:
                i = seq.get((r.tenant, r.kind), 0)
                seq[(r.tenant, r.kind)] = i + 1
                answers[(r.tenant, r.kind, i)] = np.asarray(r.result)
        return answers

    devices = [torch.device("cuda", 0) if dev.type == "cuda" else dev] \
        * FLEET_SLOTS

    def build_fleet():
        fs = FleetService(devices, slots_per_device=1024, rebalance_every=0,
                          shard_threshold=threshold)
        for t in names:
            fs.admit(t, n, expected_edges=n)
        fs.admit("whale", whale_nodes, expected_edges=4 * n)
        preload(fs.submit, fs.submit_insert, fs.run)
        return fs

    def build_single():
        svc = ConnectivityService(slots=4096, device=devices[0])
        for t in names:
            svc.registry.create(t, n)
        svc.registry.create("whale", whale_nodes)
        preload(svc.submit, svc.submit_insert, svc.run)
        return svc

    # the fleet's main path (admission, preload, the stream), counts set
    # to 0 just before and read just after; tracing on for the SLOs
    torch.cuda.synchronize()
    cc_ops.KERNEL.launches = 0
    mj_ops.KERNEL.launches = 0
    tracer = obs.enable(capacity=1 << 14)
    tracer.reset()
    try:
        t0 = time.perf_counter()
        fs = build_fleet()
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        fleet_answers = drive(fs.submit, fs.step, fs.run)
        torch.cuda.synchronize()
        fleet_s = time.perf_counter() - t0
        launches = {"cc_fused": cc_ops.KERNEL.launches,
                    "multi_jump": mj_ops.ROOTS.launches}
        slo = fs.slo()
    finally:
        obs.disable()
    owners = [sum(1 for t in names if fs.placement_of(t) == i)
              for i in range(FLEET_SLOTS)]
    check(owners == [FLEET_TENANTS] * FLEET_SLOTS,
          f"fleet: tenants per slot {owners}")
    check(fs.placement_of("whale") == "mesh", "fleet: the whale is packed")
    whale = fs._sharded["whale"]
    check(launches["cc_fused"] >= FLEET_SLOTS and launches["multi_jump"] >= 1,
          f"fleet: the whale's mesh solve launched {launches}")
    for i, t in enumerate(names):
        acc = np.concatenate([base[t]] + [
            p for a in schedule for (u, kind, p) in a
            if u == t and kind == "insert"])
        got = fs.shards[fs.placement_of(t)].registry.get(t).labels
        check(np.array_equal(got.cpu().numpy(),
                             connected_components_scipy(acc, n)),
              f"fleet {t}: labels differ from scipy")
    check(np.array_equal(whale.labels.cpu().numpy(),
                         connected_components_scipy(chain, whale_nodes)),
          "fleet whale: labels differ from scipy")
    stats = fs.stats_summary()
    del fs
    torch.cuda.empty_cache()

    tobs = obs.enable(capacity=1 << 14)
    tobs.reset()
    try:
        t0 = time.perf_counter()
        svc = build_single()
        torch.cuda.synchronize()
        single_build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        single_answers = drive(svc.submit, svc.step, svc.run)
        torch.cuda.synchronize()
        single_s = time.perf_counter() - t0
        single_slo = svc.slo
    finally:
        obs.disable()
    check(fleet_answers.keys() == single_answers.keys(),
          "fleet and single-device answers cover different requests")
    for key, a in fleet_answers.items():
        check(np.array_equal(a, single_answers[key]),
              f"fleet answer {key} differs from the single device's")
    del svc
    torch.cuda.empty_cache()

    # the syncs: a replay on a fresh fleet, each tick under sync debugging
    fs = build_fleet()
    ticks = []

    def counted(step):
        before = fs.engine.stats["collects"]
        done, syncs = count_syncs(torch, step)
        ticks.append({"syncs": syncs,
                      "event_waits": fs.engine.stats["collects"] - before})
        return done

    replay = drive(fs.submit, fs.step, fs.run, on_step=counted)
    check(replay.keys() == fleet_answers.keys() and all(
        np.array_equal(a, fleet_answers[k]) for k, a in replay.items()),
        "fleet replay answers differ from the timed run's")
    del fs
    torch.cuda.empty_cache()

    def q_ms(rec, q, kind):
        return rec.percentile(q, kinds=(kind,)) * 1e3

    res = {
        "tenants": len(names) + 1, "slots": FLEET_SLOTS,
        "requests": n_requests,
        "fleet_build_s": build_s, "single_build_s": single_build_s,
        "ms_fleet": fleet_s * 1e3, "ms_single_device": single_s * 1e3,
        "requests_per_s_fleet": n_requests / fleet_s,
        "requests_per_s_single": n_requests / single_s,
        "p50_ms_same_component_fleet": q_ms(slo, 0.50, "same_component"),
        "p99_ms_same_component_fleet": q_ms(slo, 0.99, "same_component"),
        "p50_ms_component_size_fleet": q_ms(slo, 0.50, "component_size"),
        "p99_ms_component_size_fleet": q_ms(slo, 0.99, "component_size"),
        "p50_ms_same_component_single": q_ms(single_slo, 0.50,
                                             "same_component"),
        "p99_ms_same_component_single": q_ms(single_slo, 0.99,
                                             "same_component"),
        "tick_syncs": [t["syncs"] for t in ticks],
        "tick_event_waits": [t["event_waits"] for t in ticks],
        "launches": launches,
        "whale_resolves": whale.resolves,
        "engine": stats["engine"], "runner_cache": stats["runner_cache"],
        "query_calls_fleet": sum(s["query_calls"] for s in stats["shards"]),
    }
    print(f"fleet ({card}): answers == single device request by request; "
          f"every tenant's labels == scipy; {json.dumps(res)}")
    rows["cc_fused"]["launches_fleet"] = launches["cc_fused"]
    rows["multi_jump"]["launches_fleet"] = launches["multi_jump"]
    out = {"fleet": res, "fleet_s": time.perf_counter() - t_phase}
    print(f"fleet: {out['fleet_s']:.1f} s")
    return out


# the MLA and MoE LMs (phases 22-23) at full width; the MoE models' depth
# is cut to what one 80 GB card holds beside its caches and activations
MOE_DEPTH = {"phi3.5-moe-42b-a6.6b": 24, "grok-1-314b": 6}
MOE_PROMPTS = (17, 1000, 4097, 8192)
MOE_MAX_NEW = (8, 32, 16, 32)
NORMS = ("ln1", "ln2", "final_norm", "q_norm", "kv_norm")
PREFILL_OPS = ("aten::bmm", "aten::mm", "aten::index_add_", "aten::index",
               "aten::sort", "aten::cumsum", "aten::_softmax", "aten::cat",
               "aten::copy_")


def random_lm(torch, T, cfg, dev) -> dict:
    """Random weights from seed 0 (``T.init``), the norm weights then
    drawn N(1, 0.1²) from seed 1: at the reference's zero init every
    norm without gemma's ``1 +`` zeroes its output, and the logits with
    it."""
    params = T.init(cfg, generator=torch.Generator(dev).manual_seed(0),
                    device=dev)
    g = torch.Generator(dev).manual_seed(1)
    for name, t in T.flatten(params).items():
        if name.rsplit(".", 1)[-1] in NORMS:
            t.normal_(1.0, 0.1, generator=g)
    return params


def k6_at_model_shape(torch, np, dev, cfg, params, card: str) -> dict:
    """K6 on the real layer-0 q, k, v of an 8192-token prefill of
    ``cfg`` (seed 1 tokens), against its plain version by groups of kv
    heads under the p-rounding gates; timed beside the plain version
    and SDPA. For MLA the call is the padded one (q / k 96 -> 128, v 64
    -> 128): the plain version of the unpadded tensors equals the padded
    one's first 64 columns in f32, the padded columns of the kernel's
    output are 0, and SDPA, the route (pad, kernel, slice) and the true
    bound take the unpadded shapes."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa_ops, \
        ref as fa_ref
    from repro_torch.models import layers as L

    captured = prefill_attention_inputs(torch, np, dev, cfg, params, 1)
    q, k, v, kw = captured[0]
    hq, hkv, dp = q.shape[2], k.shape[2], q.shape[3]
    mla = cfg.attention == "mla"
    d = cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim if mla else dp
    dv = cfg.mla.v_head_dim if mla else dp
    check(kw == dict(sm_scale=d ** -0.5, causal=True, window=0,
                     softcap=cfg.attn_softcap) and v.shape[3] == dp,
          f"{cfg.name}: flash call {tuple(v.shape)} {kw}")
    pkw = dict(sm_scale=kw["sm_scale"], causal=True)
    got = fa_ops.flash_attention(q, k, v, **kw)
    grp = hq // hkv
    per = max(1, 8 // grp)                 # kv heads in a plain-version call
    groups = [slice(j, min(j + per, hkv)) for j in range(0, hkv, per)]

    def parts(j, x_q, x_k, x_v):
        return (x_q[:, :, j.start * grp:j.stop * grp], x_k[:, :, j],
                x_v[:, :, j])

    def by_group(fn, *xs):
        return torch.cat([fn(*parts(j, *xs), **pkw) for j in groups], dim=2)

    want = by_group(fa_ref.ref_flash_attention, q, k, v)
    bound = by_group(fa_ref.p_rounding_bound, q, k, v)
    norm_bound = sum(fa_ref.p_rounding_norm_bound(*parts(j, q, k, v), **pkw)
                     ** 2 for j in groups) ** 0.5
    res = attention_check(fa_ref, got, want, f"{cfg.name} layer 0", bound,
                          norm_bound)
    del want, bound
    qu, ku, vu = (x[..., :n].contiguous()
                  for x, n in ((q, d), (k, d), (v, dv)))
    if mla:
        check(bool((got[..., dv:] == 0).all()),
              "the padded columns of the MLA kernel output are not 0")

        def plain_f32(x_q, x_k, x_v, sm_scale, causal):
            b, s, h, _ = x_q.shape

            def fold(x):
                return x.permute(0, 2, 1, 3).reshape(b * h, s, x.shape[-1])
            p = fa_ref.attention_probs(fold(x_q), fold(x_k),
                                       sm_scale=sm_scale, causal=causal)
            return torch.einsum("bqk,bkd->bqd", p, fold(x_v).float())

        res["padded_vs_unpadded_plain_f32_err"] = max(float(
            (plain_f32(*parts(j, q, k, v), **pkw)[..., :dv]
             - plain_f32(*parts(j, qu, ku, vu), **pkw)).abs().max())
            for j in groups)
        check(res["padded_vs_unpadded_plain_f32_err"] <= 1e-5,
              f"padded plain attention differs from the unpadded: {res}")
    del got
    torch.cuda.synchronize()
    ms = time_ms(torch, lambda: fa_ops.flash_attention(q, k, v, **kw))
    b_ms, by = attention_bound(q, k, 0)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (qu, ku, vu))

    def sdpa():
        return F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, scale=kw["sm_scale"],
            enable_gqa=hq != hkv)

    row = dict(
        shape=f"{cfg.name} layer 0 of a {q.shape[1]}-token prefill: q "
              f"{tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)} bf16"
              + (f" (q / k {d}, v {dv}, zero-padded to {dp})" if mla
                 else "") + ", causal, softcap 0",
        **res, ms=ms, body="wgmma" if fa_ops.body_of(
            q.dtype, dp) is fa_ops.WGMMA else "fma",
        plain_ms=time_ms(torch, lambda: by_group(
            fa_ref.ref_flash_attention, q, k, v)),
        plain="ref_flash_attention by groups of kv heads",
        bound_ms=b_ms, bound_by=by, library_ms=time_ms(torch, sdpa),
        library=f"F.scaled_dot_product_attention(is_causal=True, scale="
                f"{d}**-0.5{', enable_gqa=True' if hq != hkv else ''}) on "
                f"{'the unpadded ' if mla else ''}[B, H, S, d] copies",
        tflops=attention_flops(q, 0) / ms / 1e9, share_of_bound=b_ms / ms)
    row["library_ratio"] = ms / row["library_ms"]
    if mla:
        pos = torch.arange(q.shape[1], dtype=torch.int32, device=dev)
        pairs = q.shape[0] * causal_pairs(q.shape[1], q.shape[1], 0)
        by_bytes = bound_ms(2 * q.shape[0] * q.shape[1] * (hq + hkv)
                            * (d + dv))
        by_ops = 2 * (d + dv) * hq * pairs / BF16_OPS_PER_S * 1e3
        row.update(
            bound_true_ms=max(by_bytes, by_ops),
            bound_true_by="bytes" if by_bytes >= by_ops else "operations",
            bound_note=f"bound_ms: the padded work (q, k, v, o at d {dp}); "
                       f"bound_true_ms: the true work (q / k {d}, v / o "
                       f"{dv})",
            route_ms=time_ms(torch, lambda: L.multi_head_attention(
                qu, ku, vu, q_positions=pos, k_positions=pos,
                sm_scale=kw["sm_scale"])),
            route="layers.multi_head_attention on the unpadded tensors: "
                  "the pads, the kernel, the slice")
    print(f"flash_attention {cfg.name} ({card}): {row}")
    del q, k, v, qu, ku, vu, qt, kt, vt, captured
    return row


def routing_recorder(eng, M, E):
    """Wraps ``moe.route``, ``engine._prefill`` and ``engine._decode`` to
    keep, per engine call, the rows it routed (prefill: the request's
    uid; decode: (uid, position) per slot, None for an empty one) and,
    per layer, ``gate_idx`` and ``keep`` (cloned on the device, no sync).
    Returns (the record, a function that undoes the wrapping)."""
    calls = []
    route, prefill, decode = M.route, E._prefill, E._decode
    uids = iter(range(1, 1 << 30))      # the engine's uids, FIFO admission

    def rec_route(*a):
        r = route(*a)
        calls[-1][2].append((r["gate_idx"].clone(), r["keep"].clone()))
        return r

    def rec_prefill(*a):
        calls.append(("prefill", next(uids), []))
        return prefill(*a)

    def rec_decode(*a):
        calls.append(("decode", [None if r is None else
                                 (r.uid, int(eng.lengths[s]))
                                 for s, r in enumerate(eng.active)], []))
        return decode(*a)

    M.route, E._prefill, E._decode = rec_route, rec_prefill, rec_decode

    def undo():
        M.route, E._prefill, E._decode = route, prefill, decode
    return calls, undo


def served_routing(torch, calls, uid: int, plen: int, n: int, k: int):
    """Per layer, the routing the engine gave request ``uid``'s tokens
    at positions 0..n-1 (the prompt's from its prefill, the rest from
    the decode steps that fed them): (gate_idx [n, k], keep [k * n]
    choice-major)."""
    pre = next(c for c in calls if c[0] == "prefill" and c[1] == uid)
    steps = []
    for c in calls:
        if c[0] == "decode":
            for s, row in enumerate(c[1]):
                if row is not None and row[0] == uid:
                    steps.append((c, s, row[1]))
    steps = steps[:n - plen]
    check([p for _, _, p in steps] == list(range(plen, n)),
          f"request {uid}: decode positions do not follow its prompt")
    out = []
    for i, (gate_p, keep_p) in enumerate(pre[2]):
        gates, keeps = [gate_p[:plen]], [keep_p.view(k, -1)[:, :plen]]
        for c, s, _ in steps:
            gate_d, keep_d = c[2][i]
            gates.append(gate_d[s:s + 1])
            keeps.append(keep_d.view(k, -1)[:, s:s + 1])
        out.append((torch.cat(gates), torch.cat(keeps, dim=1).reshape(-1)))
    return out


def forced_route(torch, F, decisions):
    """A ``moe.route`` that takes each call's decisions (gate_idx, keep)
    from ``decisions`` (one a layer, in order) and computes the rest from
    its own input: the gates from its probabilities at those experts,
    the buffer ranks among the kept rows."""
    it = iter(decisions)

    def route(params, xt, cfg, cap):
        gate_idx, keep = next(it)
        check(gate_idx.shape[0] == xt.shape[0], "forced routing rows")
        probs = torch.softmax(xt.float() @ params["router"], dim=-1)
        vals = probs.gather(1, gate_idx)
        vals = vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9)
        expert = gate_idx.T.reshape(-1)
        ranks = torch.cumsum(F.one_hot(expert, cfg.num_experts)
                             * keep[:, None], dim=0) - 1
        pos = torch.where(keep, ranks.gather(1, expert[:, None])[:, 0], 0)
        return {"probs": probs, "gate_idx": gate_idx, "gate_vals": vals,
                "expert": expert, "pos": pos, "keep": keep,
                "aux": torch.zeros((), device=xt.device)}
    return route


def recount_drops(np, probs, k: int, cap: int) -> tuple:
    """numpy's top-k (ties to the lower expert) and its capacity drops
    from router probabilities [T, E]: choice-major ranks."""
    idx = np.argsort(-probs, axis=1, kind="stable")[:, :k]
    expert = idx.T.reshape(-1)
    ranks = np.cumsum(np.eye(probs.shape[1], dtype=np.int64)[expert],
                      axis=0)[np.arange(expert.size), expert] - 1
    return idx, int((ranks >= cap).sum())


def serve_model(torch, np, dev, cfg, params, prompt_lens, max_new,
                card: str) -> dict:
    """Phase 22 / 23 for one model: ``Engine(slots=4, prompt_buf=8192,
    cache_buf=8256)`` serves the requests with K6's launches counted
    (every prefill layer, all on the Hopper body); every emitted token
    within ``LM_EPS_ULPS`` bf16 ulps of the row's largest |logit| of the
    teacher-forced ``forward`` argmax. For MoE the engine's routing is
    recorded and the teacher-forced forward takes it (the experts and
    keep mask each token was served with: capacity depends on the batch
    a token was routed in, cap = 1 at a 4-slot decode step), and the
    capacity drops of one prefill equal a numpy recount. Then TTFT,
    decode ms/step, tokens/s, peak memory and the prefill's device ms by
    op (``torch.profiler``)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa_ops, \
        ref as fa_ref
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    from repro_torch.serving import engine as E
    from torch.autograd import DeviceType

    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in prompt_lens]
    eng = E.Engine(params, cfg, slots=4, prompt_buf=LM_PROMPT_BUF,
                   cache_buf=LM_CACHE_BUF)
    for p, n in zip(prompts, max_new):
        eng.submit(p, max_new=n)
    moe = cfg.moe is not None
    calls, undo = routing_recorder(eng, M, E) if moe else ([], lambda: None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa_ops.KERNEL.launches = 0
    t0 = time.perf_counter()
    try:
        done = eng.run()
        torch.cuda.synchronize()
    finally:
        undo()
    run_s = time.perf_counter() - t0
    launches = fa_ops.KERNEL.launches
    bodies = {"wgmma": fa_ops.WGMMA.launches, "fma": fa_ops.FMA.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_tokens = sum(len(r.out_tokens) for r in done)
    print(f"{cfg.name} serving run ({card}): {len(done)} requests, "
          f"{n_tokens} tokens in {run_s:.2f} s; flash_attention launches "
          f"{launches} (by body {bodies}); peak {peak:.2f} GiB")
    check(len(done) == len(prompts), f"{cfg.name}: not every request "
                                     "finished")
    check(launches == cfg.n_layers * len(prompts),
          f"{cfg.name}: flash_attention launched {launches} times, "
          f"expected {cfg.n_layers} per prefill")
    check(bodies["wgmma"] == launches,
          f"{cfg.name}: not every prefill attention took the Hopper body: "
          f"{bodies}")
    worst, drops = 0.0, {"prefill": [0, 0], "decode": [0, 0]}
    unforced = [0.0, 0, 0]          # worst margin, tokens over the gate, of
    route, capacity = M.route, M.capacity
    for r in sorted(done, key=lambda r: r.uid):
        out = np.asarray(r.out_tokens, np.int32)
        check(len(out) == r.max_new and bool(((out >= 0) & (
            out < cfg.padded_vocab)).all()), f"request {r.uid} tokens")
        seq = np.concatenate([r.prompt, out[:-1]])
        plen = len(r.prompt)
        if moe:
            served = served_routing(torch, calls, r.uid, plen, len(seq),
                                    cfg.moe.top_k)
            for gate_idx, keep in served:
                kept = keep.view(cfg.moe.top_k, -1)
                for part, cols in (("prefill", kept[:, :plen]),
                                   ("decode", kept[:, plen:])):
                    drops[part][0] += int((~cols).sum())
                    drops[part][1] += cols.numel()
            cap = max(int(torch.bincount(
                g.T.reshape(-1)[kp], minlength=cfg.moe.num_experts).max())
                for g, kp in served)
            M.route = forced_route(torch, F, served)
            M.capacity = lambda c, chunk, cap=cap: cap
        try:
            logits = T.forward(params, torch.from_numpy(seq).to(dev)[None],
                               cfg)[0, plen - 1:]
        finally:
            M.route, M.capacity = route, capacity
        check(bool(logits.isfinite().all()), f"request {r.uid}: logits "
                                             "not finite")
        margin = argmax_margin(torch, fa_ref, logits, out)
        worst = max(worst, float(margin.max()))
        if moe:     # the same forward with its own routing: printed only
            free = argmax_margin(torch, fa_ref, T.forward(
                params, torch.from_numpy(seq).to(dev)[None], cfg)[
                    0, plen - 1:], out)
            unforced = [max(unforced[0], float(free.max())),
                        unforced[1] + int((free > LM_EPS_ULPS).sum()),
                        unforced[2] + free.numel()]
        check(bool((margin <= LM_EPS_ULPS).all()),
              f"{cfg.name} request {r.uid}: a token {float(margin.max())} "
              "bf16 ulps below the teacher-forced argmax")
        del logits
    del calls
    print(f"{cfg.name} teacher-forced check: every token within "
          f"{LM_EPS_ULPS} bf16 ulps of the argmax; worst margin "
          f"{worst:.3f} ulps" + (f"; real-token expert choices dropped "
                                 f"(dropped, of) {drops}; the forward "
                                 f"with its own routing: worst margin "
                                 f"{unforced[0]:.3f} ulps, {unforced[1]} "
                                 f"of {unforced[2]} tokens over the gate"
                                 if moe else ""))

    def prefill_of(p):
        toks = np.zeros((1, LM_PROMPT_BUF), np.int32)
        toks[0, :len(p)] = p
        one = T.init_cache(cfg, 1, LM_CACHE_BUF, device=dev)
        logits, one = E._prefill(
            params, torch.from_numpy(toks).to(dev), one,
            torch.tensor([len(p)], dtype=torch.int32, device=dev), cfg)
        return logits, one

    res = {}
    if moe:
        # one prefill's capacity drops against a numpy recount
        probs, counted = [], []

        def rec(*a):
            r = route(*a)
            probs.append(r["probs"])
            counted.append((r["gate_idx"], int((~r["keep"]).sum())))
            return r

        M.route = rec
        try:
            prefill_of(prompts[0])
        finally:
            M.route = route
        cap = M.capacity(cfg.moe, LM_PROMPT_BUF)
        per_layer = []
        for p, (gate_idx, n_drop) in zip(probs, counted):
            idx, want = recount_drops(np, p.cpu().numpy(), cfg.moe.top_k,
                                      cap)
            check(np.array_equal(idx, gate_idx.cpu().numpy()) and
                  n_drop == want, f"{cfg.name}: capacity drops {n_drop} != "
                                  f"numpy's {want}, or the experts differ")
            per_layer.append(n_drop)
        del probs, counted
        res["prefill_capacity_drops"] = dict(
            prompt=len(prompts[0]), cap=cap, per_layer=per_layer,
            of=cfg.moe.top_k * LM_PROMPT_BUF)
        res["served_real_token_drops"] = drops
        res["unforced_forward"] = dict(worst_margin_ulps=unforced[0],
                                       over_gate=unforced[1],
                                       tokens=unforced[2])
        print(f"{cfg.name}: capacity drops of the {len(prompts[0])}-token "
              f"prompt's prefill (cap {cap}) equal numpy's recount, per "
              f"layer {per_layer}")

    def first_token(p):
        logits, one = prefill_of(p)
        E._void_padding(one, [len(p)])
        E._splice(eng.cache, one, 0)
        return int(E.greedy(logits[:, len(p) - 1])[0])

    ttft = {len(p): time_ms(torch, lambda p=p: first_token(p))
            for p in (prompts[0], prompts[-1])}
    lengths = torch.tensor([n + m for n, m in zip(prompt_lens, max_new)][:4],
                           dtype=torch.int32, device=dev)
    last = torch.zeros(4, dtype=torch.int32, device=dev)

    def decode_step():
        logits, _ = E._decode(params, last, eng.cache, lengths, cfg)
        return E.greedy(logits).cpu()
    decode_ms = time_ms(torch, decode_step, reps=5)
    full = prompts[prompt_lens.index(LM_PROMPT_BUF)]
    prof = profiled(torch, lambda: prefill_of(full))
    ev = prof.key_averages()
    device = sum(e.self_device_time_total for e in ev
                 if e.device_type != DeviceType.CPU) / 1e3
    flash = sum(e.self_device_time_total for e in ev
                if e.device_type != DeviceType.CPU
                and "flash_wgmma_kernel" in e.key) / 1e3
    by_op = {e.key: getattr(e, "device_time_total", 0.0) / 1e3 for e in ev
             if e.device_type == DeviceType.CPU and e.key in PREFILL_OPS}
    res.update({
        "ttft_ms": ttft, "decode_ms_per_step_4_slots": decode_ms,
        "run_s": run_s, "tokens": n_tokens, "tokens_per_s": n_tokens / run_s,
        "flash_launches": launches, "flash_launches_by_body": bodies,
        "peak_gib": peak, "worst_margin_ulps": worst,
        "prefill_8192_device_ms": device, "prefill_flash_ms": flash,
        "prefill_device_ms_by_op": by_op,
        "prefill_top_device_ops": top_device_ops(
            [e for e in ev if e.device_type != DeviceType.CPU
             and e.self_device_time_total > 0], 1),
        "card": card})
    print(f"{cfg.name} serving ({card}): {res}")
    del eng
    return res


def mla_moe_phases(torch, np, dev, rows: dict, card: str) -> dict:
    """Phases 22-23: minicpm3-4b at full width and depth, then
    phi3.5-moe and grok-1 at full width with their depth cut
    (``MOE_DEPTH``), one model on the card at a time. Adds each model's
    K6 row to the ``flash_attention`` row's ``also``."""
    import dataclasses
    import gc

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T

    out = {}
    plan = [("minicpm3-4b", None, LM_PROMPTS, LM_MAX_NEW)] + [
        (arch, n, MOE_PROMPTS, MOE_MAX_NEW) for arch, n in MOE_DEPTH.items()]
    for phase, (arch, depth, prompts, max_new) in zip((22, 23, 23), plan):
        t0 = time.perf_counter()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 2**30
        cfg = get_arch(arch).make_config()
        if depth is not None:
            cfg = dataclasses.replace(cfg, n_layers=depth)
        params = random_lm(torch, T, cfg, dev)
        torch.cuda.synchronize()
        print(f"phase {phase}: {arch}, {cfg.n_layers} layers, "
              f"{T.param_count(cfg)} parameters "
              f"({T.param_count(cfg) * 2 / 1e9:.2f} GB bf16), init "
              f"{time.perf_counter() - t0:.1f} s; "
              f"{held:.2f} GiB held before")
        row = k6_at_model_shape(torch, np, dev, cfg, params, card)
        res = serve_model(torch, np, dev, cfg, params, list(prompts),
                          list(max_new), card)
        row["launches"] = res["flash_launches"]
        rows["flash_attention"]["also"].append(row)
        res["layers"] = cfg.n_layers
        res["phase_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        res["phase_s"] = time.perf_counter() - t0
        print(f"phase {phase} {arch}: {res['phase_s']:.1f} s, peak "
              f"{res['phase_peak_gib']:.2f} GiB")
        out[arch] = res
        del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


# DCN-v2 training (phase 24): the train_batch cell at full width, six
# steps from recsys.init (seed 0) on recsys_batch(1, i, ...), and the
# restart run with its failure and checkpoints
TRAIN_STEPS = 6
TRAIN_FAIL_AT = 4                  # the state's step when the failure hits
TRAIN_CKPT_EVERY = 3


@contextlib.contextmanager
def deterministic(torch):
    """torch's deterministic algorithms on (``index_add_`` on the card
    then sorts its ids and adds each row's terms in order)."""
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before)


def train_phases(torch, np, dev, rows: dict, card: str) -> dict:
    """Phase 24: DCN-v2's ``train_batch`` cell at full width. Adds a
    ``train`` entry to the ``embedding_bag``, ``segment_reduce`` and
    ``segment_reduce_atomic`` rows; returns the step's times."""
    import gc
    import io
    import shutil
    import tempfile

    import torch.nn.functional as F

    from repro_torch.configs import dcn_v2
    from repro_torch.data.pipeline import recsys_batch
    from repro_torch.kernels import autograd
    from repro_torch.kernels.embedding_bag import ops as eb_ops, \
        ref as eb_ref
    from repro_torch.kernels.flash_attention.ref import ulp_bf16
    from repro_torch.kernels.segment_reduce import ops as sr_ops, \
        ref as sr_ref
    from repro_torch.launch import steps
    from repro_torch.launch import train as launch_train
    from repro_torch.models import recsys
    from repro_torch.train import checkpoint
    from repro_torch.train.fault_tolerance import (SimulatedFailure,
                                                   run_with_restarts)
    from repro_torch.train.optimizer import named

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = dcn_v2.make_config()
    b = dcn_v2.SHAPE_DEFS["train_batch"]["batch"]
    v_rows, dim = cfg.total_rows, cfg.embed_dim
    cell = steps.build_cell("dcn-v2", "train_batch", device=dev)

    def fresh():
        return cell.init_state(recsys.init(
            cfg, generator=torch.Generator(dev).manual_seed(0), device=dev,
            requires_grad=True))

    def leaves(state):
        params = named(state["params"])
        return {**{f"params.{n}": p for n, p in params.items()},
                **{f"{k}.{n}": t for k, sub in state["opt"].items()
                   for n, t in sub.items()}, "step": state["step"]}

    def equal_states(a, c) -> bool:
        la, lc = leaves(a), leaves(c)
        return la.keys() == lc.keys() and all(
            la[n].dtype == lc[n].dtype and torch.equal(la[n], lc[n])
            for n in la)

    host = [recsys_batch(1, i, b, cfg.n_dense, cfg.table_sizes)
            for i in range(TRAIN_STEPS)]
    state = fresh()
    torch.cuda.synchronize()
    print(f"phase 24: dcn-v2 train_batch ({card}): B={b}, "
          f"{recsys.param_count(cfg)} parameters in {cfg.dtype}, AdamW lr "
          f"1e-3; init and {TRAIN_STEPS} host batches "
          f"{time.perf_counter() - t_phase:.1f} s")

    # -- 24a. one K5-forward / K4-backward pass against the plain route ---
    model = state["params"]
    params = named(model)
    tower = [n for n in params if n != "table"]
    bd = {k: torch.from_numpy(v).to(dev) for k, v in host[0].items()}
    flat = (bd["sparse_idx"] + model.row_offsets).reshape(-1, 1).contiguous()
    ids = flat[:, 0]
    n_look = ids.shape[0]
    eb_ops.KERNEL.launches = sr_ops.KERNEL.launches = 0
    loss_k = recsys.loss_fn(model, bd)
    grads = dict(zip(params, torch.autograd.grad(loss_k,
                                                 list(params.values()))))
    torch.cuda.synchronize()
    pass_launches = {"embedding_bag": eb_ops.KERNEL.launches,
                     "sorted": sr_ops.SORTED.launches,
                     "atomic": sr_ops.ATOMIC.launches}
    check(pass_launches == {"embedding_bag": 2, "sorted": 1, "atomic": 0},
          f"one train pass launched {pass_launches}, expected K5 twice "
          "(the lookup, the gather of the gradient rows) and K4's sorted "
          "body once")
    # the plain route: the plain lookup and the same tower; the table's
    # gradient an index_add_ of the lookup's gradient rows into fp32, then
    # the cast (deterministic: each row's terms added in order)
    table = model.table.detach()
    emb = eb_ref.ref_embedding_bag(table, flat).requires_grad_(True)
    dense = bd["dense"].to(cfg.dtype) * model.dense_norm["w"] \
        + model.dense_norm["b"]
    x0 = torch.cat([dense, emb.reshape(b, -1)], dim=-1)
    loss_p = recsys.bce_loss(recsys.tower(model, x0), bd["label"])
    g = torch.autograd.grad(loss_p, [emb] + [params[n] for n in tower])
    g_emb = g[0].contiguous()
    with deterministic(torch):
        table_plain = sr_ref.ref_segment_reduce(g_emb, ids, v_rows)
    table_nondet = sr_ref.ref_segment_reduce(g_emb, ids, v_rows)
    table_atomic = sr_ops.segment_reduce(g_emb, ids, v_rows)
    torch.cuda.synchronize()
    check(torch.equal(loss_k, loss_p), "the kernel route's loss differs "
                                       "from the plain route's")
    for n, gp in zip(tower, g[1:]):
        check(torch.equal(grads[n], gp), f"the gradient of {n} differs "
                                         "between the two routes")
    check(torch.equal(grads["table"], table_plain),
          "the table's gradient on K4's sorted body is not bit-equal to the "
          "plain route's (deterministic index_add_ into fp32, then the cast)")
    again = autograd.table_grad(g_emb, flat, v_rows)
    torch.cuda.synchronize()
    check(torch.equal(again, grads["table"]),
          "two calls of the sorted route give other table gradients")

    def ulps(x):
        return float(((x.float() - table_plain.float()).abs()
                      / ulp_bf16(table_plain)).max())
    atomic_ulps, nondet_ulps = ulps(table_atomic), ulps(table_nondet)
    check(atomic_ulps <= 1.0, f"K4's atomic body is {atomic_ulps} ulp from "
                              "the plain table gradient")
    counts = torch.bincount(ids.long(), minlength=v_rows)
    hot = int(counts.max())
    touched = int((counts > 0).sum())
    print(f"gradient parity ({card}): loss and the {len(tower)} tower "
          "gradients equal; the table gradient on K4's sorted body "
          "bit-equal to the deterministic plain route, and call to call; "
          f"atomic body {atomic_ulps} ulp, default (atomic) index_add_ "
          f"{nondet_ulps} ulp; {n_look} lookups over {touched} rows, the "
          f"hottest row {hot} times")
    del table_atomic, table_nondet, again, grads, g, emb, x0, loss_k, loss_p

    # K5 and K4 at the train shape: the forward lookup, the backward's sum
    esize = table.element_size()
    with torch.no_grad():
        sorted_ids, order = torch.sort(ids, stable=True)
        src = order.to(torch.int32)[:, None].contiguous()
        rows_sorted = eb_ops.embedding_bag(g_emb, src)
        fwd_got = eb_ops.embedding_bag(table, flat)
        fwd_want = eb_ref.ref_embedding_bag(table, flat)
        torch.cuda.synchronize()
        check(torch.equal(fwd_got, fwd_want), "K5 at the train shape differs "
                                              "from the gather")
        ids64 = ids.long()
        k5_bound, k5_by = bound(n_look * (4 + dim * esize)
                                + n_look * dim * esize, n_look * dim)
        k4_bound, k4_by = bound(n_look * dim * esize + 4 * n_look
                                + v_rows * dim * esize, n_look * dim)

        def index_add_fp32():
            return torch.zeros((v_rows, dim), dtype=torch.float32,
                               device=dev).index_add_(
                0, ids64, g_emb.float()).to(g_emb.dtype)

        def index_add_fp32_det():
            with deterministic(torch):
                return index_add_fp32()

        shape = (f"train_batch: {n_look} lookups (B={b} x 26, bags of 1) "
                 f"into {v_rows} x {dim} {table.dtype}")
        k5 = dict(shape=shape + " forward", max_abs_err=float_err(
            fwd_got, fwd_want),
            **k5_times(torch, F, eb_ops, eb_ref, table, flat, "sum"),
            bound_ms=k5_bound, bound_by=k5_by)
        # the backward's gather: the lookup's gradient rows (a [n_look,
        # dim] table read whole, once) in sorted-id order
        gather_bound, _ = bound(n_look * (4 + dim * esize)
                                + n_look * dim * esize, n_look * dim)
        k5["gather"] = dict(
            shape=f"train_batch backward gather: {n_look} gradient rows of "
                  f"{dim} {g_emb.dtype} in sorted-id order",
            max_abs_err=float_err(rows_sorted, g_emb[order]),
            **k5_times(torch, F, eb_ops, eb_ref, g_emb, src, "sum"),
            bound_ms=gather_bound, bound_by="bytes")
        check(torch.equal(rows_sorted, g_emb[order]),
              "K5's gather of the gradient rows differs from plain")
        k4_common = dict(
            plain_ms=time_ms(torch, lambda: sr_ref.ref_segment_reduce(
                g_emb, ids, v_rows)),
            library_ms=time_ms(torch, index_add_fp32),
            library="index_add_ of the fp32 rows on fp32 zeros, then the "
                    "cast (torch's default, atomic)",
            library_deterministic_ms=time_ms(torch, index_add_fp32_det),
            bound_ms=k4_bound, bound_by=k4_by, hottest_row=hot,
            rows_touched=touched)
        k4 = dict(shape=shape + " backward, sorted ids", max_abs_err=0.0,
                  ms=time_ms(torch, lambda: sr_ops.segment_reduce(
                      rows_sorted, sorted_ids, v_rows,
                      indices_are_sorted=True)),
                  sort_ms=time_ms(torch, lambda: torch.sort(ids,
                                                            stable=True)),
                  route_ms=time_ms(torch, lambda: autograd.table_grad(
                      g_emb, flat, v_rows)), **k4_common)
        k4_atomic = dict(shape=shape + " backward, the atomic body",
                         max_ulp=atomic_ulps,
                         ms=time_ms(torch, lambda: sr_ops.segment_reduce(
                             g_emb, ids, v_rows)), **k4_common)
    print(f"K5 forward at the train shape ({card}): {k5}")
    print(f"K4 sorted body at the train shape ({card}): {k4}")
    print(f"K4 atomic body at the train shape ({card}): {k4_atomic}")
    del rows_sorted, fwd_got, fwd_want, table_plain, g_emb, src, order

    # -- 24b. six train steps on the main path, counts set to 0 just before
    torch.cuda.synchronize()
    pass_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    eb_ops.KERNEL.launches = sr_ops.KERNEL.launches = 0
    t0 = time.perf_counter()
    metrics = [cell.step(state, batch)[1] for batch in host]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"embedding_bag": eb_ops.KERNEL.launches,
                "sorted": sr_ops.SORTED.launches,
                "atomic": sr_ops.ATOMIC.launches}
    steps_peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    for i, (lo, gn) in enumerate(zip(losses, norms)):
        print(f"train step {i + 1}: loss {lo:.6f} grad_norm {gn:.6f}")
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          "a train step's loss or grad norm is not finite")
    check(losses[-1] < losses[0], f"the loss did not fall over "
                                  f"{TRAIN_STEPS} steps: {losses}")
    check(launches == {"embedding_bag": 2 * TRAIN_STEPS,
                       "sorted": TRAIN_STEPS, "atomic": 0},
          f"the train steps launched {launches}")
    check(int(state["step"]) == TRAIN_STEPS, "the state's step")
    print(f"train path ({TRAIN_STEPS} steps, {wall:.2f} s with the first "
          f"call): launches {launches}; peak {steps_peak:.2f} GiB (the "
          f"gradient-parity pass before it {pass_peak:.2f} GiB)")
    clean = state

    # -- 24c. the restart run, then one save and one restore --------------
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="ck_phase24_", dir=build)
    try:
        tripped = {"done": False}

        def step_fn(s, batch):
            if int(s["step"]) == TRAIN_FAIL_AT and not tripped["done"]:
                tripped["done"] = True
                raise SimulatedFailure(f"injected at step {TRAIN_FAIL_AT}")
            return cell.step(s, batch)

        t0 = time.perf_counter()
        report = run_with_restarts(
            init_state_fn=fresh, step_fn=step_fn,
            stream_fn=lambda start: iter(host[start:]),
            total_steps=TRAIN_STEPS, ckpt_dir=tmp,
            ckpt_every=TRAIN_CKPT_EVERY, keep=1)
        torch.cuda.synchronize()
        restart_s = time.perf_counter() - t0
        check(report.restarts == 1 and report.steps_run == TRAIN_STEPS
              + TRAIN_FAIL_AT - TRAIN_CKPT_EVERY,
              f"restart run: {report.restarts} restarts, "
              f"{report.steps_run} steps")
        check(equal_states(report.final_state, clean),
              "the restarted run's params, m, v or step differ from the "
              "uninterrupted run's")
        check(sorted(os.listdir(tmp)) == [f"step_{TRAIN_STEPS:08d}"],
              f"retention kept {sorted(os.listdir(tmp))}")
        del report
        t0 = time.perf_counter()
        path = checkpoint.save(tmp, clean, TRAIN_STEPS + 1, keep=1)
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(os.path.join(path, "arrays.npz"))
        like = fresh()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checkpoint.restore(tmp, like)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check(equal_states(like, clean), "a restored checkpoint differs "
                                         "from the saved state")
        del like
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"restart parity ({card}): {TRAIN_STEPS} steps with a failure at "
          f"step {TRAIN_FAIL_AT}, checkpoints every {TRAIN_CKPT_EVERY} "
          f"(keep 1): 1 restart, params, m, v and step bit-equal to the "
          f"uninterrupted run ({restart_s:.1f} s); checkpoint "
          f"{nbytes / 1e9:.3f} GB, save {save_s:.2f} s, restore "
          f"{restore_s:.2f} s")

    # -- 24d. step times, the device's split, memory -----------------------
    batch = host[0]
    step_ms = time_ms(torch, lambda: cell.step(clean, batch))
    from torch.autograd import DeviceType
    prof = profiled(torch, lambda: cell.step(clean, batch))
    ev = [e for e in prof.key_averages()
          if e.device_type != DeviceType.CPU and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in ev) / 1e3
    times = {
        "step_ms": step_ms,
        "samples_per_s": b / step_ms * 1e3,
        "device_ms_per_step": device_ms,
        "idle_share": 1 - device_ms / step_ms if ev else None,
        "top_device_ops": top_device_ops(ev, 1, n=12),
        "losses": losses, "grad_norms": norms,
        "steps_peak_gib": steps_peak, "parity_pass_peak_gib": pass_peak,
        "restart_run_s": restart_s, "checkpoint_gb": nbytes / 1e9,
        "save_s": save_s, "restore_s": restore_s,
    }
    print(f"train step ({card}): {step_ms:.3f} ms (CUDA events, median of 3 "
          f"after a warm-up, host batch in), {times['samples_per_s']:.0f} "
          f"samples/s; device {device_ms:.3f} ms, idle share "
          f"{times['idle_share']}; by op {times['top_device_ops']}")

    # -- 24e. the launcher, in-process on the card -------------------------
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = launch_train.main(["--arch", "dcn-v2", "--steps", "30",
                                "--fail-at", "15"])
    out = out.getvalue().strip()
    print(out)
    check(rc == 0 and " 1 restarts" in out and "on cuda" in out,
          f"the launcher returned {rc}: {out!r}")

    train_rows = {"embedding_bag": dict(k5, launches=launches[
        "embedding_bag"], launches_per_step=2),
        "segment_reduce": dict(k4, launches=launches["sorted"],
                               launches_per_step=1),
        "segment_reduce_atomic": dict(k4_atomic, launches=launches[
            "atomic"], launches_per_step=0)}
    for name, entry in train_rows.items():
        rows.setdefault(name, {"name": name})["train"] = entry
    del clean, state, model, params, host
    gc.collect()
    torch.cuda.empty_cache()
    times["phase_peak_gib"] = max(pass_peak,
                                  torch.cuda.max_memory_allocated() / 2**30)
    times["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 24: {times['phase_s']:.1f} s, peak "
          f"{times['phase_peak_gib']:.2f} GiB")
    return {"dcn-v2 train_batch": times}


# gemma2-2b training (phase 25): the train_4k cell at full width and
# depth on a cut global batch, four steps on one repeated batch
LM_TRAIN_BATCH = 8                 # sequences a step (the reference's: 256)
LM_TRAIN_STEPS = 4
LM_TRAIN_SEQ = 4096
# 25b's gate: the kernel route's gaps to the all-plain route may be at
# most this many times those of the rounding controls
LM_TRAIN_GATE_FACTOR = 4
LM_TRAIN_CONTROLS = ("blocked_256", "blocked_1024", "p_fp32")


def range_device_ms(prof, name: str) -> float:
    """The device ms of the kernels launched inside the profiler ranges
    called ``name`` (``record_function``), summed."""
    from torch.autograd import DeviceType
    return sum(e.device_time_total for e in prof.events()
               if e.name == name and e.device_type == DeviceType.CPU) / 1e3


def lm_train_phases(torch, np, dev, rows: dict, card: str) -> dict:
    """Phase 25: gemma2-2b's ``train_4k`` cell at full width and depth
    (the global batch cut to ``LM_TRAIN_BATCH`` sequences). Adds the
    training entry (``train``) to the ``flash_attention`` row; returns
    the step's numbers."""
    import gc
    import io

    from torch.autograd import DeviceType

    from repro_torch.configs import gemma2_2b
    from repro_torch.configs.lm_common import SHAPE_DEFS
    from repro_torch.data.pipeline import lm_batch
    from repro_torch.kernels import autograd
    from repro_torch.kernels.flash_attention import ops as fa_ops, \
        ref as fa_ref
    from repro_torch.launch import steps
    from repro_torch.launch import train as launch_train
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import global_norm, named

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = gemma2_2b.make_config()
    seq = SHAPE_DEFS["train_4k"]["seq"]
    check(seq == LM_TRAIN_SEQ, f"train_4k is {seq} tokens")
    accum = getattr(gemma2_2b, "ACCUM_STEPS", 4)
    cell = steps.build_cell("gemma2-2b", "train_4k", device=dev)
    params = T.init(cfg, generator=torch.Generator(dev).manual_seed(0),
                    device=dev, requires_grad=True)
    state = cell.init_state(params)
    host = [lm_batch(0, i, LM_TRAIN_BATCH, seq, cfg.vocab) for i in range(2)]
    torch.cuda.synchronize()
    n_params = T.param_count(cfg)
    print(f"phase 25: gemma2-2b train_4k ({card}): {n_params} parameters "
          f"in {cfg.dtype}, moments {state['opt']['m']['embed'].dtype}, "
          f"global batch {LM_TRAIN_BATCH} x {seq + 1} tokens (the cell's "
          f"spec: {SHAPE_DEFS['train_4k']['batch']}), {accum} microbatches "
          f"of {LM_TRAIN_BATCH // accum}, remat {cfg.remat}, AdamW lr 3e-4; "
          f"init {time.perf_counter() - t_phase:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB held")
    micro = {"tokens": torch.from_numpy(
        host[0]["tokens"][:LM_TRAIN_BATCH // accum]).to(dev)}

    # -- 25a. the autograd wrapper on the microbatch's layer-0/1 inputs ---
    captured = []
    wrapper = L.flash_attention
    check(wrapper is autograd.flash_attention, "the model's attention does "
          "not call the kernel's autograd entry")

    def capture(q, k, v, **kw):
        captured.append((q.detach(), k.detach(), v.detach(), kw))
        return wrapper(q, k, v, **kw)

    L.flash_attention = capture
    try:
        T.forward_hidden({**params, "layers": params["layers"][:2]},
                         micro["tokens"][:, :-1], cfg)
    finally:
        L.flash_attention = wrapper
    windows = [c[3]["window"] for c in captured]
    check(windows == [cfg.window, 0], f"the train forward's first two "
                                      f"attention calls had windows {windows}")
    fa = {}
    for name, (q, k, v, kw) in zip(("local", "global"), captured):
        cot = torch.randn(q.shape, generator=torch.Generator(dev).manual_seed(
            2), device=dev).to(q.dtype)
        q, k, v = (t.clone().requires_grad_(True) for t in (q, k, v))
        pos = torch.arange(q.shape[1], dtype=torch.int32, device=dev)
        bkw = dict(window=kw["window"], attn_softcap=kw["softcap"],
                   scale=kw["sm_scale"])
        pkw = dict(sm_scale=kw["sm_scale"], causal=True, window=kw["window"],
                   softcap=kw["softcap"])
        before = (fa_ops.WGMMA.launches, fa_ops.FMA.launches)
        out = autograd.flash_attention(q, k, v, **kw)
        got = torch.autograd.grad(out, (q, k, v), cot)
        torch.cuda.synchronize()
        check((fa_ops.WGMMA.launches, fa_ops.FMA.launches) == (
            before[0] + 1, before[1]), f"{name}: the wrapper's forward and "
            "backward launched the kernel other than once, on the Hopper body")

        def blocked():
            o = L.attention_blocked(q, k, v, q_positions=pos,
                                    k_positions=pos, **bkw)
            return o, torch.autograd.grad(o, (q, k, v), cot)
        plain_out, want = blocked()
        for t, a, b in zip("qkv", got, want):
            check(torch.equal(a, b), f"{name}: d{t} of the wrapper differs "
                  "from torch.autograd.grad of attention_blocked")
        ref = fa_ref.ref_flash_attention(q.detach(), k.detach(), v.detach(),
                                         **pkw)
        bound = fa_ref.p_rounding_bound(q.detach(), k.detach(), v.detach(),
                                        **pkw)
        res = attention_check(fa_ref, out.detach(), ref, f"train {name}",
                              bound, fa_ref.p_rounding_norm_bound(
                                  q.detach(), k.detach(), v.detach(), **pkw))
        torch.cuda.synchronize()
        b_ms, by = attention_bound(q, k, kw["window"])
        fwd_ms = time_ms(torch, lambda: fa_ops.flash_attention(
            q.detach(), k.detach(), v.detach(), **kw))
        pair_ms = time_ms(torch, lambda: torch.autograd.grad(
            autograd.flash_attention(q, k, v, **kw), (q, k, v), cot))
        # forward and backward need the forward's flops and 2.5 times them
        # (dS, dQ, dK, dV): the bound of the pair
        pair_bound = max(bound_ms(4 * q.numel() * q.element_size()
                                  + 4 * k.numel() * k.element_size()),
                         3.5 * attention_flops(q, kw["window"])
                         / BF16_OPS_PER_S * 1e3)
        # the library call: compiled flex_attention, forward and forward +
        # backward (its own backward kernels), on the same inputs
        lib_call, lib_out, lib_pair = flex_library(
            torch, q, k, v, kw["sm_scale"], kw["window"], kw["softcap"],
            cot=cot)
        lib = dict(
            library_ms=time_ms(torch, lib_call),
            library="flex_attention (torch.compile; tanh softcap score_mod, "
                    "causal / window block mask, enable_gqa) on [B, H, S, d] "
                    "copies; fwd_bwd through its own backward",
            library_max_err_over_gate=float(
                ((lib_out.float() - ref.float()).abs() / bound).max()))
        try:
            lib_grads = lib_pair()
            lib.update(
                library_fwd_bwd_ms=time_ms(torch, lib_pair),
                library_grad_rel_diff={
                    t: float((a.transpose(1, 2).float() - b.float()).norm()
                             / b.float().norm())
                    for t, a, b in zip("qkv", lib_grads, want)})
            del lib_grads
        except Exception as exc:       # a yardstick: its failure is shown
            lib.update(library_fwd_bwd_ms=None,
                       library_fwd_bwd_error=f"{type(exc).__name__}: "
                                             f"{str(exc)[:300]}")
        del lib_call, lib_out, lib_pair
        fa[name] = dict(
            shape=f"train {name}: q {tuple(q.shape)} k {tuple(k.shape)} "
                  f"bf16, window {kw['window']}, softcap {kw['softcap']}, "
                  f"layer {0 if kw['window'] else 1} of a gemma2-2b "
                  "train_4k microbatch",
            **res, ms=fwd_ms,
            plain_ms=time_ms(torch, lambda: fa_ref.ref_flash_attention(
                q.detach(), k.detach(), v.detach(), **pkw)),
            bound_ms=b_ms, bound_by=by, **lib,
            grads_bit_equal_to_blocked=True,
            fwd_bwd_ms=pair_ms, backward_ms=pair_ms - fwd_ms,
            plain_fwd_bwd_ms=time_ms(torch, blocked),
            fwd_bwd_bound_ms=pair_bound,
            tflops=attention_flops(q, kw["window"]) / fwd_ms / 1e9,
            share_of_bound=b_ms / fwd_ms, body="wgmma")
        print(f"flash_attention {fa[name]['shape']} ({card}): {fa[name]}")
        del out, got, want, plain_out, ref, bound, cot
    del captured

    print(f"phase 25a: {time.perf_counter() - t_phase:.1f} s")

    # -- 25b. one microbatch: the kernel route against the all-plain route -
    # (every attention ``attention_blocked``), held to F times the gaps
    # that the reference's own algorithm shows when only its rounding
    # moves (its block size 256 or 1024 for 512, or P kept in fp32), and
    # a kernel with a mask fault (a 1024-key window on every layer) shown
    # to break that gate
    leaves = named(params)
    names = list(leaves)

    def route(attend=None):
        """(loss, grads) of the microbatch with attention through
        ``attend`` in place of the flash entry (None: the kernel)."""
        L.flash_attention = attend or wrapper
        try:
            loss = T.loss_fn(params, micro, cfg)
            return float(loss), torch.autograd.grad(loss,
                                                    list(leaves.values()))
        finally:
            L.flash_attention = wrapper

    def blocked_route(block_k: int = 512, p_fp32: bool = False):
        def attend(q, k, v, *, sm_scale, causal, window, softcap):
            pos = torch.arange(q.shape[1], dtype=torch.int32,
                               device=q.device)
            return L.attention_blocked(
                q, k, v.float() if p_fp32 else v, q_positions=pos,
                k_positions=pos, window=window, attn_softcap=softcap,
                scale=sm_scale, block_k=block_k)
        return attend

    def k6_with(**change):
        return lambda q, k, v, **kw: wrapper(q, k, v, **{**kw, **change})

    fa_ops.KERNEL.launches = 0
    loss_p, g_p = route(blocked_route())
    torch.cuda.synchronize()
    check(fa_ops.KERNEL.launches == 0, "the all-plain route launched K6")
    norm_p = float(global_norm(dict(zip(names, g_p))))
    leaf_norms = [float(b.float().norm()) for b in g_p]

    def gaps(loss, grads) -> dict:
        diff = [float((a.float() - b.float()).norm())
                for a, b in zip(grads, g_p)]
        rel = {n: d / r for n, d, r in zip(names, diff, leaf_norms) if r}
        worst = max(rel, key=rel.get)
        norm = float(global_norm(dict(zip(names, grads))))
        return dict(loss=loss, loss_gap=abs(loss - loss_p), grad_norm=norm,
                    grad_norm_gap=abs(norm - norm_p),
                    grad_rel_diff=float(np.sqrt(sum(d * d for d in diff)))
                    / norm_p, worst_leaf=worst,
                    worst_leaf_rel_diff=rel[worst])

    routes = {"k6": None, "blocked_256": blocked_route(256),
              "blocked_1024": blocked_route(1024),
              "p_fp32": blocked_route(p_fp32=True),
              "k6_window_1024": k6_with(window=LM_TRAIN_SEQ // 4),
              "k6_no_softcap": k6_with(softcap=0.0)}
    read = {}
    for name, attend in routes.items():
        loss, grads = route(attend)
        read[name] = gaps(loss, grads)
        del grads
    torch.cuda.synchronize()
    # the gradient's gaps (norms over millions of terms) against the
    # controls' widest; the loss, one scalar, against the spread of the
    # four rounding variants (the all-plain route and the controls); the
    # grad norm within the whole gradient's gate, as |‖a‖ - ‖b‖| <=
    # ‖a - b‖ (the norm of a difference is steady, the difference of two
    # norms is not)
    stats = ("loss_gap", "grad_norm_gap", "grad_rel_diff",
             "worst_leaf_rel_diff")
    gate = {x: LM_TRAIN_GATE_FACTOR * max(read[c][x] for c in
                                          LM_TRAIN_CONTROLS)
            for x in stats[2:]}
    variants = [loss_p] + [read[c]["loss"] for c in LM_TRAIN_CONTROLS]
    gate["loss_gap"] = LM_TRAIN_GATE_FACTOR * (max(variants) - min(variants))
    gate["grad_norm_gap"] = gate["grad_rel_diff"] * norm_p
    parity = dict(loss_plain=loss_p, grad_norm_plain=norm_p, gate=gate,
                  **read)
    for name, r in read.items():
        print(f"microbatch parity {name} ({card}): {r}; over the gate "
              f"{ {x: r[x] / gate[x] for x in stats} }")
    check(np.isfinite(read["k6"]["loss"])
          and np.isfinite(read["k6"]["grad_norm"]),
          "the kernel route's loss or grad norm is not finite")
    over = [x for x in stats if read["k6"][x] > gate[x]]
    check(not over, f"the kernel route is beyond {LM_TRAIN_GATE_FACTOR} "
          f"times the rounding controls' gaps in {over}: {parity}")
    caught = [x for x in stats if read["k6_window_1024"][x] > gate[x]]
    check(bool(caught), "the gate does not catch a kernel whose window is "
          f"1024 keys: {read['k6_window_1024']} against {gate}")
    parity["mask_fault_caught_by"] = caught
    parity["no_softcap_caught_by"] = [
        x for x in stats if read["k6_no_softcap"][x] > gate[x]]
    del g_p
    gc.collect()
    torch.cuda.empty_cache()

    print(f"phase 25b: {time.perf_counter() - t_phase:.1f} s")

    # -- 25c. four steps on one repeated batch, counts set to 0 just before
    batch = host[0]
    parity_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    fa_ops.KERNEL.launches = 0
    metrics, step_s = [], []
    for _ in range(LM_TRAIN_STEPS):
        t0 = time.perf_counter()
        metrics.append(cell.step(state, batch)[1])
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    launches = {"wgmma": fa_ops.WGMMA.launches, "fma": fa_ops.FMA.launches}
    steps_peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    for i, (lo, gn) in enumerate(zip(losses, norms)):
        print(f"lm train step {i + 1}: loss {lo:.6f} grad_norm {gn:.6f} "
              f"({step_s[i] * 1e3:.1f} ms)")
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          "an LM train step's loss or grad norm is not finite")
    check(losses[-1] < losses[0], f"the loss did not fall over "
                                  f"{LM_TRAIN_STEPS} steps: {losses}")
    per_step = 2 * cfg.n_layers * accum
    check(launches == {"wgmma": per_step * LM_TRAIN_STEPS, "fma": 0},
          f"the train steps launched {launches}, expected the Hopper body "
          f"{per_step} times a step (forward and remat recompute, "
          f"{cfg.n_layers} layers, {accum} microbatches)")
    check(int(state["step"]) == LM_TRAIN_STEPS, "the state's step")
    step_ms = statistics.median(step_s[1:]) * 1e3
    tokens = LM_TRAIN_BATCH * seq
    flops = T.model_flops_per_token(cfg) * tokens
    print(f"lm train path ({LM_TRAIN_STEPS} steps): K6 launches {launches} "
          f"({per_step} a step, all on the Hopper body); step "
          f"{step_ms:.1f} ms (median of steps 2-{LM_TRAIN_STEPS}, host clock "
          f"to a synchronize), peak {steps_peak:.2f} GiB")

    # -- 25d. where the device time goes -----------------------------------
    # A whole step is ~10^5 kernels and more ops, which the profiler takes
    # minutes to parse: profile one microbatch's forward and backward (a
    # step runs 4, then the accumulation and the update) and, alone, the
    # optimizer's update of the whole state on that microbatch's gradient.
    from repro_torch.train.optimizer import AdamWConfig, adamw
    t_prof = time.perf_counter()

    def microbatch():
        return torch.autograd.grad(T.loss_fn(params, micro, cfg),
                                   list(leaves.values()))
    mb_ms = time_ms(torch, microbatch, reps=2)
    prof = profiled(torch, microbatch)
    # the backward's range also comes back as a device-side span
    ev = [e for e in prof.key_averages()
          if e.device_type != DeviceType.CPU and e.self_device_time_total > 0
          and e.key != "flash_attention_backward"]
    mb_device = sum(e.self_device_time_total for e in ev) / 1e3

    def kernels_ms(*marks):
        return sum(e.self_device_time_total for e in ev
                   if any(m in e.key.lower() for m in marks)) / 1e3
    k6_ms = kernels_ms("flash_wgmma_kernel", "flash_kernel")
    gemm_ms = kernels_ms("gemm", "xmma", "cutlass", "nvjet")
    by_op = {"k6_forward": k6_ms,
             "attention_backward_blocked_recompute": range_device_ms(
                 prof, "flash_attention_backward"),
             "gemms_all": gemm_ms, "gemms_bf16": kernels_ms("nvjet"),
             "other": mb_device - k6_ms - gemm_ms}
    top = top_device_ops(ev, 1, n=12)
    grads = dict(zip(leaves, microbatch()))
    opt = adamw(AdamWConfig(lr=3e-4, decays=T.decays))
    opt_ms = time_ms(torch, lambda: opt.update(grads, state["opt"], leaves,
                                               state["step"]), reps=2)
    opt_device = device_ms(torch, lambda: opt.update(
        grads, state["opt"], leaves, state["step"]), reps=1)
    del grads, prof
    prof_s = time.perf_counter() - t_prof
    times = {
        "step_ms": step_ms, "step_s_each": step_s,
        "tokens_per_step": tokens, "tokens_per_s": tokens / step_ms * 1e3,
        "model_flops_per_token": T.model_flops_per_token(cfg),
        "model_tflops_per_s": flops / step_ms / 1e9,
        "bf16_peak_share": flops / step_ms / 1e9 / (BF16_OPS_PER_S / 1e12),
        "microbatch_ms": mb_ms, "microbatch_device_ms": mb_device,
        "idle_share": 1 - mb_device / mb_ms if ev else None,
        "microbatch_device_ms_by_op": by_op,
        "optimizer_ms": opt_ms, "optimizer_device_ms": opt_device,
        "step_rest_ms": step_ms - accum * mb_ms,
        "profile_s": prof_s, "microbatch_top_device_ops": top,
        "k6_launches_per_step": per_step, "losses": losses,
        "grad_norms": norms, "microbatch_parity": parity,
        "steps_peak_gib": steps_peak, "parity_peak_gib": parity_peak,
        "card": card}
    print(f"lm train step ({card}): {step_ms:.1f} ms, "
          f"{times['tokens_per_s']:.0f} tokens/s, "
          f"{times['model_tflops_per_s']:.1f} model TFLOP/s "
          f"({times['bf16_peak_share']:.4f} of the bf16 peak); a microbatch "
          f"{mb_ms:.1f} ms, device {mb_device:.1f} ms, idle share "
          f"{times['idle_share']}, by op {by_op}; the optimizer {opt_ms:.1f} "
          f"ms (device {opt_device}); the step beyond {accum} microbatches "
          f"{times['step_rest_ms']:.1f} ms; top {top}")

    # -- 25e. the launcher, in-process on the card -------------------------
    print(f"phase 25d: {time.perf_counter() - t_phase:.1f} s")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = launch_train.main(["--arch", "gemma2-2b", "--steps", "30",
                                "--fail-at", "15"])
    out = out.getvalue().strip()
    print(out)
    check(rc == 0 and " 1 restarts" in out and "on cuda" in out,
          f"the LM launcher returned {rc}: {out!r}")

    entry = dict(fa["global"], launches=launches["wgmma"] + launches["fma"],
                 launches_per_step=per_step, body="wgmma",
                 microbatch_k6_device_ms=k6_ms,
                 microbatch_backward_device_ms=by_op[
                     "attention_backward_blocked_recompute"],
                 also=[fa["local"]])
    row = rows.setdefault("flash_attention", dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:102",
        **{k: v for k, v in entry.items() if k != "also"}))
    row["train"] = entry
    del state, params, cell
    gc.collect()
    torch.cuda.empty_cache()
    times["phase_peak_gib"] = max(parity_peak, steps_peak)
    times["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 25: {times['phase_s']:.1f} s, peak "
          f"{times['phase_peak_gib']:.2f} GiB")
    return {"gemma2-2b train_4k": times}


# GNN training (phase 26): the four GNNs at full width, five cells
GNN_STEPS = 4
GNN_SEED = 26
# Reddit at its published size (``configs/gnn_common.py``): the synthetic
# graph the sampler draws ``minibatch_lg``'s blocks from
GNN_REDDIT_NODES = 232_965
GNN_REDDIT_EDGES = 114_615_892     # undirected; the CSR holds both ways
GNN_REDDIT_TRAIN = 153_431         # Reddit's train split (seeds drawn here)
# the kernel route's gaps to the all-plain route may be at most this many
# times the widest gap between two runs of the all-plain route, each on
# one of GNN_CLOUD orders of the edges (the first as given)
GNN_GATE_FACTOR = 4
GNN_CLOUD = 5
GNN_CELLS = (("graphsage-reddit", "minibatch_lg"), ("gin-tu", "molecule"),
             ("gatedgcn", "full_graph_sm"), ("gatedgcn", "minibatch_lg"),
             ("nequip", "molecule"))


def reddit_csr(np, seed: int, n: int, e: int):
    """A power-law graph of ``n`` nodes and ``e`` undirected edges as a
    ``CSR`` of 2e entries, built in place with no sort: degrees from a
    Pareto(1.2) law (clipped at 100x its floor), ``indptr`` their prefix
    sum, and each entry's neighbour drawn in proportion to degree (a
    uniform entry of the CSR names its row: the configuration model).
    Made in chunks of 2^24 entries."""
    from repro_torch.graphs.format import CSR
    rng = np.random.default_rng(seed)
    nnz = 2 * e
    w = np.minimum(rng.pareto(1.2, n) + 1.0, 100.0)
    deg = np.floor(w / w.sum() * nnz).astype(np.int64)
    deg[:nnz - int(deg.sum())] += 1
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    owner = np.repeat(np.arange(n, dtype=np.int32), deg)
    indices = np.empty(nnz, dtype=np.int32)
    step = 1 << 24
    for lo in range(0, nnz, step):
        hi = min(lo + step, nnz)
        indices[lo:hi] = owner[rng.integers(0, nnz, hi - lo)]
    del owner
    return CSR(indptr=indptr, indices=indices)


def sampled_batches(np, mb, feats, labels, d: dict, d_edge: int,
                    seed: int) -> tuple:
    """A sampler ``MiniBatch`` (global ids) as ``minibatch_lg``'s static
    batches: local rows with the seeds first, then the rest of layer 1's
    frontier, then the other input nodes, padded to ``n0`` rows; block i's
    edges padded to ``e_i`` with self-edges on the masked padding rows,
    one a row in turn (all on one row, a gather's backward adds them one
    by one: 738 of a GatedGCN step's 797 device ms).
    Returns (GraphSAGE's layered batch, the edge-union batch with
    ``edge_attr`` for GatedGCN, the rows used)."""
    n0, sizes = d["n0"], (d["e0"], d["e1"])
    seeds = mb.seed_nodes
    order = np.concatenate([
        seeds, np.setdiff1d(mb.blocks[1].src, seeds),
        np.setdiff1d(mb.input_nodes, np.union1d(mb.blocks[1].src, seeds))])
    used = order.shape[0]
    assert used == np.unique(order).shape[0] and used < n0
    local = np.full(int(order.max()) + 1, -1, dtype=np.int64)
    local[order] = np.arange(used)
    x = np.zeros((n0, feats.shape[1]), np.float32)
    x[:used] = feats[order]
    y = np.zeros(n0, np.int32)
    y[:used] = labels[order]
    mask = np.zeros(n0, np.float32)
    mask[:seeds.shape[0]] = 1.0
    layered = {"x": x, "y": y, "node_mask": mask}
    for i, (blk, size) in enumerate(zip(mb.blocks, sizes)):
        n = blk.src.shape[0]
        pad = used + np.arange(size - n) % (n0 - used)
        for k in ("src", "dst"):
            layered[f"{k}_{i}"] = np.concatenate(
                [local[getattr(blk, k)], pad]).astype(np.int32)
    union = {"x": x, "y": y, "node_mask": mask,
             "src": np.concatenate([layered["src_0"], layered["src_1"]]),
             "dst": np.concatenate([layered["dst_0"], layered["dst_1"]])}
    union["edge_attr"] = np.random.default_rng(seed).standard_normal(
        (union["src"].shape[0], d_edge), dtype=np.float32)
    return layered, union, used


def gnn_host_batch(np, arch: str, shape: str, cfg, d: dict, seed: int,
                   sampled: dict) -> dict:
    """The cell's host batch at its spec's shapes, from the port's
    pipeline generators (or the sampler's blocks for ``minibatch_lg``)."""
    from repro_torch.data.pipeline import graph_node_batch, \
        molecule_energy_batch
    if shape == "minibatch_lg":
        return sampled["layered" if arch == "graphsage-reddit" else "union"]
    if shape == "molecule":
        b = molecule_energy_batch(seed, 0, d["graphs"], d["nodes_per"],
                                  d["edges_per"],
                                  getattr(cfg, "n_species", d["d_feat"]))
        if arch == "nequip":
            return b
        rng = np.random.default_rng((seed, 1))
        return {"x": np.eye(d["d_feat"], dtype=np.float32)[b["species"]],
                "src": b["src"], "dst": b["dst"],
                "graph_ids": b["graph_ids"],
                "y": rng.integers(0, d["n_classes"], d["graphs"]).astype(
                    np.int32),
                "node_mask": np.ones(d["v"], np.float32)}
    b = graph_node_batch(seed, 0, d["v"], d["e_sym"] // 2, d["d_feat"],
                         d["n_classes"])
    b["edge_attr"] = np.random.default_rng((seed, 1)).standard_normal(
        (d["e_sym"], cfg.d_edge_in), dtype=np.float32)
    return b


def gnn_launches(arch: str, cfg, batch: dict) -> tuple:
    """(K4, K5) launches one train step makes, reckoned from the model.
    Every message sum is one K4 launch a forward; ``remat`` runs a
    layer's forward again in the backward (NequIP's layer and its edge
    chunks each: twice more). K5 is the backward of each sum whose input
    needs a gradient: not a first layer's sum over the input features
    (GraphSAGE, GIN), and not NequIP's last-layer sums into l > 0 (the
    readout takes only scalars)."""
    L = cfg.n_layers
    if arch == "graphsage-reddit":             # mean: sum and degree
        return 2 * L, L - 1
    if arch == "gin-tu":
        g = int(cfg.graph_level)              # the graph pooling
        return L + g, L - 1 + g
    if arch == "gatedgcn":                    # eta and eta * Vh
        return (4 if cfg.remat else 2) * L, 2 * L
    from repro_torch.models.gnn.nequip import coupling_paths
    paths = coupling_paths(cfg.l_max)
    e = batch["src"].shape[0]
    chunks = -(-e // min(cfg.edge_chunk, e))
    scalar = sum(1 for p in paths if p[2] == 0)
    return ((3 if cfg.remat else 1) * L * chunks * len(paths) + 1,
            ((L - 1) * len(paths) + scalar) * chunks + 1)


@contextlib.contextmanager
def plain_message_passing(torch):
    """K4 and K5 replaced by their plain versions (on the card, torch
    ops) where ``kernels.autograd`` calls them."""
    from repro_torch.kernels.embedding_bag import ops as eb_ops, \
        ref as eb_ref
    from repro_torch.kernels.segment_reduce import ops as sr_ops, \
        ref as sr_ref
    real = sr_ops.segment_reduce, eb_ops.embedding_bag
    sr_ops.segment_reduce = lambda data, ids, n, *, op="sum", \
        indices_are_sorted=False: sr_ref.ref_segment_reduce(data, ids, n, op)
    eb_ops.embedding_bag = lambda table, idx, *, combine="sum": \
        eb_ref.ref_embedding_bag(table, idx, combine)
    try:
        yield
    finally:
        sr_ops.segment_reduce, eb_ops.embedding_bag = real


def permuted_edges(np, torch, batch: dict, seed: int) -> dict:
    """The batch with every edge list (and ``edge_attr``, ``edge_mask``)
    permuted: the same sums in another order."""
    out = dict(batch)
    for suffix in ("", "_0", "_1"):
        if f"src{suffix}" not in batch:
            continue
        e = batch[f"src{suffix}"].shape[0]
        perm = torch.from_numpy(np.random.default_rng(seed).permutation(
            e)).to(batch[f"src{suffix}"].device)
        keys = (f"src{suffix}", f"dst{suffix}") + (
            ("edge_attr", "edge_mask") if not suffix else ())
        for k in keys:
            if k in batch:
                out[k] = batch[k][perm]
    return out


def dropped_in_edges(torch, batch: dict) -> tuple:
    """The batch without the edges into one node (of the nodes the loss
    reads, the first with the largest in-degree in the last edge list):
    the negative control."""
    suffix = "_1" if "src_1" in batch else ""
    dst = batch[f"dst{suffix}"]
    counts = torch.bincount(dst.long(), minlength=batch.get(
        "node_mask", dst).shape[0])
    if "node_mask" in batch:
        counts = counts * (batch["node_mask"] > 0)
    node = int(counts.argmax())
    keep = dst != node
    out = dict(batch)
    out[f"src{suffix}"] = batch[f"src{suffix}"][keep]
    out[f"dst{suffix}"] = dst[keep]
    if "edge_mask" in batch and not suffix:
        out["edge_mask"] = batch["edge_mask"][keep]
    if "edge_attr" in batch and not suffix:
        out["edge_attr"] = batch["edge_attr"][keep]
    return out, node, int((~keep).sum())


def gnn_phases(torch, np, dev, rows: dict, card: str) -> dict:
    """Phase 26: the GNN family's train cells at full width. Adds a
    ``gnn`` entry to the ``segment_reduce_atomic`` and ``embedding_bag``
    rows; returns each cell's numbers."""
    import gc
    import io

    from torch.autograd import DeviceType

    from repro_torch.configs import get_arch
    from repro_torch.configs.gnn_common import SHAPE_DEFS
    from repro_torch.graphs.sampler import sample_minibatch
    from repro_torch.kernels import autograd
    from repro_torch.kernels.embedding_bag import ops as eb_ops
    from repro_torch.kernels.segment_reduce import ops as sr_ops, \
        ref as sr_ref
    from repro_torch.launch import steps
    from repro_torch.launch import train as launch_train
    from repro_torch.models.gnn import model_of
    from repro_torch.models.gnn import nequip
    from repro_torch.train.optimizer import global_norm, named

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()

    # -- 26a. Reddit at full size, the sampler, minibatch_lg's batches -----
    d_lg = SHAPE_DEFS["minibatch_lg"]
    t0 = time.perf_counter()
    csr = reddit_csr(np, GNN_SEED, GNN_REDDIT_NODES, GNN_REDDIT_EDGES)
    csr_s = time.perf_counter() - t0
    rng = np.random.default_rng(GNN_SEED)
    feats = rng.standard_normal((GNN_REDDIT_NODES, d_lg["d_feat"]),
                                dtype=np.float32)
    labels = rng.integers(0, d_lg["n_classes"], GNN_REDDIT_NODES).astype(
        np.int32)
    seeds = rng.choice(GNN_REDDIT_TRAIN, d_lg["seeds"], replace=False)
    t0 = time.perf_counter()
    mb = sample_minibatch(csr, seeds, d_lg["fanouts"], rng)
    sample_s = time.perf_counter() - t0
    layered, union, used = sampled_batches(
        np, mb, feats, labels, d_lg, get_arch("gatedgcn").D_EDGE, GNN_SEED)
    deg = np.diff(csr.indptr)
    graph = dict(nodes=GNN_REDDIT_NODES, csr_entries=int(csr.indptr[-1]),
                 degree_max=int(deg.max()), degree_median=float(
                     np.median(deg)), build_s=csr_s, sample_s=sample_s,
                 rows_used=used, frontier_1=int(
                     np.union1d(mb.blocks[1].src, seeds).shape[0]),
                 blocks=[int(b.src.shape[0]) for b in mb.blocks])
    del csr, feats, labels, deg
    print(f"phase 26: reddit-scale graph ({card}): {graph}; "
          f"{time.perf_counter() - t_phase:.1f} s")
    sampled = {"layered": layered, "union": union}

    def loss_and_grads(M, params, batch, cfg):
        loss = M.loss_fn(params, batch, cfg)
        return float(loss.detach()), torch.autograd.grad(
            loss, list(named(params).values()))

    out, k4_entry, k5_entry = {}, None, None
    for arch, shape in GNN_CELLS:
        t_cell = time.perf_counter()
        name = f"{arch} {shape}"
        mod, M = get_arch(arch), model_of(arch)
        cfg = mod.make_config(shape)
        d = SHAPE_DEFS[shape]
        cell = steps.build_cell(arch, shape, device=dev)
        host = gnn_host_batch(np, arch, shape, cfg, d, GNN_SEED, sampled)
        spec = mod.input_specs(shape)["batch"]
        check({k: (tuple(v.shape), str(v.dtype)) for k, v in host.items()}
              == {k: (s, str(dt).removeprefix("torch.")) for k, (s, dt) in
                  spec.items()}, f"{name}: the batch is not the spec")
        batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        h2d_ms = time_ms(torch, lambda: {k: torch.from_numpy(v).to(dev)
                                         for k, v in host.items()}, reps=2)
        params = M.init(cfg, generator=torch.Generator(dev).manual_seed(0),
                        device=dev, requires_grad=True)
        leaves = named(params)
        names = list(leaves)
        per_step = gnn_launches(arch, cfg, host)

        # parity: the kernel route against the all-plain route. Each runs
        # on the batch and on GNN_CLOUD - 1 edge permutations of it (the
        # same sums in other fp32 orders). A ReLU unit whose input lies
        # within rounding of 0 flips its gradient term on some of those
        # runs and not on others (a discrete step: 3.1e-4 of GraphSAGE's
        # gradient at minibatch_lg on an H100), so the kernel runs are held to the
        # nearest plain run, and the gate is the factor times the widest
        # gap between two plain runs
        variants = [batch] + [permuted_edges(np, torch, batch, GNN_SEED + i)
                              for i in range(1, GNN_CLOUD)]
        eb_ops.KERNEL.launches = sr_ops.KERNEL.launches = 0
        with plain_message_passing(torch):
            plain = [loss_and_grads(M, params, b, cfg) for b in variants]
        torch.cuda.synchronize()
        check(eb_ops.KERNEL.launches == sr_ops.KERNEL.launches == 0,
              f"{name}: the all-plain route launched a kernel")
        kernel = [loss_and_grads(M, params, b, cfg) for b in variants]
        torch.cuda.synchronize()
        pass_launches = (sr_ops.ATOMIC.launches, eb_ops.KERNEL.launches)
        want = (GNN_CLOUD * per_step[0], GNN_CLOUD * per_step[1])
        check(pass_launches == want and sr_ops.SORTED.launches == 0,
              f"{name}: {GNN_CLOUD} passes launched K4 / K5 {pass_launches},"
              f" the model's count is {want}")
        dropped, node, n_drop = dropped_in_edges(torch, batch)
        fault = loss_and_grads(M, params, dropped, cfg)
        del dropped, variants
        stats = ("loss_gap", "grad_rel_diff", "worst_leaf_rel_diff")

        def gaps(run, ref) -> dict:
            diff = [float((a - b).norm()) for a, b in zip(run[1], ref[1])]
            rel = {n: x / float(b.norm()) for n, x, b in
                   zip(names, diff, ref[1]) if float(b.norm())}
            worst = max(rel, key=rel.get)
            return dict(loss_gap=abs(run[0] - ref[0]),
                        grad_rel_diff=float(np.sqrt(sum(x * x for x in diff)))
                        / float(global_norm(dict(zip(names, ref[1])))),
                        worst_leaf=worst, worst_leaf_rel_diff=rel[worst])

        def nearest(run) -> dict:
            each = [gaps(run, p) for p in plain]
            return {x: min(g[x] for g in each) for x in stats}
        within = [gaps(a, b) for i, a in enumerate(plain)
                  for b in plain[i + 1:]]
        gate = {x: GNN_GATE_FACTOR * max(g[x] for g in within) for x in stats}
        # a scalar can read no gap by chance: the loss's gate is at least
        # the factor times one fp32 ulp of the loss
        gate["loss_gap"] = max(gate["loss_gap"], GNN_GATE_FACTOR * float(
            np.spacing(np.float32(abs(plain[0][0])))))
        near = [nearest(k) for k in kernel]
        read = {"kernel": {x: min(r[x] for r in near) for x in stats},
                "kernel_first_vs_plain_first": gaps(kernel[0], plain[0]),
                "plain_widest": {x: max(g[x] for g in within)
                                 for x in stats},
                "kernel_dropped_in_edges": nearest(fault)}
        check(all(np.isfinite(k[0]) for k in kernel)
              and all(bool(torch.isfinite(g).all()) for k in kernel
                      for g in k[1]),
              f"{name}: a kernel-route loss or gradient is not finite")
        over = [x for x in stats if read["kernel"][x] > gate[x]]
        check(not over, f"{name}: the kernel route is beyond "
              f"{GNN_GATE_FACTOR} times the plain route's widest gap in "
              f"{over}: {read} against {gate}")
        caught = [x for x in stats
                  if read["kernel_dropped_in_edges"][x] > gate[x]]
        check(bool(caught), f"{name}: the gate does not catch the kernel "
              f"route without node {node}'s {n_drop} in-edges: "
              f"{read['kernel_dropped_in_edges']} against {gate}")
        parity = dict(loss_plain=plain[0][0], loss_kernel=kernel[0][0],
                      grad_norm_plain=float(global_norm(dict(
                          zip(names, plain[0][1])))),
                      runs=GNN_CLOUD, gate=gate, dropped_node=node,
                      dropped_edges=n_drop, dropped_caught_by=caught, **read)
        for k, r in read.items():
            print(f"{name} parity {k} ({card}): {r}; over the gate "
                  f"{ {x: r[x] / gate[x] if gate[x] else None for x in stats} }")
        del plain, kernel, fault

        if arch == "nequip":
            # forces; the energy under a random rotation, held to controls
            # that move only f32 rounding (every coordinate one ulp off,
            # the edges permuted). A self-loop edge (i, i) has r = 1e-9 > 0
            # and Y_2(0) = (0, 0, -c, 0, 0), a message that does not rotate
            # (the reference's model alike): the check masks those edges
            # through ``edge_mask``, and the unmasked gap is read beside it
            forces = nequip.forces(params, batch, cfg)
            masked = {**batch, "edge_mask": (batch["src"] != batch["dst"])
                      .to(torch.float32)}
            q, _ = np.linalg.qr(np.random.default_rng(GNN_SEED)
                                .standard_normal((3, 3)))
            if np.linalg.det(q) < 0:
                q[:, 0] *= -1
            rot = torch.from_numpy((host["positions"].astype(np.float64)
                                    @ q.T).astype(np.float32)).to(dev)

            def jittered(seed):
                sign = np.where(np.random.default_rng(seed).random(
                    host["positions"].shape) < 0.5, -1.0, 1.0)
                return masked["positions"] + torch.from_numpy((sign * np.spacing(
                    np.abs(host["positions"]))).astype(np.float32)).to(dev)
            with torch.no_grad():
                e0 = nequip.forward(params, masked, cfg)
                e_rot = nequip.forward(params, {**masked, "positions": rot},
                                       cfg)
                e_ctrl = [nequip.forward(params, permuted_edges(
                    np, torch, {**masked, "positions": jittered(s)}, s), cfg)
                    for s in (GNN_SEED + 3, GNN_SEED + 4)]
                e_all = nequip.forward(params, batch, cfg)
                e_all_rot = nequip.forward(params, {**batch, "positions": rot},
                                           cfg)
            torch.cuda.synchronize()
            rot_gap = float((e_rot - e0).abs().max())
            # the largest energy's ulp floors it: a gap of a few ulps of the
            # value is rounding whatever the controls read
            rot_gate = GNN_GATE_FACTOR * max(
                [float((e - e0).abs().max()) for e in e_ctrl]
                + [float(np.spacing(np.float32(float(e0.abs().max()))))])
            check(bool(torch.isfinite(forces).all()),
                  "nequip: the forces are not finite")
            check(rot_gap <= rot_gate, f"nequip: a rotation moves the "
                  f"energies by {rot_gap}, the gate (rounding controls) is "
                  f"{rot_gate}")
            parity.update(
                forces_finite=True, forces_abs_max=float(forces.abs().max()),
                rotation_energy_gap=rot_gap, rotation_gate=rot_gate,
                self_loops=int((batch["src"] == batch["dst"]).sum()),
                rotation_energy_gap_with_self_loops=float(
                    (e_all_rot - e_all).abs().max()),
                energy_abs_max=float(e0.abs().max()))
            print(f"nequip forces and rotation ({card}): |F| max "
                  f"{parity['forces_abs_max']:.6f}; a rotation moves the "
                  f"energies by {rot_gap:.3e} (gate {rot_gate:.3e}) with "
                  f"the {parity['self_loops']} self-loop edges masked, by "
                  f"{parity['rotation_energy_gap_with_self_loops']:.3e} "
                  "with them")
            del forces, e0, e_rot, e_ctrl, e_all, e_all_rot, masked

        # -- GNN_STEPS AdamW steps on one repeated batch --------------------
        state = cell.init_state(params)
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        sr_ops.KERNEL.launches = eb_ops.KERNEL.launches = 0
        metrics, step_s = [], []
        for _ in range(GNN_STEPS):
            t0 = time.perf_counter()
            metrics.append(cell.step(state, batch)[1])
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        launches = {"k4_atomic": sr_ops.ATOMIC.launches,
                    "k4_sorted": sr_ops.SORTED.launches,
                    "k5": eb_ops.KERNEL.launches}
        peak = torch.cuda.max_memory_allocated() / 2**30
        losses = [float(m["loss"]) for m in metrics]
        norms = [float(m["grad_norm"]) for m in metrics]
        check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
              f"{name}: a loss or grad norm is not finite: {losses} {norms}")
        check(losses[-1] < losses[0], f"{name}: the loss did not fall over "
                                      f"{GNN_STEPS} steps: {losses}")
        want = {"k4_atomic": GNN_STEPS * per_step[0], "k4_sorted": 0,
                "k5": GNN_STEPS * per_step[1]}
        check(launches == want, f"{name}: {GNN_STEPS} steps launched "
              f"{launches}, the model's count is {want}")
        check(int(state["step"]) == GNN_STEPS, f"{name}: the state's step")

        # -- time, the device's split, memory -------------------------------
        step_ms = time_ms(torch, lambda: cell.step(state, batch))
        prof = profiled(torch, lambda: cell.step(state, batch))
        ev = [e for e in prof.key_averages()
              if e.device_type != DeviceType.CPU
              and e.self_device_time_total > 0 and e.key != "optimizer"]
        dev_ms = sum(e.self_device_time_total for e in ev) / 1e3

        def kernels_ms(*marks):
            return sum(e.self_device_time_total for e in ev
                       if any(m in e.key for m in marks)) / 1e3
        by_op = {"k4": kernels_ms("::scatter_kernel", "::fill_kernel",
                                  "::cast_kernel"),
                 "k5": kernels_ms("embedding_bag_kernel"),
                 "gemms": kernels_ms("gemm", "Gemm", "xmma", "cutlass",
                                     "nvjet", "sm90_")}
        by_op["optimizer"] = range_device_ms(prof, "optimizer")
        by_op["rest"] = dev_ms - sum(by_op.values())
        del prof
        times = dict(
            step_ms=step_ms, step_s_each=step_s, h2d_ms=h2d_ms,
            device_ms_per_step=dev_ms,
            idle_share=1 - dev_ms / step_ms if ev else None,
            device_ms_by_op=by_op, top_device_ops=top_device_ops(ev, 1, n=8),
            k4_share=by_op["k4"] / dev_ms if ev else None,
            launches_per_step={"k4": per_step[0], "k5": per_step[1]},
            launches=launches,
            losses=losses, grad_norms=norms, peak_gib=peak,
            params=sum(p.numel() for p in leaves.values()),
            batch={k: list(v.shape) for k, v in host.items()},
            parity=parity, card=card)
        if shape == "minibatch_lg":
            times["graph"] = graph
        print(f"{name} ({card}): losses {losses}, step {step_ms:.3f} ms "
              f"(CUDA events, median of 3 after a warm-up, batch on the "
              f"card; its copy {h2d_ms:.3f} ms), device {dev_ms:.3f} ms, "
              f"idle share {times['idle_share']}, by op {by_op}, peak "
              f"{peak:.2f} GiB, launches a step {times['launches_per_step']}; "
              f"top {times['top_device_ops']}")

        # -- K4 and K5 at the largest call: GraphSAGE's layer 0 -------------
        if arch == "graphsage-reddit":
            with torch.no_grad():
                rows_in = batch["x"][batch["src_0"]].contiguous()
                ids = batch["dst_0"]
                n_seg = batch["x"].shape[0]
                got = sr_ops.segment_reduce(rows_in, ids, n_seg)
                want_k4 = sr_ref.ref_segment_reduce(rows_in, ids, n_seg)
                ids64 = ids.long()

                def index_add():
                    return torch.zeros((n_seg, rows_in.shape[1]),
                                       dtype=torch.float32,
                                       device=dev).index_add_(0, ids64,
                                                              rows_in)
                lib = index_add()
                torch.cuda.synchronize()
                err = float(((got - want_k4).abs() / (1 + want_k4.abs()))
                            .max())
                check(err <= 1e-5, f"K4 at the GNN shape is {err} from "
                                   "plain (gate 1e-5 (1 + |ref|))")
                n_e, dim = rows_in.shape
                k4_bound, k4_by = bound(4 * n_e * dim + 4 * n_e
                                        + 4 * n_seg * dim, n_e * dim)
                k4_entry = dict(
                    shape=f"GraphSAGE layer 0 at minibatch_lg: [{n_e}, {dim}]"
                          f" f32 rows into {n_seg} by unsorted dst_0",
                    body="segment_reduce", max_abs_err=float(
                        (got - want_k4).abs().max()), rel_err=err,
                    library_max_abs_err=float((lib - want_k4).abs().max()),
                    ms=time_ms(torch, lambda: sr_ops.segment_reduce(
                        rows_in, ids, n_seg)),
                    device_ms=device_ms(torch, lambda: sr_ops.segment_reduce(
                        rows_in, ids, n_seg)),
                    plain_ms=time_ms(torch, lambda: sr_ref.ref_segment_reduce(
                        rows_in, ids, n_seg)),
                    library_ms=time_ms(torch, index_add),
                    library_device_ms=device_ms(torch, index_add),
                    library="index_add_ of the f32 rows on f32 zeros",
                    bound_ms=k4_bound, bound_by=k4_by)
                del got, want_k4, lib
                # K5: the backward's gather_rows at the same shape
                g_out = torch.randn((n_seg, dim), device=dev,
                                    generator=torch.Generator(dev)
                                    .manual_seed(GNN_SEED))
                got = autograd.gather_rows(g_out, ids, n_seg)
                want_k5 = torch.index_select(g_out, 0, ids64)
                torch.cuda.synchronize()
                check(torch.equal(got, want_k5), "K5's gather_rows at the "
                      "GNN shape differs from index_select")
                k5_bound, k5_by = bound(4 * n_e * dim + 4 * n_e
                                        + 4 * n_e * dim, 0)
                idx2 = ids[:, None].contiguous()
                k5_entry = dict(
                    shape=f"gather_rows at minibatch_lg: [{n_seg}, {dim}] f32"
                          f" gradient rows by {n_e} ids (bags of 1)",
                    max_abs_err=0.0,
                    ms=time_ms(torch, lambda: eb_ops.embedding_bag(
                        g_out, idx2)),
                    device_ms=device_ms(torch, lambda: eb_ops.embedding_bag(
                        g_out, idx2)),
                    route_ms=time_ms(torch, lambda: autograd.gather_rows(
                        g_out, ids, n_seg)),
                    plain_ms=time_ms(torch, lambda: g_out[ids64]),
                    library_ms=time_ms(torch, lambda: torch.index_select(
                        g_out, 0, ids64)),
                    library_device_ms=device_ms(torch, lambda: torch.
                                                index_select(g_out, 0, ids64)),
                    library="torch.index_select (bit-equal)",
                    bound_ms=k5_bound, bound_by=k5_by)
                del got, want_k5, g_out, rows_in, idx2
            print(f"K4 at the GNN shape ({card}): {k4_entry}")
            print(f"K5 at the GNN shape ({card}): {k5_entry}")
        times["cell_s"] = time.perf_counter() - t_cell
        out[name] = times
        del state, params, leaves, batch, cell, metrics
        gc.collect()
        torch.cuda.empty_cache()
    del sampled, layered, union

    # -- 26c. the launcher, in-process on the card -------------------------
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = launch_train.main(["--arch", "gin-tu", "--steps", "30",
                                "--fail-at", "15"])
    text = buf.getvalue().strip()
    print(text)
    check(rc == 0 and " 1 restarts" in text and "on cuda" in text
          and "45 steps" in text, f"the GNN launcher returned {rc}: {text!r}")

    launches = {"k4": sum(c["launches"]["k4_atomic"] for c in out.values()),
                "k5": sum(c["launches"]["k5"] for c in out.values())}
    per_cell = {n: dict(c["launches_per_step"], k4_device_ms=c[
        "device_ms_by_op"]["k4"], k5_device_ms=c["device_ms_by_op"]["k5"],
        step_ms=c["step_ms"]) for n, c in out.items()}
    k4_row = dict(k4_entry, launches=launches["k4"], per_cell=per_cell)
    k5_row = dict(k5_entry, launches=launches["k5"], per_cell=per_cell)
    rows.setdefault("segment_reduce_atomic", dict(
        name="segment_reduce_atomic", route="cuda",
        source="src/repro_torch/kernels/csrc/segment_reduce.cu",
        replaces="src/repro/kernels/segment_reduce/segment_reduce.py:62",
        **{k: v for k, v in k4_row.items() if k != "per_cell"}))["gnn"] = \
        k4_row
    rows.setdefault("embedding_bag", dict(
        name="embedding_bag", route="cuda",
        source="src/repro_torch/kernels/csrc/embedding_bag.cu",
        replaces="src/repro/kernels/embedding_bag/embedding_bag.py:44",
        **{k: v for k, v in k5_row.items() if k != "per_cell"}))["gnn"] = \
        k5_row
    phase_s = time.perf_counter() - t_phase
    print(f"phase 26: {phase_s:.1f} s; K4 launches {launches['k4']}, K5 "
          f"{launches['k5']} over the cells' {GNN_STEPS}-step runs")
    out["phase_s"] = phase_s
    return {"gnn": out}


# phase 27: the dry-run, the cost model, the transfer pass and elastic
# rescale on the card
ANALYSIS_BUCKETS = ("small", "scale")
ANALYSIS_ENTRIES = ("service.tick.insert", "service.tick.delete",
                    "service.tick.delete_forest", "queries.same_component",
                    "queries.component_size", "queries.count_components",
                    "queries.component_histogram",
                    "queries.spanning_forest_stats")


def remat_band(rec: dict) -> tuple:
    """(lo, hi) of an LM train cell's ``useful_flop_ratio``, derived from
    remat: a token costs forward 2N + backward 4N + a recompute of at
    most 2N (``torch.utils.checkpoint`` stops recomputing a block once
    the tensors its backward needs are back, so 0 to 2N), where the
    model counts 6N. N is the parameters a token's matmuls reach: less
    an untied input embedding (a lookup), plus the expert rows capacity
    pads (E x capacity rows a chunk where top-k x chunk are used).
    Attention is counted apart: K6's launches and the backward's
    ``flash_attention_backward`` range, as counted."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.lm_common import SHAPE_DEFS
    from repro_torch.models import moe
    from repro_torch.models.transformer import model_flops_per_token

    mod = get_arch(rec["arch"])
    cfg = mod.make_config()
    d = SHAPE_DEFS[rec["shape"]]
    tokens = d["batch"] * d["seq"]
    n = model_flops_per_token(cfg) / 6
    if not cfg.tie_embed:
        n -= cfg.padded_vocab * cfg.d_model
    if cfg.moe is not None:
        micro = d["batch"] // getattr(mod, "ACCUM_STEPS", 4) * d["seq"]
        chunk = min(cfg.moe.dispatch_chunk, micro)
        n += cfg.n_layers * 3 * cfg.d_model * cfg.moe.d_ff_expert * (
            cfg.moe.num_experts * moe.capacity(cfg.moe, chunk) / chunk
            - cfg.moe.top_k)
    attn = sum(k["flops"] for k in rec["kernels"].values()) + \
        rec["ranges"].get("flash_attention_backward", {}).get("flops", 0.0)
    return (rec["model_flops"] / (8 * tokens * n + attn),
            rec["model_flops"] / (6 * tokens * n + attn))


def launch_analysis_phases(torch, np, dev, rows: dict, card: str) -> dict:
    """Phase 27: the dry-run of every cell, the cost model against the
    card, the transfer pass against the card's sync count, and an
    elastic rescale of a TrainState between the card and the CPU.
    Returns each part's numbers."""
    import gc
    import shutil
    import tempfile

    from repro_torch.analysis import transfers
    from repro_torch.analysis.entries import all_entries
    from repro_torch.analysis.graph_utils import trace
    from repro_torch.analysis.runner import BUCKETS
    from repro_torch.configs import all_cells, cc_graphs, dcn_v2, get_arch
    from repro_torch.configs.gnn_common import SHAPE_DEFS as GNN_SHAPES
    from repro_torch.data.pipeline import recsys_batch
    from repro_torch.kernels.embedding_bag import ops as eb_ops
    from repro_torch.kernels.segment_reduce import ops as sr_ops
    from repro_torch.launch import dryrun, elastic, steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import recsys
    from repro_torch.models.gnn import model_of
    from repro_torch.roofline.analysis import cost
    from repro_torch.train import checkpoint, train_state
    from repro_torch.train.optimizer import AdamWConfig, adamw, named

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    out = {}

    # -- 27a. the dry-run of every cell on meta ----------------------------
    jobs = max(1, min(8, (os.cpu_count() or 2) - 1))
    path = ROOT / "build" / "dryrun_phase27.jsonl"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.unlink(missing_ok=True)
    t0 = time.perf_counter()
    rc = dryrun.main(["--arch", "all", "--jobs", str(jobs), "--out",
                      str(path)])
    dry_s = time.perf_counter() - t0
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    want = [(a, s) for a, s, skip in all_cells() if skip is None] + \
        [("cc-adaptive", s) for s in cc_graphs.SHAPES]
    check(rc == 0 and [(r["arch"], r["shape"]) for r in recs] == want,
          f"the dry-run returned {rc} with {len(recs)} of {len(want)} "
          "records")
    lm = {}
    for r in recs:
        if r["kind"] != "train" or get_arch(r["arch"]).FAMILY != "lm":
            continue
        lo, hi = remat_band(r)
        ratio = r["roofline"]["useful_flop_ratio"]
        counted = r["roofline"]["hlo_gflops_per_chip"] * 1e9
        lm[r["arch"]] = {"counted_flops": counted,
                         "model_flops": r["model_flops"],
                         "useful_flop_ratio": ratio, "band": [lo, hi],
                         "meta_run_s": r["run_s"]}
        print(f"dry-run {r['arch']} train_4k: counted {counted:.4e} FLOPs, "
              f"model {r['model_flops']:.4e}, useful_flop_ratio {ratio} "
              f"(remat band {lo:.4f}-{hi:.4f}), meta run {r['run_s']} s "
              f"[{card}]")
        check(lo - 1e-4 <= ratio <= hi + 1e-4,
              f"{r['arch']}: useful_flop_ratio {ratio} outside the remat "
              f"band {lo:.4f}-{hi:.4f}")
    check(len(lm) == 5, f"{len(lm)} LM train cells dry-ran, not 5")
    print(f"27a: {len(recs)} cells dry-ran on meta in {dry_s:.1f} s "
          f"({jobs} processes); skipped "
          f"{[(a, s) for a, s, skip in all_cells() if skip]}")
    out["dryrun"] = {"cells": len(recs), "seconds": dry_s, "jobs": jobs,
                     "lm_train": lm}

    # -- 27b. the cost model's bound against the card ----------------------
    bounds = {}
    cfg = dcn_v2.make_config()
    model = recsys.init(cfg, generator=torch.Generator(dev).manual_seed(0),
                        device=dev)
    host = recsys_batch(1, 0, dcn_v2.SHAPE_DEFS["serve_bulk"]["batch"],
                        cfg.n_dense, cfg.table_sizes)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    cell = steps.build_cell("dcn-v2", "serve_bulk", device=dev)
    eb_ops.KERNEL.launches = 0
    _, c = cost(cell.step, model, batch)
    torch.cuda.synchronize()
    check(eb_ops.KERNEL.launches == c.kernels["embedding_bag"]["launches"]
          == 1, f"serve_bulk under the cost model: {eb_ops.KERNEL.launches} "
          f"K5 launches, {c.kernels} reported")
    bounds["dcn-v2/serve_bulk"] = (c, time_ms(torch, lambda: cell.step(
        model, batch)))
    del model, batch
    gc.collect()
    torch.cuda.empty_cache()

    arch, shape = "graphsage-reddit", "minibatch_lg"
    gcfg = get_arch(arch).make_config(shape)
    d = GNN_SHAPES[shape]
    rng = np.random.default_rng(GNN_SEED)
    n0, n1, seeds = d["n0"], d["n1"], d["seeds"]

    def ids(n, hi):
        return torch.from_numpy(rng.integers(0, hi, n).astype(np.int32)
                                ).to(dev)
    gbatch = {"x": torch.from_numpy(rng.standard_normal(
                  (n0, d["d_feat"]), dtype=np.float32)).to(dev),
              "y": ids(n0, d["n_classes"]),
              "node_mask": (torch.arange(n0, device=dev) < seeds).float(),
              "src_0": ids(d["e0"], n0), "dst_0": ids(d["e0"], n1),
              "src_1": ids(d["e1"], n1), "dst_1": ids(d["e1"], seeds)}
    gcell = steps.build_cell(arch, shape, device=dev)
    state = gcell.init_state(model_of(arch).init(
        gcfg, generator=torch.Generator(dev).manual_seed(0), device=dev,
        requires_grad=True))
    for k in (eb_ops.KERNEL, sr_ops.KERNEL):
        k.launches = 0
    _, c = cost(gcell.step, state, gbatch)
    torch.cuda.synchronize()
    check(c.kernels["segment_reduce"]["launches"] == sr_ops.ATOMIC.launches
          > 0 and c.kernels["embedding_bag"]["launches"]
          == eb_ops.KERNEL.launches > 0,
          f"{arch} under the cost model: {c.kernels} reported, K4 "
          f"{sr_ops.ATOMIC.launches}, K5 {eb_ops.KERNEL.launches} counted")
    bounds[f"{arch}/{shape}"] = (c, time_ms(torch, lambda: gcell.step(
        state, gbatch)))
    del state, gbatch
    out["cost_model"] = {}
    for name, (c, ms) in bounds.items():
        b = c.bound_ms()
        share = b / ms
        out["cost_model"][name] = {
            "bound_ms": b, "measured_ms": ms, "share": share,
            "gbytes": c.bytes / 1e9, "gflops": dict(
                (k, v / 1e9) for k, v in c.flops.items()),
            "ops": c.ops, "kernels": c.kernels}
        print(f"27b {name}: bound {b:.3f} ms (bytes {c.bytes / 1e9:.3f} GB, "
              f"FLOPs {c.flops}, {c.ops} ops) vs measured {ms:.3f} ms: "
              f"{share:.1%} of it [{card}]")
        check(b <= ms, f"{name}: the bound {b:.3f} ms exceeds the measured "
              f"{ms:.3f} ms")

    # -- 27c. the transfer pass against the card's synchronizing calls -----
    entries = {e.name: e for e in all_entries()}
    out["transfers"] = {}
    for name in ANALYSIS_ENTRIES:
        for bname in ANALYSIS_BUCKETS:
            syncs = []
            t = trace(entries[name], BUCKETS[bname], device=dev,
                      runner=lambda run: syncs.append(
                          count_syncs(torch, run)[1]))
            check(t.failure is None and len(syncs) == 1,
                  f"{name} at {bname} failed on the card: {t.failure}")
            points = transfers.sync_points(t)
            counted = sum(points.values())
            # each read's _local_scalar_dense counted once, not twice
            distinct = counted - sum(op.name == "_local_scalar_dense"
                                     for op in t.record.ops)
            out["transfers"][f"{name}@{bname}"] = dict(
                card_syncs=syncs[0], counted=counted, distinct=distinct,
                **points, ops=len(t.record.ops))
            print(f"27c {name} at {bname} {BUCKETS[bname]}: card syncs "
                  f"{syncs[0]}, the pass's {counted} ({points}; "
                  f"{distinct} distinct), {len(t.record.ops)} ops [{card}]")
            check(syncs[0] <= counted,
                  f"{name} at {bname}: the card made {syncs[0]} "
                  f"synchronizing calls, the pass counted {points}: it "
                  "missed a kind of sync")

    # -- 27d. elastic: a TrainState card -> CPU -> card, bit-equal ---------
    ecfg = get_arch("gin-tu").make_config("molecule")
    M = model_of("gin-tu")
    opt = adamw(AdamWConfig())
    card_state = train_state.create(M.init(
        ecfg, generator=torch.Generator(dev).manual_seed(0), device=dev,
        requires_grad=True), opt)
    g = torch.Generator(dev).manual_seed(27)
    with torch.no_grad():
        for t in [*named(card_state["params"]).values(),
                  *card_state["opt"]["m"].values(),
                  *card_state["opt"]["v"].values()]:
            t.copy_(torch.randn(t.shape, generator=g, device=dev))
        card_state["step"].fill_(27)

    def leaves(s):
        return {"step": s["step"], **{f"params.{n}": p.detach() for n, p
                                      in named(s["params"]).items()},
                **{f"{k}.{n}": t for k in ("m", "v")
                   for n, t in s["opt"][k].items()}}
    tmp = Path(tempfile.mkdtemp(dir=ROOT / "build"))
    try:
        checkpoint.save(str(tmp / "card"), card_state, 27)
        on_cpu = elastic.rescale(str(tmp / "card"), card_state,
                                 make_mesh(1, device="cpu"))
        checkpoint.save(str(tmp / "cpu"), on_cpu, 27)
        back = elastic.rescale(str(tmp / "cpu"), on_cpu,
                               make_mesh(1, device=dev))
    finally:
        shutil.rmtree(tmp)
    want = leaves(card_state)
    for label, s, where in (("cpu", on_cpu, "cpu"), ("card", back,
                                                      dev.type)):
        got = leaves(s)
        check(got.keys() == want.keys() and all(
            got[n].device.type == where and got[n].dtype == want[n].dtype
            and torch.equal(got[n].cpu(), want[n].cpu()) for n in want),
            f"elastic rescale onto the {label} is not bit-equal")
    n_bytes = sum(t.numel() * t.element_size() for t in want.values())
    print(f"27d gin-tu TrainState ({len(want)} leaves, {n_bytes} bytes): "
          "card -> CPU -> card, bit-equal both ways")
    out["elastic"] = {"leaves": len(want), "bytes": n_bytes}

    phase_s = time.perf_counter() - t_phase
    print(f"phase 27: {phase_s:.1f} s (dry-run {dry_s:.1f} s) [{card}]")
    out["phase_s"] = phase_s
    return {"launch_analysis": out}


def cc_phases(torch, np, dev, rows: dict, card: str) -> tuple:
    """Phases 2-5: the CC kernels against their plain versions, the main
    path at full scale, the parity constants, the solve times. Adds the
    K1-K3 rows to ``rows``; returns (the solve times, phase 3's graphs,
    their oracle labels)."""
    from repro_torch.core import cc, rounds
    from repro_torch.core.unionfind import connected_components_scipy
    from repro_torch.graphs.device import DeviceGraph
    from repro_torch.graphs.generators import table1_scaled
    from repro_torch.kernels.cc_fused import ops as cc_ops, ref as cc_ref
    from repro_torch.kernels.hook import ops as hook_ops, ref as hook_ref
    from repro_torch.kernels.multi_jump import ops as mj_ops, ref as mj_ref

    t0 = time.perf_counter()
    graphs = {name: DeviceGraph.from_host(
        table1_scaled(name, scale=SCALE, seed=1), device=dev)
        for name in FULL_SCALE}
    for name, g in graphs.items():
        print(f"graph {name}: |V|={g.num_nodes} |E|={g.true_edges} "
              f"s={g.plan.num_segments} seg={g.plan.segment_size}")
    print(f"generate: {time.perf_counter() - t0:.1f} s")

    # -- 2. kernels vs plain, at the path's shapes -------------------------
    scans = {}
    for name, g in graphs.items():
        segs = rounds.pad_and_segment(g.edges, g.plan)
        counts = rounds.segment_true_counts(g.true_edges, g.plan, device=dev)
        pi0 = torch.arange(g.num_nodes, dtype=torch.int32, device=dev)
        got_pi, got_sw = cc_ops.fused_segment_scan(pi0, segs, counts)
        want_pi, want_sw = cc_ref.ref_segment_scan(pi0, segs, counts)
        torch.cuda.synchronize()
        err = max(max_abs_err(got_pi, want_pi),
                  max_abs_err(got_sw, want_sw))
        check(err == 0, f"cc_fused differs from its plain version on {name}")
        sweeps = int(got_sw.sum())
        print(f"cc_fused {name}: pi and sweeps equal to plain "
              f"(summed sweeps {sweeps})")
        n_edges = segs.shape[0] * segs.shape[1]
        stream = 8 * n_edges + 8 * g.num_nodes * (sweeps + 1)
        sector = (8 + (2 + 2 * 2 + 1) * SECTOR) * n_edges \
            + (4 + SECTOR + 4) * g.num_nodes * sweeps
        scans[name] = (segs, counts, dict(
            shape=f"{name} scan: V={g.num_nodes}, "
                  f"S={segs.shape[0]}x{segs.shape[1]}, {sweeps} sweeps",
            max_abs_err=err,
            ms=time_ms(torch, lambda: cc_ops.fused_segment_scan(
                pi0, segs, counts)),
            fuel1_ms=time_ms(torch, lambda: cc_ops.fused_segment_scan(
                pi0, segs, counts, fuel=1)),
            plain_ms=time_ms(torch, lambda: cc_ref.ref_segment_scan(
                pi0, segs, counts)),
            bound_ms=bound_ms(stream), bound_sector_ms=bound_ms(sector)))
        print(f"cc_fused {name}: {scans[name][2]}")
        # K1's first cleanup launch at the path's shape: pi after the scan,
        # the whole edge list as one segment. Fuel 1 (the hook and one
        # sweep) beside the full fuel splits its time into hook and sweeps
        flat = segs.reshape(1, -1, 2)
        true1 = torch.tensor([g.true_edges], dtype=torch.int32, device=dev)
        got_c = cc_ops.fused_segment_scan(got_pi, flat, true1)
        want_c = cc_ref.ref_segment_scan(got_pi, flat, true1)
        torch.cuda.synchronize()
        err = max(max_abs_err(got_c[0], want_c[0]),
                  max_abs_err(got_c[1], want_c[1]))
        check(err == 0, f"cc_fused's cleanup launch differs from its plain "
                        f"version on {name}")
        sweeps = int(got_c[1].sum())
        n_edges = flat.shape[1]
        scans[name][2]["cleanup"] = dict(
            shape=f"{name} first cleanup launch: V={g.num_nodes}, "
                  f"E={n_edges}, pi after the scan, {sweeps} sweeps",
            max_abs_err=err,
            ms=time_ms(torch, lambda: cc_ops.fused_segment_scan(
                got_pi, flat, true1)),
            fuel1_ms=time_ms(torch, lambda: cc_ops.fused_segment_scan(
                got_pi, flat, true1, fuel=1)),
            bound_ms=bound_ms(8 * n_edges + 8 * g.num_nodes * (sweeps + 1)),
            bound_sector_ms=bound_ms((8 + 7 * SECTOR) * n_edges
                                     + (4 + SECTOR + 4) * g.num_nodes
                                     * sweeps))
        print(f"cc_fused {name} cleanup: {scans[name][2]['cleanup']}")
        del got_c, want_c
    rows["cc_fused"] = dict(
        name="cc_fused", route="cuda",
        source="src/repro_torch/kernels/csrc/cc_fused.cu",
        replaces="src/repro/kernels/cc_fused/cc_fused.py:122",
        equal=True, **scans["kron-logn21"][2], bound_by="bytes",
        library_ms=None, also=[scans["usa-osm"][2]])

    g = graphs["usa-osm"]
    segs = scans["usa-osm"][0]
    seg0 = segs[0]
    pi0 = torch.arange(g.num_nodes, dtype=torch.int32, device=dev)
    got = hook_ops.hook_edges_pallas(pi0, seg0, edge_tile=1024, lift_steps=2)
    want = hook_ref.ref_hook_tiled(pi0, seg0, 1024, 2)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    check(err == 0, "hook differs from its plain tiled version on usa-osm")
    print(f"hook usa-osm segment 0 ({seg0.shape[0]} edges, tile 1024): "
          "equal to plain")
    n_edges = seg0.shape[0]
    rows["hook"] = dict(
        name="hook", route="cuda",
        source="src/repro_torch/kernels/csrc/hook.cu",
        replaces="src/repro/kernels/hook/hook.py:53",
        shape=f"usa-osm segment 0: E={n_edges}, V={g.num_nodes}, tile 1024",
        equal=True, max_abs_err=err,
        ms=time_ms(torch, lambda: hook_ops.hook_edges_pallas(
            pi0, seg0, edge_tile=1024, lift_steps=2)),
        plain_ms=time_ms(torch, lambda: hook_ref.ref_hook_tiled(
            pi0, seg0, 1024, 2)),
        bound_ms=bound_ms(8 * n_edges + 8 * g.num_nodes), bound_by="bytes",
        bound_sector_ms=bound_ms((8 + 7 * SECTOR) * n_edges
                                 + 8 * g.num_nodes),
        library_ms=None)

    # K2's snapshot body (solve_pallas's hook) against hook_edges on each
    # graph's segment 0, timed beside the one-block body on usa
    snap = {}
    for name, g in graphs.items():
        seg0 = scans[name][0][0]
        pi0 = torch.arange(g.num_nodes, dtype=torch.int32, device=dev)
        got = hook_ops.hook_edges_snapshot(pi0, seg0, lift_steps=2)
        want = rounds.hook_edges(pi0, seg0, lift_steps=2)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        check(err == 0, f"hook_snapshot differs from hook_edges on {name}")
        n_edges = seg0.shape[0]
        snap[name] = dict(
            shape=f"{name} segment 0: E={n_edges}, V={g.num_nodes}, one "
                  "snapshot",
            equal=True, max_abs_err=err,
            ms=time_ms(torch, lambda: hook_ops.hook_edges_snapshot(
                pi0, seg0, lift_steps=2)),
            plain_ms=time_ms(torch, lambda: rounds.hook_edges(
                pi0, seg0, lift_steps=2)),
            bound_ms=bound_ms(8 * n_edges + 8 * g.num_nodes),
            bound_by="bytes",
            bound_sector_ms=bound_ms((8 + 7 * SECTOR) * n_edges
                                     + 8 * g.num_nodes),
            library_ms=None)
        print(f"hook_snapshot {name} ({card}): {snap[name]}")
    snap["usa-osm"]["one_block_ms"] = rows["hook"]["ms"]
    rows["hook_snapshot"] = dict(
        name="hook_snapshot", route="cuda",
        source="src/repro_torch/kernels/csrc/hook.cu",
        replaces="src/repro/kernels/hook/hook.py:53", **snap["usa-osm"],
        also=[snap["kron-logn21"]])

    # K3 on the main path's compress input, pi after the first segment's
    # hook, on both graphs: full_compress (the fixpoint body) beside the
    # one-block sequential body run to its fixpoint (tile 512, 2 rounds,
    # at most 64 sweeps)
    mj, seq_mj = {}, {}
    for name, g in graphs.items():
        pi0 = torch.arange(g.num_nodes, dtype=torch.int32, device=dev)
        hooked = rounds.hook_edges(pi0, scans[name][0][0], lift_steps=2)
        want = mj_ref.ref_full_compress(hooked)
        got = mj_ops.full_compress(hooked, tile=512)
        seq = mj_ops.sequential_sweeps(hooked, tile=512, rounds=2,
                                       max_sweeps=mj_ops.MAX_SWEEPS)
        torch.cuda.synchronize()
        err = max(max_abs_err(got, want), max_abs_err(seq, want))
        check(err == 0, f"full_compress or the sequential fixpoint differs "
                        f"from ref_full_compress on {name}")
        moved = int((hooked != want).sum())
        v = g.num_nodes
        shape = (f"{name} full_compress: V={v}, pi after segment 0's hook "
                 f"({moved} pointers move)")
        common = dict(equal=True, max_abs_err=err,
                      plain_ms=time_ms(torch, lambda: mj_ref.ref_full_compress(
                          hooked)),
                      bound_ms=bound_ms(8 * v), bound_by="bytes",
                      bound_sector_ms=bound_ms((8 + SECTOR) * v),
                      library_ms=None)
        mj[name] = dict(
            shape=shape, body="compress_roots", **common,
            ms=time_ms(torch, lambda: mj_ops.full_compress(hooked, tile=512)))
        seq_mj[name] = dict(
            shape=shape + "; tile 512, 2 rounds, at most 64 sweeps",
            body="multi_jump_sweeps", **common,
            ms=time_ms(torch, lambda: mj_ops.sequential_sweeps(
                hooked, tile=512, rounds=2, max_sweeps=mj_ops.MAX_SWEEPS)))
        mj[name]["speedup_over_sequential"] = \
            seq_mj[name]["ms"] / mj[name]["ms"]
        print(f"multi_jump {name} ({card}): fixpoint body {mj[name]}; "
              f"sequential body {seq_mj[name]}")

    # the one-sweep body (multi_jump), off the main path
    g = graphs["kron-logn21"]
    hooked = rounds.hook_edges(
        torch.arange(g.num_nodes, dtype=torch.int32, device=dev),
        scans["kron-logn21"][0][0], lift_steps=2)
    got = mj_ops.multi_jump(hooked, tile=512, rounds=2)
    want = mj_ref.ref_multi_jump_sweep(hooked, 512, 2)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    check(err == 0, "multi_jump differs from its plain version on kron")
    seq_mj["one_sweep"] = dict(
        shape=f"kron-logn21 one sweep: V={g.num_nodes}, tile 512, rounds 2",
        body="multi_jump_sweeps", equal=True, max_abs_err=err,
        ms=time_ms(torch, lambda: mj_ops.multi_jump(hooked, tile=512)),
        plain_ms=time_ms(torch, lambda: mj_ref.ref_multi_jump_sweep(
            hooked, 512, 2)),
        bound_ms=bound_ms(8 * g.num_nodes), bound_by="bytes",
        bound_sector_ms=bound_ms((8 + 2 * SECTOR) * g.num_nodes),
        library_ms=None)
    print(f"multi_jump one sweep ({card}): {seq_mj['one_sweep']}")
    k3 = dict(route="cuda", source="src/repro_torch/kernels/csrc/multi_jump.cu",
              replaces="src/repro/kernels/multi_jump/multi_jump.py:56")
    rows["multi_jump"] = dict(name="multi_jump", **k3, **mj["usa-osm"],
                              also=[mj["kron-logn21"]])
    rows["multi_jump_sequential"] = dict(
        name="multi_jump_sequential", **k3, **seq_mj["usa-osm"],
        also=[seq_mj["kron-logn21"], seq_mj["one_sweep"]])
    del hooked, got, want, seq

    # -- 3. the main path at full scale, launches counted ------------------
    ks = {"cc_fused": cc_ops.KERNEL, "hook": hook_ops.KERNEL,
          "multi_jump": mj_ops.KERNEL}
    for k in ks.values():
        k.launches = 0
    t0 = time.perf_counter()
    results = {}
    for name, g in graphs.items():
        before = cc_ops.KERNEL.launches
        fused = cc.solve_static(g, method="pallas_fused")
        fused_launches = cc_ops.KERNEL.launches - before
        before = hook_ops.KERNEL.launches
        labels = cc.solve_pallas(g)
        results[name] = (fused, fused_launches, labels,
                         hook_ops.KERNEL.launches - before)
    torch.cuda.synchronize()
    launches = {n: k.launches for n, k in ks.items()}
    mj_bodies = {"roots": mj_ops.ROOTS.launches,
                 "sequential": mj_ops.SEQUENTIAL.launches}
    check(mj_bodies["roots"] == launches["multi_jump"],
          f"full_compress did not take the fixpoint body: {mj_bodies}")
    hook_bodies = {"snapshot": hook_ops.SNAPSHOT.launches,
                   "tiles": hook_ops.TILES.launches}
    check(hook_bodies["snapshot"] == launches["hook"],
          f"solve_pallas did not take the snapshot hook body: {hook_bodies}")
    print(f"main path (pallas_fused + pallas on {', '.join(FULL_SCALE)}): "
          f"{time.perf_counter() - t0:.1f} s, launches {launches}")
    for n, count in launches.items():
        check(count > 0, f"kernel {n} was not launched on the main path")
    oracles = {}
    for name, g in graphs.items():
        fused, fused_launches, labels, hook_launches = results[name]
        want = connected_components_scipy(g.edges.cpu().numpy(),
                                          g.num_nodes)
        oracles[name] = want
        check(np.array_equal(fused.labels.cpu().numpy(), want),
              f"pallas_fused labels differ from the oracle on {name}")
        check(np.array_equal(labels.cpu().numpy(), want),
              f"pallas labels differ from the oracle on {name}")
        adaptive = cc.solve_static(g, method="adaptive")
        check(np.array_equal(adaptive.labels.cpu().numpy(), want),
              f"adaptive labels differ from the oracle on {name}")
        fw, aw = fused.work.as_ints(), adaptive.work.as_ints()
        check(fw == aw, f"pallas_fused counters {fw} != adaptive {aw} "
                        f"on {name}")
        cleanup = aw["hook_rounds"] - g.plan.num_segments
        check(fused_launches == 1 + cleanup,
              f"cc_fused launched {fused_launches} times on {name}, "
              f"expected 1 + {cleanup} cleanup rounds")
        check(hook_launches == aw["hook_rounds"],
              f"solve_pallas launched the hook {hook_launches} times on "
              f"{name}, adaptive has {aw['hook_rounds']} hook rounds")
        print(f"{name}: labels == scipy oracle ({len(np.unique(want))} "
              f"components); pallas_fused counters == adaptive {aw}; "
              f"cc_fused launches {fused_launches} = 1 + {cleanup} cleanup; "
              f"solve_pallas hook launches {hook_launches} = hook_rounds")
    rows["cc_fused"]["launches"] = launches["cc_fused"]
    rows["hook"]["launches"] = hook_bodies["tiles"]
    rows["hook_snapshot"]["launches"] = hook_bodies["snapshot"]
    rows["multi_jump"]["launches"] = mj_bodies["roots"]
    rows["multi_jump_sequential"]["launches"] = mj_bodies["sequential"]
    print(f"peak device memory: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # where each solve's device time goes: every kernel's summed device
    # time and launches over one solve, from torch.profiler
    symbols = {"cc_fused": "cc_fused_kernel", "hook": "hook_tiles_kernel",
               "hook_snapshot": "hook_snapshot_kernel",
               "multi_jump": "compress_roots_kernel",
               "multi_jump_sequential": "multi_jump_kernel"}
    for name, g in graphs.items():
        for solve, fn in (("pallas", lambda: cc.solve_pallas(g)),
                          ("pallas_fused", lambda: cc.solve_static(
                              g, method="pallas_fused"))):
            per_kernel, total = device_kernels(torch, fn)
            shares = {k: kernel_share(per_kernel, sym)
                      for k, sym in symbols.items()}
            print(f"profile {name} {solve} ({card}): device {total:.3f} ms; "
                  f"CC kernels {shares}; top "
                  f"{dict(list(per_kernel.items())[:6])}")
            for k, share in shares.items():
                rows[k].setdefault("main_path_device_ms", {})[
                    f"{name} {solve}"] = share

    # K1 and K2 by launch: the scan (or each segment), then each cleanup
    # round, from torch.profiler
    for name, g in graphs.items():
        split = launch_ms(torch, lambda: cc.solve_pallas(g),
                          "hook_snapshot_kernel")
        nseg = g.plan.num_segments
        check(len(split) == results[name][3],
              f"profile of {name} solve_pallas holds {len(split)} "
              f"hook_snapshot launches, not {results[name][3]}")
        rows["hook_snapshot"].setdefault("per_launch_ms", {})[name] = {
            "segments": sum(split[:nseg]),
            "segment_max": max(split[:nseg]),
            "cleanup": split[nseg:]}
        print(f"profile {name} pallas by launch ({card}): hook_snapshot "
              f"{nseg} segments {sum(split[:nseg]):.3f} ms (max "
              f"{max(split[:nseg]):.3f}), cleanup rounds "
              f"{[round(t, 3) for t in split[nseg:]]}")
        split = launch_ms(torch, lambda: cc.solve_static(
            g, method="pallas_fused"), "cc_fused_kernel")
        check(len(split) == results[name][1],
              f"profile of {name} pallas_fused holds {len(split)} cc_fused "
              f"launches, not {results[name][1]}")
        rows["cc_fused"].setdefault("per_launch_ms", {})[name] = {
            "scan": split[0], "cleanup": split[1:]}
        print(f"profile {name} pallas_fused by launch ({card}): scan "
              f"{split[0]:.3f} ms, cleanup rounds "
              f"{[round(t, 3) for t in split[1:]]}")

    # -- 4. parity constants at scale 0.002 --------------------------------
    for name, (shape, counters, scan_sweeps) in PARITY.items():
        g = DeviceGraph.from_host(table1_scaled(name, scale=0.002, seed=1),
                                  device=dev)
        check((g.num_nodes, g.true_edges, g.plan.num_segments) == shape,
              f"{name} stand-in shape")
        want = dict(zip(COUNTERS, counters))
        for method in ("adaptive", "pallas_fused"):
            got = cc.solve_static(g, method=method).work.as_ints()
            check(got == want, f"{name} {method} counters {got} != {want}")
        segs = rounds.pad_and_segment(g.edges, g.plan)
        counts = rounds.segment_true_counts(g.true_edges, g.plan, device=dev)
        _, sw = cc_ops.fused_segment_scan(
            torch.arange(g.num_nodes, dtype=torch.int32, device=dev),
            segs, counts)
        check(int(sw.sum()) == scan_sweeps, f"{name} scan sweeps")
        print(f"parity {name} @0.002: counters {counters} and scan sweeps "
              f"{scan_sweeps} reproduced")

    # -- 5. end-to-end times -----------------------------------------------
    e2e = {}
    for name, g in graphs.items():
        e2e[name] = {
            "pallas_fused_ms": time_ms(
                torch, lambda: cc.solve_static(g, method="pallas_fused")),
            "pallas_ms": time_ms(torch, lambda: cc.solve_pallas(g)),
            "adaptive_ms": time_ms(
                torch, lambda: cc.solve_static(g, method="adaptive")),
        }
        print(f"e2e {name}: " + ", ".join(
            f"{k} {v:.3f}" for k, v in e2e[name].items()))
    return e2e, graphs, oracles


# the kernels JSON line's rows, in order
KERNEL_ROWS = ("cc_fused", "cc_fused_batched", "hook", "hook_snapshot",
               "multi_jump", "multi_jump_sequential", "embedding_bag",
               "segment_reduce", "segment_reduce_atomic", "flash_attention")
# phase groups, in run order; ``--only`` runs some of them (the CC phases
# 2-5 come along with any group that reuses their graphs)
GROUPS = ("cc", "recsys", "lm", "front_door", "dynamic", "batched",
          "service", "distributed", "fleet", "mla_moe", "train", "lm_train",
          "gnn", "launch_analysis")
NEEDS_CC = ("front_door", "dynamic", "distributed")


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    only = set(GROUPS)
    if args:
        if len(args) != 2 or args[0] != "--only" \
                or not set(args[1].split(",")) <= set(GROUPS):
            print(f"usage: chip_smoke.py [--only GROUP[,GROUP...]], groups "
                  f"{', '.join(GROUPS)}", file=sys.stderr)
            return 2
        only = set(args[1].split(","))
        if only & set(NEEDS_CC):
            only.add("cc")
    # the one torch.compile (phase 11's flex_attention yardstick) keeps
    # its caches in the checkout's build directory and compiles in-process
    for var, val in (("TORCHINDUCTOR_CACHE_DIR", ROOT / "build" / "inductor"),
                     ("TRITON_CACHE_DIR", ROOT / "build" / "triton"),
                     ("TORCHINDUCTOR_COMPILE_THREADS", "1")):
        os.environ.setdefault(var, str(val))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found: run from the "
              "repository root", file=sys.stderr)
        return 1
    import numpy as np

    from repro_torch import kernels

    t_start = time.perf_counter()
    dev = torch.device(DEVICE)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)

    # -- 1. build ----------------------------------------------------------
    report = kernels.build()
    print(f"build: {report['seconds']:.2f} s (nvcc, sm_90a, "
          f"{len(report['ptxas'])} sources built in parallel)")
    for name, text in report["ptxas"].items():
        for line in text.splitlines():
            if "registers" in line or "error" in line.lower():
                print(f"  ptxas {name}: {line.strip()}")

    # -- 2.-5. the CC kernels and the static main path ---------------------
    rows, e2e = {}, {}
    graphs = oracles = None
    if "cc" in only:
        cc_e2e, graphs, oracles = cc_phases(torch, np, dev, rows, card)
        e2e.update(cc_e2e)
    # 6.-10. the recsys serving slice; 11.-13. the LM serving slice
    if "recsys" in only:
        e2e.update(recsys_phases(torch, np, dev, rows, card))
    if "lm" in only:
        e2e.update(lm_phases(torch, np, dev, rows, card))
    # 14.-15. the front door; 16.-17. the dynamic stream
    if "front_door" in only:
        e2e.update(front_door_phases(torch, np, dev, rows, card, graphs,
                                     oracles))
    if "dynamic" in only:
        e2e.update(dynamic_phases(torch, np, dev, rows, card, graphs))
    # 18. the batched engine; 19. the connectivity service
    if "batched" in only:
        e2e.update(batched_phases(torch, np, dev, rows, card))
    if "service" in only:
        e2e.update(service_phases(torch, np, dev, rows, card))
    # 20. the multi-shard engine and the cc-adaptive cell; 21. the fleet
    if "distributed" in only:
        e2e.update(distributed_phases(torch, np, dev, rows, card, graphs,
                                      oracles))
    if "fleet" in only:
        e2e.update(fleet_phases(torch, np, dev, rows, card))
    # 22.-23. the MLA and MoE LMs, one model on the card at a time
    graphs = oracles = None
    if "mla_moe" in only:
        e2e.update(mla_moe_phases(torch, np, dev, rows, card))
    # 24. DCN-v2 training; 25. gemma2-2b training
    if "train" in only:
        e2e.update(train_phases(torch, np, dev, rows, card))
    if "lm_train" in only:
        e2e.update(lm_train_phases(torch, np, dev, rows, card))
    # 26. the GNN family's training
    if "gnn" in only:
        e2e.update(gnn_phases(torch, np, dev, rows, card))
    # 27. the dry-run, the cost model, the transfer pass, elastic rescale
    if "launch_analysis" in only:
        e2e.update(launch_analysis_phases(torch, np, dev, rows, card))
    print("e2e " + json.dumps(e2e))
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": [rows[k] for k in KERNEL_ROWS
                                  if k in rows or only == set(GROUPS)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
