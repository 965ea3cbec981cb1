"""repro_torch's MoE FFN (``models/moe.py``) against the reference's
``repro.models.moe``, on the smoke MoE shapes (d_model 64, 4 experts,
top-2, d_ff_expert 96) and a decode-shaped call on 8 experts, with the
reference's parameters carried across and inputs from numpy seeds.

Routing is compared exactly: the port's ``gate_idx`` against the
reference's own ``jax.lax.top_k`` output (recorded where the reference
calls it), and the port's buffer positions and keep mask against a
numpy recount from those indices (choice-major ranks, capacity per
chunk). Outputs: float32 within 1e-5 and the aux loss within 1e-6 (sums
in another order); bfloat16 with the routing equal and the output
within 2e-2 of its largest |value|, the bfloat16 forward test's gate in
``tests/test_torch_lm.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as JM
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM

SMOKE = TM.MoEConfig(num_experts=4, top_k=2, d_ff_expert=96)
D = 64


def _ref_cfg(cfg: TM.MoEConfig) -> JM.MoEConfig:
    return JM.MoEConfig(**dataclasses.asdict(cfg))


def _params(cfg: TM.MoEConfig, seed: int, dtype=jnp.float32):
    tree = jax.tree.map(np.array, JM.moe_params(
        jax.random.PRNGKey(seed), D, _ref_cfg(cfg), dtype))
    return tree, {k: TL.from_numpy(v) for k, v in tree.items()}


def _input(shape, seed: int, dtype=np.float32) -> np.ndarray:
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return x.astype(jnp.bfloat16) if dtype != np.float32 else x


def _recount(gate_idx: np.ndarray, e: int, cap: int):
    """Buffer ranks and keep mask from the top-k indices [T, k], in
    numpy: choice-major order (every first choice before any second),
    tokens in order within a choice."""
    expert = gate_idx.T.reshape(-1)
    pos = np.empty_like(expert)
    seen = np.zeros(e, np.int64)
    for i, ex in enumerate(expert):
        pos[i] = seen[ex]
        seen[ex] += 1
    return pos, pos < cap


def _run_both(cfg, tree, tparams, x, monkeypatch):
    """(reference out, aux, its top-k indices per chunk), (port out, aux,
    its route() results per chunk)."""
    ref_idx, port_routes = [], []
    top_k = jax.lax.top_k

    def spy_top_k(p, k):
        vals, idx = top_k(p, k)
        jax.debug.callback(lambda a: ref_idx.append(np.asarray(a)), idx,
                           ordered=True)
        return vals, idx

    monkeypatch.setattr(jax.lax, "top_k", spy_top_k)
    want, want_aux = JM.moe_apply(jax.tree.map(jnp.asarray, tree),
                                  jnp.asarray(x), _ref_cfg(cfg))
    jax.effects_barrier()
    monkeypatch.setattr(jax.lax, "top_k", top_k)
    route = TM.route

    def spy_route(*a):
        r = route(*a)
        port_routes.append(r)
        return r

    monkeypatch.setattr(TM, "route", spy_route)
    got, got_aux = TM.moe_apply(tparams, TL.from_numpy(x), cfg)
    return (np.asarray(want.astype(jnp.float32)), float(want_aux), ref_idx), \
        (got.float().numpy(), float(got_aux), port_routes)


def _check_routing(cfg, t: int, ref_idx, port_routes):
    chunk = min(cfg.dispatch_chunk, t)
    cap = TM.capacity(cfg, chunk)
    assert cap == max(int(cfg.capacity_factor * chunk * cfg.top_k
                          / cfg.num_experts), 1)
    assert len(ref_idx) == len(port_routes) == -(-t // chunk)
    dropped = 0
    for idx, r in zip(ref_idx, port_routes):
        np.testing.assert_array_equal(r["gate_idx"].numpy(), idx)
        pos, keep = _recount(idx, cfg.num_experts, cap)
        np.testing.assert_array_equal(r["pos"].numpy(), pos)
        np.testing.assert_array_equal(r["keep"].numpy(), keep)
        dropped += int((~keep).sum())
    return dropped


@pytest.mark.parametrize("shape,chunk", [((2, 19), 16384), ((2, 19), 16),
                                         ((3, 11), 8), ((1, 40), 40)])
def test_moe_apply_matches_reference(shape, chunk, monkeypatch):
    """One chunk, and several with a zero-padded last one (38 tokens in
    chunks of 16: 16 + 16 + 6 and 10 padding rows; 33 in chunks of 8)."""
    cfg = dataclasses.replace(SMOKE, dispatch_chunk=chunk)
    tree, tparams = _params(cfg, 1)
    x = _input((*shape, D), 2)
    (want, want_aux, ref_idx), (got, got_aux, routes) = _run_both(
        cfg, tree, tparams, x, monkeypatch)
    _check_routing(cfg, shape[0] * shape[1], ref_idx, routes)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert abs(got_aux - want_aux) <= 1e-6


def test_moe_apply_overflow_drops_like_the_reference(monkeypatch):
    """Capacity factor 0.5 on inputs pushed toward expert 0: ranks past
    the capacity are dropped, second choices first."""
    cfg = dataclasses.replace(SMOKE, capacity_factor=0.5)
    tree, tparams = _params(cfg, 3)
    x = _input((2, 24, D), 4) + 0.5 * tree["router"][:, 0] / np.linalg.norm(
        tree["router"][:, 0]) * 8
    (want, want_aux, ref_idx), (got, got_aux, routes) = _run_both(
        cfg, tree, tparams, x.astype(np.float32), monkeypatch)
    dropped = _check_routing(cfg, 48, ref_idx, routes)
    assert dropped > 0
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert abs(got_aux - want_aux) <= 1e-6


@pytest.mark.parametrize("tied", ((1, 2), (0, 1, 2, 3)))
def test_moe_apply_exact_ties_pick_the_lower_expert(tied, monkeypatch):
    """Equal router columns give bit-equal probabilities; top-k takes
    the lower expert first, as ``jax.lax.top_k`` does (the order decides
    priority in the buffers)."""
    tree, tparams = _params(SMOKE, 5)
    for i in tied[1:]:
        tree["router"][:, i] = tree["router"][:, tied[0]]
    tparams["router"] = TL.from_numpy(tree["router"])
    x = _input((2, 16, D), 6)
    (want, want_aux, ref_idx), (got, got_aux, routes) = _run_both(
        SMOKE, tree, tparams, x, monkeypatch)
    probs = routes[0]["probs"]
    for i in tied[1:]:
        assert torch.equal(probs[:, i], probs[:, tied[0]])
    _check_routing(SMOKE, 32, ref_idx, routes)
    idx = routes[0]["gate_idx"].numpy()
    if len(tied) == 4:
        assert (idx == [0, 1]).all()
    else:   # where both tied experts lead, the lower one comes first
        both = np.isin(idx, tied).all(axis=1)
        assert both.any() and (idx[both] == list(tied)).all()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert abs(got_aux - want_aux) <= 1e-6


def test_moe_apply_decode_shaped_call_collides(monkeypatch):
    """A decode step of 4 slots on 8 experts: cap = 1, so two slots
    choosing one expert keep only the earlier rank (an empty slot takes
    capacity like any row, as in the reference's serving)."""
    cfg = TM.MoEConfig(num_experts=8, top_k=2, d_ff_expert=96)
    assert TM.capacity(cfg, 4) == 1
    tree, tparams = _params(cfg, 7)
    dropped = 0
    for seed in range(8, 14):
        x = _input((4, 1, D), seed)
        (want, want_aux, ref_idx), (got, got_aux, routes) = _run_both(
            cfg, tree, tparams, x, monkeypatch)
        dropped += _check_routing(cfg, 4, ref_idx, routes)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        assert abs(got_aux - want_aux) <= 1e-6
    assert dropped > 0


@pytest.mark.parametrize("chunk", (16384, 16))
def test_moe_apply_bf16_same_input_routes_equally(chunk, monkeypatch):
    """bfloat16 experts and input (router float32): fed the same bf16
    input, both packages take the same routing decisions, and the output
    is within the bf16 forward test's gate."""
    cfg = dataclasses.replace(SMOKE, dispatch_chunk=chunk)
    tree, tparams = _params(cfg, 9, jnp.bfloat16)
    assert tparams["router"].dtype == torch.float32
    assert tparams["w_up"].dtype == torch.bfloat16
    x = _input((2, 19, D), 10, jnp.bfloat16)
    (want, want_aux, ref_idx), (got, got_aux, routes) = _run_both(
        cfg, tree, tparams, x, monkeypatch)
    _check_routing(cfg, 38, ref_idx, routes)
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
    assert abs(got_aux - want_aux) <= 1e-6


def test_moe_params_shapes_and_dtypes():
    cfg = TM.MoEConfig(num_experts=3, top_k=2, d_ff_expert=10)
    p = TM.moe_params(8, cfg, torch.bfloat16,
                      generator=torch.Generator().manual_seed(0),
                      device="cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in p.items()} == {
        "router": ((8, 3), torch.float32),
        "w_gate": ((3, 8, 10), torch.bfloat16),
        "w_up": ((3, 8, 10), torch.bfloat16),
        "w_down": ((3, 10, 8), torch.bfloat16)}
    assert float(p["w_down"].float().std()) == pytest.approx(10 ** -0.5,
                                                             rel=0.3)
