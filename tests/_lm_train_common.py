"""Helpers shared by the LM training parity tests
(``tests/test_torch_lm_*.py``): the smoke configs' reference parameters,
token batches, and the whole-train-step check that
``test_torch_lm_train_steps*.py`` run, a few archs a file.

As in ``test_torch_lm.py`` the reference's zero norm weights and QKV
biases are drawn from a seeded normal instead, the same numbers for
both packages, so that every parameter takes part.

Tolerances (float32). Attention, the losses and ``loss_fn``'s value:
1e-5 (the same fp32 terms summed in another order). ``loss_fn``'s
gradients: 1e-5 of the leaf's largest |gradient| (a gradient sums many
terms whose fp32 orders differ). AdamW steps, each from the same
carried state on both sides: loss to 1e-6 relative, grad norm to 1e-6
(2^-8 with bf16 moments); m and v within what that gradient gate makes
of them (1e-5 of m's largest, 2e-5 of v's); a parameter within the move
those errors make in the update lr m^ / (sqrt(v^) + eps), worked out
element by element from the reference's m and v, plus its own ulp.
Where sqrt(v) is near 0 that bound grows without limit, as Adam turns
fp32 noise in a near-zero gradient into a move of any size up to the
step's. grok-1's train cell keeps its moments and its 16-microbatch
gradient sum in bfloat16: the sum rounds after each add, at most half an
ulp of a partial sum, and no partial sum exceeds S = sum_j |g_j| (the
microbatch gradients, the port's), so the two sides' sums differ by at
most 16 ulp(S) beyond their inputs; the clip factor moves with the grad
norm's 2^-8; each side's rounding of m and v to bfloat16 adds one ulp.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget
from repro.data import pipeline as jdp
from repro.models import transformer as JT
from repro.train import train_state as jts
from repro.train.optimizer import AdamWConfig as JAdamWConfig, \
    adamw as jadamw
from repro_torch.configs import get_arch as tget
from repro_torch.launch import steps
from repro_torch.models import transformer as TT
from repro_torch.train.optimizer import AdamWConfig, adamw, named

ARCHS = ("gemma2-2b", "qwen2.5-32b", "minicpm3-4b", "grok-1-314b",
         "phi3.5-moe-42b-a6.6b")
MOE = ("grok-1-314b", "phi3.5-moe-42b-a6.6b")
PERTURBED = ("ln1", "ln2", "ln1_post", "ln2_post", "final_norm", "bq", "bk",
             "bv", "q_norm", "kv_norm")
SEQ = 32


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _rand(shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    return np.spacing(np.abs(x).astype(np.float32)) * 65536.0


def _reference_params(arch: str) -> tuple:
    """(reference config, port config, the reference's smoke params as
    host arrays with the norms and biases drawn from a seeded normal)."""
    jcfg = jget(arch).make_smoke_config()
    tcfg = tget(arch).make_smoke_config()
    tree = jax.tree.map(np.asarray, JT.init(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(7)
    paths, treedef = jax.tree_util.tree_flatten_with_path(tree)
    leaves = []
    for path, leaf in paths:
        if getattr(path[-1], "key", None) in PERTURBED:
            leaf = rng.normal(0.0, 0.3, leaf.shape).astype(leaf.dtype)
        leaves.append(leaf)
    return jcfg, tcfg, jax.tree_util.tree_unflatten(treedef, leaves)


def _tokens(cfg, b: int, seed: int = 3) -> np.ndarray:
    return jdp.lm_batch(seed, 0, b, SEQ, cfg.vocab)["tokens"]



# --------------------------------------------------------------------------
# Whole train steps from a carried reference TrainState
# --------------------------------------------------------------------------

def _reference_steps(arch: str, n_steps: int, b: int):
    """The reference's ``_build_lm`` train step (AdamW lr 3e-4, the
    arch's moment dtype, its accumulation) on the smoke config, run
    ``n_steps`` times: (port config, the states before and after each
    step as host arrays, each step's metrics)."""
    jcfg, tcfg, tree = _reference_params(arch)
    mod = jget(arch)
    moment = getattr(mod, "MOMENT_DTYPE", None)
    opt = jadamw(JAdamWConfig(lr=3e-4, moment_dtype=moment))
    state = jts.create(jax.tree.map(jnp.asarray, tree), opt)
    step = jax.jit(jts.make_train_step(
        lambda p, bb: JT.loss_fn(p, bb, jcfg), opt,
        accum_steps=getattr(mod, "ACCUM_STEPS", 4), accum_dtype=moment))
    states, metrics = [jax.tree.map(np.asarray, state)], []
    for i in range(n_steps):
        state, m = step(state, {"tokens": jnp.asarray(_tokens(jcfg, b, i))})
        states.append(jax.tree.map(np.asarray, state))
        metrics.append({k: float(v) for k, v in m.items()})
    return tcfg, states, metrics


def _moment_gates(m: np.ndarray, v: np.ndarray, sum_gate=None) -> tuple:
    """The gates of m and v (see the module docstring): the gradient's
    1e-5 of its leaf's largest carried into m = b1 m + (1 - b1) g and
    v = b2 v + (1 - b2) g^2. With bfloat16 moments ``sum_gate`` = (the
    gate of the step's gradient, its magnitude): that moves m by
    (1 - b1) dg and v by (1 - b2) 2 |g| dg, and each side's rounding to
    bfloat16 adds one ulp."""
    dm = 1e-5 * np.abs(m).max() + np.zeros_like(m)
    dv = 2e-5 * np.abs(v).max() + np.zeros_like(v)
    if sum_gate is not None:
        dg, g = sum_gate
        dm = dm + 0.1 * dg + bf16_ulp(m)
        dv = dv + 0.05 * 2 * g * dg + bf16_ulp(v)
    return dm, dv


def _bf16_sum_gate(params: dict, tokens: np.ndarray, cfg, accum: int,
                   grad_norm: float) -> dict:
    """By leaf, (the gate, the magnitude) of the step's gradient g =
    clip * (the bfloat16 sum of the ``accum`` microbatch gradients) /
    accum. Each side's sum rounds after every add, at most half an ulp of
    a partial sum, and no partial sum exceeds S = sum_j |g_j|: the two
    sums differ by at most accum ulp(S) beyond their fp32 inputs' 1e-5.
    The clip factor 1 / max(norm, 1) moves with the norm, by 2^-8 (its
    gate). The microbatch gradients are the port's, on the carried
    parameters."""
    leaves = TT.flatten(params)
    total = {n: 0.0 for n in leaves}
    gsum = {n: 0.0 for n in leaves}
    for chunk in np.split(tokens, accum):
        loss = TT.loss_fn(params, {"tokens": torch.from_numpy(chunk)}, cfg)
        for n, g in zip(leaves, torch.autograd.grad(loss,
                                                    list(leaves.values()))):
            total[n] = total[n] + np.abs(_np(g)).astype(np.float64)
            gsum[n] = gsum[n] + _np(g).astype(np.float64)
    clip = min(1.0, 1.0 / grad_norm)
    out = {}
    for n in leaves:
        g = clip * np.abs(gsum[n]) / accum
        dg = clip * (accum * bf16_ulp(total[n]) + 1e-5 * total[n].max()) \
            / accum + 2.0 ** -8 * g
        out[n] = (dg, g)
    return out


def _port_leaves(tree: dict, tcfg) -> dict:
    """A reference state's params, m and v as port leaves by name."""
    cpu = torch.device("cpu")
    return {part: TT.flatten(TT._unstacked(
        tree["params"] if part == "params" else tree["opt"][part], tcfg,
        cpu)) for part in ("params", "m", "v")}



def train_steps_match_reference(arch, monkeypatch):
    """3 steps of ``build_cell(arch, "train_4k")``'s step (on the smoke
    config, B = 16 sequences of 32 tokens), each from the reference's
    state before it (``state_from_reference``), against the reference's
    steps under ``jax.jit``: loss, grad norm, params, m and v under the
    module's gates. Each step starts from the same state on both sides,
    so no step inherits the last one's differences."""
    n_steps, b, lr = 3, 16, 3e-4
    tcfg, states, jm = _reference_steps(arch, n_steps, b)
    mod = tget(arch)
    monkeypatch.setattr(mod, "make_config", lambda: tcfg)
    cell = steps.build_cell(arch, "train_4k", device="cpu")
    moment = getattr(mod, "MOMENT_DTYPE", None)
    opt = adamw(AdamWConfig(lr=lr, moment_dtype=moment))
    for i in range(n_steps):
        state = TT.state_from_reference(states[i], tcfg, opt, device="cpu")
        sum_gate = None
        if moment is not None:
            sum_gate = _bf16_sum_gate(state["params"], _tokens(tcfg, b, i),
                                      tcfg, mod.ACCUM_STEPS,
                                      jm[i]["grad_norm"])
        state, m = cell.step(state, {"tokens": _tokens(tcfg, b, i)})
        assert int(state["step"]) == i + 1
        assert float(m["loss"]) == pytest.approx(jm[i]["loss"], rel=1e-6)
        assert float(m["grad_norm"]) == pytest.approx(
            jm[i]["grad_norm"], rel=1e-6 if moment is None else 2.0 ** -8)
        before, after = _port_leaves(states[i], tcfg), \
            _port_leaves(states[i + 1], tcfg)
        got = {"params": named(state["params"]), **state["opt"]}
        bc1, bc2 = 1 - 0.9 ** (i + 1), 1 - 0.95 ** (i + 1)
        for part in ("m", "v", "params"):
            assert got[part].keys() == after[part].keys()
            for n, t in got[part].items():
                g, w = _np(t), _np(after[part][n])
                assert t.dtype == after[part][n].dtype, (part, n)
                m, v = (_np(after[k][n]).astype(np.float64)
                        for k in ("m", "v"))
                dm, dv = _moment_gates(m, v, None if sum_gate is None
                                       else sum_gate[n])
                if part == "m":
                    gate = dm
                elif part == "v":
                    gate = dv
                else:
                    # the update lr m^ / (sqrt(v^) + eps), moved by dm, dv
                    root = np.sqrt(v / bc2)
                    gate = lr * (dm / bc1 / (root + 1e-8) + np.abs(m / bc1)
                                 * (dv / bc2) / (2 * np.maximum(root, 1e-30)
                                                 * (root + 1e-8) ** 2)) \
                        + np.spacing(np.abs(w))
                assert np.all(np.abs(g - w) <= gate), (i, part, n, float(
                    (np.abs(g - w) / np.maximum(gate, 1e-38)).max()))
        # a skipped update is off by all of the leaf's movement
        for n, t in got["params"].items():
            moved = np.abs(_np(after["params"][n])
                           - _np(before["params"][n])).sum()
            assert np.abs(_np(t) - _np(after["params"][n])).sum() <= \
                0.25 * moved, (i, n)
