"""repro_torch's training substrate against the reference's
(``repro.train``) on the same numpy inputs: the optimizers step by step,
clipping and schedules, gradient accumulation, checkpoints (their
format, and across the two packages), the restart loop, the watchdog,
gradient compression and the data generators.

Tolerances: float32 within 1e-6 (the update math is the same ops in
another framework; the bias correction's ``b1 ** t`` is a float32
``pow``, which XLA and torch may round one ulp apart, and global norms
sum in another order). bfloat16 parameters and moments: within one
bfloat16 ulp of the value per step. Both packages run the same fp32
arithmetic and round it to bfloat16 at the same places, so an fp32
difference of a few float32 ulps can move one rounding to the
neighbouring bfloat16 value, once per stored rounding and step.
"""
import json
import os
import tempfile
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jdp
from repro.train import checkpoint as jck
from repro.train import compression as jcomp
from repro.train import fault_tolerance as jft
from repro.train import optimizer as jopt
from repro.train import train_state as jts
from repro_torch.data import pipeline as tdp
from repro_torch.models.layers import from_numpy
from repro_torch.train import checkpoint as tck
from repro_torch.train import compression as tcomp
from repro_torch.train import fault_tolerance as tft
from repro_torch.train import loop as tloop
from repro_torch.train import optimizer as topt
from repro_torch.train import train_state as tts

JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bfloat16 ulp at |x| (7 stored mantissa bits)."""
    return np.spacing(np.abs(x).astype(np.float32)) * 65536.0


def _close(got, want, dtype, steps: int = 1) -> None:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    else:
        gate = steps * bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
        assert np.all(np.abs(got - want) <= gate), np.abs(got - want).max()


def _quad_problem(rng):
    x = rng.standard_normal((4, 8)).astype(np.float32)
    t = rng.standard_normal((4, 8)).astype(np.float32)

    def loss(p, batch):
        return torch.mean((p["w"] @ batch["x"] + p["b"][:, None]
                           - batch["t"]) ** 2)
    params = {"w": torch.ones((4, 4), requires_grad=True),
              "b": torch.zeros((4,), requires_grad=True)}
    return params, loss, {"x": torch.from_numpy(x), "t": torch.from_numpy(t)}


# --------------------------------------------------------------------------
# Optimizers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("make_opt", [
    lambda: topt.adamw(topt.AdamWConfig(lr=0.05, weight_decay=0.0)),
    lambda: topt.sgd(topt.SGDConfig(lr=0.05, momentum=0.9)),
])
def test_optimizers_reach_least_squares_optimum(rng, make_opt):
    params, loss, batch = _quad_problem(rng)
    opt = make_opt()
    state = tts.create(params, opt)
    step = tts.make_train_step(loss, opt)
    for _ in range(300):
        state, m = step(state, batch)
    x, t = batch["x"].numpy(), batch["t"].numpy()
    a = np.vstack([x, np.ones((1, 8), np.float32)])
    w = t @ a.T @ np.linalg.inv(a @ a.T)
    opt_loss = float(((w @ a - t) ** 2).mean())
    assert float(m["loss"]) < opt_loss + 1e-2
    assert int(state["step"]) == 300 and state["step"].dtype == torch.int32


OPTIMIZERS = {
    "adamw": (lambda m: jopt.adamw(jopt.AdamWConfig(lr=1e-2)),
              lambda m: topt.adamw(topt.AdamWConfig(lr=1e-2))),
    "adamw-noclip-cosine": (
        lambda m: jopt.adamw(jopt.AdamWConfig(
            lr=jopt.cosine_schedule(1e-2, 2, 5), clip_norm=0.0,
            weight_decay=0.3)),
        lambda m: topt.adamw(topt.AdamWConfig(
            lr=topt.cosine_schedule(1e-2, 2, 5), clip_norm=0.0,
            weight_decay=0.3))),
    "adamw-f32-moments": (
        lambda m: jopt.adamw(jopt.AdamWConfig(lr=1e-2,
                                              moment_dtype=jnp.float32)),
        lambda m: topt.adamw(topt.AdamWConfig(lr=1e-2,
                                              moment_dtype=torch.float32))),
    "sgd-momentum-clip": (
        lambda m: jopt.sgd(jopt.SGDConfig(lr=1e-2, clip_norm=0.5)),
        lambda m: topt.sgd(topt.SGDConfig(lr=1e-2, clip_norm=0.5))),
    "sgd": (lambda m: jopt.sgd(jopt.SGDConfig(lr=1e-2, momentum=0.0)),
            lambda m: topt.sgd(topt.SGDConfig(lr=1e-2, momentum=0.0))),
}


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_steps_match_reference(name, dtype):
    """Five steps of ``update`` + ``apply_updates`` on the same numpy
    parameters and gradients (a matrix, which decays, and a vector,
    which does not): updates, moments, grad norms and parameters equal
    the reference's at every step."""
    rng = np.random.default_rng(3)
    host = {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "b": rng.standard_normal((5,)).astype(np.float32) * 0.1}
    jo, to = (f(None) for f in OPTIMIZERS[name])
    jp = {k: jnp.asarray(v, JNP[dtype]) for k, v in host.items()}
    tp = {k: from_numpy(np.asarray(v)) for k, v in jp.items()}
    js, ts = jo.init(jp), to.init(tp)
    assert jax.tree.structure(js) == jax.tree.structure(
        {k: dict(v) for k, v in ts.items()})
    for step in range(5):
        g = {k: rng.standard_normal(v.shape).astype(np.float32) * 3
             for k, v in host.items()}
        jg = {k: jnp.asarray(v, JNP[dtype]) for k, v in g.items()}
        tg = {k: from_numpy(np.asarray(v)) for k, v in jg.items()}
        ju, js, jn = jo.update(jg, js, jp, jnp.asarray(step, jnp.int32))
        tu, ts, tn = to.update(tg, ts, tp,
                               torch.tensor(step, dtype=torch.int32))
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        jp = jopt.apply_updates(jp, ju)
        tp = topt.apply_updates(tp, tu)
        for k in host:
            assert tu[k].dtype == tp[k].dtype == dtype
            _close(tu[k], ju[k], dtype)
            _close(tp[k], jp[k], dtype, steps=step + 1)
            for slot in ts:
                _close(ts[slot][k], js[slot][k], dtype, steps=step + 1)


def test_clip_by_global_norm_matches_reference(rng):
    g = {"a": rng.standard_normal(10).astype(np.float32) * 3,
         "b": {"c": rng.standard_normal((3, 4)).astype(np.float32)}}
    for max_norm in (1.0, 100.0):
        jc, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g),
                                          max_norm)
        tc, tn = topt.clip_by_global_norm(
            {"a": torch.from_numpy(g["a"]),
             "b": {"c": torch.from_numpy(g["b"]["c"])}}, max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        np.testing.assert_allclose(tc["a"].numpy(), np.asarray(jc["a"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(tc["b.c"].numpy(),
                                   np.asarray(jc["b"]["c"]), rtol=1e-6)
    _, n = topt.clip_by_global_norm({"a": torch.full((10,), 3.0),
                                     "b": torch.full((10,), 4.0)}, 1.0)
    np.testing.assert_allclose(float(n), np.sqrt(90 + 160), rtol=1e-6)


def test_cosine_and_constant_schedules_match_reference():
    jl = jopt.cosine_schedule(1.0, warmup=10, total=110, floor=0.1)
    tl = topt.cosine_schedule(1.0, warmup=10, total=110, floor=0.1)
    for s in (0, 1, 5, 9, 10, 11, 50, 109, 110, 200):
        want = float(jl(s))
        assert float(tl(s)) == pytest.approx(want, rel=1e-6, abs=1e-7)
        assert float(tl(torch.tensor(s, dtype=torch.int32))) == \
            pytest.approx(want, rel=1e-6, abs=1e-7)
    assert float(tl(0)) == 0.0 and float(tl(5)) == pytest.approx(0.5)
    c = topt.constant_schedule(3e-4)(7)
    assert c.dtype == torch.float32 and float(c) == float(
        jopt.constant_schedule(3e-4)(7))


def test_moment_dtype_and_named():
    opt = topt.adamw(topt.AdamWConfig(moment_dtype=torch.bfloat16))
    state = opt.init({"w": torch.ones((4, 4))})
    assert state["m"]["w"].dtype == torch.bfloat16
    tree = {"mlp": {"ws": [torch.zeros(1), torch.ones(2)]}, "head": 1}
    assert list(topt.named(tree)) == ["mlp.ws.0", "mlp.ws.1", "head"]


def test_grad_accumulation_equals_single_shot(rng):
    w = rng.standard_normal((4, 4)).astype(np.float32)

    def loss(p, b):
        return torch.mean((b["x"] @ p["w"] - b["t"]) ** 2)

    batch = {"x": torch.from_numpy(rng.standard_normal((8, 4)).astype(
        np.float32)),
             "t": torch.from_numpy(rng.standard_normal((8, 4)).astype(
                 np.float32))}
    opt = topt.adamw(topt.AdamWConfig(lr=1e-2, weight_decay=0.0))
    s1 = tts.create({"w": torch.from_numpy(w.copy()).requires_grad_()},
                    opt)
    s4 = tts.create({"w": torch.from_numpy(w.copy()).requires_grad_()},
                    opt)
    s1, m1 = tts.make_train_step(loss, opt)(s1, batch)
    s4, m4 = tts.make_train_step(loss, opt, accum_steps=4)(s4, batch)
    np.testing.assert_allclose(s1["params"]["w"].detach().numpy(),
                               s4["params"]["w"].detach().numpy(), atol=1e-6)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=1e-6)
    with pytest.raises(ValueError, match="split"):
        tts.make_train_step(loss, opt, accum_steps=3)(s4, batch)


@pytest.mark.parametrize("accum", (1, 4))
def test_train_step_matches_reference(rng, accum):
    """The generic step (value and grad, optional accumulation, AdamW,
    in-place apply) on a least-squares problem: loss, grad norm,
    parameters and moments equal the reference's jitted step."""
    w = rng.standard_normal((4, 4)).astype(np.float32)
    b = {"x": rng.standard_normal((8, 4)).astype(np.float32),
         "t": rng.standard_normal((8, 4)).astype(np.float32)}
    jo = jopt.adamw(jopt.AdamWConfig(lr=1e-2))
    to = topt.adamw(topt.AdamWConfig(lr=1e-2))
    js = jts.create({"w": jnp.asarray(w)}, jo)
    ts = tts.create({"w": torch.from_numpy(w.copy()).requires_grad_()}, to)
    jstep = jax.jit(jts.make_train_step(
        lambda p, bb: jnp.mean((bb["x"] @ p["w"] - bb["t"]) ** 2), jo,
        accum_steps=accum))
    tstep = tts.make_train_step(
        lambda p, bb: torch.mean((bb["x"] @ p["w"] - bb["t"]) ** 2), to,
        accum_steps=accum)
    for _ in range(3):
        js, jm = jstep(js, jax.tree.map(jnp.asarray, b))
        ts, tm = tstep(ts, {k: torch.from_numpy(v) for k, v in b.items()})
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-6)
    _close(ts["params"]["w"], js["params"]["w"], torch.float32)
    for slot in ("m", "v"):
        _close(ts["opt"][slot]["w"], js["opt"][slot]["w"], torch.float32)
    assert int(ts["step"]) == int(js["step"]) == 3
    assert tts.param_count(ts) == jts.param_count(js) == 16


def test_fit_trains_a_copy(rng):
    params, loss, batch = _quad_problem(rng)
    opt = topt.adamw(topt.AdamWConfig(lr=0.05, weight_decay=0.0))
    logs = []
    state, hist = tloop.fit(loss_fn=loss, params=params, opt=opt,
                            stream=iter([batch] * 30), steps=30,
                            log_every=10, log_fn=logs.append)
    assert [h["step"] for h in hist] == [10, 20, 30] and len(logs) == 3
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert torch.equal(params["w"], torch.ones((4, 4)))   # untouched
    assert not torch.equal(state["params"]["w"], params["w"])


def test_create_takes_the_parameters_as_given():
    """``create`` changes no parameter: it refuses frozen ones, naming
    them, and keeps trainable ones as they are."""
    opt = topt.sgd(topt.SGDConfig(lr=0.1))
    with pytest.raises(ValueError, match=r"\['b'\] do not require grad"):
        tts.create({"w": torch.ones(2, requires_grad=True),
                    "b": torch.zeros(2)}, opt)
    w = torch.ones(2, requires_grad=True)
    assert tts.create({"w": w}, opt)["params"]["w"] is w


# --------------------------------------------------------------------------
# Checkpoints
# --------------------------------------------------------------------------

def _state(rng, dtype=torch.float32) -> dict:
    """A port state shaped like DCN-v2's (a list of dicts, a dict of
    lists, dotted moment names, an int32 step) in ``dtype``."""
    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dtype)
    params = {"table": t(6, 3), "cross": [{"w": t(2, 2), "b": t(2)},
                                          {"w": t(2, 2), "b": t(2)}],
              "mlp": {"ws": [t(3, 2)], "bs": [t(2)]}}
    flat = topt.named(params)
    return {"params": params,
            "opt": {"m": {n: t(*p.shape) for n, p in flat.items()},
                    "v": {n: t(*p.shape) for n, p in flat.items()}},
            "step": torch.tensor(7, dtype=torch.int32)}


def _reference_tree(state: dict, dtype) -> dict:
    """The same values as the reference's nested tree of jax arrays."""
    def conv(x):
        a = x.detach().float().numpy()
        return jnp.asarray(a, JNP[dtype]) if x.dtype != torch.int32 \
            else jnp.asarray(x.numpy())

    def nest(flat):
        out = {"table": conv(flat["table"]),
               "cross": [{"w": conv(flat[f"cross.{i}.w"]),
                          "b": conv(flat[f"cross.{i}.b"])} for i in range(2)],
               "mlp": {"ws": [conv(flat["mlp.ws.0"])],
                       "bs": [conv(flat["mlp.bs.0"])]}}
        return out
    return {"params": nest(topt.named(state["params"])),
            "opt": {k: nest(v) for k, v in state["opt"].items()},
            "step": conv(state["step"])}


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _zeros_like(state: dict) -> dict:
    return _map(torch.zeros_like, state)


def _assert_states_equal(a: dict, b: dict) -> None:
    fa, fb = tck._flatten_with_paths(tck._tree(a)), \
        tck._flatten_with_paths(tck._tree(b))
    assert [n for n, _ in fa] == [n for n, _ in fb]
    for (n, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and torch.equal(x, y), n


def test_checkpoint_roundtrip_and_retention(rng):
    state = _state(rng)
    with tempfile.TemporaryDirectory() as d:
        path = tck.save(d, state, 7)
        assert sorted(os.listdir(path)) == ["arrays.npz", "manifest.json"]
        restored = tck.restore(d, like=_zeros_like(state))
        _assert_states_equal(restored, state)
        saver = tck.AsyncCheckpointer(d, keep=2)
        for s in (8, 9, 10):
            saver.save(state, s)
        saver.wait()
        assert sorted(os.listdir(d)) == ["step_00000009", "step_00000010"]
        assert tck.latest_step(d) == 10
    assert tck.latest_step(os.path.join(d, "gone")) is None


def test_async_checkpoint_snapshots_before_the_state_moves(rng):
    """The train step writes parameters in place, so the snapshot must
    be a copy taken when ``save`` is called."""
    state = _state(rng)
    want = _map(torch.clone, state)
    with tempfile.TemporaryDirectory() as d:
        saver = tck.AsyncCheckpointer(d)
        saver.save(state, 1)
        with torch.no_grad():
            state["params"]["table"].add_(1.0)
            state["step"] += 5
        saver.wait()
        _assert_states_equal(tck.restore(d, like=_zeros_like(state)), want)


def test_checkpoint_shape_mismatch_and_missing_leaf_raise(rng):
    state = {"w": torch.zeros((3, 3))}
    with tempfile.TemporaryDirectory() as d:
        tck.save(d, state, 1)
        with pytest.raises(ValueError, match="shape"):
            tck.restore(d, like={"w": torch.zeros((4, 4))})
        with pytest.raises(KeyError, match="'v'"):
            tck.restore(d, like={"w": torch.zeros((3, 3)),
                                 "v": torch.zeros(1)})
    with tempfile.TemporaryDirectory() as d, \
            pytest.raises(FileNotFoundError):
        tck.restore(d, like=state)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_reference_checkpoint_restores_into_the_port(rng, dtype):
    state = _state(rng, dtype)
    with tempfile.TemporaryDirectory() as d:
        jck.save(d, _reference_tree(state, dtype), 7)
        restored = tck.restore(d, like=_zeros_like(state))
    _assert_states_equal(restored, state)


def test_port_checkpoint_restores_into_the_reference(rng):
    state = _state(rng)
    with tempfile.TemporaryDirectory() as d:
        tck.save(d, state, 7)
        like = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                            _reference_tree(state, torch.float32))
        restored = jck.restore(d, like=like)
    want = _reference_tree(state, torch.float32)
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_port_checkpoint_is_byte_equal_to_the_reference(rng, dtype):
    """A port save writes the manifest and the ``.npy`` members that a
    reference save of the same state writes (the zip's own timestamps
    aside). In bfloat16 this is the check that crosses the packages:
    the reference cannot restore its own bfloat16 leaves."""
    state = _state(rng, dtype)
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        p1 = tck.save(d1, state, 7)
        p2 = jck.save(d2, _reference_tree(state, dtype), 7)
        manifests = [json.load(open(os.path.join(p, "manifest.json")))
                     for p in (p1, p2)]
        assert manifests[0] == manifests[1]
        members = []
        for p in (p1, p2):
            with zipfile.ZipFile(os.path.join(p, "arrays.npz")) as z:
                members.append({n: z.read(n) for n in z.namelist()})
        assert members[0] == members[1]
    leaves = manifests[0]["leaves"]
    assert [l["name"] for l in leaves][:3] == [
        "opt/m/cross/0/b", "opt/m/cross/0/w", "opt/m/cross/1/b"]
    assert {l["name"]: l["dtype"] for l in leaves}["params/table"] == \
        ("bfloat16" if dtype == torch.bfloat16 else "float32")


# --------------------------------------------------------------------------
# Fault tolerance
# --------------------------------------------------------------------------

def _make_stream(start):
    def gen():
        step = start
        while True:
            r = np.random.default_rng((42, step))
            yield {"x": torch.from_numpy(r.standard_normal((4, 8)).astype(
                np.float32)),
                   "t": torch.from_numpy(r.standard_normal((4, 8)).astype(
                       np.float32))}
            step += 1
    return gen()


def test_run_with_restarts_recovers_and_replays(rng):
    """A failure mid-run: the loop restores the checkpoint and ends in
    EXACTLY the state of an uninterrupted run (deterministic (seed, step)
    stream, bit-equal on the CPU)."""
    params, loss, _ = _quad_problem(rng)
    opt = topt.adamw(topt.AdamWConfig(lr=0.05, weight_decay=0.0))
    raw = tts.make_train_step(loss, opt)

    def run(fail_at, d):
        tripped = {"done": False}

        def step_fn(state, batch):
            if fail_at and int(state["step"]) == fail_at \
                    and not tripped["done"]:
                tripped["done"] = True
                raise tft.SimulatedFailure("boom")
            return raw(state, batch)

        return tft.run_with_restarts(
            init_state_fn=lambda: tts.create(
                {k: v.detach().clone().requires_grad_()
                 for k, v in params.items()}, opt),
            step_fn=step_fn, stream_fn=_make_stream, total_steps=40,
            ckpt_dir=d, ckpt_every=10, max_restarts=2)

    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        clean = run(0, d1)
        faulty = run(25, d2)
        assert tck.latest_step(d2) == 40
    assert (clean.restarts, faulty.restarts) == (0, 1)
    assert (clean.steps_run, faulty.steps_run) == (40, 45)
    _assert_states_equal(faulty.final_state, clean.final_state)


def test_run_with_restarts_gives_up():
    def step_fn(state, batch):
        raise tft.SimulatedFailure("always")

    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(RuntimeError, match="max_restarts=2"):
            tft.run_with_restarts(
                init_state_fn=lambda: {"step": torch.zeros(
                    (), dtype=torch.int32)},
                step_fn=step_fn, stream_fn=lambda s: iter([{}] * 100),
                total_steps=10, ckpt_dir=d, max_restarts=2)


def test_watchdog_matches_reference(rng):
    times = list(rng.uniform(0.09, 0.11, 20)) + [1.0, 0.1, 0.5, 0.1, 0.35]
    jw, tw = jft.StepWatchdog(threshold=3.0), tft.StepWatchdog(threshold=3.0)
    flags = [(jw.observe(i, t), tw.observe(i, t)) for i, t in
             enumerate(times)]
    assert all(a == b for a, b in flags) and sum(a for a, _ in flags) == 3
    assert tw.slow_steps == jw.slow_steps and tw.ema == jw.ema


# --------------------------------------------------------------------------
# Gradient compression
# --------------------------------------------------------------------------

def test_compression_error_feedback_matches_reference(rng):
    g = {"a": rng.standard_normal(512).astype(np.float32),
         "b": rng.standard_normal((8, 16)).astype(np.float32) * 1e-3}
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    tres, jres = tcomp.zero_residual(tg), jcomp.zero_residual(jg)
    for _ in range(3):
        tq, tsc, tres = tcomp.compress(tg, tres)
        jq, jsc, jres = jcomp.compress(jg, jres)
        tdeq = tcomp.decompress(tq, tsc, tg)
        for k in g:
            assert tq[k].dtype == torch.int8
            np.testing.assert_array_equal(tq[k].numpy(), np.asarray(jq[k]))
            np.testing.assert_allclose(float(tsc[k]), float(jsc[k]),
                                       rtol=1e-7)
            np.testing.assert_allclose(tres[k].numpy(), np.asarray(jres[k]),
                                       atol=1e-7)
            # int8 error bounded by scale/2; EF: deq + residual = g + r_in
            err = np.abs(tdeq[k].numpy() - g[k])
            assert err.max() <= float(tsc[k]) * 0.5 + 1e-6 + np.abs(
                tres[k].numpy()).max()


def test_compression_invariant(rng):
    g = {"a": torch.from_numpy(rng.standard_normal(512).astype(np.float32))}
    q, sc, res = tcomp.compress(g, tcomp.zero_residual(g))
    deq = tcomp.decompress(q, sc, g)
    assert float((deq["a"] - g["a"]).abs().max()) <= float(sc["a"]) * 0.5 \
        + 1e-7
    torch.testing.assert_close(deq["a"] + res["a"], g["a"], atol=1e-6,
                               rtol=0)


# --------------------------------------------------------------------------
# Data pipeline
# --------------------------------------------------------------------------

GENERATORS = {
    "lm_batch": lambda m, seed, step: m.lm_batch(seed, step, 4, 16, 100),
    "lm_batch_wide": lambda m, seed, step: m.lm_batch(seed, step, 2, 300,
                                                      256_000),
    "recsys_batch": lambda m, seed, step: m.recsys_batch(
        seed, step, 8, 5, (10, 20)),
    "graph_node_batch": lambda m, seed, step: m.graph_node_batch(
        seed, step, 64, 128, 6, 3),
    "molecule_energy_batch": lambda m, seed, step: m.molecule_energy_batch(
        seed, step, 4, 8, 12, n_species=5),
}


@pytest.mark.parametrize("seed,step", [(0, 0), (7, 3), (7, 4), (123, 99)])
@pytest.mark.parametrize("name", list(GENERATORS))
def test_generators_bit_equal_to_reference(name, seed, step):
    got = GENERATORS[name](tdp, seed, step)
    want = GENERATORS[name](jdp, seed, step)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])


def test_lm_batches_resume_at_a_step():
    it = tdp.lm_batches(1, 2, 8, 50, start_step=3)
    np.testing.assert_array_equal(next(it)["tokens"],
                                  jdp.lm_batch(1, 3, 2, 8, 50)["tokens"])
    np.testing.assert_array_equal(next(it)["tokens"],
                                  jdp.lm_batch(1, 4, 2, 8, 50)["tokens"])


def test_prefetcher_order_and_exception():
    it = tdp.Prefetcher(iter([{"i": 1}, {"i": 2}, {"i": 3}]), depth=2)
    assert [b["i"] for b in it] == [1, 2, 3]

    def bad():
        yield {"i": 1}
        raise ValueError("stream died")

    it = tdp.Prefetcher(bad())
    assert next(it)["i"] == 1
    with pytest.raises(ValueError, match="stream died"):
        next(it)
