"""repro_torch's ``compressed_psum`` over a mesh's slots against the
reference's inside ``shard_map``, on the CPU: the collectives it runs
(``pmax``, ``psum`` of int32 payloads, ``pmean``), forward and backward
against hand-written reductions; then the int8 payloads, the mean and
every slot's new residual at 1 device (in this process) and at 8 forced
host devices (one subprocess), each bit-equal. Bit-equality is the
gate: the scale is a max and a division by 127, the payload a rounding
of one fp32 division, the total an exact int32 sum, the mean one
product and one division, and the residual one product and one
difference, each correctly rounded on both sides. The reference under
``jax.jit`` fuses the residual's product and difference into one
rounding; that residual is held to its own formula instead (derived in
the 8-device test)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from repro.train.compression import _quantize as j_quantize
from repro.train.compression import compressed_psum as j_compressed_psum
from repro_torch.launch import collectives
from repro_torch.train.compression import compressed_psum, shared_payloads

from test_distributed import run_sub


# --------------------------------------------------------------------------
# The collectives, against hand-written reductions
# --------------------------------------------------------------------------

def _slot_tensors(k: int, seed: int = 0, dtype=np.float64) -> list:
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((5, 3)).astype(dtype))
            .requires_grad_(dtype != np.int32) for _ in range(k)]


@pytest.mark.parametrize("k", (1, 2, 3, 8))
def test_pmax_forward_and_backward(k):
    """Every slot holds the elementwise max; the gradient goes to the
    slot that holds it (no ties in these draws)."""
    xs = _slot_tensors(k)
    out = collectives.pmax(xs)
    want = torch.stack([x.detach() for x in xs]).amax(0)
    assert all(torch.equal(o, want) for o in out)
    arg = torch.stack([x.detach() for x in xs]).argmax(0)
    grads = torch.autograd.grad(out[0], xs, torch.ones_like(want))
    for i, g in enumerate(grads):
        assert torch.equal(g, (arg == i).double())


@pytest.mark.parametrize("k", (1, 2, 3, 8))
def test_pmean_forward_and_backward(k):
    """Every slot holds the sum over k; one slot's copy hands each
    input 1/k of its cotangent."""
    xs = _slot_tensors(k, seed=1)
    out = collectives.pmean(xs)
    want = sum(x.detach() for x in xs) / k
    assert all(torch.allclose(o, want, rtol=0, atol=1e-12) for o in out)
    cot = torch.full_like(want, 2.0)
    grads = torch.autograd.grad(out[0], xs, cot)
    assert all(torch.equal(g, cot / k) for g in grads)


@pytest.mark.parametrize("k", (1, 2, 8))
def test_psum_of_int32_payloads_is_exact(k):
    xs = [torch.from_numpy(np.random.default_rng(i).integers(
        -127, 128, (5, 3)).astype(np.int32)) for i in range(k)]
    out = collectives.psum(xs)
    want = torch.from_numpy(np.sum([x.numpy() for x in xs], axis=0,
                                   dtype=np.int32))
    assert all(o.dtype == torch.int32 and torch.equal(o, want) for o in out)


# --------------------------------------------------------------------------
# compressed_psum against the reference's
# --------------------------------------------------------------------------

def _inputs(k: int, seed: int = 7) -> tuple:
    """k slots of three leaves (f32 [64], f32 [3, 5] at other scales, a
    bf16 [16] gradient) and f32 residuals, each slot its own draw."""
    rng = np.random.default_rng(seed)
    grads = {"a": rng.standard_normal((k, 64)).astype(np.float32),
             "b": (rng.standard_normal((k, 3, 5))
                   * np.exp(rng.standard_normal((k, 1, 1)))).astype(
                       np.float32),
             "c": rng.standard_normal((k, 16)).astype(np.float32)}
    res = {n: (0.01 * rng.standard_normal(g.shape)).astype(np.float32)
           for n, g in grads.items()}
    return grads, res


def _port(grads: dict, res: dict, k: int) -> dict:
    """The port's payloads, means and new residuals by leaf, the slots
    stacked on axis 0 (each slot holds its [1, ...] block, as a
    ``shard_map`` shard does)."""
    def slot(tree, j, n):
        t = torch.from_numpy(tree[n][j:j + 1])
        return t.to(torch.bfloat16) if n == "c" and tree is grads else t
    g = [{n: slot(grads, j, n) for n in grads} for j in range(k)]
    r = [{n: slot(res, j, n) for n in res} for j in range(k)]
    payloads, _, _ = shared_payloads(g, r)
    means, new_res = compressed_psum(g, r)
    return {n: {"payload": np.concatenate([p[n].numpy() for p in payloads]),
                "mean": np.concatenate([m[n].float().numpy() for m in means]),
                "residual": np.concatenate([x[n].numpy() for x in new_res])}
            for n in grads}


def _reference_local(gl, rl):
    """One shard's (mean, new residual, payload), the payload quantized
    with the reference's own ``_quantize`` at the pmax-shared scale."""
    gl = {**gl, "c": gl["c"].astype(jnp.bfloat16)}
    mean, new_res = j_compressed_psum(gl, rl, "d")

    def payload(g, r):
        gf = g.astype(jnp.float32) + r
        return j_quantize(gf, jax.lax.pmax(jnp.max(jnp.abs(gf)) / 127.0,
                                           "d"))
    pay = jax.tree.map(payload, gl, rl)
    return ({n: m.astype(jnp.float32) for n, m in mean.items()}, new_res,
            pay)


def _assert_bit_equal(got: dict, want: dict) -> None:
    for n in got:
        for part in ("payload", "mean", "residual"):
            w = np.asarray(want[n][part], got[n][part].dtype)
            assert got[n][part].shape == w.shape, (n, part)
            assert np.array_equal(got[n][part], w), (n, part, float(
                np.abs(got[n][part].astype(np.float64) - w).max()))


def test_compressed_psum_equals_reference_on_one_device():
    grads, res = _inputs(1)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("d",))
    mean, new_res, pay = shard_map(
        _reference_local, mesh=mesh, in_specs=(P("d"), P("d")),
        out_specs=(P("d"), P("d"), P("d")), check_rep=False)(
        jax.tree.map(jnp.asarray, grads), jax.tree.map(jnp.asarray, res))
    want = {n: {"payload": np.asarray(pay[n]), "mean": np.asarray(mean[n]),
                "residual": np.asarray(new_res[n])} for n in grads}
    got = _port(grads, res, 1)
    _assert_bit_equal(got, want)
    assert got["a"]["payload"].dtype == np.int8
    assert np.abs(got["a"]["payload"]).max() == 127


_REFERENCE_8 = """
    import json
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P
    from repro.train.compression import _quantize, compressed_psum

    assert len(jax.devices()) == 8
    mesh = jax.sharding.Mesh(np.array(jax.devices()), ("d",))
    data = np.load(PATH)
    grads = {n[2:]: jnp.asarray(data[n]) for n in data.files
             if n.startswith("g.")}
    res = {n[2:]: jnp.asarray(data[n]) for n in data.files
           if n.startswith("r.")}

    def local(gl, rl):
        gl = {**gl, "c": gl["c"].astype(jnp.bfloat16)}
        mean, new_res = compressed_psum(gl, rl, "d")

        def payload(g, r):
            gf = g.astype(jnp.float32) + r
            return _quantize(gf, jax.lax.pmax(jnp.max(jnp.abs(gf)) / 127.0,
                                              "d"))
        pay = jax.tree.map(payload, gl, rl)
        return ({n: m.astype(jnp.float32) for n, m in mean.items()},
                new_res, pay)
    f = shard_map(local, mesh=mesh, in_specs=(P("d"), P("d")),
                  out_specs=(P("d"), P("d"), P("d")), check_rep=False)
    out = {}
    for how, fn in (("eager", f), ("jit", jax.jit(f))):
        mean, new_res, pay = fn(grads, res)
        out[how] = {n: {"payload": np.asarray(pay[n]).tolist(),
                        "mean": np.asarray(mean[n]).tolist(),
                        "residual": np.asarray(new_res[n]).tolist()}
                    for n in grads}
    print("REF_CPSUM_8 " + json.dumps(out))
"""


def test_compressed_psum_equals_reference_on_8_host_devices(tmp_path):
    """The reference's ``compressed_psum`` on 8 forced host devices
    against the port's 8 slots. Run shard by shard, as the reference's
    own multi-device test runs it: every shard's payloads, mean and new
    residuals bit-equal. Under ``jax.jit`` the payloads and means are
    bit-equal too, but XLA contracts the residual ``gf - q * scale`` into
    one fused multiply-add (one rounding where the source has two): the
    jitted residual is bit-equal to ``fl(gf - q s)`` rounded once (exact
    in float64: q s has at most 32 significant bits and lies within s/2
    of gf), the port's to ``fl(gf - fl(q s))``, as written, and the two
    differ by at most half an ulp of ``q s``. The slots' scales differ
    (leaf ``b`` draws a scale a slot), so the shared scale is a real
    max."""
    grads, res = _inputs(8)
    path = tmp_path / "cpsum.npz"
    np.savez(path, **{f"g.{n}": g for n, g in grads.items()},
             **{f"r.{n}": r for n, r in res.items()})
    out = run_sub(f"    PATH = {str(path)!r}\n" + _REFERENCE_8)
    line = [ln for ln in out.splitlines() if ln.startswith("REF_CPSUM_8 ")]
    want = json.loads(line[0][len("REF_CPSUM_8 "):])
    got = _port(grads, res, 8)
    _assert_bit_equal(got, want["eager"])
    for n in grads:
        for part in ("payload", "mean"):
            assert np.array_equal(got[n][part], np.asarray(
                want["jit"][n][part], got[n][part].dtype)), (n, part)
        g = grads[n]
        if n == "c":
            g = torch.from_numpy(g).to(torch.bfloat16).float().numpy()
        gf = g + res[n]
        scale = np.abs(gf.reshape(8, -1)).max(1).max() / np.float32(127.0)
        q = got[n]["payload"].astype(np.float32)
        fused = (gf.astype(np.float64) - q.astype(np.float64)
                 * np.float64(scale)).astype(np.float32)
        jitted = np.asarray(want["jit"][n]["residual"], np.float32)
        assert np.array_equal(jitted, fused), n
        assert np.array_equal(got[n]["residual"], gf - q * scale), n
        assert np.all(np.abs(got[n]["residual"] - jitted)
                      <= np.spacing(np.abs(q * scale)) / 2), n
    scales = np.abs(grads["b"] + res["b"]).reshape(8, -1).max(1)
    assert scales.max() > 2 * scales.min()
    # the mean is within half the shared scale of the exact mean
    exact = (grads["a"] + res["a"]).mean(0)
    step = np.abs(grads["a"] + res["a"]).max() / 127.0
    assert np.abs(got["a"]["mean"] - exact).max() <= 0.5 * step + 1e-6
