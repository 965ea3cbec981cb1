"""repro_torch's LM training against the reference's, on the CPU:
remat, ``model_flops_per_token``, a carried reference TrainState, the
train cells and the launcher. The blocked attention and the losses are
in ``test_torch_lm_attention.py``, ``loss_fn`` in
``test_torch_lm_loss_fn.py``, whole AdamW steps in
``test_torch_lm_train_steps*.py`` (shared helpers:
``_lm_train_common.py``)."""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget
from repro.models import transformer as JT
from repro.train import train_state as jts
from repro.train.optimizer import AdamWConfig as JAdamWConfig, \
    adamw as jadamw
from repro_torch.configs import get_arch as tget
from repro_torch.launch import steps
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as TT
from repro_torch.train.optimizer import AdamWConfig, adamw, named

from _lm_train_common import ARCHS, _reference_params, _tokens
from _threads import one_thread  # noqa: F401  (the launchers' small ops)


@pytest.mark.parametrize("arch", ("gemma2-2b", "minicpm3-4b",
                                  "phi3.5-moe-42b-a6.6b"))
def test_remat_gives_equal_gradients(arch):
    """``remat`` on (each block under checkpoint) and off give the same
    loss and gradients, bit for bit: the recompute runs the same ops on
    the same inputs."""
    _, tcfg, tree = _reference_params(arch)
    batch = {"tokens": torch.from_numpy(_tokens(tcfg, 2))}
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        params = TT.params_from_reference(tree, cfg, device="cpu",
                                          requires_grad=True)
        loss = TT.loss_fn(params, batch, cfg)
        leaves = list(TT.flatten(params).values())
        out.append((loss, torch.autograd.grad(loss, leaves)))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_remat_recomputes_each_block(monkeypatch):
    """With remat each layer runs twice in a forward and backward (the
    forward, then the checkpoint's recompute), once without."""
    _, tcfg, tree = _reference_params("gemma2-2b")
    batch = {"tokens": torch.from_numpy(_tokens(tcfg, 2))}
    calls = []
    real = TT._layer_apply

    def spy(*a, **kw):
        calls.append(True)
        return real(*a, **kw)

    monkeypatch.setattr(TT, "_layer_apply", spy)
    for remat, want in ((False, 4), (True, 8)):
        calls.clear()
        cfg = dataclasses.replace(tcfg, remat=remat)
        params = TT.params_from_reference(tree, cfg, device="cpu",
                                          requires_grad=True)
        loss = TT.loss_fn(params, batch, cfg)
        torch.autograd.grad(loss, list(TT.flatten(params).values()))
        assert len(calls) == want, remat


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_per_token_matches_reference(arch):
    want = JT.model_flops_per_token(jget(arch).make_config())
    assert TT.model_flops_per_token(tget(arch).make_config()) == want



def test_state_from_reference_carries_every_bit():
    """grok-1's state: f32 params and bf16 moments, every leaf the
    reference's bits; a moment dtype other than the optimizer's is
    refused."""
    jcfg, tcfg, tree = _reference_params("grok-1-314b")
    jopt = jadamw(JAdamWConfig(moment_dtype=jnp.bfloat16))
    start = jax.tree.map(np.asarray, jts.create(
        jax.tree.map(jnp.asarray, tree), jopt))
    rng = np.random.default_rng(2)
    for key in ("m", "v"):
        start["opt"][key] = jax.tree.map(
            lambda a: np.asarray(jnp.asarray(rng.standard_normal(a.shape),
                                             jnp.bfloat16)), start["opt"][key])
    start["step"] = np.int32(7)
    opt = adamw(AdamWConfig(moment_dtype=torch.bfloat16))
    state = TT.state_from_reference(start, tcfg, opt, device="cpu")
    assert all(p.requires_grad for p in named(state["params"]).values())
    assert int(state["step"]) == 7 and state["step"].dtype == torch.int32
    for key in ("m", "v"):
        want = TT.flatten(TT._unstacked(start["opt"][key], tcfg,
                                        torch.device("cpu")))
        got = state["opt"][key]
        assert got.keys() == want.keys()
        for n, t in got.items():
            assert t.dtype == torch.bfloat16 and torch.equal(t, want[n])
    with pytest.raises(ValueError, match=r"opt.m.embed is .*bfloat16, the optimizer makes .*float32"):
        TT.state_from_reference(start, tcfg, adamw(AdamWConfig()),
                                device="cpu")


# --------------------------------------------------------------------------
# Cells and the launcher
# --------------------------------------------------------------------------

TRAIN_SPECS = {  # arch: (padded vocab, accumulation steps), the reference's
    "gemma2-2b": (256_000, 4),
    "qwen2.5-32b": (152_064, 16),
    "minicpm3-4b": (73_472, 4),
    "grok-1-314b": (131_072, 16),
    "phi3.5-moe-42b-a6.6b": (32_256, 4),
}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cell_builds_without_allocating(arch, monkeypatch):
    """``build_cell(arch, "train_4k")`` on the full config: the state's
    specs (params as ``param_specs``, m and v in the moment dtype, the
    router float32 unless the moments are bf16), the batch spec, the
    step's accumulation (grok-1 sums its 16 microbatches in bf16), and
    no parameter, state or tensor made on the way."""
    made, built = [], []
    for name in ("zeros", "empty", "full", "randn"):
        real = getattr(torch, name)
        monkeypatch.setattr(torch, name, lambda *a, _r=real, **k: (
            made.append(a), _r(*a, **k))[1])
    make_step = steps.train_state.make_train_step
    monkeypatch.setattr(steps.train_state, "make_train_step",
                        lambda *a, **k: (built.append(k),
                                         make_step(*a, **k))[1])
    cell = steps.build_cell(arch, "train_4k", device="cpu")
    assert made == []
    cfg = tget(arch).make_config()
    rows, accum = TRAIN_SPECS[arch]
    state, bspec = cell.args
    assert (cell.kind, bspec) == ("train", {"tokens": ((256, 4097),
                                                       torch.int32)})
    assert state["params"] == TT.param_specs(cfg)
    assert state["params"]["embed"][0] == (cfg.padded_vocab, cfg.d_model)
    assert cfg.padded_vocab == rows
    mom = getattr(tget(arch), "MOMENT_DTYPE", None)
    for n, (shape, dt) in state["opt"]["m"].items():
        assert shape == state["params"][n][0]
        assert dt == (mom or state["params"][n][1])
    assert state["opt"]["m"] == state["opt"]["v"]
    assert state["step"] == ((), torch.int32)
    assert built == [{"accum_steps": accum, "accum_dtype": mom}]
    assert cfg.remat and not tget(arch).make_smoke_config().remat
    assert callable(cell.init_state)


def test_launcher_trains_gemma2_and_recovers(tmp_path, capsys):
    """``launch.train --arch gemma2-2b --steps 30 --fail-at 15 --device
    cpu``: returns 0 after one restart (from step 0: the first
    checkpoint would be at 25), the loss falls."""
    rc = launch_train.main(["--arch", "gemma2-2b", "--steps", "30",
                            "--fail-at", "15", "--device", "cpu",
                            "--ckpt", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert rc == 0
    m = re.search(r"45 steps, 1 restarts, loss ([\d.]+) -> ([\d.]+)", out)
    assert m, out
    assert float(m.group(2)) < float(m.group(1))
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "step_00000025", "step_00000030"]


@pytest.mark.parametrize("arch", ARCHS[1:])
def test_launcher_trains_every_lm(arch, capsys):
    assert launch_train.main(["--arch", arch, "--steps", "4", "--device",
                              "cpu"]) == 0
    assert re.search(rf"\[train\] {re.escape(arch)} on cpu: 4 steps, 0 "
                     r"restarts", capsys.readouterr().out)
