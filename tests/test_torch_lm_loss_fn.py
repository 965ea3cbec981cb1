"""repro_torch's ``loss_fn`` against the reference's on the smoke
configs of all five LMs (the MoE aux loss included), on the CPU: the
value within 1e-5, every gradient within 1e-5 of its leaf's largest
|gradient| (a gradient sums many terms whose fp32 orders differ)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as JT
from repro_torch.configs import get_arch as tget
from repro_torch.models import transformer as TT

from _lm_train_common import ARCHS, MOE, _np, _reference_params, _tokens


# --------------------------------------------------------------------------
# loss_fn on the five smoke configs
# --------------------------------------------------------------------------

def _reference_loss_and_grads(arch: str, tokens: np.ndarray, seq_chunk: int):
    jcfg, tcfg, tree = _reference_params(arch)
    batch = {"tokens": jnp.asarray(tokens)}
    loss, grads = jax.value_and_grad(
        lambda p: JT.loss_fn(p, batch, jcfg, seq_chunk=seq_chunk))(
        jax.tree.map(jnp.asarray, tree))
    _, aux = JT.forward_hidden(jax.tree.map(jnp.asarray, tree),
                               batch["tokens"][:, :-1], jcfg)
    grads = TT.flatten(TT.params_from_reference(
        jax.tree.map(np.asarray, grads), tcfg, device="cpu"))
    return tcfg, tree, float(loss), float(aux), grads


@pytest.mark.parametrize("seq_chunk", (512, 12))
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_reference(arch, seq_chunk):
    """``loss_fn`` and its gradient to every parameter against the
    reference's ``loss_fn`` (seq_chunk 12 does not divide S = 32); for
    the MoE archs the aux loss is in it and equals the reference's."""
    tokens = _tokens(tget(arch).make_smoke_config(), 2)
    tcfg, tree, want, want_aux, wgrads = _reference_loss_and_grads(
        arch, tokens, seq_chunk)
    params = TT.params_from_reference(tree, tcfg, device="cpu",
                                      requires_grad=True)
    batch = {"tokens": torch.from_numpy(tokens)}
    loss = TT.loss_fn(params, batch, tcfg, seq_chunk=seq_chunk)
    leaves = TT.flatten(params)
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    assert float(loss) == pytest.approx(want, rel=1e-5, abs=1e-6)
    for name, g in grads.items():
        w = _np(wgrads[name])
        np.testing.assert_allclose(_np(g), w, rtol=0,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-6),
                                   err_msg=name)
    with torch.no_grad():
        _, aux = TT.forward_hidden(params, batch["tokens"][:, :-1], tcfg,
                                   with_aux=True)
    assert float(aux) == pytest.approx(want_aux, rel=1e-5, abs=1e-7)
    assert (float(aux) > 0) == (arch in MOE)
