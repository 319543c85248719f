"""The port's forward entry point (tpu_operator_torch.entry) against the
JAX package's (``__graft_entry__.entry``): JAX's parameters carried across
(``convert.burnin_params_from_jax``) give JAX's logits, at the entry's
configuration in f32 (the burn-in's f32 tolerance) and in its own bf16
(the burn-in's bf16 tolerance), on the entry's zero tokens and on random
ones."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from tpu_operator.workloads import burnin as jax_burnin
from tpu_operator_torch import convert, entry
from tpu_operator_torch.workloads import burnin

# the tolerances of tests/test_torch_burnin.py: f32 sums in other orders;
# bf16 rounds at the same casts, XLA keeping fused chains in f32
F32_RTOL = 1e-5
BF16_LOGITS_ATOL = 2.0 ** -4
BF16_LOGITS_NORM_RTOL = 2.0 ** -6


@pytest.fixture(scope="module")
def jax_side():
    fn, (params, tokens) = jax_entry.entry()
    return fn, jax.tree.map(np.asarray, params), np.asarray(tokens)


def test_entry_shape_and_arguments():
    fn, (model, tokens) = entry.entry(device="cpu")
    cfg = entry.CONFIG
    assert (cfg.vocab, cfg.d_model, cfg.n_heads, cfg.n_layers, cfg.d_ff,
            cfg.seq_len, cfg.batch) == (256, 128, 4, 2, 512, 64, 4)
    assert cfg.dtype == torch.bfloat16
    assert isinstance(model, burnin.BurninLM)
    assert tokens.dtype == torch.int64 and not tokens.any()
    assert tokens.shape == (4, 64) and tokens.device.type == "cpu"
    with torch.no_grad():
        logits = fn(model, tokens)
    assert logits.shape == (4, 64, 256) and logits.dtype == torch.float32
    assert torch.isfinite(logits).all()


def test_entry_is_seeded():
    _, (a, _) = entry.entry(device="cpu")
    _, (b, _) = entry.entry(device="cpu")
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name


def test_entry_refuses_to_fall_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry.entry()


@pytest.mark.parametrize("tokens", ["entry", "random"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_entry_logits_match_jax(jax_side, tokens, dtype):
    jfn, params, jtokens = jax_side
    if tokens == "random":
        rng = np.random.default_rng(1)
        jtokens = rng.integers(0, entry.CONFIG.vocab, jtokens.shape,
                               dtype=np.int32)
    cfg = entry.CONFIG
    if dtype == "f32":
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
        jcfg = jax_burnin.BurninConfig(vocab=256, d_model=128, n_heads=4,
                                       n_layers=2, d_ff=512, seq_len=64,
                                       batch=4, dtype=jnp.float32)
        want = np.asarray(jax.jit(jax_burnin.forward, static_argnums=2)(
            params, jtokens, jcfg))
    else:
        want = np.asarray(jax.jit(jfn)(params, jtokens))
    fn, _ = entry.entry(device="cpu")
    model = convert.burnin_params_from_jax(params, cfg, device="cpu")
    with torch.no_grad():
        got = fn(model, torch.from_numpy(jtokens.astype(np.int64))).numpy()
    assert got.shape == want.shape == (4, 64, 256)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=F32_RTOL,
                                   atol=F32_RTOL * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_LOGITS_ATOL)
        assert np.linalg.norm(got - want) <= \
            BF16_LOGITS_NORM_RTOL * np.linalg.norm(want)
