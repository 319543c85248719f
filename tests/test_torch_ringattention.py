"""Context-parallel attention: the port (tpu_operator_torch.workloads.
ringattention) on four gloo ranks against the JAX package's
``ring_attention``/``ulysses_attention`` under shard_map on four CPU
devices, from the same numpy-seeded inputs.

One spawn of four ranks runs every case; each rank returns its shard of
the output (and of the gradients), and the shards are concatenated along
the sequence. Tolerances: out 1e-4 abs in f32 (the JAX tests' bound),
grads rtol 2e-4 / atol 2e-5.
"""

import concurrent.futures
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tpu_operator.workloads import ringattention as jax_ra
from tpu_operator_torch.parallel import mesh
from tpu_operator_torch.workloads import ringattention as ra
from torch_ring_ranks import CASES, GRAD_INPUTS, WORLD, qkv, rank_cases

OUT_ATOL = 1e-4
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)


def _jax_case(jax_mesh, name):
    inputs, strategy, causal, use_flash = CASES[name]
    if strategy == "ring":
        fn = functools.partial(jax_ra.ring_attention, mesh=jax_mesh,
                               causal=causal, use_flash=use_flash)
    else:
        fn = functools.partial(jax_ra.ulysses_attention, mesh=jax_mesh,
                               causal=causal)
    return np.asarray(jax.jit(fn)(*map(jnp.asarray, inputs)))


def _jax_grads():
    # held to jax.grad of the JAX oracle: JAX's own test holds its ring's
    # gradients to the same (tests/test_ringattention.py), and compiling
    # the gradient of its shard_map ring takes ~20 s on a CPU
    def loss(q, k, v):
        return jnp.sum(jax_ra.reference_attention(q, k, v) ** 2)

    return [np.asarray(g) for g in jax.grad(
        loss, argnums=(0, 1, 2))(*map(jnp.asarray, GRAD_INPUTS))]


def _jax_expected(pool):
    """JAX's outputs of every case and its oracle's gradients, compiled
    on ``pool``'s threads."""
    jax_mesh = Mesh(np.array(jax.devices()[:WORLD]), ("sp",))
    futures = {name: pool.submit(_jax_case, jax_mesh, name) for name in CASES}
    futures["grads"] = pool.submit(_jax_grads)
    want = {name: f.result() for name, f in futures.items()}
    try:
        jax_ra.ulysses_attention(*map(jnp.asarray, qkv(heads=3)),
                                 mesh=jax_mesh)
        want["ulysses_3_heads"] = None
    except ValueError as e:
        want["ulysses_3_heads"] = str(e)
    return want


@pytest.fixture(scope="module")
def runs():
    """(per-rank results, JAX's): the four gloo ranks run while JAX
    compiles its side."""
    with concurrent.futures.ThreadPoolExecutor(len(CASES) + 2) as pool:
        ranks = pool.submit(mesh.spawn, rank_cases, WORLD, "cpu",
                            timeout_s=120)
        want = _jax_expected(pool)
        return ranks.result(), want


def _gathered(ranks, name):
    return np.concatenate([r[name] for r in ranks], axis=1)


@pytest.mark.parametrize("name", list(CASES))
def test_matches_jax(runs, name):
    ranks, want = runs
    got = _gathered(ranks, name)
    assert got.shape == want[name].shape
    np.testing.assert_allclose(got, want[name], rtol=0, atol=OUT_ATOL)


def test_ulysses_rejects_indivisible_heads(runs):
    ranks, want = runs
    assert "not divisible" in want["ulysses_3_heads"]
    for r in ranks:
        assert r["ulysses_3_heads"] == want["ulysses_3_heads"]


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_gradients_match_jax(runs, strategy):
    ranks, want = runs
    for i, name in enumerate("qkv"):
        got = np.concatenate([r[f"{strategy}_grads"][i] for r in ranks],
                             axis=1)
        np.testing.assert_allclose(got, want["grads"][i],
                                   err_msg=f"d{name}", **GRAD_TOL)


def test_flash_ring_is_forward_only(runs):
    for r in runs[0]:
        assert "forward-only" in r["flash_backward"]


def test_run_body_is_correct_for_both_strategies(runs):
    ranks = runs[0]
    res = ranks[0]["run_body"]
    assert [r.strategy for r in res] == ["ring", "ulysses"]
    for r in res:
        assert r.correct and r.devices == WORLD and r.max_abs_err < 1e-4
    for rank in ranks[1:]:  # only rank 0 holds the gathered output
        assert all(np.isnan(r.max_abs_err) for r in rank["run_body"])
    assert set(vars(res[0])) == set(
        jax_ra.ContextParallelResult.__dataclass_fields__)


@pytest.mark.parametrize("causal", [True, False])
def test_reference_attention_matches_jax(causal):
    q, k, v = qkv()
    got = ra.reference_attention(*map(torch.from_numpy, (q, k, v)),
                                 causal=causal).numpy()
    want = np.asarray(jax_ra.reference_attention(*map(jnp.asarray, (q, k, v)),
                                                 causal=causal))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

