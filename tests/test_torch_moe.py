"""Expert parallelism: the port (tpu_operator_torch.workloads.moe) on four
gloo ranks against the JAX package's ``moe_forward`` under shard_map on
four CPU devices, from JAX's parameters and numpy-seeded tokens carried
across as numpy (``convert.moe_params_from_jax``).

One spawn of four ranks (body in tests/torch_parallel_ranks.py) runs
every case. Tolerances are JAX's own (tests/test_pipeline_moe.py): the
output 1e-4 abs in f32; the gradients of sum(out**2) rtol 1e-4 / atol
1e-5, held to ``jax.grad`` of the oracle, to which that test holds JAX's
sharded layer.
"""

import concurrent.futures
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_parallel_ranks as body
from tpu_operator.parallel.mesh import ring_mesh
from tpu_operator.workloads import moe as jax_moe
from tpu_operator_torch import convert
from tpu_operator_torch.workloads import moe
from tpu_operator_torch.parallel import mesh

OUT_ATOL = 1e-4
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
DIMS = body.MOE_DIMS


def jax_params():
    return jax.tree.map(np.asarray, jax_moe.init_moe_params(
        jax.random.PRNGKey(0), body.WORLD, DIMS["d_model"], DIMS["d_ff"]))


def inputs():
    return {name: body.seeded((body.WORLD * b, DIMS["d_model"]), i)
            for i, (name, (b, _)) in enumerate(body.MOE_CASES.items())}


GRAD_X = body.seeded((body.WORLD * 8, DIMS["d_model"]), 10)


def _jax_case(params, x, cap):
    jmesh = ring_mesh(jax.devices()[:body.WORLD], axis_name="expert")
    sp = jax.device_put(params, {
        "router": NamedSharding(jmesh, P()),
        "w1": NamedSharding(jmesh, P("expert")),
        "w2": NamedSharding(jmesh, P("expert"))})
    xs = jax.device_put(jnp.asarray(x), NamedSharding(jmesh, P("expert")))
    out = jax.jit(functools.partial(jax_moe.moe_forward, mesh=jmesh,
                                    capacity=cap))(sp, xs)
    oracle = jax.jit(jax_moe.reference_moe, static_argnums=(2, 3))(
        params, jnp.asarray(x), body.WORLD, cap)
    return np.asarray(out), np.asarray(oracle)


def _jax_grads(params):
    def loss(p, x):
        return jnp.sum(jax_moe.reference_moe(p, x, body.WORLD, 8) ** 2)

    return jax.tree.map(np.asarray, jax.jit(jax.grad(loss))(params, GRAD_X))


@pytest.fixture(scope="module")
def runs():
    """(per-rank results, JAX's): the four gloo ranks run while JAX
    compiles its side."""
    params, xs = jax_params(), inputs()
    with concurrent.futures.ThreadPoolExecutor(len(xs) + 2) as pool:
        ranks = pool.submit(mesh.spawn, body.moe_body, body.WORLD, "cpu",
                            args=(params, xs, GRAD_X), timeout_s=120)
        futures = {name: pool.submit(_jax_case, params, xs[name], cap)
                   for name, (_, cap) in body.MOE_CASES.items()}
        futures["grads"] = pool.submit(_jax_grads, params)
        want = {name: f.result() for name, f in futures.items()}
        return ranks.result(), want


@pytest.mark.parametrize("name", list(body.MOE_CASES))
def test_forward_matches_jax(runs, name):
    ranks, want = runs
    got = np.concatenate([r[name] for r in ranks])
    out, oracle = want[name]
    assert got.shape == out.shape
    np.testing.assert_allclose(got, out, rtol=0, atol=OUT_ATOL)
    np.testing.assert_allclose(got, oracle, rtol=0, atol=OUT_ATOL)


def test_capacity_2_drops_tokens_as_jax_does(runs):
    ranks, want = runs
    got = np.concatenate([r["capacity_2"] for r in ranks])
    dropped = np.all(want["capacity_2"][1] == 0.0, axis=-1)
    assert dropped.mean() > 0.0, "capacity=2 must actually drop tokens"
    # the same tokens dropped: exactly the oracle's zero rows are zero
    np.testing.assert_array_equal(np.all(got == 0.0, axis=-1), dropped)


@pytest.mark.parametrize("key", ["router", "w1", "w2"])
def test_gradients_match_jax(runs, key):
    ranks, want = runs
    if key == "router":
        # replicated: every rank holds JAX's sum over the devices
        for r in ranks:
            np.testing.assert_allclose(r["grads"][key], want["grads"][key],
                                       err_msg=key, **GRAD_TOL)
        got = ranks[0]["grads"][key]
    else:
        got = np.stack([r["grads"][key] for r in ranks])
        np.testing.assert_allclose(got, want["grads"][key], err_msg=key,
                                   **GRAD_TOL)
    assert np.abs(got).max() > 0, f"dead grad: {key}"


def test_run_body_matches_the_oracle(runs):
    ranks = runs[0]
    res = ranks[0]["run_body"].result
    assert res.correct and res.experts == body.WORLD
    assert res.tokens == 16 * body.WORLD and res.capacity == 16
    assert res.dropped_fraction == 0.0 and res.max_abs_err < 1e-4
    assert set(vars(res)) == set(jax_moe.MoEResult.__dataclass_fields__)
    for r in ranks[1:]:  # only rank 0 holds the oracle
        assert np.isnan(r["run_body"].result.max_abs_err)


@pytest.mark.parametrize("capacity", [0, 2, 5])
def test_route_matches_jax(capacity):
    params = jax_params()
    x = body.seeded((12, DIMS["d_model"]), 30)
    want = [np.asarray(a) for a in jax_moe._route(
        jnp.asarray(x), params["router"], body.WORLD, capacity)]
    got = [a.numpy() for a in moe._route(
        torch.from_numpy(x), convert.to_torch(params["router"], "cpu"),
        body.WORLD, capacity)]
    for g, w in zip(got, want):  # combine, dispatch
        assert g.shape == w.shape == (12, body.WORLD, capacity)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


def test_reference_moe_matches_jax():
    params = jax_params()
    x = GRAD_X
    want = np.asarray(jax.jit(jax_moe.reference_moe, static_argnums=(2, 3))(
        params, jnp.asarray(x), body.WORLD, 3))
    tparams = {k: convert.to_torch(v, "cpu") for k, v in params.items()}
    got = moe.reference_moe(tparams, torch.from_numpy(x), body.WORLD,
                            3).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=OUT_ATOL)


def test_router_spreads_tokens_over_experts():
    """A collapsed router would make the exchange test vacuous."""
    params = moe.init_moe_params(0, 8, 16, 32, device="cpu")
    x = torch.from_numpy(body.seeded((64, 16), 31))
    experts = set((x @ params["router"]).argmax(dim=-1).tolist())
    assert len(experts) > 2


def test_run_spawns_one_expert_per_rank(monkeypatch):
    calls = []

    def fake(fn, world_size, device_type, args=()):
        calls.append((fn, world_size, device_type, args))
        return [moe.CaseReport("result", 0.0, 0.0)] * world_size

    monkeypatch.setattr(moe.multihost.mesh, "spawn", fake)
    for k in ("MASTER_ADDR", "GPU_COORDINATOR_ADDRESS"):  # no job to join
        monkeypatch.delenv(k, raising=False)
    assert moe.run(tokens_per_expert=8, device="cpu", world_size=4) == "result"
    fn, world_size, device_type, (case,) = calls[0]
    assert (fn, world_size, device_type) == (moe.moe_rank, 4, "cpu")
    assert case["tokens_per_expert"] == 8
