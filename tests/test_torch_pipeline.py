"""Pipeline parallelism: the port (tpu_operator_torch.workloads.pipeline)
on four gloo ranks against the JAX package's ``pipeline_forward`` under
shard_map on four CPU devices, from JAX's parameters and numpy-seeded
inputs carried across as numpy (``convert.pipeline_params_from_jax``).

One spawn of four ranks (body in tests/torch_parallel_ranks.py) runs
every case. Tolerances: the output 1e-4 abs in f32 (JAX's harness bound);
the gradients of sum(out**2) rtol/atol 1e-3 (JAX's own test,
tests/test_pipeline_moe.py), held to ``jax.grad`` of the sequential
oracle, to which that test holds JAX's pipeline.
"""

import concurrent.futures
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as body
from tpu_operator.parallel.mesh import ring_mesh
from tpu_operator.workloads import pipeline as jax_pp
from tpu_operator_torch import convert
from tpu_operator_torch.parallel import mesh
from tpu_operator_torch.workloads import pipeline

OUT_ATOL = 1e-4
GRAD_TOL = dict(rtol=1e-3, atol=1e-3)
DIMS = body.PIPELINE_DIMS


def jax_params(n_stages=body.WORLD):
    return jax.tree.map(np.asarray, jax_pp.init_stage_params(
        jax.random.PRNGKey(0), n_stages, DIMS["d_model"], DIMS["d_ff"]))


def inputs():
    return {name: body.seeded((batch, DIMS["seq"], DIMS["d_model"]), i)
            for i, (name, (batch, _)) in enumerate(
                body.PIPELINE_CASES.items())}


GRAD_X = body.seeded((8, DIMS["seq"], DIMS["d_model"]), 10)


def _jax_case(params, x, m):
    jmesh = ring_mesh(jax.devices()[:body.WORLD], axis_name="pipe")
    fn = jax.jit(functools.partial(jax_pp.pipeline_forward, mesh=jmesh,
                                   n_microbatches=m))
    return np.asarray(fn(params, jnp.asarray(x)))


def _jax_grads(params):
    def loss(p, x):
        return jnp.sum(jax_pp.reference_forward(p, x) ** 2)

    return jax.tree.map(np.asarray, jax.jit(jax.grad(loss))(params, GRAD_X))


@pytest.fixture(scope="module")
def runs():
    """(per-rank results, JAX's): the four gloo ranks run while JAX
    compiles its side."""
    params, xs = jax_params(), inputs()
    with concurrent.futures.ThreadPoolExecutor(len(xs) + 2) as pool:
        ranks = pool.submit(mesh.spawn, body.pipeline_body, body.WORLD, "cpu",
                            args=(params, xs, GRAD_X), timeout_s=120)
        futures = {name: pool.submit(_jax_case, params, xs[name], m)
                   for name, (_, m) in body.PIPELINE_CASES.items()}
        futures["grads"] = pool.submit(_jax_grads, params)
        want = {name: f.result() for name, f in futures.items()}
        return ranks.result(), want


@pytest.mark.parametrize("name", list(body.PIPELINE_CASES))
def test_forward_matches_jax(runs, name):
    ranks, want = runs
    for r in ranks:  # the output is replicated on every stage
        assert r[name].shape == want[name].shape
        np.testing.assert_allclose(r[name], want[name], rtol=0,
                                   atol=OUT_ATOL)


@pytest.mark.parametrize("key", ["w1", "b1", "w2", "b2"])
def test_stage_gradients_match_jax(runs, key):
    ranks, want = runs
    got = np.stack([r["grads"][key] for r in ranks])
    np.testing.assert_allclose(got, want["grads"][key], err_msg=key,
                               **GRAD_TOL)
    for s in range(body.WORLD):  # every stage gets a real gradient
        assert np.abs(got[s]).max() > 0, f"dead grad: {key}, stage {s}"


def test_run_body_matches_the_oracle(runs):
    ranks = runs[0]
    res = ranks[0]["run_body"].result
    assert res.correct and res.stages == body.WORLD and res.max_abs_err < 1e-4
    assert set(vars(res)) == set(jax_pp.PipelineResult.__dataclass_fields__)
    for r in ranks[1:]:  # only rank 0 holds the oracle
        assert np.isnan(r["run_body"].result.max_abs_err)


@pytest.mark.parametrize("s", [0, 3])
def test_stage_fn_matches_jax(s):
    params = jax_params()
    x = body.seeded((2, DIMS["seq"], DIMS["d_model"]), 20)
    want = np.asarray(jax.jit(jax_pp.stage_fn)(
        jax.tree.map(lambda a: a[s], params), jnp.asarray(x)))
    got = pipeline.stage_fn(convert.pipeline_params_from_jax(params, s, "cpu"),
                            torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_reference_forward_matches_jax():
    params = jax_params()
    x = body.seeded((2, DIMS["seq"], DIMS["d_model"]), 21)
    want = np.asarray(jax.jit(jax_pp.reference_forward)(params,
                                                        jnp.asarray(x)))
    stacked = {k: convert.to_torch(v, "cpu") for k, v in params.items()}
    got = pipeline.reference_forward(stacked, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=OUT_ATOL)


def test_batch_must_divide_microbatches():
    params = convert.pipeline_params_from_jax(jax_params(), 0, "cpu")
    x = torch.zeros((6, DIMS["seq"], DIMS["d_model"]))
    with pytest.raises(ValueError, match="not divisible"):
        pipeline.pipeline_forward(params, x, n_microbatches=4)
    with pytest.raises(ValueError, match="not divisible"):  # before a spawn
        pipeline.run(batch=6, n_microbatches=4, device="cpu", world_size=2)


def test_init_stage_params_follows_the_jax_init():
    got = pipeline.init_stage_params(3, 4, DIMS["d_model"], DIMS["d_ff"],
                                     device="cpu")
    again = pipeline.init_stage_params(3, 4, DIMS["d_model"], DIMS["d_ff"],
                                       device="cpu")
    ref = jax_params()
    for k, w in ref.items():
        assert torch.equal(got[k], again[k]), k
        assert tuple(got[k].shape) == w.shape and got[k].dtype == torch.float32
        # the same scale: std within 15% of JAX's draw's
        assert float(got[k].std()) == pytest.approx(float(np.std(w)),
                                                    rel=0.15, abs=1e-6), k


def test_run_spawns_one_stage_per_rank(monkeypatch):
    calls = []

    def fake(fn, world_size, device_type, args=()):
        calls.append((fn, world_size, device_type, args))
        return [pipeline.CaseReport("result", 0.0, 0.0)] * world_size

    monkeypatch.setattr(pipeline.multihost.mesh, "spawn", fake)
    for k in ("MASTER_ADDR", "GPU_COORDINATOR_ADDRESS"):  # no job to join
        monkeypatch.delenv(k, raising=False)
    assert pipeline.run(batch=16, n_microbatches=8, device="cpu",
                        world_size=4) == "result"
    fn, world_size, device_type, (case,) = calls[0]
    assert (fn, world_size, device_type) == (pipeline.pipeline_rank, 4, "cpu")
    assert case["batch"] == 16 and case["n_microbatches"] == 8
