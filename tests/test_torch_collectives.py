"""Interconnect proof: the port's collective suite (gloo, two spawned
ranks) against the JAX package's ``_step_fn`` under shard_map on two CPU
devices, on the same routing-revealing input."""

import time
from functools import partial

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from tpu_operator.parallel.mesh import ring_mesh, shard_map
from tpu_operator.workloads import collectives as jax_collectives
from tpu_operator_torch.parallel import mesh
from tpu_operator_torch.workloads import collectives

OPS = list(collectives._BUS_FACTOR)
WORLD = 2


def _jax_outputs(op, n):
    """Each device's output of JAX's one-shot step on the oracle input
    (the apply_once of collectives._oracle_ok)."""
    one = jax_collectives._step_fn(op, n)
    x = collectives.oracle_input(n)
    k = x.shape[1]

    @jax.jit
    @partial(shard_map, mesh=ring_mesh(jax.devices()[:n]),
             in_specs=P("ring", None), out_specs=P("ring", None))
    def apply_once(shard):
        return one(shard.reshape(-1)).reshape(1, k)

    return np.asarray(apply_once(x))


def _rank_probe(rank, world_size, device, ops):
    """One spawn does it all: every op once on the oracle input, the
    all-reduce step's storage, then the timed suite at a tiny size."""
    c = torch.full((8 * world_size,), float(rank + 1))
    ptr = c.data_ptr()
    out = collectives._step("all_reduce", c, world_size, rank)
    return {
        "oracle": {op: collectives.oracle_outputs(op, device) for op in ops},
        "all_reduce_in_place": (out.data_ptr() == ptr, out is c,
                                out.numpy().copy()),
        "suite": collectives.measure_suite(device, size_mb=0.01, iters=2,
                                           repeats=1, ops=ops),
    }


def _raise(rank, world_size, device):
    raise ValueError("rank failure on purpose")


def _hang(rank, world_size, device):
    time.sleep(120)


@pytest.fixture(scope="module")
def gloo_ranks():
    return mesh.spawn(_rank_probe, WORLD, "cpu", args=(OPS,), timeout_s=120)


@pytest.mark.parametrize("n", range(1, 9))
def test_bus_factor_matches_jax(n):
    # at n=1 all_reduce's factor is 0, as in JAX: reported, never gated
    assert set(collectives._BUS_FACTOR) == set(jax_collectives._BUS_FACTOR)
    for op, f in collectives._BUS_FACTOR.items():
        assert f(n) == jax_collectives._BUS_FACTOR[op](n)


@pytest.mark.parametrize("op", OPS)
def test_each_rank_matches_jax_step(gloo_ranks, op):
    # small integers averaged over two ranks are exact in float32: the
    # outputs must be equal, not close
    want = _jax_outputs(op, WORLD)
    for rank, res in enumerate(gloo_ranks):
        np.testing.assert_array_equal(res["oracle"][op], want[rank])
    np.testing.assert_array_equal(collectives.oracle_want(op, WORLD), want)


def test_all_reduce_step_makes_no_copy(gloo_ranks):
    """JAX's step is ``psum(c) * (1/n)`` with no rebuild inside the timed
    loop: the port's all-reduce step reduces and scales its input in
    place and returns that same storage (the mean of 1 and 2 is 1.5)."""
    for res in gloo_ranks:
        same_ptr, same_tensor, values = res["all_reduce_in_place"]
        assert same_ptr and same_tensor
        np.testing.assert_array_equal(values, np.full(8 * WORLD, 1.5,
                                                      np.float32))


@pytest.mark.parametrize("op", OPS)
def test_timed_suite_over_gloo(gloo_ranks, op):
    res = gloo_ranks[0]["suite"][op]
    assert res.op == op and res.correct and res.devices == WORLD
    # per-rank k rounded down to a multiple of n*n, as collectives.py:189
    k = int(0.01 * 1e6 / 4) // (WORLD * WORLD) * WORLD * WORLD
    assert res.bytes_per_device == k * 4
    assert res.bus_bw_gbps == pytest.approx(
        collectives._BUS_FACTOR[op](WORLD) * res.algo_bw_gbps)
    assert res.device_kind == "cpu" and res.fraction_of_peak is None


def test_spawn_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank failure on purpose"):
        mesh.spawn(_raise, 1, "cpu", timeout_s=60)


def test_spawn_times_out_a_hung_rank():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="still running"):
        mesh.spawn(_hang, 1, "cpu", timeout_s=3)
    assert time.monotonic() - t0 < 60


def test_default_device_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        collectives.run_suite(size_mb=0.01, world_size=1)
