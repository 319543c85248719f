"""Compute proof: the port's matmul chain (tpu_operator_torch.workloads.
matmul) against the JAX package's scan expression, on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from tpu_operator.workloads import matmul as jax_matmul
from tpu_operator_torch.convert import to_numpy, to_torch
from tpu_operator_torch.workloads import matmul

# float32: the same products summed in another order, 1e-5 relative.
# bfloat16: both sides accumulate in float32 and round each of the
# `iters` products to bf16; a different accumulation order can move one
# rounding by one bf16 ulp (2**-8 relative) per product, so 4 products
# give at most about 4 * 2**-8 = 1.6e-2 on O(1) values.
TOLERANCES = {"float32": 1e-5, "bfloat16": 1.6e-2}


def _jax_chain(a, b, iters):
    """matmul.py's scan body (`step` under lax.scan), verbatim."""
    def step(c, _):
        return c @ b, ()

    out, _ = lax.scan(step, a, None, length=iters)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chain_matches_jax_scan(dtype):
    size, iters = 64, 4
    rng = np.random.default_rng(3)
    a = rng.standard_normal((size, size)).astype(np.float32)
    b = rng.standard_normal((size, size)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    ja = jnp.asarray(a, jdt)
    # pre-scaled in the working dtype, as matmul.py:58-60 does
    jb = jnp.asarray(b, jdt) / jnp.sqrt(jnp.float32(size)).astype(jdt)
    want = np.asarray(_jax_chain(ja, jb, iters).astype(jnp.float32))
    got = matmul.chain(to_torch(np.asarray(ja), "cpu"),
                       to_torch(np.asarray(jb), "cpu"), iters)
    assert got.dtype == getattr(torch, dtype)
    tol = TOLERANCES[dtype]
    np.testing.assert_allclose(to_numpy(got), want, rtol=tol, atol=tol)


def test_bf16_prescale_matches_jax():
    # B / bf16(sqrt(N)) in bf16, not a float32 division rounded after
    size = 64
    rng = np.random.default_rng(4)
    b = jnp.asarray(rng.standard_normal((size, size)), jnp.bfloat16)
    want = np.asarray(
        (b / jnp.sqrt(jnp.float32(size)).astype(jnp.bfloat16)).astype(jnp.float32))
    tb = to_torch(np.asarray(b), "cpu")
    scale = torch.tensor(np.sqrt(size), dtype=torch.float32).to(torch.bfloat16)
    np.testing.assert_array_equal(to_numpy(tb / scale), want)
    _, pb = matmul.inputs(size, "cpu", seed=0)
    assert pb.dtype == torch.bfloat16


def test_run_matches_jax_run_accounting():
    kw = dict(size=64, iters=4, calls=2, repeats=1)
    port = matmul.run(device="cpu", **kw)
    ref = jax_matmul.run(**kw)
    assert set(vars(port)) == set(vars(ref))
    for field in ("size", "iters", "calls"):
        assert getattr(port, field) == getattr(ref, field)
    flops = 2.0 * 64 ** 3 * 4 * 2
    for res in (port, ref):
        assert res.tflops * res.seconds * 1e12 == pytest.approx(flops)
        assert res.checksum_ok
        assert res.utilization is None and res.peak_tflops is None
    assert port.device_kind == "cpu"


def test_inputs_are_seeded():
    a1, b1 = matmul.inputs(32, "cpu", seed=7)
    a2, b2 = matmul.inputs(32, "cpu", seed=7)
    a3, _ = matmul.inputs(32, "cpu", seed=8)
    assert torch.equal(a1, a2) and torch.equal(b1, b2)
    assert not torch.equal(a1, a3)


def test_default_device_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        matmul.run(size=8, iters=1, calls=1, repeats=1)
