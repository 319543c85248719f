"""HBM triad probe: the port (tpu_operator_torch.workloads.hbm_probe)
against the JAX package's Pallas triad, on the CPU.

On the CPU the port's wrapper runs the kernel's plain version; the CUDA
kernel itself is held to that plain version on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_operator.workloads import pallas_probe
from tpu_operator_torch.convert import to_numpy, to_torch
from tpu_operator_torch.workloads import hbm_probe


def _inputs(seed=0, shape=(256, 512)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape, dtype=np.float32),
            rng.standard_normal(shape, dtype=np.float32))


def test_plain_triad_bit_exact_against_pallas_interpret():
    # the Pallas kernel in interpret mode rounds once (a fused
    # multiply-add), as torch's add_(b, alpha=) does: tolerance 0
    a, b = _inputs()
    want = np.asarray(pallas_probe.triad(jnp.asarray(a), jnp.asarray(b),
                                         alpha=0.37, interpret=True))
    got = hbm_probe.triad_reference_(to_torch(a, "cpu"), to_torch(b, "cpu"),
                                     0.37)
    np.testing.assert_array_equal(to_numpy(got), want)


def test_wrapper_on_cpu_is_plain_version_in_place_and_uncounted():
    a, b = _inputs(seed=1)
    ta, tb = to_torch(a, "cpu"), to_torch(b, "cpu")
    before = hbm_probe.triad_.launches
    out = hbm_probe.triad_(ta, tb, 0.37)
    assert out is ta  # in place over a
    want = np.asarray(pallas_probe.triad(jnp.asarray(a), jnp.asarray(b),
                                         alpha=0.37, interpret=True))
    np.testing.assert_array_equal(to_numpy(ta), want)
    assert hbm_probe.triad_.launches == before == 0


def test_run_matches_jax_run_accounting():
    port = hbm_probe.run(size_mb=2, iters=3, repeats=1, device="cpu")
    ref = pallas_probe.run(size_mb=2.0, iters=3, repeats=1, interpret=True)
    assert port.bytes_moved == ref.bytes_moved == 128 * 4096 * 4 * 3 * 3
    assert port.correct and ref.correct
    assert port.device_kind == "cpu"
    assert port.peak_hbm_gbps is None and port.fraction_of_peak is None
    assert hbm_probe.triad_.launches == 0
    assert set(vars(port)) == set(vars(ref))


def test_run_correctness_probe_catches_a_wrong_triad(monkeypatch):
    monkeypatch.setattr(hbm_probe, "triad_reference_",
                        lambda a, b, alpha: a.add_(b, alpha=alpha * 1.01))
    assert not hbm_probe.run(size_mb=2, iters=3, repeats=1,
                             device="cpu").correct


@pytest.mark.parametrize("case, match", [
    ("dtype", "float32"),
    ("contiguous", "contiguous"),
    ("shape", "shapes differ"),
    ("overlap", "overlaps"),
    ("not_tensor", "must be a tensor"),
])
def test_wrapper_argument_checks_raise(case, match):
    a = torch.zeros(64, 32)
    b = torch.ones(64, 32)
    if case == "dtype":
        b = b.double()
    elif case == "contiguous":
        a = torch.zeros(32, 64).t()
    elif case == "shape":
        b = torch.ones(32, 64)
    elif case == "overlap":
        buf = torch.zeros(64 * 32 + 1)
        a, b = buf[1:].view(64, 32), buf[:-1].view(64, 32)
    elif case == "not_tensor":
        b = np.ones((64, 32), np.float32)
    with pytest.raises(ValueError, match=match):
        hbm_probe.triad_(a, b, 0.5)


def test_default_device_refuses_the_cpu():
    # device=None means the card; here there is none, so the probe
    # raises instead of measuring the CPU
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        hbm_probe.run(size_mb=2, iters=1, repeats=1)
