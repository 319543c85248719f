"""The context-parallel harness on the CPU: ``run``'s per-rank body on two
gloo ranks, f32, both strategies in one spawn, held to the oracle at the
JAX harness's tolerance (1e-4 in f32); ``run`` itself with the spawn
replaced, and ``row_rel_err``."""

import math

import numpy as np
import pytest
import torch

from tpu_operator.workloads import ringattention as jax_ra
from tpu_operator_torch.parallel import mesh
from tpu_operator_torch.workloads import ringattention as ra

SHAPE = dict(seq_len=64, n_heads=4, head_dim=8, batch=2)
WORLD = 2


@pytest.fixture(scope="module")
def reports():
    cases = [dict(strategy=s, **SHAPE) for s in ("ring", "ulysses")]
    return mesh.spawn(ra.context_parallel_rank, WORLD, "cpu", args=(cases,))


@pytest.mark.parametrize("i, strategy", [(0, "ring"), (1, "ulysses")])
def test_run_on_the_cpu_is_correct(reports, i, strategy):
    res, launches, rel = reports[0][i]
    assert res.strategy == strategy and res.devices == WORLD
    assert res.seq_len == SHAPE["seq_len"]
    assert res.correct and res.max_abs_err < 1e-4 and res.seconds > 0
    assert 0 <= rel < 1e-4 and launches == 0
    assert list(vars(res)) == list(
        jax_ra.ContextParallelResult.__dataclass_fields__)
    # only rank 0 holds the gathered output
    assert math.isnan(reports[1][i].result.max_abs_err)
    assert math.isnan(reports[1][i].row_rel_err)


def test_run_spawns_its_one_case(monkeypatch):
    calls = []

    def fake(body, world_size, device_type, args=()):
        calls.append((body, world_size, device_type, args))
        return [[ra.CaseReport("result", 0, 0.0)]] * world_size

    monkeypatch.setattr(ra.mesh, "spawn", fake)
    assert ra.run(strategy="ulysses", device="cpu", world_size=4) == "result"
    assert calls == [(ra.context_parallel_rank, 4, "cpu", ([dict(
        strategy="ulysses", seq_len=2048, n_heads=8, head_dim=64, batch=1,
        causal=True)],))]


def test_run_without_a_device_needs_cuda():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ra.run(seq_len=64, n_heads=4, head_dim=8)


def test_run_rejects_a_sequence_the_ranks_cannot_split():
    # refused before any rank is started
    with pytest.raises(ValueError, match="not divisible by 2 ranks"):
        ra.run(seq_len=63, n_heads=4, head_dim=8, device="cpu", world_size=2)


def test_row_rel_err_is_zero_on_rows_that_vanish_in_both():
    want = torch.zeros((2, 5, 8))
    want[0, 1] = 1.0
    got = want.clone()
    got[0, 1, 3] += 2.0 ** -10
    assert ra.row_rel_err(got, want) == pytest.approx(2.0 ** -10 / 8 ** 0.5)
    got[1, 4, 0] = 1e-6  # a row that should be empty is not
    assert ra.row_rel_err(got, want) > 1e20


def test_row_rel_err_sees_a_dropped_chunk_in_a_late_row():
    # attention over 4096 keys without one 64-key chunk: the output is a
    # few hundredths, but the row moves by about sqrt(64/4096) of itself
    rng = np.random.default_rng(0)
    v = torch.from_numpy(rng.standard_normal((4096, 128), dtype=np.float32))
    want = v.mean(dim=0, keepdim=True)
    got = torch.cat([v[:1024], v[1088:]]).mean(dim=0, keepdim=True)
    assert float(want.abs().max()) < 0.1
    assert ra.row_rel_err(got, want) > 0.05  # the card's limit is 2**-7
