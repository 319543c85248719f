"""Each plain reference against float64 arithmetic and against the port's
CPU path at small sizes, and each control against its cell's limits."""

import pytest
import torch

from perfbench import compare, controls
from perfbench.reference import allreduce, attention, triad
from perfbench.tests import cpu


def _dense64(q, k, v, causal=True):
    B, S, H, D = q.shape
    q, k, v = (t.double().transpose(1, 2) for t in (q, k, v))
    s = q @ k.transpose(-1, -2) / D ** 0.5
    if causal:
        s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1),
                          float("-inf"))
    return (torch.softmax(s, -1) @ v).transpose(1, 2)


def _inputs(S=48, H=3, D=64, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(1, S, H, D, generator=g).to(torch.bfloat16)
            for _ in range(4)]


@pytest.mark.parametrize("block_elems", [1 << 28, 48 * 7])
def test_attention_reference_against_float64(monkeypatch, block_elems):
    monkeypatch.setattr(attention, "_BLOCK_ELEMS", block_elems)
    q, k, v, g = _inputs()
    q64, k64, v64 = (t.double().requires_grad_(True) for t in (q, k, v))
    o64 = _dense64(q64, k64, v64)
    o64.backward(g.double())
    out, dq, dk, dv = attention.forward_backward(q, k, v, g)
    assert compare.rel(attention.forward(q, k, v), o64.detach()) < 1e-6
    for got, want in ((out, o64), (dq, q64.grad), (dk, k64.grad),
                      (dv, v64.grad)):
        assert compare.rel(got, want.detach()) < 1e-5


def test_attention_reference_against_the_port():
    from tpu_operator_torch.workloads import flashattention as fa

    q, k, v, g = _inputs()
    qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = fa.flash_attention(qs, ks, vs, causal=True)
    out.backward(g)
    want = attention.forward_backward(q, k, v, g)
    for got, w in zip((out, qs.grad, ks.grad, vs.grad), want):
        assert compare.rel(got.detach(), w) < 1e-2


def test_triad_reference_against_the_port():
    from tpu_operator_torch.workloads import hbm_probe

    g = torch.Generator().manual_seed(1)
    a0 = torch.randint(-1024, 1025, (64, 128), generator=g).float()
    b = torch.randint(-8, 9, (64, 128), generator=g).float()
    a = a0.clone()
    for _ in range(300):
        hbm_probe.triad_(a, b, alpha=0.5)
    assert compare.max_abs(a, triad.after(a0, b, 0.5, 300)) == 0.0
    assert compare.max_abs(triad.chain(a0, b, 0.5, 300, torch.float32),
                           triad.after(a0, b, 0.5, 300)) == 0.0


def test_allreduce_reference():
    parts = [torch.tensor([1.0, -3.0, 1024.0]), torch.tensor([2.0, 0.0, 1.0])]
    assert allreduce.mean(parts).tolist() == [1.5, -1.5, 512.5]


@pytest.mark.parametrize("cell", ["attn.prefill-64k", "attn.train-16k",
                                  "proofs.hbm-1card", "proofs.nvlink-4card"])
def test_control_fails_the_limits(cell):
    """One precision below the configuration's, in the program's place,
    is not correct (at the CPU test size)."""
    got = controls.readings(cpu.small_cell(cell), 20261017, "cpu")
    assert any(not value <= limit for value, limit in got.values()), got
