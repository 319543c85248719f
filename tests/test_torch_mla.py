"""MLA's attention core on the port: ``flash_attention`` with ``scale=``
at keys 192 wide over values 128 wide, the key assembled from a per-head
k_nope and one rope key k_pe that every head shares (DeepSeek-V3's
training form), against the plain float32 reference of the benchmark
(``perfbench/reference/attention_mla.py``), on the CPU.

Beyond the JAX package, whose kernel has neither a scale argument nor
split widths: the port's ``scale=`` is held to that plain reference, and
an omitted scale to the port's own D**-0.5 bit for bit.

Tolerances: f32 in and out on both sides, computed in another order
(the port's plain version chunk by chunk with an online softmax, the
reference by blocks of rows): out 1e-4 abs, gradients rtol 2e-4 / atol
2e-5, as ``test_torch_flashattention.py`` holds f32.
"""

import math

import numpy as np
import pytest
import torch

from perfbench.generators import attention_mla
from perfbench.reference import attention_mla as mla_reference
from tpu_operator_torch.convert import to_numpy
from tpu_operator_torch.workloads import flashattention as fa

OUT_ATOL = 1e-4
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
# DeepSeek-V3's config: qk_nope_head_dim, qk_rope_head_dim, v_head_dim,
# rope_scaling
DSV3 = {"qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "v_head_dim": 128,
        "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40,
                         "mscale": 1, "mscale_all_dim": 1,
                         "original_max_position_embeddings": 4096,
                         "type": "yarn"}}


def inputs(S=160, H=4, seed=0, dtype=torch.float32):
    """q [1, S, H, 192], k_nope [1, S, H, 128], k_pe [1, S, 1, 64], v and
    dout [1, S, H, 128], numpy-seeded."""
    rng = np.random.default_rng(seed)
    shapes = ((1, S, H, 192), (1, S, H, 128), (1, S, 1, 64), (1, S, H, 128),
              (1, S, H, 128))
    return [torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
            .to(dtype) for s in shapes]


def mla(q, k_nope, k_pe, v, scale):
    """The layer as the benchmark's generator runs it: k assembled under
    autograd, then the port's entry point."""
    k = torch.cat([k_nope, k_pe.expand(-1, -1, q.shape[2], -1)], dim=-1)
    return fa.flash_attention(q, k, v, causal=True, scale=scale)


def test_yarn_scale_from_the_catalog_numbers():
    # DeepSeek's rule: 192**-0.5 * (0.1 * ln 40 + 1)**2
    scale = attention_mla.softmax_scale(DSV3)
    assert scale == pytest.approx(0.1352338, abs=1e-7)
    assert attention_mla.yarn_mscale(40, 1) == pytest.approx(1.3688879,
                                                             abs=1e-7)
    assert scale / 192 ** -0.5 == pytest.approx(1.8738542, abs=1e-7)


def test_mla_forward_and_every_gradient_match_the_reference():
    q, k_nope, k_pe, v, dout = inputs()
    scale = attention_mla.softmax_scale(DSV3)
    leaves = [t.clone().requires_grad_() for t in (q, k_nope, k_pe, v)]
    out = mla(*leaves, scale)
    out.backward(dout)
    want = mla_reference.forward_backward(q, k_nope, k_pe, v, dout, scale)
    assert out.shape == (1, 160, 4, 128) and out.is_contiguous()
    np.testing.assert_allclose(to_numpy(out.detach()), to_numpy(want[0]),
                               rtol=0, atol=OUT_ATOL)
    for x, r, name in zip(leaves, want[1:], ("q", "k_nope", "k_pe", "v")):
        assert x.grad.shape == x.shape, name
        np.testing.assert_allclose(to_numpy(x.grad), to_numpy(r),
                                   err_msg=f"d{name}", **GRAD_TOL)
    # the shared key's gradient is the head sum of the rope columns
    assert leaves[2].grad.shape == (1, 160, 1, 64)
    assert float(want[3].abs().max()) > 0


def test_omitted_scale_is_bit_identical_to_d_to_the_minus_half():
    """Both entries and the backward, at split widths and at equal ones,
    in bf16 and f32."""
    for dtype in (torch.bfloat16, torch.float32):
        q, k_nope, k_pe, v, dout = inputs(S=96, dtype=dtype)
        k = torch.cat([k_nope, k_pe.expand(-1, -1, 4, -1)], dim=-1)
        for kk, vv in ((k, v), (k[..., :128].contiguous(), v)):
            d = kk.shape[-1]
            runs = []
            for kw in ({}, {"scale": d ** -0.5}):
                xs = [t.clone().requires_grad_() for t in (q[..., :d], kk,
                                                            vv)]
                o = fa.flash_attention(*xs, causal=True, **kw)
                o.backward(dout)
                runs.append([o.detach()] + [x.grad for x in xs])
            for a, b in zip(*runs):
                assert torch.equal(a, b)
            qf, kf, vf = (t[0].transpose(0, 1).contiguous()
                          for t in (q[..., :d], kk, vv))
            blocks = [fa.flash_attention_blocks(qf, kf, vf, 0, 0, **kw)
                      for kw in ({}, {"scale": d ** -0.5})]
            for a, b in zip(*blocks):
                assert torch.equal(a, b)


def test_scale_moves_the_answer():
    q, k_nope, k_pe, v, _ = inputs(S=64)
    a = mla(q, k_nope, k_pe, v, None)
    b = mla(q, k_nope, k_pe, v, attention_mla.softmax_scale(DSV3))
    assert not torch.allclose(a, b, atol=1e-2)


def test_scaled_calls_count_on_both_entries(monkeypatch):
    for fn in (fa.flash_attention_blocks, fa.flash_bwd):
        for name in ("scaled_calls", "split_calls", "launches"):
            monkeypatch.setattr(fn, name, 0)
    q, k_nope, k_pe, v, dout = inputs(S=64)
    leaves = [t.clone().requires_grad_() for t in (q, k_nope, k_pe, v)]
    mla(*leaves, attention_mla.softmax_scale(DSV3)).backward(dout)
    # D**-0.5 given, or none: not counted
    mla(q, k_nope, k_pe, v, 192 ** -0.5)
    mla(q, k_nope, k_pe, v, None)
    qf, kf, vf = (t[0].transpose(0, 1).contiguous()
                  for t in (q[..., :128], k_nope, v))
    o, m, l = fa.flash_attention_blocks(qf, kf, vf, 0, 0, scale=0.5)
    fa.flash_bwd(qf, kf, vf, o, m, l, torch.ones_like(o), True, scale=0.5)
    assert fa.flash_attention_blocks.scaled_calls == 2
    assert fa.flash_bwd.scaled_calls == 2
    assert fa.flash_attention_blocks.split_calls == 3
    assert fa.flash_bwd.split_calls == 1
    for fn in (fa.flash_attention_blocks, fa.flash_bwd):
        assert fn.launches == 0


@pytest.mark.parametrize("scale", [0.0, -0.1, math.inf, math.nan, True,
                                   "0.1", None.__class__, 1j])
def test_a_scale_that_is_not_a_finite_positive_float_is_refused(scale):
    q, k_nope, k_pe, v, dout = inputs(S=16)
    with pytest.raises(ValueError, match="scale must be a finite positive"):
        mla(q, k_nope, k_pe, v, scale)
    qf, kf, vf = (t[0].transpose(0, 1).contiguous()
                  for t in (q[..., :128], k_nope, v))
    with pytest.raises(ValueError, match="flash_attention_blocks: scale"):
        fa.flash_attention_blocks(qf, kf, vf, 0, 0, scale=scale)
    o, m, l = fa.flash_attention_blocks(qf, kf, vf, 0, 0)
    with pytest.raises(ValueError, match="flash_bwd: scale"):
        fa.flash_bwd(qf, kf, vf, o, m, l, torch.ones_like(o), True,
                     scale=scale)
