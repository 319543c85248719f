"""Flash attention: the port (tpu_operator_torch.workloads.flashattention)
against the JAX package's Pallas kernel in interpret mode and its custom
VJP, on the CPU, from the same numpy-seeded inputs.

On the CPU the port's ``flash_attention_blocks`` runs the kernel's plain
version; kernel B2 itself is held to that plain version on the card by
chip_smoke.py.

Tolerances: out 1e-4 abs in f32 (the JAX tests' bound; both sides
compute in f32 in another order), m 1e-5 abs and l 1e-5 relative (row
statistics of the same f32 scores), f32 grads rtol 2e-4 / atol 2e-5 and
bf16 grads rtol 0.05 / atol 0.02, as the JAX tests hold them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_operator.workloads import flashattention as jax_fa
from tpu_operator.workloads.ringattention import (
    reference_attention as jax_reference)
from tpu_operator_torch.convert import to_numpy, to_torch
from tpu_operator_torch.workloads import flashattention as fa
from tpu_operator_torch.workloads.ringattention import reference_attention

OUT_ATOL = 1e-4
M_ATOL = 1e-5
L_RTOL = 1e-5
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
BF16_GRAD_TOL = dict(rtol=0.05, atol=0.02)


def qkv(batch=2, seq=64, heads=2, dim=8, seed=0):
    """[B, S, H, D] float32 q, k, v from one numpy generator."""
    rng = np.random.default_rng(seed)
    shape = (batch, seq, heads, dim)
    return tuple(rng.standard_normal(shape, dtype=np.float32)
                 for _ in range(3))


def fold(x):
    """[B, S, H, D] numpy -> [B*H, S, D]."""
    b, s, h, d = x.shape
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, d))


def both_blocks(q, k, v, q_offset, k_offset, causal=True, **tiles):
    """(port, JAX) (out, m, l) of flash_attention_blocks on [BH, S, D]."""
    port = fa.flash_attention_blocks(
        to_torch(q, "cpu"), to_torch(k, "cpu"), to_torch(v, "cpu"),
        q_offset, k_offset, causal=causal, **tiles)
    ref = jax_fa.flash_attention_blocks(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_offset, k_offset,
        causal=causal, interpret=True, **tiles)
    return [to_numpy(t) for t in port], [np.asarray(t) for t in ref]


def assert_blocks_close(port, ref):
    (o, m, l), (ro, rm, rl) = port, ref
    assert o.shape == ro.shape and m.shape == rm.shape == l.shape
    np.testing.assert_allclose(o, ro, rtol=0, atol=OUT_ATOL)
    np.testing.assert_allclose(m, rm, rtol=0, atol=M_ATOL)
    np.testing.assert_allclose(l, rl, rtol=L_RTOL, atol=0)


class TestBlocks:
    @pytest.mark.parametrize("causal", [True, False])
    def test_matches_jax(self, causal):
        q, k, v = (fold(t) for t in qkv())
        assert_blocks_close(*both_blocks(q, k, v, 0, 0, causal=causal))

    def test_multiple_chunks_and_tiles(self):
        # seq > chunk forces the online softmax through several K/V chunks
        q, k, v = (fold(t) for t in qkv(seq=128))
        port, ref = both_blocks(q, k, v, 0, 0, q_tile=32, chunk=32)
        assert_blocks_close(port, ref)
        oracle = fold(np.asarray(jax_reference(*map(jnp.asarray, qkv(seq=128)))))
        np.testing.assert_allclose(port[0], oracle, rtol=0, atol=OUT_ATOL)

    def test_offsets_match_jax(self):
        # a ring hop's block: queries at 64.., keys at 32.. (partly masked)
        q, k, v = (fold(t) for t in qkv())
        assert_blocks_close(*both_blocks(q, k, v, 64, 32))

    def test_fully_future_block_is_exactly_empty(self):
        # every key after every query: out == 0, l == 0, m == NEG_INF,
        # exactly, on both sides
        q, k, v = (fold(t) for t in qkv(seq=32))
        for o, m, l in both_blocks(q, k, v, 0, 32):
            assert np.all(o == 0.0)
            assert np.all(l == 0.0)
            assert np.all(m == np.float32(fa.NEG_INF))

    @pytest.mark.parametrize("d", [64, 128])
    @pytest.mark.parametrize("sq, sk, q_offset, k_offset, causal", [
        (300, 260, 0, 0, True),        # ragged: no length a multiple of 128
        (300, 260, 0, 0, False),
        (300, 260, 300, 170, True),    # ring offsets off the 128 grid
        (300, 260, 100, 160, True),    # rows 0..59 of a live block see no key
    ])
    def test_kernel_tiles_match_jax(self, sq, sk, q_offset, k_offset, causal,
                                    d):
        # the plain version at kernel B2's tiles (128 query rows, 128-key
        # chunks) against the Pallas kernel in one tile, where those tiles
        # break: ragged ends, offsets that are not multiples of 128 and
        # rows that see no key inside a block that others see
        rng = np.random.default_rng(sq + sk + q_offset + d)
        q, k, v = (rng.standard_normal((2, s, d), dtype=np.float32)
                   for s in (sq, sk, sk))
        port = [to_numpy(t) for t in fa.flash_attention_blocks(
            to_torch(q, "cpu"), to_torch(k, "cpu"), to_torch(v, "cpu"),
            q_offset, k_offset, causal=causal, q_tile=128, chunk=128)]
        ref = [np.asarray(t) for t in jax_fa.flash_attention_blocks(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_offset,
            k_offset, causal=causal, q_tile=sq, chunk=sk, interpret=True)]
        assert_blocks_close(port, ref)
        dead = max(0, k_offset - q_offset) if causal else 0
        for o, m, l in (port, ref):
            assert np.all(o[:, :dead] == 0.0) and np.all(l[:, :dead] == 0.0)
            assert np.all(m[:, :dead] == np.float32(fa.NEG_INF))
            assert np.all(l[:, dead:] > 0.0)

    def test_two_blocks_merge_into_the_whole(self):
        # the ring merge's contract: (out, m, l) of two K halves combine
        # into attention over all of K
        q, k, v = (fold(t) for t in qkv())
        tq, tk, tv = (to_torch(t, "cpu") for t in (q, k, v))
        o1, m1, l1 = fa.flash_attention_blocks(tq, tk[:, :32], tv[:, :32], 0, 0)
        o2, m2, l2 = fa.flash_attention_blocks(tq, tk[:, 32:], tv[:, 32:], 0, 32)
        m_new = torch.maximum(m1, m2)
        dead = m_new <= fa.NEG_INF / 2
        a1 = torch.where(dead, 0.0, torch.exp(m1 - m_new))
        a2 = torch.where(dead, 0.0, torch.exp(m2 - m_new))
        l_new = l1 * a1 + l2 * a2
        merged = (o1 * (l1 * a1)[..., None] + o2 * (l2 * a2)[..., None]) \
            / torch.where(l_new == 0.0, 1.0, l_new)[..., None]
        oracle = fold(np.asarray(jax_reference(*map(jnp.asarray, qkv()))))
        np.testing.assert_allclose(to_numpy(merged), oracle, rtol=0,
                                   atol=OUT_ATOL)

    def test_wrapper_on_cpu_is_plain_version_and_uncounted(self):
        q, k, v = (to_torch(fold(t), "cpu") for t in qkv(seq=32))
        before = fa.flash_attention_blocks.launches
        got = fa.flash_attention_blocks(q, k, v, 0, 0)
        want = fa.flash_attention_blocks_reference(q, k, v, 0, 0)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert fa.flash_attention_blocks.launches == before == 0

    @pytest.mark.parametrize("case, match", [
        ("rank", r"\[BH, S, D\]"),
        ("dtype", "share device and dtype"),
        ("shape", "disagree"),
        ("device", "unsupported device"),
    ])
    def test_argument_checks_raise(self, case, match):
        q = k = v = torch.zeros(2, 16, 8)
        if case == "rank":
            q = torch.zeros(2, 16, 2, 8)
        elif case == "dtype":
            k = k.double()
        elif case == "shape":
            v = torch.zeros(2, 16, 4)
        elif case == "device":
            q = k = v = torch.zeros(2, 16, 8, device="meta")
        with pytest.raises(ValueError, match=match):
            fa.flash_attention_blocks(q, k, v, 0, 0)


class TestFlashAttention:
    @pytest.mark.parametrize("causal", [True, False])
    def test_forward_and_grads_match_jax(self, causal):
        q, k, v = qkv()
        tq, tk, tv = (to_torch(t, "cpu").requires_grad_() for t in (q, k, v))
        out = fa.flash_attention(tq, tk, tv, causal=causal)
        (out ** 2).sum().backward()

        def loss(q, k, v):
            return jnp.sum(jax_fa.flash_attention(q, k, v, causal=causal,
                                                  interpret=True) ** 2)

        jq, jk, jv = map(jnp.asarray, (q, k, v))
        want = jax_fa.flash_attention(jq, jk, jv, causal=causal,
                                      interpret=True)
        np.testing.assert_allclose(to_numpy(out), np.asarray(want), rtol=0,
                                   atol=OUT_ATOL)
        g = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
        for t, want, name in zip((tq, tk, tv), g, "qkv"):
            np.testing.assert_allclose(to_numpy(t.grad), np.asarray(want),
                                       err_msg=f"d{name}", **GRAD_TOL)

    def test_grads_match_autograd_of_the_oracle(self):
        q, k, v = qkv()
        ts = [to_torch(t, "cpu").requires_grad_() for t in (q, k, v)]
        refs = [to_torch(t, "cpu").requires_grad_() for t in (q, k, v)]
        (fa.flash_attention(*ts) ** 2).sum().backward()
        (reference_attention(*refs) ** 2).sum().backward()
        for t, r in zip(ts, refs):
            np.testing.assert_allclose(to_numpy(t.grad), to_numpy(r.grad),
                                       **GRAD_TOL)

    def test_chunked_backward_matches_jax_bwd_rule(self):
        # four K chunks through the recompute, on the same residuals
        q, k, v = (fold(t) for t in qkv(seq=128))
        jq, jk, jv = map(jnp.asarray, (q, k, v))
        out, res = jax_fa._flash_fwd_rule(jq, jk, jv, True, True)
        want = jax_fa._flash_bwd_rule(True, True, res, 2 * out, chunk=32)
        port_res = [to_torch(np.asarray(t), "cpu") for t in res]
        got = fa.flash_bwd(*port_res, 2 * port_res[3], causal=True, chunk=32)
        for a, b in zip(got, want):
            np.testing.assert_allclose(to_numpy(a), np.asarray(b), **GRAD_TOL)

    def test_bf16_inputs_give_bf16_cotangents(self):
        q, k, v = (t.astype(jnp.bfloat16) for t in map(jnp.asarray, qkv(seq=32)))
        ts = [to_torch(np.asarray(t), "cpu").requires_grad_() for t in (q, k, v)]
        fa.flash_attention(*ts).float().sum().backward()

        def loss(q, k, v):
            return jnp.sum(jax_fa.flash_attention(
                q, k, v, interpret=True).astype(jnp.float32))

        g = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
        for t, want in zip(ts, g):
            assert t.grad.dtype == torch.bfloat16
            np.testing.assert_allclose(
                to_numpy(t.grad), np.asarray(want.astype(jnp.float32)),
                **BF16_GRAD_TOL)
