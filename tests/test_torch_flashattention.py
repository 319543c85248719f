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
from tpu_operator_torch.workloads import attention_reference
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
        assert fa.flash_attention_blocks.copies == 0

    @pytest.mark.parametrize("heads", [16, 4])
    def test_out_in_a_fold_views_layout_unfolds_contiguous(self, heads):
        # B2 writes out with empty_like of the fold view of q: a layout the
        # rule takes, which flash_attention's unfold turns into a
        # contiguous [1, S, H, D] with no copy
        S, D = 32, 64
        x = torch.zeros(1, S, heads, D, dtype=torch.bfloat16)
        out = torch.empty_like(x.transpose(1, 2).reshape(heads, S, D))
        assert fa._tma_takes(out) and out.stride() == (D, heads * D, 1)
        unfolded = out.reshape(1, heads, S, D).transpose(1, 2)
        assert unfolded.is_contiguous()
        assert unfolded.data_ptr() == out.data_ptr()

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
            # v may be narrower than q and k, but k is as wide as q
            k = torch.zeros(2, 16, 4)
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

    @pytest.mark.parametrize("group, window", [(4, 24), (4, None), (1, 24)])
    def test_leaf_grads_at_batch_one_match_the_reference(self, group,
                                                         window):
        # B = 1, where the fold is a view: q, k and v as leaves, k and v
        # over H / group heads, against autograd of the plain f32
        # reference; each leaf's gradient comes back in its own layout
        g = torch.Generator().manual_seed(group * 100 + (window or 0))
        S, H, D = 96, 8, 16
        q, dout = (torch.randn(1, S, H, D, generator=g) for _ in range(2))
        k, v = (torch.randn(1, S, H // group, D, generator=g)
                for _ in range(2))
        xs = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fa.flash_attention(*xs, causal=True, window=window)
        out.backward(dout)
        want = attention_reference.forward_backward(q, k, v, dout, True,
                                                    window)
        np.testing.assert_allclose(to_numpy(out.detach()), to_numpy(want[0]),
                                   rtol=0, atol=OUT_ATOL)
        for x, r, name in zip(xs, want[1:], "qkv"):
            assert x.grad.shape == x.shape and x.grad.is_contiguous(), name
            np.testing.assert_allclose(to_numpy(x.grad), to_numpy(r),
                                       err_msg=f"d{name}", **GRAD_TOL)


class TestBackwardWrapper:
    """``flash_bwd``: the plain version on a CPU tensor (kernel B3 is held
    to it on the card by chip_smoke.py), and its argument checks."""

    @staticmethod
    def residuals(sq=48, sk=40, causal=True, dtype=torch.float32):
        q, k, v = (to_torch(fold(t), "cpu").to(dtype) for t in qkv(seq=sq))
        k, v = k[:, :sk], v[:, :sk]
        out, m, l = fa.flash_attention_blocks(q, k, v, 0, 0, causal=causal)
        dout = torch.from_numpy(np.random.default_rng(1).standard_normal(
            tuple(out.shape), dtype=np.float32)).to(dtype)
        return q, k, v, out, m, l, dout

    @pytest.mark.parametrize("sq, sk, causal, dtype", [
        (48, 40, True, torch.float32),
        (48, 40, False, torch.float32),
        (32, 64, True, torch.bfloat16),
    ])
    def test_on_cpu_is_plain_version_and_uncounted(self, sq, sk, causal,
                                                   dtype):
        res = self.residuals(sq, sk, causal, dtype)
        got = fa.flash_bwd(*res, causal=causal, chunk=16)
        want = fa.flash_bwd_reference(*res, causal=causal, chunk=16)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype == dtype
            assert torch.equal(a, b)
        assert fa.flash_bwd.launches == fa.flash_bwd.copies == 0
        assert fa.flash_attention_blocks.copies == 0

    @staticmethod
    def operand(case):
        """A bf16 [BH, S, D] tensor of each kind the kernels' rule tells
        apart: the fold views are q, k or v of 16 heads, and k or v of 4
        KV heads, at B = 1."""
        B, S, H, D = 1, 32, 16, 64
        if case in ("fold view", "GQA fold view"):
            h = H if case == "fold view" else 4
            x = torch.zeros(B, S, h, D, dtype=torch.bfloat16)
            return x.transpose(1, 2).reshape(B * h, S, D)
        if case == "contiguous":
            return torch.zeros(H, S, D, dtype=torch.bfloat16)
        if case == "last stride":
            return torch.zeros(H, D, S, dtype=torch.bfloat16).transpose(1, 2)
        if case == "row stride":
            return torch.zeros(H, S, D + 1, dtype=torch.bfloat16)[..., :D]
        if case == "size-1 stride":
            # contiguous to torch, whose strides skip a dimension of one
            return torch.zeros(S * D, dtype=torch.bfloat16).as_strided(
                (1, S, D), (7, D, 1))
        assert case == "base"
        flat = torch.zeros(H * S * D + 1, dtype=torch.bfloat16)
        return flat[1:].view(H, S, D)

    RULE_CASES = [("fold view", True), ("GQA fold view", True),
                  ("contiguous", True), ("last stride", False),
                  ("row stride", False), ("size-1 stride", False),
                  ("base", False)]

    # B3's cases keep their ids; B2's, which shares the rule, add theirs
    @pytest.mark.parametrize("entry, case, takes", [
        pytest.param("flash_bwd", case, takes,
                     id=f"{case}-{takes}") for case, takes in RULE_CASES] + [
        pytest.param("flash_attention_blocks", case, takes,
                     id=f"flash_attention_blocks-{case}-{takes}")
        for case, takes in RULE_CASES])
    def test_b3_takes_or_copies(self, entry, case, takes, monkeypatch):
        # which tensors B2's and B3's tensor maps and plain accesses read as
        # they are; the others are copied by the fallback, counted by the
        # entry that launches, and the copy is taken, as are outputs
        # allocated in a taken operand's layout
        entries = (fa.flash_attention_blocks, fa.flash_bwd)
        for fn in entries:
            monkeypatch.setattr(fn, "copies", 0)
        t = self.operand(case)
        assert fa._tma_takes(t) is takes
        got = fa._tma_operand(t, getattr(fa, entry))
        assert (got is t) is takes and torch.equal(got, t)
        assert fa._tma_takes(got) and fa._tma_takes(fa._aligned(t))
        assert [fn.copies for fn in entries] == [
            int(not takes and fn.__name__ == entry) for fn in entries]
        if takes:
            g = torch.empty_like(t)
            assert g.stride() == t.stride() and fa._tma_takes(g)

    @pytest.mark.parametrize("case, match", [
        ("device", "unsupported device"),
        ("mixed device", "unsupported device"),
        ("out", "shapes disagree"),
        ("m", "shapes disagree"),
        ("kv", "shapes disagree"),
        ("rank", "shapes disagree"),
    ])
    def test_argument_checks_raise(self, case, match):
        q, k, v, out, m, l, dout = self.residuals()
        if case == "device":
            q, k, v, out, m, l, dout = (t.to("meta") for t in
                                        (q, k, v, out, m, l, dout))
        elif case == "mixed device":
            dout = dout.to("meta")
        elif case == "out":
            out = out[:, :-1]
        elif case == "m":
            m = m[:, None]
        elif case == "kv":
            v = v[:, :-1]
        elif case == "rank":
            q = q[None]
        with pytest.raises(ValueError, match=match):
            fa.flash_bwd(q, k, v, out, m, l, dout, causal=True)


class TestSplitWidthsAndSinks:
    """Values narrower than keys (MiMo-V2-Flash's 192/128, here 96/64) and
    attention sinks, on the CPU path: the forward and its backward, the
    sinks' gradient included, against autograd of the port's plain f32
    reference (``attention_reference``)."""

    @staticmethod
    def inputs(S=80, H=16, hkv=1, D=96, DV=64, sinks=True, seed=0):
        g = torch.Generator().manual_seed(seed)
        q = torch.randn(1, S, H, D, generator=g)
        k = torch.randn(1, S, hkv, D, generator=g)
        v = torch.randn(1, S, hkv, DV, generator=g)
        dout = torch.randn(1, S, H, DV, generator=g)
        s = torch.rand(H, generator=g) * 4 + 2 if sinks else None
        return q, k, v, dout, s

    @pytest.mark.parametrize("hkv, window, sinks", [
        (1, None, False),    # group 16, the full layer's
        (1, None, True),
        (2, 24, True),       # group 8 under a window, the window layers'
        (2, 24, False),
        (16, 7, True),       # no group
    ])
    def test_forward_and_grads_match_the_reference(self, hkv, window,
                                                   sinks):
        q, k, v, dout, s = self.inputs(hkv=hkv, sinks=sinks,
                                       seed=hkv + (window or 0))
        xs = [t.clone().requires_grad_() for t in (q, k, v)]
        sx = s.clone().requires_grad_() if sinks else None
        out = fa.flash_attention(*xs, causal=True, window=window, sinks=sx)
        out.backward(dout)
        want = attention_reference.forward_backward(q, k, v, dout, True,
                                                    window, s)
        assert out.shape == (1, 80, 16, 64) and out.is_contiguous()
        np.testing.assert_allclose(to_numpy(out.detach()), to_numpy(want[0]),
                                   rtol=0, atol=OUT_ATOL)
        got = xs + ([sx] if sinks else [])
        assert len(want) == 1 + len(got)
        for x, r, name in zip(got, want[1:], ("q", "k", "v", "sinks")):
            assert x.grad.shape == x.shape, name
            np.testing.assert_allclose(to_numpy(x.grad), to_numpy(r),
                                       err_msg=f"d{name}", **GRAD_TOL)

    def test_sinks_fold_into_the_row_statistics(self):
        # l * e^m = e^sink + sum_j e^s_j; a row that sees no key keeps
        # out = 0 and gets m = sink, l = 1
        q, k, v, _, s = self.inputs(S=48, H=4, hkv=2)
        qf, kf, vf = (t[0].transpose(0, 1).contiguous() for t in (q, k, v))
        o, m, l = fa.flash_attention_blocks(qf, kf, vf, 0, 16, sinks=s)
        o0, m0, l0 = fa.flash_attention_blocks(qf, kf, vf, 0, 16)
        live = l0 > 0
        total = torch.exp(m0) * l0 + torch.exp(s)[:, None]
        np.testing.assert_allclose(to_numpy((l * torch.exp(m))[live]),
                                   to_numpy(total[live]), rtol=1e-5)
        assert bool(live[:, 16:].all()) and not bool(live[:, :16].any())
        assert torch.equal(o[:, :16], torch.zeros_like(o[:, :16]))
        assert torch.equal(m[:, :16], s[:, None].expand(4, 16))
        assert torch.equal(l[:, :16], torch.ones_like(l[:, :16]))
        # the sink only rescales each live row: out = out0 * (1 - P_sink)
        keep = (torch.exp(m0) * l0 / total)[..., None]
        np.testing.assert_allclose(to_numpy(o[:, 16:]),
                                   to_numpy((o0 * keep)[:, 16:]),
                                   rtol=0, atol=1e-6)

    def test_counters_on_the_cpu_path(self, monkeypatch):
        for fn in (fa.flash_attention_blocks, fa.flash_bwd):
            for name in ("split_calls", "sink_calls", "launches"):
                monkeypatch.setattr(fn, name, 0)
        q, k, v, dout, s = self.inputs(S=32)
        xs = [t.clone().requires_grad_() for t in (q, k, v)]
        fa.flash_attention(*xs, sinks=s).backward(dout)
        fa.flash_attention(q, k, k).detach()
        for fn in (fa.flash_attention_blocks, fa.flash_bwd):
            assert fn.launches == 0
        assert (fa.flash_attention_blocks.split_calls,
                fa.flash_attention_blocks.sink_calls) == (1, 1)
        assert (fa.flash_bwd.split_calls, fa.flash_bwd.sink_calls) == (1, 1)

    def test_persistent_calls_stay_zero_on_the_cpu_path(self):
        # counted on the card path only: window and full calls on the CPU
        # leave it where it started, at 0
        assert fa.flash_attention_blocks.persistent_calls == 0
        q, k, v, _, s = self.inputs(S=32, hkv=2)
        for window in (None, 24, 1):
            fa.flash_attention(q, k, v, window=window, sinks=s)
        qf, kf, vf = (t[0].transpose(0, 1) for t in (q, k, v))
        fa.flash_attention_blocks(qf, kf, vf, 0, 0, window=8)
        assert fa.flash_attention_blocks.persistent_calls == 0

    @pytest.mark.parametrize("window, persistent", [
        (None, False), (1, True), (128, True), (2048, True), (10 ** 9, True),
    ])
    def test_persistent_rule_is_a_window(self, window, persistent):
        # B2's entry takes the persistent kernel for the band calls with a
        # window (window > 0 after the contract) and for no other call
        q, k, v, _, _ = self.inputs(S=16, H=4, hkv=2)
        qf, kf, vf = (t[0].transpose(0, 1) for t in (q, k, v))
        _, win = fa._contract("b2", qf, kf, vf, window=window)
        assert fa.b2_persistent(win) is persistent

    @pytest.mark.parametrize("heads, width", [(16, 64), (4, 128), (1, 64)])
    def test_out_at_vs_width_unfolds_contiguous(self, heads, width):
        # out in the fold view's layout at v's width: a [H, S, DV] view of
        # a contiguous [1, S, H, DV]
        S, D = 32, 192
        x = torch.zeros(1, S, heads, D, dtype=torch.bfloat16)
        out = fa._empty_in_layout(x.transpose(1, 2).reshape(heads, S, D),
                                  width)
        assert out.shape == (heads, S, width) and fa._tma_takes(out)
        unfolded = out.reshape(1, heads, S, width).transpose(1, 2)
        assert unfolded.is_contiguous()
        assert unfolded.data_ptr() == out.data_ptr()

    @pytest.mark.parametrize("case, match", [
        ("sinks dtype", "sinks must be a float32"),
        ("sinks length", r"sinks must be a \[H\]"),
        ("k width", "disagree"),
        ("dout width", "disagree"),
    ])
    def test_argument_checks_raise(self, case, match):
        q, k, v, dout, s = self.inputs(S=16, H=4, hkv=2)
        if case == "sinks dtype":
            s = s.double()
        elif case == "sinks length":
            s = s[:3]
        elif case == "k width":
            k = k[..., :64]
        with pytest.raises(ValueError, match=match):
            if case == "dout width":
                qf, kf, vf = (t[0].transpose(0, 1).contiguous()
                              for t in (q, k, v))
                o, m, l = fa.flash_attention_blocks(qf, kf, vf, 0, 0)
                fa.flash_bwd(qf, kf, vf, o, m, l, torch.zeros_like(qf),
                             causal=True)
            else:
                fa.flash_attention(q, k, v, sinks=s)
