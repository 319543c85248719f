"""Flash attention: the long-context hot op as a hand-written CUDA kernel.

Counterpart of ``tpu_operator/workloads/flashattention.py``. Plain
attention materialises the [Sq, Sk] score matrix in device memory; flash
attention keeps it on chip by tiling Q and streaming K/V chunks through
an online softmax (running max ``m`` + normaliser ``l``), so memory
traffic stays O(S*D) instead of O(S^2). It is the local-block engine of
the context-parallel path (``workloads/ringattention.py``): each ring
hop's (Q-block, KV-block) attend runs here, and the block's (m, l)
statistics are exactly what the ring merge needs.

Layout [BH, S, D]. Causal masking is positional (runtime global offsets)
because in ring attention a K block's global position depends on which
hop it arrived on.

``flash_attention_blocks`` launches kernel B2 (``csrc/flash_attention.cu``)
on a CUDA tensor and runs its plain version,
``flash_attention_blocks_reference``, on a CPU tensor. The plain version
repeats the TPU kernel's arithmetic chunk by chunk, in f32. The backward,
``flash_bwd``, launches kernel B3 (``csrc/flash_attention_bwd.cu``) on a
CUDA tensor and runs its plain version, ``flash_bwd_reference`` (the JAX
package's ``_flash_bwd_rule`` in torch ops), on a CPU tensor.

Under ``torch.profiler`` each entry records a ``tpu_operator_torch.*``
span (``backend.span``): ``flash_attention`` holds ``.fold`` (the
layout change to [BH, S, D]), ``flash_attention_blocks`` (checks, its
``.align`` copies, allocations, its ``.launch``) and ``.unfold``;
``flash_bwd`` covers the backward.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from ..kernels import build
from .backend import span

NEG_INF = -1e30

# kernel B2's head widths and input type (one instantiation each)
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_DTYPE = torch.bfloat16

_SIGNATURES = {
    "flash_attention_fwd_bf16": (ctypes.c_int, (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # q, k, v
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # out, m, l
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,      # bh, sq, sk
        ctypes.c_int64,                                      # d
        ctypes.c_int64, ctypes.c_int64,                      # q/k offset
        ctypes.c_int, ctypes.c_float,                        # causal, scale
        ctypes.c_void_p)),                                   # stream
}

# kernel B3's query tile: its row statistics and dQ accumulator are
# padded to whole tiles (kBlockQ in csrc/flash_attention_bwd.cu)
B3_Q_TILE = 64

_BWD_SIGNATURES = {
    "flash_attention_bwd_bf16": (ctypes.c_int, (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # q, k, v
        ctypes.c_void_p, ctypes.c_void_p,                    # out, dout
        ctypes.c_void_p, ctypes.c_void_p,                    # m, l
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # dq, dk, dv
        ctypes.c_void_p, ctypes.c_void_p,                    # stats, dq_acc
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,      # bh, sq, sk
        ctypes.c_int64,                                      # d
        ctypes.c_int, ctypes.c_float,                        # causal, scale
        ctypes.c_void_p)),                                   # stream
}


def flash_attention_blocks_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        q_offset: int, k_offset: int, causal: bool = True,
        q_tile: int = 256, chunk: int = 512,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of ``_flash_kernel``: each Q tile streams K/V chunks
    through the f32 online softmax. Scores are scaled before the mask, so
    ``NEG_INF`` is never scaled; ragged ends take a shorter last tile."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    m_all = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    l_all = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    for q0 in range(0, sq, q_tile):
        qt = q[:, q0:q0 + q_tile].float()
        tq = qt.shape[1]
        q_pos = q_offset + q0 + torch.arange(tq, device=q.device)[:, None]
        acc = torch.zeros((bh, tq, d), dtype=torch.float32, device=q.device)
        m = torch.full((bh, tq, 1), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((bh, tq, 1), dtype=torch.float32, device=q.device)
        for k0 in range(0, sk, chunk):
            kc = k[:, k0:k0 + chunk].float()
            vc = v[:, k0:k0 + chunk].float()
            s = torch.einsum("bqd,bkd->bqk", qt, kc) * scale
            if causal:
                k_pos = k_offset + k0 + torch.arange(kc.shape[1],
                                                     device=q.device)[None, :]
                s = torch.where(q_pos >= k_pos, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=2, keepdim=True))
            dead = m_new <= NEG_INF / 2
            # fully-masked rows keep exp well-defined
            p = torch.exp(s - torch.where(dead, 0.0, m_new))
            p = torch.where(dead, 0.0, p)
            alpha = torch.where(dead, 0.0, torch.exp(m - m_new))
            l = l * alpha + p.sum(dim=2, keepdim=True)
            acc = acc * alpha + torch.einsum("bqk,bkd->bqd", p, vc)
            m = m_new
        out[:, q0:q0 + tq] = (acc / torch.where(l == 0.0, 1.0, l)).to(q.dtype)
        m_all[:, q0:q0 + tq] = m[..., 0]
        l_all[:, q0:q0 + tq] = l[..., 0]
    return out, m_all, l_all


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.dim() != 3:
            raise ValueError(f"flash_attention_blocks: {name} must be a "
                             f"[BH, S, D] tensor")
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError("flash_attention_blocks: q, k, v must share "
                             "device and dtype")
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"flash_attention_blocks: unsupported device "
                             f"{t.device}")
    if k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[2] != q.shape[2]:
        raise ValueError(f"flash_attention_blocks: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} disagree")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, on a 16-byte boundary (a TMA tensor map's base)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention_blocks(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        q_offset: int, k_offset: int, causal: bool = True,
        q_tile: int = 256, chunk: int = 512,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused attend of q against (k, v) with positional causal masking.

    q, k, v: [BH, S, D]. Returns (out [BH, Sq, D], NORMALISED, in q's
    dtype; m [BH, Sq] and l [BH, Sq] in f32) so a ring merge can combine
    blocks: unnormalised partial = out * l. ``q_offset``/``k_offset`` are
    the global positions of element 0. A row that sees no key gives
    out = 0, l = 0 and m = NEG_INF.

    On a CUDA tensor this launches kernel B2 (and counts the launch in
    ``flash_attention_blocks.launches``), which takes bf16 with D in
    ``KERNEL_HEAD_DIMS`` and always works in 128-row Q tiles and 128-key
    chunks; ``q_tile``/``chunk`` are the plain version's loop steps, used
    on a CPU tensor.
    """
    with span("flash_attention_blocks"):
        _check(q, k, v)
        if q.device.type == "cpu":
            return flash_attention_blocks_reference(q, k, v, q_offset,
                                                    k_offset, causal, q_tile,
                                                    chunk)
        bh, sq, d = q.shape
        sk = k.shape[1]
        if q.dtype != KERNEL_DTYPE:
            raise ValueError(f"flash_attention_blocks: the kernel takes "
                             f"{KERNEL_DTYPE} on the card, got {q.dtype}")
        if d not in KERNEL_HEAD_DIMS:
            raise ValueError(f"flash_attention_blocks: head dim {d} not in "
                             f"{KERNEL_HEAD_DIMS}")
        # at B == 1 the fold is a view, and these are its copies
        with span("flash_attention_blocks.align"):
            q, k, v = _aligned(q), _aligned(k), _aligned(v)
        out = torch.empty_like(q)
        m = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
        l = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
        if bh == 0 or sq == 0:
            return out, m, l
        lib = build.load("flash_attention", _SIGNATURES)
        with span("flash_attention_blocks.launch"), \
                torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = lib.flash_attention_fwd_bf16(
                q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), m.data_ptr(), l.data_ptr(),
                bh, sq, sk, d, int(q_offset), int(k_offset),
                1 if causal else 0, 1.0 / math.sqrt(d), stream)
        if err != 0:
            raise RuntimeError(f"flash attention kernel launch failed: "
                               f"cudaError {err}")
        flash_attention_blocks.launches += 1
        return out, m, l


flash_attention_blocks.launches = 0


# ---------------------------------------------------------------------------
# the differentiable [B, S, H, D] entry point
# ---------------------------------------------------------------------------
# The forward saves only (out, m, l), the flash residuals, and the
# backward re-materialises the probability tiles one K chunk at a time
# (the standard flash-attention backward recurrence: D = rowsum(dO * O),
# dS = P * (dP - D)), so memory stays O(S*D) end to end.


def flash_bwd_reference(q, k, v, out, m, l, dout, causal: bool,
                        chunk: int = 512):
    """Plain version of kernel B3: the chunked-recompute backward of
    ``_flash_bwd_rule``, in f32, with cotangents cast back to the input
    dtypes."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    chunk = min(chunk, sk)
    scale = 1.0 / math.sqrt(d)
    l_safe = torch.where(l == 0.0, 1.0, l)
    in_dtypes = (q.dtype, k.dtype, v.dtype)
    # compute in f32 like the forward: recomputed P must match the
    # forward's P, not a bf16 quantisation
    q = q.float()
    dout = dout.float()
    out = out.float()
    delta = (dout * out).sum(dim=-1)                           # [BH, Sq]
    q_pos = torch.arange(sq, device=q.device)[:, None]
    dead = (m <= NEG_INF / 2)[..., None]
    dq = torch.zeros((bh, sq, d), dtype=torch.float32, device=q.device)
    dk_cs, dv_cs = [], []
    for k0 in range(0, sk, chunk):
        ks = k[:, k0:k0 + chunk].float()
        vs = v[:, k0:k0 + chunk].float()
        s = torch.einsum("bqd,bkd->bqk", q, ks) * scale         # [BH,Sq,C]
        if causal:
            k_pos = k0 + torch.arange(ks.shape[1],
                                      device=q.device)[None, :]
            s = torch.where(q_pos >= k_pos, s, NEG_INF)
        p = torch.exp(s - m[..., None]) / l_safe[..., None]
        p = torch.where(dead, 0.0, p)
        dv_cs.append(torch.einsum("bqk,bqd->bkd", p, dout))
        dp = torch.einsum("bqd,bkd->bqk", dout, vs)
        ds = p * (dp - delta[..., None])
        dq += torch.einsum("bqk,bkd->bqd", ds, ks) * scale
        dk_cs.append(torch.einsum("bqk,bqd->bkd", ds, q) * scale)
    dk = torch.cat(dk_cs, dim=1)
    dv = torch.cat(dv_cs, dim=1)
    return tuple(t.to(dt) for t, dt in zip((dq, dk, dv), in_dtypes))


def _check_bwd(q, k, v, out, m, l, dout) -> None:
    named = (("q", q), ("k", k), ("v", v), ("out", out), ("m", m),
             ("l", l), ("dout", dout))
    for name, t in named:
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"flash_bwd: {name} must be a tensor")
        if t.device.type not in ("cpu", "cuda") or t.device != q.device:
            raise ValueError(f"flash_bwd: unsupported device {t.device} "
                             f"for {name} (q on {q.device})")
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2] \
            or out.shape != q.shape or dout.shape != q.shape \
            or m.shape != q.shape[:2] or l.shape != q.shape[:2]:
        raise ValueError(
            "flash_bwd: shapes disagree: " + " ".join(
                f"{name}{tuple(t.shape)}" for name, t in named))


def flash_bwd(q, k, v, out, m, l, dout, causal: bool, chunk: int = 512):
    """dq, dk, dv of ``flash_attention_blocks(q, k, v, 0, 0, causal)`` from
    its (out, m, l) and the upstream gradient ``dout``.

    On a CUDA tensor this launches kernel B3 (and counts the call in
    ``flash_bwd.launches``), which takes bf16 q, k, v, out and dout with D
    in ``KERNEL_HEAD_DIMS`` and f32 m and l; ``chunk`` is the plain
    version's step over keys, used on a CPU tensor.
    """
    with span("flash_bwd"):
        _check_bwd(q, k, v, out, m, l, dout)
        if q.device.type == "cpu":
            return flash_bwd_reference(q, k, v, out, m, l, dout, causal,
                                       chunk)
        bh, sq, d = q.shape
        sk = k.shape[1]
        if any(t.dtype != KERNEL_DTYPE for t in (q, k, v, out, dout)):
            raise ValueError(f"flash_bwd: the kernel takes {KERNEL_DTYPE} "
                             f"q, k, v, out and dout on the card, got "
                             f"{[t.dtype for t in (q, k, v, out, dout)]}")
        if m.dtype != torch.float32 or l.dtype != torch.float32:
            raise ValueError("flash_bwd: m and l must be float32")
        if d not in KERNEL_HEAD_DIMS:
            raise ValueError(f"flash_bwd: head dim {d} not in "
                             f"{KERNEL_HEAD_DIMS}")
        q, k, v, out, dout = (_aligned(t) for t in (q, k, v, out, dout))
        m, l = m.contiguous(), l.contiguous()
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        if bh == 0 or sq == 0 or sk == 0:
            return dq.zero_(), dk.zero_(), dv.zero_()
        sq_pad = -(-sq // B3_Q_TILE) * B3_Q_TILE
        stats = torch.empty((2, bh, sq_pad), dtype=torch.float32,
                            device=q.device)
        dq_acc = torch.empty((bh, sq_pad, d), dtype=torch.float32,
                             device=q.device)
        lib = build.load("flash_attention_bwd", _BWD_SIGNATURES)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = lib.flash_attention_bwd_bf16(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                dout.data_ptr(), m.data_ptr(), l.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
                dq_acc.data_ptr(), bh, sq, sk, d, 1 if causal else 0,
                1.0 / math.sqrt(d), stream)
        if err != 0:
            raise RuntimeError(f"flash attention backward kernel launch "
                               f"failed: cudaError {err}")
        flash_bwd.launches += 1
        return dq, dk, dv


flash_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, m, l = flash_attention_blocks(q, k, v, 0, 0, causal=causal)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, m, l = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, m, l, dout, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Single-device flash attention, [B, S, H, D] layout (the drop-in for
    ``reference_attention``). Differentiable: the backward pass is
    ``flash_bwd`` (kernel B3 on the card)."""
    with span("flash_attention"):
        B, S, H, D = q.shape
        fold = lambda t: t.transpose(1, 2).reshape(B * H, -1, D)
        with span("flash_attention.fold"):
            qf, kf, vf = fold(q), fold(k), fold(v)
        out = _FlashAttention.apply(qf, kf, vf, causal)
        del qf, kf, vf
        with span("flash_attention.unfold"):
            return out.reshape(B, H, S, D).transpose(1, 2)
