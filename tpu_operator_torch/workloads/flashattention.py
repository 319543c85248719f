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
hop it arrived on. Beyond the TPU kernel (which has none of these), K/V
may hold fewer heads than Q (grouped-query attention: query row r reads
K/V row r // group), the causal mask may take a sliding window of W keys,
V may be narrower than Q and K (split widths, as MLA's prefill form and
MiMo-V2-Flash have: keys 192 wide over values 128 wide), each query
row may add a learned sink logit to its softmax's denominator (attention
sinks: a logit with no value), and the softmax scale may be the caller's
(``scale=``, as MLA's YaRN rule sets it) in place of D**-0.5.

``flash_attention_blocks`` launches kernel B2 (``csrc/flash_attention.cu``)
on a CUDA tensor and runs its plain version,
``flash_attention_blocks_reference``, on a CPU tensor. The plain version
repeats the TPU kernel's arithmetic chunk by chunk, in f32. The backward,
``flash_bwd``, launches kernel B3 (``csrc/flash_attention_bwd.cu``) on a
CUDA tensor and runs its plain version, ``flash_bwd_reference`` (the JAX
package's ``_flash_bwd_rule`` in torch ops), on a CPU tensor.

Both kernels read each bf16 operand through its own (bh, row) strides
(``_tma_takes``), and copy only one that no tensor map can take. At B = 1
the fold of ``flash_attention`` is such a view, so no layout copy is made
on either side of B2 or B3.

Under ``torch.profiler`` each entry records a ``tpu_operator_torch.*``
span (``backend.span``): ``flash_attention`` holds ``.fold`` (the
layout change to [BH, S, D]), ``flash_attention_blocks`` (checks, its
``.align``, allocations, its ``.launch``) and ``.unfold``; ``flash_bwd``
covers the backward, with its ``.align`` and its ``.launch``. An
``.align`` holds the rule and the fallback's copies of operands it
refuses.
"""

from __future__ import annotations

import ctypes
import math
import numbers
from typing import Tuple

import torch

from .backend import launch, span

NEG_INF = -1e30

# kernel B2's (q and k width, v width) pairs and input type: one
# instantiation each, (192, 128) the band one alone
KERNEL_HEAD_DIMS = ((64, 64), (128, 128), (192, 128))
# kernel B3's: (192, 128) the band one alone, as B2's; no sink gradient
B3_HEAD_DIMS = ((64, 64), (128, 128), (192, 128))
KERNEL_DTYPE = torch.bfloat16

_SIGNATURES = {
    "flash_attention_fwd_bf16": (ctypes.c_int, (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # q, k, v
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # out, m, l
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,      # bh, sq, sk
        ctypes.c_int64, ctypes.c_int64,                      # d, dv
        ctypes.c_int64, ctypes.c_int64,                      # q/k offset
        ctypes.c_int, ctypes.c_float,                        # causal, scale
        ctypes.c_int64, ctypes.c_int64,                      # group, window
        ctypes.c_void_p,                                     # sinks
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int,        # strides, device
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
        ctypes.c_int64, ctypes.c_int64,                      # d, dv
        ctypes.c_int, ctypes.c_float,                        # causal, scale
        ctypes.c_int64, ctypes.c_int64,                      # group, window
        ctypes.c_void_p,                                     # sinks
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int,        # strides, device
        ctypes.c_void_p)),                                   # stream
}


def _seen(q_pos: torch.Tensor, k_pos: torch.Tensor, window) -> torch.Tensor:
    """The pairs the causal mask leaves visible: k_pos <= q_pos, and under
    a window of W keys also q_pos - W < k_pos."""
    seen = q_pos >= k_pos
    return seen if window is None else seen & (q_pos - k_pos < window)


def _empty_in_layout(t: torch.Tensor, width: int) -> torch.Tensor:
    """A new tensor of ``t``'s shape but for a last dimension ``width``
    wide, its outer dimensions laid out in ``t``'s order: ``empty_like``
    at ``t``'s own width (which keeps a dense view's strides), and its
    rule for a dense tensor at another width. For the fold view [H, S, D]
    of [1, S, H, D], a [H, S, width] view of a contiguous [1, S, H,
    width]."""
    if width == t.shape[-1]:
        return torch.empty_like(t)
    outer = sorted(range(t.dim() - 1), key=lambda i: -t.stride(i))
    x = t.new_empty([t.shape[i] for i in outer] + [width])
    return x.permute([outer.index(i) for i in range(t.dim() - 1)]
                     + [t.dim() - 1])


def flash_attention_blocks_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        q_offset: int, k_offset: int, causal: bool = True,
        q_tile: int = 256, chunk: int = 512, window=None, sinks=None,
        scale=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of ``_flash_kernel``: each Q tile streams K/V chunks
    through the f32 online softmax. Scores are scaled before the mask, so
    ``NEG_INF`` is never scaled; ragged ends take a shorter last tile.
    Query row r reads K/V row r // group, group = q.shape[0] //
    k.shape[0] (the group's rows are adjacent in the b-major fold), and
    a ``window`` of W keys leaves the query at global position i the keys
    j with i - W < j <= i. v may be narrower than q and k; out takes v's
    width. ``sinks`` (f32 [BH]) folds each row's sink logit into its
    denominator after the last chunk: one more column of the softmax,
    with no value. ``scale`` multiplies the scores (None: D**-0.5)."""
    bh, sq, d = q.shape
    bkv, sk = k.shape[:2]
    dv = v.shape[2]
    g = bh // bkv if bkv else 1
    scale = _scale(d, scale)
    out = _empty_in_layout(q, dv)
    m_all = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    l_all = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    for q0 in range(0, sq, q_tile):
        tq = min(q_tile, sq - q0)
        qt = q[:, q0:q0 + tq].float().reshape(bkv, g, tq, d)
        q_pos = q_offset + q0 + torch.arange(tq, device=q.device)[:, None]
        acc = torch.zeros((bkv, g, tq, dv), dtype=torch.float32,
                          device=q.device)
        m = torch.full((bkv, g, tq, 1), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((bkv, g, tq, 1), dtype=torch.float32, device=q.device)
        for k0 in range(0, sk, chunk):
            kc = k[:, k0:k0 + chunk].float()
            vc = v[:, k0:k0 + chunk].float()
            s = torch.einsum("bgqd,bkd->bgqk", qt, kc) * scale
            if causal:
                k_pos = k_offset + k0 + torch.arange(kc.shape[1],
                                                     device=q.device)[None, :]
                s = torch.where(_seen(q_pos, k_pos, window), s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=3, keepdim=True))
            dead = m_new <= NEG_INF / 2
            # fully-masked rows keep exp well-defined
            p = torch.exp(s - torch.where(dead, 0.0, m_new))
            p = torch.where(dead, 0.0, p)
            alpha = torch.where(dead, 0.0, torch.exp(m - m_new))
            l = l * alpha + p.sum(dim=3, keepdim=True)
            acc = acc * alpha + torch.einsum("bgqk,bkd->bgqd", p, vc)
            m = m_new
        if sinks is not None:
            sink = sinks.float().reshape(bkv, g, 1, 1)
            m_new = torch.maximum(m, sink)
            alpha = torch.exp(m - m_new)
            l = l * alpha + torch.exp(sink - m_new)
            acc = acc * alpha
            m = m_new
        o = acc / torch.where(l == 0.0, 1.0, l)
        out[:, q0:q0 + tq] = o.reshape(bh, tq, dv).to(q.dtype)
        m_all[:, q0:q0 + tq] = m.reshape(bh, tq)
        l_all[:, q0:q0 + tq] = l.reshape(bh, tq)
    return out, m_all, l_all


def _scale(d: int, scale) -> float:
    """The softmax scale a call uses: D**-0.5, computed as ``1 /
    sqrt(D)``, where ``scale`` is None, else ``scale`` as a float
    (``_contract`` has refused any other)."""
    return 1.0 / math.sqrt(d) if scale is None else float(scale)


def _scaled(d: int, scale) -> bool:
    """Whether ``scale`` differs from the default D**-0.5 (as ``d **
    -0.5`` or ``1 / sqrt(d)``, which differ in the last bit at some D):
    counted in ``.scaled_calls``."""
    return scale is not None and float(scale) not in (d ** -0.5,
                                                      _scale(d, None))


def _disagree(where: str, why: str, named) -> ValueError:
    return ValueError(f"{where}: shapes disagree: {why}: " + " ".join(
        f"{name}{tuple(t.shape)}" for name, t in named))


def _contract(where: str, q, k, v, rest=(), causal: bool = True,
              window=None, share_dtype: bool = True,
              sinks=None, scale=None) -> Tuple[int, int]:
    """The one contract of kernels B2 and B3 and of their plain versions:
    q [BH, Sq, D], k [BH / group, Sk, D] and v [BH / group, Sk, DV] on one
    CPU or CUDA device; ``rest`` names B3's further tensors (out and dout
    [BH, Sq, DV], m and l [BH, Sq]); on a card, bf16 with (D, DV) in
    ``KERNEL_HEAD_DIMS`` and f32 m and l; a ``window`` is a whole number
    of keys >= 1 under the causal mask; ``sinks`` f32 [BH]; a ``scale``
    None or a finite positive real number. Returns (group, window), the
    window 0 where there is none. It runs on every call, so messages are
    built only to raise."""
    if scale is not None and (
            isinstance(scale, bool) or not isinstance(scale, numbers.Real)
            or not math.isfinite(scale) or scale <= 0):
        raise ValueError(f"{where}: scale must be a finite positive float, "
                         f"got {scale!r:.200}")
    named = (("q", q), ("k", k), ("v", v), *rest)
    for name, t in named:
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"{where}: {name} must be a tensor")
    dev = q.device
    for name, t in named:
        if t.device != dev or dev.type not in ("cpu", "cuda"):
            raise ValueError(f"{where}: unsupported device {t.device} for "
                             f"{name} (q on {dev})")
    qs, ks, vs = q.shape, k.shape, v.shape
    for name, t in named:
        stats = name == "m" or name == "l"
        if t.dim() != (2 if stats else 3):
            raise _disagree(where, f"{name} must be a "
                            f"{'[BH, S]' if stats else '[BH, S, D]'} tensor",
                            named)
        if name in ("out", "dout") and t.shape != qs[:2] + vs[2:] \
                or stats and t.shape != qs[:2]:
            raise _disagree(where, f"{name} must match q's rows and v's "
                            f"width", named)
    if share_dtype and not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"{where}: q, k, v must share device and dtype")
    bh, bkv = qs[0], ks[0]
    if ks[1] != vs[1] or bkv != vs[0] or ks[2] != qs[2] \
            or (bh % bkv if bkv else bh):
        raise _disagree(where, "k and v alike but for v's width, k as wide "
                        "as q, q's BH a multiple of theirs", named)
    if sinks is not None and (
            not isinstance(sinks, torch.Tensor) or sinks.device != dev
            or sinks.dtype != torch.float32 or sinks.shape != (bh,)):
        raise ValueError(f"{where}: sinks must be a float32 [BH] = [{bh}] "
                         f"tensor on q's device, got {sinks!r:.200}")
    if window is not None:
        if isinstance(window, bool) \
                or not isinstance(window, numbers.Integral) or window < 1:
            raise ValueError(f"{where}: window must be a whole number of "
                             f"keys >= 1, got {window!r}")
        if not causal:
            raise ValueError(f"{where}: a window needs the causal mask "
                             f"(causal=False, window={window})")
    if dev.type == "cuda":
        data = [(name, t) for name, t in named if name not in ("m", "l")]
        if any(t.dtype != KERNEL_DTYPE for _, t in data):
            raise ValueError(f"{where}: the kernel takes {KERNEL_DTYPE} "
                             f"{', '.join(n for n, _ in data)} on the card, "
                             f"got {[t.dtype for _, t in data]}")
        if any(t.dtype != torch.float32 for name, t in rest
               if name in ("m", "l")):
            raise ValueError(f"{where}: m and l must be float32")
        if (qs[2], vs[2]) not in KERNEL_HEAD_DIMS:
            raise ValueError(f"{where}: head dims (q/k {qs[2]}, v {vs[2]}) "
                             f"not in {KERNEL_HEAD_DIMS}")
    return (bh // bkv if bkv else 1), (0 if window is None else int(window))


def b2_persistent(window: int) -> bool:
    """Whether kernel B2 takes its persistent schedule for a call with a
    ``window`` of that many keys (0: none), as ``csrc/flash_attention.cu``
    chooses: one block an SM walking the Q tiles, under a window, where
    every tile sees about window / 128 + 1 chunks; one block a tile
    without one, where causal tiles see from 1 to all chunks."""
    return window > 0


def _count(fn, group: int, window: int, split: bool, sink: bool,
           scaled: bool) -> None:
    fn.window_calls += window > 0
    fn.grouped_calls += group > 1
    fn.split_calls += split
    fn.sink_calls += sink
    fn.scaled_calls += scaled


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """The fallback's copy: a new contiguous tensor, whose base the
    allocator puts on a 16-byte boundary (a TMA tensor map's base)."""
    return t.clone(memory_format=torch.contiguous_format)


def _tma_takes(t: torch.Tensor) -> bool:
    """Whether kernels B2 and B3 read or write the bf16 [BH, S, D] tensor
    ``t`` as it is: D's stride 1, its (bh, row) strides positive multiples
    of 8 elements (16 bytes, as a TMA map needs), and its base on a
    16-byte boundary. At B = 1 the fold of [1, S, H, D] is such a view."""
    return t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(
        s > 0 and s % 8 == 0 for s in t.stride()[:-1])


def _tma_operand(t: torch.Tensor, fn) -> torch.Tensor:
    """``t`` where ``_tma_takes`` it as it is, else ``_aligned``'s copy,
    counted in ``fn.copies`` (``fn`` the entry that launches)."""
    if _tma_takes(t):
        return t
    fn.copies += 1
    return _aligned(t)


def _row_strides(*ts: torch.Tensor):
    """The (bh, row) strides of ``ts`` in elements, in order, as the C
    entry points take them."""
    return (ctypes.c_int64 * (2 * len(ts)))(*(
        n for t in ts for n in t.stride()[:2]))


def flash_attention_blocks(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        q_offset: int, k_offset: int, causal: bool = True,
        q_tile: int = 256, chunk: int = 512, window=None, sinks=None,
        scale=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused attend of q against (k, v) with positional causal masking.

    q [BH, Sq, D], k [BH / group, Sk, D] and v [BH / group, Sk, DV]:
    query row r reads K/V row r // group (grouped KV heads, folded
    b-major). Returns (out [BH, Sq, DV], NORMALISED, in q's dtype; m
    [BH, Sq] and l [BH, Sq] in f32) so a ring merge can combine blocks:
    unnormalised partial = out * l. ``q_offset``/``k_offset`` are the
    global positions of element 0, and a ``window`` of W keys (causal
    only) leaves the query at global position i the keys j with i - W < j
    <= i. ``sinks`` (f32 [BH]) adds e^sinks[r] to row r's denominator, a
    logit with no value, once a call: l * e^m = e^sink + sum_j e^s_j, so
    blocks with a sink cannot be merged. ``scale`` multiplies the scores
    before the softmax (None: D**-0.5; else a finite positive float). A
    row that sees no key gives out = 0, l = 0 and m = NEG_INF (with a
    sink, m = sink and l = 1).

    On a CUDA tensor this launches kernel B2 (and counts the launch in
    ``flash_attention_blocks.launches``), which takes bf16 with (D, DV)
    in ``KERNEL_HEAD_DIMS`` and always works in 128-row Q tiles and
    128-key chunks; ``q_tile``/``chunk`` are the plain version's loop
    steps, used on a CPU tensor. B2 reads each of q, k and v through its
    own strides, and copies only one it cannot take (``_tma_takes``),
    counted in ``flash_attention_blocks.copies``; out comes back in q's
    layout at v's width. At B = 1 the fold of ``flash_attention`` is such
    a view, so no copy is made before B2 and out unfolds to a contiguous
    [1, S, H, DV]. Calls with a window, a group above 1, split widths (DV
    < D), sinks and a scale other than D**-0.5 are counted in
    ``.window_calls``, ``.grouped_calls``, ``.split_calls``,
    ``.sink_calls`` and ``.scaled_calls`` on both paths; launches that
    take B2's persistent schedule (``b2_persistent``) in
    ``.persistent_calls``.
    """
    with span("flash_attention_blocks"):
        group, win = _contract("flash_attention_blocks", q, k, v,
                               causal=causal, window=window, sinks=sinks,
                               scale=scale)
        bh, sq, d = q.shape
        dv = v.shape[2]
        _count(flash_attention_blocks, group, win, dv != d,
               sinks is not None, _scaled(d, scale))
        if q.device.type == "cpu":
            return flash_attention_blocks_reference(q, k, v, q_offset,
                                                    k_offset, causal, q_tile,
                                                    chunk, window, sinks,
                                                    scale)
        sk = k.shape[1]
        with span("flash_attention_blocks.align"):
            q, k, v = (_tma_operand(t, flash_attention_blocks)
                       for t in (q, k, v))
            if sinks is not None:
                sinks = sinks.contiguous()
        # in q's layout at v's width
        out = _empty_in_layout(q, dv)
        m = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
        l = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
        if bh == 0 or sq == 0:
            return out, m, l
        with span("flash_attention_blocks.launch"):
            launch("flash_attention", _SIGNATURES, "flash_attention_fwd_bf16",
                   q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   out.data_ptr(), m.data_ptr(), l.data_ptr(),
                   bh, sq, sk, d, dv, int(q_offset), int(k_offset),
                   1 if causal else 0, _scale(d, scale), group, win,
                   None if sinks is None else sinks.data_ptr(),
                   _row_strides(q, k, v, out), q.device.index,
                   what="flash attention kernel")
        flash_attention_blocks.launches += 1
        flash_attention_blocks.persistent_calls += b2_persistent(win)
        return out, m, l


flash_attention_blocks.launches = 0
flash_attention_blocks.window_calls = 0
flash_attention_blocks.grouped_calls = 0
flash_attention_blocks.split_calls = 0
flash_attention_blocks.sink_calls = 0
flash_attention_blocks.scaled_calls = 0
flash_attention_blocks.copies = 0
flash_attention_blocks.persistent_calls = 0


# ---------------------------------------------------------------------------
# the differentiable [B, S, H, D] entry point
# ---------------------------------------------------------------------------
# The forward saves only (out, m, l), the flash residuals, and the
# backward re-materialises the probability tiles one K chunk at a time
# (the standard flash-attention backward recurrence: D = rowsum(dO * O),
# dS = P * (dP - D)), so memory stays O(S*D) end to end.


def flash_bwd_reference(q, k, v, out, m, l, dout, causal: bool,
                        chunk: int = 512, window=None, sinks=None,
                        scale=None):
    """Plain version of kernel B3: the chunked-recompute backward of
    ``_flash_bwd_rule``, in f32, with cotangents cast back to the input
    dtypes. Grouped K/V rows (``flash_attention_blocks_reference``'s
    rule) take dK and dV summed over their group's query rows; dq and dk
    come at q's width, dv at v's. With ``sinks`` the forward's (m, l)
    already hold each row's sink, so P and dS are as without one, and the
    sinks' gradient comes fourth: dsink_r = -sum_i P^sink_i rowsum(dO_i *
    O_i) over row r's queries, P^sink_i = e^(sink_r - m_i) / l_i.
    ``scale`` is the forward's (None: D**-0.5)."""
    bh, sq, d = q.shape
    bkv, sk = k.shape[:2]
    dv_width = v.shape[2]
    g = bh // bkv if bkv else 1
    chunk = min(chunk, sk)
    scale = _scale(d, scale)
    in_dtypes = (q.dtype, k.dtype, v.dtype)
    # compute in f32 like the forward: recomputed P must match the
    # forward's P, not a bf16 quantisation
    q = q.float().reshape(bkv, g, sq, d)
    dout, out = (t.float().reshape(bkv, g, sq, dv_width) for t in (dout, out))
    m = m.reshape(bkv, g, sq)
    l_safe = torch.where(l == 0.0, 1.0, l).reshape(bkv, g, sq)
    delta = (dout * out).sum(dim=-1)                        # [Bkv, G, Sq]
    q_pos = torch.arange(sq, device=q.device)[:, None]
    dead = (m <= NEG_INF / 2)[..., None]
    dq = torch.zeros((bkv, g, sq, d), dtype=torch.float32, device=q.device)
    dk_cs, dv_cs = [], []
    for k0 in range(0, sk, chunk):
        ks = k[:, k0:k0 + chunk].float()
        vs = v[:, k0:k0 + chunk].float()
        s = torch.einsum("bgqd,bkd->bgqk", q, ks) * scale    # [Bkv,G,Sq,C]
        if causal:
            k_pos = k0 + torch.arange(ks.shape[1], device=q.device)[None, :]
            s = torch.where(_seen(q_pos, k_pos, window), s, NEG_INF)
        p = torch.exp(s - m[..., None]) / l_safe[..., None]
        p = torch.where(dead, 0.0, p)
        dv_cs.append(torch.einsum("bgqk,bgqd->bkd", p, dout))
        dp = torch.einsum("bgqd,bkd->bgqk", dout, vs)
        ds = p * (dp - delta[..., None])
        dq += torch.einsum("bgqk,bkd->bgqd", ds, ks) * scale
        dk_cs.append(torch.einsum("bgqk,bgqd->bkd", ds, q) * scale)
    dk = torch.cat(dk_cs, dim=1)
    dv = torch.cat(dv_cs, dim=1)
    grads = tuple(t.to(dt) for t, dt in zip((dq.reshape(bh, sq, d), dk, dv),
                                            in_dtypes))
    if sinks is None:
        return grads
    # a row with a sink has l >= e^(sink - m) > 0, so l_safe is its l
    p_sink = torch.exp(sinks.float().reshape(bkv, g, 1) - m) / l_safe
    return grads + (-(p_sink * delta).sum(dim=-1).reshape(bh),)


def flash_bwd(q, k, v, out, m, l, dout, causal: bool, chunk: int = 512,
              window=None, sinks=None, scale=None):
    """dq, dk, dv of ``flash_attention_blocks(q, k, v, 0, 0, causal,
    window=window, sinks=sinks, scale=scale)`` from its (out, m, l) and
    the upstream gradient ``dout``; dk and dv have k's and v's shape, each
    summed over its group's query rows; with ``sinks``, their gradient
    fourth.

    On a CUDA tensor this launches kernel B3 (and counts the call in
    ``flash_bwd.launches``), which takes bf16 q, k, v, out and dout with
    (D, DV) in ``B3_HEAD_DIMS`` (keys 192 wide over values 128 among
    them) and f32 m and l, and no sinks: sinks raise ValueError there.
    ``chunk`` is the plain version's step over keys, used on a CPU
    tensor, which takes sinks too. B3 reads each of q, k, v, out and dout
    through its own strides, and copies only one it cannot take
    (``_tma_takes``), counted in ``flash_bwd.copies``; dq, dk and dv come
    back in q's, k's and v's layouts. At B = 1 the fold of
    ``flash_attention`` is such a view, so no copy is made before B3 and
    autograd keeps the gradients it hands each leaf. Calls with a window,
    a group above 1, split widths, sinks and a scale other than D**-0.5
    are counted in ``.window_calls``, ``.grouped_calls``,
    ``.split_calls``, ``.sink_calls`` and ``.scaled_calls`` on both
    paths.
    """
    with span("flash_bwd"):
        group, win = _contract(
            "flash_bwd", q, k, v, (("out", out), ("m", m), ("l", l),
                                   ("dout", dout)),
            causal=causal, window=window, share_dtype=False, sinks=sinks,
            scale=scale)
        bh, sq, d = q.shape
        dv_width = v.shape[2]
        _count(flash_bwd, group, win, dv_width != d, sinks is not None,
               _scaled(d, scale))
        if q.device.type == "cpu":
            return flash_bwd_reference(q, k, v, out, m, l, dout, causal,
                                       chunk, window, sinks, scale)
        if (d, dv_width) not in B3_HEAD_DIMS or sinks is not None:
            raise ValueError(
                f"flash_bwd: kernel B3 takes no sinks (no sink gradient) "
                f"and head dims {B3_HEAD_DIMS} on the card; got head dims "
                f"(q/k {d}, v {dv_width}), sinks "
                f"{'given' if sinks is not None else 'none'}")
        sk = k.shape[1]
        if bh == 0 or sq == 0 or sk == 0:
            return tuple(torch.zeros_like(t) for t in (q, k, v))
        with span("flash_bwd.align"):
            q, k, v, out, dout = (_tma_operand(t, flash_bwd)
                                  for t in (q, k, v, out, dout))
            m, l = m.contiguous(), l.contiguous()
        # in the operands' layouts (empty_like keeps a dense view's strides)
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        sq_pad = -(-sq // B3_Q_TILE) * B3_Q_TILE
        stats = torch.empty((2, bh, sq_pad), dtype=torch.float32,
                            device=q.device)
        dq_acc = torch.empty((bh, sq_pad, d), dtype=torch.float32,
                             device=q.device)
        with span("flash_bwd.launch"):
            launch("flash_attention_bwd", _BWD_SIGNATURES,
                   "flash_attention_bwd_bf16", q.device,
                   q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   dout.data_ptr(), m.data_ptr(), l.data_ptr(), dq.data_ptr(),
                   dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
                   dq_acc.data_ptr(), bh, sq, sk, d, dv_width,
                   1 if causal else 0, _scale(d, scale), group, win, None,
                   _row_strides(q, k, v, out, dout, dq, dk, dv),
                   q.device.index,
                   what="flash attention backward kernel")
        flash_bwd.launches += 1
        return dq, dk, dv


flash_bwd.launches = 0
flash_bwd.window_calls = 0
flash_bwd.grouped_calls = 0
flash_bwd.split_calls = 0
flash_bwd.sink_calls = 0
flash_bwd.scaled_calls = 0
flash_bwd.copies = 0


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, sinks, scale):
        out, m, l = flash_attention_blocks(q, k, v, 0, 0, causal=causal,
                                           window=window, sinks=sinks,
                                           scale=scale)
        ctx.save_for_backward(q, k, v, out, m, l, sinks)
        ctx.causal = causal
        ctx.window = window
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, m, l, sinks = ctx.saved_tensors
        grads = flash_bwd(q, k, v, out, m, l, dout, ctx.causal,
                          window=ctx.window, sinks=sinks, scale=ctx.scale)
        return (*grads[:3], None, None,
                grads[3] if sinks is not None else None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window=None,
                    sinks=None, scale=None) -> torch.Tensor:
    """Single-device flash attention, [B, S, H, D] layout (the drop-in for
    ``reference_attention``). k and v may hold fewer heads, [B, S, Hkv, D]
    with H a multiple of Hkv: query head h reads KV head h // (H // Hkv),
    transformers' ``repeat_kv``, without repeating K/V in memory. v may be
    narrower than q and k, [B, S, Hkv, DV]: the output is [B, S, H, DV].
    ``scale`` multiplies the scores before the softmax: None is D**-0.5,
    D the width of q and k; else a finite positive float, such as the
    scale MLA's YaRN rule gives (DeepSeek-V3: 192**-0.5 * mscale**2).
    ``window=W`` (causal only) leaves the query at position i the keys j
    with i - W < j <= i, W keys with itself: transformers' sliding-window
    causal mask. ``sinks`` (f32 [H]) adds head h's learned logit, with no
    value, to each of its rows' softmax as one more column, the form of
    transformers' gpt-oss eager attention. Differentiable: the backward
    pass is ``flash_bwd`` (kernel B3 on the card, which takes split widths
    and any scale but no sinks)."""
    with span("flash_attention"):
        if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
            raise ValueError(f"flash_attention: q, k, v must be [B, S, H, "
                             f"D] tensors, got q{tuple(q.shape)} "
                             f"k{tuple(k.shape)} v{tuple(v.shape)}")
        B, S, H, _ = q.shape
        DV = v.shape[3]
        if sinks is not None and (not isinstance(sinks, torch.Tensor)
                                  or sinks.shape != (H,)):
            raise ValueError(f"flash_attention: sinks must be a [H] = "
                             f"[{H}] tensor, one logit a query head, got "
                             f"{getattr(sinks, 'shape', sinks)!r}")
        fold = lambda t: t.transpose(1, 2).reshape(B * t.shape[2], -1,
                                                   t.shape[3])
        with span("flash_attention.fold"):
            qf, kf, vf = fold(q), fold(k), fold(v)
            # b-major, as the rows: a view at B = 1
            sf = None if sinks is None else sinks.expand(B, -1).reshape(-1)
        out = _FlashAttention.apply(qf, kf, vf, causal, window, sf, scale)
        del qf, kf, vf, sf
        with span("flash_attention.unfold"):
            return out.reshape(B, H, S, DV).transpose(1, 2)
