"""The yardstick's arithmetic for the backward of attention whose values
are narrower than its keys (MLA's training form: keys 192 wide over
values 128 wide), with grouped KV heads and a sliding window: the model
FLOPs of a backward call, the bytes it needs, and its bound.
``roofline_layers.py``'s backward counts are the case of equal widths.

As there, every count follows from shapes alone: a kernel that reads K/V
once a query head, recomputes the scores, or visits masked pairs, is
still held to what the algorithm needs.
"""

from __future__ import annotations

from typing import Optional, Tuple

from .roofline import Peak
from .roofline_layers import window_pairs


def split_bwd_flops(bh: int, s: int, d_qk: int, d_v: int,
                    window: Optional[int] = None) -> float:
    """Model FLOPs of one causal backward over ``bh`` query heads: five
    products, a multiply-add each a visible pair and dimension. Three at
    the key width (S = Q·Kᵀ again, dK = dSᵀ·Q, dQ = dS·K) and two at the
    value width (dP = dO·Vᵀ, dV = Pᵀ·dO); at equal widths 2.5 times the
    forward, as ``roofline_layers.layer_bwd_flops`` counts it."""
    return 2.0 * bh * window_pairs(s, window) * (3 * d_qk + 2 * d_v)


def split_bwd_bytes(bh: int, bh_kv: int, s: int, d_qk: int,
                    d_v: int) -> int:
    """Bytes of one backward in bf16: q read and dq written at ``bh``
    heads and the key width, out and dout read at ``bh`` and the value
    width, the row statistics m and l read in f32 at ``bh``; k read and
    dk written at ``bh_kv`` heads and the key width, v read and dv written
    at ``bh_kv`` and the value width."""
    return (4 * bh * s * (d_qk + d_v) + 2 * bh * s * 4
            + 4 * bh_kv * s * (d_qk + d_v))


def split_bwd_bound(peak: Peak, bh: int, bh_kv: int, s: int, d_qk: int,
                    d_v: int, window: Optional[int] = None
                    ) -> Tuple[float, str]:
    """(seconds, what bounds it) of one backward call: its operations
    against the bf16 peak or its bytes against the HBM rate, whichever
    takes longer."""
    ops_s = split_bwd_flops(bh, s, d_qk, d_v, window) / peak.bf16_flops
    bytes_s = split_bwd_bytes(bh, bh_kv, s, d_qk, d_v) / peak.hbm_bytes_s
    return (ops_s, "operations") if ops_s >= bytes_s else (bytes_s, "bytes")


def calls_bound(peak: Peak, calls) -> float:
    """Seconds the backward bounds of ``calls`` add up to: each a dict
    with ``bh``, ``bh_kv``, ``seq``, ``d_qk``, ``d_v`` and ``window``
    (None for a full layer), as the ``attention_mla`` generator's facts
    list them."""
    return sum(split_bwd_bound(peak, c["bh"], c["bh_kv"], c["seq"],
                               c["d_qk"], c["d_v"], c["window"])[0]
               for c in calls)
