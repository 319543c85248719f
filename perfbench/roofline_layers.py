"""The yardstick's arithmetic for a period of attention layers with
grouped KV heads and a sliding window: the pairs a windowed causal
attend computes, its model FLOPs, the bytes it needs, and the bound of
one forward or backward call. ``roofline.py``'s counts are the case of
one KV head a query head and no window.

As there, every count follows from shapes alone: a kernel that reads K/V
once a query head, or visits masked pairs, is still held to what the
algorithm needs.
"""

from __future__ import annotations

from typing import Optional, Tuple

from .roofline import Peak, causal_pairs


def window_pairs(s: int, w: Optional[int] = None) -> int:
    """Query-key pairs a causal attend of ``s`` positions computes under
    a window of ``w`` keys (the query at i sees j with i - w < j <= i):
    the first ``w`` queries see 1 .. w keys, every later one ``w``. No
    window, or one of ``s`` keys or more, is the causal mask alone."""
    if w is None or w >= s:
        return causal_pairs(s)
    return w * (w + 1) // 2 + (s - w) * w


def layer_fwd_flops(bh: int, s: int, d: int, window: Optional[int] = None
                    ) -> float:
    """Model FLOPs of one causal attention forward over ``bh`` query
    heads: Q·Kᵀ and P·V, two multiply-adds a visible pair and head
    dimension. Grouped KV heads change no product."""
    return 4.0 * bh * d * window_pairs(s, window)


def layer_bwd_flops(bh: int, s: int, d: int, window: Optional[int] = None
                    ) -> float:
    """Model FLOPs of one backward: 2.5 times the forward, as
    ``roofline.attention_bwd_flops`` counts it."""
    return 2.5 * layer_fwd_flops(bh, s, d, window)


def layer_fwd_bytes(bh: int, bh_kv: int, s: int, d: int) -> int:
    """Bytes of one forward in bf16: q read and out written at ``bh``
    heads, k and v read at ``bh_kv``, and the row statistics m and l
    written in f32 at ``bh``."""
    return 2 * bh * s * d * 2 + 2 * bh_kv * s * d * 2 + 2 * bh * s * 4


def layer_bwd_bytes(bh: int, bh_kv: int, s: int, d: int) -> int:
    """Bytes of one backward in bf16: q, out and dout read and dq written
    at ``bh`` heads, m and l read in f32 at ``bh``; k and v read and dk
    and dv written at ``bh_kv``."""
    return 4 * bh * s * d * 2 + 2 * bh * s * 4 + 4 * bh_kv * s * d * 2


def _bound(peak: Peak, flops: float, nbytes: int) -> Tuple[float, str]:
    ops_s = flops / peak.bf16_flops
    bytes_s = nbytes / peak.hbm_bytes_s
    return (ops_s, "operations") if ops_s >= bytes_s else (bytes_s, "bytes")


def layer_fwd_bound(peak: Peak, bh: int, bh_kv: int, s: int, d: int,
                    window: Optional[int] = None) -> Tuple[float, str]:
    """(seconds, what bounds it) of one forward call: its operations
    against the bf16 peak or its bytes against the HBM rate, whichever
    takes longer."""
    return _bound(peak, layer_fwd_flops(bh, s, d, window),
                  layer_fwd_bytes(bh, bh_kv, s, d))


def layer_bwd_bound(peak: Peak, bh: int, bh_kv: int, s: int, d: int,
                    window: Optional[int] = None) -> Tuple[float, str]:
    """(seconds, what bounds it) of one backward call."""
    return _bound(peak, layer_bwd_flops(bh, s, d, window),
                  layer_bwd_bytes(bh, bh_kv, s, d))


def calls_bound(peak: Peak, calls, backward: bool = False) -> float:
    """Seconds the bounds of ``calls`` add up to: each a dict with
    ``bh``, ``bh_kv``, ``seq``, ``head_dim`` and ``window`` (None for a
    full layer), as the ``attention_layers`` generator's facts list
    them."""
    fn = layer_bwd_bound if backward else layer_fwd_bound
    return sum(fn(peak, c["bh"], c["bh_kv"], c["seq"], c["head_dim"],
                  c["window"])[0] for c in calls)
