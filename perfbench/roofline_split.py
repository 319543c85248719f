"""The yardstick's arithmetic for attention whose values are narrower than
its keys (MLA's prefill form, MiMo-V2-Flash's 192-wide keys over 128-wide
values), with grouped KV heads, a sliding window and attention sinks:
the model FLOPs of a forward call, the bytes it needs, and its bound.
``roofline_layers.py``'s counts are the case of equal widths and no sink.

As there, every count follows from shapes alone: a kernel that reads K/V
once a query head, or visits masked pairs, is still held to what the
algorithm needs.
"""

from __future__ import annotations

from typing import Optional, Tuple

from .roofline import Peak
from .roofline_layers import window_pairs


def split_fwd_flops(bh: int, s: int, d_qk: int, d_v: int,
                    window: Optional[int] = None) -> float:
    """Model FLOPs of one causal forward over ``bh`` query heads: Q·Kᵀ at
    the key width and P·V at the value width, a multiply-add each a
    visible pair and dimension. Grouped KV heads and a sink (one more
    logit a row) change no product."""
    return 2.0 * bh * window_pairs(s, window) * (d_qk + d_v)


def split_fwd_bytes(bh: int, bh_kv: int, s: int, d_qk: int, d_v: int,
                    sinks: bool = False) -> int:
    """Bytes of one forward in bf16: q read at ``bh`` heads and the key
    width, out written at ``bh`` and the value width, k and v read at
    ``bh_kv`` heads and their widths, the row statistics m and l written
    in f32 at ``bh``, and with ``sinks`` one f32 logit read a query
    head."""
    return (2 * bh * s * (d_qk + d_v) + 2 * bh_kv * s * (d_qk + d_v)
            + 2 * bh * s * 4 + (4 * bh if sinks else 0))


def split_fwd_bound(peak: Peak, bh: int, bh_kv: int, s: int, d_qk: int,
                    d_v: int, window: Optional[int] = None,
                    sinks: bool = False) -> Tuple[float, str]:
    """(seconds, what bounds it) of one forward call: its operations
    against the bf16 peak or its bytes against the HBM rate, whichever
    takes longer."""
    ops_s = split_fwd_flops(bh, s, d_qk, d_v, window) / peak.bf16_flops
    bytes_s = split_fwd_bytes(bh, bh_kv, s, d_qk, d_v, sinks) \
        / peak.hbm_bytes_s
    return (ops_s, "operations") if ops_s >= bytes_s else (bytes_s, "bytes")


def calls_bound(peak: Peak, calls) -> float:
    """Seconds the forward bounds of ``calls`` add up to: each a dict with
    ``bh``, ``bh_kv``, ``seq``, ``d_qk``, ``d_v``, ``window`` (None for a
    full layer) and ``sinks``, as the ``attention_period`` generator's
    facts list them."""
    return sum(split_fwd_bound(peak, c["bh"], c["bh_kv"], c["seq"],
                               c["d_qk"], c["d_v"], c["window"],
                               c["sinks"])[0] for c in calls)
