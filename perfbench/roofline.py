"""The yardstick's arithmetic: the card's published peaks, and the
operations and bytes each measured kernel or step needs.

Every count here follows from shapes alone, never from what an
implementation does: a kernel that reads its inputs twice, or a backward
pass that recomputes the forward, is still held to what the algorithm
needs. The per-layer readers (``layer_metrics/``) divide these counts by
device times from the profiler's trace.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class Peak:
    bf16_flops: float      # dense tensor-core FLOP/s
    hbm_bytes_s: float     # device memory bytes/s
    nvlink_bytes_s: float  # one direction, bytes/s a card


# NVIDIA's data sheet, H100 SXM5, dense rates without sparsity: 989
# TFLOP/s bf16, 3.35 TB/s HBM3, 18 NVLink-4 links at 900 GB/s as send plus
# receive, so 450 GB/s each way. NCCL's bus bandwidth counts the bytes one
# card sends a second, so it is held against one direction.
H100_SXM = Peak(bf16_flops=989e12, hbm_bytes_s=3.35e12, nvlink_bytes_s=450e9)

# substrings of torch.cuda.get_device_name(), lower case
_PEAKS = (("h100 80gb hbm3", H100_SXM), ("h100 sxm", H100_SXM))


def peak_for(kind: str) -> Optional[Peak]:
    """The peaks of a card by its name; None for a card not in the table
    (its shares are then not reported)."""
    kind = (kind or "").lower()
    for hint, peak in _PEAKS:
        if hint in kind:
            return peak
    return None


def causal_pairs(s: int) -> int:
    """Query-key pairs a causal attend of ``s`` positions computes."""
    return s * (s + 1) // 2


def attention_fwd_flops(bh: int, s: int, d: int, causal: bool = True) -> float:
    """Model FLOPs of one attention forward over ``bh`` heads: Q·Kᵀ and
    P·V, two multiply-adds a visible pair and head dimension."""
    pairs = causal_pairs(s) if causal else s * s
    return 4.0 * bh * d * pairs


def attention_bwd_flops(bh: int, s: int, d: int, causal: bool = True) -> float:
    """Model FLOPs of one attention backward: counted as 2.5 times the
    forward (five products of the forward's size against its two:
    dV = Pᵀ·dO, dP = dO·Vᵀ, dQ = dS·K, dK = dSᵀ·Q, and S = Q·Kᵀ again),
    whatever implements it."""
    return 2.5 * attention_fwd_flops(bh, s, d, causal)


def flash_bound(peak: Peak, bh: int, s: int, d: int) -> Tuple[float, str]:
    """(seconds, what bounds it) of one causal [bh, s, d] bf16 attend:
    the causal pairs' operations against the bf16 peak, or q, k, v read
    and out written in bf16 and the row statistics m, l written in f32
    against the HBM rate, whichever is larger."""
    ops_s = attention_fwd_flops(bh, s, d, True) / peak.bf16_flops
    bytes_s = (4 * bh * s * d * 2 + 2 * bh * s * 4) / peak.hbm_bytes_s
    return (ops_s, "operations") if ops_s >= bytes_s else (bytes_s, "bytes")


def triad_bytes(elements: int, itemsize: int = 4) -> int:
    """Bytes of one STREAM triad ``a = a + alpha * b``: a and b read, a
    written."""
    return 3 * itemsize * elements


def triad_bound(peak: Peak, elements: int, itemsize: int = 4) -> float:
    """Seconds one triad takes at the HBM rate."""
    return triad_bytes(elements, itemsize) / peak.hbm_bytes_s


def allreduce_bus_factor(n: int) -> float:
    """Bytes a card sends over its links per byte it reduces, in a ring
    all-reduce of ``n`` ranks (reduce-scatter then all-gather): the
    bus-bandwidth factor of nccl-tests' ``all_reduce_perf``."""
    return 2.0 * (n - 1) / n


def allreduce_bus_bytes(nbytes: int, n: int) -> float:
    """Bus bytes of one all-reduce of ``nbytes`` a rank over ``n`` ranks."""
    return allreduce_bus_factor(n) * nbytes
