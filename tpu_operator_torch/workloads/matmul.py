"""Single-card tensor-core proof: sustained bf16 matmul throughput.

Counterpart of ``tpu_operator/workloads/matmul.py``: a chained NxN bf16
matmul, measured with the same protocol. ``calls`` chains of ``iters``
products run back to back through a data dependency (each chain consumes
the previous one's output) and the host synchronises ONCE at the end, so
the fixed launch and sync latency is amortised over calls*iters products.

B is pre-scaled by 1/sqrt(N), in bf16 as the JAX package does it, so the
chained products stay O(1) without a per-step renormalisation polluting
the matmul stream. The product itself is ``torch.matmul`` (cuBLAS on the
card), as the JAX package leaves it to XLA outside any Pallas kernel.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Optional

import torch

from .backend import resolve_device, synchronize
from .hardware import chip_spec_for, device_kind


@dataclass
class MatmulResult:
    size: int
    iters: int
    calls: int
    seconds: float
    tflops: float
    peak_tflops: Optional[float]
    utilization: Optional[float]
    device_kind: str
    checksum_ok: bool


def chain(a: torch.Tensor, b: torch.Tensor, iters: int) -> torch.Tensor:
    """``a @ b @ b ... `` (``iters`` products), the body of the JAX scan."""
    c = a
    for _ in range(iters):
        c = torch.matmul(c, b)
    return c


def inputs(size: int, device, seed: int = 0, dtype=torch.bfloat16):
    """Seeded ``(a, b)`` with ``b`` pre-scaled by 1/sqrt(size) in ``dtype``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    a = torch.randn((size, size), generator=gen, device=device, dtype=dtype)
    b = torch.randn((size, size), generator=gen, device=device, dtype=dtype)
    scale = torch.tensor(math.sqrt(size), dtype=torch.float32).to(dtype)
    return a, b / scale.to(device)


def run(size: int = 8192, iters: int = 32, calls: int = 8, repeats: int = 3,
        device=None, seed: int = 0) -> MatmulResult:
    dev = resolve_device(device)
    a, b = inputs(size, dev, seed)
    out = chain(a, b, iters)
    synchronize(dev)  # warm-up (cuBLAS handle + heuristics) + full sync

    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = a
        for _ in range(calls):
            out = chain(out, b, iters)
        probe = out[:1, :1].float().cpu()  # single end-of-chain sync
        best = min(best, time.perf_counter() - t0)

    flops = 2.0 * size * size * size * iters * calls
    tflops = flops / best / 1e12
    kind = device_kind(dev)
    spec = chip_spec_for(kind)
    return MatmulResult(
        size=size, iters=iters, calls=calls, seconds=best, tflops=tflops,
        peak_tflops=spec.peak_bf16_tflops if spec else None,
        utilization=(tflops / spec.peak_bf16_tflops) if spec else None,
        device_kind=kind, checksum_ok=bool(torch.isfinite(probe).all()))


def main() -> int:
    import json

    res = run()
    print(json.dumps(res.__dict__))
    return 0 if res.checksum_ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
