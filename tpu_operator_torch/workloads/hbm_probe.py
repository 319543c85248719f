"""HBM-bandwidth probe: the STREAM triad as a hand-written CUDA kernel.

Counterpart of ``tpu_operator/workloads/pallas_probe.py``. Complements the
matmul (tensor-core) and collective (NVLink) proofs with the third leg of
the roofline, sustained device-memory bandwidth: ``a = a + alpha * b``
streams 3 arrays per element, and those bytes over the time taken are the
achieved bandwidth, held against the card's published figure.

``triad_`` launches kernel B1 (``csrc/triad.cu``) on a CUDA tensor and
runs its plain version, ``triad_reference_``, on a CPU tensor. Both update
``a`` in place, the counterpart of the Pallas kernel's
``input_output_aliases={0: 0}``: chaining triads needs no copy.
"""

from __future__ import annotations

import ctypes
import time
from dataclasses import dataclass
from typing import Optional

import torch

from .backend import launch, resolve_device, span, synchronize
from .hardware import chip_spec_for, device_kind

_SIGNATURES = {
    "triad_f32": (ctypes.c_int, (ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_float, ctypes.c_int64,
                                 ctypes.c_void_p)),
}


def triad_reference_(a: torch.Tensor, b: torch.Tensor,
                     alpha: float) -> torch.Tensor:
    """Plain version: ``a += alpha * b`` with one rounding per element
    (fused multiply-add), bit-equal to the Pallas kernel's result."""
    return a.add_(b, alpha=alpha)


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    for name, t in (("a", a), ("b", b)):
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"triad_: {name} must be a tensor, got {type(t)}")
        if t.dtype != torch.float32:
            raise ValueError(f"triad_: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"triad_: {name} must be contiguous")
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"triad_: unsupported device {t.device}")
    if a.shape != b.shape:
        raise ValueError(f"triad_: shapes differ, {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"triad_: devices differ, {a.device} vs {b.device}")
    a0, b0 = a.data_ptr(), b.data_ptr()
    nbytes = a.numel() * 4
    if a0 != b0 and a0 < b0 + nbytes and b0 < a0 + nbytes:
        raise ValueError("triad_: b overlaps a without being a")


def triad_(a: torch.Tensor, b: torch.Tensor, alpha: float = 2.0) -> torch.Tensor:
    """``a = a + alpha * b`` in place; returns ``a``.

    On a CUDA tensor this launches kernel B1 (and counts the launch in
    ``triad_.launches``); on a CPU tensor it runs the plain version.
    Under ``torch.profiler`` either records the span
    ``tpu_operator_torch.triad_``.
    """
    with span("triad_"):
        _check(a, b)
        if a.device.type == "cpu":
            return triad_reference_(a, b, alpha)
        launch("triad", _SIGNATURES, "triad_f32", a.device, a.data_ptr(),
               b.data_ptr(), float(alpha), a.numel(), what="triad kernel")
        triad_.launches += 1
        return a


triad_.launches = 0


@dataclass
class TriadResult:
    bytes_moved: int
    seconds: float
    bandwidth_gbps: float
    peak_hbm_gbps: Optional[float]
    fraction_of_peak: Optional[float]
    device_kind: str
    correct: bool


def run(size_mb: float = 512.0, iters: int = 24, repeats: int = 3,
        device=None) -> TriadResult:
    """Two-point measurement: time ``lo`` and ``lo+iters`` triad chains
    and take the marginal rate, cancelling fixed launch and sync latency.

    Each chain restarts from ``a = 1`` (refilled outside the timed
    region), as each call of the JAX chain starts from the same ``a``;
    alpha=0.5 with b=2 adds exactly 1 per triad, so ``1 + lo + iters`` is
    the correctness probe.
    """
    dev = resolve_device(device)
    cols = 4096
    rows_total = max(128, int(size_mb * 1e6 / 4 / cols) // 128 * 128)
    a = torch.ones((rows_total, cols), dtype=torch.float32, device=dev)
    b = torch.full((rows_total, cols), 2.0, dtype=torch.float32, device=dev)

    def chain(n):
        for _ in range(n):
            triad_(a, b, alpha=0.5)

    lo = 2
    chain(lo)  # build + load the kernel, warm up
    synchronize(dev)

    def timed(n):
        best = float("inf")
        for _ in range(repeats):
            a.fill_(1.0)
            synchronize(dev)
            t0 = time.perf_counter()
            chain(n)
            synchronize(dev)
            best = min(best, time.perf_counter() - t0)
        return best

    t_lo = timed(lo)
    t_hi = timed(lo + iters)
    probe = float(a[0, 0])
    bytes_per_iter = a.numel() * 4 * 3  # read a, read b, write a
    seconds = max(t_hi - t_lo, 1e-9)
    bw = bytes_per_iter * iters / seconds / 1e9
    kind = device_kind(dev)
    spec = chip_spec_for(kind)
    correct = abs(probe - (1.0 + lo + iters)) <= 1e-5 * (1.0 + lo + iters)
    return TriadResult(
        bytes_moved=bytes_per_iter * iters, seconds=seconds,
        bandwidth_gbps=bw,
        peak_hbm_gbps=spec.hbm_bw_gbps if spec else None,
        fraction_of_peak=(bw / spec.hbm_bw_gbps) if spec else None,
        device_kind=kind, correct=correct)


def main() -> int:
    import json

    res = run()
    print(json.dumps(res.__dict__))
    return 0 if res.correct else 1


if __name__ == "__main__":
    raise SystemExit(main())
