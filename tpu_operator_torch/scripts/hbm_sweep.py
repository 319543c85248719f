"""One-shot HBM STREAM-triad sweep on the card.

Counterpart of ``scripts/hbm_sweep.py``. Runs ``hbm_probe.run`` (kernel
B1, ``csrc/triad.cu``) across a small (size_mb, iters) grid in one
process and prints a JSON report: ``device_kind``, ``results`` by
``<size>MBx<iters>`` (``bandwidth_gbps``, ``fraction_of_peak``,
``correct``) and ``best``.

    python -m tpu_operator_torch.scripts.hbm_sweep            # the grid
    python -m tpu_operator_torch.scripts.hbm_sweep --quick    # 3 points

Without CUDA it prints ``{"error": ...}`` and exits 1, as the reference
does off a TPU: the plain version never stands in for the kernel.
"""

from __future__ import annotations

import argparse
import json
import sys

GRID = [(256.0, 24), (512.0, 16), (512.0, 24), (512.0, 48),
        (1024.0, 24), (2048.0, 16), (2048.0, 24)]
QUICK_GRID = [(256.0, 24), (512.0, 24), (1024.0, 24)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="hbm_sweep")
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args(argv)

    from ..workloads import backend, hbm_probe
    from ..workloads.hardware import device_kind

    try:
        devices = backend.init_devices(attempts=1)
    except Exception as e:  # the JSON contract holds when init fails
        print(json.dumps({"error": f"backend init failed: "
                                   f"{type(e).__name__}: {e}"}))
        return 1
    dev = devices[0]
    results = {}
    best = (None, 0.0)  # on fraction when the card is known, else GB/s
    for size_mb, iters in QUICK_GRID if args.quick else GRID:
        r = hbm_probe.run(size_mb=size_mb, iters=iters, repeats=2,
                          device=dev)
        key = f"{size_mb:.0f}MBx{iters}"
        results[key] = {
            "bandwidth_gbps": round(r.bandwidth_gbps, 1),
            "fraction_of_peak": (round(r.fraction_of_peak, 4)
                                 if r.fraction_of_peak is not None else None),
            "correct": r.correct,
        }
        print(f"# {key}: {results[key]}", file=sys.stderr)
        score = (r.fraction_of_peak if r.fraction_of_peak is not None
                 else r.bandwidth_gbps)
        if r.correct and score > best[1]:
            best = (key, score)
    print(f"# kernels: {json.dumps({'triad': hbm_probe.triad_.launches})}",
          file=sys.stderr)
    print(json.dumps({"device_kind": device_kind(dev),
                      "results": results,
                      "best": {"config": best[0],
                               "score": round(best[1], 4)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
