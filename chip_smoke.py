#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one card and check it.

    python3 chip_smoke.py        # from the root of a checkout, on a CUDA host

The main path is the per-node validation chain (driver -> runtime -> cuda
-> hbm -> nvlink) of ``tpu_operator_torch``, run through its CLI at the
DaemonSet's sizes (MATMUL_SIZE=4096, HBM_SIZE_MB=512). Phases, each fatal:

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build the hand-written kernels from the checkout's sources;
3. hold each kernel against its plain PyTorch version on the card, at the
   main path's shape, a ragged length and a misaligned view;
4. run the validator chain with every launch count set to 0, and require
   that the chain went through each kernel and wrote every barrier file;
5. run the collective suite over NCCL at world size 1 against its oracle;
6. time each kernel beside its bound, its plain version and the library
   call computing the same function, and the matmul proof;
7. print the kernel table as one JSON line.

The last line is ``{"ok": true, "device": {...}}``; on any failure the
script exits non-zero and prints no such line. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

# the validator's matmul and triad proofs at the DaemonSet's defaults
MATMUL_SIZE = 4096
HBM_SIZE_MB = 512
# [31232, 4096] f32: the triad's shape at HBM_SIZE_MB (rows rounded to 128)
TRIAD_SHAPE = (max(128, int(HBM_SIZE_MB * 1e6 / 4 / 4096) // 128 * 128), 4096)
TRIAD_ALPHA = 0.37
# the kernel computes fmaf(alpha, b, a) with one rounding; torch's CUDA
# add_(b, alpha=) is compiled with FMA contraction, so the two must agree
# bit for bit
TRIAD_TOLERANCE = 0.0
# launches of the triad per validate_hbm at the defaults: 2 warm-up, then
# 3 repeats of the lo=2 chain and 3 of the lo+iters=26 chain
TRIAD_LAUNCHES_PER_HBM_PROOF = 2 + 3 * 2 + 3 * 26
# H100 SXM peak for f32 outside the tensor cores (data sheet), for the
# operations side of the triad's bound
F32_PEAK_TFLOPS = 67.0


def log(msg: str) -> None:
    print(msg, flush=True)


def card_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_triad(torch, hbm_probe, dev, gen, shape, offset: int) -> float:
    """Kernel vs plain version on seeded inputs of ``shape``, viewed
    ``offset`` elements into their buffers; returns the max abs error."""
    n = 1
    for d in shape:
        n *= d
    a0 = torch.randn(n + offset, generator=gen, device=dev)
    b0 = torch.randn(n + offset, generator=gen, device=dev)
    b = b0[offset:].view(shape)
    got_buf, want_buf = a0.clone(), a0.clone()
    got = got_buf[offset:].view(shape)
    want = want_buf[offset:].view(shape)
    hbm_probe.triad_(got, b, TRIAD_ALPHA)
    hbm_probe.triad_reference_(want, b, TRIAD_ALPHA)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    log(f"  triad {list(shape)} offset={offset} (data_ptr % 16 = "
        f"{got.data_ptr() % 16}): max_abs_err={err!r} "
        f"bit_equal={torch.equal(got, want)} tolerance={TRIAD_TOLERANCE}")
    if not err <= TRIAD_TOLERANCE:
        raise RuntimeError(f"triad kernel disagrees with its plain version "
                           f"on {list(shape)} offset={offset}: {err!r}")
    return err


def run_validator_chain(cli, barrier) -> dict:
    """The port's validator CLI, in process, one component at a time;
    returns each barrier file's contents."""
    files = {}
    for comp, status in (("driver", "driver-ready"),
                         ("runtime", "runtime-ready"),
                         ("cuda", "cuda-ready"),
                         ("hbm", "hbm-ready"),
                         ("nvlink", "nvlink-ready")):
        t0 = time.perf_counter()
        rc = cli.main(["-c", comp])
        secs = time.perf_counter() - t0
        info = barrier.read_status(status)
        log(f"  -c {comp}: rc={rc} in {secs:.3f}s, {status}: {info}")
        if rc != 0 or info is None:
            raise RuntimeError(f"validator -c {comp} failed (rc={rc}, "
                               f"{status} {'missing' if info is None else 'written'})")
        files[status] = info
    return files


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a card",
              file=sys.stderr)
        return 1

    from tpu_operator_torch.cli import validator as cli
    from tpu_operator_torch.kernels import build
    from tpu_operator_torch.validator import barrier
    from tpu_operator_torch.workloads import collectives, hbm_probe, matmul
    from tpu_operator_torch.workloads.hardware import CHIPS, chip_spec_for

    # 1. the card
    card = card_name_and_power()
    kind = torch.cuda.get_device_name(0)
    log("# phase 1: card")
    log(card)
    log(f"  torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device_count={torch.cuda.device_count()}")
    spec = chip_spec_for(kind)
    if spec is None:
        log(f"  no published spec for {kind!r}; bounds use the H100 SXM's")
        spec = CHIPS["h100-sxm"]
    dev = torch.device("cuda", 0)

    # 2. build
    log("# phase 2: build")
    built = build.build("triad")
    log(f"  triad: {built.path.name} built in {built.seconds:.2f}s")
    for line in built.log.splitlines():
        log(f"    {line}")

    # 3. kernels against their plain versions
    log("# phase 3: kernels vs plain versions")
    gen = torch.Generator(device=dev).manual_seed(0)
    ragged = (1001, 333)  # 333333 elements: not a multiple of 4
    triad_err = max(check_triad(torch, hbm_probe, dev, gen, TRIAD_SHAPE, 0),
                    check_triad(torch, hbm_probe, dev, gen, ragged, 0),
                    check_triad(torch, hbm_probe, dev, gen, TRIAD_SHAPE, 1))

    # 4. the main path, counted
    log("# phase 4: validator chain")
    valdir = tempfile.mkdtemp(prefix="gpu-validations-")
    os.environ.update(GPU_VALIDATION_DIR=valdir, MATMUL_SIZE=str(MATMUL_SIZE),
                      HBM_SIZE_MB=str(HBM_SIZE_MB))
    try:
        hbm_probe.triad_.launches = 0
        files = run_validator_chain(cli, barrier)
        triad_launches = hbm_probe.triad_.launches
    finally:
        shutil.rmtree(valdir, ignore_errors=True)
    log(f"  triad launches in the chain: {triad_launches} "
        f"(expected {TRIAD_LAUNCHES_PER_HBM_PROOF})")
    if triad_launches == 0:
        raise RuntimeError("the HBM proof did not launch the triad kernel")
    frac = files["hbm-ready"].get("FRACTION_OF_PEAK")
    if frac is None or float(frac) < 0.5:
        raise RuntimeError(f"hbm-ready FRACTION_OF_PEAK={frac}, gate 0.5")

    # 5. collectives over NCCL at world size 1
    log("# phase 5: collective suite, NCCL, world size 1 (nothing crosses "
        "a link at n=1: the figures are local copies)")
    suite = collectives.run_suite(size_mb=64, iters=10, repeats=3,
                                  world_size=1, device="cuda",
                                  timeout_s=300)
    for op, r in suite.items():
        log(f"  {op}: correct={r.correct} algo={r.algo_bw_gbps!r} GB/s "
            f"bus={r.bus_bw_gbps!r} GB/s seconds={r.seconds!r}")
        if not r.correct:
            raise RuntimeError(f"collective {op} failed its oracle")

    # 6. timings
    log("# phase 6: timings")
    a = torch.randn(TRIAD_SHAPE, generator=gen, device=dev)
    b = torch.randn(TRIAD_SHAPE, generator=gen, device=dev)
    n = a.numel()
    triad_bytes = 3 * 4 * n          # read a, read b, write a
    triad_flops = 2 * n              # one multiply-add per element
    bound_bytes_ms = triad_bytes / (spec.hbm_bw_gbps * 1e9) * 1e3
    bound_ops_ms = triad_flops / (F32_PEAK_TFLOPS * 1e12) * 1e3
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    bound_by = "bytes" if bound_bytes_ms >= bound_ops_ms else "operations"

    def kernel():
        hbm_probe.triad_(a, b, TRIAD_ALPHA)

    def plain():
        hbm_probe.triad_reference_(a, b, TRIAD_ALPHA)

    def library():
        a.add_(b, alpha=TRIAD_ALPHA)

    # in turns on one card: plain, kernel, kernel, plain
    plain_runs, kernel_runs = [cuda_ms(torch, plain)], []
    kernel_runs += [cuda_ms(torch, kernel), cuda_ms(torch, kernel)]
    plain_runs.append(cuda_ms(torch, plain))
    library_ms = cuda_ms(torch, library)
    kernel_ms, plain_ms = min(kernel_runs), min(plain_runs)
    del a, b
    mm = matmul.run(size=MATMUL_SIZE, iters=32, calls=8, repeats=3, device=dev)
    if not mm.checksum_ok:
        raise RuntimeError("matmul produced non-finite values")
    timings = {
        "card": card,
        "triad": {"shape": list(TRIAD_SHAPE), "ms": kernel_ms,
                  "ms_runs": kernel_runs, "plain_ms_runs": plain_runs,
                  "gbps": triad_bytes / (kernel_ms * 1e-3) / 1e9,
                  "bound_ms": bound_ms, "library_ms": library_ms,
                  "fraction_of_peak": bound_bytes_ms / kernel_ms,
                  "hbm_ready": files["hbm-ready"]},
        "matmul": {"size": mm.size, "iters": mm.iters, "calls": mm.calls,
                   "tflops": mm.tflops, "peak_tflops": mm.peak_tflops,
                   "utilization": mm.utilization},
    }
    log(json.dumps(timings))

    # 7. the kernel table
    kernels = [{
        "name": "triad",
        "route": "cuda",
        "source": "tpu_operator_torch/csrc/triad.cu",
        "replaces": "tpu_operator/workloads/pallas_probe.py:30",
        "launches": triad_launches,
        "max_abs_err": triad_err,
        "tolerance": TRIAD_TOLERANCE,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
