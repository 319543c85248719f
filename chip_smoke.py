#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one card and check it.

    python3 chip_smoke.py    # from the root of a checkout, on a CUDA host

Five paths of ``tpu_operator_torch`` are driven. The per-node validation
chain (driver -> runtime -> cuda -> hbm -> nvlink -> dcn) runs through its
CLI at the DaemonSet's sizes (MATMUL_SIZE=4096, HBM_SIZE_MB=512). The
long-context path runs ring and Ulysses attention through
``ringattention``'s harness over every visible card, the ring's
flash-kernel hop at a 32k-token context, and ``flash_attention`` forward
and backward. The burn-in trainer runs at ``BurninConfig``'s defaults
over every visible card, with its checkpoint/resume, the DCN probe and
the multi-card dry run. The pipeline, the expert-parallel MoE and the
conv burn-in run over every visible card. The node's status exporter,
the CUDA validation pod's payload, chip telemetry over NVML and the
forward entry point run on the card. Phases, each fatal:

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build the hand-written kernels from the checkout's sources, one nvcc
   per source, all at once; the flash kernel's two instantiations must
   spill nothing and keep their setmaxnreg (no ptxas warning C7508);
3. hold each kernel against its plain PyTorch version on the card: the
   triad at the main path's shape, a ragged length and a misaligned view;
   flash attention at the harness's and the long context's shapes, ragged
   lengths (also multiples of 64 that are not of 128), ring-hop offsets,
   rows that see no key inside a live block (exact), a block wholly in
   the future (exact), non-causal D=128 and a two-block merge;
4. run the validator chain with the triad's count set to 0, and require
   that the chain went through the kernel and wrote every barrier file;
   then the DCN proof, once on this one node (skipped) and once as node 1
   of 2 against a TCP listener this script opens on 127.0.0.1 (RTT_MS);
5. run the collective suite over NCCL at world size 1 against its oracle;
6. run the long-context path with the flash kernel's count set to 0, and
   require that it is correct and went through the kernel;
7. time each kernel beside its bound, its plain version and the library
   call computing the same function, the matmul proof, and the parts of
   the flash ring's call on one card (fold, kernel, merge);
8. the burn-in (no kernel of its own): ``burnin.run()`` whose loss must
   fall; a TP and an FSDP step on one batch whose losses agree within
   2e-4; a checkpoint save, a restore into a fresh init whose parameters,
   AdamW moments and step counts equal the saved ones bit for bit, and a
   next step whose loss equals the uninterrupted run's bit for bit; ms per train
   step, tokens/s, save and restore seconds; with >= 2 cards the DCN probe
   over two fake slices (NVLink traffic: nothing crosses a network), with
   an even number >= 4 the dry run (now with its conv, pipeline and MoE
   stages);
9. the parallel workloads (no kernel of their own), one rank per card:
   ``pipeline.run()`` and ``moe.run()`` at their defaults, each correct
   against its oracle, and one wider case each held to its f32 oracle
   within 1e-5 of the oracle's largest value, with ms per call;
   ``convburn.run()`` whose loss must fall, and the conv train step's ms,
   images/s and the card's busy share under ``torch.profiler``;
A (in phase 4). the node-status exporter over the chain's barrier files:
   each gauge equals its file's figure, ``serve`` answers /metrics and
   /healthz, and the figures go with the files;
10 (B). the CUDA validation pod's container command and env, as
   ``validator.workload.cuda_workload_pod`` builds them, run as a process
   on the card (rc 0, finite checksum), and a process's start to CUDA
   ready, by part;
11 (C). chip telemetry: ``gpu-telemetry`` (``csrc/gpu_telemetry.cc``,
   NVML) built at first use; one row a card, NVML's memory total within
   2% of torch's, the temperature sane, two fresh ``--watch`` ticks
   through ``NativeEngine``, the duty cycle above 0 under a matmul chain,
   and the exporter, ``collect_cuda`` and ``collect_native`` agreeing;
12 (D). ``entry()``'s forward on the card: finite logits [4, 64, 256],
   ms a call;
13. the NVLink proof's all-reduce step against a bare all-reduce and
   against the step with a copy first, at 256 MB a rank over every card,
   with NCCL's algorithm choice (TUNING debug); on one card nothing
   crosses a link, and the two steps differ by the copy;
14. print the kernel table as one JSON line.

The last line is ``{"ok": true, "device": {...}}``; on any failure the
script exits non-zero and prints no such line. Imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
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

KERNELS = ("triad", "flash_attention")
# flash attention [B, S, H, D]: ringattention.run()'s defaults, and a 32k
# context of 8 heads of 128, which long-context training runs
FLASH_RUN_SHAPE = (1, 2048, 8, 64)
FLASH_LONG_SHAPE = (1, 32768, 8, 128)
# kernel vs plain version, bf16 inputs. The kernel rounds P to bf16 for
# P.V, where the plain version keeps it f32, and both round out to bf16:
# out may differ by one bf16 step, 1.6e-2 where |out| is in [2, 4), so the
# abs limit is 2e-2. That alone would pass a wrong late row, whose values
# are a few hundredths, so each row [.., D] of out is also held to
# ||o - ro|| / ||ro|| <= 2**-7, one bf16 step of the row: rounding noise
# is a fixed share of the row, a dropped or misplaced K/V chunk a share
# of about sqrt(D / keys seen). m and l, f32 row statistics, agreed
# within 3e-6 on the H100, so 1e-4 leaves a margin of 30
FLASH_OUT_TOL = 2e-2
FLASH_OUT_ROW_RTOL = 2.0 ** -7
FLASH_M_TOL = 1e-4
FLASH_L_RTOL = 1e-4
# logged, not gated: the largest |o - ro| / (atol + rtol * |ro|) with
# atol 1e-3 and rtol 2**-7. The rounding of P scales with the weighted
# |v| of a row, not with |out|, so where a row's values cancel this
# reads above 1 on a right output
FLASH_ELEM_ATOL, FLASH_ELEM_RTOL = 1e-3, 2.0 ** -7
# flash_attention's bf16 forward and backward against autograd of the f32
# oracle, the tolerance of the JAX package's bf16 gradient test
FLASH_GRAD_RTOL, FLASH_GRAD_ATOL = 0.05, 0.02


# the burn-in: TP and FSDP losses of one step on one batch agree within
# JAX's own bound (tests/test_workloads.py)
BURNIN_FSDP_RTOL = 2e-4
# train steps timed per repeat, after BURNIN_WARMUP steps
BURNIN_WARMUP, BURNIN_TIMED_STEPS, BURNIN_REPEATS = 3, 10, 3
# the DCN probe's all-reduce per rank, validate_dcn's default
DCN_PROBE_SIZE_MB = 64.0

# the parallel workloads' wider cases, to put the card to work: a pipeline
# of 1024-wide FFN stages (d_ff 4096) over 8 microbatches of 4 x 256
# tokens, and an MoE of 2048 tokens an expert at the same widths. Both
# run in f32 (TF32 off, torch's default) against their f32 oracles; the
# gate is relative to the oracle's largest value, since f32 products of
# 4096 terms summed in another order differ by ~1e-6 of it
PIPELINE_WIDE = dict(batch=32, seq_len=256, d_model=1024, d_ff=4096,
                     n_microbatches=8)
MOE_WIDE = dict(tokens_per_expert=2048, d_model=1024, d_ff=4096)
WIDE_RTOL = 1e-5
# timed calls per pipeline/MoE case, after one warm-up; the min is kept
PARALLEL_REPEATS = 5

# chip telemetry: NVML's memory total against torch.cuda.mem_get_info's
# (they differ by the driver's reserve, 0.59% on an H100 80GB HBM3); the
# load under which the duty cycle must rise: 16384-square bf16 products,
# ~8.8 TFLOP each, ~3 s of the card's time in all
TELEMETRY_HBM_RTOL = 0.02
TELEMETRY_MATMUL, TELEMETRY_PRODUCTS = 16384, 300
# the NVLink proof's per-rank all-reduce, validate_nvlink's default
NVLINK_PROOF_SIZE_MB = 256.0


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


def check_flash_build(log_text: str) -> dict:
    """ptxas's report of the flash kernel: bytes spilled (stores, loads)
    per instantiation, by head width. Fails unless both widths are there
    with nothing spilled, or where ptxas ignored setmaxnreg (C7508)."""
    spills, width = {}, None
    for line in log_text.splitlines():
        if "Function properties for" in line:
            found = re.search(r"flash_fwdILi(\d+)E", line)
            width = int(found.group(1)) if found else None
        elif width is not None and "spill stores" in line:
            spills[width] = tuple(int(n) for n in re.findall(
                r"(\d+) bytes spill (?:stores|loads)", line))
            width = None
    log(f"  flash_fwd spills (stores, loads) by head width: {spills}")
    if "C7508" in log_text or "setmaxnreg ignored" in log_text:
        raise RuntimeError("ptxas ignored setmaxnreg in the flash kernel")
    if sorted(spills) != [64, 128] or any(any(v) for v in spills.values()):
        raise RuntimeError(f"flash kernel spills or lacks an instantiation: "
                           f"{spills}")
    return spills


def flash_inputs(torch, dev, gen, bh, sq, sk, d):
    return tuple(torch.randn((bh, s, d), generator=gen, device=dev)
                 .to(torch.bfloat16) for s in (sq, sk, sk))


def out_errors(ra, o, ro) -> dict:
    """max abs error, worst row's relative error and (logged only) the
    largest elementwise ratio of out against its plain version."""
    d = (o.float() - ro.float()).abs()
    return {"out": d.max().item(), "out_row_rel": ra.row_rel_err(o, ro),
            "out_elem_ratio": (d / (FLASH_ELEM_ATOL + FLASH_ELEM_RTOL
                                    * ro.float().abs())).max().item()}


def require_flash_close(label, errs) -> None:
    log(f"  flash {label}: max_abs_err out={errs['out']!r} "
        f"m={errs.get('m')!r} l_rel={errs.get('l_rel')!r}; out row "
        f"rel={errs['out_row_rel']!r}, elementwise ratio (logged) "
        f"{errs['out_elem_ratio']!r} (tolerances out {FLASH_OUT_TOL} abs "
        f"and {FLASH_OUT_ROW_RTOL} a row, m {FLASH_M_TOL}, l {FLASH_L_RTOL})")
    if not (errs["out"] <= FLASH_OUT_TOL
            and errs["out_row_rel"] <= FLASH_OUT_ROW_RTOL
            and errs.get("m", 0.0) <= FLASH_M_TOL
            and errs.get("l_rel", 0.0) <= FLASH_L_RTOL):
        raise RuntimeError(f"flash kernel disagrees with its plain version "
                           f"on {label}: {errs}")


def check_flash(torch, fa, ra, dev, gen, label, bh, sq, sk, d, q_offset=0,
                k_offset=0, causal=True, dead_rows=0) -> dict:
    """Kernel vs plain version on seeded bf16 inputs; returns the errors.
    The first ``dead_rows`` rows see no key: there out == 0, l == 0 and
    m == -1e30 exactly."""
    q, k, v = flash_inputs(torch, dev, gen, bh, sq, sk, d)
    o, m, l = fa.flash_attention_blocks(q, k, v, q_offset, k_offset, causal)
    ro, rm, rl = fa.flash_attention_blocks_reference(
        q, k, v, q_offset, k_offset, causal, q_tile=4096)
    torch.cuda.synchronize()
    if dead_rows:
        exact = (bool((o[:, :dead_rows] == 0).all())
                 and bool((l[:, :dead_rows] == 0).all())
                 and bool((m[:, :dead_rows] == fa.NEG_INF).all())
                 and bool((l[:, dead_rows:] > 0).all()))
        log(f"  flash {label}: rows 0..{dead_rows - 1} out==0, l==0, "
            f"m==-1e30 exactly and later rows live: {exact}")
        if not exact:
            raise RuntimeError(f"flash kernel: the dead rows of {label} are "
                               f"not exactly empty")
    live = rl > 0
    errs = dict(out_errors(ra, o, ro), m=(m - rm).abs().max().item(),
                l_rel=((l - rl).abs()[live] / rl[live]).max().item()
                if bool(live.any()) else (l - rl).abs().max().item())
    require_flash_close(f"{label} [{bh}, {sq}|{sk}, {d}] offsets="
                        f"({q_offset}, {k_offset}) causal={causal}", errs)
    return errs


def check_flash_future_block(torch, fa, dev, gen, bh, s, d) -> None:
    """A K block after every query: out, l == 0 and m == -1e30 exactly."""
    q, k, v = flash_inputs(torch, dev, gen, bh, s, s, d)
    o, m, l = fa.flash_attention_blocks(q, k, v, 0, s, True)
    torch.cuda.synchronize()
    exact = (bool((o == 0).all()) and bool((l == 0).all())
             and bool((m == fa.NEG_INF).all()))
    log(f"  flash fully-future block [{bh}, {s}, {d}] k_offset={s}: "
        f"out==0, l==0, m==-1e30 exactly: {exact}")
    if not exact:
        raise RuntimeError("flash kernel: a fully-future block is not empty")


def check_flash_merge(torch, fa, ra, dev, gen, shape) -> dict:
    """The two halves of K, each a ring hop's flash tile, folded by the
    ring's own merge, against the plain version over the whole; returns
    the errors of out."""
    B, S, H, D = shape
    q, k, v = (torch.randn(shape, generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    h = S // 2
    o = torch.zeros(shape, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, S), dtype=torch.float32, device=dev)
    m = l + fa.NEG_INF
    for k0 in (0, h):
        blk = ra._block_attend_flash(q, k[:, k0:k0 + h], v[:, k0:k0 + h],
                                     0, k0, True)
        o, l, m = ra.merge(o, l, m, *blk)
    merged = o / torch.where(l == 0, 1.0, l).transpose(1, 2)[..., None]
    fold = lambda t: t.transpose(1, 2).reshape(B * H, S, D)
    want, _, _ = fa.flash_attention_blocks_reference(
        fold(q), fold(k), fold(v), 0, 0, True, q_tile=4096)
    torch.cuda.synchronize()
    errs = out_errors(ra, fold(merged), want)
    require_flash_close(f"two-block merge {list(shape)}", errs)
    return errs


def check_flash_attention_grad(torch, fa, ra, dev, gen) -> dict:
    """flash_attention forward and backward (bf16) against autograd of the
    f32 oracle on the same inputs and a seeded cotangent."""
    shape = FLASH_RUN_SHAPE
    base = [torch.randn(shape, generator=gen, device=dev) for _ in range(3)]
    w = torch.randn(shape, generator=gen, device=dev)
    xs = [t.to(torch.bfloat16).requires_grad_() for t in base]
    refs = [t.to(torch.bfloat16).float().requires_grad_() for t in base]
    out = fa.flash_attention(*xs)
    (out.float() * w).sum().backward()
    want = ra.reference_attention(*refs)
    (want * w).sum().backward()
    torch.cuda.synchronize()
    errs = {"out": (out.float() - want).abs().max().item()}
    ok = errs["out"] <= FLASH_OUT_TOL
    for name, x, r in zip("qkv", xs, refs):
        g, rg = x.grad.float(), r.grad
        errs[f"d{name}"] = (g - rg).abs().max().item()
        ok = ok and x.grad.dtype == torch.bfloat16 and bool(
            ((g - rg).abs() <= FLASH_GRAD_ATOL + FLASH_GRAD_RTOL
             * rg.abs()).all())
    log(f"  flash_attention {list(shape)} fwd+bwd vs autograd of the f32 "
        f"oracle: {errs} (out {FLASH_OUT_TOL}; grads rtol {FLASH_GRAD_RTOL}"
        f" atol {FLASH_GRAD_ATOL})")
    if not ok:
        raise RuntimeError(f"flash_attention forward/backward disagrees: {errs}")
    return errs


def long_context_path(torch, mesh, ra, n_cards: int) -> tuple:
    """ringattention's per-rank body for both strategies at run()'s
    defaults and the flash ring at the long shape, one rank per card;
    returns rank 0's results, the flash ring's worst row error and the
    flash launches summed over the ranks."""
    def shape(b, s, h, d):
        return dict(seq_len=s, n_heads=h, head_dim=d, batch=b)

    cases = [dict(strategy="ring", **shape(*FLASH_RUN_SHAPE)),
             dict(strategy="ulysses", **shape(*FLASH_RUN_SHAPE)),
             dict(strategy="ring", use_flash=True,
                  **shape(*FLASH_LONG_SHAPE))]
    ranks = mesh.spawn(ra.context_parallel_rank, n_cards, "cuda",
                       args=(cases,), timeout_s=600)
    launches = sum(rep.launches for rank in ranks for rep in rank)
    for case, rep in zip(cases, ranks[0]):
        log(f"  {case}: {rep.result} row_rel_err={rep.row_rel_err!r}")
        if not rep.result.correct:
            raise RuntimeError(f"context-parallel {case} failed: {rep}")
    # the flash ring's rows past the first shard see thousands of keys and
    # hold values of a few hundredths, below the harness's 2e-2: each row
    # is held to the plain version as the kernel is
    flash = ranks[0][2]
    if not flash.row_rel_err <= FLASH_OUT_ROW_RTOL:
        raise RuntimeError(f"the flash ring's rows disagree with the plain "
                           f"version: {flash.row_rel_err!r} > "
                           f"{FLASH_OUT_ROW_RTOL}")
    return [rep.result for rep in ranks[0]], flash.row_rel_err, launches


def flash_bound(spec, bh, s, d) -> tuple:
    """(bound_ms, bound_by) of one causal [bh, s, d] bf16 attend: two
    products over the s*(s+1)/2 visible pairs against the bf16 peak, and
    q, k, v read and out written in bf16, m and l written in f32."""
    flops = 4.0 * bh * d * s * (s + 1) / 2
    nbytes = 4 * bh * s * d * 2 + 2 * bh * s * 4
    ops_ms = flops / (spec.peak_bf16_tflops * 1e12) * 1e3
    bytes_ms = nbytes / (spec.hbm_bw_gbps * 1e9) * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def time_flash(torch, fa, dev, gen, spec, shape, plain_iters) -> dict:
    """Kernel, plain version and SDPA on one causal [B*H, S, D] block."""
    B, S, H, D = shape
    bh = B * H
    q, k, v = flash_inputs(torch, dev, gen, bh, S, S, D)
    q4, k4, v4 = (t[None] for t in (q, k, v))

    def kernel():
        fa.flash_attention_blocks(q, k, v, 0, 0, True)

    def plain():
        fa.flash_attention_blocks_reference(q, k, v, 0, 0, True)

    def library():
        torch.nn.functional.scaled_dot_product_attention(q4, k4, v4,
                                                         is_causal=True)

    plain_runs = [cuda_ms(torch, plain, iters=plain_iters, warmup=1)]
    kernel_runs = [cuda_ms(torch, kernel), cuda_ms(torch, kernel)]
    plain_runs.append(cuda_ms(torch, plain, iters=plain_iters, warmup=1))
    library_ms = cuda_ms(torch, library)
    bound_ms, bound_by = flash_bound(spec, bh, S, D)
    ms = min(kernel_runs)
    return {"shape": list(shape), "ms": ms, "ms_runs": kernel_runs,
            "plain_ms": min(plain_runs), "plain_ms_runs": plain_runs,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "fraction_of_bound": bound_ms / ms,
            "tflops": 4.0 * bh * D * S * (S + 1) / 2 / (ms * 1e-3) / 1e12}


def time_ring_parts(torch, fa, ra, dev, gen) -> dict:
    """The one-card flash ring's call at the long shape, part by part
    with CUDA events: the fold of q, k, v to contiguous [B*H, S, D] (the
    copies that ``flash_attention_blocks`` makes of the folded views),
    kernel B2, the unfold of its output (out * l back to [B, S, H, D]),
    the merge into the running state, and the rest of the call (the
    running state's zeros and the final division)."""
    B, S, H, D = FLASH_LONG_SHAPE
    q, k, v = (torch.randn(FLASH_LONG_SHAPE, generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    fold = lambda t: t.transpose(1, 2).reshape(B * H, -1, D).contiguous()
    fq, fk, fv = fold(q), fold(k), fold(v)
    out, m, l = fa.flash_attention_blocks(fq, fk, fv, 0, 0, True)
    blk = ra._block_attend_flash(q, k, v, 0, 0, True)
    o0 = torch.zeros(FLASH_LONG_SHAPE, dtype=torch.float32, device=dev)
    l0 = torch.zeros((B, H, S), dtype=torch.float32, device=dev)
    m0 = l0 + fa.NEG_INF

    def rest():
        o = torch.zeros_like(q, dtype=torch.float32)
        lz = torch.zeros((B, H, S), dtype=torch.float32, device=dev)
        return lz + fa.NEG_INF, (o / torch.where(
            lz == 0.0, 1.0, lz).transpose(1, 2)[..., None]).to(q.dtype)

    parts = {
        "fold_ms": cuda_ms(torch, lambda: (fold(q), fold(k), fold(v))),
        "kernel_ms": cuda_ms(
            torch, lambda: fa.flash_attention_blocks(fq, fk, fv, 0, 0, True)),
        "unfold_ms": cuda_ms(torch, lambda: (out.float() * l[..., None])
                             .reshape(B, H, S, D).transpose(1, 2)),
        "merge_ms": cuda_ms(torch, lambda: ra.merge(o0, l0, m0, *blk)),
        "rest_ms": cuda_ms(torch, rest),
    }
    parts["sum_ms"] = sum(parts[key] for key in (
        "fold_ms", "kernel_ms", "unfold_ms", "merge_ms", "rest_ms"))
    log(f"  flash ring call at {list(FLASH_LONG_SHAPE)} on one card, by "
        f"part: {parts}")
    return parts


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


@contextlib.contextmanager
def environ(**values):
    """os.environ with ``values`` set (None: unset), restored on exit."""
    old = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_dcn_proofs(cli, barrier) -> dict:
    """``-c dcn`` on this one node (skipped), then as node 1 of 2 whose
    rendezvous is a listener this script opens on 127.0.0.1 (the kernel
    completes the handshake; nothing accepts); returns both files."""
    files = {}
    one_node = dict(GPU_NUM_NODES=None, MASTER_ADDR=None, MASTER_PORT=None,
                    GROUP_RANK=None, DCN_BANDWIDTH_PROBE=None)
    with environ(**one_node):
        rc = cli.main(["-c", "dcn"])
        files["single_node"] = info = barrier.read_status("dcn-ready")
    log(f"  -c dcn, one node: rc={rc}, dcn-ready: {info}")
    if rc != 0 or info is None or "SKIPPED" not in info:
        raise RuntimeError(f"validator -c dcn on one node: rc={rc} {info}")
    barrier.clear_status("dcn-ready")
    with socket.socket() as srv:
        srv.bind(("127.0.0.1", 0))
        srv.listen(4)
        port = srv.getsockname()[1]
        with environ(**dict(one_node, GPU_NUM_NODES="2",
                            MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                            GROUP_RANK="1")):
            rc = cli.main(["-c", "dcn"])
            files["two_nodes"] = info = barrier.read_status("dcn-ready")
    log(f"  -c dcn, node 1 of 2, rendezvous 127.0.0.1:{port}: rc={rc}, "
        f"dcn-ready: {info}")
    if rc != 0 or info is None or "RTT_MS" not in info:
        raise RuntimeError(f"validator -c dcn against the listener: rc={rc} "
                           f"{info}")
    return files


def burnin_checks_rank(rank, world_size, device, ckdir: str) -> dict:
    """Per-rank body for ``mesh.spawn`` (one rank per card): at
    ``BurninConfig``'s defaults on the [data, model] mesh of every rank,
    one TP and one FSDP step on one batch; ``dryrun.resume_matches`` on
    the TP state (save, restore into a fresh differently seeded init with
    every parameter, moment and step count bit-equal, and a next step
    whose loss equals the uninterrupted run's bit for bit; it raises
    otherwise); then the TP step timed."""
    import torch

    from tpu_operator_torch import dryrun
    from tpu_operator_torch.parallel.mesh import build_mesh
    from tpu_operator_torch.workloads import burnin

    cfg = burnin.BurninConfig()
    mesh = build_mesh()
    step, init_state, _ = burnin.make_train_step(mesh, cfg)
    fstep, finit, _ = burnin.make_train_step(mesh, cfg, fsdp=True)
    batch, batch2 = (burnin.make_batch(cfg, mesh, s) for s in (0, 1))
    tp, loss = step(init_state(0), batch)
    fs, floss = fstep(finit(0), batch)
    del fs
    resume = dryrun.resume_matches(step, init_state, tp, batch2, ckdir)

    step_s = time_steps(torch, step, tp, batch, device)
    busy = profile_steps(torch, step, tp, batch, device)
    # the same step without a mesh, no DTensor: on one card it does the
    # same work, so the difference is DTensor's and the collectives' cost
    pstep, pinit, _ = burnin.make_train_step(None, cfg, device=device)
    plain_s = time_steps(torch, pstep, pinit(0), burnin.make_batch(
        cfg, None, 0, device=device), device)
    return {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "tp_loss": float(loss), "fsdp_loss": float(floss),
            "resume": resume, "save_s": resume["save_s"],
            "restore_s": resume["restore_s"],
            "step_ms_runs": [t * 1e3 for t in step_s],
            "step_ms": min(step_s) * 1e3,
            "tokens_per_s": cfg.batch * cfg.seq_len / min(step_s),
            "plain_step_ms_runs": [t * 1e3 for t in plain_s],
            "plain_step_ms": min(plain_s) * 1e3, "profile": busy,
            # the card's idle share of the unprofiled step
            "device_idle_share": None if busy["busy_ms"] is None
            else 1.0 - busy["busy_ms"] / (min(step_s) * 1e3)}


def time_steps(torch, step, state, batch, device) -> list:
    """Seconds per train step, one figure per repeat, after warm-up."""
    for _ in range(BURNIN_WARMUP):
        state, _ = step(state, batch)
    torch.cuda.synchronize(device)
    runs = []
    for _ in range(BURNIN_REPEATS):
        t0 = time.perf_counter()
        for _ in range(BURNIN_TIMED_STEPS):
            state, _ = step(state, batch)
        torch.cuda.synchronize(device)
        runs.append((time.perf_counter() - t0) / BURNIN_TIMED_STEPS)
    return runs


def profile_steps(torch, step, state, batch, device) -> dict:
    """``BURNIN_TIMED_STEPS`` steps under ``torch.profiler``: the card's
    busy time a step (the sum of its kernels' and copies' own times; the
    spans of annotated regions, such as the optimizer's step, are left
    out, since their kernels are counted), the device operations a step
    and the five longest, and the wall time a step under the profiler.
    Where the profiler records no device time, the device figures are
    None (not measured)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(BURNIN_TIMED_STEPS):
            state, _ = step(state, batch)
        torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3 / BURNIN_TIMED_STEPS
    on_device = [e for e in prof.key_averages()
                 if e.self_device_time_total > 0 and e.self_cpu_time_total == 0
                 and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(e.self_device_time_total for e in on_device) / 1e3 \
        / BURNIN_TIMED_STEPS
    if busy_ms == 0:
        return {"wall_ms": wall_ms, "busy_ms": None, "device_ops": None}
    top = sorted(on_device, key=lambda e: -e.self_device_time_total)[:5]
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "device_ops": sum(e.count for e in on_device) / BURNIN_TIMED_STEPS,
            "top": [(e.key[:60], e.self_device_time_total / 1e3
                     / BURNIN_TIMED_STEPS) for e in top]}


def burnin_path(mesh, card: str, n_cards: int) -> dict:
    """Phase 8; returns its figures."""
    from tpu_operator_torch import dryrun
    from tpu_operator_torch.parallel import multihost
    from tpu_operator_torch.workloads import burnin

    cfg = burnin.BurninConfig()
    t0 = time.perf_counter()
    first, last = burnin.run()
    run_s = time.perf_counter() - t0
    log(f"  burnin.run() at {cfg}: first_loss={first!r} last_loss={last!r} "
        f"in {run_s:.1f}s")
    if not last < first:
        raise RuntimeError(f"the burn-in's loss did not fall: {first} -> "
                           f"{last}")
    with tempfile.TemporaryDirectory(prefix="burnin-ckpt-") as ckdir:
        ranks = mesh.spawn(burnin_checks_rank, n_cards, "cuda",
                           args=(ckdir,), timeout_s=600)
    r0 = ranks[0]
    rel = abs(r0["fsdp_loss"] - r0["tp_loss"]) / abs(r0["tp_loss"])
    log(f"  mesh {r0['mesh']}: tp_loss={r0['tp_loss']!r} "
        f"fsdp_loss={r0['fsdp_loss']!r} rel={rel!r} (limit "
        f"{BURNIN_FSDP_RTOL})")
    if not rel <= BURNIN_FSDP_RTOL:
        raise RuntimeError(f"FSDP and TP losses disagree: {rel!r}")
    # resume_matches raised in the rank unless every restored tensor and
    # the next loss were bit-equal
    for i, r in enumerate(ranks):
        log(f"  rank {i}: restored step 1 into a fresh init: "
            f"{r['resume']['tensors_restored']} parameter and optimizer "
            f"tensors bit-equal; the next step (step "
            f"{r['resume']['resumed_step']}) loss {r['resume']['loss']!r} "
            f"bit-equal to the uninterrupted run's")
    figures = {"card": card, "cards": n_cards, "config": str(cfg),
               "run_first_loss": first, "run_last_loss": last,
               "run_seconds": run_s, **r0}
    if n_cards >= 2:
        probe = multihost.fake_slices_probe(2, size_mb=DCN_PROBE_SIZE_MB)
        log(f"  DCN probe over 2 fake slices of {n_cards // 2} card(s) on "
            f"one node (NVLink traffic, no network): {probe}")
        if not probe.correct or probe.slices != 2:
            raise RuntimeError(f"the DCN probe moved wrong data: {probe}")
        figures["dcn_probe_nvlink"] = probe.__dict__
    else:
        log("  DCN probe: skipped, two fake slices need two cards and this "
            "host has one")
    if n_cards >= 4 and n_cards % 2 == 0:
        figures["dryrun"] = dryrun.dryrun_multichip(n_cards)
        log(f"  dryrun_multichip({n_cards}): {figures['dryrun']}")
    else:
        log(f"  dryrun_multichip: skipped, needs an even number >= 4 of "
            f"cards, this host has {n_cards}")
    return figures


def parallel_checks_rank(rank, world_size, device) -> dict:
    """Per-rank body for ``mesh.spawn`` (one rank per card): the pipeline
    and MoE cases at ``run()``'s defaults and at the wide shapes, timed
    (rank 0 holds each to its oracle), then the conv burn-in's train step
    at ``ConvBurninConfig``'s defaults on the training mesh, timed and
    profiled."""
    import torch

    from tpu_operator_torch.parallel import multihost
    from tpu_operator_torch.workloads import convburn, moe, pipeline

    def case(report) -> dict:
        return {**report.result.__dict__, "oracle_max": report.oracle_max,
                "ms": report.seconds * 1e3}

    out = {
        "pipeline": case(pipeline.pipeline_case(device,
                                                repeats=PARALLEL_REPEATS)),
        "pipeline_wide": case(pipeline.pipeline_case(
            device, repeats=PARALLEL_REPEATS, **PIPELINE_WIDE)),
        "moe": case(moe.moe_case(device, repeats=PARALLEL_REPEATS)),
        "moe_wide": case(moe.moe_case(device, repeats=PARALLEL_REPEATS,
                                      **MOE_WIDE)),
    }
    torch.cuda.empty_cache()
    cfg = convburn.ConvBurninConfig()
    cmesh = multihost.training_mesh()
    step, init_state = convburn.make_train_step(cmesh, cfg)
    state, batch = init_state(0), convburn.make_batch(cfg, cmesh, 0)
    step_s = time_steps(torch, step, state, batch, device)
    busy = profile_steps(torch, step, state, batch, device)
    out["conv"] = {
        "mesh": dict(zip(cmesh.mesh_dim_names, cmesh.shape)),
        "step_ms_runs": [t * 1e3 for t in step_s],
        "step_ms": min(step_s) * 1e3,
        "images_per_s": cfg.batch / min(step_s), "profile": busy,
        "device_idle_share": None if busy["busy_ms"] is None
        else 1.0 - busy["busy_ms"] / (min(step_s) * 1e3)}
    return out


def parallel_path(mesh, card: str, n_cards: int, dryrun) -> dict:
    """Phase 9; returns its figures."""
    from tpu_operator_torch.workloads import convburn, moe, pipeline

    figures = {"card": card, "cards": n_cards}
    for name, run in (("pipeline_run", pipeline.run), ("moe_run", moe.run)):
        t0 = time.perf_counter()
        res = run()
        figures[name] = {**res.__dict__,
                         "run_seconds": time.perf_counter() - t0}
        log(f"  {name.replace('_', '.')}(): {res} in "
            f"{figures[name]['run_seconds']:.1f}s")
        if not res.correct:
            raise RuntimeError(f"{name.replace('_', '.')}() diverged from its "
                               f"oracle: {res}")
    cfg = convburn.ConvBurninConfig()
    t0 = time.perf_counter()
    first, last = convburn.run()
    figures["conv_run"] = {"config": str(cfg), "first_loss": first,
                           "last_loss": last,
                           "run_seconds": time.perf_counter() - t0}
    log(f"  convburn.run() at {cfg}: first_loss={first!r} "
        f"last_loss={last!r} in {figures['conv_run']['run_seconds']:.1f}s")
    if not last < first:
        raise RuntimeError(f"the conv burn-in's loss did not fall: {first} "
                           f"-> {last}")
    r0 = mesh.spawn(parallel_checks_rank, n_cards, "cuda", timeout_s=600)[0]
    for name in ("pipeline", "pipeline_wide", "moe", "moe_wide"):
        rep = r0[name]
        log(f"  {name}: max_abs_err={rep['max_abs_err']!r} "
            f"oracle_max={rep['oracle_max']!r} ms={rep['ms']!r} ({rep})")
        if name.endswith("_wide"):
            limit = WIDE_RTOL * rep["oracle_max"]
            if not rep["max_abs_err"] <= limit:
                raise RuntimeError(f"{name} diverged from its oracle: "
                                   f"{rep['max_abs_err']!r} > {limit!r}")
        elif not rep["correct"]:
            raise RuntimeError(f"{name} diverged from its oracle: {rep}")
    log(f"  conv train step on {r0['conv']['mesh']}: "
        f"{r0['conv']['step_ms']!r} ms, {r0['conv']['images_per_s']!r} "
        f"images/s, card idle {r0['conv']['device_idle_share']!r}")
    figures.update(r0)
    if dryrun is not None:
        figures["dryrun_stages"] = {k: dryrun[k] for k in (
            "conv_loss", "pipeline_stages", "pipeline_err", "moe_experts",
            "moe_err")}
    return figures


# --- phases A-D and the all-reduce step on several cards -------------------


def prom_series(text: str) -> dict:
    """{(gauge, labels): value} of a Prometheus exposition text."""
    from prometheus_client.parser import text_string_to_metric_families

    out = {}
    for family in text_string_to_metric_families(text):
        for s in family.samples:
            out[(s.name, tuple(sorted(s.labels.items())))] = s.value
    return out


def http_get(url: str) -> tuple:
    import urllib.request

    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.status, resp.read()


def node_exporter_phase(barrier, files: dict) -> dict:
    """Phase A: the node-status exporter over the barrier files the chain
    just wrote. Each gauge equals its file's figure (the driver's card
    count, the cuda and hbm figures must be there; the NVLink figure
    where the proof measured one); ``serve`` answers /metrics and
    /healthz; after the preStop clean-up the figures are gone."""
    from tpu_operator_torch.validator import metrics as node_metrics

    node = "smoke"
    m = node_metrics.NodeMetrics(node)
    m.collect_once()
    got = prom_series(m.render().decode())

    def gauge(name, **labels):
        return got.get((f"gpu_operator_node_{name}",
                        tuple(sorted(dict(labels, node=node).items()))))

    want = {
        "gpus": float(files["driver-ready"]["CHIP_COUNT"]),
        "matmul_tensor_core_utilization": float(
            files["cuda-ready"]["TENSOR_CORE_UTILIZATION"]),
        "hbm_fraction_of_peak": float(files["hbm-ready"]["FRACTION_OF_PEAK"]),
    }
    nvlink = files["nvlink-ready"].get("FRACTION_OF_PEAK")
    want_nvlink = None if nvlink is None else float(nvlink)
    seen = {name: gauge(name) for name in want}
    seen["nvlink_fraction_of_peak"] = gauge("nvlink_fraction_of_peak")
    ready = {c: gauge("component_ready", component=c)
             for c in node_metrics.COMPONENT_FILES}
    log(f"  NodeMetrics gauges: {seen}; component_ready: {ready}")
    for name, value in want.items():
        if seen[name] != value:
            raise RuntimeError(f"exporter gauge {name}={seen[name]!r}, its "
                               f"barrier file says {value!r}")
    if seen["nvlink_fraction_of_peak"] != want_nvlink:
        raise RuntimeError(f"exporter NVLink figure "
                           f"{seen['nvlink_fraction_of_peak']!r}, nvlink-ready "
                           f"says {want_nvlink!r}")
    if ready != {"driver": 1.0, "runtime": 1.0, "cuda": 1.0, "plugin": 0.0,
                 "nvlink": 1.0}:
        raise RuntimeError(f"exporter readiness {ready} does not follow the "
                           f"barrier files")
    stop = threading.Event()
    server = node_metrics.serve(0, node_name=node, stop_event=stop)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        code, body = http_get(url + "/metrics")
        hcode, hbody = http_get(url + "/healthz")
    finally:
        stop.set()
        server.shutdown()
        server.server_close()
    log(f"  serve(0): GET /metrics {code} ({len(body)} bytes), /healthz "
        f"{hcode} {hbody!r}")
    if code != 200 or hcode != 200 or prom_series(body.decode()) != got:
        raise RuntimeError("the exporter's server did not serve its gauges")
    barrier.cleanup_all()
    m.collect_once()
    left = sorted({k[0] for k in prom_series(m.render().decode())}
                  & {f"gpu_operator_node_{n}" for n in seen if n != "gpus"})
    log(f"  after cleanup_all: figure gauges left {left}")
    if left:
        raise RuntimeError(f"figure gauges outlived their files: {left}")
    return {"gauges": seen, "component_ready": ready,
            "metrics_bytes": len(body)}


# a child's timestamps (time.time(), this host's clock) from its start to
# CUDA ready: interpreter up, torch imported, a context on the card, the
# first cuBLAS product done
POD_START_PROBE = """
import json, sys, time
t = {"main": time.time()}
import torch
t["torch_imported"] = time.time()
x = torch.ones(1, device="cuda")
torch.cuda.synchronize()
t["cuda_context"] = time.time()
a = torch.randn(1024, 1024, device="cuda", dtype=torch.bfloat16)
(a @ a).sum().item()
t["first_matmul"] = time.time()
print(json.dumps(t))
"""


def pod_payload_phase(card: str) -> dict:
    """Phase B: the CUDA validation pod's container command and env, as
    ``cuda_workload_pod`` builds them, run as a process on the card from
    the checkout's root. rc 0 and a finite checksum are required; its
    wall time is logged, then split by a second process into interpreter
    start, torch's import, the CUDA context and the first cuBLAS product."""
    from tpu_operator_torch.validator import workload

    pod = workload.cuda_workload_pod("gpu-operator", "smoke-node",
                                     "checkout", matmul_size=MATMUL_SIZE,
                                     request_gpu=False)
    container = pod["spec"]["containers"][0]
    cmd = list(container["command"])
    env = dict(os.environ, **{e["name"]: e["value"]
                              for e in container["env"]})
    env["PYTHONPATH"] = os.getcwd()
    log(f"  pod {pod['metadata']['name']}: {cmd} env "
        f"{container['env']} ({shutil.which(cmd[0])})")
    t0 = time.time()
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=300)
    wall = time.time() - t0
    result = json.loads(out.stdout.strip().splitlines()[-1]) \
        if out.returncode == 0 and out.stdout.strip() else None
    log(f"  rc={out.returncode} in {wall:.3f}s wall: {result}")
    if out.returncode != 0 or not result or not result.get("checksum_ok"):
        raise RuntimeError(f"the pod's payload failed (rc={out.returncode}): "
                           f"{out.stderr[-2000:]}")
    t0 = time.time()
    probe = subprocess.run([cmd[0], "-c", POD_START_PROBE], env=env,
                           capture_output=True, text=True, timeout=120)
    if probe.returncode != 0:
        raise RuntimeError(f"the start-up probe failed: {probe.stderr[-2000:]}")
    t = json.loads(probe.stdout.strip().splitlines()[-1])
    start = {"interpreter_s": t["main"] - t0,
             "import_torch_s": t["torch_imported"] - t["main"],
             "cuda_context_s": t["cuda_context"] - t["torch_imported"],
             "first_matmul_s": t["first_matmul"] - t["cuda_context"],
             "to_cuda_ready_s": t["first_matmul"] - t0}
    log(f"  a process's start to CUDA ready ({card}): {start}")
    return {"wall_s": wall, "result": result, "start": start}


def telemetry_phase(torch, card: str) -> dict:
    """Phase C: ``gpu-telemetry`` built at first use and run once (one row
    a visible card; NVML's memory total within TELEMETRY_HBM_RTOL of
    torch's, the temperature in (0, 110) where NVML reports one); its
    ``--watch 1`` engine read through ``NativeEngine`` for two fresh
    ticks, and its duty cycle above 0 while a bf16 matmul chain runs
    (unless NVML refuses utilisation); the exporter and the torch
    collector agree with it; ``collect_native`` itself returns the cards."""
    from tpu_operator_torch.metrics import gpu_exporter as exp
    from tpu_operator_torch.workloads import matmul

    n = torch.cuda.device_count()
    with environ(GPU_TELEMETRY_BIN=None, GPU_TELEMETRY_WATCH=None,
                 GPU_FAKE_CHIPS=None, GPU_HEALTH_ENGINE_INFO=None):
        t0 = time.perf_counter()
        binary = exp.telemetry_binary()
        log(f"  gpu-telemetry: {binary} ready in "
            f"{time.perf_counter() - t0:.2f}s")
        out = subprocess.run([binary], capture_output=True, text=True,
                             timeout=60)
        rows = json.loads(out.stdout)
        refused = sorted(set(re.findall(r"(nvml\w+): Not Supported",
                                        out.stderr)))
        log(f"  one scan: rc={out.returncode} rows={rows}")
        log(f"  NVML refused: {refused or 'nothing'}; stderr "
            f"{out.stderr.strip()!r}")
        if out.returncode != 0 or len(rows) != n:
            raise RuntimeError(f"gpu-telemetry saw {len(rows)} cards of {n}")
        totals = []
        for i, row in enumerate(rows):
            free, total = torch.cuda.mem_get_info(i)
            rel = abs(row["hbm_total_bytes"] - total) / total
            totals.append({"nvml": row["hbm_total_bytes"], "torch": total,
                           "rel": rel})
            log(f"  gpu{i}: NVML total {row['hbm_total_bytes']} bytes, "
                f"torch.cuda.mem_get_info total {total} bytes, rel {rel!r} "
                f"(limit {TELEMETRY_HBM_RTOL}); temperature "
                f"{row['temperature_c']!r} C")
            if not row["hbm_usage_known"] or not rel <= TELEMETRY_HBM_RTOL:
                raise RuntimeError(f"NVML's memory total disagrees: {row}")
            temp = row["temperature_c"]
            if temp is not None and not 0 < temp < 110:
                raise RuntimeError(f"gpu{i} temperature {temp} C")

        engine = exp.NativeEngine(binary, 1)
        try:
            def wait_ticks(k, limit_s):
                want = engine.ticks + k
                deadline = time.monotonic() + limit_s
                while engine.ticks < want:
                    if time.monotonic() > deadline or not engine.alive():
                        raise RuntimeError(f"gpu-telemetry --watch 1 gave "
                                           f"{engine.ticks} ticks")
                    time.sleep(0.05)
                return engine.latest_samples()

            wait_ticks(2, 10)  # two fresh ticks while idle
            idle = engine.latest_samples()
            # a chain of 16384-square bf16 products (~8.8 TFLOP each) the
            # card works through for ~3 s, enqueued at once
            a, b = matmul.inputs(TELEMETRY_MATMUL, torch.device("cuda", 0))
            c = matmul.chain(a, b, TELEMETRY_PRODUCTS)
            busy = [wait_ticks(1, 5) for _ in range(2)]
            torch.cuda.synchronize()
            finite = bool(torch.isfinite(c[:1, :1].float()).all())
            del a, b, c
        finally:
            engine.stop()
        duty = max(s[0].duty_cycle_pct for s in busy)
        log(f"  --watch 1: {engine.ticks} ticks; idle duty "
            f"{[s.duty_cycle_pct for s in idle]}, under the matmul chain "
            f"{[[x.duty_cycle_pct for x in s] for s in busy]} (finite "
            f"{finite}); engine stopped: {not engine.alive()}")
        if engine.alive():
            raise RuntimeError("the telemetry engine outlived stop()")
        if "nvmlDeviceGetUtilizationRates" not in refused and not duty > 0:
            raise RuntimeError("NVML's duty cycle stayed 0 under load")

        native = exp.collect_native()
        cuda = exp.collect_cuda()
        exporter = exp.GpuExporter("smoke")
        served = exporter.collect_once()
    log(f"  collect_native: {[vars(s) for s in native]}")
    log(f"  collect_cuda: {[vars(s) for s in cuda]}")
    log(f"  GpuExporter.collect_once: {served} card(s)")
    if len(native) != n:
        raise RuntimeError(f"collect_native returned {len(native)} cards")
    if served != n:
        raise RuntimeError(f"the exporter served {served} cards of {n}")
    for s, t in zip(native, cuda):
        if not abs(s.hbm_total - t.hbm_total) <= \
                TELEMETRY_HBM_RTOL * t.hbm_total:
            raise RuntimeError(f"collect_cuda's total {t.hbm_total} is not "
                               f"NVML's {s.hbm_total}")
    return {"card": card, "rows": rows, "totals": totals,
            "nvml_refused": refused, "ticks": engine.ticks,
            "duty_idle": [s.duty_cycle_pct for s in idle],
            "duty_busy": duty}


def entry_phase(torch, card: str) -> dict:
    """Phase D: ``entry()`` on the card; finite logits of the reference's
    shape, and ms a call by CUDA events."""
    from tpu_operator_torch import entry

    fn, args = entry.entry()
    with torch.no_grad():
        logits = fn(*args)
        torch.cuda.synchronize()
        shape = list(logits.shape)
        finite = bool(torch.isfinite(logits).all())
        ms = cuda_ms(torch, lambda: fn(*args))
    cfg = entry.CONFIG
    log(f"  entry() on {args[1].device}: logits {shape} {logits.dtype}, "
        f"finite {finite}; {ms!r} ms a call ({card})")
    if shape != [cfg.batch, cfg.seq_len, cfg.vocab] or not finite:
        raise RuntimeError(f"entry() gave logits {shape}, finite {finite}")
    return {"shape": shape, "ms": ms, "card": card}


def allreduce_step_rank(rank, world_size, device, size_mb: float) -> dict:
    """Per-rank body (one rank per card): the NVLink proof's all-reduce
    step (``collectives._step``, in place) against a bare in-place
    ``dist.all_reduce`` and against the step with a copy first, at the
    proof's per-rank size, in turns (step, bare, copy, copy, bare,
    step); each 40 calls a repeat after 10 warm-up, the best of 5."""
    import torch
    import torch.distributed as dist

    from tpu_operator_torch.workloads import collectives

    n = world_size
    k = max(1, int(size_mb * 1e6 / 4) // (n * n)) * n * n
    x = torch.ones(k, dtype=torch.float32, device=device)
    # the bare sum runs on zeros, which it keeps (ones would grow n-fold a
    # call); the step keeps its ones
    zeros = torch.zeros_like(x)
    scale = 1.0 / n

    def step():
        collectives._step("all_reduce", x, n, rank)

    def bare():
        dist.all_reduce(zeros)

    def copy_first():
        y = x.clone()
        dist.all_reduce(y)
        y.mul_(scale)

    def best_ms(fn) -> float:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(5):
            dist.barrier()
            t0 = time.perf_counter()
            for _ in range(40):
                fn()
            torch.cuda.synchronize()
            best = min(best, (time.perf_counter() - t0) / 40)
        return best * 1e3

    runs = {"step": [], "bare": [], "copy_first": []}
    for name in ("step", "bare", "copy_first", "copy_first", "bare", "step"):
        runs[name].append(best_ms({"step": step, "bare": bare,
                                   "copy_first": copy_first}[name]))
    gb = k * 4 / 1e9
    bus = 2.0 * (n - 1) / n * gb
    return {"bytes_per_rank": k * 4, "ms_runs": runs,
            **{f"{name}_ms": min(r) for name, r in runs.items()},
            **{f"{name}_algo_gbps": gb / (min(r) / 1e3)
               for name, r in runs.items()},
            **{f"{name}_bus_gbps": bus / (min(r) / 1e3)
               for name, r in runs.items()}}


def allreduce_step_phase(mesh, n_cards: int, card: str) -> dict:
    """``allreduce_step_rank`` over every card with NCCL's TUNING debug
    written to files, whose algorithm and protocol lines for the proof's
    size are logged."""
    with tempfile.TemporaryDirectory(prefix="nccl-tuning-") as d:
        with environ(NCCL_DEBUG="INFO", NCCL_DEBUG_SUBSYS="TUNING",
                     NCCL_DEBUG_FILE=os.path.join(d, "nccl.%h.%p.log")):
            r0 = mesh.spawn(allreduce_step_rank, n_cards, "cuda",
                            args=(NVLINK_PROOF_SIZE_MB,), timeout_s=600)[0]
        lines = []
        for name in sorted(os.listdir(d)):
            with open(os.path.join(d, name), errors="replace") as f:
                lines += [ln.strip() for ln in f
                          if "AllReduce" in ln or "lgo" in ln]
    size = str(r0["bytes_per_rank"])
    at_size = [ln for ln in lines if size in ln]
    choices = sorted({re.sub(r"^.*?\] ", "", re.sub(r"time [\d.]+", "", ln))
                      for ln in at_size})
    log(f"  all-reduce at {r0['bytes_per_rank']} bytes a rank over "
        f"{n_cards} cards ({card}): {r0}")
    log(f"  NCCL TUNING: {len(lines)} all-reduce or algorithm lines, "
        f"{len(at_size)} at this size; distinct at this size: "
        f"{choices[:8]}; first lines: {lines[:6]}")
    return {**r0, "nccl_algo_lines": choices[:8],
            "nccl_lines_total": len(lines)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a card",
              file=sys.stderr)
        return 1

    from tpu_operator_torch.cli import validator as cli
    from tpu_operator_torch.kernels import build
    from tpu_operator_torch.parallel import mesh
    from tpu_operator_torch.validator import barrier
    from tpu_operator_torch.workloads import (collectives, hbm_probe, matmul,
                                              ringattention)
    from tpu_operator_torch.workloads import flashattention as fa
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
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        builds = dict(zip(KERNELS, pool.map(build.build, KERNELS)))
    for name, built in builds.items():
        log(f"  {name}: {built.path.name} built in {built.seconds:.2f}s")
        for line in built.log.splitlines():
            log(f"    {line}")
    flash_spills = check_flash_build(builds["flash_attention"].log)

    # 3. kernels against their plain versions
    log("# phase 3: kernels vs plain versions")
    gen = torch.Generator(device=dev).manual_seed(0)
    ragged = (1001, 333)  # 333333 elements: not a multiple of 4
    triad_err = max(check_triad(torch, hbm_probe, dev, gen, TRIAD_SHAPE, 0),
                    check_triad(torch, hbm_probe, dev, gen, ragged, 0),
                    check_triad(torch, hbm_probe, dev, gen, TRIAD_SHAPE, 1))
    B, S, H, D = FLASH_RUN_SHAPE
    LB, LS, LH, LD = FLASH_LONG_SHAPE
    ra = ringattention
    flash_errs = [
        check_flash(torch, fa, ra, dev, gen, "run() shape", B * H, S, S, D),
        check_flash(torch, fa, ra, dev, gen, "run() shape", B * H, S, S, D,
                    causal=False),
        check_flash(torch, fa, ra, dev, gen, "long context", LB * LH, LS, LS,
                    LD),
        check_flash(torch, fa, ra, dev, gen, "ragged", 8, 1000, 1000, 128),
        check_flash(torch, fa, ra, dev, gen, "ragged", 8, 1000, 1000, 64,
                    causal=False),
        check_flash(torch, fa, ra, dev, gen, "ring hop", 8, 1000, 600, 128,
                    q_offset=2000, k_offset=1700),
        # multiples of 64 that are not of 128: a half-empty last Q tile
        # and K/V chunk
        check_flash(torch, fa, ra, dev, gen, "ragged", 8, 4160, 4160, 128),
        # a ring hop whose first 60 rows see no key, inside a block whose
        # later rows do
        check_flash(torch, fa, ra, dev, gen, "dead rows", 8, 1000, 1000, 128,
                    q_offset=1700, k_offset=1760, dead_rows=60),
        check_flash(torch, fa, ra, dev, gen, "non-causal", 8, 4096, 4096,
                    128, causal=False),
        check_flash_merge(torch, fa, ra, dev, gen, FLASH_RUN_SHAPE)]
    flash_err = max(e["out"] for e in flash_errs)
    flash_row_rel = max(e["out_row_rel"] for e in flash_errs)
    check_flash_future_block(torch, fa, dev, gen, B * H, S, D)

    # 4. the main path, counted
    log("# phase 4: validator chain")
    valdir = tempfile.mkdtemp(prefix="gpu-validations-")
    os.environ.update(GPU_VALIDATION_DIR=valdir, MATMUL_SIZE=str(MATMUL_SIZE),
                      HBM_SIZE_MB=str(HBM_SIZE_MB))
    try:
        hbm_probe.triad_.launches = 0
        files = run_validator_chain(cli, barrier)
        triad_launches = hbm_probe.triad_.launches
        dcn_files = run_dcn_proofs(cli, barrier)
        log("# phase 4A: node-status exporter over the chain's barrier "
            "files")
        exporter = node_exporter_phase(barrier, files)
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

    # 6. the long-context path, counted: the ranks are fresh processes
    # whose counts start at 0, and report their own
    log(f"# phase 6: long-context path over {torch.cuda.device_count()} "
        f"card(s)")
    torch.cuda.empty_cache()
    fa.flash_attention_blocks.launches = 0
    t0 = time.perf_counter()
    cp_results, ring_row_rel, rank_launches = long_context_path(
        torch, mesh, ringattention, torch.cuda.device_count())
    grad_errs = check_flash_attention_grad(torch, fa, ringattention, dev, gen)
    flash_launches = rank_launches + fa.flash_attention_blocks.launches
    log(f"  flash launches on the path: {flash_launches} ({rank_launches} "
        f"in the ranks, {fa.flash_attention_blocks.launches} in "
        f"flash_attention) in {time.perf_counter() - t0:.1f}s")
    if rank_launches == 0 or fa.flash_attention_blocks.launches == 0:
        raise RuntimeError("the long-context path did not launch the flash "
                           "kernel")

    # 7. timings
    log("# phase 7: timings")
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
    flash_run = time_flash(torch, fa, dev, gen, spec, FLASH_RUN_SHAPE,
                           plain_iters=5)
    flash_long = time_flash(torch, fa, dev, gen, spec, FLASH_LONG_SHAPE,
                            plain_iters=2)
    ring_parts = time_ring_parts(torch, fa, ringattention, dev, gen)
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
        "flash_attention": {"run_shape": flash_run, "long_shape": flash_long,
                            "grad_check": grad_errs,
                            "ptxas_spills": flash_spills,
                            "ring_call_parts": ring_parts},
        "context_parallel": [r.__dict__ for r in cp_results],
        "dcn_ready": dcn_files,
    }
    log(json.dumps(timings))

    # 8. the burn-in: no kernel of this repo lies on it (its attention is
    # einsum, as JAX's is jnp), so no count is read here
    log(f"# phase 8: burn-in over {torch.cuda.device_count()} card(s)")
    torch.cuda.empty_cache()
    burnin_figures = burnin_path(mesh, card, torch.cuda.device_count())
    log(json.dumps({"burnin": burnin_figures}))

    # 9. the parallel workloads: no kernel of this repo lies on them (their
    # products and convolutions are torch's, as JAX leaves them to XLA),
    # so no count is read here
    log(f"# phase 9: pipeline, MoE and conv burn-in over "
        f"{torch.cuda.device_count()} card(s)")
    torch.cuda.empty_cache()
    parallel = parallel_path(mesh, card, torch.cuda.device_count(),
                             burnin_figures.get("dryrun"))
    log(json.dumps({"parallel_workloads": parallel}))

    # 10-13: the pod's payload, chip telemetry, the forward entry point and
    # the NVLink proof's all-reduce step; no kernel of this repo lies on
    # them (the matmul is cuBLAS's, the forward's attention einsum), and
    # the counts read after them say so
    hbm_probe.triad_.launches = 0
    fa.flash_attention_blocks.launches = 0
    log("# phase 10 (B): the CUDA validation pod's payload")
    pod = pod_payload_phase(card)
    log("# phase 11 (C): chip telemetry (NVML through gpu-telemetry)")
    telemetry = telemetry_phase(torch, card)
    log("# phase 12 (D): forward entry point")
    entry_figures = entry_phase(torch, card)
    n_cards = torch.cuda.device_count()
    log(f"# phase 13: the NVLink proof's all-reduce step over {n_cards} "
        f"card(s)" + (" (nothing crosses a link: the step is its mul_, and "
                      "copy_first adds the copy's cost)" if n_cards == 1
                      else ""))
    allreduce = allreduce_step_phase(mesh, n_cards, card)
    log(f"  kernel launches in phases 10-13: triad "
        f"{hbm_probe.triad_.launches}, flash "
        f"{fa.flash_attention_blocks.launches}")
    log(json.dumps({"node_exporter": exporter, "pod_payload": pod,
                    "telemetry": telemetry, "entry": entry_figures,
                    "allreduce_step": allreduce}))

    # 14. the kernel table
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
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "tpu_operator_torch/csrc/flash_attention.cu",
        "replaces": "tpu_operator/workloads/flashattention.py:35",
        "launches": flash_launches,
        "max_abs_err": flash_err,
        "tolerance": FLASH_OUT_TOL,
        "max_row_rel_err": flash_row_rel,
        "row_rtol": FLASH_OUT_ROW_RTOL,
        "ring_row_rel_err": ring_row_rel,
        "shape": flash_long["shape"],
        "ms": flash_long["ms"],
        "plain_ms": flash_long["plain_ms"],
        "bound_ms": flash_long["bound_ms"],
        "bound_by": flash_long["bound_by"],
        "library_ms": flash_long["library_ms"],
        "library_ratio": flash_long["ms"] / flash_long["library_ms"],
        "fraction_of_bound": flash_long["fraction_of_bound"],
    }]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
