#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one card and check it.

    python3 chip_smoke.py    # from the root of a checkout, on a CUDA host

Six paths of ``tpu_operator_torch`` are driven. The per-node validation
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
forward entry point run on the card, the node's allocation plane hands
the card to child processes, and the topology manager groups the cards
behind the device plugin. The operator's reconcile renders the validator
DaemonSet, whose init containers run on the card as processes, first
driven pass by pass and then by the operator's runtime (the Manager's
watches, workqueue and informer cache); under that runtime a driver CR's
rollout walks the node through the upgrade FSM, a SliceRequest is placed
and the burn-in trainer on it is carried through a second rollout by the
elastic handshake, and the port's headline bench runs as a process.
Phases, each fatal:

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build the hand-written kernels from the checkout's sources, one nvcc
   per source, all at once; the two instantiations of each flash kernel
   (forward and backward) must spill nothing, keep their setmaxnreg (no
   ptxas warning C7508) and their asynchronous wgmma (no C7512);
3. hold each kernel against its plain PyTorch version on the card: the
   triad at the main path's shape, a ragged length and a misaligned view;
   flash attention at the harness's and the long context's shapes, ragged
   lengths (also multiples of 64 that are not of 128), ring-hop offsets,
   rows that see no key inside a live block (exact), a block wholly in
   the future (exact), non-causal D=128 and a two-block merge; the
   backward kernel at the training cell's shape, ragged lengths,
   non-causal D=128, D=64 and dead rows (their dq exactly 0); the backward
   kernel on ``flash_attention``'s fold views at B = 1 against itself on
   their contiguous copies (dk and dv bit-equal, dq within the contiguous
   path's own run-to-run difference), and on a misaligned q, which only
   the copying fallback takes;
4. run the validator chain with the triad's count set to 0, and require
   that the chain went through the kernel and wrote every barrier file;
   then the DCN proof, once on this one node (skipped) and once as node 1
   of 2 against a TCP listener this script opens on 127.0.0.1 (RTT_MS);
5. run the collective suite over NCCL at world size 1 against its oracle;
6. run the long-context path with the flash kernels' counts set to 0, and
   require that it is correct and went through the kernels (the backward
   through ``flash_attention``'s gradient check); at both training cells'
   widths, profile ``flash_attention``'s backward: B3's three kernels
   alone on the card, no operand copied, the leaves' gradients contiguous;
7. time each kernel beside its bound, its plain version and the library
   call computing the same function (SDPA's backward for the backward
   kernel, timed here only), the matmul proof, and the parts of the flash
   ring's call on one card (fold, kernel, merge);
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
E. the node's allocation plane, against a stub apiserver (one Node, GET,
   metadata-only GET, merge-PATCH) and a stub kubelet (Registration on a
   unix socket): the driver agent's versions equal nvidia-smi's, the
   runtime agent's card nodes open, preflight clears every gate; the
   shared plugin lists gpu0..gpuN-1 with torch's UUIDs, and its
   Allocate's card is the one a child sees alone by UUID; the health
   engine warns on a card filled to 0.95 of NVML's total and clears when
   it is freed, and a FAILing card is advertised Unhealthy; the fence
   moves cards to the isolated plugin; a vGPU profile re-registers it as
   nvidia.com/vgpu, and PyTorch's allocator holds two children to the
   budget of its Allocate (0.9 of it fits, 1.1 raises OOM); fencing-ready,
   vgpu-ready and their gauges; the fence withdrawn; feature discovery's
   labels, patched once. No kernel launches in it;
F. the topology manager, against the stub apiserver (now also listing
   its nodes, with a stub peer node): NVML's NVLink facts per card (the
   UUIDs torch's, the active links nvidia-smi's), feature discovery's
   topology and multihost from them; the reference's profiles: ``full``
   one group of every card, an unknown profile ``failed``, grouped
   agreement on a multi-host pool (``GPU_TOPOLOGY=mnnvl-<n>``) ``pending``
   until the peer asks for the same profile, then ``success``;
   ``split-2`` ``failed`` on one card; on four, ``[gpu0, gpu1]`` and
   ``[gpu2, gpu3]``, NVLink peers per NVML, served by the shared plugin
   as ``slice0``/``slice1``, and one child per group (both at once, then
   one alone) seeing its two cards alone by UUID and running phase 13's
   all-reduce step over them, correct, with bus GB/s. No kernel launches
   in it;
G. the operator's reconcile path on the port's FakeClient: a GPU node
   built from the card (feature discovery's NVML labels, GKE's
   nvidia-h100-80gb, the cards allocatable) beside a CPU node, and a
   GPUClusterPolicy whose nvlinkBandwidthThreshold is NVLINK_THRESHOLD.
   The first pass is notReady with a 5 s requeue, stamps present,
   gpu.generation, gpu.chips and the deploy labels on the GPU node alone,
   and applies every enabled state's objects. The device plugin's
   rendered wait, cut to 2 s, fails; the rendered validator DaemonSet's
   init containers then run in order, each its command's
   [project.scripts] target with its rendered args and env as a process
   (only the volume mounts stood in for: GPU_VALIDATION_DIR, HOST_ROOT=/,
   and the stub apiserver for the service account), each exiting 0 and
   writing its barrier file; plugin-validation's pod is played by the
   stub apiserver as a process; dcn-validation records the single-node
   skip; hbm-validation's child launches the triad. Every operand's
   rendered wait then passes; with the kubelet simulated the policy is
   ready (Ready=True, clusterInfo, the gpu_nodes and gpu_chips gauges), a
   steady pass writes nothing, and disabling the metrics exporter removes
   its DaemonSet. ms per pass and per state, seconds per container;
H. the operator's runtime: ``gpu-operator --fake-cluster --once
   --fake-gpu-nodes 1`` as a process (rc 0, seconds); then phase G's
   cluster under the Manager as ``gpu-operator`` wires it (the informer
   cache, the tracing client, leader election, a snapshot dir, the
   GPUClusterPolicy controller at two workers, the health server on an
   ephemeral port), and no direct reconcile() call: the policy created,
   a kubelet thread plays the rendered validator DaemonSet's init
   containers on the card (hbm-validation's child launches the triad),
   every operand's wait, then marks the DaemonSets ready, and the
   policy reaches ready by a reconcile caused by a DaemonSet's watch
   event. Install-to-ready, each reconcile's ms, queue wait and causes;
   /healthz, /metrics (the reconcile histogram's count = the
   controller's), /debug/traces (a state span, ready, for every enabled
   state; ms a state), /debug/timeline (new -> notReady -> ready),
   /debug/cache (cached, its reads), /debug/slo, /debug/snapshot, the
   Lease held; 5 s steady with one more pass through the queue: no write
   but the elector's Lease renewals, no get or list past the cache; a
   restart from the snapshot written at stop: restored, converged, no
   write but the Lease's;
I (before H). ``python -m tpu_operator_torch.bench`` as a process, its
   rider's fleet, placement-fleet and restart parts at 2000 nodes: one
   JSON line that parses; the matmul proof (one card) or the all-reduce
   (several) correct, and the triad on one card; no ``error`` anywhere
   in it; the scale part ``ready`` with no request left once cached;
   both rollouts rolled; scored placement packing at least as well as
   first fit, the elastic migration losing no acked step, warm and cold
   restarts deciding alike, the fair policy fairer than the baseline.
   The line and the triad's launches in the bench's process are printed;
J (under H's restarted manager). A GPUDriver over the card's pool (the
   policy's driver state stands down), auto-upgrade on, a workload pod
   holding the cards, then the GPUDriver's driverVersion set to the
   version nvidia-smi reports, which changes the driver's template. The
   node's upgrade.state transitions, recorded as they happen, walk
   upgrade-required -> cordon -> migrate -> drain -> pod-restart ->
   validation -> uncordon -> done; the workload leaves by the FSM's
   eviction; a kubelet thread plays the recreated driver pod (preflight,
   gpu-driver-install proving the pinned version) and the recreated
   validator pod's init containers on the card (hbm-validation's child
   launches the triad), and validation waits for that pod; the node ends
   uncordoned. Seconds from the version change to done, and a stage;
K (after J, under the same manager, now with ``sliceplacement``). A
   second node of the card's pool joins (the card's product and topology
   labels, its cards allocatable, its rollouts paused), its validator pod
   played on the card by a kubelet thread; a SliceRequest for the card's
   count is placed on the first node by watch events alone, with a
   ``placed-by`` lease; the burn-in trainer at ``BurninConfig``'s
   defaults runs in a process on the card under the port's
   ``ElasticWorkload`` over ``DCPCheckpointStore`` (exactly
   ``steps_per_tick`` train steps a tick; the trainer reaches the
   FakeClient through a bridge on 127.0.0.1); unpinning the GPUDriver's
   ``driverVersion`` walks the placed node into migrate-required, where
   the migrator posts the intent, the trainer checkpoints and acks,
   ``find_replacement`` rebinds the request onto the second node, and a
   new trainer process restores the acked step there (Resumed); the FSM
   then drains (the trainer's pod evicted after the rebind), revalidates
   through the recreated validator pod on the card and ends in done. The
   stages and migration phases in order, the acked step restored, the
   binding and leases moved, and the nine losses after the resume equal
   (``torch.equal``) an uninterrupted run's from the same seed; ms of the
   placement, s from intent to ack, ms from ack to rebind, s from rebind
   to resumed, and s from the version change to done against J's;
N (after M). The operator as it is deployed, over HTTP:
   ``tests/mock_apiserver.py`` on 127.0.0.1 (its lazy imports of the JAX
   package answered by the port's modules), a kubeconfig, the card's
   node and a CPU node; ``install.sh install`` with leader election and
   two replicas; the rendered operator Deployment's container as two
   ``gpu-operator`` processes through $KUBECONFIG; a kubelet thread on a
   second HTTPClient plays the validator pod on the card (the plugin
   pod through the same apiserver) and marks the DaemonSets. Ready, the
   Lease held by one replica, ``gpuop-cfg status`` READY and ``diff``
   clean; 10 s steady with no write but the Lease's and the standby
   idle; three devicePlugin mutations applied (one through five
   injected 409s, one after every watch stream dropped); the leader
   SIGKILLed, the standby leading within the Lease and rewriting no
   DaemonSet, a mutation after it applied; ``install.sh uninstall
   --purge-crds`` leaving no CR, DaemonSet or CRD. Then
   ``python -m tpu_operator_torch.scripts.hbm_sweep`` (every point
   correct) and ``end-to-end.sh`` (nine stages, the workload proof on
   the card) as processes;
14. print the kernel table as one JSON line.

The last line is ``{"ok": true, "device": {...}}``; on any failure the
script exits non-zero and prints no such line. Imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import math
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

KERNELS = ("triad", "flash_attention", "flash_attention_bwd")
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
# the backward kernel (B3) vs its plain version, dq, dk and dv each, bf16
# inputs. B3 rounds P and dS to bf16 as MMA operands where the plain
# version keeps them f32, both round the gradients to bf16, and dQ's
# partial sums land in an order that changes from run to run (bulk
# reductions from many blocks): each a relative 2**-9 at most, of rounding
# noise that does not add up across a row, and read 0.0025-0.0028 of the
# whole tensor's norm on the H100. So the whole tensor is held to 2**-7
# (a margin of ~3), and its worst row, against the larger of its norm and
# the median row's (rows of keys that few queries see are all but 0), to
# 2**-6 (the worst row read 0.0037-0.0053): a tile of 64 queries or 128
# keys dropped or misplaced moves its rows by far more
FLASH_BWD_RTOL = 2.0 ** -7
FLASH_BWD_ROW_RTOL = 2.0 ** -6
# the training cell's shape: forward and backward of [1, 16384, 16, 128]
FLASH_TRAIN_SHAPE = (1, 16384, 16, 128)
# the prefill cells' widths: [1, 65536, 16, 128], and the mixed replay's
# shortest call, 4095 positions (ragged Q tiles and K/V chunks)
FLASH_PREFILL_SHAPE = (1, 65536, 16, 128)
FLASH_MIXLEN_SHORT_SHAPE = (1, 4095, 16, 128)
# Trinity-Mini's attention period (attn.trinity-train-16k): [1, 16384, 32,
# 128] over 4 KV heads, three layers under a window of 2048 keys, one full
FLASH_LAYERS_SHAPE = (1, 16384, 32, 128)
FLASH_LAYERS_GROUP, FLASH_LAYERS_WINDOW = 8, 2048
# MiMo-V2-Flash's attention period (attn.mimo-prefill-mixlen): 64 query
# heads, keys 192 wide over values 128 wide; its full layer over 4 KV
# heads, its window layers over 8 under a 128-key window with a sink a
# head. Phase 6 runs the cell's shortest prompt, 8191 positions; phase 7
# times B2 at 16384
MIMO_HEADS, MIMO_D, MIMO_DV = 64, 192, 128
MIMO_FULL_KV, MIMO_SWA_KV, MIMO_WINDOW = 4, 8, 128
MIMO_CHECK_SEQ, MIMO_TIME_SEQ = 8191, 16384
# the cell's second prompt, ragged: the persistent kernel's last Q tile
# holds 127 rows
MIMO_RAGGED_SEQ = 16383
# DeepSeek-V3's MLA attention in training (attn.dsv3-train-16k): 128
# heads at group 1, keys 192 wide (128 + a 64-wide rope key that every
# head shares) over values 128 wide, at 16384 positions; the softmax
# scale by DeepSeek's rule, 192**-0.5 * mscale**2 with YaRN's mscale =
# 0.1 * mscale_all_dim * ln(factor) + 1 (factor 40, mscale_all_dim 1)
MLA_HEADS, MLA_D, MLA_DV, MLA_SEQ = 128, 192, 128, 16384
MLA_SCALE = MLA_D ** -0.5 * (0.1 * 1 * math.log(40) + 1) ** 2


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


# a flash kernel's instantiations: head width, and whether it is the band
# variant (grouped KV heads, a sliding window, a sink) or the MHA one; B2
# adds keys 192 wide over values 128 wide, a band one alone, and the
# persistent kernel (``flash_fwd_persistent``) that its band calls with a
# window take, at every width
FLASH_INSTANTIATIONS = ("64", "128", "64.band", "128.band")
FLASH_FWD_INSTANTIATIONS = FLASH_INSTANTIATIONS + (
    "192x128.band", "64.persistent", "128.persistent", "192x128.persistent")
# B3 adds keys 192 wide over values 128 wide, a band one alone, as B2
FLASH_BWD_INSTANTIATIONS = FLASH_INSTANTIATIONS + ("192x128.band",)
# registers a thread that ptxas reports for the MHA instantiations of B2
# and B3: a block of 384 threads, one a multiprocessor, starts with 65536
# / 384 rounded down to a multiple of 8, and setmaxnreg moves them between
# the producer and the consumers. The band variant must leave them so: a
# higher figure means a launch bound changed, and either spills or
# serialises the wgmma where the budget is spent
FLASH_MHA_REGISTERS = 168


def check_flash_build(log_text: str, kernel: str = "flash_fwd") -> dict:
    """ptxas's report of a flash kernel (``flash_fwd``, B2, or
    ``flash_bwd``, B3): bytes spilled (stores, loads) and registers a
    thread per instantiation, keyed by head width (``<d>x<dv>`` where the
    values are narrower), ``.band`` for the band variant and
    ``.persistent`` for B2's persistent kernel. Fails unless
    all of the kernel's instantiations are there with nothing spilled and
    the MHA ones at ``FLASH_MHA_REGISTERS``, where ptxas ignored
    setmaxnreg (C7508) or where it serialised the wgmma for want of
    registers (C7512)."""
    instantiations = (FLASH_FWD_INSTANTIATIONS if kernel == "flash_fwd"
                      else FLASH_BWD_INSTANTIATIONS)
    spills, regs, name, last = {}, {}, None, None
    for line in log_text.splitlines():
        if "Function properties for" in line or "Compiling entry" in line:
            found = re.search(kernel + r"(_persistent)?ILi(\d+)E"
                              r"(?:Li(\d+)E)?(?:Lb([01])E)?", line)
            name = None
            if found:
                persistent, d, dv, band = found.groups()
                name = (d if dv in (None, d) else f"{d}x{dv}") + (
                    ".persistent" if persistent
                    else ".band" if band == "1" else "")
        elif name is not None and "spill stores" in line:
            spills[name] = tuple(int(n) for n in re.findall(
                r"(\d+) bytes spill (?:stores|loads)", line))
            last, name = name, None
        elif last is not None and "Used" in line and "registers" in line:
            found = re.search(r"Used (\d+) registers", line)
            if found:
                regs[last] = int(found.group(1))
            last = None
    log(f"  {kernel} spills (stores, loads) by instantiation: {spills}; "
        f"registers a thread: {regs}")
    if "C7508" in log_text or "setmaxnreg ignored" in log_text:
        raise RuntimeError(f"ptxas ignored setmaxnreg in {kernel}")
    if "C7512" in log_text:
        raise RuntimeError(f"ptxas serialised the wgmma of {kernel}")
    if sorted(spills) != sorted(instantiations) \
            or any(any(v) for v in spills.values()):
        raise RuntimeError(f"{kernel} spills or lacks an instantiation: "
                           f"{spills}")
    moved = {k: regs.get(k) for k in instantiations
             if "." not in k and regs.get(k) != FLASH_MHA_REGISTERS}
    if moved:
        raise RuntimeError(f"{kernel}'s MHA registers a thread moved from "
                           f"{FLASH_MHA_REGISTERS}: {moved}")
    return {k: {"spills": spills[k], "registers": regs.get(k)}
            for k in instantiations}


def flash_inputs(torch, dev, gen, bh, sq, sk, d, group=1, dv=None):
    """q [bh, sq, d], k [bh / group, sk, d] and v [bh / group, sk, dv]
    (dv = d by default), bf16."""
    return tuple(torch.randn((n, s, w), generator=gen, device=dev)
                 .to(torch.bfloat16)
                 for n, s, w in ((bh, sq, d), (bh // group, sk, d),
                                 (bh // group, sk, dv or d)))


def flash_sinks(torch, dev, gen, heads):
    """f32 [heads] sink logits, uniform in [2, 6] nats, as the MiMo cell
    draws them: a window row's sink holds 4-65% of its softmax's mass."""
    return torch.rand(heads, generator=gen, device=dev) * 4 + 2


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
                k_offset=0, causal=True, dead_rows=0, group=1,
                window=None, dv=None, sinks=False) -> dict:
    """Kernel vs plain version on seeded bf16 inputs; returns the errors.
    The first ``dead_rows`` rows (or the rows of a ``slice``) see no key:
    there out == 0, l == 0 and m == -1e30 exactly (with sinks m == the
    row's sink and l == 1), and every other row sees one.
    ``group`` query rows share each K/V row, ``window`` is the sliding
    window's keys, ``dv`` the values' width (d by default), and ``sinks``
    gives each row a sink logit."""
    q, k, v = flash_inputs(torch, dev, gen, bh, sq, sk, d, group, dv)
    s = flash_sinks(torch, dev, gen, bh) if sinks else None
    o, m, l = fa.flash_attention_blocks(q, k, v, q_offset, k_offset, causal,
                                        window=window, sinks=s)
    ro, rm, rl = fa.flash_attention_blocks_reference(
        q, k, v, q_offset, k_offset, causal, q_tile=4096 // group,
        window=window, sinks=s)
    torch.cuda.synchronize()
    if dead_rows:
        dead = (dead_rows if isinstance(dead_rows, slice)
                else slice(0, dead_rows))
        rows = torch.zeros(sq, dtype=torch.bool, device=dev)
        rows[dead] = True
        dead_m = fa.NEG_INF if s is None else s[:, None]
        exact = (bool((o[:, rows] == 0).all())
                 and bool((l[:, rows] == (0 if s is None else 1)).all())
                 and bool((m[:, rows] == dead_m).all())
                 and bool((l[:, ~rows] > (0 if s is None else 1)).all()))
        log(f"  flash {label}: rows {dead.start}..{dead.stop - 1} out==0, "
            f"l==0 (1 with sinks), m==-1e30 (the sink) exactly and the "
            f"other rows live: {exact}")
        if not exact:
            raise RuntimeError(f"flash kernel: the dead rows of {label} are "
                               f"not exactly empty")
    live = rl > 0
    errs = dict(out_errors(ra, o, ro), m=(m - rm).abs().max().item(),
                l_rel=((l - rl).abs()[live] / rl[live]).max().item()
                if bool(live.any()) else (l - rl).abs().max().item())
    require_flash_close(f"{label} [{bh}, {sq}|{sk}, {d}|{dv or d}] "
                        f"offsets=({q_offset}, {k_offset}) causal={causal} "
                        f"group={group} window={window} sinks={sinks}",
                        errs)
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


def check_flash_attention_layers(torch, fa, ra, dev, gen,
                                 shape=FLASH_LAYERS_SHAPE,
                                 group=FLASH_LAYERS_GROUP,
                                 window=FLASH_LAYERS_WINDOW) -> dict:
    """``flash_attention`` forward and backward at Trinity-Mini's widths
    (q [B, S, H, D], k and v over H / group KV heads), under its window
    and with none, on the same inputs folded by hand: out against the
    forward's plain version, the gradients against the backward's plain
    version on B2's residuals. Each call must make one B2 and one B3
    launch, both counted
    as grouped, and as windowed where the window is set: the fold of k
    and v by their own head count and the window's way through autograd,
    on the card."""
    B, S, H, D = shape
    hkv = H // group
    q, dout = (torch.randn((B, S, H, D), generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((B, S, hkv, D), generator=gen, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    fold = lambda t: t.transpose(1, 2).reshape(B * t.shape[2], S, D)
    entries = (fa.flash_attention_blocks, fa.flash_bwd)
    names = ("launches", "window_calls", "grouped_calls")
    out = {}
    for label, w in (("window", window), ("full", None)):
        xs = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        for fn in entries:
            for name in names:
                setattr(fn, name, 0)
        o = fa.flash_attention(*xs, causal=True, window=w)
        o.backward(dout)
        counts = {f"{fn.__name__}.{name}": getattr(fn, name)
                  for fn in entries for name in names}
        # (the CPU path, for a rehearsal, counts no launch)
        want = {f"{fn.__name__}.{name}": int(
            (name != "window_calls" or w is not None)
            and (name != "launches" or dev.type == "cuda"))
                for fn in entries for name in names}
        qf, kf, vf, gf = fold(q), fold(k), fold(v), fold(dout)
        ro, rm, rl = fa.flash_attention_blocks_reference(
            qf, kf, vf, 0, 0, True, q_tile=4096 // group, window=w)
        # the backward's plain version on B2's own residuals, as
        # check_flash_bwd holds B3: dq's first rows are differences of
        # near-equal terms, which out's bf16 rounding moves (logged below
        # against the plain forward's residuals)
        bo, bm, bl = fa.flash_attention_blocks(qf, kf, vf, 0, 0, True,
                                               window=w)
        grads = fa.flash_bwd_reference(qf, kf, vf, bo, bm, bl, gf, True,
                                       chunk=128, window=w)
        plain_dq = fa.flash_bwd_reference(qf, kf, vf, ro, rm, rl, gf, True,
                                          chunk=128, window=w)[0]
        if dev.type == "cuda":
            torch.cuda.synchronize()
        errs = out_errors(ra, fold(o.detach()), ro)
        dq, pdq = (t.float().reshape(-1, D) for t in (fold(xs[0].grad),
                                                       plain_dq))
        n = pdq.norm(dim=-1)
        rows = (dq - pdq).norm(dim=-1) / torch.clamp(n, min=float(n.median()))
        errs["dq_row_vs_plain_fwd"] = rows.max().item()
        errs["dq_row_vs_plain_fwd_at"] = int(rows.argmax()) % S
        ok = errs["out"] <= FLASH_OUT_TOL and errs["out_row_rel"] <= \
            FLASH_OUT_ROW_RTOL and counts == want
        for name, x, r in zip(("dq", "dk", "dv"), xs, grads):
            e = grad_errors(torch, fold(x.grad), r)
            errs[f"{name}_rel"], errs[f"{name}_row"] = e["rel"], e["row"]
            ok = ok and x.grad.dtype == torch.bfloat16 \
                and x.grad.shape == x.shape \
                and e["rel"] <= FLASH_BWD_RTOL \
                and e["row"] <= FLASH_BWD_ROW_RTOL
        log(f"  flash_attention {list(shape)} over {hkv} KV heads, "
            f"window={w}: {errs}, counters {counts} (out {FLASH_OUT_TOL} "
            f"abs and {FLASH_OUT_ROW_RTOL} a row; grads "
            f"{FLASH_BWD_RTOL} the tensor, {FLASH_BWD_ROW_RTOL} a row; "
            f"counters {want})")
        if not ok:
            raise RuntimeError(f"flash_attention at {list(shape)} over {hkv} "
                               f"KV heads, window={w}, disagrees with the "
                               f"plain versions or left the band path: "
                               f"{errs}, {counts}")
        out[label] = dict(errs, counters=counts)
        del xs, o, ro, rm, rl, bo, bm, bl, grads, plain_dq, dq, pdq, rows
    return out


def device_ops(torch, fn) -> list:
    """The names of the device operations (kernels, copies, memsets) that
    ``fn()`` runs, under ``torch.profiler``, sorted, without their
    arguments."""
    act = torch.profiler.ProfilerActivity
    with tempfile.TemporaryDirectory() as tmp:
        with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    return sorted({re.sub(r"^void |\(anonymous namespace\)::|\(.*$", "",
                          e.get("name", ""))
                   for e in events if e.get("cat") in (
                       "kernel", "gpu_memcpy", "gpu_memset")})


def check_flash_fwd_no_copies(torch, fa, dev, gen, label, shape, hkv,
                              window=None, dv=None, sinks=False) -> dict:
    """``flash_attention``'s forward at B = 1 under ``torch.profiler``:
    on the card only B2 (``flash_fwd``: no copy, no elementwise kernel)
    runs, ``flash_attention_blocks.copies`` does not rise, the unfolded
    output is contiguous [1, S, H, DV], and the call is counted once in
    ``.split_calls`` where the values (``dv`` wide) are narrower than the
    keys, in ``.sink_calls`` with ``sinks`` and in ``.persistent_calls``
    with a ``window`` (``flash_fwd_persistent`` runs then). B2's out, m
    and l on the fold views must be bit-equal to B2's on contiguous copies
    of the same inputs, and so must the unfolded output to that out."""
    _, S, H, D = shape
    DV = dv or D
    q = torch.randn((1, S, H, D), generator=gen, device=dev).to(
        torch.bfloat16)
    k, v = (torch.randn((1, S, hkv, w), generator=gen, device=dev)
            .to(torch.bfloat16) for w in (D, DV))
    s = flash_sinks(torch, dev, gen, H) if sinks else None
    fold = lambda t: t.transpose(1, 2).reshape(t.shape[2], S, t.shape[3])
    views = [fold(t) for t in (q, k, v)]
    counters = ("copies", "split_calls", "sink_calls", "persistent_calls")
    found = {}

    def forward():
        with torch.no_grad():
            found["o"] = fa.flash_attention(q, k, v, causal=True,
                                            window=window, sinks=s)

    # once before the profiler: a kernel's first launch in the process
    # (its lazy load) went unrecorded in one profiled call
    forward()
    torch.cuda.synchronize()
    before = {n: getattr(fa.flash_attention_blocks, n) for n in counters}
    names = device_ops(torch, forward)
    counts = {n: getattr(fa.flash_attention_blocks, n) - before[n]
              for n in counters}
    got = fa.flash_attention_blocks(*views, 0, 0, True, window=window,
                                    sinks=s)
    copies = fa.flash_attention_blocks.copies - before["copies"]
    want = fa.flash_attention_blocks(*(t.contiguous() for t in views), 0, 0,
                                     True, window=window, sinks=s)
    torch.cuda.synchronize()
    o = found.pop("o")
    res = {"device_ops": names, "copies": copies, "counters": counts,
           "out_m_l_equal": [bool(torch.equal(a, b))
                             for a, b in zip(got, want)],
           "unfolded_equal": bool(torch.equal(fold(o), want[0])),
           "unfolded_contiguous": o.is_contiguous(),
           "unfolded_shape": list(o.shape),
           "out_layout": list(got[0].stride())}
    if window:
        kernel = "flash_fwd_persistent<%d, %d>" % (D, DV)
    elif DV == D:
        kernel = "flash_fwd<%d, %d, %s>" % (
            D, D, "true" if hkv < H or sinks else "false")
    else:
        kernel = "flash_fwd<%d, %d, true>" % (D, DV)
    want_counts = {"copies": 0, "split_calls": int(DV != D),
                   "sink_calls": int(sinks),
                   "persistent_calls": int(bool(window))}
    log(f"  flash_attention's forward on fold views, {label} {list(shape)} "
        f"over {hkv} KV heads of {D}|{DV}, window={window}, sinks={sinks}: "
        f"{res} (want only [{kernel}], counters {want_counts}, bit-equal "
        f"to B2 on contiguous copies)")
    if names != [kernel] or copies or counts != want_counts \
            or not all(res["out_m_l_equal"]) or not res["unfolded_equal"] \
            or not res["unfolded_contiguous"] \
            or list(o.shape) != [1, S, H, DV]:
        raise RuntimeError(f"flash_attention's forward at {list(shape)}, "
                           f"window={window}, ran more than B2, copied or "
                           f"disagrees with B2 on contiguous copies: {res}")
    del q, k, v, views, got, want, o
    return res


def check_flash_attention_no_copies(torch, fa, dev, gen, shape, hkv,
                                    window=None, dv=None,
                                    scale=None) -> dict:
    """``flash_attention``'s backward at B = 1 under ``torch.profiler``:
    on the card only B3's three kernels run (``flash_bwd_pre``,
    ``flash_bwd``, ``flash_bwd_post``: no copy, no elementwise kernel),
    ``flash_bwd.copies`` does not rise, and the leaves' gradients come
    back contiguous, as autograd keeps them without a clone. ``dv`` is
    the values' width (D by default), ``scale`` the softmax scale's."""
    _, S, H, D = shape
    DV = dv or D
    q = torch.randn((1, S, H, D), generator=gen, device=dev).to(
        torch.bfloat16)
    dout = torch.randn((1, S, H, DV), generator=gen, device=dev).to(
        torch.bfloat16)
    k, v = (torch.randn((1, S, hkv, w), generator=gen, device=dev)
            .to(torch.bfloat16) for w in (D, DV))
    xs = [t.requires_grad_() for t in (q, k, v)]
    o = fa.flash_attention(*xs, causal=True, window=window, scale=scale)
    torch.cuda.synchronize()
    before = fa.flash_bwd.copies
    names = device_ops(torch, lambda: o.backward(dout))
    band = hkv < H or window or DV != D
    want = ["flash_bwd<%d, %d, %s>" % (D, DV, "true" if band else "false"),
            "flash_bwd_post<%d>" % D, "flash_bwd_pre<%d, %d>" % (D, DV)]
    res = {"device_ops": names, "copies": fa.flash_bwd.copies - before,
           "grads_contiguous": [x.grad.is_contiguous() for x in xs]}
    log(f"  flash_attention's backward at {list(shape)} over {hkv} KV heads "
        f"of {D}|{DV}, window={window}, scale={scale}: {res} (want only "
        f"{want}, no copy)")
    if names != sorted(want) or res["copies"] or not all(
            res["grads_contiguous"]):
        raise RuntimeError(f"flash_attention's backward at {list(shape)}, "
                           f"window={window}, ran more than B3 or copied: "
                           f"{res}")
    return res


def grad_errors(torch, x, r) -> dict:
    """The whole tensor's relative error and its worst row's, against the
    larger of the row's norm and the median row's."""
    x, r = x.float(), r.float()
    rows = r.reshape(-1, r.shape[-1])
    d = (x.reshape(-1, r.shape[-1]) - rows).norm(dim=-1)
    n = rows.norm(dim=-1)
    den = torch.clamp(n, min=float(n.median()))
    den = torch.where(den > 0, den, torch.ones_like(den))
    return {"rel": ((x - r).norm() / r.norm()).item(),
            "row": (d / den).max().item()}


def check_flash_bwd(torch, fa, dev, gen, label, bh, sq, sk, d, causal=True,
                    dead_rows=0, group=1, window=None, dv=None,
                    scale=None) -> dict:
    """Kernel B3 vs its plain version on seeded bf16 inputs and B2's
    residuals; returns the errors of dq, dk, dv. The first ``dead_rows``
    rows are made rows that see no key (out 0, m -1e30, l 0), as B2 leaves
    them: their dq must be exactly 0. ``group``, ``window`` and ``dv`` as
    ``check_flash``'s; ``scale`` the softmax scale (D**-0.5 if None)."""
    q, k, v = flash_inputs(torch, dev, gen, bh, sq, sk, d, group, dv)
    dout = torch.randn((bh, sq, dv or d), generator=gen, device=dev).to(
        torch.bfloat16)
    out, m, l = fa.flash_attention_blocks(q, k, v, 0, 0, causal,
                                          window=window, scale=scale)
    if dead_rows:
        out[:, :dead_rows] = 0
        m[:, :dead_rows] = fa.NEG_INF
        l[:, :dead_rows] = 0
    got = fa.flash_bwd(q, k, v, out, m, l, dout, causal, window=window,
                       scale=scale)
    # the plain version's [bh / group, group, sq, chunk] f32 scores within
    # 1 GiB
    chunk = 512 if group * sq <= 65536 and bh * sq <= 2 ** 19 else 128
    want = fa.flash_bwd_reference(q, k, v, out, m, l, dout, causal,
                                  chunk=chunk, window=window, scale=scale)
    torch.cuda.synchronize()
    errs = {}
    for name, x, r in zip(("dq", "dk", "dv"), got, want):
        e = grad_errors(torch, x, r)
        errs[f"{name}_rel"], errs[f"{name}_row"] = e["rel"], e["row"]
    ok = all(x.dtype == torch.bfloat16 for x in got) and all(
        errs[f"{n}_rel"] <= FLASH_BWD_RTOL
        and errs[f"{n}_row"] <= FLASH_BWD_ROW_RTOL for n in ("dq", "dk", "dv"))
    if dead_rows:
        errs["dead_dq_zero"] = bool((got[0][:, :dead_rows] == 0).all())
        ok = ok and errs["dead_dq_zero"]
    log(f"  flash_bwd {label} [{bh}, {sq}|{sk}, {d}|{dv or d}] "
        f"causal={causal} group={group} window={window} scale={scale}: "
        f"{errs} (tolerances {FLASH_BWD_RTOL} the tensor, "
        f"{FLASH_BWD_ROW_RTOL} a row)")
    if not ok:
        raise RuntimeError(f"flash backward kernel disagrees with its plain "
                           f"version on {label}: {errs}")
    return errs


def check_flash_bwd_views(torch, fa, dev, gen, label, shape, hkv=None,
                          window=None, misalign=False) -> dict:
    """Kernel B3 on ``flash_attention``'s fold views at B = 1 ([1, S, H, D]
    into [H, S, D] with strides (D, H*D)) against B3 on their contiguous
    copies, on the same inputs and B2's residuals: dk and dv must be
    bit-equal, and dq, whose f32 reductions land in a varying order, no
    further from the contiguous path's than that path's three runs lie
    from each other (by relative norm, with half as much again of room).
    The views must be taken as they are (``flash_bwd.copies`` unchanged);
    with ``misalign`` q starts one element past a 16-byte boundary, and
    only the copying fallback takes it."""
    _, S, H, D = shape
    hkv = hkv or H
    q, dout = (torch.randn((1, S, H, D), generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((1, S, hkv, D), generator=gen, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    if misalign:
        flat = torch.empty(q.numel() + 1, dtype=q.dtype, device=dev)
        q = flat[1:].view(q.shape).copy_(q)
    fold = lambda t: t.transpose(1, 2).reshape(t.shape[2], S, D)
    views = [fold(t) for t in (q, k, v, dout)]
    flat_ones = [t.contiguous() for t in views]
    out, m, l = fa.flash_attention_blocks(*flat_ones[:3], 0, 0, True,
                                          window=window)
    before = fa.flash_bwd.copies
    got = fa.flash_bwd(*views[:3], out, m, l, views[3], True, window=window)
    copies = fa.flash_bwd.copies - before
    runs = [fa.flash_bwd(*flat_ones[:3], out, m, l, flat_ones[3], True,
                         window=window) for _ in range(3)]
    torch.cuda.synchronize()

    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    spread = max(rel(a[0], b[0]) for i, a in enumerate(runs)
                 for b in runs[i + 1:])
    errs = {"copies": copies,
            "dq_rel": max(rel(got[0], r[0]) for r in runs),
            "dq_run_to_run": spread,
            "dk_equal": bool(torch.equal(got[1], runs[0][1])),
            "dv_equal": bool(torch.equal(got[2], runs[0][2])),
            "layouts_kept": [tuple(x.stride()) == tuple(t.stride()) for x, t
                             in zip(got, views)]}
    ok = errs["dk_equal"] and errs["dv_equal"] \
        and errs["dq_rel"] <= 1.5 * spread \
        and (copies >= 1 if misalign else copies == 0) \
        and all(errs["layouts_kept"][1:]) \
        and (misalign or errs["layouts_kept"][0])
    log(f"  flash_bwd on fold views, {label} {list(shape)} over {hkv} KV "
        f"heads, window={window}, q misaligned={misalign}: {errs} (dk, dv "
        f"bit-equal; dq within 1.5x the contiguous path's run-to-run; "
        f"copies {'>= 1' if misalign else '0'})")
    if not ok:
        raise RuntimeError(f"B3 on fold views disagrees with B3 on their "
                           f"contiguous copies on {label}: {errs}")
    return errs


def check_flash_bwd_refuses_sinks(torch, fa, dev, gen) -> dict:
    """On the card ``flash_bwd`` still refuses sinks (B3 has no sink
    gradient), by name, at split widths and at equal ones, and takes the
    same split-width call without them."""
    out = {}
    for d, dv in ((MIMO_D, MIMO_DV), (128, 128)):
        q, k, v = flash_inputs(torch, dev, gen, 8, 256, 256, d, 2, dv)
        s = flash_sinks(torch, dev, gen, 8)
        o, m, l = fa.flash_attention_blocks(q, k, v, 0, 0, True, sinks=s)
        dout = torch.randn_like(o)
        try:
            fa.flash_bwd(q, k, v, o, m, l, dout, True, sinks=s)
            msg = None
        except ValueError as e:
            msg = str(e)
        o, m, l = fa.flash_attention_blocks(q, k, v, 0, 0, True)
        taken = fa.flash_bwd(q, k, v, o, m, l, dout, True)
        torch.cuda.synchronize()
        out[f"{d}x{dv}"] = {"refused": msg,
                            "without_sinks_finite": all(
                                bool(t.isfinite().all()) for t in taken)}
    log(f"  flash_bwd with sinks on the card: {out}")
    if not all(r["refused"] and "sinks" in r["refused"]
               and r["without_sinks_finite"] for r in out.values()):
        raise RuntimeError(f"flash_bwd took sinks on the card, or refused "
                           f"the call without them: {out}")
    return out


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


def card_peak(spec):
    """The card's peaks as the benchmark's yardstick takes them
    (``perfbench/roofline.py``), from its published spec."""
    from perfbench import roofline

    return roofline.Peak(bf16_flops=spec.peak_bf16_tflops * 1e12,
                         hbm_bytes_s=spec.hbm_bw_gbps * 1e9,
                         nvlink_bytes_s=0.0)


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
    from perfbench import roofline

    bound_s, bound_by = roofline.flash_bound(card_peak(spec), bh, S, D)
    bound_ms = bound_s * 1e3
    ms = min(kernel_runs)
    return {"shape": list(shape), "ms": ms, "ms_runs": kernel_runs,
            "plain_ms": min(plain_runs), "plain_ms_runs": plain_runs,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "fraction_of_bound": bound_ms / ms,
            "tflops": roofline.attention_fwd_flops(bh, S, D)
            / (ms * 1e-3) / 1e12}


def time_flash_bwd(torch, fa, dev, gen, spec, shape) -> dict:
    """Kernel B3, its plain version and SDPA's backward on one causal
    [B*H, S, D] block, with B2's residuals."""
    B, S, H, D = shape
    bh = B * H
    q, k, v = flash_inputs(torch, dev, gen, bh, S, S, D)
    dout = torch.randn((bh, S, D), generator=gen, device=dev).to(
        torch.bfloat16)
    out, m, l = fa.flash_attention_blocks(q, k, v, 0, 0, True)
    q4, k4, v4 = (t[None].detach().requires_grad_() for t in (q, k, v))
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True)

    def kernel():
        fa.flash_bwd(q, k, v, out, m, l, dout, True)

    def plain():
        fa.flash_bwd_reference(q, k, v, out, m, l, dout, True)

    def library():
        torch.autograd.grad(sdpa_out, (q4, k4, v4), dout[None],
                            retain_graph=True)

    plain_runs = [cuda_ms(torch, plain, iters=2, warmup=1)]
    kernel_runs = [cuda_ms(torch, kernel), cuda_ms(torch, kernel)]
    plain_runs.append(cuda_ms(torch, plain, iters=2, warmup=1))
    library_ms = cuda_ms(torch, library)
    from perfbench import roofline

    flops = roofline.attention_bwd_flops(bh, S, D)
    bound_ms = flops / card_peak(spec).bf16_flops * 1e3
    ms = min(kernel_runs)
    return {"shape": list(shape), "ms": ms, "ms_runs": kernel_runs,
            "plain_ms": min(plain_runs), "plain_ms_runs": plain_runs,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": "operations", "fraction_of_bound": bound_ms / ms,
            "tflops": flops / (ms * 1e-3) / 1e12}


def time_flash_layers(torch, fa, dev, gen, spec) -> dict:
    """Kernels B2 and B3 (band instantiations; B2's persistent kernel
    under the window, which ``"persistent"`` records) at Trinity-Mini's
    window and full layers ([1, 16384, 32, 128] over 4 KV heads), each against
    its bound (``perfbench/roofline_layers.py``); SDPA's forward and
    backward on K/V repeated per group for the full layer (a window
    needs a dense mask there, so it is not timed)."""
    from perfbench import roofline, roofline_layers

    B, S, H, D = FLASH_LAYERS_SHAPE
    bh, g = B * H, FLASH_LAYERS_GROUP
    peak = card_peak(spec)
    q, k, v = flash_inputs(torch, dev, gen, bh, S, S, D, g)
    dout = torch.randn((bh, S, D), generator=gen, device=dev).to(
        torch.bfloat16)
    out = {}
    for name, w in (("window", FLASH_LAYERS_WINDOW), ("full", None)):
        o, m, l = fa.flash_attention_blocks(q, k, v, 0, 0, True, window=w)
        before = fa.flash_attention_blocks.persistent_calls
        fwd_ms = min(cuda_ms(torch, lambda: fa.flash_attention_blocks(
            q, k, v, 0, 0, True, window=w)) for _ in range(2))
        persistent = fa.flash_attention_blocks.persistent_calls > before
        bwd_ms = min(cuda_ms(torch, lambda: fa.flash_bwd(
            q, k, v, o, m, l, dout, True, window=w)) for _ in range(2))
        fb, fby = roofline_layers.layer_fwd_bound(peak, bh, bh // g, S, D, w)
        bb, bby = roofline_layers.layer_bwd_bound(peak, bh, bh // g, S, D, w)
        out[name] = {"window": w, "persistent": persistent,
                     "fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
                     "fwd_bound_ms": fb * 1e3, "fwd_bound_by": fby,
                     "bwd_bound_ms": bb * 1e3, "bwd_bound_by": bby,
                     "fwd_fraction_of_bound": fb * 1e3 / fwd_ms,
                     "bwd_fraction_of_bound": bb * 1e3 / bwd_ms}
        del o, m, l
    q4, k4, v4 = (t[None].detach().requires_grad_() for t in (
        q, k.repeat_interleave(g, 0), v.repeat_interleave(g, 0)))
    sdpa = torch.nn.functional.scaled_dot_product_attention(q4, k4, v4,
                                                            is_causal=True)
    out["full"]["library_fwd_ms"] = cuda_ms(
        torch, lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True))
    out["full"]["library_bwd_ms"] = cuda_ms(torch, lambda: torch.autograd.grad(
        sdpa, (q4, k4, v4), dout[None], retain_graph=True))
    log(f"  flash layers at {list(FLASH_LAYERS_SHAPE)} over {bh // g} KV "
        f"heads: {out}")
    return {"shape": list(FLASH_LAYERS_SHAPE), "group": g, **out}


def time_flash_split(torch, fa, dev, gen, spec) -> dict:
    """Kernel B2 at MiMo-V2-Flash's widths, [1, 16384, 64, 192] with
    values 128 wide: its full layer over 4 KV heads, and its window layer
    over 8 under a 128-key window with sinks (the persistent kernel, which
    ``"persistent"`` records), each against its bound
    (``perfbench/roofline_split.py``). No library call is timed beside
    it: SDPA's fused kernels take no values narrower than keys, nor
    sinks, and its plain one would hold [64, 16384, 16384] scores."""
    from perfbench import roofline_split

    S, H, d, dv = MIMO_TIME_SEQ, MIMO_HEADS, MIMO_D, MIMO_DV
    peak = card_peak(spec)
    out = {}
    for name, hkv, w, sinks in (("full", MIMO_FULL_KV, None, False),
                                ("window", MIMO_SWA_KV, MIMO_WINDOW, True)):
        q, k, v = flash_inputs(torch, dev, gen, H, S, S, d, H // hkv, dv)
        s = flash_sinks(torch, dev, gen, H) if sinks else None
        before = fa.flash_attention_blocks.persistent_calls
        ms = min(cuda_ms(torch, lambda: fa.flash_attention_blocks(
            q, k, v, 0, 0, True, window=w, sinks=s)) for _ in range(2))
        bound, by = roofline_split.split_fwd_bound(peak, H, hkv, S, d, dv,
                                                   w, sinks)
        out[name] = {"kv_heads": hkv, "window": w, "sinks": sinks,
                     "persistent":
                         fa.flash_attention_blocks.persistent_calls > before,
                     "ms": ms,
                     "bound_ms": bound * 1e3, "bound_by": by,
                     "fraction_of_bound": bound * 1e3 / ms}
        del q, k, v
    log(f"  flash at MiMo-V2-Flash's widths [1, {S}, {H}, {d}|{dv}]: {out}")
    return {"shape": [1, S, H, d, dv], **out}


def time_flash_mla_bwd(torch, fa, dev, gen, spec) -> dict:
    """Kernel B3 at DeepSeek-V3's MLA widths, [1, 16384, 128, 192] with
    values 128 wide at group 1 and YaRN's scale, with B2's residuals,
    against its bound (``perfbench/roofline_split_bwd.py``) and its plain
    version, with B2's forward beside it. SDPA's backward on the same
    call is timed as the library's yardstick where a fused kernel of it
    takes values narrower than keys (None where it raises)."""
    from perfbench import roofline_split, roofline_split_bwd

    H, S, d, dv = MLA_HEADS, MLA_SEQ, MLA_D, MLA_DV
    peak = card_peak(spec)
    q, k, v = flash_inputs(torch, dev, gen, H, S, S, d, 1, dv)
    dout = torch.randn((H, S, dv), generator=gen, device=dev).to(
        torch.bfloat16)
    out, m, l = fa.flash_attention_blocks(q, k, v, 0, 0, True,
                                          scale=MLA_SCALE)

    def kernel():
        fa.flash_bwd(q, k, v, out, m, l, dout, True, scale=MLA_SCALE)

    def plain():
        fa.flash_bwd_reference(q, k, v, out, m, l, dout, True, chunk=128,
                               scale=MLA_SCALE)

    fwd_ms = min(cuda_ms(torch, lambda: fa.flash_attention_blocks(
        q, k, v, 0, 0, True, scale=MLA_SCALE)) for _ in range(2))
    plain_runs = [cuda_ms(torch, plain, iters=1, warmup=1)]
    kernel_runs = [cuda_ms(torch, kernel), cuda_ms(torch, kernel)]
    plain_runs.append(cuda_ms(torch, plain, iters=1, warmup=0))
    try:
        q4, k4, v4 = (t[None].detach().requires_grad_() for t in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True, scale=MLA_SCALE)
        library_ms = cuda_ms(torch, lambda: torch.autograd.grad(
            sdpa, (q4, k4, v4), dout[None], retain_graph=True), iters=5)
        del q4, k4, v4, sdpa
    except RuntimeError as e:
        library_ms = f"not run: {str(e)[:160]}"
    bound, by = roofline_split_bwd.split_bwd_bound(peak, H, H, S, d, dv)
    fb, fby = roofline_split.split_fwd_bound(peak, H, H, S, d, dv)
    ms = min(kernel_runs)
    res = {"shape": [1, S, H, d, dv], "scale": MLA_SCALE, "ms": ms,
           "ms_runs": kernel_runs, "plain_ms": min(plain_runs),
           "plain_ms_runs": plain_runs, "library_ms": library_ms,
           "bound_ms": bound * 1e3, "bound_by": by,
           "fraction_of_bound": bound * 1e3 / ms,
           "tflops": roofline_split_bwd.split_bwd_flops(H, S, d, dv)
           / (ms * 1e-3) / 1e12,
           "fwd_ms": fwd_ms, "fwd_bound_ms": fb * 1e3, "fwd_bound_by": fby,
           "fwd_fraction_of_bound": fb * 1e3 / fwd_ms}
    log(f"  B3 at DeepSeek-V3's MLA widths [1, {S}, {H}, {d}|{dv}]: {res}")
    del q, k, v, dout, out, m, l
    return res


def time_ring_parts(torch, fa, ra, dev, gen) -> dict:
    """The one-card flash ring's call at the long shape, part by part
    with CUDA events: the fold of q, k, v to contiguous [B*H, S, D] (the
    layout copies B2 no longer needs, kept here as a yardstick: at B = 1
    ``flash_attention_blocks`` reads the folded views as they are), kernel
    B2 on the contiguous folds, the unfold of its output (out * l back to
    [B, S, H, D]),
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
    """(status, body) of a GET, an error status included."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


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
    # every step averaged ones to ones, and every bare sum kept its zeros
    correct = bool((x - 1).abs().max() <= 1e-6) and not bool(zeros.any())
    gb = k * 4 / 1e9
    bus = 2.0 * (n - 1) / n * gb
    return {"bytes_per_rank": k * 4, "correct": correct, "ms_runs": runs,
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
            ranks = mesh.spawn(allreduce_step_rank, n_cards, "cuda",
                               args=(NVLINK_PROOF_SIZE_MB,), timeout_s=600)
        r0 = ranks[0]
        if not all(r["correct"] for r in ranks):
            raise RuntimeError("the all-reduce step gave a wrong sum")
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


# phase E: the node's allocation plane. The fence of a four-card host
# (two cards left to the shared pool), the vGPU profile, and the share
# of each budget child's allocation: 0.9 of the budget must fit, 1.1 must
# raise the allocator's OOM
FENCE_FOUR_CARDS = ("gpu1", "gpu3")
VGPU_PROFILES_YAML = "profiles:\n  vgpu-2:\n    vgpusPerCard: 2\n"
BUDGET_SHARES = (0.9, 1.1)
# the health engine's HBM rule fires at 0.95 of NVML's total; the fill
# aims a little past it
HBM_FILL_TARGET = 0.96
# a child given one card by UUID: it must see that card alone and run a
# bf16 product on it; its timestamps go from start to CUDA ready
ALLOCATED_CHILD = """
import json, time
t = {"main": time.time()}
import torch
t["torch_imported"] = time.time()
n = torch.cuda.device_count()
p = torch.cuda.get_device_properties(0)
a = torch.randn(4096, 4096, device="cuda", dtype=torch.bfloat16)
c = a @ a
torch.cuda.synchronize()
t["cuda_ready"] = time.time()
print(json.dumps({"count": n, "uuid": "GPU-" + str(p.uuid),
                  "finite": bool(torch.isfinite(c).all()), "t": t}))
"""
# a child under a vGPU's env: it allocates SHARE of its budget, the
# fraction in PYTORCH_CUDA_ALLOC_CONF of torch's total, in one tensor
BUDGET_CHILD = """
import json, os, sys, time
t = {"main": time.time()}
import torch
share = float(sys.argv[1])
conf = os.environ["PYTORCH_CUDA_ALLOC_CONF"]
fraction = float(conf.split("per_process_memory_fraction:")[1].split(",")[0])
free, total = torch.cuda.mem_get_info()
t["cuda_ready"] = time.time()
budget = int(fraction * total)
out = {"share": share, "fraction": fraction, "torch_total": total,
       "budget_bytes": budget, "count": torch.cuda.device_count(),
       "uuid": "GPU-" + str(torch.cuda.get_device_properties(0).uuid)}
try:
    x = torch.empty(int(share * budget), dtype=torch.uint8, device="cuda")
    x.fill_(1)
    torch.cuda.synchronize()
    out["allocated"] = True
except torch.OutOfMemoryError as e:
    out["allocated"] = False
    out["oom"] = str(e).splitlines()[0][:400]
t["done"] = time.time()
out["t"] = t
print(json.dumps(out))
"""


def merge_patch(target: dict, patch: dict) -> dict:
    """RFC 7386: a None value removes its key, a dict merges."""
    for k, v in patch.items():
        if v is None:
            target.pop(k, None)
        elif isinstance(v, dict):
            base = target.get(k)
            target[k] = merge_patch(base if isinstance(base, dict) else {}, v)
        else:
            target[k] = v
    return target


class StubApiserver:
    """Nodes over HTTP on 127.0.0.1: GET of one (whole, or its metadata
    under the PartialObjectMetadata Accept), GET of the collection, and
    merge-PATCH; records each request's method, Accept and Content-Type.
    ``node`` is the first node, the one the agents run on. Pods: POST,
    GET and DELETE of one, each created pod played by ``play_pod``."""

    def __init__(self, node_name: str, labels: dict,
                 allocatable: dict | None = None, play_pod=None):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.nodes = {}
        self.node_name = node_name
        self.add_node(node_name, labels, allocatable)
        self.requests = []
        # pods by (namespace, name); ``play_pod(pod) -> phase`` plays a
        # created pod in a thread (phase G), else it stays Pending
        self.pods = {}
        self.play_pod = play_pod
        prefix = "/api/v1/nodes"
        pods = re.compile(r"^/api/v1/namespaces/([^/]+)/pods(?:/([^/?]+))?$")
        stub = self

        class Handler(BaseHTTPRequestHandler):
            def _answer(self, code, doc):
                body = json.dumps(doc).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _node(self):
                name = self.path[len(prefix) + 1:]
                if not self.path.startswith(prefix + "/"):
                    return None
                return stub.nodes.get(name)

            def do_GET(self):
                accept = self.headers.get("Accept", "")
                stub.requests.append(("GET", accept, ""))
                m = pods.match(self.path)
                if m and m.group(2):
                    pod = stub.pods.get((m.group(1), m.group(2)))
                    if pod is None:
                        return self._answer(404, {"reason": "NotFound"})
                    return self._answer(200, pod)
                if self.path == prefix:
                    return self._answer(200, {
                        "apiVersion": "v1", "kind": "NodeList",
                        "items": list(stub.nodes.values())})
                node = self._node()
                if node is None:
                    return self._answer(404, {"reason": "NotFound"})
                if "as=PartialObjectMetadata" in accept:
                    return self._answer(200, {
                        "apiVersion": "meta.k8s.io/v1",
                        "kind": "PartialObjectMetadata",
                        "metadata": node["metadata"]})
                self._answer(200, node)

            def do_PATCH(self):
                ctype = self.headers.get("Content-Type", "")
                body = json.loads(self.rfile.read(
                    int(self.headers["Content-Length"])))
                stub.requests.append(("PATCH", "", ctype))
                node = self._node()
                if node is None:
                    return self._answer(404, {"reason": "NotFound"})
                if ctype != "application/merge-patch+json":
                    return self._answer(415, {"reason": ctype})
                merge_patch(node, body)
                self._answer(200, node)

            def do_POST(self):
                body = json.loads(self.rfile.read(
                    int(self.headers["Content-Length"])))
                stub.requests.append(("POST", "", self.path))
                m = pods.match(self.path)
                if not m or m.group(2):
                    return self._answer(404, {"reason": "NotFound"})
                key = (m.group(1), body["metadata"]["name"])
                if key in stub.pods:
                    return self._answer(409, {"reason": "AlreadyExists"})
                body["metadata"]["namespace"] = m.group(1)
                body["status"] = {"phase": "Pending"}
                stub.pods[key] = body
                if stub.play_pod is not None:
                    threading.Thread(target=stub._play, args=(key, body),
                                     daemon=True).start()
                self._answer(201, body)

            def do_DELETE(self):
                stub.requests.append(("DELETE", "", self.path))
                m = pods.match(self.path)
                if not m or not m.group(2) or \
                        stub.pods.pop((m.group(1), m.group(2)), None) is None:
                    return self._answer(404, {"reason": "NotFound"})
                self._answer(200, {"status": "Success"})

            def log_message(self, *args):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"

    def add_node(self, name: str, labels: dict,
                 allocatable: dict | None = None) -> None:
        self.nodes[name] = {
            "apiVersion": "v1", "kind": "Node",
            "metadata": {"name": name, "labels": dict(labels)},
            "status": {"capacity": dict(allocatable or {}),
                       "allocatable": dict(allocatable or {})}}

    def _play(self, key, pod: dict) -> None:
        pod["status"] = {"phase": "Running"}
        phase = self.play_pod(pod)
        if key in self.pods:
            pod["status"] = {"phase": phase}

    @property
    def node(self) -> dict:
        return self.nodes[self.node_name]

    def labels(self, name: str | None = None) -> dict:
        node = self.nodes[name or self.node_name]
        return dict(node["metadata"].get("labels") or {})

    def stop(self):
        self.server.shutdown()
        self.server.server_close()


class StubKubelet:
    """kubelet's v1beta1.Registration on ``<socket_dir>/kubelet.sock``."""

    def __init__(self, socket_dir: str):
        import grpc
        from concurrent import futures

        from tpu_operator_torch.deviceplugin import api_pb2 as pb

        self.registrations = []

        def register(request, context):
            self.registrations.append(request.resource_name)
            return pb.Empty()

        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
        self._server.add_generic_rpc_handlers((
            grpc.method_handlers_generic_handler("v1beta1.Registration", {
                "Register": grpc.unary_unary_rpc_method_handler(
                    register,
                    request_deserializer=pb.RegisterRequest.FromString,
                    response_serializer=pb.Empty.SerializeToString)}),))
        self._server.add_insecure_port(
            f"unix://{os.path.join(socket_dir, 'kubelet.sock')}")
        self._server.start()

    def wait_for(self, resource: str, limit_s: float = 20.0) -> None:
        deadline = time.monotonic() + limit_s
        while resource not in self.registrations:
            if time.monotonic() > deadline:
                raise RuntimeError(f"the kubelet saw {self.registrations}, "
                                   f"never {resource}")
            time.sleep(0.05)

    def stop(self):
        self._server.stop(grace=0.2)


class PluginClient:
    """A kubelet's side of one plugin's socket: a ListAndWatch stream
    kept open, and Allocate."""

    def __init__(self, socket_path: str):
        import grpc

        from tpu_operator_torch.deviceplugin import api_pb2 as pb

        self.pb = pb
        self.channel = grpc.insecure_channel(f"unix://{socket_path}")
        law = self.channel.unary_stream(
            "/v1beta1.DevicePlugin/ListAndWatch",
            request_serializer=pb.Empty.SerializeToString,
            response_deserializer=pb.ListAndWatchResponse.FromString)
        self.stream = law(pb.Empty(), timeout=600)
        self._allocate = self.channel.unary_unary(
            "/v1beta1.DevicePlugin/Allocate",
            request_serializer=pb.AllocateRequest.SerializeToString,
            response_deserializer=pb.AllocateResponse.FromString)

    def next_list(self) -> dict:
        """The stream's next device list, {ID: health}."""
        return {d.ID: d.health for d in next(self.stream).devices}

    def allocate(self, ids) -> tuple:
        """(envs, host paths, ms) of one container's allocation."""
        req = self.pb.AllocateRequest()
        req.container_requests.add(devicesIDs=list(ids))
        t0 = time.perf_counter()
        resp = self._allocate(req, timeout=60)
        ms = (time.perf_counter() - t0) * 1e3
        [c] = resp.container_responses
        return dict(c.envs), [d.host_path for d in c.devices], ms

    def close(self):
        self.stream.cancel()
        self.channel.close()


def smi_query(*fields: str) -> list:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={','.join(fields)}",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return [[f.strip() for f in line.split(",")]
            for line in out.stdout.strip().splitlines()]


def smi_cuda_version() -> int:
    """nvidia-smi's CUDA version as cuDriverGetVersion counts it
    (13.0 -> 13000)."""
    out = subprocess.run(["nvidia-smi", "-q", "-x"], capture_output=True,
                         text=True, timeout=60, check=True)
    m = re.search(r"<cuda_version>(\d+)\.(\d+)</cuda_version>", out.stdout)
    if not m:
        raise RuntimeError("nvidia-smi -q -x gave no cuda_version")
    return int(m.group(1)) * 1000 + int(m.group(2)) * 10


def child_run(code: str, env: dict, *args: str) -> tuple:
    """(result, seconds from start to CUDA ready) of a child process."""
    t0 = time.time()
    out = subprocess.run([sys.executable, "-c", code, *args], env=env,
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError(f"child failed (rc={out.returncode}): "
                           f"{out.stderr[-2000:]}")
    res = json.loads(out.stdout.strip().splitlines()[-1])
    return res, res["t"]["cuda_ready"] - t0


def allocation_plane_phase(torch, card: str) -> dict:
    """Phase E: the node's allocation plane on the card(s), against a stub
    apiserver (one Node) and a stub kubelet (Registration) this script
    opens on 127.0.0.1 and a unix socket. Each step is gated: the driver
    and runtime agents; the shared plugin's inventory (gpu0..gpuN-1, the
    UUIDs torch sees), its first ListAndWatch and an Allocate whose card
    a child process sees alone by UUID; the health engine over NVML, its
    HBM warning raised by filling the card and cleared by freeing it, a
    FAILing card advertised Unhealthy; the fence (the shared pool drops
    the fenced cards, the isolated plugin serves them whole); a vGPU
    profile (the isolated plugin re-registers as nvidia.com/vgpu, and
    the allocator enforces the budget of an Allocate in two children);
    the fence withdrawn; feature discovery's labels. Times in ms."""
    import importlib.util

    from tpu_operator_torch.api import labels as L
    from tpu_operator_torch.cli import node_agents
    from tpu_operator_torch.deviceplugin import plugin as dp
    from tpu_operator_torch.featurediscovery import FeatureDiscovery
    from tpu_operator_torch.isolation import fencing, vgpu
    from tpu_operator_torch.metrics import health_engine as he
    from tpu_operator_torch.runtime.kubeclient import InClusterClient
    from tpu_operator_torch.validator import barrier, components
    from tpu_operator_torch.validator import metrics as node_metrics

    absent = [m for m in ("grpc", "google.protobuf", "yaml")
              if importlib.util.find_spec(m) is None]
    log(f"  {json.dumps({'absent': absent})}")
    if absent:
        raise RuntimeError(f"phase E needs {absent} on this machine")
    n = torch.cuda.device_count()
    ms = {}
    children = {}
    d = tempfile.mkdtemp(prefix="gpu-allocation-plane-")
    fence_file = os.path.join(d, "fencing.json")
    vgpu_file = os.path.join(d, "vgpu-config.json")
    sockets = os.path.join(d, "device-plugins")
    os.makedirs(sockets)
    profiles = os.path.join(d, "vgpu-profiles.yaml")
    with open(profiles, "w") as f:
        f.write(VGPU_PROFILES_YAML)
    node_name = "smoke-node"
    api = StubApiserver(node_name, {L.WORKLOAD_CONFIG: "virtual"})
    client = InClusterClient(api.url)
    kubelet = StubKubelet(sockets)
    shared = isolated = shared_rpc = isolated_rpc = engine_srv = None
    stub_srv = None
    stop = threading.Event()
    held = None
    try:
        with environ(GPU_VALIDATION_DIR=os.path.join(d, "validations"),
                     GPU_FENCING_FILE=fence_file, GPU_VGPU_FILE=vgpu_file,
                     GPU_SLICE_FILE=os.path.join(d, "no-slices.json"),
                     GPU_FAKE_CHIPS=None, GPU_HEALTH_ENGINE_INFO=None,
                     GPU_TELEMETRY_WATCH=None, GPU_TELEMETRY_BIN=None,
                     GPU_WORKLOAD_CONFIG=None, SHARING_REPLICAS=None,
                     GPU_PLUGIN_CONFIG_DIR=None, GPU_DRIVER_VERSION=None,
                     DEVICE_PATH_GLOB=None, GPU_CARD_MEMORY_MB=None):
            # E1. the driver and runtime agents
            t0 = time.perf_counter()
            rc = node_agents.main(["gpu-driver-install", "verify"])
            ms["driver_install_verify"] = (time.perf_counter() - t0) * 1e3
            drv = barrier.read_status(".driver-ctr-ready") or {}
            smi_driver = smi_query("driver_version")[0][0]
            smi_cuda = smi_cuda_version()
            log(f"  gpu-driver-install verify: rc={rc} {drv}; nvidia-smi "
                f"driver {smi_driver}, CUDA {smi_cuda}")
            if rc != 0 or drv.get("DRIVER_VERSION") != smi_driver or \
                    drv.get("CUDA_DRIVER_VERSION") != str(smi_cuda):
                raise RuntimeError(f"the driver agent's {drv} disagrees "
                                   f"with nvidia-smi")
            t0 = time.perf_counter()
            rc = node_agents.main(["gpu-runtime-setup", "verify"])
            ms["runtime_setup_verify"] = (time.perf_counter() - t0) * 1e3
            env_file = barrier.validation_dir().parent / "gpu-env"
            runtime_env = dict(ln.split("=", 1) for ln in
                               env_file.read_text().splitlines())
            nodes = runtime_env.get("GPU_DEVICES", "").split(",")
            node_errors = [e for e in map(components.device_node_error,
                                          nodes) if e]
            log(f"  gpu-runtime-setup verify: rc={rc} {runtime_env}; "
                f"errors opening the card nodes: {node_errors}")
            if rc != 0 or len(nodes) != n or node_errors:
                raise RuntimeError("the runtime agent's card nodes do not "
                                   "open")
            for name in barrier.KNOWN_STATUS_FILES:
                if not barrier.is_ready(name):
                    barrier.write_status(name, {"SMOKE": "1"})
            rc = node_agents.main(["gpu-driver-manager", "preflight"])
            left = [f for f in barrier.KNOWN_STATUS_FILES
                    if barrier.is_ready(f)]
            log(f"  gpu-driver-manager preflight: rc={rc}; of "
                f"{len(barrier.KNOWN_STATUS_FILES)} known files, left "
                f"{left}")
            if rc != 0 or left:
                raise RuntimeError(f"preflight left {left}")

            # E2. the shared plugin
            inventory = dp.card_inventory()
            ids = [f"gpu{i}" for i in range(n)]
            torch_uuids = {"GPU-" + str(torch.cuda.get_device_properties(i)
                                        .uuid) for i in range(n)}
            log(f"  NVML inventory: {inventory}")
            if [c.id for c in inventory.cards] != ids or \
                    {c.uuid for c in inventory.cards} != torch_uuids:
                raise RuntimeError(f"the inventory {inventory.cards} is not "
                                   f"torch's {sorted(torch_uuids)}")
            t0 = time.perf_counter()
            shared = dp.GpuDevicePlugin(socket_dir=sockets,
                                        health_interval_s=3600)
            shared.start()
            shared_rpc = PluginClient(shared.socket_path)
            listed = shared_rpc.next_list()
            ms["shared_start_to_first_list"] = (time.perf_counter() - t0) * 1e3
            shared.register_with_kubelet()
            kubelet.wait_for(L.GPU_RESOURCE)
            log(f"  shared plugin: first ListAndWatch {listed} in "
                f"{ms['shared_start_to_first_list']!r} ms; kubelet "
                f"registrations {kubelet.registrations}")
            if listed != dict.fromkeys(ids, dp.HEALTHY):
                raise RuntimeError(f"the shared plugin listed {listed}")
            fence_ids = list(FENCE_FOUR_CARDS) if n >= 4 else ids
            target = [c for c in ids if c not in fence_ids or n < 4][-1]
            card_t = inventory.card(target)
            envs, paths, ms["shared_allocate"] = shared_rpc.allocate([target])
            log(f"  Allocate([{target}]) in {ms['shared_allocate']!r} ms: "
                f"{paths} {envs}")
            if envs.get("NVIDIA_VISIBLE_DEVICES") != card_t.uuid or \
                    paths[0] != f"/dev/nvidia{card_t.minor}":
                raise RuntimeError(f"Allocate named {envs} {paths}, not "
                                   f"{card_t}")
            child_env = dict(os.environ, PYTHONPATH=os.getcwd(), **envs)
            child_env["CUDA_VISIBLE_DEVICES"] = envs["NVIDIA_VISIBLE_DEVICES"]
            res, children["allocated_s"] = child_run(ALLOCATED_CHILD,
                                                     child_env)
            log(f"  child with CUDA_VISIBLE_DEVICES={card_t.uuid}: {res}; "
                f"start to CUDA ready {children['allocated_s']!r} s")
            if res["count"] != 1 or res["uuid"] != card_t.uuid or \
                    not res["finite"]:
                raise RuntimeError(f"the allocated child saw {res}")

            # E3. the health engine over NVML
            eng = he.HealthEngine()
            engine_srv = he.serve(0, interval=3600, stop_event=stop,
                                  engine=eng)
            info = f"127.0.0.1:{engine_srv.server_address[1]}"
            os.environ["GPU_HEALTH_ENGINE_INFO"] = info

            def verdicts():
                t0 = time.perf_counter()
                eng.collect_once()
                ms.setdefault("health_collect_once", []).append(
                    (time.perf_counter() - t0) * 1e3)
                code, body = http_get(f"http://{info}/v1/health")
                return code, json.loads(body)

            code, health = verdicts()
            log(f"  /v1/health {code}: {health}")
            if code != 200 or [c["status"] for c in health["chips"]] != \
                    ["ok"] * n:
                raise RuntimeError(f"the idle cards are not all ok: {health}")
            own = next(c for c in inventory.cards if c.uuid == "GPU-" + str(
                torch.cuda.get_device_properties(0).uuid))
            torch.cuda.empty_cache()
            held = []
            for _ in range(4):
                s = next(x for x in eng.samples()
                         if x["chip_id"] == own.id)
                used, total = s["hbm_used"], s["hbm_total"]
                if used / total >= he.HBM_WARN_FRACTION:
                    break
                need = int(HBM_FILL_TARGET * total) - used
                held.append(torch.empty(need, dtype=torch.uint8,
                                        device="cuda:0"))
                torch.cuda.synchronize()
                code, health = verdicts()
            full = next(c for c in health["chips"] if c["chip_id"] == own.id)
            log(f"  filled {own.id} ({sum(t.numel() for t in held)} bytes "
                f"held): NVML used {used}/{total} = {used / total!r}; "
                f"/v1/health {code}: {full}")
            shared.refresh_devices()
            after_fill = {d.ID: d.health for d in shared.devices()}
            if full["status"] != "warn" or not any(
                    "HBM" in r for r in full["reasons"]) or code != 200:
                raise RuntimeError(f"no HBM warning at {used / total}: {full}")
            if after_fill[own.id] != dp.HEALTHY:
                raise RuntimeError(f"a warn verdict unhealthed {own.id}")
            held = None
            torch.cuda.empty_cache()
            code, health = verdicts()
            freed = next(c for c in health["chips"] if c["chip_id"] == own.id)
            log(f"  freed: /v1/health {code}: {freed}; plugin kept "
                f"{after_fill}")
            if freed["status"] != "ok":
                raise RuntimeError(f"the warning outlived the memory: {freed}")
            stub_srv = stub_health_engine({"gpu0": "fail"})
            os.environ["GPU_HEALTH_ENGINE_INFO"] = \
                f"127.0.0.1:{stub_srv.server_address[1]}"
            shared.refresh_devices()
            failed = shared_rpc.next_list()
            os.environ["GPU_HEALTH_ENGINE_INFO"] = info
            shared.refresh_devices()
            recovered = shared_rpc.next_list()
            log(f"  a stub engine answering 503 with gpu0 fail: "
                f"ListAndWatch {failed}; back on the engine: {recovered}")
            if failed.get("gpu0") != dp.UNHEALTHY or \
                    recovered != dict.fromkeys(ids, dp.HEALTHY):
                raise RuntimeError("a FAILing card was not advertised "
                                   "Unhealthy and back")

            # E4. the fence
            fence_cfg = ",".join(FENCE_FOUR_CARDS) if n >= 4 else "all"
            client.patch("v1", "Node", node_name, {"metadata": {
                "labels": {L.FENCING_CONFIG: fence_cfg,
                           L.VGPU_CONFIG: "vgpu-2"}}})
            agent = fencing.FencingAgent(client, node_name,
                                         fencing_file=fence_file)
            t0 = time.perf_counter()
            state = agent.apply_once()
            ms["fencing_apply_once"] = (time.perf_counter() - t0) * 1e3
            fenced = fencing.fenced_chips()
            shared.refresh_devices()
            pool = shared_rpc.next_list()
            log(f"  FencingAgent.apply_once: {state} in "
                f"{ms['fencing_apply_once']!r} ms, fenced {fenced}, node "
                f"label {api.labels().get(L.FENCING_STATE)}; shared pool "
                f"{pool}")
            if state != "success" or fenced != fence_ids or \
                    api.labels().get(L.FENCING_STATE) != "success" or \
                    pool != {c: dp.HEALTHY for c in ids
                             if c not in fenced}:
                raise RuntimeError("the fence did not move the cards out of "
                                   "the shared pool")
            if n >= 4:
                envs, paths, _ = shared_rpc.allocate([target])
                if envs["NVIDIA_VISIBLE_DEVICES"] != card_t.uuid:
                    raise RuntimeError(f"the fenced pool reallocated {envs}")
            isolated = dp.IsolatedGpuDevicePlugin(socket_dir=sockets,
                                                  health_interval_s=0.5)
            threading.Thread(target=isolated.serve_forever,
                             kwargs={"poll_s": 0.2}, daemon=True).start()
            kubelet.wait_for(L.GPU_ISOLATED_RESOURCE)
            isolated_rpc = PluginClient(isolated.socket_path)
            whole = isolated_rpc.next_list()
            fence_info = components.validate_fencing()
            log(f"  isolated plugin as {L.GPU_ISOLATED_RESOURCE}: {whole}; "
                f"fencing-ready {fence_info}")
            if whole != dict.fromkeys(fenced, dp.HEALTHY) or \
                    fence_info["FENCED"] != ",".join(fenced):
                raise RuntimeError("the isolated pool is not the fence")

            # E5. vGPUs under the allocator's budget
            mgr = vgpu.VGPUDeviceManager(client, node_name, profiles,
                                         vgpu_file=vgpu_file)
            t0 = time.perf_counter()
            state = mgr.apply_once()
            ms["vgpu_apply_once"] = (time.perf_counter() - t0) * 1e3
            kubelet.wait_for(L.VGPU_RESOURCE)
            units = isolated_rpc.next_list()
            log(f"  VGPUDeviceManager.apply_once: {state} in "
                f"{ms['vgpu_apply_once']!r} ms, node label "
                f"{api.labels().get(L.VGPU_CONFIG_STATE)}; isolated plugin "
                f"re-registered: {kubelet.registrations}; lists {units}")
            want_units = [f"{c}-vgpu{j}" for c in fenced for j in range(2)]
            if state != "success" or sorted(units) != sorted(want_units):
                raise RuntimeError(f"the vGPU inventory is {units}")
            unit = want_units[0]
            card_v = inventory.card(fenced[0])
            envs, paths, ms["vgpu_allocate"] = isolated_rpc.allocate([unit])
            log(f"  Allocate([{unit}]) in {ms['vgpu_allocate']!r} ms: "
                f"{paths} {envs}")
            if envs.get("PYTORCH_CUDA_ALLOC_CONF") != \
                    "per_process_memory_fraction:0.5000" or \
                    envs.get("NVIDIA_VISIBLE_DEVICES") != card_v.uuid:
                raise RuntimeError(f"the vGPU's contract is {envs}")
            child_env = dict(os.environ, PYTHONPATH=os.getcwd(), **envs)
            child_env["CUDA_VISIBLE_DEVICES"] = envs["NVIDIA_VISIBLE_DEVICES"]
            with concurrent.futures.ThreadPoolExecutor(2) as pool_:
                budget = list(pool_.map(
                    lambda s: child_run(BUDGET_CHILD, child_env, str(s)),
                    BUDGET_SHARES))
            for (res, ready_s), share in zip(budget, BUDGET_SHARES):
                children[f"budget_{share}_s"] = ready_s
                log(f"  budget child ({share} of the budget): {res}; start "
                    f"to CUDA ready {ready_s!r} s")
            (fits, _), (over, _) = budget
            log(f"  budget: fraction 0.5 of torch's total {fits['torch_total']}"
                f" = {fits['budget_bytes']} bytes "
                f"({fits['budget_bytes'] / 2**20!r} MiB); the inventory's "
                f"GPU_MEM_LIMIT_MB {envs.get('GPU_MEM_LIMIT_MB')}; NVML's "
                f"total / 2 = {card_v.memory_total_bytes / 2 / 2**20!r} MiB")
            if not fits["allocated"] or over["allocated"] or \
                    "allowed" not in over.get("oom", "") or \
                    fits["uuid"] != card_v.uuid or fits["count"] != 1:
                raise RuntimeError("the allocator did not enforce the vGPU's "
                                   "budget")
            with environ(GPU_WORKLOAD_CONFIG="virtual"):
                vgpu_info = components.validate_vgpu()
            m = node_metrics.NodeMetrics("smoke")
            m.collect_once()
            got = prom_series(m.render().decode())
            gauges = {c: got.get(("gpu_operator_node_component_ready",
                                  (("component", c), ("node", "smoke"))))
                      for c in node_metrics.ISOLATION_COMPONENT_FILES}
            log(f"  vgpu-ready {vgpu_info}; isolated-plane gauges {gauges}")
            if gauges != {"fencing": 1.0, "vgpu": 1.0}:
                raise RuntimeError(f"the exporter's isolated gauges {gauges}")
            agent.cleanup()
            shared.refresh_devices()
            back = shared_rpc.next_list()
            gone = [p for p in (fence_file, vgpu_file) if os.path.exists(p)]
            log(f"  FencingAgent.cleanup: files left {gone}; shared pool "
                f"{back}")
            if gone or back != dict.fromkeys(ids, dp.HEALTHY):
                raise RuntimeError("the withdrawn fence did not return the "
                                   "cards")

            # E6. feature discovery
            fd = FeatureDiscovery(client, node_name)
            t0 = time.perf_counter()
            delta = fd.apply_once()
            ms["feature_discovery_apply_once"] = \
                (time.perf_counter() - t0) * 1e3
            again = fd.apply_once()
            labels = api.labels()
            log(f"  FeatureDiscovery.apply_once in "
                f"{ms['feature_discovery_apply_once']!r} ms: {delta}; "
                f"again: {again}")
            want = {L.GPU_PRODUCT: own.name.replace(" ", "-"),
                    L.GPU_MEMORY_GB: "80", L.DRIVER_VERSION: smi_driver}
            if "H100 80GB HBM3" in own.name:  # SXM
                want[L.GPU_NVLINK_GBPS] = "450"
            if {k: labels.get(k) for k in want} != want or again:
                raise RuntimeError(f"feature labels {delta}, want {want}")
            meta = client.get("v1", "Node", node_name, metadata_only=True)
            if meta.get("kind") != "PartialObjectMetadata" or \
                    meta["metadata"]["labels"] != labels:
                raise RuntimeError(f"a metadata-only GET gave {meta}")
            metadata_gets = sum(1 for r in api.requests
                                if "PartialObjectMetadata" in r[1])
            log(f"  stub apiserver: {len(api.requests)} requests "
                f"({metadata_gets} metadata-only GETs)")
    finally:
        held = None
        for rpc in (shared_rpc, isolated_rpc):
            if rpc is not None:
                rpc.close()
        for plugin in (shared, isolated):
            if plugin is not None:
                plugin.stop()
        stop.set()
        for srv in (engine_srv, stub_srv):
            if srv is not None:
                srv.shutdown()
                srv.server_close()
        kubelet.stop()
        api.stop()
        shutil.rmtree(d, ignore_errors=True)
    out = {"card": card, "ms": ms, "children_s": children,
           "absent": absent, "driver": drv, "budget": budget[0][0]}
    return out


def stub_health_engine(statuses: dict):
    """A health engine answering /v1/health with 503 and ``statuses``."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    body = json.dumps({"status": "fail", "reasons": [], "chips": [
        {"chip_id": c, "status": s, "reasons": []}
        for c, s in statuses.items()]}).encode()

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            self.send_response(503)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


# phase F: the topology manager on the real cards. The profiles are the
# reference's ConfigMap (full, split-2, split-4), read from its manifest;
# each card group's child runs phase 13's all-reduce step over its two
# cards at the proof's size
TOPOLOGY_CONFIGMAP = os.path.join("manifests", "state-topology-manager",
                                  "0300_config_map.yaml")
GROUP_CHILD = """
import json, sys, time
t = {"main": time.time()}
import torch
t["torch_imported"] = time.time()
n = torch.cuda.device_count()
uuids = ["GPU-" + str(torch.cuda.get_device_properties(i).uuid)
         for i in range(n)]
torch.ones(1, device="cuda").sum().item()
t["cuda_ready"] = time.time()
import chip_smoke
from tpu_operator_torch.parallel import mesh
ranks = mesh.spawn(chip_smoke.allreduce_step_rank, n, "cuda",
                   args=(float(sys.argv[1]),), timeout_s=300)
t["done"] = time.time()
print(json.dumps({"count": n, "uuids": uuids, "ranks": ranks, "t": t}))
"""


def configmap_profiles(path: str) -> str:
    """The ``config.yaml`` block of a ConfigMap manifest (a template, so
    read as text: the block is plain YAML)."""
    import textwrap

    with open(path) as f:
        text = f.read()
    return textwrap.dedent(text.split("config.yaml: |\n", 1)[1])


def smi_active_links() -> list:
    """Active NVLinks a card, in nvidia-smi's index order (``nvidia-smi
    nvlink -s``: a link with a rate is up, ``<inactive>`` is not)."""
    out = subprocess.run(["nvidia-smi", "nvlink", "-s"], capture_output=True,
                         text=True, timeout=60, check=True)
    counts = []
    for line in out.stdout.splitlines():
        if line.startswith("GPU "):
            counts.append(0)
        elif counts and re.search(r"Link \d+: [\d.]+ GB/s", line):
            counts[-1] += 1
    return counts


def group_children(groups: list, envs: list, card: str) -> dict:
    """One child per card group, all at once, then the first alone; each
    sees its group's cards by UUID and runs the all-reduce step over them.
    Returns each run's results (start to CUDA ready in s, bus GB/s)."""

    def run(i):
        child_env = dict(os.environ, PYTHONPATH=os.getcwd(), **envs[i])
        child_env["CUDA_VISIBLE_DEVICES"] = envs[i]["NVIDIA_VISIBLE_DEVICES"]
        res, ready_s = child_run(GROUP_CHILD, child_env,
                                 str(NVLINK_PROOF_SIZE_MB))
        want = envs[i]["NVIDIA_VISIBLE_DEVICES"].split(",")
        r0 = res["ranks"][0]
        log(f"  slice{i} child ({groups[i]}): sees {res['count']} cards "
            f"{res['uuids']}; start to CUDA ready {ready_s!r} s; all-reduce "
            f"at {r0['bytes_per_rank']} bytes a rank correct "
            f"{[r['correct'] for r in res['ranks']]}: step {r0['step_ms']!r} "
            f"ms ({r0['step_bus_gbps']!r} GB/s bus), bare "
            f"{r0['bare_ms']!r} ms ({r0['bare_bus_gbps']!r} GB/s bus) "
            f"({card})")
        if res["count"] != len(want) or sorted(res["uuids"]) != sorted(want):
            raise RuntimeError(f"the slice{i} child saw {res['uuids']}, "
                               f"not its own {want}")
        if not all(r["correct"] for r in res["ranks"]):
            raise RuntimeError(f"slice{i}'s all-reduce gave a wrong sum")
        return {"ready_s": ready_s, "step_ms": r0["step_ms"],
                "step_bus_gbps": r0["step_bus_gbps"],
                "bare_ms": r0["bare_ms"], "bare_bus_gbps": r0["bare_bus_gbps"],
                "ranks_s": res["t"]["done"] - res["t"]["cuda_ready"]}

    with concurrent.futures.ThreadPoolExecutor(len(groups)) as pool:
        together = list(pool.map(run, range(len(groups))))
    alone = run(0)
    log(f"  slice0 all-reduce step alone {alone['step_ms']!r} ms, beside "
        f"slice1 {together[0]['step_ms']!r} ms ({card})")
    return {"together": together, "alone": alone}


def topology_phase(torch, card: str) -> dict:
    """Phase F: the topology manager on the card(s), against a stub
    apiserver (this node and a stub peer). Each step is gated: the
    inventory's NVLink facts (UUIDs torch's, active links nvidia-smi's);
    feature discovery's topology and multihost from NVML; the reference's
    profiles: ``full`` one group of every card, an unknown profile
    ``failed``, ``split-2`` ``failed`` on one card and two groups of NVLink
    peers on four, served as slice0 and slice1 by the shared plugin, each
    Allocate's child seeing its two cards alone and summing over them;
    grouped agreement on a multi-host pool, ``pending`` until the peer
    asks for the same profile. Times in ms."""
    from tpu_operator_torch.api import labels as L
    from tpu_operator_torch.deviceplugin import plugin as dp
    from tpu_operator_torch.featurediscovery import FeatureDiscovery
    from tpu_operator_torch.kernels import build
    from tpu_operator_torch.runtime.kubeclient import InClusterClient
    from tpu_operator_torch.state.nodepool import NodePool, topology_of
    from tpu_operator_torch.topology import manager as tm

    n = torch.cuda.device_count()
    ids = [f"gpu{i}" for i in range(n)]
    ms = {}
    out = {"card": card, "ms": ms}
    d = tempfile.mkdtemp(prefix="gpu-topology-")
    slice_file = os.path.join(d, "slice-config.json")
    sockets = os.path.join(d, "device-plugins")
    os.makedirs(sockets)
    profiles = os.path.join(d, "config.yaml")
    with open(profiles, "w") as f:
        f.write(configmap_profiles(TOPOLOGY_CONFIGMAP))
    node_name, peer = "smoke-node", "smoke-peer"
    api = StubApiserver(node_name, {L.GKE_NODEPOOL: "smoke-pool"})
    api.node["status"]["allocatable"][L.GPU_RESOURCE] = str(n)
    client = InClusterClient(api.url)
    shared = shared_rpc = None
    try:
        with environ(GPU_SLICE_FILE=slice_file,
                     GPU_FENCING_FILE=os.path.join(d, "no-fence.json"),
                     GPU_FAKE_CHIPS=None, GPU_TELEMETRY_BIN=None,
                     GPU_TOPOLOGY=None, GPU_HEALTH_ENGINE_INFO=None,
                     SHARING_REPLICAS=None, GPU_PLUGIN_CONFIG_DIR=None):
            # F1. NVML's facts: a scraper that does not build fails here,
            # not as a node with no card
            build.build_host("gpu_telemetry")
            t0 = time.perf_counter()
            inventory = dp.card_inventory()
            ms["inventory"] = (time.perf_counter() - t0) * 1e3
            torch_uuids = {"GPU-" + str(torch.cuda.get_device_properties(i)
                                        .uuid) for i in range(n)}
            if [c.id for c in inventory.cards] != ids or \
                    {c.uuid for c in inventory.cards} != torch_uuids:
                raise RuntimeError(f"NVML's inventory {inventory.cards} is "
                                   f"not torch's {n} cards")
            smi_links = smi_active_links()
            for c in inventory.cards:
                reach = sorted({str(r) for _, r in c.nvlink or ()})
                log(f"  {c.id} {c.uuid} /dev/nvidia{c.minor}: "
                    f"{'refused' if c.nvlink is None else len(c.nvlink)} "
                    f"active NVLinks reaching {reach}; NVLink peers "
                    f"{c.nvlink_peers}; fabric {c.fabric}; refused "
                    f"{dict(c.refused)}")
            links = [None if c.nvlink is None else len(c.nvlink)
                     for c in inventory.cards]
            topology = topology_of(inventory)
            log(f"  active links: NVML {links}, nvidia-smi {smi_links}; "
                f"topology {topology}; inventory in {ms['inventory']!r} ms "
                f"({card})")
            if links != smi_links or topology is None:
                raise RuntimeError("NVML's NVLink facts disagree with "
                                   "nvidia-smi or name no fabric")
            out.update(topology=topology, links=links, cards=[
                {"id": c.id, "nvlink_peers": c.nvlink_peers,
                 "fabric": None if c.fabric is None else vars(c.fabric),
                 "refused": dict(c.refused)} for c in inventory.cards])

            # F2. feature discovery stamps the fabric
            fd = FeatureDiscovery(client, node_name)
            t0 = time.perf_counter()
            delta = fd.apply_once()
            ms["feature_discovery_apply_once"] = \
                (time.perf_counter() - t0) * 1e3
            labels = api.labels()
            product = labels.get(L.GPU_PRODUCT, "")
            multihost = str(NodePool(product, topology).multi_host).lower()
            log(f"  FeatureDiscovery.apply_once in "
                f"{ms['feature_discovery_apply_once']!r} ms: {delta}")
            if labels.get(L.GPU_TOPOLOGY) != topology or \
                    labels.get(L.GPU_MULTIHOST) != multihost:
                raise RuntimeError(f"feature labels {labels}, want topology "
                                   f"{topology}, multihost {multihost}")

            # F3. the manager over the reference's profiles
            mgr = tm.TopologyManager(client, node_name, profiles,
                                     slice_file=slice_file)
            if sorted(mgr.profiles) != ["full", "split-2", "split-4"]:
                raise RuntimeError(f"profiles {sorted(mgr.profiles)}")

            def ask(profile, name=node_name):
                client.patch("v1", "Node", name, {"metadata": {"labels": {
                    L.SLICE_CONFIG: profile}}})

            def apply(want):
                t0 = time.perf_counter()
                state = mgr.apply_once()
                ms.setdefault("apply_once", []).append(
                    (time.perf_counter() - t0) * 1e3)
                doc = tm.read_slice_file(slice_file)
                log(f"  apply_once ({api.labels().get(L.SLICE_CONFIG)}): "
                    f"{state} in {ms['apply_once'][-1]!r} ms; node label "
                    f"{api.labels().get(L.SLICE_CONFIG_STATE)}; slice file "
                    f"{doc} ({card})")
                if state != want or \
                        api.labels().get(L.SLICE_CONFIG_STATE) != want:
                    raise RuntimeError(f"the manager gave {state}, not "
                                       f"{want}")
                return doc

            doc = apply("success")
            units = [dev.ID for dev in dp.discover_devices()]
            if doc["groups"] != [ids] or units != ids:
                raise RuntimeError(f"full gave {doc}; the plugin lists "
                                   f"{units}")
            ask("no-such-profile")
            apply("failed")

            # grouped agreement: this node and a stub peer of one multi-host
            # pool (GPU_TOPOLOGY names an NVLink domain across hosts)
            domain = f"mnnvl-{n}"
            with environ(GPU_TOPOLOGY=domain):
                fd.apply_once()
            api.add_node(peer, {L.GPU_PRODUCT: product,
                                L.GPU_TOPOLOGY: domain,
                                L.GKE_NODEPOOL: "smoke-pool",
                                L.SLICE_CONFIG: "split-4"})
            ask("full")
            log(f"  node {api.labels()}; peer {api.labels(peer)}")
            if api.labels().get(L.GPU_MULTIHOST) != "true":
                raise RuntimeError("GPU_TOPOLOGY did not make the pool "
                                   "multi-host")
            apply("pending")
            ask("full", peer)
            apply("success")
            fd.apply_once()
            if (api.labels().get(L.GPU_TOPOLOGY),
                    api.labels().get(L.GPU_MULTIHOST)) != (topology,
                                                          multihost):
                raise RuntimeError("feature discovery did not restore "
                                   "NVML's topology")

            ask("split-2")
            if n % 2:
                try:
                    tm.chip_groups(ids, 2)
                except ValueError as e:
                    log(f"  split-2 on {n} card(s): {e}")
                apply("failed")
            else:
                doc = apply("success")
                half = n // 2
                groups = [ids[:half], ids[half:]]
                if doc["groups"] != groups:
                    raise RuntimeError(f"split-2 gave {doc['groups']}")
                for g in groups:
                    for a in g:
                        peers = inventory.card(a).nvlink_peers
                        if peers is None or set(g) - {a} - set(peers):
                            raise RuntimeError(f"NVML does not report "
                                               f"{g} as NVLink peers")
            if n >= 4 and n % 2 == 0:
                # F4. the groups behind the shared plugin, and a child each
                t0 = time.perf_counter()
                shared = dp.GpuDevicePlugin(socket_dir=sockets,
                                            health_interval_s=3600)
                shared.start()
                shared_rpc = PluginClient(shared.socket_path)
                listed = shared_rpc.next_list()
                ms["shared_start_to_first_list"] = \
                    (time.perf_counter() - t0) * 1e3
                log(f"  shared plugin: first ListAndWatch {listed} in "
                    f"{ms['shared_start_to_first_list']!r} ms ({card})")
                if listed != {"slice0": dp.HEALTHY, "slice1": dp.HEALTHY}:
                    raise RuntimeError(f"the shared plugin listed {listed}")
                envs = []
                for i, g in enumerate(groups):
                    env, paths, t_ms = shared_rpc.allocate([f"slice{i}"])
                    ms.setdefault("slice_allocate", []).append(t_ms)
                    members = [inventory.card(c) for c in g]
                    log(f"  Allocate([slice{i}]) in {t_ms!r} ms: {paths} "
                        f"{env} ({card})")
                    if env.get("NVIDIA_VISIBLE_DEVICES") != ",".join(
                            c.uuid for c in members) or paths[:half] != [
                            f"/dev/nvidia{c.minor}" for c in members]:
                        raise RuntimeError(f"Allocate of slice{i} named "
                                           f"{env} {paths}, not {g}")
                    envs.append(env)
                out["children"] = group_children(groups, envs, card)
    finally:
        if shared_rpc is not None:
            shared_rpc.close()
        if shared is not None:
            shared.stop()
        api.stop()
        shutil.rmtree(d, ignore_errors=True)
    return out


# phase G: the operator's reconcile path. The port's GPUClusterPolicy is
# reconciled on its in-memory FakeClient over a node built from the real
# card, and the validator DaemonSet it renders is played on the card: each
# init container's command (resolved through pyproject.toml's
# [project.scripts]), args and env, in order, as its own process. Only the
# pod's volume mounts are stood in for.
RECONCILE_NODE = "smoke-node"
RECONCILE_NAMESPACE = "gpu-operator"
# a container's process: far under the validator's own pod wait (60 x 5 s)
RECONCILE_CHILD_TIMEOUT_S = 300
# the device plugin's wait, cut from its 300 s so the closed gate shows
WAIT_CUT_TIMEOUT_S = 2
# runs a [project.scripts] target as its console script would, and prints
# the kernel counts of its process as the last line
SCRIPT_LAUNCHER = """
import importlib, json, os, sys
target, argv0 = sys.argv[1], sys.argv[2]
sys.argv = [argv0] + sys.argv[3:]
url = os.environ.pop("SMOKE_APISERVER", "")
if url:
    # stand-in for the pod's service-account mount and the kubelet's
    # KUBERNETES_SERVICE_* env: the in-cluster client reaches the stub
    from tpu_operator_torch.runtime import kubeclient
    kubeclient.InClusterClient.from_env = classmethod(
        lambda cls, sa_dir=None: cls(url, namespace=os.environ.get(
            "OPERATOR_NAMESPACE", "default")))
module, attr = target.split(":")
rc = 1
try:
    rc = getattr(importlib.import_module(module), attr)()
finally:
    hbm = sys.modules.get("tpu_operator_torch.workloads.hbm_probe")
    print(json.dumps({"rc": rc, "triad_launches":
                      hbm.triad_.launches if hbm else 0}), flush=True)
sys.exit(rc)
"""
# the base env of a container: what an image and the container toolkit
# give a process, never the validator's own knobs from this script's env
CONTAINER_BASE_ENV = ("PATH", "HOME", "TMPDIR", "LANG", "LC_ALL",
                      "LD_LIBRARY_PATH", "CUDA_HOME")


def project_scripts() -> dict:
    import tomllib

    with open("pyproject.toml", "rb") as f:
        return tomllib.load(f)["project"]["scripts"]


def rendered_env(ctr: dict, node_name: str, namespace: str) -> dict:
    """A container's rendered env as the kubelet resolves it: a value, or
    a fieldRef to the pod's node or namespace."""
    out = {}
    for var in ctr.get("env") or []:
        if "value" in var:
            out[var["name"]] = str(var["value"])
            continue
        path = var["valueFrom"]["fieldRef"]["fieldPath"]
        out[var["name"]] = {"spec.nodeName": node_name,
                            "metadata.namespace": namespace}[path]
    return out


def container_process(ctr: dict, scripts: dict, env: dict,
                      extra_args=()) -> dict:
    """Run one container's command and args as a process from the
    checkout's root; rc, seconds and the launcher's last line."""
    cmd = ctr["command"]
    target = scripts.get(cmd[0])
    if target is None or not target.startswith("tpu_operator_torch."):
        raise RuntimeError(f"container {ctr['name']}: command {cmd[0]!r} "
                           f"names no port agent in [project.scripts]")
    argv = [sys.executable, "-c", SCRIPT_LAUNCHER, target, cmd[0],
            *cmd[1:], *(ctr.get("args") or []), *extra_args]
    t0 = time.perf_counter()
    out = subprocess.run(argv, env=env, capture_output=True, text=True,
                         timeout=RECONCILE_CHILD_TIMEOUT_S)
    secs = time.perf_counter() - t0
    last = {}
    for line in reversed(out.stdout.strip().splitlines()):
        if line.startswith("{"):
            last = json.loads(line)
            break
    return {"rc": out.returncode, "seconds": secs, "target": target,
            "triad_launches": last.get("triad_launches", 0),
            "stderr_tail": out.stderr[-1500:]}


def daemonset(client, name: str) -> dict:
    return client.get("apps/v1", "DaemonSet", name, RECONCILE_NAMESPACE)


def play_pod(env: dict, runs: list):
    """The stub apiserver's kubelet: a created pod's first container's
    command and env run as a process; its exit code gives the phase."""
    def play(pod: dict) -> str:
        ctr = pod["spec"]["containers"][0]
        penv = dict(env, **{e["name"]: e["value"]
                            for e in ctr.get("env") or []})
        t0 = time.perf_counter()
        out = subprocess.run(ctr["command"], env=penv, capture_output=True,
                             text=True, timeout=RECONCILE_CHILD_TIMEOUT_S)
        runs.append({"pod": pod["metadata"]["name"], "command":
                     ctr["command"], "rc": out.returncode,
                     "seconds": time.perf_counter() - t0,
                     "stdout_tail": out.stdout[-300:]})
        return "Succeeded" if out.returncode == 0 else "Failed"
    return play


def container_base_env(extra_env: dict | None) -> dict:
    """What a container's process starts from: the image's and the
    container toolkit's env (never the validator's own knobs from this
    script's env), and the checkout on PYTHONPATH."""
    base = {k: os.environ[k] for k in CONTAINER_BASE_ENV if k in os.environ}
    base.update({k: v for k, v in os.environ.items()
                 if k.startswith(("NVIDIA_", "CUDA_"))})
    base.update(extra_env or {})
    base["PYTHONPATH"] = os.getcwd()
    return base


def validator_stand_ins(pod: dict, valdir: str) -> dict:
    """The env that stands in for the validator pod's volume mounts; every
    container must mount the validations at the validator's default dir."""
    from tpu_operator_torch.validator import barrier

    mounts = {v["name"]: v for v in pod["volumes"]}
    log(f"  stand-ins for the pod's volume mounts: validations "
        f"(hostPath {mounts['validations']['hostPath']['path']}) -> "
        f"GPU_VALIDATION_DIR={valdir}; host-root (hostPath "
        f"{mounts['host-root']['hostPath']['path']} at /host) -> "
        f"HOST_ROOT=/; the service account -> the apiserver at "
        f"SMOKE_APISERVER")
    for ctr in pod["initContainers"] + pod["containers"]:
        for m in ctr.get("volumeMounts") or []:
            if m["name"] == "validations" and \
                    m["mountPath"] != barrier.DEFAULT_DIR:
                raise RuntimeError(f"{ctr['name']} mounts the validations "
                                   f"at {m['mountPath']}, not the "
                                   f"validator's default dir")
    return {"GPU_VALIDATION_DIR": valdir, "HOST_ROOT": "/"}


def operand_waits(client, base: dict, stand_ins: dict, scripts: dict,
                  label: str, cut: bool = False) -> dict:
    """Every operand's rendered wait init container, at once, as
    processes; with ``cut`` only the device plugin's, its timeout cut."""
    jobs = []
    for ds in client.list("apps/v1", "DaemonSet"):
        for ctr in ds["spec"]["template"]["spec"].get(
                "initContainers") or []:
            if (ctr.get("args") or [None])[0] != "wait":
                continue
            if cut and ds["metadata"]["name"] != \
                    "gpu-device-plugin-daemonset":
                continue
            env = {**base, **rendered_env(ctr, RECONCILE_NODE,
                                          RECONCILE_NAMESPACE),
                   **stand_ins}
            extra = ("--timeout", str(WAIT_CUT_TIMEOUT_S)) if cut else ()
            jobs.append((ds["metadata"]["name"], ctr, env, extra))
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
        outs = list(ex.map(lambda j: container_process(
            j[1], scripts, j[2], j[3]), jobs))
    res = {f"{j[0]}/{j[1]['name']} {' '.join(j[1]['args'])}":
           (o["rc"], round(o["seconds"], 3)) for j, o in zip(jobs, outs)}
    log(f"  {label}: {res}")
    return res


def play_init_containers(pod: dict, base: dict, stand_ins: dict,
                         api_url: str, scripts: dict, card: str,
                         node: str = RECONCILE_NODE) -> dict:
    """The validator pod's init containers on ``node`` in order, each its
    command's [project.scripts] target as a process; each must exit 0 and
    write its barrier file. plugin-validation reaches the stub
    apiserver."""
    from tpu_operator_torch.validator import barrier

    containers = {}
    for ctr in pod["initContainers"]:
        env = {**base, **rendered_env(ctr, node, RECONCILE_NAMESPACE),
               **stand_ins}
        if ctr["name"] == "plugin-validation":
            env["SMOKE_APISERVER"] = api_url
        shown = {k: v for k, v in env.items() if k not in base}
        res = container_process(ctr, scripts, env)
        status = ctr["args"][1] + "-ready"
        with environ(GPU_VALIDATION_DIR=stand_ins["GPU_VALIDATION_DIR"]):
            info = barrier.read_status(status)
        res["barrier"] = info
        log(f"  {ctr['name']}: {ctr['command'] + ctr['args']} -> "
            f"{res['target']}, env {shown}: rc={res['rc']} in "
            f"{res['seconds']:.3f}s ({card}), {status}: {info}")
        if res["rc"] != 0 or info is None:
            raise RuntimeError(f"{ctr['name']} failed (rc={res['rc']}, "
                               f"{status} {info}): {res['stderr_tail']}")
        res.pop("stderr_tail")
        containers[ctr["name"]] = res
    if not containers["dcn-validation"]["barrier"].get("SKIPPED"):
        raise RuntimeError("dcn-validation did not record the single-node "
                           "skip")
    if containers["hbm-validation"]["triad_launches"] == 0:
        raise RuntimeError("hbm-validation did not launch the triad kernel")
    return containers


def gpu_node_cluster(n_cards: int):
    """The port's FakeClient over a GPU node built from the card (GKE's
    accelerator label, the allocatable cards, feature discovery's NVML
    labels) and a CPU node."""
    from tpu_operator_torch.api import labels as L
    from tpu_operator_torch.featurediscovery import FeatureDiscovery
    from tpu_operator_torch.runtime.fake import FakeClient

    client = FakeClient()
    client.add_node(RECONCILE_NODE, labels={
        L.GKE_ACCELERATOR: "nvidia-h100-80gb"},
        allocatable={L.GPU_RESOURCE: str(n_cards)})
    client.add_node("cpu-node")
    FeatureDiscovery(client, RECONCILE_NODE).apply_once()
    return client


def reconcile_phase(torch, card: str, extra_env: dict | None = None,
                    matmul_size: int = MATMUL_SIZE) -> dict:
    """Phase G: the operator's reconcile path. A GPU node built from the
    real card (feature discovery's NVML labels, GKE's accelerator label,
    the allocatable cards) and a CPU node on the port's FakeClient; a
    GPUClusterPolicy whose NVLink gate is this run's NVLINK_THRESHOLD.
    The first pass is notReady (5 s) with the node labelled and every
    enabled state's objects applied; the device plugin's rendered wait
    fails; the rendered validator DaemonSet's init containers run in
    order on the card, each exiting 0 and writing its barrier file
    (plugin-validation against a stub apiserver that plays its pod); every
    operand's rendered wait then passes; with the kubelet simulated the
    policy is ready, a steady pass writes nothing, and disabling the
    metrics exporter removes its DaemonSet. ``extra_env`` and
    ``matmul_size`` serve a rehearsal on the CPU only."""
    from tpu_operator_torch.api import labels as L
    from tpu_operator_torch.api.clusterpolicy import (
        KIND_CLUSTER_POLICY, V1, GPUClusterPolicySpec, new_cluster_policy)
    from tpu_operator_torch.api.conditions import COND_READY, get_condition
    from tpu_operator_torch.controllers.clusterpolicy_controller import (
        ClusterPolicyReconciler)
    from tpu_operator_torch.metrics.registry import render_prometheus
    from tpu_operator_torch.runtime.manager import Request
    from tpu_operator_torch.runtime.objects import is_namespaced, thaw_obj
    from tpu_operator_torch.state.operands import build_states
    from tpu_operator_torch.state.state import SyncContext

    n_cards = torch.cuda.device_count() if extra_env is None else 1
    threshold = float(os.environ.get("NVLINK_THRESHOLD", "0.8"))
    scripts = project_scripts()
    figures = {"card": card, "nvlink_threshold": threshold}
    ms = {}

    # G1. the node, from the card
    client = gpu_node_cluster(n_cards)
    client.create(new_cluster_policy(spec={"validator": {
        "nvlinkBandwidthThreshold": threshold, "matmulSize": matmul_size}}))
    rec = ClusterPolicyReconciler(client=client,
                                  namespace=RECONCILE_NAMESPACE)
    req = Request(name="gpu-cluster-policy")

    def reconcile(label):
        t0 = time.perf_counter()
        result = rec.reconcile(req)
        ms[label] = (time.perf_counter() - t0) * 1e3
        cr = client.get(V1, KIND_CLUSTER_POLICY, req.name)
        return result, cr

    # G2. the first pass
    result, cr = reconcile("first_pass")
    gpu = client.get("v1", "Node", RECONCILE_NODE)["metadata"]["labels"]
    cpu = client.get("v1", "Node", "cpu-node")["metadata"]["labels"]
    dss = sorted(d["metadata"]["name"]
                 for d in client.list("apps/v1", "DaemonSet"))
    log(f"  first pass in {ms['first_pass']!r} ms ({card}): state "
        f"{cr['status']['state']}, requeue {result.requeue_after} s; "
        f"DaemonSets {dss}")
    log(f"  GPU node labels: {gpu}")
    deploy = {L.deploy_label(st) for st in L.CONTAINER_WORKLOAD_STATES}
    if cr["status"]["state"] != "notReady" or result.requeue_after != 5.0:
        raise RuntimeError(f"first pass: {cr['status']}, {result}")
    if gpu.get(L.PRESENT) != "true" or \
            gpu.get(L.GPU_GENERATION) != "h100-sxm" or \
            gpu.get(L.GPU_CHIP_COUNT) != str(n_cards) or \
            not deploy <= {k for k, v in gpu.items() if v == "true"}:
        raise RuntimeError(f"the GPU node's labels are wrong: {gpu}")
    if any(k.startswith(L.DOMAIN) for k in cpu):
        raise RuntimeError(f"the CPU node was labelled: {cpu}")
    ctx_objects = {}
    ctx = SyncContext(client=client, policy=cr,
                      spec=GPUClusterPolicySpec.from_obj(cr),
                      namespace=RECONCILE_NAMESPACE)
    for state in build_states():
        if not state.enabled(ctx):
            continue
        for obj in state.render(ctx):
            ns = RECONCILE_NAMESPACE if is_namespaced(obj["kind"]) else None
            if client.get_or_none(obj["apiVersion"], obj["kind"],
                                  obj["metadata"]["name"], ns) is None:
                raise RuntimeError(f"state {state.name}: {obj['kind']}/"
                                   f"{obj['metadata']['name']} missing")
            ctx_objects[state.name] = ctx_objects.get(state.name, 0) + 1
    log(f"  objects applied per enabled state: {ctx_objects}")
    figures["daemonsets"] = dss

    # G3/G4. the rendered validator pod on the card, gated
    pod = daemonset(client, "gpu-operator-validator")["spec"]["template"][
        "spec"]
    valdir = tempfile.mkdtemp(prefix="gpu-reconcile-validations-")
    stand_ins = validator_stand_ins(pod, valdir)
    base = container_base_env(extra_env)
    pod_runs = []
    api = StubApiserver(RECONCILE_NODE, {}, allocatable={
        L.GPU_RESOURCE: str(n_cards)}, play_pod=play_pod(base, pod_runs))
    try:
        before = operand_waits(
            client, base, stand_ins, scripts, "the device plugin's wait "
            f"before the chain, cut to {WAIT_CUT_TIMEOUT_S} s", cut=True)
        if not before or any(rc == 0 for rc, _ in before.values()):
            raise RuntimeError(f"a wait passed before the chain: {before}")
        chain_t0 = time.perf_counter()
        containers = play_init_containers(pod, base, stand_ins, api.url,
                                          scripts, card)
        chain_s = time.perf_counter() - chain_t0
        after = operand_waits(client, base, stand_ins, scripts,
                              "every operand's wait after the chain")
        if any(rc != 0 for rc, _ in after.values()):
            raise RuntimeError(f"a wait failed after the chain: {after}")
    finally:
        api.stop()
        shutil.rmtree(valdir, ignore_errors=True)
    log(f"  the plugin pod as the stub played it: {pod_runs}")
    hbm = containers["hbm-validation"]

    # G5. ready, steady, an operand disabled
    client.simulate_kubelet(ready=True)
    result, cr = reconcile("ready_pass")
    ready = get_condition(cr, COND_READY)
    gauges = prom_series(render_prometheus())
    nodes_gauge = gauges.get(("gpu_operator_gpu_nodes_total", ()))
    cards_gauge = gauges.get(("gpu_operator_gpu_chips_total", ()))
    log(f"  ready pass in {ms['ready_pass']!r} ms ({card}): state "
        f"{cr['status']['state']}, Ready {ready}, clusterInfo "
        f"{cr['status'].get('clusterInfo')}; gpu_nodes {nodes_gauge}, "
        f"gpu_chips {cards_gauge}")
    if cr["status"]["state"] != "ready" or ready["status"] != "True" or \
            not cr["status"].get("clusterInfo") or nodes_gauge != 1.0 or \
            cards_gauge != float(n_cards):
        raise RuntimeError(f"the policy is not ready: {cr['status']}")
    client.reset_verb_counts()
    result, cr = reconcile("steady_pass")
    verbs = client.reset_verb_counts()
    writes = {v: n for v, n in verbs.items() if v in WRITE_VERBS}
    log(f"  steady pass in {ms['steady_pass']!r} ms ({card}): verbs "
        f"{verbs}")
    if writes or cr["status"]["state"] != "ready":
        raise RuntimeError(f"the steady pass wrote {writes}")
    per_state = {dict(labels)["state"]: v * 1e3
                 for (name, labels), v in gauges.items()
                 if name == "gpu_operator_operand_sync_duration_seconds"}
    log(f"  ms per state in the ready pass (operand_sync_duration, "
        f"{card}): {per_state}")
    spec = thaw_obj(client.get(V1, KIND_CLUSTER_POLICY, req.name))
    # the spec the ready passes ran (phase L holds the install bundle to it)
    figures["policy_spec"] = thaw_obj(spec["spec"])
    spec["spec"]["metricsExporter"] = {"enabled": False}
    client.update(spec)
    reconcile("disable_pass")
    left = client.get_or_none("apps/v1", "DaemonSet", "gpu-metrics-exporter",
                              RECONCILE_NAMESPACE)
    log(f"  metrics exporter disabled: its DaemonSet "
        f"{'remains' if left else 'removed'} ({ms['disable_pass']!r} ms)")
    if left is not None:
        raise RuntimeError("disabling the metrics exporter left its "
                           "DaemonSet")
    figures.update({"ms": ms, "ms_per_state": per_state,
                    "containers": containers, "chain_wall_s": chain_s,
                    "plugin_pod": pod_runs,
                    "triad_launches": hbm["triad_launches"],
                    "waits_before": before, "waits_after": after})
    log(f"  validator chain as the operator waits on it: {chain_s:.3f} s "
        f"wall ({card})")
    return figures


# phase H: the operator's runtime. The manager is wired as gpu-operator
# wires it (the informer cache, the tracing client, leader election, the
# snapshot plane) over phase G's cluster, and nothing calls reconcile():
# the policy's watch, the nodes' and the owned DaemonSets' feed the
# workqueue, and two workers reconcile. A kubelet thread plays the
# rendered validator pod on the card, then marks the DaemonSets ready.
OPERATOR_ARGS = ("--leader-elect", "--workers", "2", "--health-port", "0")
RUNTIME_READY_TIMEOUT_S = 900
STEADY_WINDOW_S = 5.0
WRITE_VERBS = ("create", "update", "update_status", "patch", "delete")


class WriteLog:
    """Every write the apiserver side (the FakeClient) takes, by verb and
    kind: the leader elector's Lease writes are told apart from the
    reconcile's."""

    def __init__(self, client):
        self.entries = []
        self._lock = threading.Lock()
        for verb in WRITE_VERBS:
            setattr(client, verb, self._recorded(verb, getattr(client, verb)))

    def _recorded(self, verb, inner):
        def write(*args, **kw):
            kind = args[0].get("kind") if verb in (
                "create", "update", "update_status") else args[1]
            with self._lock:
                self.entries.append((verb, kind))
            return inner(*args, **kw)
        return write

    def take(self) -> dict:
        """{"verb kind": n} since the last take."""
        with self._lock:
            entries, self.entries = self.entries, []
        out = {}
        for verb, kind in entries:
            out[f"{verb} {kind}"] = out.get(f"{verb} {kind}", 0) + 1
        return out


def wait_for(pred, what: str, timeout: float, poll: float = 0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        value = pred()
        if value:
            return value
        time.sleep(poll)
    raise RuntimeError(f"timed out after {timeout} s waiting for {what}")


def histogram_count(text: str, name: str, controller: str) -> float:
    return prom_series(text).get(
        (name + "_count", (("controller", controller),)), 0.0)


def histogram_total(text: str, name: str, part: str) -> float:
    """A histogram's ``_count`` or ``_sum`` over every label set."""
    return sum(v for (n, _), v in prom_series(text).items()
               if n == name + part)


def operator_process_phase(card: str) -> dict:
    """H0: ``gpu-operator --fake-cluster --once --fake-gpu-nodes 1``,
    resolved through [project.scripts], as a process."""
    ctr = {"name": "gpu-operator", "command": ["gpu-operator"],
           "args": ["--fake-cluster", "--once", "--fake-gpu-nodes", "1"]}
    res = container_process(ctr, project_scripts(),
                            container_base_env(None))
    log(f"  gpu-operator --fake-cluster --once --fake-gpu-nodes 1 -> "
        f"{res['target']}: rc={res['rc']} in {res['seconds']:.3f}s "
        f"({card})")
    if res["rc"] != 0:
        raise RuntimeError(f"gpu-operator exited {res['rc']}: "
                           f"{res['stderr_tail']}")
    res.pop("stderr_tail")
    return res


def reconcile_traces(traces: list) -> list:
    """One row a reconcile, oldest first: ms, queue wait, causes, state."""
    rows = []
    for t in reversed(traces):
        states = [c.get("tags", {}).get("status")
                  for c in t["root"].get("children", [])
                  if c["name"].startswith("state:")]
        causes = sorted({f"{c['reason']} {c.get('origin', '')}".strip()
                         for c in t.get("causes", [])})
        rows.append({"id": t["id"], "ms": t["duration_s"] * 1e3,
                     "queue_wait_ms": (t["queue_wait_s"] or 0.0) * 1e3,
                     "causes": causes,
                     "ready_states": states.count("ready"),
                     "settled": all(s in ("ready", "disabled")
                                    for s in states),
                     "states": len(states), "outcome": t["outcome"]})
    return rows


def runtime_phase(torch, card: str, extra_env: dict | None = None,
                  matmul_size: int = MATMUL_SIZE, rollout=None) -> dict:
    """Phase H: the operator's runtime on the card (H1-H5; H0 runs
    apart). ``extra_env`` and ``matmul_size`` serve a rehearsal on the
    CPU only. ``rollout``, when given, is phase J: called with the
    restarted manager over the same cluster before it stops, its figures
    returned under "rollout"."""
    from tpu_operator_torch.api import labels as L
    from tpu_operator_torch.api.clusterpolicy import (
        KIND_CLUSTER_POLICY, V1, GPUClusterPolicySpec, new_cluster_policy)
    from tpu_operator_torch.cli.operator import build_parser, wire_manager
    from tpu_operator_torch.metrics.registry import render_prometheus
    from tpu_operator_torch.runtime.manager import Request
    from tpu_operator_torch.runtime.timeline import TIMELINE
    from tpu_operator_torch.runtime.tracing import TRACER
    from tpu_operator_torch.state.operands import build_states
    from tpu_operator_torch.state.state import SyncContext

    n_cards = torch.cuda.device_count() if extra_env is None else 1
    threshold = float(os.environ.get("NVLINK_THRESHOLD", "0.8"))
    scripts = project_scripts()
    figures = {"card": card}
    hist = "gpu_operator_reconcile_duration_seconds"

    # H1. the manager over phase G's cluster, wired as gpu-operator does
    client = gpu_node_cluster(n_cards)
    writes = WriteLog(client)
    args = build_parser().parse_args(list(OPERATOR_ARGS))
    snapdir = tempfile.mkdtemp(prefix="gpu-operator-snapshots-")
    valdir = tempfile.mkdtemp(prefix="gpu-runtime-validations-")
    TRACER.reset()
    TIMELINE.reset()
    mgr = wire_manager(client, args, snapshot_dir=snapdir)
    ctrl = mgr.controllers[0]
    hist0 = histogram_count(render_prometheus(), hist, ctrl.name)
    base = container_base_env(extra_env)
    pod_runs = []
    api = StubApiserver(RECONCILE_NODE, {}, allocatable={
        L.GPU_RESOURCE: str(n_cards)}, play_pod=play_pod(base, pod_runs))
    kubelet_out = {}
    mgr2 = None
    try:
        t0 = time.perf_counter()
        mgr.start()
        url = f"http://127.0.0.1:{mgr._http.server_address[1]}"
        wait_for(lambda: mgr.elector.is_leader, "the Lease", 30)
        log(f"  manager started, Lease won in "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms; health server "
            f"{url}; OPERATOR_ARGS {' '.join(OPERATOR_ARGS)}; client "
            f"{type(mgr.client).__name__} -> "
            f"{type(mgr.client.inner).__name__} -> "
            f"{type(mgr.client.inner.inner).__name__}")
        t_install = time.perf_counter()
        client.create(new_cluster_policy(spec={"validator": {
            "nvlinkBandwidthThreshold": threshold,
            "matmulSize": matmul_size}}))

        # H2. the kubelet plays the chain; the manager reconciles alone
        def kubelet():
            try:
                ds = wait_for(lambda: client.get_or_none(
                    "apps/v1", "DaemonSet", "gpu-operator-validator",
                    RECONCILE_NAMESPACE), "the validator DaemonSet", 60)
                pod = ds["spec"]["template"]["spec"]
                stand_ins = validator_stand_ins(pod, valdir)
                c0 = time.perf_counter()
                kubelet_out["containers"] = play_init_containers(
                    pod, base, stand_ins, api.url, scripts, card)
                kubelet_out["chain_s"] = time.perf_counter() - c0
                kubelet_out["waits"] = operand_waits(
                    client, base, stand_ins, scripts,
                    "every operand's wait after the chain")
                if any(rc != 0 for rc, _ in kubelet_out["waits"].values()):
                    raise RuntimeError(f"a wait failed after the chain: "
                                       f"{kubelet_out['waits']}")
                kubelet_out["marked_at"] = time.perf_counter()
                client.simulate_kubelet(ready=True)
            except BaseException as e:  # re-raised by the phase below
                kubelet_out["error"] = e

        th = threading.Thread(target=kubelet, name="smoke-kubelet",
                              daemon=True)
        th.start()

        def policy_state():
            cr = client.get(V1, KIND_CLUSTER_POLICY, "gpu-cluster-policy")
            return (cr.get("status") or {}).get("state")

        wait_for(lambda: policy_state() == "ready" or "error" in kubelet_out,
                 "the policy to be ready", RUNTIME_READY_TIMEOUT_S, 0.02)
        t_ready = time.perf_counter()
        ready_s = t_ready - t_install
        th.join(timeout=60)
        if "error" in kubelet_out:
            raise kubelet_out["error"]
        if "marked_at" not in kubelet_out or th.is_alive():
            raise RuntimeError("the policy was ready before the kubelet "
                               "marked the DaemonSets")
        after_mark_ms = (t_ready - kubelet_out["marked_at"]) * 1e3
        if not mgr.wait_idle(timeout=60, horizon=1.0):
            raise RuntimeError("the controller did not go idle")
        log(f"  the plugin pod as the stub played it: {pod_runs}")
        gauges = prom_series(render_prometheus())
        install_gauge = gauges.get(("gpu_operator_install_to_ready_seconds",
                                    (("policy", "gpu-cluster-policy"),)))
        traces = TRACER.traces(controller=ctrl.name)
        rows = reconcile_traces(traces)
        for row in rows:
            log(f"    reconcile {row['id']}: {row['ms']:.1f} ms, queue "
                f"wait {row['queue_wait_ms']:.2f} ms, {row['ready_states']}"
                f"/{row['states']} states ready, {row['outcome']}, causes "
                f"{row['causes']}")
        ready_row = next(r for r in rows if r["states"] and r["settled"])
        log(f"  H2: ready {ready_s:.3f} s after the policy was created "
            f"(gpu_operator_install_to_ready_seconds {install_gauge!r}), "
            f"{after_mark_ms:.1f} ms after the kubelet marked the "
            f"DaemonSets; {ctrl.reconcile_total} reconciles "
            f"({ctrl.reconcile_errors} failed), none called directly; the "
            f"ready one {ready_row['id']} ({card})")
        if not any(c.startswith("watch:MODIFIED DaemonSet/")
                   for c in ready_row["causes"]):
            raise RuntimeError(f"the ready reconcile was not caused by a "
                               f"DaemonSet's watch event: {ready_row}")
        hbm = kubelet_out["containers"]["hbm-validation"]
        log(f"  validator chain as the runtime waits on it: "
            f"{kubelet_out['chain_s']:.3f} s wall; hbm-validation's child "
            f"launched the triad {hbm['triad_launches']} times ({card})")

        # H3. observability over HTTP
        code, body = http_get(url + "/healthz")
        if code != 200 or body != b"ok":
            raise RuntimeError(f"/healthz answered {code} {body!r}")
        for _ in range(50):
            total = ctrl.reconcile_total
            code, text = http_get(url + "/metrics")
            count = histogram_count(text.decode(), hist, ctrl.name) - hist0
            if code == 200 and total == ctrl.reconcile_total == count:
                break
            time.sleep(0.1)
        else:
            raise RuntimeError(f"/metrics: {hist}_count rose {count}, the "
                               f"controller counted {ctrl.reconcile_total}")
        code, body = http_get(url + "/debug/traces?controller=" + ctrl.name)
        served = json.loads(body)
        ready_trace = next(t for t in served["traces"]
                           if t["id"] == ready_row["id"])
        spans = {c["name"][len("state:"):]: c for c in
                 ready_trace["root"]["children"]
                 if c["name"].startswith("state:")}
        policy = client.get(V1, KIND_CLUSTER_POLICY, "gpu-cluster-policy")
        ctx = SyncContext(client=client, policy=policy,
                          spec=GPUClusterPolicySpec.from_obj(policy),
                          namespace=RECONCILE_NAMESPACE)
        enabled = [s.name for s in build_states() if s.enabled(ctx)]
        ms_per_state = {name: spans[name]["duration_s"] * 1e3
                        for name in enabled if name in spans}
        statuses = {name: spans.get(name, {}).get("tags", {}).get("status")
                    for name in enabled}
        log(f"  H3: /healthz 200; /metrics {hist}_count rose {count:.0f} = "
            f"reconcile_total {ctrl.reconcile_total}; /debug/traces "
            f"{served['count']} traces, the ready one's state spans "
            f"{statuses}")
        log(f"  ms per state in the ready reconcile (its spans, {card}): "
            f"{ms_per_state}")
        if set(ms_per_state) != set(enabled) or \
                any(v != "ready" for v in statuses.values()):
            raise RuntimeError(f"the ready reconcile lacks a state span or "
                               f"a ready status: {statuses}")
        code, body = http_get(url + f"/debug/timeline?kind="
                              f"{KIND_CLUSTER_POLICY}&name=gpu-cluster-policy")
        events = json.loads(body)["events"]
        changes = [(e["detail"]["from"], e["detail"]["to"]) for e in events
                   if e["event"] == "state"]
        log(f"  /debug/timeline: {len(events)} events, state changes "
            f"{changes}")
        if code != 200 or changes != [("new", "notReady"),
                                      ("notReady", "ready")]:
            raise RuntimeError(f"the timeline's state changes: {changes}")
        code, body = http_get(url + "/debug/cache")
        cache = json.loads(body)
        log(f"  /debug/cache: cached {cache['cached']}, cache_reads "
            f"{cache['cache_reads']}, relists {cache['relists']}, kinds "
            f"{ {k: v['objects'] for k, v in cache['kinds'].items()} }")
        if code != 200 or not cache["cached"] or cache["cache_reads"] <= 0:
            raise RuntimeError(f"/debug/cache: {cache}")
        for path in ("/debug/slo", "/debug/snapshot"):
            code, body = http_get(url + path)
            if code != 200:
                raise RuntimeError(f"{path} answered {code}")
        slo = json.loads(http_get(url + "/debug/slo")[1])
        log(f"  /debug/slo 200: "
            f"{ {s['name']: s['breached'] for s in slo['slos']} }; "
            f"/debug/snapshot 200")
        lease = client.get("coordination.k8s.io/v1", "Lease", "gpu-operator",
                           RECONCILE_NAMESPACE)
        log(f"  Lease gpu-operator/{RECONCILE_NAMESPACE} held by "
            f"{lease['spec']['holderIdentity']}")
        if lease["spec"]["holderIdentity"] != mgr.elector.identity:
            raise RuntimeError(f"the Lease is not ours: {lease['spec']}")

        # H4. steady: the kubelet quiet, one more pass through the queue
        writes.take()
        client.reset_verb_counts()
        total0 = ctrl.reconcile_total
        ctrl.enqueue(Request(name="gpu-cluster-policy"))
        time.sleep(STEADY_WINDOW_S)
        if not mgr.wait_idle(timeout=30, horizon=1.0):
            raise RuntimeError("the controller did not go idle")
        steady_writes = writes.take()
        verbs = client.reset_verb_counts()
        ours = {k: n for k, n in steady_writes.items() if k != "update Lease"}
        log(f"  H4: {STEADY_WINDOW_S} s steady, "
            f"{ctrl.reconcile_total - total0} reconciles: writes "
            f"{steady_writes} (the Lease's are the elector's renewals), "
            f"verbs {verbs}")
        if ours or verbs.get("get") or verbs.get("list") or \
                policy_state() != "ready":
            raise RuntimeError(f"the steady state wrote {ours} or read "
                               f"past the cache: {verbs}")

        # H5. restart from the snapshot
        t_stop = time.perf_counter()
        stopping, mgr = mgr, None
        stopping.stop()
        stop_ms = (time.perf_counter() - t_stop) * 1e3
        files = sorted(os.listdir(snapdir))
        writes.take()
        client.reset_verb_counts()
        mgr2 = wire_manager(client, args, snapshot_dir=snapdir)
        ctrl2 = mgr2.controllers[0]
        t_restart = time.perf_counter()
        mgr2.start()
        wait_for(lambda: mgr2.elector.is_leader, "the Lease again", 60)
        wait_for(lambda: ctrl2.reconcile_total >= 1, "a reconcile", 60)
        if not mgr2.wait_idle(timeout=60, horizon=1.0):
            raise RuntimeError("the restarted controller did not go idle")
        restart_ms = (time.perf_counter() - t_restart) * 1e3
        restore = mgr2.last_restore or {}
        restart_writes = writes.take()
        verbs2 = client.reset_verb_counts()
        ours = {k: n for k, n in restart_writes.items()
                if not k.endswith(" Lease")}
        log(f"  H5: stop {stop_ms:.1f} ms wrote {files}; the restart "
            f"restored {restore} and converged in {restart_ms:.1f} ms over "
            f"{ctrl2.reconcile_total} reconciles: writes {restart_writes} "
            f"(the Lease's are the electors'), verbs {verbs2} ({card})")
        if restore.get("outcome") != "restored" or ours or \
                policy_state() != "ready":
            raise RuntimeError(f"the restart: {restore}, wrote {ours}")
        figures.update({
            "install_to_ready_s": ready_s,
            "install_to_ready_gauge_s": install_gauge,
            "ready_after_kubelet_ms": after_mark_ms,
            "reconciles": rows, "ready_reconcile": ready_row["id"],
            "ms_per_state": ms_per_state,
            "chain_wall_s": kubelet_out["chain_s"],
            "containers": kubelet_out["containers"],
            "waits": kubelet_out["waits"], "plugin_pod": pod_runs,
            "triad_launches": hbm["triad_launches"],
            "steady": {"writes": steady_writes, "verbs": verbs},
            "restart": {"restore": restore, "ms": restart_ms,
                        "writes": restart_writes, "verbs": verbs2,
                        "stop_ms": stop_ms}})
        if rollout is not None:
            figures["rollout"] = rollout(
                client=client, mgr=mgr2, api=api, base=base,
                scripts=scripts, valdir=valdir)
        return figures
    finally:
        for m in (mgr, mgr2):
            if m is not None:
                m.stop()
        api.stop()
        shutil.rmtree(valdir, ignore_errors=True)
        shutil.rmtree(snapdir, ignore_errors=True)


# phase I: the port's headline bench as a process; its fleet, placement-
# fleet and restart parts at 2000 nodes, cut from the reference's 10,000
# to keep the script's time (each takes 70-90 s of one host CPU at
# 10,000)
BENCH_FLEET_NODES = 2000
# the rider's federation part: 5 cells of this many nodes (2000 by
# default, cut for the script's time as the fleet parts are)
BENCH_FEDERATION_NODES_PER_CELL = 400
BENCH_TIMEOUT_S = 600


def find_errors(tree, path: str = "") -> list:
    """Every ``error`` key in a doc, by its path."""
    out = []
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k == "error":
                out.append(f"{path}: {v}")
            out += find_errors(v, f"{path}.{k}" if path else k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out += find_errors(v, f"{path}[{i}]")
    return out


def bench_phase(card: str, n_cards: int) -> dict:
    """Phase I: ``python -m tpu_operator_torch.bench`` as a process on the
    card(s). Its one JSON line must parse; the matmul proof (one card) or
    the all-reduce (several) must be correct, and on one card the triad
    too; no part may carry an ``error``; the rider's scale part must be
    ready with no apiserver request left once cached, and both rollouts
    must have rolled. The triad's launches in that process come from its
    stderr's ``# kernels:`` line."""
    env = dict(container_base_env(None),
               GPUOP_BENCH_FLEET_NODES=str(BENCH_FLEET_NODES),
               GPUOP_BENCH_PLACEMENT_FLEET_NODES=str(BENCH_FLEET_NODES),
               GPUOP_BENCH_RESTART_NODES=str(BENCH_FLEET_NODES),
               GPUOP_BENCH_FEDERATION_NODES_PER_CELL=str(
                   BENCH_FEDERATION_NODES_PER_CELL))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "tpu_operator_torch.bench"],
                         env=env, capture_output=True, text=True,
                         timeout=BENCH_TIMEOUT_S)
    secs = time.perf_counter() - t0
    lines = [ln for ln in out.stdout.strip().splitlines() if ln.strip()]
    launches = {"triad": 0}
    for ln in out.stderr.splitlines():
        if ln.startswith("# kernels: "):
            launches = json.loads(ln[len("# kernels: "):])
    log(f"  rc={out.returncode} in {secs:.1f}s ({card}); the line:")
    log("  " + (lines[-1] if lines else "<none>"))
    log(f"  kernel launches in the bench's process: {launches}")
    if out.returncode != 0 or len(lines) != 1:
        raise RuntimeError(f"the bench exited {out.returncode} with "
                           f"{len(lines)} stdout lines: "
                           f"{out.stderr[-2000:]}")
    doc = json.loads(lines[0])
    errors = find_errors(doc)
    if errors:
        raise RuntimeError(f"the bench's line carries errors: {errors}")
    want = ("validator_matmul_tensor_core_utilization" if n_cards == 1
            else "validator_nvlink_allreduce_fraction_of_peak")
    if doc["metric"] != want:
        raise RuntimeError(f"the bench's metric is {doc['metric']!r}, not "
                           f"{want!r} (an _invalid suffix is a failed check)")
    if n_cards == 1:
        triad = doc["hbm_triad"]
        if triad["metric"] != "validator_hbm_triad_fraction_of_peak":
            raise RuntimeError(f"the bench's triad: {triad}")
        if launches["triad"] == 0:
            raise RuntimeError("the bench's HBM figure did not launch the "
                               "triad kernel")
    cp = doc["controlplane"]
    if not cp["ready"] or cp["steady_requests_cached"] != 0:
        raise RuntimeError(f"the scale part: ready {cp['ready']}, "
                           f"{cp['steady_requests_cached']} cached requests")
    if not (cp["rollout"]["rolled"] and cp["rollout_edge"]["rolled"]):
        raise RuntimeError(f"the rollout did not roll: {cp['rollout']} "
                           f"{cp['rollout_edge']}")
    if doc["install_to_ready_seconds"] != cp["install_to_ready_s"]:
        raise RuntimeError("install_to_ready_seconds is not the rider's")
    # the placement parts' claims: scored packing at least first fit's, no
    # acked step lost by the elastic migration, warm and cold restarts
    # deciding alike, the fair policy fairer than the priority baseline
    if cp["fleet_utilization"] < cp["fleet_utilization_first_fit"] or \
            cp["migration"]["elastic_lost_steps"] != 0 or \
            not cp["restart"]["decisions_agree"] or \
            cp["fairness_jain_index"] <= cp["fairness"]["jain_baseline"]:
        raise RuntimeError(f"a placement part's claim fails: "
                           f"{ {k: cp[k] for k in ('placement', 'migration', 'restart', 'fairness')} }")
    fed = cp["federation"]
    log(f"  the rider's federation part: {fed['n_cells']} cells x "
        f"{fed['nodes_per_cell']} nodes, {fed['n_requests']} requests: "
        f"federated {fed['federated_placed_chips']} cards placed against "
        f"flat {fed['flat_placed_chips']} (quality "
        f"{cp['federation_quality_vs_flat']}), route p99 "
        f"{cp['federation_route_p99_ms']} ms against the flat index's "
        f"{fed['flat_p99_ms']} ms ({card})")
    if (fed["n_cells"], fed["nodes_per_cell"]) != (
            5, BENCH_FEDERATION_NODES_PER_CELL) or \
            fed["federated_placed_chips"] <= 0 or \
            cp["federation_route_p99_ms"] <= 0:
        raise RuntimeError(f"the federation part: {fed}")
    return {"card": card, "seconds": secs, "line": doc,
            "triad_launches": launches["triad"]}


# phase J: the stages a node walks in a driver rollout, in order
ROLLOUT_STAGES = ["upgrade-required", "cordon-required", "migrate-required",
                  "drain-required", "pod-restart-required",
                  "validation-required", "uncordon-required", "done"]
ROLLOUT_TIMEOUT_S = 600
ROLLOUT_WORKLOAD = "training-job"


def driver_version() -> str:
    """The driver version the card runs, as nvidia-smi reports it."""
    return smi_query("driver_version")[0][0]


def play_recreated_pods(client, node: str, driver_ds: str, api_url: str,
                        base: dict, scripts: dict, valdir: str,
                        card: str) -> dict:
    """The kubelet's part of a rollout on ``node`` once it waits in
    validation: the recreated driver pod (its init container, then its
    main container with ``--no-park``) and the recreated validator pod's
    init containers run on the card as processes, each exiting 0; then
    the DaemonSets are marked ready."""
    ds = client.get("apps/v1", "DaemonSet", driver_ds,
                    RECONCILE_NAMESPACE)["spec"]["template"]["spec"]
    stand_ins = {"GPU_VALIDATION_DIR": valdir, "HOST_ROOT": "/"}
    driver = {}
    for ctr, extra in ((ds["initContainers"][0], ()),
                       (ds["containers"][0], ("--no-park",))):
        env = {**base, **rendered_env(ctr, node, RECONCILE_NAMESPACE),
               **stand_ins}
        res = container_process(ctr, scripts, env, extra)
        res["env"] = {k: v for k, v in env.items() if k not in base}
        log(f"  the recreated driver pod's {ctr['name']} on {node}: "
            f"{ctr['command'] + ctr['args'] + list(extra)} rc="
            f"{res['rc']} in {res['seconds']:.3f}s, env {res['env']} "
            f"({card})")
        if res["rc"] != 0:
            raise RuntimeError(f"{ctr['name']} failed: "
                               f"{res['stderr_tail']}")
        res.pop("stderr_tail")
        driver[ctr["name"]] = res
    pod = client.get("apps/v1", "DaemonSet", "gpu-operator-validator",
                     RECONCILE_NAMESPACE)["spec"]["template"]["spec"]
    c0 = time.perf_counter()
    containers = play_init_containers(pod, base, stand_ins, api_url,
                                      scripts, card, node=node)
    out = {"driver": driver, "containers": containers,
           "chain_s": time.perf_counter() - c0,
           "marked_at": time.perf_counter()}
    client.simulate_kubelet(ready=True)
    return out


def rollout_phase(torch, card: str, client, mgr, api, base: dict,
                  scripts: dict, valdir: str) -> dict:
    """Phase J: a driver rollout under phase H's restarted manager. A
    GPUDriver takes the card's pool (the policy's driver state stands
    down) and the policy turns auto-upgrade on; a workload pod asks for
    the cards on the node; the GPUDriver's driverVersion is then set to
    the version the card runs, which changes the driver's template, so
    the upgrade FSM must roll the node. A kubelet thread plays the pods
    the FSM deletes: once the node is in validation, the recreated driver
    pod (gpu-driver-manager preflight closes every gate, gpu-driver-install
    proves the pinned version), then the recreated validator pod's init
    containers (hbm-validation's child launches the triad), then marks
    them ready. The node's upgrade.state transitions, the pod events and
    the FSM's evictions are recorded as they happen."""
    from tpu_operator_torch.api import labels as L
    from tpu_operator_torch.api.clusterpolicy import KIND_CLUSTER_POLICY, V1
    from tpu_operator_torch.api.gpudriver import (KIND_GPU_DRIVER, V1ALPHA1,
                                                  new_gpu_driver)
    from tpu_operator_torch.runtime.objects import labels_of, thaw_obj
    from tpu_operator_torch.state.nodepool import get_node_pools

    t_start = time.perf_counter()
    lock = threading.Lock()
    transitions, pod_events, evictions = [], [], []

    def on_node(event):
        if event.obj["metadata"]["name"] != RECONCILE_NODE:
            return
        state = labels_of(event.obj).get(L.UPGRADE_STATE)
        with lock:
            if not transitions or transitions[-1][1] != state:
                transitions.append((time.perf_counter(), state))

    def on_pod(event):
        pod = event.obj
        if (pod.get("spec") or {}).get("nodeName") != RECONCILE_NODE:
            return
        with lock:
            pod_events.append((time.perf_counter(), event.type,
                               pod["metadata"]["name"]))

    unwatch = [client.watch("v1", "Node", on_node),
               client.watch("v1", "Pod", on_pod)]
    upgrader = next(c.reconciler for c in mgr.controllers
                    if c.name == "gpu-upgrade")
    inner_evict = upgrader.client.evict

    def evict(name, namespace=None):  # the FSM's drain, recorded
        with lock:
            evictions.append((time.perf_counter(), f"{namespace}/{name}"))
        return inner_evict(name, namespace)

    upgrader.client.evict = evict

    def state() -> str | None:
        with lock:
            return transitions[-1][1] if transitions else None

    node = client.get("v1", "Node", RECONCILE_NODE)
    [pool] = get_node_pools([node])
    driver_ds = f"gpu-driver-{pool.name}"
    kubelet_out = {}
    try:
        # J1. the GPUDriver takes the card's pool; auto-upgrade on
        client.create(new_gpu_driver("card-pool", {
            "nodeSelector": pool.selector}))
        wait_for(lambda: client.get_or_none("apps/v1", "DaemonSet", driver_ds,
                                            RECONCILE_NAMESPACE),
                 f"the GPUDriver's DaemonSet {driver_ds}", 60)
        policy = thaw_obj(client.get(V1, KIND_CLUSTER_POLICY,
                                     "gpu-cluster-policy"))
        policy["spec"]["upgradePolicy"] = {"autoUpgrade": True,
                                           "maxParallelUpgrades": 1}
        client.update(policy)
        wait_for(lambda: client.get_or_none(
            "apps/v1", "DaemonSet", "gpu-driver-daemonset",
            RECONCILE_NAMESPACE) is None,
            "the policy's driver state to stand down", 60)
        client.simulate_kubelet(ready=True)
        wait_for(lambda: (client.get(V1ALPHA1, KIND_GPU_DRIVER, "card-pool")
                          .get("status") or {}).get("state") == "ready",
                 "the GPUDriver to be ready", 60)
        log(f"  J1: GPUDriver card-pool over pool {pool.name} "
            f"({pool.selector}) ready, DaemonSet {driver_ds}; the policy's "
            f"gpu-driver-daemonset stood down; autoUpgrade on")

        # J2. a workload holds the node's cards
        client.create({"apiVersion": "v1", "kind": "Pod", "metadata": {
            "name": ROLLOUT_WORKLOAD, "namespace": "default"},
            "spec": {"nodeName": RECONCILE_NODE, "containers": [{
                "name": "train", "resources": {"requests": {
                    L.GPU_RESOURCE: str(torch.cuda.device_count())}}}]},
            "status": {"phase": "Running", "conditions": [
                {"type": "Ready", "status": "True"}]}})

        # the kubelet: once the FSM has deleted the node's driver and
        # validator pods and waits in validation, play the recreated pods
        def kubelet():
            try:
                wait_for(lambda: state() == "validation-required",
                         "the node to enter validation", ROLLOUT_TIMEOUT_S)
                kubelet_out["validation_at"] = time.perf_counter()
                live = {p["metadata"]["name"] for p in client.list(
                    "v1", "Pod") if p["spec"].get("nodeName") ==
                    RECONCILE_NODE}
                kubelet_out["pods_at_validation"] = sorted(live)
                kubelet_out.update(play_recreated_pods(
                    client, RECONCILE_NODE, driver_ds, api.url, base,
                    scripts, valdir, card))
            except BaseException as e:  # re-raised by the phase below
                kubelet_out["error"] = e

        th = threading.Thread(target=kubelet, name="smoke-kubelet-rollout",
                              daemon=True)
        th.start()

        # J3. pin the driver version the card runs: the template changes
        version = driver_version()
        cr = thaw_obj(client.get(V1ALPHA1, KIND_GPU_DRIVER, "card-pool"))
        cr["spec"]["driverVersion"] = version
        t_bump = time.perf_counter()
        client.update(cr)
        wait_for(lambda: state() == "done" or "error" in kubelet_out,
                 "the rollout to finish", ROLLOUT_TIMEOUT_S, 0.02)
        t_done = time.perf_counter()
        th.join(timeout=60)
        if "error" in kubelet_out:
            raise kubelet_out["error"]
        if not mgr.wait_idle(timeout=60, horizon=1.0):
            raise RuntimeError("the manager did not go idle after the "
                               "rollout")
    finally:
        for u in unwatch:
            u()
        del upgrader.client.evict

    # J4. what happened, in order
    with lock:
        seq = [s for _, s in transitions if s is not None]
        stage_at = {s: t for t, s in transitions if s is not None}
        events = list(pod_events)
        evicted = list(evictions)
    stage_s = {s: stage_at[b] - stage_at[s]
               for s, b in zip(ROLLOUT_STAGES, ROLLOUT_STAGES[1:])
               if s in stage_at and b in stage_at}
    log(f"  J: upgrade.state transitions of {RECONCILE_NODE}: {seq}")
    log(f"  rollout {t_done - t_bump:.3f} s from the driverVersion bump to "
        f"done; seconds per stage {stage_s} ({card})")
    log(f"  evictions {[e for _, e in evicted]}; the node's pod events "
        f"{[(round(t - t_bump, 3), ty, n) for t, ty, n in events if t >= t_bump]}")
    if seq != ROLLOUT_STAGES:
        raise RuntimeError(f"the node walked {seq}, not {ROLLOUT_STAGES}")
    workload = f"default/{ROLLOUT_WORKLOAD}"
    if [e for _, e in evicted] != [workload] or \
            client.get_or_none("v1", "Pod", ROLLOUT_WORKLOAD, "default"):
        raise RuntimeError(f"the workload did not leave by eviction: "
                           f"{evicted}")
    deleted = {n: t for t, ty, n in events
               if ty == "DELETED" and t >= t_bump}
    added = {n: t for t, ty, n in events if ty == "ADDED" and t >= t_bump}
    validator = f"gpu-operator-validator-{RECONCILE_NODE}"
    driver_pod = f"{driver_ds}-{RECONCILE_NODE}"
    for name in (validator, driver_pod):
        if name not in deleted or name not in added:
            raise RuntimeError(f"{name} was not deleted and recreated: "
                               f"deleted {deleted}, added {added}")
    hbm = kubelet_out["containers"]["hbm-validation"]
    if not (deleted[validator] <= stage_at["validation-required"]
            <= kubelet_out["marked_at"] <= added[validator]
            <= stage_at["uncordon-required"]):
        raise RuntimeError("validation did not wait for the recreated "
                           "validator pod")
    if hbm["triad_launches"] == 0:
        raise RuntimeError("the recreated validator's hbm-validation did "
                           "not launch the triad")
    install = kubelet_out["driver"]["gpu-driver-installer"]
    if install["env"].get("GPU_DRIVER_VERSION") != version:
        raise RuntimeError(f"gpu-driver-install ran without the pinned "
                           f"version: {install['env']}")
    node = client.get("v1", "Node", RECONCILE_NODE)
    if (node.get("spec") or {}).get("unschedulable"):
        raise RuntimeError("the node ended cordoned")
    log(f"  validation waited {added[validator] - stage_at['validation-required']:.3f} s "
        f"for the recreated validator pod (its chain "
        f"{kubelet_out['chain_s']:.3f} s wall; hbm-validation's child "
        f"launched the triad {hbm['triad_launches']} times); "
        f"gpu-driver-install proved driver {version}; the node ends "
        f"uncordoned in done ({card})")
    return {"card": card, "driver_version": version,
            "rollout_s": t_done - t_bump, "stage_s": stage_s,
            "stages": seq, "evictions": [e for _, e in evicted],
            "chain_wall_s": kubelet_out["chain_s"],
            "driver_pod": kubelet_out["driver"],
            "containers": kubelet_out["containers"],
            "pods_at_validation": kubelet_out["pods_at_validation"],
            "triad_launches": hbm["triad_launches"],
            "phase_s": time.perf_counter() - t_start}


# phase K: placement and the elastic handshake. A second node of the
# card's pool (its pods played on the same card) joins; a SliceRequest for
# the card's count is placed by watch events alone; the burn-in trainer
# runs under the port's ElasticWorkload in a process on the card; a
# driver rollout of the placed node's pool walks it into migrate-required,
# where the trainer checkpoints and acks, the migrator rebinds the request
# onto the other node, and a new trainer process restores the ack there
MIGRATION_NODE = RECONCILE_NODE + "-b"   # sorts after the placed node
TRAINER_REQUEST = "burnin-trainer"
TRAINER_NAMESPACE = "default"
# the shim's cadence: exactly TRAINER_STEPS_PER_TICK real train steps a
# tick, a periodic save every TRAINER_CHECKPOINT_EVERY steps (its defaults)
TRAINER_STEPS_PER_TICK = 3
TRAINER_CHECKPOINT_EVERY = 6
TRAINER_TICK_S = 0.1
TRAINER_WARM_STEPS = 12     # steps before the rollout starts
TRAINER_RESUMED_TICKS = 3   # training ticks after the resume, compared
TRAINER_TIMEOUT_S = 300
# the trainer's device; a rehearsal on a host without a card sets "cpu"
TRAINER_DEVICE = "cuda"
TRAINER_CHILD = """
import sys
import chip_smoke
sys.exit(chip_smoke.trainer_process())
"""


class ClusterBridge:
    """The phase's FakeClient as the trainer processes see it, served over
    ``multiprocessing.managers`` on 127.0.0.1: each verb's result comes
    back thawed, its NotFound and Conflict as tags the child raises
    again."""

    def __init__(self, client):
        self.client = client

    def call(self, verb: str, args: tuple, kwargs: dict):
        from tpu_operator_torch.runtime.client import (ConflictError,
                                                       NotFoundError)
        from tpu_operator_torch.runtime.objects import thaw_obj

        try:
            return "ok", thaw_obj(getattr(self.client, verb)(*args,
                                                              **kwargs))
        except NotFoundError as e:
            return "notfound", str(e)
        except ConflictError as e:
            return "conflict", str(e)


class BridgedClient:
    """The trainer process's client: the ElasticWorkload's verbs over the
    parent's ClusterBridge."""

    def __init__(self, bridge):
        self.bridge = bridge

    def _call(self, verb, *args, **kwargs):
        from tpu_operator_torch.runtime.client import (ConflictError,
                                                       NotFoundError)

        tag, value = self.bridge.call(verb, args, kwargs)
        if tag == "notfound":
            raise NotFoundError(value)
        if tag == "conflict":
            raise ConflictError(value)
        return value

    def get(self, *args, **kwargs):
        return self._call("get", *args, **kwargs)

    def get_or_none(self, *args, **kwargs):
        return self._call("get_or_none", *args, **kwargs)

    def patch(self, *args, **kwargs):
        return self._call("patch", *args, **kwargs)

    def update_status(self, *args, **kwargs):
        return self._call("update_status", *args, **kwargs)


def serve_cluster(client) -> tuple:
    """Serve ``client`` to child processes; returns (address, authkey
    hex, stop)."""
    from multiprocessing.managers import BaseManager

    bridge = ClusterBridge(client)

    class Served(BaseManager):
        pass

    Served.register("cluster", callable=lambda: bridge, exposed=("call",))
    key = os.urandom(16)
    server = Served(address=("127.0.0.1", 0), authkey=key).get_server()
    threading.Thread(target=server.serve_forever, name="smoke-cluster",
                     daemon=True).start()
    return server.address, key.hex(), server.stop_event.set


def trainer_process() -> int:
    """Phase K's trainer as one process on the card: the burn-in at
    ``BurninConfig``'s defaults under the port's ``ElasticWorkload`` for
    the SliceRequest, over ``DCPCheckpointStore`` on ``TrainCheckpointer``.
    After each tick the trainer runs the train steps the shim counted
    (``steps_per_tick`` a training tick, none on a restore tick); the
    store's ``state_fn`` catches it up to the shim's step first, so a save
    holds the state of the step it is numbered.

    ``SMOKE_TRAINER_ROLE=first``: tick until the shim has acked a migrate
    intent, then hold still until the binding moves away, and exit. Once
    the file ``SMOKE_TRAINER_HOLD`` names exists (the rollout is about to
    start), its periodic checkpoints stop and it writes that path plus
    ``.quiet``: a periodic save's status write racing the migrator's
    intent would erase the intent's ``status.migration`` (ROADMAP.md
    §C, C8), so from there on the shim writes the handshake's status
    alone.
    ``resume``: the first tick restores the acked step (Resumed); then
    TRAINER_RESUMED_TICKS training ticks, whose losses are held to an
    uninterrupted run from the same seed in this process, exactly. The
    report goes to SMOKE_TRAINER_OUT as JSON."""
    t = {"main": time.time()}
    import torch
    from multiprocessing.managers import BaseManager

    from tpu_operator_torch.api import slicerequest as sr
    from tpu_operator_torch.runtime.objects import get_nested
    from tpu_operator_torch.workloads import burnin
    from tpu_operator_torch.workloads.checkpoint import TrainCheckpointer
    from tpu_operator_torch.workloads.elastic import (DCPCheckpointStore,
                                                      ElasticWorkload)

    role = os.environ["SMOKE_TRAINER_ROLE"]
    device = os.environ["SMOKE_TRAINER_DEVICE"]
    host, port = os.environ["SMOKE_CLUSTER"].rsplit(":", 1)

    class Served(BaseManager):
        pass

    Served.register("cluster")
    served = Served(address=(host, int(port)),
                    authkey=bytes.fromhex(os.environ["SMOKE_AUTHKEY"]))
    served.connect()
    client = BridgedClient(served.cluster())
    cfg = burnin.BurninConfig()
    step_fn, init_state, _ = burnin.make_train_step(None, cfg,
                                                    device=device)
    box = {"state": init_state(0)}

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    sync()
    t["cuda_ready"] = time.time()
    losses = {}
    saves = []

    def caught_up():
        state = box["state"]
        while state.step < shim.step:
            state, loss = step_fn(state, burnin.make_batch(
                cfg, None, state.step, device=device))
            losses[state.step] = loss
        box["state"] = state
        return state

    class TimedStore(DCPCheckpointStore):
        def save(self, step, payload=None, partial=False, layout=None):
            caught_up()
            sync()
            t0 = time.perf_counter()
            super().save(step, payload, partial, layout)
            saves.append((int(step), time.perf_counter() - t0))

    store = TimedStore(TrainCheckpointer(os.environ["SMOKE_TRAINER_CKPT"]),
                       state_fn=caught_up,
                       state_like_fn=lambda: box["state"])
    shim = ElasticWorkload(client, TRAINER_REQUEST, TRAINER_NAMESPACE,
                           store=store,
                           checkpoint_every=TRAINER_CHECKPOINT_EVERY,
                           steps_per_tick=TRAINER_STEPS_PER_TICK)

    def binding():
        cr = client.get_or_none(sr.V1ALPHA1, sr.KIND_SLICE_REQUEST,
                                TRAINER_REQUEST, TRAINER_NAMESPACE)
        return list(get_nested(cr, "status", "nodes", default=[]) or [])

    report = {"role": role, "t": t}
    deadline = time.monotonic() + TRAINER_TIMEOUT_S
    if role == "first":
        bound = binding()
        ticks = 0
        hold = os.environ["SMOKE_TRAINER_HOLD"]
        while binding() == bound:
            if time.monotonic() > deadline:
                raise RuntimeError("the binding never moved")
            if "quiet_step" not in report and os.path.exists(hold):
                shim.checkpoint_every = sys.maxsize
                report["quiet_step"] = shim.step
                with open(hold + ".quiet", "w") as f:
                    f.write(str(shim.step))
            if shim.max_acked < 0:
                shim.tick()
                caught_up()
                ticks += 1
                if shim.max_acked >= 0:
                    t["acked"] = time.time()
            time.sleep(TRAINER_TICK_S)
        t["moved_away"] = time.time()
        report.update(bound=bound, ticks=ticks, step=shim.step,
                      acked=shim.max_acked)
    else:
        t0 = time.perf_counter()
        shim.tick()
        sync()
        report["restore_s"] = time.perf_counter() - t0
        t["resumed"] = time.time()
        restored = shim.step
        if box["state"].step != restored:
            raise RuntimeError(f"the shim restored step {restored}, the "
                               f"state {box['state'].step}")
        for _ in range(TRAINER_RESUMED_TICKS):
            shim.tick()
            caught_up()
            time.sleep(TRAINER_TICK_S)
        # the uninterrupted run from the same seed, in this process
        state, oracle = init_state(0), {}
        for i in range(shim.step):
            state, oracle[i + 1] = step_fn(state, burnin.make_batch(
                cfg, None, i, device=device))
        report.update(
            restored=restored, step=shim.step, bound=binding(),
            oracle={s: float(oracle[s]).hex() for s in sorted(losses)},
            equal={s: bool(torch.equal(losses[s], oracle[s]))
                   for s in sorted(losses)})
    report["losses"] = {s: float(v).hex() for s, v in sorted(losses.items())}
    report["saves"] = saves
    with open(os.environ["SMOKE_TRAINER_OUT"], "w") as f:
        json.dump(report, f)
    return 0


def start_trainer(role: str, address, authkey: str, ckdir: str,
                  out: str, base: dict):
    env = dict(base, SMOKE_TRAINER_ROLE=role,
               SMOKE_TRAINER_DEVICE=TRAINER_DEVICE,
               SMOKE_CLUSTER=f"{address[0]}:{address[1]}",
               SMOKE_AUTHKEY=authkey, SMOKE_TRAINER_CKPT=ckdir,
               SMOKE_TRAINER_OUT=out,
               SMOKE_TRAINER_HOLD=os.path.join(ckdir, "hold"))
    return subprocess.Popen([sys.executable, "-c", TRAINER_CHILD], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def finish_trainer(proc, out: str, what: str) -> dict:
    try:
        _, err = proc.communicate(timeout=TRAINER_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0 or not os.path.exists(out):
        raise RuntimeError(f"the {what} trainer exited {proc.returncode}: "
                           f"{err[-2000:]}")
    with open(out) as f:
        return json.load(f)


def migration_phase(torch, card: str, client, mgr, api, base: dict,
                    scripts: dict, valdir: str, rollout_s: float) -> dict:
    """Phase K under phase H's restarted manager, after J: placement, the
    burn-in trainer under the elastic shim, and a driver rollout that
    moves it to the other node by the handshake, resumed bit-exact."""
    from tpu_operator_torch.api import labels as L
    from tpu_operator_torch.api.gpudriver import KIND_GPU_DRIVER, V1ALPHA1
    from tpu_operator_torch.api import slicerequest as sr
    from tpu_operator_torch.metrics.registry import render_prometheus
    from tpu_operator_torch.runtime.objects import (annotations_of,
                                                    get_nested, labels_of,
                                                    thaw_obj)
    from tpu_operator_torch.state.nodepool import get_node_pools

    t_start = time.perf_counter()
    n_cards = torch.cuda.device_count()
    key = f"{TRAINER_NAMESPACE}/{TRAINER_REQUEST}"
    lock = threading.Lock()
    transitions, phases, evictions, pod_events = [], [], [], []

    def on_node(event):
        if event.obj["metadata"]["name"] != RECONCILE_NODE:
            return
        state = labels_of(event.obj).get(L.UPGRADE_STATE)
        with lock:
            if not transitions or transitions[-1][1] != state:
                transitions.append((time.perf_counter(), state))

    def on_pod(event):
        pod = event.obj
        if (pod.get("spec") or {}).get("nodeName") != RECONCILE_NODE:
            return
        with lock:
            pod_events.append((time.perf_counter(), event.type,
                               pod["metadata"]["name"]))

    def on_request(event):
        if event.obj["metadata"]["name"] != TRAINER_REQUEST:
            return
        status = event.obj.get("status") or {}
        seen = (status.get("phase"),
                (status.get("migration") or {}).get("phase"))
        with lock:
            if not phases or phases[-1][1] != seen:
                phases.append((time.perf_counter(), seen))

    def request():
        return client.get(sr.V1ALPHA1, sr.KIND_SLICE_REQUEST,
                          TRAINER_REQUEST, TRAINER_NAMESPACE)

    def seen_at(want) -> float | None:
        with lock:
            return next((t for t, s in phases if want(s)), None)

    upgrader = next(c.reconciler for c in mgr.controllers
                    if c.name == "gpu-upgrade")
    inner_evict = upgrader.client.evict

    def evict(name, namespace=None):  # the FSM's drain, recorded
        with lock:
            evictions.append((time.perf_counter(), f"{namespace}/{name}"))
        return inner_evict(name, namespace)

    unwatch = [client.watch("v1", "Node", on_node),
               client.watch("v1", "Pod", on_pod),
               client.watch(sr.V1ALPHA1, sr.KIND_SLICE_REQUEST, on_request)]
    upgrader.client.evict = evict
    address, authkey, stop_bridge = serve_cluster(client)
    work = tempfile.mkdtemp(prefix="gpu-migration-")
    valdir_b = tempfile.mkdtemp(prefix="gpu-validations-b-")
    kubelet_out, node_b_out = {}, {}
    procs = []
    node_a = client.get("v1", "Node", RECONCILE_NODE)
    [pool] = get_node_pools([node_a])
    driver_ds = f"gpu-driver-{pool.name}"
    hist = "gpu_operator_placement_latency_seconds"
    try:
        # K1. the second node: the card's own product and topology, its
        # driver rollouts paused (the rollout moves the placed node alone)
        labels = {k: v for k, v in labels_of(node_a).items()
                  if k in (L.GKE_ACCELERATOR, L.GKE_ACCELERATOR_COUNT)
                  or k in L.FEATURE_LABELS}
        alloc = {L.GPU_RESOURCE: str(n_cards)}
        client.create({
            "apiVersion": "v1", "kind": "Node",
            "metadata": {"name": MIGRATION_NODE, "labels": labels,
                         "annotations": {L.DRIVER_UPGRADE_ENABLED: "false"}},
            "spec": {},
            "status": {"allocatable": dict(alloc), "capacity": dict(alloc),
                       "nodeInfo": node_a["status"]["nodeInfo"],
                       "conditions": [{"type": "Ready", "status": "True"}]}})
        api.add_node(MIGRATION_NODE, labels, alloc)

        def node_b_kubelet():  # the new node's validator pod, on the card
            try:
                wait_for(lambda: labels_of(client.get(
                    "v1", "Node", MIGRATION_NODE)).get(
                        L.deploy_label("operator-validation")) == "true",
                    "the second node's deploy labels", 60)
                pod = daemonset(client, "gpu-operator-validator")[
                    "spec"]["template"]["spec"]
                c0 = time.perf_counter()
                node_b_out["containers"] = play_init_containers(
                    pod, base, {"GPU_VALIDATION_DIR": valdir_b,
                                "HOST_ROOT": "/"},
                    api.url, scripts, card, node=MIGRATION_NODE)
                node_b_out["chain_s"] = time.perf_counter() - c0
                client.simulate_kubelet(ready=True)
            except BaseException as e:  # re-raised by the phase below
                node_b_out["error"] = e

        th_b = threading.Thread(target=node_b_kubelet,
                                name="smoke-kubelet-b", daemon=True)
        th_b.start()
        client.simulate_kubelet(ready=True)
        log(f"  K1: node {MIGRATION_NODE} joins pool {pool.name} "
            f"({pool.selector}), {n_cards} card(s), rollouts paused "
            f"({L.DRIVER_UPGRADE_ENABLED}=false); its validator pod plays "
            f"on the card in a kubelet thread")

        # K2. a SliceRequest for the card's count, placed by watch events
        count0 = histogram_total(render_prometheus(), hist, "_count")
        sum0 = histogram_total(render_prometheus(), hist, "_sum")
        t_create = time.perf_counter()
        client.create(sr.new_slice_request(
            TRAINER_REQUEST, {"chips": n_cards},
            namespace=TRAINER_NAMESPACE))
        wait_for(lambda: seen_at(lambda s: s[0] == sr.PHASE_PLACED),
                 "the SliceRequest to be placed", 60, 0.005)
        placed_ms = (seen_at(lambda s: s[0] == sr.PHASE_PLACED)
                     - t_create) * 1e3
        cr = request()
        bound = list(get_nested(cr, "status", "nodes"))
        text = render_prometheus()
        decision_s = histogram_total(text, hist, "_sum") - sum0
        decisions = histogram_total(text, hist, "_count") - count0
        lease = annotations_of(client.get("v1", "Node", RECONCILE_NODE)
                               ).get(L.PLACED_BY)
        log(f"  K2: {key} ({n_cards} card(s)) placed on {bound} "
            f"{placed_ms:.2f} ms after its creation, by watch events alone; "
            f"{decisions:.0f} scoring pass(es), {decision_s * 1e3:.3f} ms "
            f"({hist}); score {cr['status']['score']}; lease {lease!r} "
            f"({card})")
        if bound != [RECONCILE_NODE] or lease != key:
            raise RuntimeError(f"placement: bound {bound}, lease {lease!r}")

        # K3. the trainer on the placed node, and its pod there
        client.create({"apiVersion": "v1", "kind": "Pod", "metadata": {
            "name": TRAINER_REQUEST, "namespace": TRAINER_NAMESPACE},
            "spec": {"nodeName": RECONCILE_NODE, "containers": [{
                "name": "train", "resources": {"requests": {
                    L.GPU_RESOURCE: str(n_cards)}}}]},
            "status": {"phase": "Running", "conditions": [
                {"type": "Ready", "status": "True"}]}})
        ckdir = os.path.join(work, "checkpoints")
        out1, out2 = (os.path.join(work, f"trainer-{i}.json")
                      for i in (1, 2))
        t_first = time.perf_counter()
        first = start_trainer("first", address, authkey, ckdir, out1, base)
        procs.append(first)
        wait_for(lambda: (get_nested(request(), "status", "progress",
                                     "checkpointedStep", default=0) or 0)
                 >= TRAINER_WARM_STEPS or first.poll() is not None,
                 "the trainer's first checkpoints", TRAINER_TIMEOUT_S)
        if first.poll() is not None:
            finish_trainer(first, out1, "first")
        log(f"  K3: the trainer (burn-in at BurninConfig's defaults under "
            f"ElasticWorkload over DCPCheckpointStore) checkpointed step "
            f"{get_nested(request(), 'status', 'progress', 'checkpointedStep')}"
            f" {time.perf_counter() - t_first:.2f} s after its process "
            f"started ({card})")

        # K4. the rollout of the placed node's pool, once the second node
        # is validated (the kubelet's marks are cluster-wide: the first
        # node's validation must wait for its own recreated pod's)
        th_b.join(timeout=ROLLOUT_TIMEOUT_S)
        if "error" in node_b_out or th_b.is_alive():
            raise node_b_out.get("error") or RuntimeError(
                "the second node's validator chain did not finish")

        def kubelet():
            try:
                wait_for(lambda: transitions and transitions[-1][1]
                         == "validation-required",
                         "the node to enter validation", ROLLOUT_TIMEOUT_S)
                kubelet_out.update(play_recreated_pods(
                    client, RECONCILE_NODE, driver_ds, api.url, base,
                    scripts, valdir, card))
            except BaseException as e:  # re-raised by the phase below
                kubelet_out["error"] = e

        # the trainer's periodic saves stop before the rollout (C8)
        hold = os.path.join(ckdir, "hold")
        open(hold, "w").close()
        wait_for(lambda: os.path.exists(hold + ".quiet")
                 or first.poll() is not None,
                 "the trainer to stop its periodic saves", TRAINER_TIMEOUT_S)
        th = threading.Thread(target=kubelet, name="smoke-kubelet-k",
                              daemon=True)
        th.start()
        gd = thaw_obj(client.get(V1ALPHA1, KIND_GPU_DRIVER, "card-pool"))
        version = gd["spec"].pop("driverVersion", None)
        t_bump = time.perf_counter()
        client.update(gd)
        wait_for(lambda: seen_at(lambda s: s[1] == sr.MIG_REBOUND)
                 or "error" in kubelet_out or first.poll() not in (None, 0),
                 "the rebind", ROLLOUT_TIMEOUT_S, 0.005)
        report1 = finish_trainer(first, out1, "first")
        t_second = time.perf_counter()
        second = start_trainer("resume", address, authkey, ckdir, out2, base)
        procs.append(second)
        report2 = finish_trainer(second, out2, "resumed")
        wait_for(lambda: (transitions and transitions[-1][1] == "done")
                 or "error" in kubelet_out,
                 "the rollout to finish", ROLLOUT_TIMEOUT_S, 0.02)
        t_done = time.perf_counter()
        th.join(timeout=60)
        if "error" in kubelet_out:
            raise kubelet_out["error"]
        if th.is_alive():
            raise RuntimeError("the kubelet thread did not finish")
        if not mgr.wait_idle(timeout=60, horizon=1.0):
            raise RuntimeError("the manager did not go idle after K")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for u in unwatch:
            u()
        del upgrader.client.evict
        stop_bridge()
        shutil.rmtree(work, ignore_errors=True)
        shutil.rmtree(valdir_b, ignore_errors=True)

    # K5. what happened, in order
    with lock:  # the node's walk since the version change
        seq = [s for t, s in transitions if s is not None and t >= t_bump]
        stage_at = {s: t for t, s in transitions
                    if s is not None and t >= t_bump}
        mig_seq = [s[1] for _, s in phases if s[1]]
        mig_at = {s[1]: t for t, s in phases if s[1]}
        evicted = list(evictions)
        events = [e for e in pod_events if e[0] >= t_bump]
    cr = request()
    mig = cr["status"]["migration"]
    acked, restored = mig.get("ackedStep"), mig.get("restoredStep")
    intent_to_ack_s = mig_at[sr.MIG_CHECKPOINTED] - mig_at[sr.MIG_MIGRATING]
    ack_to_rebind_ms = (mig_at[sr.MIG_REBOUND]
                        - mig_at[sr.MIG_CHECKPOINTED]) * 1e3
    rebind_to_resumed_s = mig_at[sr.MIG_RESUMED] - mig_at[sr.MIG_REBOUND]
    # the ack's save is the last at the acked step
    ack_save = [s for step, s in report1["saves"] if step == acked][-1:]
    losses, oracle = report2["losses"], report2["oracle"]
    log(f"  K: upgrade.state transitions of {RECONCILE_NODE}: {seq}")
    log(f"  the request's migration phases: {mig_seq}; acked step {acked}, "
        f"restored step {restored}; {report1['ticks']} ticks in the first "
        f"process (periodic saves off from step {report1['quiet_step']}, "
        f"acked at {report1['step']}), the resumed one at step "
        f"{report2['step']}")
    log(f"  intent -> ack {intent_to_ack_s:.3f} s (the ack's DCP save "
        f"{ack_save[0] if ack_save else float('nan'):.3f} s); ack -> rebind "
        f"{ack_to_rebind_ms:.1f} ms (the FSM's 5 s requeue); rebind -> "
        f"resumed {rebind_to_resumed_s:.3f} s (the old process's exit, a "
        f"new process to CUDA ready, and the DCP restore "
        f"{report2['restore_s']:.3f} s); version change -> done "
        f"{t_done - t_bump:.3f} s, against J's {rollout_s:.3f} s ({card})")
    log(f"  losses after the resume (float.hex) {losses}; the uninterrupted "
        f"run's {oracle}")
    if seq != ROLLOUT_STAGES:
        raise RuntimeError(f"the node walked {seq}, not {ROLLOUT_STAGES}")
    if mig_seq != [sr.MIG_MIGRATING, sr.MIG_CHECKPOINTED, sr.MIG_REBOUND,
                   sr.MIG_RESUMED]:
        raise RuntimeError(f"the migration phases: {mig_seq}")
    if not (stage_at["migrate-required"] <= mig_at[sr.MIG_MIGRATING]
            and mig_at[sr.MIG_REBOUND] <= stage_at["drain-required"]):
        raise RuntimeError("the handshake did not run inside the migrate "
                           "stage")
    if acked is None or restored != acked or report2["restored"] != acked \
            or report1["acked"] != acked:
        raise RuntimeError(f"acked {acked}, restored {restored} (status), "
                           f"{report2['restored']} (trainer)")
    if cr["status"]["nodes"] != [MIGRATION_NODE] or \
            report2["bound"] != [MIGRATION_NODE]:
        raise RuntimeError(f"the request is bound to {cr['status']['nodes']}")
    leases = {n: annotations_of(client.get("v1", "Node", n)).get(
        L.PLACED_BY) for n in (RECONCILE_NODE, MIGRATION_NODE)}
    if leases != {RECONCILE_NODE: None, MIGRATION_NODE: key}:
        raise RuntimeError(f"the leases after the move: {leases}")
    if len(losses) != TRAINER_RESUMED_TICKS * TRAINER_STEPS_PER_TICK or \
            min(int(s) for s in losses) != acked + 1 or \
            losses != oracle or not all(report2["equal"].values()):
        raise RuntimeError(f"the resumed losses differ from the "
                           f"uninterrupted run's: {report2['equal']}")
    if [e for _, e in evicted] != [key] or \
            evicted[0][0] < mig_at[sr.MIG_REBOUND]:
        raise RuntimeError(f"the trainer's pod did not leave by eviction "
                           f"after the rebind: {evicted}")
    node = client.get("v1", "Node", RECONCILE_NODE)
    if (node.get("spec") or {}).get("unschedulable"):
        raise RuntimeError("the node ended cordoned")
    deleted = {n: t for t, ty, n in events if ty == "DELETED"}
    added = {n: t for t, ty, n in events if ty == "ADDED"}
    validator = f"gpu-operator-validator-{RECONCILE_NODE}"
    if not (deleted.get(validator, float("inf"))
            <= stage_at["validation-required"] <= kubelet_out["marked_at"]
            <= added.get(validator, float("-inf"))
            <= stage_at["uncordon-required"]):
        raise RuntimeError(f"validation did not wait for the recreated "
                           f"validator pod: deleted {deleted}, added {added}")
    hbm = kubelet_out["containers"]["hbm-validation"]
    hbm_b = node_b_out["containers"]["hbm-validation"]
    if hbm["triad_launches"] == 0 or hbm_b["triad_launches"] == 0:
        raise RuntimeError("a validator's hbm-validation did not launch "
                           "the triad")
    log(f"  {MIGRATION_NODE}'s validator chain {node_b_out['chain_s']:.3f} s "
        f"(the triad {hbm_b['triad_launches']} times in its child); the "
        f"recreated validator on {RECONCILE_NODE} {kubelet_out['chain_s']:.3f}"
        f" s (the triad {hbm['triad_launches']} times); the driver "
        f"{version!r} unpinned; the node ends uncordoned in done ({card})")
    return {"card": card, "placement_ms": placed_ms,
            "placement_decision_ms": decision_s * 1e3,
            "placement_decisions": decisions,
            "intent_to_ack_s": intent_to_ack_s,
            "ack_save_s": ack_save[0] if ack_save else None,
            "ack_to_rebind_ms": ack_to_rebind_ms,
            "rebind_to_resumed_s": rebind_to_resumed_s,
            "restore_s": report2["restore_s"],
            "rollout_s": t_done - t_bump, "rollout_j_s": rollout_s,
            "stages": seq, "migration_phases": mig_seq,
            "acked_step": acked, "restored_step": restored,
            "resumed_losses": losses, "evictions": [e for _, e in evicted],
            "trainer_first": {k: report1[k] for k in ("ticks", "step", "t",
                                                      "quiet_step")},
            "trainer_resumed": {k: report2[k] for k in ("step", "t")},
            "chain_wall_s": kubelet_out["chain_s"],
            "node_b_chain_wall_s": node_b_out["chain_s"],
            "triad_launches": hbm["triad_launches"],
            "triad_launches_node_b": hbm_b["triad_launches"],
            "phase_s": time.perf_counter() - t_start}


# phase L: fleet telemetry and the install surface, under phase H's
# restarted manager after K
PUBLISH_INTERVAL_S = 0.25    # the digest publishers' cadence (30 s a node)
TELEMETRY_TIMEOUT_S = 60
CLI_TIMEOUT_S = 120
TEMP_TOLERANCE_C = 3.0
HBM_FREE_TOLERANCE = 0.02
MUST_GATHER_DIR = os.path.join("build", "smoke-must-gather")


class ClusterReadApi:
    """A FakeClient served read-only over HTTP on 127.0.0.1, for the CLIs
    that reach a cluster through $KUBECONFIG (``gpuop-cfg status``,
    ``gpuop-must-gather``): GET of a collection (one namespace or all,
    a label selector of ``k=v``, ``k`` and ``!k`` terms) and of one
    object, for the kinds those CLIs read; anything else is 404."""

    KINDS = ("Node", "Pod", "ConfigMap", "Service", "Event", "Namespace",
             "DaemonSet", "Lease", "PodDisruptionBudget", "GPUClusterPolicy",
             "GPUDriver", "SliceRequest", "GPUQuota")

    def __init__(self, client):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        from urllib.parse import parse_qs, urlparse

        from tpu_operator_torch.runtime.client import ListOptions
        from tpu_operator_torch.runtime.kubeclient import plural_of

        kinds = {plural_of(k): k for k in self.KINDS}

        def selector(text: str) -> dict:
            match, exprs = {}, []
            for term in filter(None, text.split(",")):
                if "=" in term:
                    k, _, v = term.partition("=")
                    match[k] = v
                elif term.startswith("!"):
                    exprs.append({"key": term[1:],
                                  "operator": "DoesNotExist"})
                else:
                    exprs.append({"key": term, "operator": "Exists"})
            return {"matchLabels": match, "matchExpressions": exprs}

        class Handler(BaseHTTPRequestHandler):
            def _answer(self, code, doc):
                body = json.dumps(doc).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                u = urlparse(self.path)
                segs = [s for s in u.path.split("/") if s]
                if segs[:1] == ["api"]:
                    av, rest = segs[1], segs[2:]
                elif segs[:1] == ["apis"]:
                    av, rest = "/".join(segs[1:3]), segs[3:]
                else:
                    rest = []
                ns = None
                if rest[:1] == ["namespaces"] and len(rest) >= 3:
                    ns, rest = rest[1], rest[2:]
                if not rest or rest[0] not in kinds:
                    return self._answer(404, {"reason": "NotFound"})
                kind = kinds[rest[0]]
                if len(rest) > 1:
                    obj = client.get_or_none(av, kind, rest[1], ns)
                    if obj is None:
                        return self._answer(404, {"reason": "NotFound"})
                    return self._answer(200, obj)
                q = parse_qs(u.query)
                opts = ListOptions(namespace=ns, label_selector=selector(
                    q["labelSelector"][0]) if "labelSelector" in q else None)
                self._answer(200, {"apiVersion": av, "kind": f"{kind}List",
                                   "metadata": {"resourceVersion": "1"},
                                   "items": list(client.list(av, kind,
                                                             opts))})

            def log_message(self, *args):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"

    def kubeconfig(self, path: str) -> str:
        """A kubeconfig naming this server, written to ``path``."""
        with open(path, "w") as f:
            json.dump({"apiVersion": "v1", "kind": "Config",
                       "current-context": "smoke",
                       "contexts": [{"name": "smoke", "context": {
                           "cluster": "smoke", "user": "smoke",
                           "namespace": RECONCILE_NAMESPACE}}],
                       "clusters": [{"name": "smoke",
                                     "cluster": {"server": self.url}}],
                       "users": [{"name": "smoke",
                                  "user": {"token": "smoke"}}]}, f)
        return path

    def stop(self):
        self.server.shutdown()
        self.server.server_close()


class TimedPatches:
    """The client a digest publisher writes through: each patch's start
    time, by (node, digest seq)."""

    def __init__(self, client, published: dict):
        self.client, self.published = client, published

    def patch(self, api_version, kind, name, body, *args, **kwargs):
        from tpu_operator_torch.api import labels as L

        raw = body["metadata"]["annotations"][L.HEALTH_DIGEST]
        self.published[(name, json.loads(raw)["seq"])] = time.perf_counter()
        return self.client.patch(api_version, kind, name, body, *args,
                                 **kwargs)


def fleet_phase(torch, card: str, client, mgr, api, base: dict,
                scripts: dict, valdir: str, ran_spec: dict) -> dict:
    """Phase L under phase H's restarted manager, after K: the card's
    health digests through the Manager's fleet fold; a lost card on the
    second node condemned, its condition written, and K's request
    drained back to the card's node; the CLIs on the live cluster; and
    the install bundle against ``ran_spec``, the policy spec phase G's
    ready passes ran (H created the same; J has since turned its
    autoUpgrade on)."""
    from tpu_operator_torch.api import labels as L
    from tpu_operator_torch.api import slicerequest as sr
    from tpu_operator_torch.api.clusterpolicy import (
        KIND_CLUSTER_POLICY, V1, GPUClusterPolicySpec)
    from tpu_operator_torch.api.crd import cluster_policy_crd
    from tpu_operator_torch.api.validate import admission_errors
    from tpu_operator_torch.controllers.telemetry_controller import (
        TelemetryReconciler)
    from tpu_operator_torch.metrics import health_engine as he
    from tpu_operator_torch.metrics.fleet import (
        FLEET_TELEMETRY, domain_of, node_generation, rollup_nodes)
    from tpu_operator_torch.runtime.objects import (
        annotations_of, get_nested, thaw_obj, yaml_module)
    from tpu_operator_torch.state.operands import build_states
    from tpu_operator_torch.state.state import SyncContext

    t_start = time.perf_counter()
    n_cards = torch.cuda.device_count()
    url = f"http://127.0.0.1:{mgr._http.server_address[1]}"
    key = f"{TRAINER_NAMESPACE}/{TRAINER_REQUEST}"
    node_a, node_b = RECONCILE_NODE, MIGRATION_NODE
    lock = threading.Lock()
    published, folded, conditions, placements = {}, {}, [], []

    def condition_of(node):
        return next((c for c in get_nested(node, "status", "conditions",
                                           default=[]) or []
                     if c.get("type") == L.TELEMETRY_CONDITION), None)

    def on_fold(event_type, node):
        # registered after the fold's own listener: it runs once the
        # fold has taken the digest
        name = node["metadata"]["name"]
        d = FLEET_TELEMETRY.digest_of(name)
        if d is not None:
            with lock:
                folded.setdefault((name, d["seq"]), (
                    time.perf_counter(), FLEET_TELEMETRY.is_condemned(name),
                    FLEET_TELEMETRY.fail_streak(name)))

    def on_node(event):
        name = event.obj["metadata"]["name"]
        cond = condition_of(event.obj)
        with lock:
            if name in (node_a, node_b) and (
                    not conditions or conditions[-1][1:] !=
                    (name, cond and cond["status"])):
                conditions.append((time.perf_counter(), name,
                                   cond and cond["status"]))

    def on_request(event):
        if event.obj["metadata"]["name"] != TRAINER_REQUEST:
            return
        st = event.obj.get("status") or {}
        with lock:
            placements.append((time.perf_counter(), st.get("phase"),
                               list(st.get("nodes") or []),
                               st.get("lastEvictionReason")))

    def fold_of(name, seq):
        with lock:
            return folded.get((name, seq))

    def published_ms(name, seq):
        return (fold_of(name, seq)[0] - published[(name, seq)]) * 1e3

    def publisher(name, engine, stop):
        th = threading.Thread(target=he.publish_digests, args=(
            TimedPatches(client, published), name, engine),
            kwargs={"generation": gen, "interval": PUBLISH_INTERVAL_S,
                    "stop_event": stop}, name=f"smoke-digests-{name}",
            daemon=True)
        th.start()
        return th

    # L0. the telemetry reconciler on the manager wire_manager built: the
    # operator registers none (C9, kept)
    if "telemetry" in [c.name for c in mgr.controllers]:
        raise RuntimeError("wire_manager registered a telemetry reconciler")
    ctrl = mgr.add_reconciler(TelemetryReconciler(client=mgr.client))
    ctrl.start()
    cache = mgr.find_cache()
    unwatch = [cache.add_delta_listener("v1", "Node", on_fold),
               client.watch("v1", "Node", on_node),
               client.watch(sr.V1ALPHA1, sr.KIND_SLICE_REQUEST, on_request)]
    gen = node_generation(client.get("v1", "Node", node_a))
    stops = [threading.Event(), threading.Event()]
    threads = []
    bridge = None
    work = tempfile.mkdtemp(prefix="gpu-fleet-")
    collect_local = he.collect_local
    try:
        # L1. the card's digests: NVML through the health engine
        eng_a = he.HealthEngine()
        eng_a.collect_once()
        smi_temp = max(float(r[0]) for r in smi_query("temperature.gpu"))
        free = min(f / t for f, t in (torch.cuda.mem_get_info(i)
                                      for i in range(n_cards)))
        threads.append(publisher(node_a, eng_a, stops[0]))
        wait_for(lambda: fold_of(node_a, 3), "three folded digests of "
                 + node_a, TELEMETRY_TIMEOUT_S, 0.002)
        stops[0].set()
        threads[0].join(timeout=10)
        digest_a = FLEET_TELEMETRY.digest_of(node_a)
        code, body = http_get(url + "/debug/fleet")
        fleet = json.loads(body)
        dom = fleet["domains"][domain_of(client.get("v1", "Node", node_a))]
        fold_ms = [published_ms(node_a, seq)
                   for seq in range(1, digest_a["seq"] + 1)]
        log(f"  L1: {node_a}'s health engine over NVML published "
            f"{digest_a['seq']} digests: grades {digest_a['grades']}, "
            f"temp_max_c {digest_a['temp_max_c']} (nvidia-smi {smi_temp}), "
            f"hbm_free_frac {digest_a['hbm_free_frac']} (mem_get_info "
            f"{free:.4f}); /debug/fleet {code}: totals {fleet['totals']}, "
            f"domain {dom}; publish -> fold {fold_ms} ms ({card})")
        if code != 200 or set(digest_a["grades"].values()) != {"ok"} or \
                len(digest_a["grades"]) != n_cards:
            raise RuntimeError(f"the card's digest: {digest_a}")
        if abs(digest_a["temp_max_c"] - smi_temp) > TEMP_TOLERANCE_C or \
                abs(digest_a["hbm_free_frac"] - free) > HBM_FREE_TOLERANCE:
            raise RuntimeError(f"the digest disagrees with nvidia-smi and "
                               f"torch.cuda: {digest_a}")
        if (fleet["totals"]["reporting"], fleet["totals"]["silent"],
                fleet["totals"]["degraded_chips"]) != (1, 1, 0) or \
                dom["temp_max_c"] != digest_a["temp_max_c"] or \
                dom["hbm_headroom_frac"] != digest_a["hbm_free_frac"]:
            raise RuntimeError(f"/debug/fleet: {fleet}")

        # L2. a card lost on the second node, by the health engine's own
        # rule (the first enumeration pins the count), condemns it
        eng_b = he.HealthEngine()
        eng_b.collect_once()
        he.collect_local = lambda: []
        try:
            eng_b.collect_once()
        finally:
            he.collect_local = collect_local
        verdict = eng_b.health()
        if verdict["reasons"] != [f"{n_cards} of {n_cards} chips missing"]:
            raise RuntimeError(f"the lost card's verdict: {verdict}")
        threads.append(publisher(node_b, eng_b, stops[1]))
        wait_for(lambda: any(c[1:] == (node_b, "False") for c in conditions)
                 and any(p[1] == sr.PHASE_PLACED and p[2] == [node_a]
                         for p in placements),
                 "the condemnation to move the request", TELEMETRY_TIMEOUT_S,
                 0.002)
        with lock:
            t_cond = next(t for t, n, c in conditions
                          if (n, c) == (node_b, "False"))
            t_placed = next(t for t, ph, nodes, _ in placements
                            if ph == sr.PHASE_PLACED and nodes == [node_a])
            evicted = [r for _, ph, _, r in placements
                       if ph == sr.PHASE_PENDING]
        folds = [fold_of(node_b, seq)[1:] for seq in (1, 2, 3)]
        cond_ms = (t_cond - published[(node_b, 3)]) * 1e3
        placed_ms = (t_placed - t_cond) * 1e3
        cr = client.get(sr.V1ALPHA1, sr.KIND_SLICE_REQUEST, TRAINER_REQUEST,
                        TRAINER_NAMESPACE)
        leases = {n: annotations_of(client.get("v1", "Node", n)).get(
            L.PLACED_BY) for n in (node_a, node_b)}
        written = condition_of(client.get("v1", "Node", node_b))
        log(f"  L2: {node_b}'s engine: {verdict['reasons']}; the fold after "
            f"FAIL 1, 2, 3 (condemned, streak): {folds}; {written}; the "
            f"request drained ({evicted}) and placed on "
            f"{cr['status']['nodes']}, leases {leases}, migration "
            f"{get_nested(cr, 'status', 'migration', 'phase')!r} "
            f"(a hard drain: no handshake)")
        log(f"  third FAIL publish -> GPUTelemetryHealthy=False "
            f"{cond_ms:.3f} ms; condition -> re-Placed {placed_ms:.3f} ms "
            f"({card})")
        if folds != [(False, 1), (False, 2), (True, 3)] or \
                written["reason"] != "TelemetryCondemned":
            raise RuntimeError(f"the condemnation: {folds}, {written}")
        if evicted[:1] != [f"node {node_b} condemned by telemetry"] or \
                cr["status"]["nodes"] != [node_a] or \
                leases != {node_a: key, node_b: None}:
            raise RuntimeError(f"the drain: {evicted}, {cr['status']}, "
                               f"{leases}")

        # two OK digests absolve it: the card is back
        eng_b.collect_once()
        with lock:
            seq_ok = max(seq for n, seq in published if n == node_b) + 1
        wait_for(lambda: any(c[1:] == (node_b, "True") for c in conditions),
                 "the absolution", TELEMETRY_TIMEOUT_S, 0.002)
        stops[1].set()
        threads[1].join(timeout=10)
        with lock:
            t_true = next(t for t, n, c in conditions
                          if (n, c) == (node_b, "True"))
            oks = [seq for (n, seq), v in folded.items()
                   if n == node_b and seq >= seq_ok and v[0] <= t_true]
        log(f"  {node_b} absolved after {len(oks)} OK digest(s) from seq "
            f"{seq_ok} (GPUTelemetryHealthy=True); the request stays on "
            f"{node_a}")
        if FLEET_TELEMETRY.condemned() or len(oks) < 2:
            raise RuntimeError(f"the absolution: {FLEET_TELEMETRY.condemned()}"
                               f", OK digests {oks}")
        if not mgr.wait_idle(timeout=60, horizon=1.0):
            raise RuntimeError("the manager did not go idle after L2")

        # L3. the CLIs on the live cluster, against the manager's port
        bridge = ClusterReadApi(client)
        env = dict(os.environ, PYTHONPATH=os.getcwd(),
                   KUBECONFIG=bridge.kubeconfig(os.path.join(
                       work, "kubeconfig")))
        env.pop("KUBERNETES_SERVICE_HOST", None)

        def cli(*argv):
            t0 = time.perf_counter()
            out = subprocess.run([sys.executable, "-m", *argv], env=env,
                                 capture_output=True, text=True,
                                 timeout=CLI_TIMEOUT_S)
            return out, time.perf_counter() - t0

        fleet = json.loads(http_get(url + "/debug/fleet")[1])
        cfg = "tpu_operator_torch.cli.gpuop_cfg"
        status, status_s = cli(cfg, "status", "-o", "json",
                               "--operator-url", url)
        report = json.loads(status.stdout)
        top, top_s = cli(cfg, "top", "--url", url, "-o", "json")
        top_text, _ = cli(cfg, "top", "--url", url)
        want = {"degradedChips": fleet["totals"]["degraded_chips"],
                "chips": fleet["totals"]["chips"],
                "reporting": fleet["totals"]["reporting"],
                "condemned": fleet["totals"]["condemned"],
                "worstDomain": fleet["worst_domain"]}
        unready = [(o["name"], o["reason"]) for o in report["operands"]
                   if not o["ready"]]
        log(f"  L3: gpuop-cfg status -o json rc {status.returncode} "
            f"(ready {report.get('ready')}: CRs "
            f"{[(c['kind'], c['name'], c['state']) for c in report['crs']]}"
            f", operands not ready {unready}) in {status_s:.3f} s: fleet "
            f"{report.get('fleet')}; /debug/fleet {want}; gpuop-cfg top "
            f"rc {top.returncode} in {top_s:.3f} s:")
        for line in top_text.stdout.splitlines():
            log(f"    {line}")
        if report.get("fleet") != want or json.loads(top.stdout)[
                "totals"] != fleet["totals"] or top.returncode != 0 or \
                json.loads(top.stdout)["worst_domain"] != \
                fleet["worst_domain"]:
            raise RuntimeError(f"status/top disagree with /debug/fleet: "
                               f"{report.get('fleet')}, {top.stdout}")
        shutil.rmtree(MUST_GATHER_DIR, ignore_errors=True)
        gathered, gather_s = cli("tpu_operator_torch.cli.must_gather", "-o",
                                 MUST_GATHER_DIR)
        summary = json.load(open(os.path.join(MUST_GATHER_DIR,
                                              "summary.json")))
        bundle = json.load(open(os.path.join(MUST_GATHER_DIR, "fleet",
                                             "fleet.json")))
        rolled = rollup_nodes(client.list("v1", "Node"))
        log(f"  gpuop-must-gather rc {gathered.returncode} in "
            f"{gather_s:.3f} s into {MUST_GATHER_DIR}: kinds "
            f"{summary['kinds']}, errors {summary['errors']}; fleet.json "
            f"{'==' if bundle == rolled else '!='} rollup_nodes ({card})")
        if gathered.returncode != 0 or bundle != rolled or \
                summary["errors"] or not summary.get("federation_rendered"):
            raise RuntimeError(f"must-gather: {summary}, {gathered.stderr}")
        shutil.rmtree(MUST_GATHER_DIR, ignore_errors=True)

        # L4. the install bundle at default values against the policy G
        # and H reconciled (their threshold, where NVLINK_THRESHOLD moved
        # it, given as a values file)
        live = client.get(V1, KIND_CLUSTER_POLICY, "gpu-cluster-policy")
        ran = dict(thaw_obj(live), spec=thaw_obj(ran_spec))
        values = {}
        if "NVLINK_THRESHOLD" in os.environ:
            values = {"clusterPolicy": {"spec": {"validator": {
                "nvlinkBandwidthThreshold": ran_spec["validator"][
                    "nvlinkBandwidthThreshold"]}}}}
        values_file = os.path.join(work, "values.yaml")
        with open(values_file, "w") as f:
            json.dump(values, f)
        generated, gen_s = cli(cfg, "generate", "all", "--values",
                               values_file)
        yaml = yaml_module()
        docs = [d for d in yaml.safe_load_all(generated.stdout) if d]
        policy = next(d for d in docs if d["kind"] == KIND_CLUSTER_POLICY)
        policy_file = os.path.join(work, "policy.yaml")
        with open(policy_file, "w") as f:
            yaml.safe_dump(policy, f)
        validated, val_s = cli(cfg, "validate", "clusterpolicy", "-f",
                               policy_file)
        schema = cluster_policy_crd()["spec"]["versions"][0]["schema"][
            "openAPIV3Schema"]
        admitted = admission_errors(thaw_obj(policy), None, schema)
        spec_ran = GPUClusterPolicySpec.from_obj(ran).to_obj()
        spec_bundle = GPUClusterPolicySpec.from_obj(policy).to_obj()
        # H's live policy is G's but for J's upgrade knob
        spec_live = GPUClusterPolicySpec.from_obj(live).to_obj()
        h_is_g = all(spec_live[k] == spec_ran[k] for k in spec_ran
                     if k != "upgradePolicy")

        def daemonsets(p):
            ctx = SyncContext(client=client, policy=p,
                              spec=GPUClusterPolicySpec.from_obj(p),
                              namespace=RECONCILE_NAMESPACE)
            return json.loads(json.dumps([
                o for s in build_states() if s.enabled(ctx)
                for o in s.render(ctx) if o["kind"] == "DaemonSet"]))

        rendered = daemonsets(ran)
        same = rendered == daemonsets(dict(thaw_obj(live),
                                           spec=policy["spec"]))
        log(f"  L4: gpuop-cfg generate all --values {values} rc "
            f"{generated.returncode} in {gen_s:.3f} s: "
            f"{[d['kind'] for d in docs]}; gpuop-cfg validate rc "
            f"{validated.returncode} in {val_s:.3f} s "
            f"({validated.stdout.strip()}); CEL admission {admitted}; the "
            f"bundle's spec {'==' if spec_bundle == spec_ran else '!='} "
            f"the one G and H ran (H's live policy "
            f"{'is' if h_is_g else 'is NOT'} G's but for J's "
            f"upgradePolicy {live['spec'].get('upgradePolicy')}); "
            f"{len(rendered)} DaemonSets rendered "
            f"{'alike' if same else 'DIFFERENTLY'} from both ({card})")
        if generated.returncode != 0 or validated.returncode != 0 or \
                admitted or spec_bundle != spec_ran or not h_is_g or \
                not same or not rendered:
            raise RuntimeError(f"the install bundle: {validated.stderr} "
                               f"{admitted}")
        return {"card": card,
                "digests_card_node": digest_a["seq"],
                "digest_temp_max_c": digest_a["temp_max_c"],
                "smi_temp_c": smi_temp,
                "digest_hbm_free_frac": digest_a["hbm_free_frac"],
                "torch_hbm_free_frac": free,
                "publish_to_fold_ms": fold_ms,
                "fail3_to_condition_ms": cond_ms,
                "condition_to_placed_ms": placed_ms,
                "condemn_folds": folds,
                "status_s": status_s, "top_s": top_s,
                "must_gather_s": gather_s, "generate_s": gen_s,
                "validate_s": val_s, "daemonsets": len(rendered),
                "phase_s": time.perf_counter() - t_start}
    finally:
        he.collect_local = collect_local
        for stop in stops:
            stop.set()
        for th in threads:
            th.join(timeout=10)
        for u in unwatch:
            u()
        if bridge is not None:
            bridge.stop()
        shutil.rmtree(work, ignore_errors=True)
        shutil.rmtree(MUST_GATHER_DIR, ignore_errors=True)


# phase M: chaos and federation, after phase H's manager has stopped
CHAOS_NODES = 32
CHAOS_SEED = 7
# scenarios also run as `gpuop-chaos run` processes, their stdout held to
# the in-process verdict byte for byte
CHAOS_CLI_SCENARIOS = ("operator-crash", "cell-partition")
CELLS = ("cell-a", "cell-b")
# one harness pass advances the federation's virtual clock by the chaos
# runner's step (chaos/federation.py STEP_DT); the breaker's horizons
# cost no wall seconds
FEDERATION_STEP_S = 20.0
FEDERATION_PASS_LIMIT = 40
FEDERATION_POLL_S = 0.02


def chaos_phase(card: str) -> dict:
    """M1: all 18 chaos scenarios through the port's ``run_scenario`` in
    this process, at 32 nodes and seed 7 over the port's ``build_cluster``
    mix: each verdict ``ok`` with faults injected and no violation; and
    ``gpuop-chaos run`` as a process for CHAOS_CLI_SCENARIOS, its stdout
    the in-process verdict byte for byte."""
    from tpu_operator_torch.chaos.runner import SCENARIOS, run_scenario

    env = container_base_env(None)
    procs = {s: subprocess.Popen(
        [sys.executable, "-m", "tpu_operator_torch.cli.chaos", "run",
         "--scenario", s, "--nodes", str(CHAOS_NODES), "--seed",
         str(CHAOS_SEED)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for s in CHAOS_CLI_SCENARIOS}
    t_start = time.perf_counter()
    verdicts, seconds = {}, {}
    try:
        for s in SCENARIOS:
            t0 = time.perf_counter()
            v = run_scenario(s, nodes=CHAOS_NODES, seed=CHAOS_SEED)
            seconds[s] = time.perf_counter() - t0
            verdicts[s] = v
            injected = sum(v["faults_injected"].values())
            log(f"  {s}: ok {v['ok']}, {injected} faults injected "
                f"{v['faults_injected']}, {len(v['violations'])} "
                f"violation(s), {v['soak_passes']} soak pass(es), "
                f"{seconds[s]:.3f} s")
            if not v["ok"] or v["violations"] or injected == 0:
                raise RuntimeError(f"chaos scenario {s}: {v['violations']}")
        in_process_s = time.perf_counter() - t_start
        cli = {}
        for s, proc in procs.items():
            out, err = proc.communicate(timeout=CLI_TIMEOUT_S)
            want = json.dumps(verdicts[s], indent=2, sort_keys=True) + "\n"
            cli[s] = {"rc": proc.returncode, "bytes": len(out),
                      "equal": out == want}
            log(f"  gpuop-chaos run --scenario {s} --nodes {CHAOS_NODES} "
                f"--seed {CHAOS_SEED}: rc {proc.returncode}, {len(out)} "
                f"bytes, {'==' if out == want else '!='} the in-process "
                f"verdict")
            if proc.returncode != 0 or out != want:
                raise RuntimeError(f"gpuop-chaos {s}: {err[-2000:]}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    log(f"  {len(verdicts)} scenarios in {in_process_s:.3f} s in this "
        f"process; the longest {max(seconds, key=seconds.get)} "
        f"{max(seconds.values()):.3f} s ({card})")
    return {"card": card, "scenarios": len(verdicts),
            "seconds": seconds, "in_process_s": in_process_s,
            "faults_injected": {s: sum(v["faults_injected"].values())
                                for s, v in verdicts.items()},
            "cli": cli}


def federation_phase(torch, card: str, node_cluster=None) -> dict:
    """M2: a cross-cell migration of the card's trainer. Two cells, each
    its own FakeClient over a GPU node built from the card and a
    cell-pinned PlacementReconciler; a GlobalRouter under a
    FederationReconciler on a Manager with a snapshot dir (``/debug/cells``
    answers); the MultiCellHarness's contact and migration passes on a
    virtual clock the phase advances. The request is routed to cell A and
    placed there, phase K's trainer trains on the card against A; A is
    partitioned from the global plane (its breaker walks to Open, its
    slice untouched), the router restarts from the Manager's snapshot
    mid-window, and past the condemnation horizon the harness hops the
    slice to B by the elastic handshake, where a new trainer restores the
    acked step, its losses bit-equal to an uninterrupted run's. Then
    ``gpuop-cfg cells`` and ``gpuop-must-gather`` run as processes against
    the live manager and a read-only view of the global queue."""
    from tpu_operator_torch.api import labels as L
    from tpu_operator_torch.api import slicerequest as sr
    from tpu_operator_torch.chaos.faults import VirtualClock
    from tpu_operator_torch.chaos.federation import (ROUTER_TUNING,
                                                     _PartitionGate)
    from tpu_operator_torch.controllers.federation_controller import (
        FederationReconciler)
    from tpu_operator_torch.controllers.placement_controller import (
        PlacementReconciler)
    from tpu_operator_torch.federation.digest import cell_digest
    from tpu_operator_torch.federation.router import (CELL_HEALTHY,
                                                      CELL_OPEN,
                                                      CELL_SUSPECT,
                                                      GlobalRouter)
    from tpu_operator_torch.runtime import Request
    from tpu_operator_torch.runtime.cache import CachedClient
    from tpu_operator_torch.runtime.client import ApiError, ListOptions
    from tpu_operator_torch.runtime.fake import FakeClient
    from tpu_operator_torch.runtime.manager import Manager
    from tpu_operator_torch.runtime.multicell import Cell, MultiCellHarness
    from tpu_operator_torch.runtime.objects import (annotations_of,
                                                    get_nested, thaw_obj)

    t_start = time.perf_counter()
    n_cards = torch.cuda.device_count()
    ns = TRAINER_NAMESPACE
    key = f"{ns}/{TRAINER_REQUEST}"
    cell_a, cell_b = CELLS
    # virtual time starts at the wall's: the trainer's shim reads an
    # intent's deadline on its own (wall) clock
    clock = VirtualClock(start=time.time())
    t0_virtual = clock()
    fakes = {c: (node_cluster or gpu_node_cluster)(n_cards) for c in CELLS}
    gates = {c: _PartitionGate(fakes[c]) for c in CELLS}
    recons = {c: PlacementReconciler(fakes[c], namespace=ns,
                                     preemption=False, now=clock, cell=c)
              for c in CELLS}
    harness = MultiCellHarness(
        GlobalRouter(CELLS, now=clock, **ROUTER_TUNING),
        {c: Cell(c, gates[c], reconciler=recons[c], namespace=ns)
         for c in CELLS}, now=clock)
    queue = FakeClient()  # the global queue's apiserver
    lock = threading.Lock()
    seen = {c: [] for c in CELLS}   # (t, phase, migration phase) a cell
    delivered = []

    def on_request(cell):
        def handler(event):
            if event.obj["metadata"]["name"] != TRAINER_REQUEST:
                return
            status = event.obj.get("status") or {}
            s = (event.type, status.get("phase"),
                 (status.get("migration") or {}).get("phase"))
            with lock:
                if not seen[cell] or seen[cell][-1][1] != s:
                    seen[cell].append((time.perf_counter(), s))
        return handler

    def first_at(cell, want):
        with lock:
            return next((t for t, s in seen[cell] if want(s)), None)

    def deliver(cell, cr):  # the router's hand-off to the chosen cell
        meta = cr["metadata"]
        body = {"apiVersion": sr.V1ALPHA1, "kind": sr.KIND_SLICE_REQUEST,
                "metadata": {"name": meta["name"],
                             "namespace": meta.get("namespace") or ns,
                             "annotations": dict(
                                 meta.get("annotations") or {},
                                 **{L.CELL_PIN: cell})},
                "spec": thaw_obj(cr["spec"])}
        harness.cells[cell].client.create(body)
        with lock:
            delivered.append((time.perf_counter(), cell))

    snapdir = tempfile.mkdtemp(prefix="gpu-federation-snapshots-")

    def start_manager(router):
        cached = CachedClient(queue)
        mgr = Manager(cached, namespace=RECONCILE_NAMESPACE, health_port=0,
                      snapshot_dir=snapdir, snapshot_interval=3600.0)
        mgr.add_reconciler(FederationReconciler(cached, router, namespace=ns,
                                                submit=deliver))
        mgr.start()
        return mgr

    def cell_pass():  # each cell's own rider, never behind the gate
        for c in CELLS:
            names = {cr["metadata"]["name"] for cr in fakes[c].list(
                sr.V1ALPHA1, sr.KIND_SLICE_REQUEST,
                ListOptions(namespace=ns))} | {TRAINER_REQUEST}
            for name in sorted(names):
                recons[c].reconcile(Request(name=name, namespace=ns))

    def contact_pass():  # the list through the gate is the probe, as
        # chaos/federation.py's contact pass makes it
        router = harness.router
        for c in router.cells_to_contact():
            try:
                gates[c].list("v1", "Node")
            except ApiError:
                router.record_failure(c)
                continue
            router.record_success(c)
            harness._seq[c] += 1
            router.observe_digest(cell_digest(
                harness.cells[c].fleet_index(), c, harness._seq[c], clock()))
        router.export_metrics()

    def one_pass(advance: bool = True):
        contact_pass()
        cell_pass()
        harness.migration_pass()
        if advance:
            clock.advance(FEDERATION_STEP_S)

    def request_in(cell):
        return fakes[cell].get_or_none(sr.V1ALPHA1, sr.KIND_SLICE_REQUEST,
                                       TRAINER_REQUEST, ns)

    def state_of(cell):
        return harness.router.cells[cell].state

    unwatch = [fakes[c].watch(sr.V1ALPHA1, sr.KIND_SLICE_REQUEST,
                              on_request(c)) for c in CELLS]
    bridges = {c: serve_cluster(fakes[c]) for c in CELLS}
    base = container_base_env(None)
    work = tempfile.mkdtemp(prefix="gpu-federation-")
    ckdir = os.path.join(work, "checkpoints")
    out1, out2 = (os.path.join(work, f"trainer-{i}.json") for i in (1, 2))
    procs, mgr, api = [], None, None
    try:
        # M2.1 an unpinned request for the card's count, routed by the
        # FederationReconciler on a watch event, placed by cell A's rider
        contact_pass()
        mgr = start_manager(harness.router)
        url = f"http://127.0.0.1:{mgr._http.server_address[1]}"
        t_submit = time.perf_counter()
        queue.create(sr.new_slice_request(TRAINER_REQUEST,
                                          {"chips": n_cards}, namespace=ns))
        wait_for(lambda: delivered, "the route", 60, FEDERATION_POLL_S)
        route_ms = (delivered[0][0] - t_submit) * 1e3
        pin = annotations_of(queue.get(sr.V1ALPHA1, sr.KIND_SLICE_REQUEST,
                                       TRAINER_REQUEST, ns)).get(L.CELL_PIN)
        cell_pass()
        placed = request_in(cell_a)
        log(f"  M2.1: {key} ({n_cards} card(s)) on the global queue, "
            f"routed to {delivered[0][1]} by the FederationReconciler "
            f"{route_ms:.3f} ms after its creation (pin {pin!r}); "
            f"{cell_a}'s rider placed it on "
            f"{get_nested(placed, 'status', 'nodes')} "
            f"({get_nested(placed, 'status', 'phase')})")
        if delivered[0][1] != cell_a or pin != cell_a or get_nested(
                placed, "status", "phase") != sr.PHASE_PLACED or \
                request_in(cell_b) is not None:
            raise RuntimeError(f"the route: {delivered}, pin {pin!r}")
        bound_a = list(placed["status"]["nodes"])

        # M2.2 phase K's trainer on the card, against cell A
        t_first = time.perf_counter()
        first = start_trainer("first", bridges[cell_a][0],
                              bridges[cell_a][1], ckdir, out1, base)
        procs.append(first)
        wait_for(lambda: (get_nested(request_in(cell_a), "status",
                                     "progress", "checkpointedStep",
                                     default=0) or 0)
                 >= TRAINER_WARM_STEPS or first.poll() is not None,
                 "the trainer's first checkpoints", TRAINER_TIMEOUT_S)
        if first.poll() is not None:
            finish_trainer(first, out1, "first")
        log(f"  M2.2: the trainer checkpointed step "
            f"{get_nested(request_in(cell_a), 'status', 'progress', 'checkpointedStep')}"
            f" in {cell_a} {time.perf_counter() - t_first:.2f} s after its "
            f"process started ({card})")
        hold = os.path.join(ckdir, "hold")
        open(hold, "w").close()  # periodic saves stop first (C8)
        wait_for(lambda: os.path.exists(hold + ".quiet")
                 or first.poll() is not None,
                 "the trainer to stop its periodic saves", TRAINER_TIMEOUT_S)

        # M2.3 partition cell A from the global plane: only the harness's
        # view fails; A's own rider and the trainer go on
        gates[cell_a].blocked = True
        t_part = clock()
        walk, passes_to_open = [state_of(cell_a)], 0
        while state_of(cell_a) != CELL_OPEN:
            one_pass()
            passes_to_open += 1
            walk.append(state_of(cell_a))
            if passes_to_open > FEDERATION_PASS_LIMIT:
                raise RuntimeError(f"the breaker never opened: {walk}")
        open_since = harness.router.cells[cell_a].open_since
        to_open_s = open_since - t_part
        one_pass()  # into the window
        # M2.4 the router restarts from the Manager's snapshot mid-window
        mgr.write_snapshot_now()
        mgr.stop()
        router2 = GlobalRouter(CELLS, now=clock, **ROUTER_TUNING)
        mgr = start_manager(router2)
        url = f"http://127.0.0.1:{mgr._http.server_address[1]}"
        restore = dict(mgr.last_restore or {})
        harness.router = router2
        recovered = harness.recover_migrations()
        kept = router2.cells[cell_a]
        log(f"  M2.3: {cell_a} partitioned from the global plane at "
            f"virtual {t_part - t0_virtual:.0f} s; breaker {walk} in {passes_to_open} "
            f"pass(es), Open {to_open_s:.0f} virtual s after the partition; "
            f"{cell_a}'s slice still {get_nested(request_in(cell_a), 'status', 'phase')}"
            f" on {get_nested(request_in(cell_a), 'status', 'nodes')}")
        log(f"  M2.4: the router restarted from the Manager's snapshot: "
            f"outcome {restore.get('outcome')}, federation_restored "
            f"{restore.get('federation_restored')}; {cell_a} {kept.state} "
            f"since virtual {kept.open_since - t0_virtual:.0f} s; "
            f"{recovered} migration(s) "
            f"recovered")
        if walk[:3] != [CELL_HEALTHY, CELL_SUSPECT, CELL_OPEN] or \
                restore.get("federation_restored") is not True or \
                kept.state != CELL_OPEN or kept.open_since != open_since or \
                list(get_nested(request_in(cell_a), "status", "nodes")
                     or []) != bound_a or first.poll() is not None:
            raise RuntimeError(f"the partition: {walk}, {restore}, "
                               f"{kept.to_dict()}")
        passes_to_condemned = 1
        while harness.router.condemned_cells() != [cell_a]:
            one_pass()
            passes_to_condemned += 1
            if passes_to_condemned > FEDERATION_PASS_LIMIT:
                raise RuntimeError("the cell was never condemned")
        to_condemned_s = clock() - open_since

        # M2.5 the partition heals behind an Open breaker: the harness
        # hops the condemned cell's slice to B (the clock stands still,
        # so no probe comes due and no intent deadline passes)
        gates[cell_a].blocked = False
        second = None
        t_heal = time.perf_counter()
        while harness.migrations or second is None:
            one_pass(advance=False)
            if second is None and first_at(
                    cell_b, lambda s: s[2] == sr.MIG_REBOUND):
                second = start_trainer("resume", bridges[cell_b][0],
                                       bridges[cell_b][1], ckdir, out2,
                                       base)
                procs.append(second)
            if first.poll() not in (None, 0) or (
                    second is not None and second.poll() not in (None, 0)):
                break
            if time.perf_counter() - t_heal > TRAINER_TIMEOUT_S:
                raise RuntimeError(f"the hop did not finish: "
                                   f"{harness.migrations}")
            time.sleep(FEDERATION_POLL_S)
        report1 = finish_trainer(first, out1, "first")
        report2 = finish_trainer(second, out2, "resumed")
        one_pass(advance=False)
        # the partition is over: A's probe comes due and heals its breaker
        while state_of(cell_a) != CELL_HEALTHY:
            one_pass()
            if clock() - open_since > 10 * ROUTER_TUNING["probe_cap_s"]:
                raise RuntimeError("the healed cell never closed its "
                                   "breaker")

        # M2.7 the CLIs against the live manager and the global queue
        api = ClusterReadApi(queue)
        env = dict(base, KUBECONFIG=api.kubeconfig(os.path.join(
            work, "kubeconfig")))

        def cli(*argv):
            t0 = time.perf_counter()
            out = subprocess.run([sys.executable, "-m", *argv], env=env,
                                 capture_output=True, text=True,
                                 timeout=CLI_TIMEOUT_S)
            return out, time.perf_counter() - t0

        cells_doc = json.loads(http_get(url + "/debug/cells")[1])
        cfg = "tpu_operator_torch.cli.gpuop_cfg"
        cells_json, cells_s = cli(cfg, "cells", "--url", url, "-o", "json")
        cells_text, _ = cli(cfg, "cells", "--url", url)
        bundle_dir = os.path.join(work, "bundle")
        gathered, gather_s = cli("tpu_operator_torch.cli.must_gather", "-o",
                                 bundle_dir)
        summary = json.load(open(os.path.join(bundle_dir, "summary.json")))
        bundled = json.load(open(os.path.join(bundle_dir, "federation",
                                              "cells.json")))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for u in unwatch:
            u()
        for _, _, stop in bridges.values():
            stop()
        if api is not None:
            api.stop()
        if mgr is not None:
            mgr.stop()
        shutil.rmtree(work, ignore_errors=True)
        shutil.rmtree(snapdir, ignore_errors=True)

    # M2.6 what happened, in order
    with lock:
        a_seq = [s for _, s in seen[cell_a]]
        b_seq = [s for _, s in seen[cell_b]]
    intent_at = first_at(cell_a, lambda s: s[2] == sr.MIG_MIGRATING)
    ack_at = first_at(cell_a, lambda s: s[2] == sr.MIG_CHECKPOINTED)
    twin_placed_at = first_at(cell_b, lambda s: s[1] == sr.PHASE_PLACED)
    rebound_at = first_at(cell_b, lambda s: s[2] == sr.MIG_REBOUND)
    resumed_at = first_at(cell_b, lambda s: s[2] == sr.MIG_RESUMED)
    twin = report2
    acked = report1["acked"]
    losses, oracle = report2["losses"], report2["oracle"]
    log(f"  M2.5: {cell_a} condemned {to_condemned_s:.0f} virtual s after "
        f"it opened ({passes_to_condemned} pass(es)); the partition healed "
        f"behind the Open breaker; {cell_a}'s request "
        f"{[s[1:] for s in a_seq]}; {cell_b}'s twin "
        f"{[s[1:] for s in b_seq]}")
    log(f"  intent -> ack {ack_at - intent_at:.3f} s; ack -> twin Placed "
        f"{(twin_placed_at - ack_at) * 1e3:.1f} ms; Rebound -> resumed "
        f"{resumed_at - rebound_at:.3f} s (a new process to CUDA ready and "
        f"the DCP restore {report2['restore_s']:.3f} s); acked step "
        f"{acked}, the first trainer at step {report1['step']} (periodic "
        f"saves off from step {report1['quiet_step']}), resumed at "
        f"{report2['restored']} on {report2['bound']} ({card})")
    log(f"  losses after the resume (float.hex) {losses}; the uninterrupted "
        f"run's {oracle}")
    fig_cells = json.loads(cells_json.stdout or "null")
    log(f"  M2.7: gpuop-cfg cells -o json rc {cells_json.returncode} in "
        f"{cells_s:.3f} s, {'==' if fig_cells == cells_doc else '!='} "
        f"/debug/cells; gpuop-must-gather rc {gathered.returncode} in "
        f"{gather_s:.3f} s: errors {summary['errors']}, federation/cells.json "
        f"{'==' if bundled == {k: cells_doc[k] for k in ('cells', 'unrouted')} else '!='}"
        f" /debug/cells' cells and queue:")
    for line in cells_text.stdout.splitlines():
        log(f"    {line}")
    want_b = [s[2] for s in b_seq if s[2]]
    if [s[2] for s in a_seq if s[2]][:2] != [sr.MIG_MIGRATING,
                                             sr.MIG_CHECKPOINTED] or \
            a_seq[-1][0] != "DELETED" or \
            want_b[-2:] != [sr.MIG_REBOUND, sr.MIG_RESUMED]:
        raise RuntimeError(f"the hop: {a_seq}, {b_seq}")
    if acked is None or report2["restored"] != acked or \
            report2["bound"] != get_nested(
                fakes[cell_b].get(sr.V1ALPHA1, sr.KIND_SLICE_REQUEST,
                                  TRAINER_REQUEST, ns), "status", "nodes") \
            or report1["step"] <= report1["quiet_step"]:
        raise RuntimeError(f"acked {acked}, restored {report2['restored']}, "
                           f"bound {report2['bound']}")
    if len(losses) != TRAINER_RESUMED_TICKS * TRAINER_STEPS_PER_TICK or \
            min(int(s) for s in losses) != acked + 1 or \
            losses != oracle or not all(twin["equal"].values()):
        raise RuntimeError(f"the resumed losses differ from the "
                           f"uninterrupted run's: {twin['equal']}")
    if cells_json.returncode != 0 or fig_cells != cells_doc or \
            cells_text.returncode != 0 or gathered.returncode != 0 or \
            summary["errors"] or bundled != {
                k: cells_doc[k] for k in ("cells", "unrouted")}:
        raise RuntimeError(f"the CLIs: {cells_json.stderr} "
                           f"{gathered.stderr} {summary}")
    return {"card": card, "route_ms": route_ms,
            "passes_to_open": passes_to_open,
            "partition_to_open_virtual_s": to_open_s,
            "passes_to_condemned": passes_to_condemned,
            "open_to_condemned_virtual_s": to_condemned_s,
            "federation_restored": restore.get("federation_restored"),
            "intent_to_ack_s": ack_at - intent_at,
            "ack_to_twin_placed_ms": (twin_placed_at - ack_at) * 1e3,
            "rebound_to_resumed_s": resumed_at - rebound_at,
            "restore_s": report2["restore_s"],
            "acked_step": acked, "restored_step": report2["restored"],
            "quiet_step": report1["quiet_step"],
            "first_trainer_step": report1["step"],
            "resumed_losses": losses,
            "cells_cli_s": cells_s, "must_gather_s": gather_s,
            "phase_s": time.perf_counter() - t_start}



# phase N: the operator as it is deployed. tests/mock_apiserver.py serves
# a real HTTP API on 127.0.0.1 (loaded by path: it imports only the
# standard library at its top, and the few modules it imports while it
# answers a request are served by the port's namesakes, never the JAX
# package's); install.sh installs the bundle with leader election and two
# replicas; the rendered operator Deployment's container runs as two
# gpu-operator processes that find the apiserver through $KUBECONFIG; a
# kubelet thread on its own HTTPClient plays the validator pod on the card
# and marks the DaemonSets. No FakeClient, no --fake-cluster.
MOCK_APISERVER = os.path.join("tests", "mock_apiserver.py")
MOCK_APISERVER_IMPORTS = {
    "tpu_operator.api.validate": "tpu_operator_torch.api.validate",
    "tpu_operator.runtime.client": "tpu_operator_torch.runtime.client",
    "tpu_operator.runtime.objects": "tpu_operator_torch.runtime.objects",
}
INSTALL_SH = os.path.join("tpu_operator_torch", "scripts", "install.sh")
SHELL_E2E = os.path.join("tpu_operator_torch", "scripts", "end-to-end.sh")
SHELL_STAGES = ["install-manifests", "values-pipeline", "lifecycle-hooks",
                "validate-clusterpolicy", "verify-operator",
                "restart-operator", "validator-components", "workload-proof",
                "isolated-plane"]
DEPLOYED_REPLICAS = 2
DEPLOYED_STEADY_S = 10.0
KUBELET_TICK_S = 0.5
# a policy left unreconciled this long at a start (ROADMAP C5), or a
# mutation unseen this long (C12), is taken as dropped, and the policy's
# spec is changed again, as an admin would re-apply it
MUTATION_WAIT_S = 10.0
MUTATION_NUDGES = 3
INJECTED_CONFLICTS = 5
# a reconnect the apiserver's full accept queue refused waits for TCP to
# send its SYN again: 1 s after the first (RFC 6298's initial timeout),
# then 2 s and 4 s more; a reopen past this came through a retransmission
RETRANSMIT_S = 0.9
FAILOVER_TIMEOUT_S = 60
SETTLE_S = 3.0
DEPLOYED_TIMEOUT_S = 600


def load_mock_apiserver():
    """``tests/mock_apiserver.py`` as a module. Its handlers import the
    JAX package's admission check, merge patch and label match where a
    request needs them; here each of those imports is answered by the
    port's module of the same path, and any other import of the JAX
    package fails."""
    import builtins
    import importlib
    import importlib.util

    spec = importlib.util.spec_from_file_location("smoke_mock_apiserver",
                                                  MOCK_APISERVER)
    mod = importlib.util.module_from_spec(spec)
    real = builtins.__import__

    def port_import(name, globals=None, locals=None, fromlist=(), level=0):
        if name in MOCK_APISERVER_IMPORTS and fromlist:
            return importlib.import_module(MOCK_APISERVER_IMPORTS[name])
        if name.split(".")[0] == "tpu_operator":
            raise ImportError(f"the mock apiserver asked for {name}")
        return real(name, globals, locals, fromlist, level)

    mod.__builtins__ = dict(vars(builtins), __import__=port_import)
    spec.loader.exec_module(mod)
    return mod


class ServerLog:
    """Every answer the mock apiserver gives: (method, path, code, the
    policy's status.state where a write answered it)."""

    def __init__(self, srv):
        self.entries = []
        self._lock = threading.Lock()
        handler = srv.http.RequestHandlerClass  # this server's own class
        send = handler._send

        def _send(h, code, doc):
            state = None
            if h.command in ("PUT", "PATCH") and code == 200 and \
                    "gpuclusterpolicies/" in h.path:
                state = (doc.get("status") or {}).get("state")
            with self._lock:
                self.entries.append((h.command, h.path.split("?")[0], code,
                                     state))
            return send(h, code, doc)

        handler._send = _send

    def take(self) -> list:
        with self._lock:
            entries, self.entries = self.entries, []
        return entries

    @staticmethod
    def writes(entries) -> dict:
        """{"METHOD path": n} of the writes among ``entries``."""
        out = {}
        for method, path, _, _ in entries:
            if method in ("POST", "PUT", "PATCH", "DELETE"):
                out[f"{method} {path}"] = out.get(f"{method} {path}", 0) + 1
        return out


class _MarkedWriter:
    """A watch stream's writer that notes when a frame carrying the
    stream log's marker first goes out on it."""

    def __init__(self, inner, rec: dict, streams: "WatchStreamLog"):
        self._inner, self._rec, self._streams = inner, rec, streams

    def write(self, data):
        marker = self._streams.marker
        if marker and self._rec["marked"] is None and marker in data:
            self._rec["marked"] = time.monotonic()
        return self._inner.write(data)

    def __getattr__(self, name):
        return getattr(self._inner, name)


class WatchStreamLog:
    """Every watch stream the mock apiserver serves, seen from the server:
    its collection, the resourceVersion it resumed from, when it opened
    and ended, and when a frame carrying ``marker`` (bytes) first went out
    on it; and when each PUT arrived. Times are ``time.monotonic()``. It
    changes nothing the server sends."""

    def __init__(self, srv):
        self.streams, self.puts = [], []
        self.marker = None
        self._lock = threading.Lock()
        handler = srv.http.RequestHandlerClass  # this server's own class
        serve, put = handler._serve_watch, handler.do_PUT
        log_ = self

        def _serve_watch(h, coll_path, since_rv=""):
            rec = {"collection": coll_path.rsplit("/", 1)[-1],
                   "since": since_rv, "opened": time.monotonic(),
                   "ended": None, "marked": None}
            with log_._lock:
                log_.streams.append(rec)
            h.wfile = _MarkedWriter(h.wfile, rec, log_)
            try:
                return serve(h, coll_path, since_rv)
            finally:
                rec["ended"] = time.monotonic()

        def do_PUT(h):
            with log_._lock:
                log_.puts.append((time.monotonic(), h.path.split("?")[0]))
            return put(h)

        handler._serve_watch, handler.do_PUT = _serve_watch, do_PUT

    def after(self, t0: float, watched: tuple = (),
              put_to: str = "") -> dict:
        """What became of the streams open at ``t0`` (a drop): how many
        ended and when, when their successors opened (ms after ``t0``;
        those past RETRANSMIT_S waited for a dropped SYN to be sent
        again), for each successor on a ``watched`` collection its
        resume point and when the marked frame went out on it (and the
        first such time a collection), and when each PUT to a path
        ending in ``put_to`` arrived."""
        with self._lock:
            streams, puts = list(self.streams), list(self.puts)

        def ms(t):
            return None if t is None else round((t - t0) * 1e3, 1)

        dropped = [s for s in streams if s["opened"] < t0
                   and s["ended"] is not None and s["ended"] >= t0]
        reopened = [s for s in streams if s["opened"] >= t0]
        opened_ms = sorted(ms(s["opened"]) for s in reopened)
        return {
            "dropped": len(dropped),
            "ended_ms": [min((ms(s["ended"]) for s in dropped), default=None),
                         max((ms(s["ended"]) for s in dropped), default=None)],
            "reopened": len(reopened), "reopened_ms": opened_ms,
            "after_retransmit": sum(t >= RETRANSMIT_S * 1e3
                                    for t in opened_ms),
            "puts_ms": [ms(t) for t, path in puts
                        if t >= t0 and path.endswith(put_to)],
            "first_sent_ms": {c: min((ms(s["marked"]) for s in reopened
                                      if s["collection"] == c
                                      and s["marked"] is not None),
                                     default=None) for c in watched},
            "watched": [(s["collection"], s["since"], ms(s["opened"]),
                         ms(s["marked"])) for s in reopened
                        if s["collection"] in watched]}


def node_object(name: str, labels: dict | None = None,
                allocatable: dict | None = None) -> dict:
    """A Node as a joining VM registers it (the FakeClient's add_node)."""
    return {"apiVersion": "v1", "kind": "Node",
            "metadata": {"name": name, "labels": dict(labels or {})},
            "spec": {},
            "status": {"allocatable": dict(allocatable or {}),
                       "capacity": dict(allocatable or {}),
                       "nodeInfo": {"containerRuntimeVersion":
                                    "containerd://1.7.0"},
                       "conditions": [{"type": "Ready", "status": "True"}]}}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def verb_counts(text: str) -> dict:
    """{"verb kind source": n} of the client verb histogram's counts."""
    out = {}
    for (name, labels), v in prom_series(text).items():
        if name == "gpu_operator_client_verb_duration_seconds_count":
            d = dict(labels)
            out[f"{d['verb']} {d['kind']} {d['source']}"] = v
    return out


def delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


class PodPlayer:
    """The kubelet's half for standalone pods: a pod with no owner and no
    phase (plugin-validation's workload pod) runs its first container's
    command as a process, and its exit code is written as its phase."""

    def __init__(self, client, env: dict, runs: list):
        self.client, self.play = client, play_pod(env, runs)
        self.seen = set()
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._loop, daemon=True,
                                       name="smoke-pod-player")
        self.thread.start()

    def _loop(self):
        from tpu_operator_torch.runtime.objects import thaw_obj

        while not self.stop.wait(0.2):
            try:
                pods = self.client.list("v1", "Pod")
            except Exception:  # the apiserver went away at the end
                continue
            for pod in pods:
                meta = pod["metadata"]
                key = (meta.get("namespace"), meta["name"], meta.get("uid"))
                if meta.get("ownerReferences") or key in self.seen or \
                        (pod.get("status") or {}).get("phase"):
                    continue
                self.seen.add(key)
                pod = thaw_obj(pod)
                pod.setdefault("status", {})["phase"] = self.play(pod)
                try:
                    self.client.update_status(pod)
                except Exception as e:  # deleted meanwhile
                    log(f"  pod player: {meta['name']}: {e}")


def start_operator(ctr: dict, scripts: dict, env: dict, port: int,
                   logfile: str):
    """One replica of the rendered operator container as a process: its
    command resolved through [project.scripts], the rendered health port
    replaced by ``port`` (each pod has its own network namespace; here
    the replicas share one)."""
    cmd = list(ctr["command"])
    cmd[cmd.index("--health-port") + 1] = str(port)
    target = scripts[cmd[0]]
    if not target.startswith("tpu_operator_torch."):
        raise RuntimeError(f"{cmd[0]} names no port entry point")
    out = open(logfile, "w")
    proc = subprocess.Popen([sys.executable, "-c", SCRIPT_LAUNCHER, target,
                             *cmd], env=env, stdout=out,
                            stderr=subprocess.STDOUT)
    proc.logfile, proc.url, proc.cmd = logfile, f"http://127.0.0.1:{port}", cmd
    out.close()
    return proc


def leader_identity(proc) -> str | None:
    with open(proc.logfile) as f:
        found = re.findall(r"(\S+) became leader", f.read())
    return found[-1] if found else None


def scrape(proc) -> str:
    code, body = http_get(proc.url + "/metrics")
    if code != 200:
        raise RuntimeError(f"{proc.url}/metrics answered {code}")
    return body.decode()


def policy_reconciles(proc) -> float:
    return histogram_count(scrape(proc),
                           "gpu_operator_reconcile_duration_seconds",
                           "gpuclusterpolicy")


def deployed_phase(torch, card: str, extra_env: dict | None = None,
                   matmul_size: int = MATMUL_SIZE) -> dict:
    """Phase N0-N5: the operator as it is deployed. ``extra_env`` and
    ``matmul_size`` serve a rehearsal on the CPU only."""
    from tpu_operator_torch.api import labels as L
    from tpu_operator_torch.api.clusterpolicy import KIND_CLUSTER_POLICY, V1
    from tpu_operator_torch.featurediscovery import FeatureDiscovery
    from tpu_operator_torch.runtime.client import ListOptions
    from tpu_operator_torch.runtime.fake import simulate_kubelet
    from tpu_operator_torch.runtime.kubeclient import HTTPClient, KubeConfig
    from tpu_operator_torch.runtime.objects import get_nested, thaw_obj

    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count() if extra_env is None else 1
    threshold = float(os.environ.get("NVLINK_THRESHOLD", "0.8"))
    scripts = project_scripts()
    base = container_base_env(extra_env)
    figures = {"card": card}
    work = tempfile.mkdtemp(prefix="gpu-deployed-")
    valdir = os.path.join(work, "validations")
    os.makedirs(valdir)

    # N0. the apiserver, a kubeconfig, the card's node and a CPU node
    api_mod = load_mock_apiserver()
    srv = api_mod.MockApiServer().start()
    server_log = ServerLog(srv)
    stream_log = WatchStreamLog(srv)
    cfg = KubeConfig(server=srv.url, token="smoke", namespace=
                     RECONCILE_NAMESPACE)
    ops, kubelet_client = HTTPClient(cfg), HTTPClient(cfg)
    kubeconfig = os.path.join(work, "kubeconfig")
    with open(kubeconfig, "w") as f:
        json.dump({"apiVersion": "v1", "kind": "Config",
                   "current-context": "smoke",
                   "contexts": [{"name": "smoke", "context": {
                       "cluster": "smoke", "user": "smoke",
                       "namespace": RECONCILE_NAMESPACE}}],
                   "clusters": [{"name": "smoke",
                                 "cluster": {"server": srv.url}}],
                   "users": [{"name": "smoke",
                              "user": {"token": "smoke"}}]}, f)
    ops.create(node_object(RECONCILE_NODE, {
        L.GKE_ACCELERATOR: "nvidia-h100-80gb"},
        {L.GPU_RESOURCE: str(n_cards)}))
    ops.create(node_object("cpu-node"))
    FeatureDiscovery(ops, RECONCILE_NODE).apply_once()
    values = os.path.join(work, "values.yaml")
    with open(values, "w") as f:  # JSON is YAML
        json.dump({"operator": {"leaderElect": True,
                                "replicas": DEPLOYED_REPLICAS},
                   "clusterPolicy": {"spec": {"validator": {
                       "nvlinkBandwidthThreshold": threshold,
                       "matmulSize": matmul_size}}}}, f)
    cli_env = {**base, "KUBECONFIG": kubeconfig}
    log(f"  N0: mock apiserver {srv.url} (tests/mock_apiserver.py), "
        f"kubeconfig {kubeconfig}; nodes {RECONCILE_NODE} (labels "
        f"{ops.get('v1', 'Node', RECONCILE_NODE)['metadata']['labels']}) "
        f"and cpu-node")

    procs = []
    pod_runs = []
    player = PodPlayer(kubelet_client, base, pod_runs)
    kubelet_out = {}
    kubelet_stop = threading.Event()

    def retrying(fn, *args):
        """``fn(*args)``, again after a refused or reset connection: the
        apiserver's accept queue overflows while every watch reconnects."""
        for attempt in range(10):
            try:
                return fn(*args)
            except OSError:
                if attempt == 9:
                    raise
                time.sleep(0.2)

    def policy():
        return retrying(ops.get_or_none, V1, KIND_CLUSTER_POLICY,
                        "gpu-cluster-policy")

    def policy_state():
        return ((policy() or {}).get("status") or {}).get("state")

    def lease_holder():
        lease = retrying(ops.get_or_none, "coordination.k8s.io/v1", "Lease",
                         "gpu-operator", RECONCILE_NAMESPACE)
        return ((lease or {}).get("spec") or {}).get("holderIdentity")

    def cli(*argv, script=None):
        t0 = time.perf_counter()
        cmd = (["bash", script] if script else
               [sys.executable, "-m", "tpu_operator_torch.cli.gpuop_cfg"])
        out = subprocess.run([*cmd, *argv], env=cli_env, capture_output=True,
                             text=True, timeout=CLI_TIMEOUT_S)
        return out, time.perf_counter() - t0

    def daemonset_rvs():
        return {d["metadata"]["name"]: d["metadata"]["resourceVersion"]
                for d in retrying(ops.list, "apps/v1", "DaemonSet",
                                  ListOptions(namespace=RECONCILE_NAMESPACE))}

    def settled(what: str) -> dict:
        """Ready, with no DaemonSet changing for SETTLE_S."""
        rvs, since = None, time.monotonic()
        deadline = time.monotonic() + DEPLOYED_TIMEOUT_S
        while time.monotonic() < deadline:
            now = daemonset_rvs()
            if now != rvs:
                rvs, since = now, time.monotonic()
            elif time.monotonic() - since >= SETTLE_S and \
                    policy_state() == "ready":
                return rvs
            time.sleep(0.1)
        raise RuntimeError(f"not settled {what}")

    def plugin_env_names():
        ds = retrying(ops.get_or_none, "apps/v1", "DaemonSet",
                      "gpu-device-plugin-daemonset", RECONCILE_NAMESPACE)
        return {e.get("name") for e in get_nested(
            ds or {}, "spec", "template", "spec", "containers",
            default=[{}])[0].get("env") or []}

    def update_policy(change):
        from tpu_operator_torch.runtime.client import ConflictError

        for _ in range(50):
            cr = thaw_obj(policy())
            change(cr)
            try:
                retrying(ops.update, cr)
                return
            except ConflictError:
                time.sleep(0.1)
        raise RuntimeError("the policy update never landed")

    def until(pred, what: str, respec) -> int:
        """Wait for ``pred``; each time it stays false MUTATION_WAIT_S,
        change the policy's spec with ``respec(cr, n)``, as an admin
        would re-apply a change: the controller watches the policy's
        generation, so nothing less reaches it. The re-applies."""
        for n in range(MUTATION_NUDGES + 1):
            if n:
                log(f"  {what}: not in {MUTATION_WAIT_S} s (the controller "
                    f"read the policy before its cache had it: ROADMAP C5 "
                    f"at a start, C12 after a change); re-applied ({n})")
                update_policy(lambda cr: respec(cr, n))
            deadline = time.monotonic() + MUTATION_WAIT_S
            while time.monotonic() < deadline:
                if pred():
                    return n
                time.sleep(0.01)
        raise RuntimeError(f"{what}: never, after {MUTATION_NUDGES} "
                           f"re-applies")

    def plugin_env(name: str):
        """A spec change: the device plugin's env is one entry ``name``,
        its value ``n`` (0 first, then each re-apply's count)."""
        def change(cr, n=0):
            cr["spec"].setdefault("devicePlugin", {})["env"] = [
                {"name": name, "value": str(n)}]
        return change

    def mutate(name: str, arm=None) -> dict:
        """Add a devicePlugin env entry; ms until the DaemonSet carries
        it, and the re-applies it took."""
        t0 = time.perf_counter()
        update_policy(plugin_env(name))
        if arm:
            arm()
        reapplied = until(lambda: name in plugin_env_names(), name,
                          plugin_env(name))
        return {"ms": (time.perf_counter() - t0) * 1e3,
                "reapplied": reapplied}

    def kubelet():
        try:
            ds = wait_for(lambda: retrying(
                kubelet_client.get_or_none, "apps/v1", "DaemonSet",
                "gpu-operator-validator", RECONCILE_NAMESPACE),
                "the validator DaemonSet", DEPLOYED_TIMEOUT_S)
            pod = ds["spec"]["template"]["spec"]
            stand_ins = validator_stand_ins(pod, valdir)
            c0 = time.perf_counter()
            kubelet_out["containers"] = play_init_containers(
                pod, base, stand_ins, srv.url, scripts, card)
            kubelet_out["chain_s"] = time.perf_counter() - c0
            kubelet_out["waits"] = operand_waits(
                kubelet_client, base, stand_ins, scripts,
                "every operand's wait after the chain")
            if any(rc != 0 for rc, _ in kubelet_out["waits"].values()):
                raise RuntimeError(f"a wait failed after the chain: "
                                   f"{kubelet_out['waits']}")
            simulate_kubelet(kubelet_client, ready=True)
            kubelet_out["marked_at"] = time.perf_counter()
            while not kubelet_stop.wait(KUBELET_TICK_S):
                try:
                    simulate_kubelet(kubelet_client, ready=True)
                except Exception as e:  # a write race, or the end
                    kubelet_out["tick_error"] = repr(e)
        except BaseException as e:  # re-raised by the phase below
            kubelet_out["error"] = e

    def relisted(proc) -> int:
        """The watches ``proc`` re-listed after the 2 s back-off (its
        kubeclient logs each)."""
        with open(proc.logfile) as f:
            return f.read().count("re-listing in 2s")

    th = threading.Thread(target=kubelet, name="smoke-kubelet", daemon=True)
    try:
        # N1. install, two replicas, ready
        t_install = time.perf_counter()
        out, install_s = cli("install", "-f", values, script=INSTALL_SH)
        if out.returncode != 0:
            raise RuntimeError(f"install.sh install: {out.stderr}")
        dep = ops.get("apps/v1", "Deployment", "gpu-operator",
                      RECONCILE_NAMESPACE)
        ctr = dep["spec"]["template"]["spec"]["containers"][0]
        replicas = dep["spec"]["replicas"]
        log(f"  N1: install.sh install -f {values} in {install_s:.3f} s: "
            f"Deployment gpu-operator, {replicas} replicas, "
            f"{' '.join(ctr['command'])}")
        if replicas != DEPLOYED_REPLICAS or \
                "--leader-elect" not in ctr["command"]:
            raise RuntimeError(f"the rendered Deployment: {dep['spec']}")
        installed_spec = thaw_obj(policy())["spec"]
        th.start()
        op_env = {**base, **rendered_env(ctr, RECONCILE_NODE,
                                         RECONCILE_NAMESPACE),
                  "KUBECONFIG": kubeconfig}
        for i in range(replicas):
            procs.append(start_operator(
                ctr, scripts, op_env, free_port(),
                os.path.join(work, f"gpu-operator-{i}.log")))
        wait_for(lambda: lease_holder() or any(
            p.poll() is not None for p in procs), "the Lease",
            DEPLOYED_TIMEOUT_S, 0.05)
        start_reapplied = until(lambda: policy_state() is not None,
                                "the leader's first reconcile",
                                plugin_env("SMOKE_REAPPLIED"))
        wait_for(lambda: policy_state() == "ready" or "error" in kubelet_out
                 or any(p.poll() is not None for p in procs),
                 "the policy to be ready", DEPLOYED_TIMEOUT_S, 0.02)
        t_ready = time.perf_counter()
        if "error" in kubelet_out:
            raise kubelet_out["error"]
        dead = [p.cmd for p in procs if p.poll() is not None]
        if dead or "marked_at" not in kubelet_out:
            raise RuntimeError(f"operators exited {dead}, or ready before "
                               f"the kubelet marked the DaemonSets")
        ready_s = t_ready - t_install
        after_mark_ms = (t_ready - kubelet_out["marked_at"]) * 1e3
        identities = {leader_identity(p): p for p in procs}
        lease = lease_holder()
        leader = identities.get(lease)
        if leader is None or None not in identities:
            raise RuntimeError(f"the Lease's holder {lease} is not one "
                               f"replica alone: {list(identities)}")
        standby = next(p for p in procs if p is not leader)
        at_ready = server_log.take()
        start_conflicts = [(m, p) for m, p, code, _ in at_ready
                           if m == "POST" and code == 409]
        leader_reconciles = policy_reconciles(leader)
        hbm = kubelet_out["containers"]["hbm-validation"]
        if start_reapplied:  # back to the installed spec, for diff
            update_policy(lambda cr: cr.update(spec=installed_spec))
            settled("after the installed spec came back")
        status, status_s = cli("status")
        diff, diff_s = cli("diff", "--values", values)
        log(f"  N1: ready {ready_s:.3f} s after install.sh started, the "
            f"chain {kubelet_out['chain_s']:.3f} s of it; "
            f"{after_mark_ms:.1f} ms after the kubelet's marks; leader "
            f"{lease} ({leader.url}), {leader_reconciles:.0f} policy "
            f"reconciles (C6); creates answered 409 at start "
            f"{start_conflicts}, the policy re-applied {start_reapplied} "
            f"times (C5); hbm-validation's child launched the triad "
            f"{hbm['triad_launches']} times; gpuop-cfg status rc "
            f"{status.returncode} ({status_s:.3f} s), diff rc "
            f"{diff.returncode} ({diff_s:.3f} s); the plugin pod "
            f"{pod_runs} ({card})")
        if status.returncode != 0 or status.stdout.strip().splitlines()[
                -1] != "READY" or diff.returncode != 0:
            raise RuntimeError(f"status/diff: {status.stdout} "
                               f"{diff.stdout} {diff.stderr}")
        if hbm["triad_launches"] != TRIAD_LAUNCHES_PER_HBM_PROOF:
            raise RuntimeError(f"hbm-validation's child launched the "
                               f"triad {hbm['triad_launches']} times")

        # N2. steady: the Lease's writes alone; the standby idle
        rvs = settled("before the steady window")
        server_log.take()
        verbs0 = verb_counts(scrape(leader))
        time.sleep(DEPLOYED_STEADY_S)
        verbs = delta(verb_counts(scrape(leader)), verbs0)
        window = server_log.take()
        writes = ServerLog.writes(window)
        lease_path = (f"/apis/coordination.k8s.io/v1/namespaces/"
                      f"{RECONCILE_NAMESPACE}/leases/gpu-operator")
        ours = {k: n for k, n in writes.items() if k != f"PUT {lease_path}"}
        client_writes = {k: n for k, n in verbs.items()
                         if k.split()[0] in WRITE_VERBS
                         and k.split()[1] != "Lease"}
        standby_reconciles = policy_reconciles(standby)
        reads = {src: sum(n for k, n in verbs.items()
                          if k.endswith(" " + src)
                          and k.split()[0] in ("get", "list"))
                 for src in ("cache", "api")}
        log(f"  N2: {DEPLOYED_STEADY_S} s steady: the apiserver took "
            f"{writes} ({len(window)} requests); the leader's verbs "
            f"{verbs} (reads by source {reads}); the standby's policy "
            f"reconciles {standby_reconciles:.0f}")
        if ours or client_writes or standby_reconciles or \
                daemonset_rvs() != rvs:
            raise RuntimeError(f"the steady window wrote {ours} "
                               f"{client_writes}, or the standby "
                               f"reconciled {standby_reconciles}")

        # N3. mutations: plain, through 409s, after dropped watches
        mutations = {"plain": mutate("SMOKE_MUTATION")}

        def arm():
            srv.fail_next_writes = INJECTED_CONFLICTS

        mutations["conflicts"] = mutate("SMOKE_AFTER_CONFLICTS", arm)
        wait_for(lambda: srv.fail_next_writes == 0,
                 "the injected conflicts to be taken", 60)
        stream_log.marker = b'"SMOKE_AFTER_DROP"'
        relists = [relisted(p) for p in procs]
        t_drop = time.monotonic()
        srv.drop_watch_streams()
        mutations["dropped_watches"] = mutate("SMOKE_AFTER_DROP")
        streams = stream_log.after(
            t_drop, ("gpuclusterpolicies", "daemonsets"),
            "/gpuclusterpolicies/gpu-cluster-policy")
        streams["relisted"] = [relisted(p) - n
                               for p, n in zip(procs, relists)]
        mutations["dropped_watches"]["streams"] = streams
        log(f"  N3 streams after the drop (ms after it, seen by the "
            f"apiserver): {streams['dropped']} ended in "
            f"{streams['ended_ms']}; {streams['reopened']} reopened at "
            f"{streams['reopened_ms']}, {streams['after_retransmit']} of "
            f"them after a SYN the full accept queue dropped was sent "
            f"again (>= {RETRANSMIT_S} s); re-listed after the 2 s "
            f"back-off, by operator process: {streams['relisted']}; the "
            f"change's PUTs at {streams['puts_ms']}, first sent on "
            f"{streams['first_sent_ms']} (a DaemonSets stream: the leader "
            f"wrote it); the policy's and the DaemonSets' new streams "
            f"(collection, resumed from rv, opened, the change sent): "
            f"{streams['watched']}")
        log(f"  N3: mutations applied (ms until the DaemonSet carried "
            f"them; re-applied where one was dropped, C12): "
            f"{mutations}; "
            f"{INJECTED_CONFLICTS} 409s injected, all taken ({card})")

        # N4. fail over: SIGKILL the leader
        rvs = settled("before the failover")
        server_log.take()
        t_kill = time.perf_counter()
        leader.kill()
        leader.wait(timeout=30)
        wait_for(lambda: lease_holder() != lease,
                 "the standby to take the Lease", FAILOVER_TIMEOUT_S, 0.05)
        takeover_s = time.perf_counter() - t_kill
        new_holder = lease_holder()
        wait_for(lambda: leader_identity(standby) is not None and
                 policy_reconciles(standby) > 0, "the new leader's first "
                 "reconcile", FAILOVER_TIMEOUT_S)
        standby_id = leader_identity(standby)
        after = settled("after the failover")
        churn = sorted(k for k in set(rvs) | set(after)
                       if rvs.get(k) != after.get(k))
        failover_log = server_log.take()
        failover_conflicts = [(m, p) for m, p, code, _ in failover_log
                              if m == "POST" and code == 409]
        failover_states = [s for *_, s in failover_log if s]
        new_reconciles = policy_reconciles(standby)
        mutations["after_failover"] = mutate("SMOKE_AFTER_FAILOVER")
        log(f"  N4: SIGKILL {lease}; {new_holder} led {takeover_s:.3f} s "
            f"later (Lease 15 s, renewal 5 s); DaemonSets rewritten "
            f"{churn}; creates answered 409 {failover_conflicts}; the "
            f"policy's status writes {failover_states}; "
            f"{new_reconciles:.0f} reconciles to settle; a mutation after "
            f"it {mutations['after_failover']}")
        if new_holder != standby_id or churn:
            raise RuntimeError(f"failover: the Lease went to {new_holder} "
                               f"(standby {standby_id}); churn {churn}")

        # N5. uninstall
        out, uninstall_s = cli("uninstall", "--purge-crds", script=INSTALL_SH)
        left = {"crds": [c["metadata"]["name"] for c in ops.list(
                    "apiextensions.k8s.io/v1", "CustomResourceDefinition")],
                "daemonsets": sorted(daemonset_rvs()),
                "policy": policy() is not None}
        log(f"  N5: install.sh uninstall --purge-crds rc {out.returncode} "
            f"in {uninstall_s:.3f} s; left {left}")
        if out.returncode != 0 or any(left.values()):
            raise RuntimeError(f"uninstall left {left}: {out.stderr}")
        figures.update({
            "install_to_ready_s": ready_s, "install_sh_s": install_s,
            "chain_wall_s": kubelet_out["chain_s"],
            "ready_after_kubelet_ms": after_mark_ms,
            "leader_policy_reconciles": leader_reconciles,
            "start_conflicts": start_conflicts,
            "start_reapplied": start_reapplied,
            "triad_launches": hbm["triad_launches"],
            "containers": kubelet_out["containers"], "plugin_pod": pod_runs,
            "status_s": status_s, "diff_s": diff_s,
            "steady": {"writes": writes, "leader_verbs": verbs,
                       "reads_by_source": reads,
                       "standby_reconciles": standby_reconciles},
            "mutations": mutations,
            "failover": {"takeover_s": takeover_s, "churn": churn,
                         "conflicts": failover_conflicts,
                         "status_writes": failover_states,
                         "reconciles": new_reconciles},
            "uninstall_s": uninstall_s})
    except BaseException:
        for p in procs:  # what the operators said, for the failure
            with open(p.logfile) as f:
                log(f"  {' '.join(p.cmd)} (rc {p.poll()}), its log's "
                    f"end:\n{f.read()[-6000:]}")
        raise
    finally:
        kubelet_stop.set()
        player.stop.set()
        for p in procs:
            if p.poll() is None:
                p.terminate()
                try:
                    p.wait(timeout=15)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
        if th.is_alive():
            th.join(timeout=30)
        for c in (ops, kubelet_client):
            c.close()
        srv.stop()
        shutil.rmtree(work, ignore_errors=True)
    figures["operator_exits"] = [p.returncode for p in procs]
    figures["phase_s"] = time.perf_counter() - t_phase
    return figures


def sweep_phase(card: str) -> dict:
    """N6: ``python -m tpu_operator_torch.scripts.hbm_sweep`` as a process
    on the card; every point correct, the triad launched."""
    base = container_base_env(None)
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m",
                          "tpu_operator_torch.scripts.hbm_sweep"],
                         env=base, capture_output=True, text=True,
                         timeout=DEPLOYED_TIMEOUT_S)
    sweep_s = time.perf_counter() - t0
    sweep = json.loads(out.stdout.strip().splitlines()[-1])
    sweep_launches = next(
        (json.loads(ln[len("# kernels: "):])["triad"]
         for ln in out.stderr.splitlines() if ln.startswith("# kernels: ")),
        0)
    log(f"  N6: python -m tpu_operator_torch.scripts.hbm_sweep rc "
        f"{out.returncode} in {sweep_s:.3f} s, triad launched "
        f"{sweep_launches} times: {json.dumps(sweep)} ({card})")
    if out.returncode != 0 or "error" in sweep or not sweep["results"] or \
            not all(r["correct"] for r in sweep["results"].values()) or \
            sweep_launches == 0:
        raise RuntimeError(f"the sweep: {sweep} {out.stderr[-1500:]}")
    return {"sweep": sweep, "sweep_s": sweep_s,
            "triad_launches": sweep_launches}


def shell_e2e_phase(card: str, extra_env: dict | None = None) -> dict:
    """N7: ``tpu_operator_torch/scripts/end-to-end.sh`` as a process, its
    workload proof on the card (no GPU_VALIDATOR_ALLOW_CPU); the nine
    stages in order. ``extra_env`` serves a rehearsal on the CPU only."""
    base = container_base_env(extra_env)
    t0 = time.perf_counter()
    out = subprocess.run(["bash", SHELL_E2E], env={**base,
                         "PYTHON": sys.executable}, capture_output=True,
                         text=True, timeout=DEPLOYED_TIMEOUT_S)
    e2e_s = time.perf_counter() - t0
    stages = [ln.split()[1] for ln in out.stdout.splitlines()
              if ln.startswith("STAGE_OK")]
    proof = next((ln for ln in out.stderr.splitlines()
                  if "cuda validation OK" in ln), "")
    log(f"  N7: end-to-end.sh rc {out.returncode} in {e2e_s:.3f} s, stages "
        f"{stages}; the workload proof: {proof.strip()} ({card})")
    if out.returncode != 0 or stages != SHELL_STAGES or \
            out.stdout.strip().splitlines()[-1] != "END_TO_END_OK":
        raise RuntimeError(f"end-to-end.sh: {out.stdout[-2000:]} "
                           f"{out.stderr[-2000:]}")
    return {"shell_e2e_s": e2e_s, "stages": stages,
            "workload_proof": proof.strip()}


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
    flash_bwd_spills = check_flash_build(builds["flash_attention_bwd"].log,
                                         "flash_bwd")

    # 3. kernels against their plain versions
    log("# phase 3: kernels vs plain versions")
    gen = torch.Generator(device=dev).manual_seed(0)
    ragged = (1001, 333)  # 333333 elements: not a multiple of 4
    triad_err = max(check_triad(torch, hbm_probe, dev, gen, TRIAD_SHAPE, 0),
                    check_triad(torch, hbm_probe, dev, gen, ragged, 0),
                    check_triad(torch, hbm_probe, dev, gen, TRIAD_SHAPE, 1))
    B, S, H, D = FLASH_RUN_SHAPE
    LB, LS, LH, LD = FLASH_LONG_SHAPE
    NB, NS, NH, ND = FLASH_LAYERS_SHAPE
    NG, NW = FLASH_LAYERS_GROUP, FLASH_LAYERS_WINDOW
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
        check_flash_merge(torch, fa, ra, dev, gen, FLASH_RUN_SHAPE),
        # grouped KV heads and windows: B2's band instantiations
        check_flash(torch, fa, ra, dev, gen, "Trinity window layer",
                    NB * NH, NS, NS, ND, group=NG, window=NW),
        check_flash(torch, fa, ra, dev, gen, "Trinity full layer", NB * NH,
                    NS, NS, ND, group=NG),
        check_flash(torch, fa, ra, dev, gen, "window, ragged", 8, 1000,
                    1000, 128, group=4, window=300),
        check_flash(torch, fa, ra, dev, gen, "window of one key", 8, 1000,
                    1000, 64, group=2, window=1),
        check_flash(torch, fa, ra, dev, gen, "window, ring hop", 8, 1000,
                    600, 128, q_offset=2000, k_offset=1700, group=2,
                    window=500),
        check_flash(torch, fa, ra, dev, gen, "window past S", 8, 4160, 4160,
                    64, group=8, window=20000),
        # keys wider than values and sinks: MiMo-V2-Flash's period, and
        # the sink on the (128, 128) and (64, 64) band instantiations
        check_flash(torch, fa, ra, dev, gen, "MiMo full layer", MIMO_HEADS,
                    MIMO_CHECK_SEQ, MIMO_CHECK_SEQ, MIMO_D,
                    group=MIMO_HEADS // MIMO_FULL_KV, dv=MIMO_DV),
        check_flash(torch, fa, ra, dev, gen, "MiMo window layer",
                    MIMO_HEADS, MIMO_CHECK_SEQ, MIMO_CHECK_SEQ, MIMO_D,
                    group=MIMO_HEADS // MIMO_SWA_KV, window=MIMO_WINDOW,
                    dv=MIMO_DV, sinks=True),
        check_flash(torch, fa, ra, dev, gen, "split, window, ragged", 8,
                    1000, 1000, 192, group=2, window=300, dv=128,
                    sinks=True),
        check_flash(torch, fa, ra, dev, gen, "split, ring hop", 8, 1000, 600,
                    192, q_offset=2000, k_offset=1700, group=2, dv=128),
        check_flash(torch, fa, ra, dev, gen, "split, sinks, dead rows", 8,
                    1000, 1000, 192, q_offset=1700, k_offset=1760,
                    dead_rows=60, group=2, dv=128, sinks=True),
        check_flash(torch, fa, ra, dev, gen, "sinks at 128", 32, 2048,
                    2048, 128, group=8, window=2048, sinks=True),
        check_flash(torch, fa, ra, dev, gen, "sinks at 64", 8, 1000, 1000,
                    64, sinks=True),
        # the persistent kernel of the calls with a window, over more
        # tiles than the card has multiprocessors: ragged, at Trinity's
        # widths at the cell's shortest prompt, and ring hops whose first
        # or last tiles see no chunk (a block's tiles with no chunk before
        # and after those with some)
        check_flash(torch, fa, ra, dev, gen, "MiMo window layer, ragged",
                    MIMO_HEADS, MIMO_RAGGED_SEQ, MIMO_RAGGED_SEQ, MIMO_D,
                    group=MIMO_HEADS // MIMO_SWA_KV, window=MIMO_WINDOW,
                    dv=MIMO_DV, sinks=True),
        check_flash(torch, fa, ra, dev, gen, "Trinity window layer", NB * NH,
                    MIMO_CHECK_SEQ, MIMO_CHECK_SEQ, ND, group=NG, window=NW),
        check_flash(torch, fa, ra, dev, gen, "window at 64, ragged", 32,
                    4160, 4160, 64, group=4, window=300),
        check_flash(torch, fa, ra, dev, gen, "window hop, first tiles dead",
                    MIMO_HEADS, 1000, 1000, MIMO_D, q_offset=1700,
                    k_offset=1990, dead_rows=290,
                    group=MIMO_HEADS // MIMO_SWA_KV, window=MIMO_WINDOW,
                    dv=MIMO_DV, sinks=True),
        check_flash(torch, fa, ra, dev, gen, "window hop, last tiles dead",
                    MIMO_HEADS, 1000, 1000, MIMO_D, q_offset=1000,
                    dead_rows=slice(127, 1000),
                    group=MIMO_HEADS // MIMO_SWA_KV, window=MIMO_WINDOW,
                    dv=MIMO_DV, sinks=True)]
    flash_err = max(e["out"] for e in flash_errs)
    flash_row_rel = max(e["out_row_rel"] for e in flash_errs)
    check_flash_future_block(torch, fa, dev, gen, B * H, S, D)
    TB, TS, TH, TD = FLASH_TRAIN_SHAPE
    bwd_errs = [
        check_flash_bwd(torch, fa, dev, gen, "training cell", TB * TH, TS,
                        TS, TD),
        check_flash_bwd(torch, fa, dev, gen, "ragged", 8, 4160, 4160, 128),
        check_flash_bwd(torch, fa, dev, gen, "ragged", 8, 300, 260, 128),
        check_flash_bwd(torch, fa, dev, gen, "ragged", 8, 300, 260, 64,
                        causal=False),
        check_flash_bwd(torch, fa, dev, gen, "non-causal", 8, 4096, 4096,
                        128, causal=False),
        check_flash_bwd(torch, fa, dev, gen, "run() shape", B * H, S, S, D),
        check_flash_bwd(torch, fa, dev, gen, "dead rows", 8, 1000, 1000,
                        128, dead_rows=60),
        # grouped KV heads and windows: B3's band instantiations
        check_flash_bwd(torch, fa, dev, gen, "Trinity window layer",
                        NB * NH, NS, NS, ND, group=NG, window=NW),
        check_flash_bwd(torch, fa, dev, gen, "Trinity full layer", NB * NH,
                        NS, NS, ND, group=NG),
        check_flash_bwd(torch, fa, dev, gen, "window, ragged", 8, 1000, 1000,
                        128, group=4, window=300),
        check_flash_bwd(torch, fa, dev, gen, "window, ragged", 8, 300, 260,
                        64, group=2, window=77),
        # (a window of one key leaves dS = P(dP - rowsum(dO O)) = 0 but
        # for rounding, which no relative error can judge)
        check_flash_bwd(torch, fa, dev, gen, "window of two keys", 8, 1000,
                        1000, 128, group=8, window=2),
        check_flash_bwd(torch, fa, dev, gen, "window past S", 8, 4160, 4160,
                        128, group=2, window=20000),
        # keys wider than values, B3's split instantiation (band at any
        # group and window): MLA's training shape at YaRN's scale,
        # MiMo-V2-Flash's full and window layers without sinks at the MiMo
        # cell's shortest prompt and at 16384, and ragged ends, a window,
        # no causal mask and dead rows
        check_flash_bwd(torch, fa, dev, gen, "MLA (DeepSeek-V3) layer",
                        MLA_HEADS, MLA_SEQ, MLA_SEQ, MLA_D, dv=MLA_DV,
                        scale=MLA_SCALE),
        *(check_flash_bwd(torch, fa, dev, gen, f"MiMo {kind} layer, no sinks",
                          MIMO_HEADS, seq, seq, MIMO_D, group=MIMO_HEADS // hkv,
                          window=w, dv=MIMO_DV)
          for seq in (MIMO_CHECK_SEQ, MIMO_TIME_SEQ)
          for kind, hkv, w in (("full", MIMO_FULL_KV, None),
                               ("window", MIMO_SWA_KV, MIMO_WINDOW))),
        check_flash_bwd(torch, fa, dev, gen, "split, ragged", 8, 300, 260,
                        MLA_D, dv=MLA_DV, scale=MLA_SCALE),
        check_flash_bwd(torch, fa, dev, gen, "split, non-causal", 8, 300,
                        260, MLA_D, causal=False, dv=MLA_DV),
        check_flash_bwd(torch, fa, dev, gen, "split, window, ragged", 8,
                        1000, 1000, MLA_D, group=2, window=77, dv=MLA_DV),
        check_flash_bwd(torch, fa, dev, gen, "split, dead rows", 8, 1000,
                        1000, MLA_D, dead_rows=60, dv=MLA_DV,
                        scale=MLA_SCALE)]
    bwd_sinks = check_flash_bwd_refuses_sinks(torch, fa, dev, gen)
    bwd_rel = max(e[f"{n}_rel"] for e in bwd_errs for n in ("dq", "dk", "dv"))
    bwd_row = max(e[f"{n}_row"] for e in bwd_errs for n in ("dq", "dk", "dv"))
    # B3 through its operands' strides: flash_attention's fold views
    bwd_view_errs = [
        check_flash_bwd_views(torch, fa, dev, gen, "training cell",
                              FLASH_TRAIN_SHAPE),
        check_flash_bwd_views(torch, fa, dev, gen, "Trinity window layer",
                              FLASH_LAYERS_SHAPE, NH // NG, NW),
        check_flash_bwd_views(torch, fa, dev, gen, "Trinity full layer",
                              FLASH_LAYERS_SHAPE, NH // NG),
        check_flash_bwd_views(torch, fa, dev, gen, "ragged", (1, 1000, 8, 64),
                              2),
        check_flash_bwd_views(torch, fa, dev, gen, "misaligned q",
                              (1, 1000, 8, 128), misalign=True)]

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
    fa.flash_bwd.launches = 0
    t0 = time.perf_counter()
    cp_results, ring_row_rel, rank_launches = long_context_path(
        torch, mesh, ringattention, torch.cuda.device_count())
    grad_errs = check_flash_attention_grad(torch, fa, ringattention, dev, gen)
    bwd_launches = fa.flash_bwd.launches
    log(f"  flash backward launches in flash_attention's gradient check: "
        f"{bwd_launches}")
    if bwd_launches != 1:
        raise RuntimeError("flash_attention's backward did not launch the "
                           "backward kernel once")
    flash_launches = rank_launches + fa.flash_attention_blocks.launches
    log(f"  flash launches on the path: {flash_launches} ({rank_launches} "
        f"in the ranks, {fa.flash_attention_blocks.launches} in "
        f"flash_attention) in {time.perf_counter() - t0:.1f}s")
    if rank_launches == 0 or fa.flash_attention_blocks.launches == 0:
        raise RuntimeError("the long-context path did not launch the flash "
                           "kernel")
    # the grouped, windowed entry: one B2 and one B3 launch a call
    layers_grad = check_flash_attention_layers(torch, fa, ringattention, dev,
                                               gen)
    # no layout copy before B2 at every attention cell's widths, out in
    # q's layout
    fwd_no_copies = [
        check_flash_fwd_no_copies(torch, fa, dev, gen, "prefill-64k",
                                  FLASH_PREFILL_SHAPE, FLASH_PREFILL_SHAPE[2]),
        check_flash_fwd_no_copies(torch, fa, dev, gen, "prefill-mixlen",
                                  FLASH_MIXLEN_SHORT_SHAPE,
                                  FLASH_MIXLEN_SHORT_SHAPE[2]),
        check_flash_fwd_no_copies(torch, fa, dev, gen, "train-16k",
                                  FLASH_TRAIN_SHAPE, FLASH_TRAIN_SHAPE[2]),
        check_flash_fwd_no_copies(torch, fa, dev, gen, "Trinity window layer",
                                  FLASH_LAYERS_SHAPE, NH // NG, NW),
        check_flash_fwd_no_copies(torch, fa, dev, gen, "Trinity full layer",
                                  FLASH_LAYERS_SHAPE, NH // NG),
        check_flash_fwd_no_copies(
            torch, fa, dev, gen, "MiMo full layer",
            (1, MIMO_CHECK_SEQ, MIMO_HEADS, MIMO_D), MIMO_FULL_KV,
            dv=MIMO_DV),
        check_flash_fwd_no_copies(
            torch, fa, dev, gen, "MiMo window layer",
            (1, MIMO_CHECK_SEQ, MIMO_HEADS, MIMO_D), MIMO_SWA_KV,
            MIMO_WINDOW, dv=MIMO_DV, sinks=True)]
    # no layout copy around B3 at both training cells' widths
    no_copies = [
        check_flash_attention_no_copies(torch, fa, dev, gen,
                                        FLASH_TRAIN_SHAPE, FLASH_TRAIN_SHAPE[2]),
        check_flash_attention_no_copies(torch, fa, dev, gen,
                                        FLASH_LAYERS_SHAPE, NH // NG, NW),
        check_flash_attention_no_copies(torch, fa, dev, gen,
                                        FLASH_LAYERS_SHAPE, NH // NG),
        check_flash_attention_no_copies(
            torch, fa, dev, gen, (1, MLA_SEQ, MLA_HEADS, MLA_D), MLA_HEADS,
            dv=MLA_DV, scale=MLA_SCALE)]

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
    flash_train_bwd = time_flash_bwd(torch, fa, dev, gen, spec,
                                     FLASH_TRAIN_SHAPE)
    flash_layers = time_flash_layers(torch, fa, dev, gen, spec)
    flash_split = time_flash_split(torch, fa, dev, gen, spec)
    flash_mla_bwd = time_flash_mla_bwd(torch, fa, dev, gen, spec)
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
                            "layers_grad_check": layers_grad,
                            "bwd_fold_views": bwd_view_errs,
                            "fwd_no_copies": fwd_no_copies,
                            "bwd_no_copies": no_copies,
                            "ptxas_spills": flash_spills,
                            "bwd_train_shape": flash_train_bwd,
                            "bwd_ptxas_spills": flash_bwd_spills,
                            "layers": flash_layers,
                            "split": flash_split,
                            "mla_bwd": flash_mla_bwd,
                            "bwd_sinks_refused": bwd_sinks,
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

    # E: the node's allocation plane; no kernel of this repo lies on it
    # (it reads NVML and never opens a context but in its children), and
    # the counts read after it say so
    hbm_probe.triad_.launches = 0
    fa.flash_attention_blocks.launches = 0
    log("# phase E: the node's allocation plane (device plugins, fencing, "
        "vGPUs, health engine, feature discovery, node agents)")
    torch.cuda.empty_cache()
    plane = allocation_plane_phase(torch, card)
    plane["launches"] = {"triad": hbm_probe.triad_.launches,
                         "flash_attention": fa.flash_attention_blocks.launches}
    log(f"  kernel launches in phase E: {plane['launches']}")
    if any(plane["launches"].values()):
        raise RuntimeError("the allocation plane launched a kernel")
    log(json.dumps({"allocation_plane": plane}))

    # F: the topology manager; no kernel of this repo lies on it (it reads
    # NVML, and its children sum with NCCL), and the counts read after it
    # say so
    hbm_probe.triad_.launches = 0
    fa.flash_attention_blocks.launches = 0
    log("# phase F: the topology manager (NVLink facts, card groups behind "
        "the device plugin, grouped agreement, the topology labels)")
    torch.cuda.empty_cache()
    topo = topology_phase(torch, card)
    topo["launches"] = {"triad": hbm_probe.triad_.launches,
                        "flash_attention": fa.flash_attention_blocks.launches}
    log(f"  kernel launches in phase F: {topo['launches']}")
    if any(topo["launches"].values()):
        raise RuntimeError("the topology manager launched a kernel")
    log(json.dumps({"topology_manager": topo}))

    # G: the operator's reconcile path. Its own modules launch no kernel;
    # the validator pod it renders runs the triad in its hbm-validation
    # child, whose launcher reports that process's count
    hbm_probe.triad_.launches = 0
    fa.flash_attention_blocks.launches = 0
    log("# phase G: the operator's reconcile path (GPUClusterPolicy, the "
        "state manager's DAG, the rendered validator DaemonSet on the card)")
    torch.cuda.empty_cache()
    reconcile = reconcile_phase(torch, card)
    reconcile["launches_in_process"] = {
        "triad": hbm_probe.triad_.launches,
        "flash_attention": fa.flash_attention_blocks.launches}
    log(f"  kernel launches in phase G: triad {reconcile['triad_launches']} "
        f"in the hbm-validation child; in this process "
        f"{reconcile['launches_in_process']}")
    if any(reconcile["launches_in_process"].values()):
        raise RuntimeError("the reconcile launched a kernel in this process")
    log(json.dumps({"reconcile": reconcile}))

    # I: the port's headline bench as a process. This process launches
    # nothing in it; the bench's own process reports its triad count
    hbm_probe.triad_.launches = 0
    fa.flash_attention_blocks.launches = 0
    log("# phase I: the port's headline bench (python -m "
        "tpu_operator_torch.bench), the control-plane rider's fleet at "
        f"{BENCH_FLEET_NODES} nodes")
    torch.cuda.empty_cache()
    headline = bench_phase(card, torch.cuda.device_count())
    headline["launches_in_process"] = {
        "triad": hbm_probe.triad_.launches,
        "flash_attention": fa.flash_attention_blocks.launches}
    if any(headline["launches_in_process"].values()):
        raise RuntimeError("the bench launched a kernel in this process")
    log(json.dumps({"bench": headline}))

    # H: the operator's runtime. The manager's watches drive the policy to
    # ready with no direct reconcile; its own modules launch no kernel, and
    # the validator pod the kubelet thread plays runs the triad in its
    # hbm-validation child, whose launcher reports that process's count.
    # J, the driver rollout, runs under H's restarted manager, its counts
    # set to 0 just before it and read just after
    hbm_probe.triad_.launches = 0
    fa.flash_attention_blocks.launches = 0
    log("# phase H: the operator's runtime (gpu-operator, the Manager's "
        "watches, workqueue, informer cache, tracing, leader election, "
        "snapshots)")
    torch.cuda.empty_cache()
    h0 = operator_process_phase(card)
    launches_h = {}

    def phase_j(**live):
        launches_h.update(triad=hbm_probe.triad_.launches,
                          flash_attention=fa.flash_attention_blocks.launches)
        hbm_probe.triad_.launches = 0
        fa.flash_attention_blocks.launches = 0
        log("# phase J: a driver rollout under the manager (GPUDriver, the "
            "upgrade FSM, eviction, the recreated driver and validator "
            "pods on the card)")
        figures = rollout_phase(torch, card, **live)
        figures["launches_in_process"] = {
            "triad": hbm_probe.triad_.launches,
            "flash_attention": fa.flash_attention_blocks.launches}
        log(f"  kernel launches in phase J: triad "
            f"{figures['triad_launches']} in the recreated hbm-validation "
            f"child; in this process {figures['launches_in_process']}")
        if any(figures["launches_in_process"].values()):
            raise RuntimeError("the rollout launched a kernel in this "
                               "process")
        return figures

    def phase_k(rollout_s: float, **live):
        hbm_probe.triad_.launches = 0
        fa.flash_attention_blocks.launches = 0
        log("# phase K: placement and the elastic handshake under the "
            "manager (a second node, a SliceRequest placed by watch events, "
            "the burn-in trainer under ElasticWorkload on the card, a "
            "driver rollout moving it by checkpoint, rebind and restore)")
        figures = migration_phase(torch, card, rollout_s=rollout_s, **live)
        figures["launches_in_process"] = {
            "triad": hbm_probe.triad_.launches,
            "flash_attention": fa.flash_attention_blocks.launches}
        log(f"  kernel launches in phase K: triad "
            f"{figures['triad_launches']} in the recreated hbm-validation "
            f"child, {figures['triad_launches_node_b']} in the second "
            f"node's; in this process {figures['launches_in_process']}")
        if any(figures["launches_in_process"].values()):
            raise RuntimeError("phase K launched a kernel in this process")
        return figures

    def phase_l(**live):
        hbm_probe.triad_.launches = 0
        fa.flash_attention_blocks.launches = 0
        log("# phase L: fleet telemetry and the install surface under the "
            "manager (the card's digests through the fleet fold, a lost "
            "card condemning the second node and draining K's request, "
            "gpuop-cfg and gpuop-must-gather on the live cluster, the "
            "install bundle against the policy G and H ran)")
        figures = fleet_phase(torch, card, ran_spec=reconcile["policy_spec"],
                              **live)
        figures["launches_in_process"] = {
            "triad": hbm_probe.triad_.launches,
            "flash_attention": fa.flash_attention_blocks.launches}
        log(f"  kernel launches in phase L: {figures['launches_in_process']}")
        if any(figures["launches_in_process"].values()):
            raise RuntimeError("phase L launched a kernel in this process")
        return figures

    def phases_jkl(**live):
        j = phase_j(**live)
        return {"j": j, "k": phase_k(j["rollout_s"], **live),
                "l": phase_l(**live)}

    runtime = runtime_phase(torch, card, rollout=phases_jkl)
    jkl = runtime.pop("rollout")
    rollout, migration, fleet = jkl["j"], jkl["k"], jkl["l"]
    runtime["operator_process"] = h0
    runtime["launches_in_process"] = launches_h
    log(f"  kernel launches in phase H: triad {runtime['triad_launches']} "
        f"in the hbm-validation child; in this process "
        f"{runtime['launches_in_process']}")
    if any(runtime["launches_in_process"].values()):
        raise RuntimeError("the runtime launched a kernel in this process")
    log(json.dumps({"runtime": runtime}))
    log(json.dumps({"rollout": rollout}))
    log(json.dumps({"migration": migration}))
    log(json.dumps({"fleet": fleet}))

    # M: chaos and federation, after H's manager has stopped. Host code:
    # no kernel of this repo lies on it (the trainers are phase K's, the
    # burn-in's einsum attention), and the counts read after it say so
    hbm_probe.triad_.launches = 0
    fa.flash_attention_blocks.launches = 0
    log("# phase M: chaos and federation (M1: the 18 chaos scenarios and "
        "gpuop-chaos; M2: the card's trainer carried across cells by the "
        "global router, a partition and a router restart)")
    chaos = chaos_phase(card)
    federation = federation_phase(torch, card)
    launches_m = {"triad": hbm_probe.triad_.launches,
                  "flash_attention": fa.flash_attention_blocks.launches}
    log(f"  kernel launches in phase M: in this process {launches_m}; no "
        f"validator child runs in M")
    if any(launches_m.values()):
        raise RuntimeError("phase M launched a kernel in this process")
    log(json.dumps({"chaos": chaos, "federation": federation,
                    "launches_in_process": launches_m}))

    # N: the operator as it is deployed, over HTTP with leader election,
    # then the sweep and the shell e2e as processes. This process launches
    # nothing in it; the validator pod's hbm-validation child and the
    # sweep's process report their own triad counts
    hbm_probe.triad_.launches = 0
    fa.flash_attention_blocks.launches = 0
    log("# phase N: the operator as it is deployed (the mock apiserver, "
        "install.sh, two gpu-operator processes under leader election, "
        "mutations, a SIGKILL failover, uninstall; the HBM sweep; the "
        "shell e2e)")
    torch.cuda.empty_cache()
    deployed = deployed_phase(torch, card)
    sweep = sweep_phase(card)
    shell_e2e = shell_e2e_phase(card)
    launches_n = {"triad": hbm_probe.triad_.launches,
                  "flash_attention": fa.flash_attention_blocks.launches}
    log(f"  kernel launches in phase N: triad {deployed['triad_launches']} "
        f"in the hbm-validation child, {sweep['triad_launches']} in the "
        f"sweep; in this process {launches_n}")
    if any(launches_n.values()):
        raise RuntimeError("phase N launched a kernel in this process")
    log(json.dumps({"deployed": deployed, "sweep": sweep,
                    "shell_e2e": shell_e2e,
                    "launches_in_process": launches_n}))

    # 14. the kernel table
    kernels = [{
        "name": "triad",
        "route": "cuda",
        "source": "tpu_operator_torch/csrc/triad.cu",
        "replaces": "tpu_operator/workloads/pallas_probe.py:30",
        "launches": triad_launches,
        "launches_phase_g_child": reconcile["triad_launches"],
        "launches_phase_h_child": runtime["triad_launches"],
        "launches_phase_i_bench": headline["triad_launches"],
        "launches_phase_j_child": rollout["triad_launches"],
        "launches_phase_k_child": migration["triad_launches"],
        "launches_phase_k_node_b_child": migration["triad_launches_node_b"],
        "launches_phase_m_in_process": launches_m["triad"],
        "launches_phase_n_child": deployed["triad_launches"],
        "launches_phase_n_sweep": sweep["triad_launches"],
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
    }, {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "tpu_operator_torch/csrc/flash_attention_bwd.cu",
        "replaces": None,
        "launches": bwd_launches,
        "max_rel_err": bwd_rel,
        "rtol": FLASH_BWD_RTOL,
        "max_row_rel_err": bwd_row,
        "row_rtol": FLASH_BWD_ROW_RTOL,
        "shape": flash_train_bwd["shape"],
        "ms": flash_train_bwd["ms"],
        "plain_ms": flash_train_bwd["plain_ms"],
        "bound_ms": flash_train_bwd["bound_ms"],
        "bound_by": flash_train_bwd["bound_by"],
        "library_ms": flash_train_bwd["library_ms"],
        "library_ratio": (flash_train_bwd["ms"]
                          / flash_train_bwd["library_ms"]),
        "fraction_of_bound": flash_train_bwd["fraction_of_bound"],
    }]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
