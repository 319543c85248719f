"""Interconnect proof: collective bandwidth over the ranks of one host.

Counterpart of ``tpu_operator/workloads/collectives.py``, on NCCL (NVLink
between the cards of a host) or gloo on the CPU. Ring accounting as
there: for N ranks each reducing S bytes, every rank moves 2*(N-1)/N * S
bytes over its links, so

    algo_bw  = S / t                      (allreduce "algorithmic" GB/s)
    bus_bw   = 2*(N-1)/N * S / t          (per-card link traffic GB/s)

``bus_bw`` is held against the card's one-way NVLink rate.

Two layers: ``measure``/``measure_suite``/``oracle_outputs`` run on every
rank of an initialised process group; ``run``/``run_collective``/
``run_suite`` spawn one rank per card (``parallel.mesh.spawn``) and
return rank 0's figures.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..parallel import mesh
from .backend import resolve_device, span, synchronize
from .hardware import chip_spec_for, device_kind

# per-card link bytes moved per byte of PER-RANK INPUT, ring algorithms
# (NCCL-tests busbw accounting, restated for this input convention — NCCL
# normalizes all_gather by the total gathered size; here every op is
# normalized by what one rank feeds in):
#   all_reduce       2*(n-1)/n   (reduce-scatter + all-gather phases)
#   all_gather        n-1        (each card RECEIVES the other n-1 full
#                                 shards, each the size of its own input)
#   reduce_scatter    (n-1)/n    (each card receives n-1 blocks of 1/n)
#   all_to_all        (n-1)/n    (keeps its own block local)
#   ppermute          1          (whole buffer crosses one hop)
_BUS_FACTOR = {
    "all_reduce": lambda n: 2.0 * (n - 1) / n,
    "all_gather": lambda n: float(n - 1),
    "reduce_scatter": lambda n: (n - 1) / n,
    "all_to_all": lambda n: (n - 1) / n,
    "ppermute": lambda n: 1.0,
}


@dataclass
class CollectiveResult:
    devices: int
    bytes_per_device: int
    seconds: float
    algo_bw_gbps: float
    bus_bw_gbps: float
    peak_ici_gbps: Optional[float]    # the card's one-way NVLink GB/s
    fraction_of_peak: Optional[float]
    device_kind: str
    correct: bool
    op: str = "all_reduce"


def _step(op: str, c: torch.Tensor, n: int, rank: int) -> torch.Tensor:
    """One shape-stable execution of a collective on this rank's 1-D
    shard ``c``, shared by the timed chain and the oracle so the two
    cannot drift apart. ``all_reduce`` updates ``c`` in place and returns
    it (JAX's ``psum(c) * (1/n)`` with no copy: the timed chain's all-ones
    input averages to ones again); every other op leaves ``c`` unchanged
    and returns a new tensor. The reduce_scatter output is 1/n of its
    input and is re-expanded by an all_gather, so that chain times the
    RS+AG pair and its per-op figure is conservative.

    Under ``torch.profiler`` the step records the span
    ``tpu_operator_torch.collectives.step``, holding ``.reduce`` around
    each ``dist`` call and ``.scale`` around each scale by 1/n."""
    with span("collectives.step"):
        k = c.numel()
        if op == "all_reduce":
            with span("collectives.reduce"):
                dist.all_reduce(c)
            with span("collectives.scale"):
                return c.mul_(1.0 / n)
        if op == "all_gather":
            g = torch.empty(n * k, dtype=c.dtype, device=c.device)
            with span("collectives.reduce"):
                dist.all_gather_into_tensor(g, c)
            # return a REMOTE block (the next rank's): the local block
            # never crossed the wire, so checking it would prove nothing
            i = (rank + 1) % n
            return g[i * k:(i + 1) * k]
        if op == "reduce_scatter":
            s = torch.empty(k // n, dtype=c.dtype, device=c.device)
            with span("collectives.reduce"):
                dist.reduce_scatter_tensor(s, c)
            with span("collectives.scale"):
                s.mul_(1.0 / n)
            g = torch.empty(k, dtype=c.dtype, device=c.device)
            with span("collectives.reduce"):
                dist.all_gather_into_tensor(g, s)
            return g
        if op == "all_to_all":
            y = torch.empty_like(c)
            with span("collectives.reduce"):
                dist.all_to_all_single(y, c)
            return y
        if op == "ppermute":
            # shard i lands on rank i+1; on one rank the permutation is
            # the identity and there is no peer to send to
            if n == 1:
                return c.clone()
            y = torch.empty_like(c)
            with span("collectives.reduce"):
                reqs = dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, c, (rank + 1) % n),
                    dist.P2POp(dist.irecv, y, (rank - 1) % n),
                ])
                for r in reqs:
                    r.wait()
            return y
        raise ValueError(f"unknown collective {op!r}")


def _chain(op: str, x: torch.Tensor, n: int, rank: int,
           iters: int) -> torch.Tensor:
    for _ in range(iters):
        x = _step(op, x, n, rank)
    return x


def oracle_input(n: int) -> np.ndarray:
    """The routing-revealing input: row r is rank r's shard (the timed
    loop's constant ones would mask routing errors)."""
    k = 8 * n
    return np.arange(n * k, dtype=np.float32).reshape(n, k)


def oracle_want(op: str, n: int) -> np.ndarray:
    """What every rank must hold after one step on ``oracle_input(n)``."""
    xs = oracle_input(n)
    k = xs.shape[1]
    if op == "all_reduce":
        return np.tile(xs.sum(axis=0) / n, (n, 1))
    if op == "all_gather":
        # rank i returns rank (i+1)%n's shard
        return np.roll(xs, -1, axis=0)
    if op == "reduce_scatter":
        # RS averages blocks of the concatenated shards; AG re-gathers:
        # every rank ends with the blockwise means, identical everywhere
        return np.tile(xs.reshape(n, n, k // n).sum(axis=0).reshape(k) / n,
                       (n, 1))
    if op == "all_to_all":
        return xs.reshape(n, n, k // n).swapaxes(0, 1).reshape(n, k)
    if op == "ppermute":
        return np.roll(xs, 1, axis=0)
    raise ValueError(f"unknown collective {op!r}")


def oracle_outputs(op: str, device) -> np.ndarray:
    """This rank's output of one step on its row of ``oracle_input``."""
    n, rank = dist.get_world_size(), dist.get_rank()
    shard = torch.from_numpy(oracle_input(n)[rank].copy()).to(device)
    out = _step(op, shard, n, rank)
    return out.cpu().numpy()


def _oracle_ok(op: str, device) -> bool:
    """Every rank's oracle step agrees with numpy (agreed across ranks)."""
    n, rank = dist.get_world_size(), dist.get_rank()
    ok = bool(np.allclose(oracle_outputs(op, device), oracle_want(op, n)[rank],
                          rtol=1e-4))
    flag = torch.tensor([1 if ok else 0], dtype=torch.int32, device=device)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return bool(flag.item())


def measure(op: str, device, size_mb: float = 64.0, iters: int = 10,
            repeats: int = 5) -> CollectiveResult:
    """Time one collective on this rank of the current process group;
    ``size_mb`` is the per-rank buffer size."""
    n, rank = dist.get_world_size(), dist.get_rank()
    # per-rank k elements, divisible by n*n so all_to_all/RS tile evenly
    k = max(1, int(size_mb * 1e6 / 4) // (n * n)) * n * n
    x = torch.ones(k, dtype=torch.float32, device=device)
    _chain(op, x, n, rank, iters)  # warm-up (communicator setup)
    synchronize(device)

    calls = 4
    best = float("inf")
    for _ in range(repeats):
        dist.barrier()
        t0 = time.perf_counter()
        o = x
        for _ in range(calls):
            o = _chain(op, o, n, rank, iters)
        synchronize(device)
        best = min(best, time.perf_counter() - t0)

    per_iter = best / (iters * calls)
    nbytes = k * 4
    algo = nbytes / per_iter / 1e9
    bus = _BUS_FACTOR[op](n) * nbytes / per_iter / 1e9
    kind = device_kind(device)
    spec = chip_spec_for(kind)
    return CollectiveResult(
        op=op, devices=n, bytes_per_device=nbytes, seconds=best,
        algo_bw_gbps=algo, bus_bw_gbps=bus,
        peak_ici_gbps=spec.nvlink_bw_gbps if spec else None,
        fraction_of_peak=(bus / spec.nvlink_bw_gbps) if spec else None,
        device_kind=kind, correct=_oracle_ok(op, device))


def measure_suite(device, size_mb: float = 64.0, iters: int = 10,
                  repeats: int = 3, ops=None) -> Dict[str, CollectiveResult]:
    return {op: measure(op, device, size_mb=size_mb, iters=iters,
                        repeats=repeats)
            for op in (ops or list(_BUS_FACTOR))}


def _suite_rank(rank, world_size, device, ops, size_mb, iters, repeats):
    return measure_suite(device, size_mb=size_mb, iters=iters,
                         repeats=repeats, ops=ops)


def run_suite(size_mb: float = 64.0, iters: int = 10, repeats: int = 3,
              world_size: Optional[int] = None, device=None, ops=None,
              timeout_s: float = mesh.DEFAULT_TIMEOUT_S
              ) -> Dict[str, CollectiveResult]:
    """One CollectiveResult per primitive, measured over ``world_size``
    spawned ranks (default: every visible card; one rank per card).
    ``device`` picks the kind: ``None``/``"cuda"`` runs NCCL on the
    cards, ``"cpu"`` runs gloo (``world_size`` then defaults to 1)."""
    dev_type = resolve_device(device).type
    if world_size is None:
        world_size = torch.cuda.device_count() if dev_type == "cuda" else 1
    ranks = mesh.spawn(_suite_rank, world_size, dev_type,
                       args=(ops, size_mb, iters, repeats),
                       timeout_s=timeout_s)
    return ranks[0]


def run_collective(op: str, size_mb: float = 64.0, iters: int = 10,
                   repeats: int = 5, world_size: Optional[int] = None,
                   device=None) -> CollectiveResult:
    return run_suite(size_mb=size_mb, iters=iters, repeats=repeats,
                     world_size=world_size, device=device, ops=[op])[op]


def run(size_mb: float = 256.0, iters: int = 10, repeats: int = 5,
        world_size: Optional[int] = None, device=None) -> CollectiveResult:
    """The gating all-reduce measurement."""
    return run_collective("all_reduce", size_mb=size_mb, iters=iters,
                          repeats=repeats, world_size=world_size,
                          device=device)


def main() -> int:
    import json

    res = run()
    print(json.dumps(res.__dict__))
    return 0 if res.correct else 1


if __name__ == "__main__":
    raise SystemExit(main())
