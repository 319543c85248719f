"""Traffic kind ``allreduce``: the NVLink proof's step through the port's
``collectives._step("all_reduce", c, n, rank)`` (an NCCL all-reduce, then
a scale by 1/n, in place), back to back on every rank, one
synchronisation per batch of ``per_batch`` steps.

The configuration gives the buffer (``nvlink_size_mb`` a rank, sized as
the proof sizes it); the traffic gives ``per_batch``, ``slices`` and
``refresh``. Each rank's buffer starts as its own seeded small integers.
An all-reduce of buffers that already agree leaves them as they are, so
after the first step the buffer alone would prove nothing more. Hence
the buffer is cut into ``slices`` slices, and at steps drawn from the
seed (within ``refresh``, a share of the steps the window is expected
to hold) one slice at a time is drawn anew on every rank, with integers
that again differ by rank, just before that step. Sums of such integers
over four ranks, and their quarters, are exact in float32, so once the
window has closed every rank's buffer has to equal, slice by slice, the
mean over the ranks of what was last drawn into it
(``reference/allreduce.py``), bit for bit.
"""

from __future__ import annotations

import random
import time

import torch

from .. import compare, roofline
from ..harness import Check, derive
from ..reference import allreduce as ref


def elements_for(size_mb: float, n: int) -> int:
    """The proof's sizing: a multiple of n*n float32 elements a rank."""
    return max(1, int(size_mb * 1e6 / 4) // (n * n)) * n * n


class Generator:
    def __init__(self, rank):
        self.r = rank
        cfg, tr = rank.config, rank.traffic
        self.n = rank.world
        self.k = elements_for(float(cfg["nvlink_size_mb"]), self.n)
        self.slices = int(tr["slices"])
        if self.k % self.slices:
            raise ValueError(f"{self.k} elements do not cut into "
                             f"{self.slices} slices")
        self.L = self.k // self.slices
        self.per_batch = int(tr["per_batch"])
        self.refresh = tr["refresh"]
        self.limits = tr["limits"]
        self.plan = {}         # window step -> slice drawn anew before it
        self.version = [0] * self.slices
        self.i = 0

    def part(self, rank: int, j: int, version: int) -> torch.Tensor:
        """What ``rank`` draws into slice ``j`` (version 0 at the start)."""
        return torch.randint(-1024, 1025, (self.L,), dtype=torch.float32,
                             device=self.r.device,
                             generator=self.r.gen("x", j, version, rank))

    def _draw(self, j: int, version: int) -> None:
        self.c[j * self.L:(j + 1) * self.L] = self.part(self.r.rank, j,
                                                        version)
        self.version[j] = version

    def _steps(self, count: int) -> None:
        from tpu_operator_torch.workloads import collectives

        for _ in range(count):
            j = self.plan.get(self.i)
            if j is not None:
                with self.r.span("refresh"):
                    self._draw(j, 1)
            with self.r.span("step"):
                collectives._step("all_reduce", self.c, self.n, self.r.rank)
            self.i += 1

    def setup(self):
        import torch.distributed as dist

        self.c = torch.empty(self.k, dtype=torch.float32, device=self.r.device)
        for j in range(self.slices):
            self._draw(j, 0)
        self._steps(self.per_batch)        # the communicator's first use
        self.r.sync()
        t0 = time.perf_counter()
        self._steps(self.per_batch)
        self.r.sync()
        est = [self.r.seconds * self.per_batch / (time.perf_counter() - t0)]
        if self.n > 1:
            dist.broadcast_object_list(est, src=0)
        # the same plan on every rank: drawn from the seed and rank 0's
        # estimate of the window's steps
        lo, hi = self.refresh
        span = range(int(lo * est[0]), max(int(lo * est[0]) + self.slices,
                                          int(hi * est[0])))
        rng = random.Random(derive(self.r.seed, "refresh"))
        order = list(range(self.slices))
        rng.shuffle(order)
        self.plan = dict(zip(sorted(rng.sample(span, self.slices)), order))
        self.i = 0
        # the refresh's temporary, allocated once before the window
        self.part(self.r.rank, 0, 0)

    def batch(self, elapsed: float) -> int:
        self._steps(self.per_batch)
        self.r.sync()
        return self.per_batch

    def end_to_end(self, window_s: float, calls: int) -> dict:
        bus = roofline.allreduce_bus_bytes(self.k * 4, self.n)
        self.gbps = bus * calls / window_s / 1e9
        return {"proof_gbps": self.gbps}

    def facts(self) -> dict:
        return {"world": self.n, "bytes": self.k * 4}

    def release(self):
        pass

    def notes(self) -> list:
        peak = roofline.H100_SXM.nvlink_bytes_s / 1e9
        share = self.gbps / peak
        return [f"nvlink: {self.i} steps of {self.k * 4} bytes a rank over "
                f"{self.n} ranks, slices drawn anew "
                f"{sum(self.version)} of {self.slices}",
                f"nvlink gate: bus {self.gbps!r} GB/s is {share!r} of "
                f"{peak!r} GB/s one-way NVLink; the operator's gate 0.8 "
                f"{'passes' if share >= 0.8 else 'fails'} (not a failed "
                f"operation)"]

    def check(self) -> list:
        err = 0.0
        for j in range(self.slices):
            want = ref.mean([self.part(r, j, self.version[j])
                             for r in range(self.n)])
            got = self.c[j * self.L:(j + 1) * self.L]
            e = compare.max_abs(got, want)
            if not e <= err:
                err = e
        self.c = None
        return [Check("buf_max_abs_err", err,
                      float(self.limits["buf_max_abs_err"]))]

    def control(self) -> list:
        """Every slice's first mean computed in bfloat16, one precision
        below the configuration's float32, judged as the program's
        buffers are."""
        err = 0.0
        for j in range(self.slices):
            parts = [self.part(r, j, 0) for r in range(self.n)]
            e = compare.max_abs(ref.mean(parts, torch.bfloat16),
                                ref.mean(parts))
            if not e <= err:
                err = e
        return [Check("buf_max_abs_err", err,
                      float(self.limits["buf_max_abs_err"]))]
