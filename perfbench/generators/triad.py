"""Traffic kind ``triad``: the HBM proof's STREAM triads through the port's
``hbm_probe.triad_`` (kernel B1), back to back and in place, one
synchronisation per batch of ``per_batch`` triads.

The configuration gives the array (``hbm_size_mb`` of float32 in rows of
``hbm_cols``, sized as the validator sizes it); the traffic gives
``alpha`` and ``per_batch``. The arrays are seeded small integers (a in
[-1024, 1024], b in [-8, 8]) and alpha a power of two, so every triad is
exact in float32 and the chain's end, ``a0 + n * alpha * b``, is known in
closed form (``reference/triad.py``). Once the window has closed, every
element of ``a`` is held to it: a triad skipped, doubled or misplaced
anywhere in the run shows.
"""

from __future__ import annotations


import torch

from .. import compare, roofline
from ..harness import Check
from ..reference import triad as ref


def rows_for(size_mb: float, cols: int) -> int:
    """The validator's sizing: whole blocks of 128 rows, at least one."""
    return max(128, int(size_mb * 1e6 / 4 / cols) // 128 * 128)


class Generator:
    def __init__(self, rank):
        self.r = rank
        cfg, tr = rank.config, rank.traffic
        self.cols = int(cfg["hbm_cols"])
        self.rows = rows_for(float(cfg["hbm_size_mb"]), self.cols)
        self.alpha = float(tr["alpha"])
        self.per_batch = int(tr["per_batch"])
        self.limits = tr["limits"]
        self.done = 0          # triads applied to a, set-up's included

    def inputs(self):
        shape = (self.rows, self.cols)
        kw = dict(dtype=torch.float32, device=self.r.device)
        a = torch.randint(-1024, 1025, shape, generator=self.r.gen("a"), **kw)
        b = torch.randint(-8, 9, shape, generator=self.r.gen("b"), **kw)
        return a, b

    def _triads(self, n):
        from tpu_operator_torch.workloads import hbm_probe

        with self.r.span("triads"):
            for _ in range(n):
                hbm_probe.triad_(self.a, self.b, alpha=self.alpha)
        self.done += n

    def setup(self):
        self.a, self.b = self.inputs()
        self._triads(self.per_batch)      # builds or loads B1
        self.r.sync()

    def batch(self, elapsed: float) -> int:
        self._triads(self.per_batch)
        self.r.sync()
        return self.per_batch

    def end_to_end(self, window_s: float, calls: int) -> dict:
        nbytes = roofline.triad_bytes(self.rows * self.cols)
        return {"proof_gbps": nbytes * calls / window_s / 1e9}

    def facts(self) -> dict:
        return {"elements": self.rows * self.cols, "itemsize": 4}

    def release(self):
        self.b = None

    def notes(self) -> list:
        return [f"triad: {self.done} triads on f32 [{self.rows}, "
                f"{self.cols}], set-up's included"]

    def check(self) -> list:
        a0, b = self.inputs()
        want = ref.after(a0, b, self.alpha, self.done)
        del a0, b
        err = compare.max_abs(self.a, want)
        self.a = None
        return [Check("a_max_abs_err", err, float(self.limits["a_max_abs_err"]))]

    def control(self, n: int = 512) -> list:
        """``n`` triads computed in bfloat16, one precision below the
        configuration's float32, judged as the program's ``a`` is."""
        a0, b = self.inputs()
        got = ref.chain(a0, b, self.alpha, n, torch.bfloat16)
        err = compare.max_abs(got, ref.after(a0, b, self.alpha, n))
        return [Check("a_max_abs_err", err, float(self.limits["a_max_abs_err"]))]
