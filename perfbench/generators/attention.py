"""Traffic kind ``attention``: one caller in a closed loop through the
port's ``flash_attention`` ([B, S, H, D], causal), each call synchronised.

``mode: prefill`` runs the forward under ``no_grad``; ``mode: train`` runs
forward and backward with a seeded upstream gradient, the gradients of
q, k and v cleared before each step. The configuration gives the heads,
the head size and the type; the traffic gives the batch and the length.

Inputs come from the seed, on the device. At a point in the window drawn
from the seed (``refresh``, a share of ``--seconds``), q is drawn anew in
place, so the calls before and after it answer different questions. The
answer of the last call before that point and of the last call of the
window are kept and, once the window has closed, held to the plain
float32 reference (``reference/attention.py``) computed from the same
inputs.

Parameters: ``mode``, ``batch``, ``seq``, ``causal``, ``refresh`` ([lo,
hi] share of the window), ``limits`` (each compared number's limit).
"""

from __future__ import annotations

import math
import statistics
import time

import torch

from .. import compare, roofline
from ..harness import Check, derive
from ..reference import attention as ref


# the numbers each answer is judged by (``compare.py``): dq's first query
# positions are a difference of near-equal terms, dP - rowsum(dO * O),
# whose rounding (O is stored in bfloat16) is large against the median
# row, so its worst row is measured against the rows' root mean square
STATS = {"out": ("rel", "row_max"), "dq": ("rel", "row_rms"),
         "dk": ("rel", "row_max"), "dv": ("rel", "row_max")}


class Generator:
    def __init__(self, rank):
        self.r = rank
        cfg, tr = rank.config, rank.traffic
        self.H = int(cfg["num_attention_heads"])
        if int(cfg["num_key_value_heads"]) != self.H:
            raise ValueError("the attention traffic takes multi-head "
                             "attention (as many KV heads as heads)")
        self.D = int(cfg["head_dim"])
        self.dtype = getattr(torch, cfg["dtype"])
        self.B, self.S = int(tr["batch"]), int(tr["seq"])
        self.causal = bool(tr.get("causal", True))
        self.train = tr["mode"] == "train"
        if tr["mode"] not in ("prefill", "train"):
            raise ValueError(f"unknown attention mode {tr['mode']!r}")
        lo, hi = tr["refresh"]
        u = derive(rank.seed, "refresh") / 2**63
        self.refresh_s = (lo + (hi - lo) * u) * rank.seconds
        self.limits = tr["limits"]
        self.lat = []
        self.refreshed = False
        self.before = self.last = None

    # inputs ---------------------------------------------------------------
    def _draw(self, name, version=0):
        t = torch.empty((self.B, self.S, self.H, self.D), dtype=self.dtype,
                        device=self.r.device)
        return t.normal_(generator=self.r.gen(name, version))

    def inputs(self, q_version=0):
        """(q, k, v, dout) as the window sees them; dout None in prefill."""
        return (self._draw("q", q_version), self._draw("k"), self._draw("v"),
                self._draw("dout") if self.train else None)

    # the program ----------------------------------------------------------
    def _call(self):
        from tpu_operator_torch.workloads import flashattention as fa

        if not self.train:
            with torch.no_grad(), self.r.span("fwd"):
                return (fa.flash_attention(self.q, self.k, self.v,
                                           causal=self.causal),)
        for t in (self.q, self.k, self.v):
            t.grad = None
        with self.r.span("fwd"):
            out = fa.flash_attention(self.q, self.k, self.v,
                                     causal=self.causal)
        with self.r.span("bwd"):
            out.backward(self.dout)
        return out.detach(), self.q.grad, self.k.grad, self.v.grad

    def setup(self):
        self.q, self.k, self.v, self.dout = self.inputs()
        if self.train:
            for t in (self.q, self.k, self.v):
                t.requires_grad_(True)
        # builds or loads B2; the second call runs with the first's answer
        # held, as the window does once at its refresh point, so the
        # allocator already holds the memory for both
        first = self._call()
        self.r.sync()
        second = self._call()
        self.r.sync()
        del first, second

    def batch(self, elapsed: float) -> int:
        if not self.refreshed and elapsed >= self.refresh_s:
            self.before, self.last = self.last, None
            with torch.no_grad(), self.r.span("refresh"):
                self.q.normal_(generator=self.r.gen("q", 1))
            self.refreshed = True
        self.last = None
        t0 = time.perf_counter()
        with self.r.span("call"):
            ans = self._call()
            self.r.sync()
        self.lat.append(time.perf_counter() - t0)
        self.last = ans
        return 1

    # figures --------------------------------------------------------------
    def end_to_end(self, window_s: float, calls: int) -> dict:
        lat = sorted(self.lat)
        p95 = lat[max(0, math.ceil(0.95 * len(lat)) - 1)]
        self.p95_note = (f"attn latency: {len(lat)} calls, median "
                         f"{statistics.median(lat) * 1e3!r} ms, p95 "
                         f"{p95 * 1e3!r} ms")
        return {"attn_tok_s": self.B * self.S * calls / window_s,
                "attn_p95_ms": p95 * 1e3}

    def facts(self) -> dict:
        bh = self.B * self.H
        flops = roofline.attention_fwd_flops(bh, self.S, self.D, self.causal)
        if self.train:
            flops += roofline.attention_bwd_flops(bh, self.S, self.D,
                                                  self.causal)
        return {"bh": bh, "seq": self.S, "head_dim": self.D,
                "model_flops_per_call": flops}

    def release(self):
        if self.train:
            for t in (self.q, self.k, self.v):
                t.grad = None
        self.q = self.k = self.v = self.dout = None

    def notes(self) -> list:
        return [getattr(self, "p95_note", ""),
                f"attn answers judged: the last call before the refresh at "
                f"{self.refresh_s!r} s and the window's last call"]

    def _reference(self, q, k, v, dout):
        if self.train:
            return ref.forward_backward(q, k, v, dout, self.causal)
        return (ref.forward(q, k, v, self.causal),)

    def check(self) -> list:
        return self._judge(((0, self.before), (1, self.last)))

    def control(self) -> list:
        """The reference computed from float8 e4m3 inputs, in the
        program's place, judged as the program's answers are."""
        answers = []
        for version in (0, 1):
            answers.append((version, self._reference(
                *(ref.fp8(t) for t in self.inputs(version)))))
        return self._judge(answers)

    def _judge(self, answers) -> list:
        names = ("out", "dq", "dk", "dv") if self.train else ("out",)
        worst = {}
        for version, ans in answers:
            if ans is None:
                raise RuntimeError("the window ended with no answer to judge")
            q, k, v, dout = self.inputs(version)
            want = self._reference(q, k, v, dout)
            del q, k, v, dout
            for name, got, w in zip(names, ans, want):
                for stat in STATS[name]:
                    fn = getattr(compare, stat)
                    # an answer the program never produced reads inf
                    key = f"{name}_{stat}"
                    val = float("inf") if got is None else fn(got, w)
                    if key not in worst or not val <= worst[key]:
                        worst[key] = val
            del want
        self.before = self.last = None
        return [Check(k, v, float(self.limits[k])) for k, v in worst.items()]

