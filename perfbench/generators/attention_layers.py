"""Traffic kind ``attention_layers``: the attention cores of one period of
a model's layers through the port's ``flash_attention`` (q [B, S, H, D],
k and v [B, S, Hkv, D]), one caller in a closed loop.

The configuration gives ``layer_types`` (``full_attention`` or
``sliding_attention`` each), ``sliding_window``, the heads, the KV heads,
``head_dim`` and ``dtype``; the traffic gives ``mode``, ``batch``, ``seqs``
(a list of lengths) and ``refresh``. A full layer is called as
``generators/attention.py`` calls it, with no ``window=`` keyword; a
window layer with ``window=sliding_window``.

``mode: train``: a step runs, for each length, the forward of every layer
in order, each under ``perfbench.fwd`` and inside it ``perfbench.swa_fwd``
or ``perfbench.full_fwd``, then each layer's backward in reverse order with
its own seeded upstream gradient, under ``perfbench.bwd`` and inside it
``perfbench.swa_bwd`` or ``perfbench.full_bwd``, so every
layer's saved tensors are live at once, as in a training step; the
gradients are cleared before each step and the step is synchronised.
``mode: prefill``: a step is one pass over ``seqs`` (a cycle), each call a
layer's forward under ``no_grad``, synchronised, so a window always holds
whole cycles.

Inputs come from the seed, on the device, each layer's and length's q, k,
v (and dout) drawn by (layer, length, name). At a point in the window
drawn from the seed (``refresh``, a share of ``--seconds``), every q is
drawn anew in place. The answers of the last step before that point and
of the window's last step are kept and, once the window has closed, held
to the plain float32 reference (``reference/attention_layers.py``)
computed from the same inputs, by the statistics of
``generators/attention.py``; and ``window_path_misses`` counts the
window-layer calls the window made less the rise of each kernel's
``window_calls`` counter (B2's, and B3's in training) over the window.

Parameters: ``mode``, ``batch``, ``seqs``, ``refresh`` ([lo, hi] share of
the window), ``limits`` (each compared number's limit).
"""

from __future__ import annotations

import math
import statistics
import time

import torch

from .. import compare, roofline_layers
from ..harness import Check, derive
from ..reference import attention_layers as ref
from ..reference.attention import fp8
from .attention import STATS

KINDS = {"full_attention": "full", "sliding_attention": "swa"}


def _counters() -> tuple:
    """The port's window-path counters of B2 and B3 (0 where the port
    has none)."""
    from tpu_operator_torch.workloads import flashattention as fa

    return (getattr(fa.flash_attention_blocks, "window_calls", 0),
            getattr(fa.flash_bwd, "window_calls", 0))


class Generator:
    def __init__(self, rank):
        self.r = rank
        cfg, tr = rank.config, rank.traffic
        self.H = int(cfg["num_attention_heads"])
        self.Hkv = int(cfg["num_key_value_heads"])
        self.D = int(cfg["head_dim"])
        self.dtype = getattr(torch, cfg["dtype"])
        unknown = set(cfg["layer_types"]) - set(KINDS)
        if unknown or self.H % self.Hkv:
            raise ValueError(f"attention_layers takes full and sliding "
                             f"layers over a whole number of query heads a "
                             f"KV head, got {sorted(unknown)}, "
                             f"{self.H}/{self.Hkv}")
        self.kinds = [KINDS[k] for k in cfg["layer_types"]]
        self.windows = [int(cfg["sliding_window"]) if k == "swa" else None
                        for k in self.kinds]
        self.B = int(tr["batch"])
        self.seqs = [int(s) for s in tr["seqs"]]
        if tr["mode"] not in ("prefill", "train"):
            raise ValueError(f"unknown attention_layers mode {tr['mode']!r}")
        self.train = tr["mode"] == "train"
        lo, hi = tr["refresh"]
        u = derive(rank.seed, "refresh") / 2**63
        self.refresh_s = (lo + (hi - lo) * u) * rank.seconds
        self.limits = tr["limits"]
        self.lat = []
        self.refreshed = False
        self.before = self.last = None
        # window-layer calls a step makes, forward (B2) and backward (B3)
        n_swa = len(self.seqs) * self.kinds.count("swa")
        self.step_window_calls = (n_swa, n_swa if self.train else 0)
        self.window_calls = [0, 0]
        self.counted = (0, 0)

    # inputs ---------------------------------------------------------------
    def _draw(self, layer, si, name, heads, version=0):
        t = torch.empty((self.B, self.seqs[si], heads, self.D),
                        dtype=self.dtype, device=self.r.device)
        return t.normal_(generator=self.r.gen(layer, si, name, version))

    def inputs(self, layer, si, version=0):
        """(q, k, v, dout) of one layer at one length; dout None in
        prefill."""
        return (self._draw(layer, si, "q", self.H, version),
                self._draw(layer, si, "k", self.Hkv),
                self._draw(layer, si, "v", self.Hkv),
                self._draw(layer, si, "dout", self.H) if self.train else None)

    def _keys(self):
        return [(layer, si) for si in range(len(self.seqs))
                for layer in range(len(self.kinds))]

    # the program ----------------------------------------------------------
    def _forward(self, layer, si):
        from tpu_operator_torch.workloads import flashattention as fa

        q, k, v, _ = self.x[layer, si]
        w = self.windows[layer]
        with self.r.span("fwd"), self.r.span(self.kinds[layer] + "_fwd"):
            if w is None:
                return fa.flash_attention(q, k, v, causal=True)
            return fa.flash_attention(q, k, v, causal=True, window=w)

    def _step(self):
        """One step's answers by (layer, length), and the latencies of its
        synchronised calls."""
        answers, lat = {}, []
        n = len(self.kinds)
        for si in range(len(self.seqs)):
            if not self.train:
                with torch.no_grad():
                    for layer in range(n):
                        t0 = time.perf_counter()
                        with self.r.span("call"):
                            answers[layer, si] = (self._forward(layer, si),)
                            self.r.sync()
                        lat.append(time.perf_counter() - t0)
                continue
            t0 = time.perf_counter()
            with self.r.span("call"):
                for layer in range(n):
                    for t in self.x[layer, si][:3]:
                        t.grad = None
                outs = [self._forward(layer, si) for layer in range(n)]
                for layer in reversed(range(n)):
                    with self.r.span("bwd"), \
                            self.r.span(self.kinds[layer] + "_bwd"):
                        outs[layer].backward(self.x[layer, si][3])
                for layer, out in enumerate(outs):
                    q, k, v, _ = self.x[layer, si]
                    answers[layer, si] = (out.detach(), q.grad, k.grad,
                                          v.grad)
                del outs
                self.r.sync()
            lat.append(time.perf_counter() - t0)
        return answers, lat

    def setup(self):
        self.x = {key: self.inputs(*key) for key in self._keys()}
        if self.train:
            for q, k, v, _ in self.x.values():
                for t in (q, k, v):
                    t.requires_grad_(True)
        # builds or loads B2 and B3; the second step runs with the first's
        # answers held, as the window does once at its refresh point
        first, _ = self._step()
        self.r.sync()
        second, _ = self._step()
        self.r.sync()
        del first, second
        self.counted = _counters()

    def batch(self, elapsed: float) -> int:
        if not self.refreshed and elapsed >= self.refresh_s:
            self.before, self.last = self.last, None
            with torch.no_grad(), self.r.span("refresh"):
                for (layer, si), (q, _, _, _) in self.x.items():
                    q.normal_(generator=self.r.gen(layer, si, "q", 1))
            self.refreshed = True
        self.last = None
        self.last, lat = self._step()
        self.lat += lat
        for i in (0, 1):
            self.window_calls[i] += self.step_window_calls[i]
        return 1

    # figures --------------------------------------------------------------
    def end_to_end(self, window_s: float, calls: int) -> dict:
        now = _counters()
        self.counted = tuple(b - a for a, b in zip(self.counted, now))
        lat = sorted(self.lat)
        p95 = lat[max(0, math.ceil(0.95 * len(lat)) - 1)]
        self.p95_note = (f"attn latency: {len(lat)} calls, median "
                         f"{statistics.median(lat) * 1e3!r} ms, p95 "
                         f"{p95 * 1e3!r} ms")
        return {"attn_tok_s": self.B * sum(self.seqs) * calls / window_s,
                "attn_p95_ms": p95 * 1e3}

    def _calls(self) -> list:
        return [{"layer": layer, "kind": self.kinds[layer],
                 "bh": self.B * self.H, "bh_kv": self.B * self.Hkv,
                 "seq": self.seqs[si], "head_dim": self.D,
                 "window": self.windows[layer]} for layer, si in self._keys()]

    def facts(self) -> dict:
        calls = self._calls()
        flops = sum(roofline_layers.layer_fwd_flops(
            c["bh"], c["seq"], c["head_dim"], c["window"]) for c in calls)
        if self.train:
            flops += 2.5 * flops
        # a step is one of the harness's calls (``batch`` returns 1)
        return {"layer_calls": calls, "train": self.train,
                "model_flops_per_call": flops,
                "window_calls": {"flash_attention_blocks": self.counted[0],
                                 "flash_bwd": self.counted[1]}}

    def release(self):
        for q, k, v, _ in self.x.values():
            for t in (q, k, v):
                t.grad = None
        self.x = {}

    def notes(self) -> list:
        return [getattr(self, "p95_note", ""),
                f"attn answers judged: every layer and length of the last "
                f"step before the refresh at {self.refresh_s!r} s and of "
                f"the window's last step; window-layer calls in the window "
                f"{self.window_calls}, window_calls' rise {list(self.counted)}"]

    def _reference(self, layer, q, k, v, dout):
        w = self.windows[layer]
        if self.train:
            return ref.forward_backward(q, k, v, dout, w)
        return (ref.forward(q, k, v, w),)

    def check(self) -> list:
        misses = sum(abs(a - b) for a, b in zip(self.window_calls,
                                                self.counted))
        return self._judge(((0, self.before), (1, self.last))) + [
            Check("window_path_misses", float(misses),
                  float(self.limits["window_path_misses"]))]

    def control(self) -> list:
        """The reference computed from float8 e4m3 inputs, in the
        program's place, judged as the program's answers are."""
        answers = []
        for version in (0, 1):
            ans = {}
            for layer, si in self._keys():
                ans[layer, si] = self._reference(
                    layer, *(fp8(t) for t in self.inputs(layer, si, version)))
            answers.append((version, ans))
        return self._judge(answers)

    def _judge(self, answers) -> list:
        names = ("out", "dq", "dk", "dv") if self.train else ("out",)
        worst = {}
        for version, ans in answers:
            if ans is None:
                raise RuntimeError("the window ended with no answer to judge")
            for layer, si in self._keys():
                q, k, v, dout = self.inputs(layer, si, version)
                want = self._reference(layer, q, k, v, dout)
                del q, k, v, dout
                got = ans.get((layer, si), ())
                for i, (name, w) in enumerate(zip(names, want)):
                    x = got[i] if i < len(got) else None
                    for stat in STATS[name]:
                        fn = getattr(compare, stat)
                        key = f"{name}_{stat}"
                        # an answer the program never produced reads inf
                        val = float("inf") if x is None else fn(x, w)
                        if key not in worst or not val <= worst[key]:
                            worst[key] = val
                del want
        self.before = self.last = None
        return [Check(k, v, float(self.limits[k])) for k, v in worst.items()]
