"""Traffic kind ``attention_mla``: the attention cores of a stage of MLA
layers (DeepSeek-V3's) in training through the port's
``flash_attention``, one caller in a closed loop.

The configuration gives ``num_hidden_layers`` (the layers of the stage),
``num_attention_heads``, ``qk_nope_head_dim``, ``qk_rope_head_dim``,
``v_head_dim``, ``rope_scaling`` and ``dtype`` (DeepSeek-V3's names); the
traffic gives ``mode`` (``train``), ``batch``, ``seqs`` and ``refresh``.

MLA in training expands its latent into per-head keys and values. Each
layer's leaves are drawn as that expansion and RoPE would hand them: q
[B, S, H, 192], k_nope [B, S, H, 128], one rope key k_pe [B, S, 1, 64]
that every head shares, and v [B, S, H, 128]. Inside each layer's
forward, under ``perfbench.fwd`` and ``perfbench.full_fwd``, the key is
assembled under autograd, k = [k_nope ; k_pe expanded over the heads],
and ``flash_attention(q, k, v, causal=True, scale=...)`` runs with the
softmax scale by DeepSeek's rule from ``rope_scaling``
(``softmax_scale``), so the backward sums dk_pe over the heads, as MLA's
training does.

A step is ``attention_layers``' training step: for each length, every
layer's forward in order, then each backward in reverse order with its
own seeded upstream gradient (dout [B, S, H, 128]) under
``perfbench.bwd`` and ``perfbench.full_bwd``; the gradients are cleared
before each step and the step is synchronised. As there, every q is drawn
anew in place at a seeded point in the window, and the answers of the
last step before it and of the window's last step (out, dq, dk_nope,
dk_pe and dv of every layer) are held, once the window has closed, to the
plain float32 reference (``reference/attention_mla.py``).
``scaled_path_misses`` counts the calls the window made with the scale
less the rise of B2's and B3's ``scaled_calls`` counters.

Parameters: ``mode``, ``batch``, ``seqs``, ``refresh`` ([lo, hi] share of
the window), ``limits`` (each compared number's limit).
"""

from __future__ import annotations

import math
import time

import torch

from .. import compare, roofline_split, roofline_split_bwd
from ..harness import Check, derive
from ..reference import attention_mla as ref
from ..reference.attention import fp8
from . import attention_layers
from .attention import STATS

NAMES = ("out", "dq", "dk_nope", "dk_pe", "dv")
# each answer's numbers: the key's two parts as dk is judged
MLA_STATS = {"out": STATS["out"], "dq": STATS["dq"], "dk_nope": STATS["dk"],
             "dk_pe": STATS["dk"], "dv": STATS["dv"]}


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention factor as DeepSeek's modelling code computes it
    (``yarn_get_mscale``): 0.1 * mscale * ln(factor) + 1, and 1 for a
    factor of 1 or less."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def softmax_scale(cfg: dict) -> float:
    """The softmax scale of an MLA layer by DeepSeek's rule: the query
    width (``qk_nope_head_dim + qk_rope_head_dim``) to the power -0.5,
    times YaRN's mscale squared where ``rope_scaling`` gives an
    ``mscale_all_dim`` (DeepSeek-V3: 192**-0.5 * 1.36889**2)."""
    scale = (int(cfg["qk_nope_head_dim"])
             + int(cfg["qk_rope_head_dim"])) ** -0.5
    rs = cfg.get("rope_scaling") or {}
    if rs.get("mscale_all_dim"):
        m = yarn_mscale(float(rs["factor"]), float(rs["mscale_all_dim"]))
        scale *= m * m
    return scale


def _scaled_calls() -> tuple:
    """The port's counts of calls with a scale other than D**-0.5, B2's
    and B3's (0 where the port has none)."""
    from tpu_operator_torch.workloads import flashattention as fa

    return (getattr(fa.flash_attention_blocks, "scaled_calls", 0),
            getattr(fa.flash_bwd, "scaled_calls", 0))


class Generator(attention_layers.Generator):
    def __init__(self, rank):
        self.r = rank
        cfg, tr = rank.config, rank.traffic
        if tr["mode"] != "train":
            raise ValueError(f"attention_mla runs training only, got "
                             f"{tr['mode']!r}")
        self.train = True
        self.H = self.Hkv = int(cfg["num_attention_heads"])
        self.DN = int(cfg["qk_nope_head_dim"])
        self.DR = int(cfg["qk_rope_head_dim"])
        self.D = self.DN + self.DR
        self.DV = int(cfg["v_head_dim"])
        self.scale = softmax_scale(cfg)
        self.dtype = getattr(torch, cfg["dtype"])
        n = int(cfg["num_hidden_layers"])
        self.kinds = ["full"] * n
        self.windows = [None] * n
        self.B = int(tr["batch"])
        self.seqs = [int(s) for s in tr["seqs"]]
        lo, hi = tr["refresh"]
        u = derive(rank.seed, "refresh") / 2**63
        self.refresh_s = (lo + (hi - lo) * u) * rank.seconds
        self.limits = tr["limits"]
        self.lat = []
        self.refreshed = False
        self.before = self.last = None
        self.step_window_calls = (0, 0)
        self.window_calls = [0, 0]
        self.counted = (0, 0)
        # calls with the scale a step makes, forward (B2) and backward (B3)
        self.step_scaled = n * len(self.seqs)
        self.scaled = 0
        self.scaled_counted = (0, 0)

    # inputs ---------------------------------------------------------------
    def _draw(self, layer, si, name, heads, width, version=0):
        t = torch.empty((self.B, self.seqs[si], heads, width),
                        dtype=self.dtype, device=self.r.device)
        return t.normal_(generator=self.r.gen(layer, si, name, version))

    def inputs(self, layer, si, version=0):
        """(q, k_nope, k_pe, v, dout) of one layer at one length."""
        return (self._draw(layer, si, "q", self.H, self.D, version),
                self._draw(layer, si, "k_nope", self.H, self.DN),
                self._draw(layer, si, "k_pe", 1, self.DR),
                self._draw(layer, si, "v", self.H, self.DV),
                self._draw(layer, si, "dout", self.H, self.DV))

    # the program ----------------------------------------------------------
    def _forward(self, layer, si):
        from tpu_operator_torch.workloads import flashattention as fa

        q, k_nope, k_pe, v, _ = self.x[layer, si]
        with self.r.span("fwd"), self.r.span("full_fwd"):
            k = torch.cat([k_nope, k_pe.expand(-1, -1, self.H, -1)], dim=-1)
            return fa.flash_attention(q, k, v, causal=True, scale=self.scale)

    def _step(self):
        """One step's answers by (layer, length), and the latencies of its
        synchronised steps."""
        answers, lat = {}, []
        n = len(self.kinds)
        for si in range(len(self.seqs)):
            t0 = time.perf_counter()
            with self.r.span("call"):
                for layer in range(n):
                    for t in self.x[layer, si][:4]:
                        t.grad = None
                outs = [self._forward(layer, si) for layer in range(n)]
                for layer in reversed(range(n)):
                    with self.r.span("bwd"), self.r.span("full_bwd"):
                        outs[layer].backward(self.x[layer, si][4])
                for layer, out in enumerate(outs):
                    leaves = self.x[layer, si][:4]
                    answers[layer, si] = (out.detach(),
                                          *(t.grad for t in leaves))
                del outs
                self.r.sync()
            lat.append(time.perf_counter() - t0)
        return answers, lat

    def setup(self):
        self.x = {key: self.inputs(*key) for key in self._keys()}
        for leaves in self.x.values():
            for t in leaves[:4]:
                t.requires_grad_(True)
        # builds or loads B2 and B3; the second step runs with the first's
        # answers held, as the window does once at its refresh point
        first, _ = self._step()
        self.r.sync()
        second, _ = self._step()
        self.r.sync()
        del first, second
        self.counted = attention_layers._counters()
        self.scaled_counted = _scaled_calls()

    def batch(self, elapsed: float) -> int:
        if not self.refreshed and elapsed >= self.refresh_s:
            self.before, self.last = self.last, None
            with torch.no_grad(), self.r.span("refresh"):
                for (layer, si), leaves in self.x.items():
                    leaves[0].normal_(generator=self.r.gen(layer, si, "q", 1))
            self.refreshed = True
        self.last = None
        self.last, lat = self._step()
        self.lat += lat
        self.scaled += self.step_scaled
        return 1

    # figures --------------------------------------------------------------
    def end_to_end(self, window_s: float, calls: int) -> dict:
        now = _scaled_calls()
        self.scaled_counted = tuple(
            b - a for a, b in zip(self.scaled_counted, now))
        return super().end_to_end(window_s, calls)

    def _calls(self) -> list:
        return [{"layer": layer, "kind": "full", "bh": self.B * self.H,
                 "bh_kv": self.B * self.Hkv, "seq": self.seqs[si],
                 "d_qk": self.D, "d_v": self.DV, "window": None,
                 "sinks": False} for layer, si in self._keys()]

    def facts(self) -> dict:
        calls = self._calls()
        flops = sum(roofline_split.split_fwd_flops(
            c["bh"], c["seq"], c["d_qk"], c["d_v"]) for c in calls)
        flops += sum(roofline_split_bwd.split_bwd_flops(
            c["bh"], c["seq"], c["d_qk"], c["d_v"]) for c in calls)
        # a step is one of the harness's calls (``batch`` returns 1)
        return {"layer_calls": calls, "train": True,
                "model_flops_per_call": flops,
                "scaled_calls": {"flash_attention_blocks":
                                 self.scaled_counted[0],
                                 "flash_bwd": self.scaled_counted[1]}}

    def release(self):
        for leaves in self.x.values():
            for t in leaves[:4]:
                t.grad = None
        self.x = {}

    def notes(self) -> list:
        return [getattr(self, "p95_note", ""),
                f"attn answers judged: out, dq, dk_nope, dk_pe and dv of "
                f"every layer and length of the last step before the "
                f"refresh at {self.refresh_s!r} s and of the window's last "
                f"step; softmax scale {self.scale!r}; calls with it in the "
                f"window {self.scaled} each way, scaled_calls' rise "
                f"{list(self.scaled_counted)}"]

    def _reference(self, layer, q, k_nope, k_pe, v, dout):
        return ref.forward_backward(q, k_nope, k_pe, v, dout, self.scale)

    def check(self) -> list:
        misses = sum(abs(self.scaled - c) for c in self.scaled_counted)
        return self._judge(((0, self.before), (1, self.last))) + [
            Check("scaled_path_misses", float(misses),
                  float(self.limits["scaled_path_misses"]))]

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
        worst = {}
        for version, ans in answers:
            if ans is None:
                raise RuntimeError("the window ended with no answer to judge")
            for layer, si in self._keys():
                want = self._reference(layer, *self.inputs(layer, si,
                                                           version))
                got = ans.get((layer, si), ())
                for i, (name, w) in enumerate(zip(NAMES, want)):
                    x = got[i] if i < len(got) else None
                    for stat in MLA_STATS[name]:
                        key = f"{name}_{stat}"
                        # an answer the program never produced reads inf
                        val = (float("inf") if x is None
                               else getattr(compare, stat)(x, w))
                        if key not in worst or not val <= worst[key]:
                            worst[key] = val
                del want
        self.before = self.last = None
        return [Check(k, v, float(self.limits[k])) for k, v in worst.items()]
