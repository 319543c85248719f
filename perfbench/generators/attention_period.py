"""Traffic kind ``attention_period``: the attention cores of one period of
a hybrid model's layers through the port's ``flash_attention``, where
each kind of layer has its own KV heads, key and value widths and sinks,
one caller in a closed loop.

The configuration gives ``hybrid_layer_pattern`` (0 a full layer, 1 a
sliding-window one), ``sliding_window``, and for full layers
``num_attention_heads``, ``num_key_value_heads``, ``head_dim`` (q and k),
``v_head_dim`` and ``add_full_attention_sink_bias``, for window layers
the ``swa_`` keys of the same names and ``add_swa_attention_sink_bias``
(MiMo-V2-Flash's names), and ``dtype``. The traffic gives ``mode``
(``prefill``), ``batch``, ``seqs``, ``refresh`` and ``sink_range``.

A step is one pass over ``seqs`` (a cycle), each call a layer's forward
under ``no_grad``, synchronised, under ``perfbench.fwd`` and inside it
``perfbench.full_fwd`` or ``perfbench.swa_fwd``; a full layer is called
with no ``window=`` keyword, a window layer with ``window=sliding_window``;
a layer with a sink with ``sinks=``, f32 [H], drawn from the seed per
layer and head, uniform in ``sink_range`` nats.

As ``attention_layers`` (whose set-up, window and judging this kind
keeps): inputs come from the seed, on the device, every q is drawn anew
in place at a seeded point, and the last cycle before it and the
window's last are held, once the window has closed, to the plain float32
reference (``reference/attention_period.py``). ``window_path_misses``
counts the window-layer calls the window made less the rise of B2's
``window_calls`` counter, and ``sink_path_misses`` the calls with a sink
less the rise of its ``sink_calls``.

Parameters: ``mode``, ``batch``, ``seqs``, ``refresh`` ([lo, hi] share of
the window), ``sink_range`` ([lo, hi] nats), ``limits`` (each compared
number's limit).
"""

from __future__ import annotations

import torch

from .. import roofline_split
from ..harness import Check, derive
from ..reference import attention_period as ref
from . import attention_layers

KINDS = {0: "full", 1: "swa"}


def _sink_calls() -> int:
    """B2's count of calls with sinks (0 where the port has none)."""
    from tpu_operator_torch.workloads import flashattention as fa

    return getattr(fa.flash_attention_blocks, "sink_calls", 0)


class Generator(attention_layers.Generator):
    def __init__(self, rank):
        self.r = rank
        cfg, tr = rank.config, rank.traffic
        if tr["mode"] != "prefill":
            raise ValueError(f"attention_period runs prefill only, got "
                             f"{tr['mode']!r}")
        self.train = False
        pattern = [int(x) for x in cfg["hybrid_layer_pattern"]]
        if set(pattern) - set(KINDS):
            raise ValueError(f"hybrid_layer_pattern holds 0 (full) and 1 "
                             f"(sliding window), got {pattern}")
        self.kinds = [KINDS[x] for x in pattern]
        # each kind's (H, Hkv, q/k width, v width, sink)
        self.shape = {}
        for kind, pre, flag in (
                ("full", "", "add_full_attention_sink_bias"),
                ("swa", "swa_", "add_swa_attention_sink_bias")):
            heads = int(cfg[pre + "num_attention_heads"])
            hkv = int(cfg[pre + "num_key_value_heads"])
            if heads % hkv:
                raise ValueError(f"{kind} layers: {heads} query heads over "
                                 f"{hkv} KV heads")
            self.shape[kind] = (heads, hkv, int(cfg[pre + "head_dim"]),
                                int(cfg[pre + "v_head_dim"]),
                                bool(cfg[flag]))
        self.windows = [int(cfg["sliding_window"]) if k == "swa" else None
                        for k in self.kinds]
        self.dtype = getattr(torch, cfg["dtype"])
        self.B = int(tr["batch"])
        self.seqs = [int(s) for s in tr["seqs"]]
        lo, hi = tr["refresh"]
        u = derive(rank.seed, "refresh") / 2**63
        self.refresh_s = (lo + (hi - lo) * u) * rank.seconds
        self.sink_range = [float(x) for x in tr["sink_range"]]
        self.limits = tr["limits"]
        self.lat = []
        self.refreshed = False
        self.before = self.last = None
        n_swa = len(self.seqs) * self.kinds.count("swa")
        self.step_window_calls = (n_swa, 0)
        self.window_calls = [0, 0]
        self.counted = (0, 0)
        self.step_sink_calls = len(self.seqs) * sum(
            self.shape[k][4] for k in self.kinds)
        self.sink_calls = 0
        self.sink_counted = 0
        # each layer's sinks, f32 [H], drawn once; None without
        lo, hi = self.sink_range
        self.sinks = []
        for layer, kind in enumerate(self.kinds):
            heads, _, _, _, sink = self.shape[kind]
            self.sinks.append(None if not sink else torch.empty(
                heads, dtype=torch.float32, device=rank.device).uniform_(
                    lo, hi, generator=rank.gen(layer, "sinks")))

    # inputs ---------------------------------------------------------------
    def _draw(self, layer, si, name, heads, version=0, width=None):
        t = torch.empty((self.B, self.seqs[si], heads, width),
                        dtype=self.dtype, device=self.r.device)
        return t.normal_(generator=self.r.gen(layer, si, name, version))

    def inputs(self, layer, si, version=0):
        """(q, k, v, None) of one layer at one length, each at its kind's
        heads and widths."""
        heads, hkv, d, dv, _ = self.shape[self.kinds[layer]]
        return (self._draw(layer, si, "q", heads, version, d),
                self._draw(layer, si, "k", hkv, 0, d),
                self._draw(layer, si, "v", hkv, 0, dv), None)

    # the program ----------------------------------------------------------
    def _forward(self, layer, si):
        from tpu_operator_torch.workloads import flashattention as fa

        q, k, v, _ = self.x[layer, si]
        kw = {}
        if self.windows[layer] is not None:
            kw["window"] = self.windows[layer]
        if self.sinks[layer] is not None:
            kw["sinks"] = self.sinks[layer]
        with self.r.span("fwd"), self.r.span(self.kinds[layer] + "_fwd"):
            return fa.flash_attention(q, k, v, causal=True, **kw)

    def setup(self):
        super().setup()
        self.sink_counted = _sink_calls()

    def batch(self, elapsed: float) -> int:
        n = super().batch(elapsed)
        self.sink_calls += self.step_sink_calls
        return n

    # figures --------------------------------------------------------------
    def end_to_end(self, window_s: float, calls: int) -> dict:
        self.sink_counted = _sink_calls() - self.sink_counted
        return super().end_to_end(window_s, calls)

    def _calls(self) -> list:
        out = []
        for layer, si in self._keys():
            kind = self.kinds[layer]
            heads, hkv, d, dv, sink = self.shape[kind]
            out.append({"layer": layer, "kind": kind, "bh": self.B * heads,
                        "bh_kv": self.B * hkv, "seq": self.seqs[si],
                        "d_qk": d, "d_v": dv, "window": self.windows[layer],
                        "sinks": sink})
        return out

    def facts(self) -> dict:
        calls = self._calls()
        flops = sum(roofline_split.split_fwd_flops(
            c["bh"], c["seq"], c["d_qk"], c["d_v"], c["window"])
            for c in calls)
        # a step is one of the harness's calls (``batch`` returns 1)
        return {"layer_calls": calls, "train": False,
                "model_flops_per_call": flops,
                "window_calls": {"flash_attention_blocks": self.counted[0]},
                "sink_calls": {"flash_attention_blocks": self.sink_counted}}

    def notes(self) -> list:
        return [getattr(self, "p95_note", ""),
                f"attn answers judged: every layer and length of the last "
                f"cycle before the refresh at {self.refresh_s!r} s and of "
                f"the window's last cycle; window-layer calls in the window "
                f"{self.window_calls[0]}, window_calls' rise "
                f"{self.counted[0]}; calls with sinks {self.sink_calls}, "
                f"sink_calls' rise {self.sink_counted}"]

    def _reference(self, layer, q, k, v, dout):
        return (ref.forward(q, k, v, self.windows[layer], self.sinks[layer]),)

    def check(self) -> list:
        return super().check() + [
            Check("sink_path_misses",
                  float(abs(self.sink_calls - self.sink_counted)),
                  float(self.limits["sink_path_misses"]))]
