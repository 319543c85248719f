"""Reading the profiler's trace of the window.

The harness wraps the calls it makes into the program in
``torch.profiler.record_function`` spans named ``perfbench.<part>``
(``perfbench.window`` around the whole traced loop). The trace is
exported as Chrome's JSON into ``TMPDIR``, read here and deleted. Each
device operation (kernel, copy, set) is tied to the spans in which the
host launched it, through the launch's correlation id, so a reader can
ask for the device time of one kernel, or of everything that one span
launched.
"""

from __future__ import annotations

import bisect
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from . import roofline

PREFIX = "perfbench."
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Op:
    name: str
    start: float          # us, on the trace's clock
    dur: float            # us
    spans: Tuple[str, ...]


@dataclass
class Trace:
    """What the readers in ``layer_metrics/`` see of one traced window."""
    window_s: float                  # the traced window, host clock
    busy_s: float                    # time with a device operation running
    steps: int                       # calls or steps in the traced window
    facts: dict                      # shapes and counts from the generator
    peak: Optional[roofline.Peak]    # the card's peaks, None if unknown
    ops: List[Op] = field(default_factory=list)
    gaps: List[Tuple[str, float]] = field(default_factory=list)
    tied: int = 0                    # ops whose launch the trace holds

    def _pick(self, match: Sequence[str] = (),
              span: Optional[str] = None) -> List[Op]:
        match = [m.lower() for m in match]
        return [op for op in self.ops
                if all(m in op.name.lower() for m in match)
                and (span is None or span in op.spans)]

    def device_s(self, match: Sequence[str] = (),
                 span: Optional[str] = None) -> float:
        """Device seconds of the operations whose names hold every string
        of ``match`` (any case), launched inside the span ``span`` if
        given."""
        return sum(op.dur for op in self._pick(match, span)) / 1e6

    def launches(self, match: Sequence[str] = (),
                 span: Optional[str] = None) -> int:
        return len(self._pick(match, span))

    def top_ops(self, n: int = 10) -> List[list]:
        """The device operations that took most time, by name."""
        by: Dict[str, float] = {}
        for op in self.ops:
            key = _short(op.name)
            by[key] = by.get(key, 0.0) + op.dur / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]


def _short(name: str) -> str:
    """A kernel's name without its argument list."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    if not name.startswith("Memcpy"):
        name = name.split("(", 1)[0]
    return name[:96]


class _SpanIndex:
    """Spans by name; spans of one name do not overlap."""

    def __init__(self, spans: List[Tuple[str, float, float]]):
        self.by: Dict[str, Tuple[List[float], List[float]]] = {}
        for name, t0, t1 in sorted(spans, key=lambda s: s[1]):
            starts, ends = self.by.setdefault(name, ([], []))
            starts.append(t0)
            ends.append(t1)

    def at(self, t: float) -> Tuple[str, ...]:
        out = []
        for name, (starts, ends) in self.by.items():
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and ends[i] >= t:
                out.append(name)
        return tuple(out)

    def innermost(self, t: float) -> str:
        best, width = "outside the harness's spans", float("inf")
        for name, (starts, ends) in self.by.items():
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and ends[i] >= t and ends[i] - starts[i] < width:
                best, width = name, ends[i] - starts[i]
        return best


def read_chrome_trace(path: str, steps: int, facts: dict,
                      peak: Optional[roofline.Peak]) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    launch_at: Dict[int, float] = {}
    spans = []
    device = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in _DEVICE_CATS:
            device.append(e)
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch_at[corr] = float(e["ts"])
        elif cat == "user_annotation" and e.get("name", "").startswith(PREFIX):
            spans.append((e["name"], float(e["ts"]),
                          float(e["ts"]) + float(e.get("dur", 0))))
    index = _SpanIndex(spans)
    win = [s for s in spans if s[0] == PREFIX + "window"]
    if not win:
        raise RuntimeError("the trace holds no perfbench.window span")
    w0, w1 = win[0][1], win[0][2]
    ops = []
    tied = 0
    for e in device:
        t0 = float(e["ts"])
        host = launch_at.get((e.get("args") or {}).get("correlation"))
        tied += host is not None
        ops.append(Op(e.get("name", "?"), t0, float(e.get("dur", 0)),
                      index.at(t0 if host is None else host)))
    busy, gaps = _busy_and_gaps(ops, w0, w1, index)
    return Trace(window_s=(w1 - w0) / 1e6, busy_s=busy, steps=steps,
                 facts=facts, peak=peak, ops=ops, gaps=gaps, tied=tied)


def _busy_and_gaps(ops: List[Op], w0: float, w1: float, index: _SpanIndex):
    """Seconds in [w0, w1] with a device operation running, and the idle
    gaps in it, each named by the innermost span the host was in at the
    gap's middle, longest first."""
    iv = sorted((max(op.start, w0), min(op.start + op.dur, w1))
                for op in ops if op.start + op.dur > w0 and op.start < w1)
    busy = 0.0
    gaps = []
    cur = w0
    for a, b in iv:
        if a > cur:
            gaps.append((cur, a))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if w1 > cur:
        gaps.append((cur, w1))
    named = sorted(((index.innermost((a + b) / 2), (b - a) / 1e6)
                    for a, b in gaps), key=lambda g: -g[1])
    return busy / 1e6, named
