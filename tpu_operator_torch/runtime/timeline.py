"""Per-object causal timelines: the second layer of the lineage plane.

The port's own copy of ``tpu_operator/runtime/timeline.py``. The tracer
(runtime/tracing.py) answers "what did THIS reconcile do"; the
workqueue's :class:`~tpu_operator_torch.runtime.workqueue.Cause` stamps
answer "why did it run". This module folds both into the view an
operator actually asks for: *what happened to this object, in order,
and why* — every enqueue (with its cause chain), reconcile outcome,
state change and spec-hash write-avoidance hit, keyed by
``(kind, name)``.

Bounded on both axes: at most ``MAX_KEYS`` tracked objects (LRU — a
churning fleet cannot grow the map without bound) and a
``RING_PER_KEY``-event ring per object (old history rolls off; the
recent story is the one worth asking for).

Served at ``/debug/timeline?kind=&name=`` on the Manager health server.
A caller that wants reproducible timelines installs a stepped clock via
:meth:`TimelineRecorder.reset`. ``OPERATOR_TRACE=0`` disables recording
along with the tracer — one kill switch for the whole lineage plane.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Callable, List, Optional, Tuple

from .tracing import env_trace_enabled

__all__ = ["TimelineEvent", "TimelineRecorder", "TIMELINE"]

#: LRU cap on distinct tracked objects.
MAX_KEYS = 1024
#: Ring size per object: the recent causal story, not a full audit log.
RING_PER_KEY = 64


def _round(v: float) -> float:
    return round(v, 6)


class TimelineEvent:
    """One entry in an object's timeline. ``detail`` must hold only
    JSON-safe, deterministic values."""

    __slots__ = ("ts", "event", "detail", "causes")

    def __init__(self, ts: float, event: str, detail: Optional[dict],
                 causes: tuple):
        self.ts = ts
        self.event = event
        self.detail = detail or {}
        self.causes = causes

    def to_dict(self) -> dict:
        d: dict = {"ts": _round(self.ts), "event": self.event}
        if self.detail:
            d["detail"] = {k: self.detail[k] for k in sorted(self.detail)}
        if self.causes:
            d["causes"] = [c.to_dict() for c in self.causes]
        return d


class TimelineRecorder:
    """Thread-safe bounded per-key ring recorder (see module docstring)."""

    def __init__(self, max_keys: int = MAX_KEYS,
                 ring: int = RING_PER_KEY,
                 clock: Callable[[], float] = time.perf_counter,
                 enabled: Optional[bool] = None):
        self.clock = clock
        self.enabled = env_trace_enabled() if enabled is None else enabled
        self._max_keys = max_keys
        self._ring = ring
        self._lock = threading.Lock()
        self._objs: "OrderedDict[Tuple[str, str], deque]" = OrderedDict()

    def record(self, kind: str, name: str, event: str,
               detail: Optional[dict] = None, causes: tuple = ()) -> None:
        """Append one event to the object's ring (cheap no-op when the
        lineage plane is disabled)."""
        if not self.enabled:
            return
        ts = self.clock()
        key = (kind, name)
        with self._lock:
            ring = self._objs.get(key)
            if ring is None:
                ring = deque(maxlen=self._ring)
                self._objs[key] = ring
                while len(self._objs) > self._max_keys:
                    self._objs.popitem(last=False)
            else:
                self._objs.move_to_end(key)
            ring.append(TimelineEvent(ts, event, detail, tuple(causes)))

    # -- reading -------------------------------------------------------------

    def timeline(self, kind: str, name: str) -> List[dict]:
        """The object's events as dicts, oldest first; [] when untracked."""
        with self._lock:
            ring = self._objs.get((kind, name))
            events = list(ring) if ring else []
        return [e.to_dict() for e in events]

    def keys(self) -> List[Tuple[str, str]]:
        """Tracked (kind, name) pairs, sorted (deterministic)."""
        with self._lock:
            return sorted(self._objs)

    def snapshot(self) -> dict:
        """``{"Kind/name": [events...]}`` over every tracked object,
        sorted by key — deterministic, so two runs under one stepped
        clock compare byte for byte."""
        with self._lock:
            items = [(k, list(ring)) for k, ring in self._objs.items()]
        return {f"{kind}/{name}": [e.to_dict() for e in events]
                for (kind, name), events in sorted(items)}

    def save(self) -> tuple:
        """Everything :meth:`reset` drops, clock and flag included, for
        :meth:`restore` to put back."""
        with self._lock:
            return (self.clock, self.enabled, list(self._objs.items()))

    def restore(self, saved: tuple) -> None:
        clock, enabled, objs = saved
        self.reset(clock=clock, enabled=enabled)
        with self._lock:
            self._objs.update(objs)

    def reset(self, clock: Optional[Callable[[], float]] = None,
              enabled: Optional[bool] = None) -> None:
        """Drop every timeline; optionally swap the clock/enabled flag
        (a test installs its stepped clock here)."""
        with self._lock:
            self._objs.clear()
        if clock is not None:
            self.clock = clock
        if enabled is not None:
            self.enabled = enabled


#: process-wide recorder, mutated in place (reset()), never rebound —
#: mirrors the TRACER contract so call sites may hold a reference.
TIMELINE = TimelineRecorder()
