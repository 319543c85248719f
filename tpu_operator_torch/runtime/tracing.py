"""Reconcile tracing: causal spans from workqueue dequeue to apiserver verb.

The port's own copy of ``tpu_operator/runtime/tracing.py``. A
dependency-free span tracer with a process-wide bounded ring buffer — a
flight recorder for the control plane. Every reconcile gets a trace:

* the root span opens at workqueue dequeue (``Controller._worker``) and
  carries the item's queue-wait time; direct-driven reconciles (tests,
  benchmarks) get their root from the reconciler's own ``reconcile``
  wrapper — the same dual-path treatment the per-controller duration
  metric already has;
* each operand-state sync is a child span;
* every client verb is a child span via :class:`TracingClient`, tagged
  ``source=cache`` (served by an informer-backed
  :class:`~tpu_operator_torch.runtime.cache.CachedClient`) or
  ``source=api`` (a real apiserver round-trip), with its latency observed
  on the ``gpu_operator_client_verb_duration_seconds`` histogram.

Finished traces land in a ``deque(maxlen=...)`` ring; failed traces and
the slowest traces are **pinned** in side buffers so they survive ring
churn — the trace you need is by construction the unusual one. The
manager serves the recorder at ``/debug/traces`` (filters: controller,
min_ms, outcome).

The clock is pluggable: production uses ``time.perf_counter``; a test
installs a stepped clock through :meth:`Tracer.reset` so its traces carry
deterministic timestamps.

``OPERATOR_TRACE=0`` (or ``gpu-operator --no-trace``) is the kill
switch: span collection becomes a no-op; the latency *histograms* stay on
(they are metrics, not traces, and cost nanoseconds per observation).
"""

from __future__ import annotations

import bisect
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Callable, List, Optional

from .client import Client, ListOptions

__all__ = ["Span", "Trace", "Tracer", "TRACER", "TracingClient"]

# ring sizes: recent window + pinned failed + pinned slowest. 256 recent
# traces of a busy 3-controller manager cover minutes of history; failed
# traces pin separately so an error burst is never evicted by the healthy
# traffic that follows it.
RING_CAPACITY = 256
FAILED_CAPACITY = 256
SLOW_KEEP = 16


def env_trace_enabled(env: Optional[dict] = None) -> bool:
    """The OPERATOR_TRACE kill switch (default: on)."""
    val = (env or os.environ).get("OPERATOR_TRACE", "1")
    return str(val).strip().lower() not in ("0", "false", "no", "off")


def _round(v: float) -> float:
    # 6 decimals = microsecond resolution; keeps trace JSON stable and
    # readable without losing anything a control loop can act on
    return round(v, 6)


class Span:
    """One timed operation inside a trace. Plain tree node, no locking:
    a span is only ever touched by the thread that opened its trace."""

    __slots__ = ("name", "start", "end", "tags", "error", "children")

    def __init__(self, name: str, start: float,
                 tags: Optional[dict] = None):
        self.name = name
        self.start = start
        self.end = start
        self.tags = tags or {}
        self.error: Optional[str] = None
        self.children: List["Span"] = []

    @property
    def duration_s(self) -> float:
        return max(0.0, self.end - self.start)

    def to_dict(self) -> dict:
        d = {
            "name": self.name,
            "start": _round(self.start),
            "duration_s": _round(self.duration_s),
        }
        if self.tags:
            d["tags"] = {k: self.tags[k] for k in sorted(self.tags)}
        if self.error:
            d["error"] = self.error
        if self.children:
            d["children"] = [c.to_dict() for c in self.children]
        return d


class Trace:
    """A finished (or in-flight) reconcile: the root span plus identity
    and outcome. ``seq`` is assigned when the trace opens, so an enqueue
    performed *during* the reconcile (a watch event fired by one of its
    own writes) can already cite this trace as its cause."""

    __slots__ = ("seq", "controller", "key", "root", "outcome", "error",
                 "queue_wait_s", "causes")

    def __init__(self, controller: str, key: str, root: Span,
                 queue_wait_s: Optional[float] = None,
                 causes: tuple = ()):
        self.seq = -1
        self.controller = controller
        self.key = key
        self.root = root
        self.outcome = "ok"
        self.error: Optional[str] = None
        self.queue_wait_s = queue_wait_s
        # Cause tuple popped off the workqueue with the item: why this
        # reconcile ran, each entry linking the trace that enqueued it
        self.causes = causes

    @property
    def duration_s(self) -> float:
        return self.root.duration_s

    def to_dict(self) -> dict:
        d = {
            "id": self.seq,
            "controller": self.controller,
            "key": self.key,
            "outcome": self.outcome,
            "error": self.error,
            "duration_s": _round(self.duration_s),
            "queue_wait_s": (None if self.queue_wait_s is None
                             else _round(self.queue_wait_s)),
            "root": self.root.to_dict(),
        }
        if self.causes:
            d["causes"] = [c.to_dict() for c in self.causes]
        return d


class Tracer:
    """Thread-safe flight recorder. Each thread has its own span stack
    (thread-local), so N reconcile workers trace concurrently without
    interleaving; the finished-trace buffers are shared under one lock."""

    def __init__(self, capacity: int = RING_CAPACITY,
                 failed_capacity: int = FAILED_CAPACITY,
                 slow_keep: int = SLOW_KEEP,
                 clock: Callable[[], float] = time.perf_counter,
                 enabled: Optional[bool] = None):
        self.clock = clock
        self.enabled = env_trace_enabled() if enabled is None else enabled
        self._capacity = capacity
        self._failed_capacity = failed_capacity
        self._slow_keep = slow_keep
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=capacity)
        self._failed: deque = deque(maxlen=failed_capacity)
        # pinned slowest traces, kept sorted ascending by (duration, -seq):
        # evicting index 0 drops the fastest pin; on duration ties the
        # OLDER trace survives (deterministic under a virtual clock where
        # most durations are identical zeros)
        self._slow: List[tuple] = []
        self._seq = 0
        self._tls = threading.local()

    # -- per-thread span stack ----------------------------------------------

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = []
            self._tls.stack = stack
        return stack

    def current_trace(self) -> Optional[Trace]:
        stack = self._stack()
        return stack[0][0] if stack else None

    def active(self) -> bool:
        """True when tracing is on AND this thread has an open trace.
        The cheap guard hot paths (TracingClient, ~1 check per client
        verb) test before building span arguments at all."""
        return self.enabled and bool(getattr(self._tls, "stack", None))

    # -- recording ----------------------------------------------------------

    @contextmanager
    def trace(self, controller: str, key: str,
              queue_wait_s: Optional[float] = None,
              causes: tuple = ()):
        """Open the root span of a reconcile. Nested calls (a Controller
        worker already opened the trace, then the reconciler's own
        wrapper asks again) are a passthrough — one reconcile, one trace,
        whichever layer saw it first. ``causes`` is the Cause tuple the
        workqueue popped with the item — the cross-controller link."""
        if not self.enabled or self._stack():
            yield None
            return
        root = Span("reconcile", self.clock())
        tr = Trace(controller, key, root, queue_wait_s=queue_wait_s,
                   causes=tuple(causes))
        with self._lock:
            # seq at open (not record): a watch handler firing inside
            # this reconcile needs the id to stamp into its Cause
            tr.seq = self._seq
            self._seq += 1
        self._stack().append((tr, root))
        try:
            yield tr
        except BaseException as e:
            tr.outcome = "error"
            tr.error = f"{type(e).__name__}: {e}"
            root.error = tr.error
            raise
        finally:
            root.end = self.clock()
            self._tls.stack = []
            self._record(tr)

    @contextmanager
    def span(self, name: str, **tags):
        """Open a child span under the innermost active span. A no-op
        (yields None) when tracing is off or no trace is active — child
        instrumentation never creates orphan traces."""
        stack = self._stack()
        if not self.enabled or not stack:
            yield None
            return
        tr, parent = stack[-1]
        sp = Span(name, self.clock(), tags=dict(tags) if tags else None)
        parent.children.append(sp)
        stack.append((tr, sp))
        try:
            yield sp
        except BaseException as e:
            if sp.error is None:
                sp.error = f"{type(e).__name__}: {e}"
            raise
        finally:
            sp.end = self.clock()
            stack.pop()

    def current(self):
        """Opaque handle to this thread's innermost active (trace, span),
        or None. A dispatcher captures it before fanning work out to
        other threads and passes it to :meth:`span_under` — the span
        stack is thread-local, so a worker thread cannot see the
        dispatcher's open trace on its own."""
        stack = self._stack()
        return stack[-1] if self.enabled and stack else None

    @contextmanager
    def span_under(self, handle, name: str, **tags):
        """Open a child span under a handle captured by :meth:`current`
        on another thread. The new span is appended to the handle's span
        (list.append is atomic; the dispatcher only reads children after
        joining its workers) and pushed on the *calling* thread's stack,
        so nested spans — TracingClient verbs inside a DAG state sync —
        attach under it. No-op (yields None) for a None handle."""
        if handle is None or not self.enabled:
            yield None
            return
        tr, parent = handle
        sp = Span(name, self.clock(), tags=dict(tags) if tags else None)
        parent.children.append(sp)
        stack = self._stack()
        stack.append((tr, sp))
        try:
            yield sp
        except BaseException as e:
            if sp.error is None:
                sp.error = f"{type(e).__name__}: {e}"
            raise
        finally:
            sp.end = self.clock()
            stack.pop()

    def tag(self, key: str, value) -> None:
        """Tag the innermost active span, if any (safe to call always)."""
        stack = self._stack()
        if stack:
            stack[-1][1].tags[key] = value

    def _record(self, tr: Trace) -> None:
        with self._lock:
            self._ring.append(tr)
            if tr.outcome == "error":
                self._failed.append(tr)
            entry = (tr.duration_s, -tr.seq, tr)
            bisect.insort(self._slow, entry[:2] + (tr,))
            if len(self._slow) > self._slow_keep:
                self._slow.pop(0)

    # -- reading ------------------------------------------------------------

    def _all_locked(self) -> List[Trace]:
        seen = {}
        for tr in list(self._ring) + list(self._failed) \
                + [e[2] for e in self._slow]:
            seen[tr.seq] = tr
        return [seen[s] for s in sorted(seen)]

    def traces(self, controller: Optional[str] = None,
               min_ms: Optional[float] = None,
               outcome: Optional[str] = None,
               limit: Optional[int] = None) -> List[dict]:
        """Recorded traces as dicts, newest first, with the /debug/traces
        filter semantics."""
        with self._lock:
            out = self._all_locked()
        out.reverse()
        if controller is not None:
            out = [t for t in out if t.controller == controller]
        if min_ms is not None:
            out = [t for t in out if t.duration_s * 1000.0 >= min_ms]
        if outcome is not None:
            out = [t for t in out if t.outcome == outcome]
        if limit is not None and limit > 0:
            out = out[:limit]
        return [t.to_dict() for t in out]

    def failed_traces(self) -> List[dict]:
        """Every pinned failed trace, oldest first (deterministic)."""
        with self._lock:
            return [t.to_dict() for t in self._failed]

    def slowest_trace(self) -> Optional[dict]:
        """The slowest recorded trace; duration ties break toward the
        earliest trace, so the answer is deterministic per run."""
        with self._lock:
            cands = self._all_locked()
        if not cands:
            return None
        best = max(cands, key=lambda t: (t.duration_s, -t.seq))
        return best.to_dict()

    def reset(self, clock: Optional[Callable[[], float]] = None,
              enabled: Optional[bool] = None) -> None:
        """Clear every buffer and restart sequence numbering; optionally
        swap the clock / enabled flag. A caller that wants reproducible
        traces (a test under a stepped clock) calls this first, so they
        carry only its clock's timestamps and per-run sequence ids."""
        with self._lock:
            self._ring.clear()
            self._failed.clear()
            self._slow.clear()
            self._seq = 0
        if clock is not None:
            self.clock = clock
        if enabled is not None:
            self.enabled = enabled


#: process-wide tracer: one flight recorder per operator process, shared
#: by every controller and the manager's /debug/traces endpoint. Mutated in place (reset()), never rebound — call sites
#: may safely hold a reference.
TRACER = Tracer()


# -- client instrumentation --------------------------------------------------

_READ_VERBS = ("get", "list", "index")


class TracingClient(Client):
    """Client wrapper that records one child span + one histogram sample
    per verb. Composes outermost in the client stack:

        controllers -> TracingClient -> CachedClient -> (HTTP|Fake)

    Reads served by an open :class:`CachedClient` are tagged
    ``source=cache``; everything else (all writes, reads on a non-cached
    or closed-cache stack) is ``source=api``. Non-verb surface (informer
    indexes, ``cache_reads``/``relists`` counters, ``close``...) delegates
    to the wrapped client via ``__getattr__``, so callers see the cache
    exactly as before."""

    def __init__(self, inner: Client, tracer: Optional[Tracer] = None):
        self.inner = inner
        self.tracer = tracer or TRACER
        # memoized Histogram children: labels() resolution costs a few
        # microseconds per call — real money at high call volumes
        self._hist_children: dict = {}

    def _read_source(self) -> str:
        if getattr(self.inner, "serves_cached_reads", False):
            return "cache"
        return "api"

    def _call(self, verb: str, kind: str, source: str, fn, **span_tags):
        child = self._hist_children.get((verb, kind, source))
        if child is None:
            from ..metrics.operator_metrics import OPERATOR_METRICS

            child = OPERATOR_METRICS.client_verb_duration.labels(
                verb=verb, kind=kind, source=source)
            self._hist_children[(verb, kind, source)] = child
        t = self.tracer
        wall0 = time.perf_counter()
        try:
            if t.active():
                with t.span("client:" + verb, verb=verb, kind=kind,
                            source=source, **span_tags):
                    return fn()
            return fn()
        finally:
            child.observe(time.perf_counter() - wall0)

    # -- verbs ---------------------------------------------------------------

    def get(self, api_version, kind, name, namespace=None,
            metadata_only=False):
        return self._call(
            "get", kind, self._read_source(),
            lambda: self.inner.get(api_version, kind, name, namespace,
                                   metadata_only=metadata_only),
            target=name)

    def list(self, api_version, kind, opts: Optional[ListOptions] = None):
        return self._call(
            "list", kind, self._read_source(),
            lambda: self.inner.list(api_version, kind, opts))

    def create(self, obj):
        return self._call(
            "create", obj.get("kind", ""), "api",
            lambda: self.inner.create(obj),
            target=(obj.get("metadata") or {}).get("name", ""))

    def update(self, obj):
        return self._call(
            "update", obj.get("kind", ""), "api",
            lambda: self.inner.update(obj),
            target=(obj.get("metadata") or {}).get("name", ""))

    def update_status(self, obj):
        return self._call(
            "update_status", obj.get("kind", ""), "api",
            lambda: self.inner.update_status(obj),
            target=(obj.get("metadata") or {}).get("name", ""))

    def patch(self, api_version, kind, name, patch, namespace=None):
        return self._call(
            "patch", kind, "api",
            lambda: self.inner.patch(api_version, kind, name, patch,
                                     namespace),
            target=name)

    def delete(self, api_version, kind, name, namespace=None):
        return self._call(
            "delete", kind, "api",
            lambda: self.inner.delete(api_version, kind, name, namespace),
            target=name)

    def evict(self, name, namespace=None):
        # delegate (HTTPClient has a real eviction POST; CachedClient
        # inherits the client-side PDB check) so semantics are exactly
        # the unwrapped stack's — this layer only times and tags it
        return self._call(
            "evict", "Pod", "api",
            lambda: self.inner.evict(name, namespace),
            target=name)

    def watch(self, api_version, kind, handler, since_rv=None):
        # long-lived subscription, not a timed verb
        if since_rv is None:
            return self.inner.watch(api_version, kind, handler)
        return self.inner.watch(api_version, kind, handler,
                                since_rv=since_rv)

    def __getattr__(self, attr):
        # everything that is not a verb (index/index_keys/has_index,
        # cache_reads/relists, resync, store_snapshot, close, ...)
        return getattr(self.inner, attr)
