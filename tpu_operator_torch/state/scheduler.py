"""Dependency-DAG operand scheduler (the port's own copy of
``tpu_operator/state/scheduler.py``).

The serial ready-gate walk pays the *sum* of all state latencies every
pass even though most operand states are independent (the device plugin
has no reason to wait on the metrics exporter). Each
:class:`~.state.State` now declares ``requires()`` — the names of states
whose sync must complete earlier in the same pass — and this module
topologically sorts the graph into *waves* (levels): every state in a
wave has all of its requirements satisfied by earlier waves, so a wave's
states sync concurrently and install-to-ready cost becomes the DAG's
critical path instead of the state count.

Three execution modes, all producing the same per-state results:

- **parallel** (production default): dependency-driven fan-out on a
  shared thread pool — each state launches the moment its last
  requirement completes, so a slow state delays only its dependents and
  a pass costs the *weighted* critical path, not per-wave maxima.
- **virtual** (chaos): ``DAG_GATE.virtual_rng`` set — waves run
  sequentially on the caller's thread in a *seeded shuffle* of the wave's
  states. Two runs with the same seed execute byte-identically while
  still exercising different intra-wave orders across seeds, which is
  what makes ``dag-race`` verdicts reproducible.
- **serial** (``OPERATOR_DAG=0`` / ``--serial-states`` kill switch):
  the scheduler steps aside entirely and the StateManager walks the
  original declaration order.

Every sync is journalled with interleaving-proof sequence numbers
(:class:`SyncJournal`); the chaos plane's ``dag-order`` invariant drains
the journal and verifies that no state ever *started* before every state
it requires *completed* in that pass.
"""

from __future__ import annotations

import os
import random
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple


def env_dag_enabled() -> bool:
    """OPERATOR_DAG=0 (or false/no/off) disables the DAG scheduler."""
    return os.environ.get("OPERATOR_DAG", "1").lower() not in (
        "0", "false", "no", "off")


class DagGate:
    """Process-wide scheduler switch (SPEC_HASH_GATE pattern):
    ``enabled=False`` restores the exact serial walk; ``virtual_rng``
    set to a seeded ``random.Random`` selects deterministic sequential
    execution (the chaos runner installs/restores it per scenario)."""

    def __init__(self) -> None:
        self.enabled: bool = env_dag_enabled()
        self.virtual_rng: Optional[random.Random] = None


DAG_GATE = DagGate()


class DependencyCycleError(RuntimeError):
    """The declared requires() edges contain a cycle. Raised at
    StateManager construction so a bad graph fails operator startup,
    not the Nth reconcile."""


def resolve_requires(states: Sequence) -> Dict[str, Tuple[str, ...]]:
    """Effective edge list: a state returning ``None`` from requires()
    is chained to its list-order predecessor, so an undeclared graph
    degenerates to the original linear order (opt-in-identical)."""
    names = [s.name for s in states]
    if len(set(names)) != len(names):
        dupes = sorted({n for n in names if names.count(n) > 1})
        raise ValueError(f"duplicate state name(s): {', '.join(dupes)}")
    known = set(names)
    out: Dict[str, Tuple[str, ...]] = {}
    prev: Optional[str] = None
    for s in states:
        req = s.requires()
        if req is None:
            req = [prev] if prev is not None else []
        unknown = sorted(set(req) - known)
        if unknown:
            raise ValueError(
                f"state {s.name!r} requires unknown state(s): "
                f"{', '.join(unknown)}")
        out[s.name] = tuple(req)
        prev = s.name
    return out


def _find_cycle(requires: Dict[str, Tuple[str, ...]],
                stuck: List[str]) -> List[str]:
    """One concrete cycle among the unplaceable states, for the error
    message — 'there is a cycle somewhere' is not actionable."""
    stuck_set = set(stuck)
    node = stuck[0]
    seen: Dict[str, int] = {}
    path: List[str] = []
    while node not in seen:
        seen[node] = len(path)
        path.append(node)
        node = next(r for r in requires[node] if r in stuck_set)
    return path[seen[node]:] + [node]


@dataclass(frozen=True)
class DagPlan:
    """Immutable compiled schedule for one state list."""

    order: Tuple[str, ...]                  # deterministic topo order
    levels: Tuple[Tuple[str, ...], ...]     # wave partition of `order`
    requires: Dict[str, Tuple[str, ...]]
    critical_path: Tuple[str, ...]          # longest requires() chain

    @classmethod
    def build(cls, states: Sequence) -> "DagPlan":
        requires = resolve_requires(states)
        index = {s.name: i for i, s in enumerate(states)}
        placed: Dict[str, int] = {}         # name -> level
        levels: List[Tuple[str, ...]] = []
        remaining = [s.name for s in states]
        while remaining:
            # Kahn by levels; within a wave the original declaration
            # order is kept (stable tie-break -> golden-order test)
            wave = [n for n in remaining
                    if all(r in placed for r in requires[n])]
            if not wave:
                cycle = _find_cycle(requires, remaining)
                raise DependencyCycleError(
                    "operand state dependency cycle: "
                    + " -> ".join(cycle)
                    + " (fix the requires() declarations; "
                    "OPERATOR_DAG=0 cannot help — a cyclic graph has "
                    "no valid serial order either)")
            wave.sort(key=index.__getitem__)
            for n in wave:
                placed[n] = len(levels)
            levels.append(tuple(wave))
            remaining = [n for n in remaining if n not in placed]
        order = tuple(n for wave in levels for n in wave)
        # critical path: deepest requires() chain, ties toward the
        # earliest-declared endpoint (deterministic)
        depth: Dict[str, int] = {}
        parent: Dict[str, Optional[str]] = {}
        for n in order:                      # topo order: deps resolved
            reqs = requires[n]
            if not reqs:
                depth[n], parent[n] = 1, None
            else:
                best = min(reqs, key=lambda r: (-depth[r], index[r]))
                depth[n], parent[n] = depth[best] + 1, best
        tail = min(order, key=lambda n: (-depth[n], index[n]))
        path: List[str] = []
        node: Optional[str] = tail
        while node is not None:
            path.append(node)
            node = parent[node]
        return cls(order=order, levels=tuple(levels), requires=requires,
                   critical_path=tuple(reversed(path)))


# -- execution journal (dag-order invariant evidence) ------------------------


@dataclass(frozen=True)
class JournalEntry:
    pass_id: int
    state: str
    start_seq: int
    done_seq: int
    requires: Tuple[str, ...]


class SyncJournal:
    """Bounded, thread-safe record of every state sync's start/done
    interleaving. The chaos invariant checker drains it and asserts the
    dependency-order contract; the bound is a backstop, not a knob —
    the checker drains every observation step."""

    def __init__(self, capacity: int = 65536):
        self._lock = threading.Lock()
        self._entries: deque = deque(maxlen=capacity)
        self._seq = 0

    def next_seq(self) -> int:
        with self._lock:
            self._seq += 1
            return self._seq

    def record(self, entry: JournalEntry) -> None:
        with self._lock:
            self._entries.append(entry)

    def drain(self) -> List[JournalEntry]:
        with self._lock:
            out = list(self._entries)
            self._entries.clear()
            return out


# -- wave executor -----------------------------------------------------------

_POOL_LOCK = threading.Lock()
_POOL: Optional[ThreadPoolExecutor] = None


def _pool() -> ThreadPoolExecutor:
    """Shared process-wide sync pool (the reconcile workers stay free to
    drain other keys while a wave runs). Sized by OPERATOR_DAG_WORKERS;
    the widest wave in the default graph is narrower than the default."""
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            workers = max(1, int(os.environ.get("OPERATOR_DAG_WORKERS",
                                                "8")))
            _POOL = ThreadPoolExecutor(max_workers=workers,
                                       thread_name_prefix="dag-sync")
        return _POOL


def run_plan(plan: DagPlan, run_one: Callable[[str], None],
             journal: Optional[SyncJournal] = None, pass_id: int = 0,
             rng: Optional[random.Random] = None) -> None:
    """Execute one full sync pass.

    ``run_one(name)`` must not raise (the StateManager's per-state
    try/except contract). With ``rng`` the pass runs sequentially in a
    seeded shuffle of each wave (virtual mode). Otherwise execution is
    *dependency-driven*: every state is submitted to the shared pool the
    moment its last requirement completes — not when its whole level
    does — so a slow state only delays its own dependents, never an
    unrelated branch, and the pass cost is the weighted critical path
    rather than the sum of per-wave maxima."""
    if rng is not None:
        for wave in plan.levels:
            names = list(wave)
            rng.shuffle(names)
            for name in names:
                _journaled(run_one, name, plan, journal, pass_id)
        return
    if len(plan.order) == 1:
        _journaled(run_one, plan.order[0], plan, journal, pass_id)
        return

    # dependency-driven fan-out. The ordering contract the dag-order
    # invariant checks is upheld structurally: a dependent is submitted
    # only AFTER each requirement's _journaled completed (journal entry
    # recorded, done_seq drawn), so its own start_seq — drawn from the
    # same locked counter — is always greater.
    lock = threading.Lock()
    waiting = {name: set(plan.requires[name]) for name in plan.order}
    remaining = len(plan.order)
    all_done = threading.Event()
    pool = _pool()

    def finish(name: str) -> None:
        try:
            _journaled(run_one, name, plan, journal, pass_id)
        finally:
            unblocked: List[str] = []
            with lock:
                nonlocal remaining
                remaining -= 1
                if remaining == 0:
                    all_done.set()
                for dep_name in list(waiting):
                    deps = waiting[dep_name]
                    deps.discard(name)
                    if not deps:
                        # popped under the lock: no two completions can
                        # both see the set hit empty and double-submit
                        del waiting[dep_name]
                        unblocked.append(dep_name)
            for nxt in unblocked:
                pool.submit(finish, nxt)

    roots = [n for n in plan.order if not plan.requires[n]]
    for n in roots:
        del waiting[n]
    for n in roots:
        pool.submit(finish, n)
    all_done.wait()


def _journaled(run_one: Callable[[str], None], name: str, plan: DagPlan,
               journal: Optional[SyncJournal], pass_id: int) -> None:
    if journal is None:
        run_one(name)
        return
    start = journal.next_seq()
    try:
        run_one(name)
    finally:
        journal.record(JournalEntry(
            pass_id=pass_id, state=name, start_seq=start,
            done_seq=journal.next_seq(), requires=plan.requires[name]))
