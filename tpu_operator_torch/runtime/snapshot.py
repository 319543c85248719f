"""Durable cache/index snapshots: the crash-safe instant-restart plane.

The port's own copy of ``tpu_operator/runtime/snapshot.py``: the
reference's schema 4, its ``federation`` section (the global router's
breaker ledgers and held digests) and ``restore_federation`` included.

A cold operator restart at 10k nodes pays full paged relists before its
first pass. This module makes restart O(changes-since-snapshot) instead:

- :func:`capture` distills a :class:`~tpu_operator_torch.runtime.cache.CachedClient`
  (the stored — already projected — views plus their measured byte
  ledgers) and optionally a ``FleetIndex`` into one JSON-serializable
  dict, stamped with a schema version and the per-kind max
  resourceVersion.
- :func:`write_snapshot` persists a capture atomically
  (write-tmp-then-``os.replace`` — a crash mid-write leaves the previous
  snapshot intact, never a torn file).
- :func:`load_latest` walks the snapshot directory newest-first and
  returns the first snapshot that survives validation; corrupt
  (unparsable, wrong schema, missing sections) or stale (older than
  ``OPERATOR_SNAPSHOT_MAX_AGE``) files are *discarded, never trusted* —
  a bad snapshot degrades to a cold start, not a wrong cache.
- :func:`restore` seeds a fresh ``CachedClient`` pre-watch; the
  informer's subscribe-time replay then folds only the delta (no-op
  replays short-circuit before projection/measure) and prunes keys
  deleted during the downtime.

The Manager writes snapshots on a jittered interval and on clean
shutdown (``OPERATOR_SNAPSHOT_DIR`` / ``OPERATOR_SNAPSHOT_INTERVAL``),
and records the restore outcome next to the snapshots so
``/debug/snapshot`` can tell the story after the fact.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
from typing import Callable, Iterable, Optional

from .objects import FrozenDict, FrozenList, freeze_obj, get_nested, thaw_obj

logger = logging.getLogger("tpu_operator_torch.snapshot")

#: Bump on any incompatible change to the snapshot layout; a mismatched
#: stamp is a corrupt snapshot, not a best-effort parse. v2: arrays are
#: wrapped on disk (see ``_wrap_lists``) so the loader freezes the whole
#: tree during the C-driven JSON parse — restore pays no per-object
#: freeze walk. v3: optional ``admission`` section (per-class deficit
#: clocks + preemption-budget buckets) so a crash never resets
#: starvation accounting. v4: optional ``federation`` section (the
#: global router's per-cell breaker ledgers + held digests) so a router
#: crash mid-partition restarts with its Open/backoff decisions intact
#: instead of hammering a partitioned cell from a cold breaker.
SCHEMA_VERSION = 4

SNAPSHOT_PREFIX = "snapshot-"
SNAPSHOT_SUFFIX = ".json"
RESTORE_MARKER = "last_restore.json"

_REQUIRED_KEYS = ("schema", "written_at", "stores", "max_rvs")


# -- knobs (same spelling as the other operator env switches) -------------


def env_snapshot_dir(env=None) -> Optional[str]:
    """OPERATOR_SNAPSHOT_DIR: where durable snapshots live. Unset/empty
    disables the snapshot plane entirely."""
    val = (env or os.environ).get("OPERATOR_SNAPSHOT_DIR", "")
    val = str(val).strip()
    return val or None


def env_snapshot_interval(env=None) -> float:
    """OPERATOR_SNAPSHOT_INTERVAL: seconds between periodic snapshot
    writes (default 300; the Manager jitters ±20% so a fleet of
    operators doesn't snapshot in lockstep). 0 disables the periodic
    writer (shutdown snapshots still happen)."""
    val = (env or os.environ).get("OPERATOR_SNAPSHOT_INTERVAL", "300")
    try:
        return max(0.0, float(str(val).strip()))
    except ValueError:
        return 300.0


def env_snapshot_max_age(env=None) -> float:
    """OPERATOR_SNAPSHOT_MAX_AGE: seconds after which a snapshot is
    considered stale and discarded at load (default 86400). A snapshot
    older than the apiserver's watch window would heal through relist
    anyway — trusting it buys nothing and risks resurrecting a dead
    fleet view. 0 disables the age check."""
    val = (env or os.environ).get("OPERATOR_SNAPSHOT_MAX_AGE", "86400")
    try:
        return max(0.0, float(str(val).strip()))
    except ValueError:
        return 86400.0


# -- capture / restore (pure, in-memory) ----------------------------------


def _gvk_key(api_version: str, kind: str) -> str:
    return f"{api_version}/{kind}"


def _split_gvk(key: str) -> tuple:
    av, _, kind = key.rpartition("/")
    return (av, kind)


def capture(cached, index=None, now: Optional[Callable[[], float]] = None,
            wall: Optional[float] = None,
            admission: Optional[dict] = None,
            federation: Optional[dict] = None) -> dict:
    """Distill the live cache (and optionally the placement index) into
    one JSON-serializable snapshot dict. Objects are thawed copies —
    the snapshot must not alias the live frozen stores once serialized.

    ``wall`` stamps ``written_at`` (defaults to ``now()`` or
    ``time.time()``); a test passes its stepped clock so captures stay
    deterministic."""
    if wall is None:
        if now is not None:
            wall = now()
        else:
            import time

            wall = time.time()
    stores = {}
    max_rvs = {}
    for (av, kind), dump in cached.dump_stores().items():
        key = _gvk_key(av, kind)
        objs = [thaw_obj(o) for o in dump["objects"]]
        # byte ledgers ride along as lists aligned with ``objects`` —
        # no (ns, name) key strings to serialize, parse, or re-split
        stores[key] = {
            "objects": objs,
            "obj_bytes": list(dump["obj_bytes"]),
            "full_obj_bytes": list(dump["full_obj_bytes"]),
        }
        rvs = []
        for o in objs:
            rv = get_nested(o, "metadata", "resourceVersion")
            try:
                rvs.append(int(rv))
            except (TypeError, ValueError):
                continue
        max_rvs[key] = max(rvs) if rvs else 0
    snap = {
        "schema": SCHEMA_VERSION,
        "written_at": float(wall),
        "stores": stores,
        "max_rvs": max_rvs,
    }
    if index is not None:
        snap["index_nodes"] = [thaw_obj(n) for n in index.export_nodes()]
    if admission is not None:
        # the placement controller's admission_snapshot(): deficit
        # clocks + preemption-budget buckets, JSON scalars only
        snap["admission"] = thaw_obj(admission)
    if federation is not None:
        # the global router's snapshot(): per-cell breaker ledgers and
        # held digests (federation/router.py), JSON scalars only
        snap["federation"] = thaw_obj(federation)
    return snap


def validate(snap, now_wall: Optional[float] = None,
             max_age_s: Optional[float] = None) -> Optional[str]:
    """Why this snapshot cannot be trusted, or None if it can."""
    if not isinstance(snap, dict):
        return "not a mapping"
    for key in _REQUIRED_KEYS:
        if key not in snap:
            return f"missing key {key!r}"
    if snap["schema"] != SCHEMA_VERSION:
        return (f"schema {snap['schema']!r} != supported "
                f"{SCHEMA_VERSION}")
    if not isinstance(snap["stores"], dict):
        return "stores is not a mapping"
    for key, dump in snap["stores"].items():
        if not isinstance(dump, dict) or "objects" not in dump:
            return f"store {key!r} has no objects"
    if max_age_s is None:
        max_age_s = env_snapshot_max_age()
    if max_age_s and now_wall is not None:
        age = now_wall - float(snap.get("written_at") or 0.0)
        if age > max_age_s:
            return f"stale: {age:.0f}s old > max age {max_age_s:.0f}s"
    return None


def restore(cached, snap) -> dict:
    """Seed a fresh (pre-watch) ``CachedClient`` from a validated
    snapshot. Returns a summary ``{kinds, objects}``. The caller is
    responsible for having validated the snapshot first."""
    kinds = 0
    objects = 0
    for key, dump in sorted(snap["stores"].items()):
        av, kind = _split_gvk(key)
        objs = dump["objects"]
        # ledgers are lists aligned with objects; anything else (absent,
        # wrong length) is dropped and seed_many re-measures
        o_b = dump.get("obj_bytes")
        f_b = dump.get("full_obj_bytes")
        if not (isinstance(o_b, (list, tuple)) and len(o_b) == len(objs)):
            o_b = None
        if not (isinstance(f_b, (list, tuple)) and len(f_b) == len(objs)):
            f_b = None
        # disk-loaded snapshots arrive deep-frozen from the parse hook;
        # seed_store freezes any plain (in-memory capture) objects itself
        count = cached.seed_store(
            av, kind, objs, obj_bytes=o_b, full_obj_bytes=f_b)
        kinds += 1
        objects += count
    return {"kinds": kinds, "objects": objects}


def restore_index(snap, index_cls=None):
    """Rebuild a ``FleetIndex`` from the snapshot's node set, or None if
    the snapshot carries no index section. ``resync()`` against the
    (snapshot-seeded, watch-healed) cache then folds the delta."""
    nodes = snap.get("index_nodes")
    if nodes is None:
        return None
    if index_cls is None:
        from ..topology.index import FleetIndex

        index_cls = FleetIndex
    return index_cls(freeze_obj(n) for n in nodes)


def restore_admission(snap) -> Optional[dict]:
    """The snapshot's admission section (deficit clocks + budget
    buckets) as a plain dict, or None when the snapshot predates it or
    carries garbage — a bad section degrades to fresh accounting, never
    a crash."""
    doc = snap.get("admission")
    if not isinstance(doc, dict):
        return None
    return thaw_obj(doc)


def restore_federation(snap) -> Optional[dict]:
    """The snapshot's federation section (the global router's breaker
    ledgers + held digests) as a plain dict, or None when the snapshot
    predates it or carries garbage — a bad section degrades to a cold
    breaker (safe: cells re-prove themselves), never a crash."""
    doc = snap.get("federation")
    if not isinstance(doc, dict):
        return None
    return thaw_obj(doc)


# -- durable persistence --------------------------------------------------

#: On-disk array marker. JSON has no list hook, so v2 snapshots wrap
#: every array as ``{"\x01": [...]}``; ``_frozen_hook`` then rebuilds
#: ``FrozenList``/``FrozenDict`` bottom-up *during* the parse, which is
#: what lets ``restore()`` seed stores with zero post-parse freeze
#: walks. The control-char key cannot collide with a real object field
#: (Kubernetes field and annotation names are printable identifiers).
_LIST_KEY = "\x01"


def _wrap_lists(obj):
    """Encode for disk: every list becomes a ``{_LIST_KEY: [...]}``
    marker dict, recursively."""
    if isinstance(obj, dict):
        return {k: _wrap_lists(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return {_LIST_KEY: [_wrap_lists(v) for v in obj]}
    return obj


def _frozen_hook(pairs):
    """``object_pairs_hook``: marker dicts decode to ``FrozenList``,
    everything else to ``FrozenDict`` — the parse output is deep-frozen
    with no extra traversal."""
    if len(pairs) == 1 and pairs[0][0] == _LIST_KEY:
        return FrozenList(pairs[0][1])
    return FrozenDict(pairs)


def write_snapshot(directory: str, snap) -> str:
    """Atomically persist a capture: serialize to a tmp file in the same
    directory, fsync, then ``os.replace`` onto the final name — the
    rename is the commit point, so a crash mid-write can only ever leave
    a stray ``.tmp``, never a torn snapshot. Returns the final path."""
    os.makedirs(directory, exist_ok=True)
    seq = int(float(snap["written_at"]) * 1000)
    final = os.path.join(
        directory, f"{SNAPSHOT_PREFIX}{seq:016d}{SNAPSHOT_SUFFIX}")
    fd, tmp = tempfile.mkstemp(prefix=SNAPSHOT_PREFIX, suffix=".tmp",
                               dir=directory)
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(_wrap_lists(snap), f, sort_keys=True,
                      separators=(",", ":"))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    # retention: keep the newest few, prune the rest (best effort)
    for stale in snapshot_files(directory)[3:]:
        try:
            os.unlink(stale)
        except OSError:  # pragma: no cover - concurrent prune
            pass
    return final


def snapshot_files(directory: str) -> list:
    """Snapshot paths in the directory, newest first."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    out = [n for n in names
           if n.startswith(SNAPSHOT_PREFIX) and n.endswith(SNAPSHOT_SUFFIX)]
    out.sort(reverse=True)
    return [os.path.join(directory, n) for n in out]


def load_latest(directory: str, now_wall: Optional[float] = None,
                max_age_s: Optional[float] = None) -> Optional[dict]:
    """The newest snapshot that survives validation, or None. Corrupt or
    stale files are skipped with a log line — a bad snapshot costs a
    cold start, never a wrong cache."""
    for path in snapshot_files(directory):
        try:
            with open(path) as f:
                snap = json.load(f, object_pairs_hook=_frozen_hook)
        except (OSError, ValueError) as exc:
            logger.warning("snapshot: discarding unreadable %s: %s",
                           path, exc)
            continue
        # the loaded tree is deep-frozen; a mutable top level carries
        # the bookkeeping key without thawing the payload
        snap = dict(snap) if isinstance(snap, dict) else snap
        reason = validate(snap, now_wall=now_wall, max_age_s=max_age_s)
        if reason is not None:
            logger.warning("snapshot: discarding %s: %s", path, reason)
            continue
        snap["_path"] = path
        return snap
    return None


def record_restore(directory: str, outcome: dict) -> None:
    """Persist the last restore outcome next to the snapshots (best
    effort) so ``/debug/snapshot`` can report it."""
    try:
        os.makedirs(directory, exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix="restore-", suffix=".tmp",
                                   dir=directory)
        with os.fdopen(fd, "w") as f:
            json.dump(outcome, f, sort_keys=True)
        os.replace(tmp, os.path.join(directory, RESTORE_MARKER))
    except OSError:  # pragma: no cover - diagnostics only
        logger.warning("snapshot: could not record restore outcome",
                       exc_info=True)


def snapshot_metadata(directory: Optional[str],
                      now_wall: Optional[float] = None) -> dict:
    """Everything an operator wants to know about the
    snapshot plane without loading object payloads: newest file, age,
    schema/RV stamps, per-kind object counts, last restore outcome."""
    if now_wall is None:
        import time

        now_wall = time.time()
    meta: dict = {
        "dir": directory or "",
        "enabled": bool(directory),
        "snapshots": [],
        "latest": None,
        "last_restore": None,
    }
    if not directory:
        return meta
    files = snapshot_files(directory)
    for path in files:
        try:
            meta["snapshots"].append(
                {"path": path, "bytes": os.path.getsize(path)})
        except OSError:
            continue
    snap = load_latest(directory, now_wall=now_wall)
    if snap is not None:
        meta["latest"] = {
            "path": snap.get("_path", ""),
            "schema": snap["schema"],
            "written_at": snap["written_at"],
            "age_s": round(max(0.0, now_wall - snap["written_at"]), 3),
            "max_rvs": dict(sorted(snap["max_rvs"].items())),
            "objects": {key: len(dump.get("objects", ()))
                        for key, dump in sorted(snap["stores"].items())},
            "has_index": "index_nodes" in snap,
            "has_admission": "admission" in snap,
            "has_federation": "federation" in snap,
        }
    marker = os.path.join(directory, RESTORE_MARKER)
    try:
        with open(marker) as f:
            meta["last_restore"] = json.load(f)
    except (OSError, ValueError):
        meta["last_restore"] = None
    return meta


def derive_requeue_state(requests: Iterable[dict]) -> dict:
    """Re-derive the requeue state a crashed operator held only in
    process memory, from what the placement controller persists on the
    objects themselves:
    ``status.requeueAttempts`` (Unschedulable backoff position) per
    SliceRequest. Returns ``{(ns, name): attempts}`` — the placement
    controller seeds its in-memory counters from this at startup so a
    restart neither collapses the backoff (retry storm) nor double-fires
    work."""
    out = {}
    for cr in requests:
        attempts = get_nested(cr, "status", "requeueAttempts")
        try:
            attempts = int(attempts)
        except (TypeError, ValueError):
            continue
        if attempts > 0:
            ns = get_nested(cr, "metadata", "namespace") or ""
            name = get_nested(cr, "metadata", "name") or ""
            out[(ns, name)] = attempts
    return out
