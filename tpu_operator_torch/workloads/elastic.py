"""Workload half of the elastic-slice protocol (Tenplex-style reshard).

The port's counterpart of ``tpu_operator/workloads/elastic.py``. The
operator (upgrade FSM migrate stage, placement resize path) posts a
``gpu.graft.dev/slice-intent`` annotation on the SliceRequest; this
module is the training job's side of the handshake:

    intent seen -> checkpoint at the next step boundary -> ack the
    durable step (annotation + ``status.migration`` Checkpointed) ->
    ... operator rebinds (Rebound) ... -> restore the acked step on the
    new binding and report Resumed + ``restoredStep``.

The ONLY thing a step may be acked on is a *committed* checkpoint: a
crash mid-save leaves a step that was never acked, so restoring an older
retained step (TrainCheckpointer's corrupt-latest fallback) can never
violate the no-acked-work-lost invariant.

Two stores speak one interface:

- ``MemoryCheckpointStore``: the deterministic in-process store the
  migration and resize benchmarks drive, no torch, all time through an
  injectable clock, so seeded runs are byte-identical.
- ``DCPCheckpointStore``: the same interface over the DCP
  ``TrainCheckpointer`` for real jobs, the counterpart of the
  reference's ``OrbaxCheckpointStore``.

``ElasticWorkload`` (the shim) drives either. Its step is its own
counter: ``tick()`` advances it by ``steps_per_tick`` and saves
``payload={"step": step}``, and a trainer that composes it with real
steps runs exactly ``steps_per_tick`` of them a tick. Like the
reference's orbax store, ``DCPCheckpointStore`` has no
``restore_shards``, so a ``Resharding`` rebind over it raises
``AttributeError`` out of ``tick()`` with the sharded gate on (ROADMAP.md
§C, C7): kept, as the reference has it.
"""

from __future__ import annotations

import logging
from typing import TYPE_CHECKING, Any, Callable, Dict, List, Optional, Tuple

from ..api import labels as L
from ..api.conditions import update_status_with_retry
from ..api.slicerequest import (
    KIND_SLICE_REQUEST,
    MIG_CHECKPOINTED,
    MIG_MIGRATING,
    MIG_REBOUND,
    MIG_RESHARDING,
    MIG_RESUMED,
    V1ALPHA1,
)
from ..metrics.operator_metrics import OPERATOR_METRICS
from ..runtime.objects import (
    annotations_of,
    get_nested,
    set_nested,
    thaw_obj,
)
from ..runtime.timeline import TIMELINE

if TYPE_CHECKING:
    from .checkpoint import TrainCheckpointer

log = logging.getLogger("tpu_operator_torch.elastic")


def env_sharded_ckpt_enabled(env=None) -> bool:
    """Sharded checkpoints default ON; OPERATOR_SHARDED_CKPT=0 (or
    false/no/off) disables them — same spelling as the other kill
    switches."""
    import os

    val = (env or os.environ).get("OPERATOR_SHARDED_CKPT", "1")
    return str(val).strip().lower() not in ("0", "false", "no", "off")


class ShardedCkptGate:
    """Process-wide switch for the sharded checkpoint layout and the
    same-domain shard handoff built on it. Disabled, every save is the
    legacy single blob and every resize rides the full
    checkpoint->rebind->restore path — the debugging escape hatch when a
    suspected partial handoff masks lost state."""

    def __init__(self):
        self.enabled = env_sharded_ckpt_enabled()


SHARDED_CKPT_GATE = ShardedCkptGate()


# --- sharded checkpoint layout + shard-movement planner --------------------
#
# Tenplex's observation, applied to the handshake: the train state is a
# parallelizable collection that can be re-split onto a new host set by
# moving ONLY the sub-tensors that change owner. The layout below is the
# manifest's map of that collection: a fixed set of logical shards, each
# owned by one host. A resize re-partitions ownership; plan_reshard()
# diffs two layouts into the minimal move set (and its byte bill), and
# the controllers fall back to the full-checkpoint path whenever the
# layouts cannot be diffed (version skew, different shard sets).

LAYOUT_VERSION = 1
DEFAULT_SHARD_COUNT = 16


def build_layout(hosts: List[str], total_bytes: int,
                 n_shards: int = DEFAULT_SHARD_COUNT,
                 version: int = LAYOUT_VERSION) -> dict:
    """Fresh layout: ``total_bytes`` of state split into ``n_shards``
    near-equal logical shards, owners assigned round-robin over the
    sorted host list. Deterministic — the workload and the controller
    compute identical layouts from the same inputs."""
    hosts = sorted(hosts)
    if not hosts:
        raise ValueError("a layout needs at least one host")
    n = max(1, int(n_shards))
    base, extra = divmod(max(0, int(total_bytes)), n)
    shards = {}
    for sid in range(n):
        shards[str(sid)] = {"owner": hosts[sid % len(hosts)],
                            "bytes": base + (1 if sid < extra else 0)}
    return {"version": int(version), "shards": shards}


def rebalance_layout(layout: dict, new_hosts: List[str]) -> dict:
    """Minimal-movement re-split of ``layout`` onto ``new_hosts``: every
    shard whose owner survives stays put (up to the balanced per-host
    ceiling); only orphaned shards and overflow move, each to the
    least-loaded new host. Deterministic: shards walk in numeric order,
    ties break on host name."""
    new_hosts = sorted(set(new_hosts))
    if not new_hosts:
        raise ValueError("a layout needs at least one host")
    shards = layout["shards"]
    cap = -(-len(shards) // len(new_hosts))  # ceil
    load = {h: 0 for h in new_hosts}
    out: Dict[str, dict] = {}
    homeless = []
    for sid in sorted(shards, key=int):
        owner = shards[sid]["owner"]
        if owner in load and load[owner] < cap:
            out[sid] = {"owner": owner,
                        "bytes": int(shards[sid]["bytes"])}
            load[owner] += 1
        else:
            homeless.append(sid)
    for sid in homeless:
        target = min(new_hosts, key=lambda h: (load[h], h))
        out[sid] = {"owner": target, "bytes": int(shards[sid]["bytes"])}
        load[target] += 1
    return {"version": int(layout.get("version", LAYOUT_VERSION)),
            "shards": out}


def plan_reshard(old_layout: Optional[dict],
                 new_layout: Optional[dict]) -> dict:
    """Pure shard-movement planner: the minimal set of shards changing
    owner between two layouts, bytes accounted. ``compatible`` is False
    (with the reason) whenever the layouts cannot be diffed — version
    skew or differing shard sets — which is the controllers' signal to
    fall back to the full-checkpoint path."""
    plan = {"moves": [], "shardsMoved": 0, "bytesMoved": 0,
            "shardsTotal": 0, "bytesTotal": 0,
            "compatible": True, "reason": ""}
    olds = (old_layout or {}).get("shards") or {}
    news = (new_layout or {}).get("shards") or {}
    if not olds or not news:
        plan.update(compatible=False, reason="missing layout")
        return plan
    old_v = int((old_layout or {}).get("version", -1))
    new_v = int((new_layout or {}).get("version", -1))
    if old_v != new_v:
        plan.update(compatible=False,
                    reason=f"layout version {old_v} != {new_v}")
        return plan
    if set(olds) != set(news):
        plan.update(compatible=False, reason="shard sets differ")
        return plan
    plan["shardsTotal"] = len(news)
    for sid in sorted(news, key=int):
        b = int(news[sid]["bytes"])
        plan["bytesTotal"] += b
        src, dst = olds[sid]["owner"], news[sid]["owner"]
        if src != dst:
            plan["moves"].append(
                {"shard": sid, "from": src, "to": dst, "bytes": b})
            plan["shardsMoved"] += 1
            plan["bytesMoved"] += b
    return plan


class MemoryCheckpointStore:
    """Deterministic stand-in for a checkpoint manager: finalized saves
    are durable, a ``partial=True`` save models a crash mid-write
    (enumerates like a real torn step directory, fails restore), and
    restore falls back past partial steps exactly like
    ``TrainCheckpointer.restore`` does.

    A save may carry a sharded ``layout`` (build_layout): the step then
    holds per-host shards plus a manifest, and the manifest IS the
    finalize-rename commit point — a ``partial`` sharded save models a
    crash mid-shard-handoff (shards written, manifest never renamed in),
    so ``manifest()`` returns None for it and restore falls back exactly
    like the blob path."""

    def __init__(self, max_to_keep: int = 3):
        self.max_to_keep = max_to_keep
        self._steps: Dict[int, dict] = {}

    def save(self, step: int, payload: Any = None,
             partial: bool = False, layout: Optional[dict] = None) -> None:
        step = int(step)
        if partial and step in self._steps \
                and not self._steps[step]["partial"]:
            # finalize-rename atomicity: a torn write can never replace
            # an already-finalized step directory (blob or manifest)
            return
        rec = {"partial": bool(partial), "payload": payload,
               "layout": None, "shards": None}
        if layout is not None:
            rec["layout"] = layout
            rec["shards"] = {
                sid: {"owner": meta["owner"],
                      "bytes": int(meta["bytes"]),
                      "payload": payload}
                for sid, meta in layout["shards"].items()}
        self._steps[step] = rec
        finalized = sorted(s for s, rec in self._steps.items()
                           if not rec["partial"])
        for stale in finalized[:-self.max_to_keep]:
            del self._steps[stale]

    def manifest(self, step: int) -> Optional[dict]:
        """The finalized layout manifest of ``step``, or None — for a
        blob step, a torn sharded step (manifest never renamed in), or
        an unknown step."""
        rec = self._steps.get(int(step))
        if rec is None or rec["partial"]:
            return None
        return rec["layout"]

    def restore_shards(self, step: int,
                       shard_ids: List[str]) -> Tuple[Any, int]:
        """Fetch ONLY the named shards of a finalized sharded step —
        the direct-handoff read path. Returns (payload, bytes_fetched);
        raises FileNotFoundError when the step has no finalized
        manifest (torn or blob-only), the full-restore fallback."""
        rec = self._steps.get(int(step))
        if rec is None or rec["partial"] or not rec["shards"]:
            raise FileNotFoundError(
                f"step {step} has no finalized sharded manifest")
        fetched = 0
        for sid in shard_ids:
            if sid not in rec["shards"]:
                raise FileNotFoundError(
                    f"step {step} has no shard {sid!r}")
            fetched += rec["shards"][sid]["bytes"]
        return rec["payload"], fetched

    def all_steps(self) -> list:
        return sorted(self._steps)

    def latest_step(self) -> Optional[int]:
        finalized = [s for s, rec in self._steps.items()
                     if not rec["partial"]]
        return max(finalized) if finalized else None

    def restore(self) -> Tuple[int, Any]:
        """(step, payload) of the newest restorable checkpoint, skipping
        partial steps with the same fallback accounting as the DCP
        path. Raises FileNotFoundError when nothing restorable exists."""
        for step in sorted(self._steps, reverse=True):
            rec = self._steps[step]
            if rec["partial"]:
                OPERATOR_METRICS.checkpoint_restore_fallbacks.inc()
                log.warning("skipping partial checkpoint step %s", step)
                continue
            return step, rec["payload"]
        raise FileNotFoundError("no restorable checkpoint")


class DCPCheckpointStore:
    """``save``/``manifest``/``latest_step``/``restore`` over a
    ``TrainCheckpointer``: ``state_fn`` yields the live train state to
    persist (a DCP ``Stateful`` with a ``step``, such as
    ``burnin.TrainState``), ``state_like_fn`` the freshly built state a
    restore loads into, whose placements the values take (which is what
    makes a resume on another layout work).

    A save that carries a ``layout`` also persists the layout manifest
    beside the step, through the checkpointer's tmp-and-rename write,
    after the step is committed: the manifest is the only artefact this
    layer adds, and its rename is the commit point of the handoff
    planner. DCP saves are synchronous, so a ``partial`` save is
    committed too; it only goes without its manifest."""

    def __init__(self, checkpointer: TrainCheckpointer,
                 state_fn: Callable[[], Any],
                 state_like_fn: Callable[[], Any]):
        self._ckpt = checkpointer
        self._state_fn = state_fn
        self._state_like_fn = state_like_fn

    def save(self, step: int, payload: Any = None,
             partial: bool = False, layout: Optional[dict] = None) -> None:
        self._ckpt.save(self._state_fn(), int(step), wait=not partial)
        if layout is not None and not partial:
            # the manifest after the committed save: a crash in between
            # leaves a restorable step that falls back to a full restore
            self._ckpt.save_manifest(int(step), layout)

    def manifest(self, step: int) -> Optional[dict]:
        return self._ckpt.read_manifest(int(step))

    def latest_step(self) -> Optional[int]:
        return self._ckpt.latest_step()

    def restore(self) -> Tuple[int, Any]:
        """(step, state) of the newest readable checkpoint: the step is
        the restored state's own, so a torn latest step that the
        checkpointer skipped is not reported."""
        state = self._ckpt.restore(self._state_like_fn())
        return int(state.step), state


class ElasticWorkload:
    """One training job speaking the slice-intent protocol for one
    SliceRequest. ``tick()`` is one scheduling quantum: the migration
    bench calls it once per virtual step, a real deployment calls it from
    the training loop's step callback.

    All cluster interaction goes through the request's status/annotations
    — the shim holds no protocol state a restart could lose; its only
    private state (the in-memory step counter) is exactly the work a
    crash is ALLOWED to lose, back to the last durable checkpoint.
    """

    def __init__(self, client, name: str, namespace: str = "default",
                 clock: Callable[[], float] = None,
                 store: Optional[MemoryCheckpointStore] = None,
                 checkpoint_every: int = 6, steps_per_tick: int = 3,
                 state_bytes: int = 1 << 20,
                 restore_bandwidth: int = 0,
                 sharded: Optional[bool] = None):
        import time

        self.client = client
        self.name = name
        self.namespace = namespace
        self.clock = clock or time.time
        self.store = store if store is not None else MemoryCheckpointStore()
        self.checkpoint_every = checkpoint_every
        self.steps_per_tick = steps_per_tick
        # synthetic state size for the shard layout's byte accounting,
        # and the restore-cost model: with restore_bandwidth > 0
        # (bytes per quantum), a restore stalls extra quanta
        # proportional to the bytes it fetched — which is what makes
        # the direct handoff's smaller byte bill measurable on the
        # virtual clock. 0 bandwidth = instant restores (legacy).
        self.state_bytes = int(state_bytes)
        self.restore_bandwidth = int(restore_bandwidth)
        self._sharded_override = sharded
        self.step = 0
        self.max_acked = -1
        self.last_reshard: Optional[dict] = None
        self._last_saved: Optional[int] = None
        self._last_save_at: Optional[float] = None
        self._nodes_seen: Optional[tuple] = None
        self._crashed = False
        self._layout: Optional[dict] = None
        self._layout_version = LAYOUT_VERSION
        self._reshard_crash_armed = False
        self._pause_ticks = 0

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    @property
    def sharded(self) -> bool:
        if self._sharded_override is not None:
            return bool(self._sharded_override)
        return SHARDED_CKPT_GATE.enabled

    def crash(self, partial: bool = True) -> None:
        """Fault hook: the job dies mid-step. ``partial`` leaves a torn
        checkpoint at the current (never-acked) step, the artifact a
        crash during an async save produces."""
        if partial:
            self.store.save(self.step, payload={"step": self.step},
                            partial=True)
        self._crashed = True

    def arm_reshard_crash(self) -> None:
        """Fault hook: die mid-shard-handoff. The next direct-handoff
        restore writes part of the re-shard (an unfinalized manifest —
        it can never shadow the finalized acked step) and crashes."""
        self._reshard_crash_armed = True

    def force_layout_mismatch(self) -> None:
        """Fault hook: the job's next checkpoints publish an
        incompatible layout version, forcing every subsequent resize
        onto the full-checkpoint fallback path."""
        self._layout_version = LAYOUT_VERSION + 1
        self._layout = None

    def _restore(self) -> int:
        try:
            step, _ = self.store.restore()
        except FileNotFoundError:
            step = 0
        return int(step)

    def _current_layout(self, nodes) -> dict:
        """The layout for a save on ``nodes``: kept when ownership
        already matches, minimally rebalanced when the host set moved,
        built fresh otherwise — always deterministic from (previous
        layout, sorted hosts)."""
        hosts = sorted(nodes)
        if self._layout is not None \
                and int(self._layout.get("version", -1)) \
                == self._layout_version:
            owners = sorted({s["owner"]
                             for s in self._layout["shards"].values()})
            if owners == hosts:
                return self._layout
            return rebalance_layout(self._layout, hosts)
        return build_layout(hosts, self.state_bytes,
                            version=self._layout_version)

    def _save(self, step: int) -> None:
        layout = None
        if self.sharded and self._nodes_seen:
            layout = self._current_layout(self._nodes_seen)
        self.store.save(step, payload={"step": step}, layout=layout)
        self._layout = layout
        self._last_saved = step
        self._last_save_at = self.clock()

    def _pause_for(self, fetched_bytes: int) -> None:
        if self.restore_bandwidth > 0 and fetched_bytes > 0:
            # the restore's own quantum covers the first bandwidth unit
            self._pause_ticks = max(
                0, -(-int(fetched_bytes) // self.restore_bandwidth) - 1)

    def _reshard_restore(self, nodes) -> Optional[Tuple[int, int]]:
        """Direct shard handoff: restore the acked step by fetching ONLY
        the shards whose owner changed onto this binding, then commit
        the re-shard under a fresh finalized manifest. Returns
        (step, bytes_fetched); None on ANY mismatch — the caller falls
        back to the full restore. Raises nothing: a mid-handoff crash
        (armed by the fault hook) leaves a torn manifest and sets the crashed
        flag instead."""
        step = self.store.latest_step()
        if step is None or not hasattr(self.store, "manifest"):
            return None
        manifest = self.store.manifest(step)
        if manifest is None \
                or int(manifest.get("version", -1)) != self._layout_version:
            return None
        new_layout = rebalance_layout(manifest, sorted(nodes))
        plan = plan_reshard(manifest, new_layout)
        if not plan["compatible"]:
            return None
        if self._reshard_crash_armed:
            # die mid-handoff: some shards of the re-shard land, the
            # manifest rename never happens — the torn save can never
            # shadow the finalized acked step, so the restart below
            # restores it and no acked work is lost
            self.store.save(step, payload={"step": step}, partial=True,
                            layout=new_layout)
            self._reshard_crash_armed = False
            self._crashed = True
            return None
        try:
            _, fetched = self.store.restore_shards(
                step, [m["shard"] for m in plan["moves"]])
        except FileNotFoundError:
            return None
        # commit the re-shard: the new ownership map becomes the
        # finalized manifest the NEXT resize plans against
        self.store.save(step, payload={"step": step}, layout=new_layout)
        self._layout = new_layout
        self.last_reshard = {"bytesMoved": plan["bytesMoved"],
                             "shardsMoved": plan["shardsMoved"],
                             "bytesTotal": plan["bytesTotal"]}
        return int(step), int(fetched)

    def tick(self) -> None:
        live = self.client.get_or_none(
            V1ALPHA1, KIND_SLICE_REQUEST, self.name, self.namespace)
        if live is None:
            return
        cr = thaw_obj(live)
        nodes = tuple(get_nested(cr, "status", "nodes", default=[]) or [])
        mig = dict(get_nested(cr, "status", "migration",
                              default={}) or {})
        phase = mig.get("phase", "")
        if not nodes:
            return  # not placed (or mid-eviction): nothing is running
        if self._pause_ticks > 0:
            # still fetching checkpoint bytes onto the new binding: the
            # restore's re-warm stalls training for this quantum
            self._pause_ticks -= 1
            return
        if (self._crashed or phase in (MIG_REBOUND, MIG_RESHARDING)
                or (self._nodes_seen is not None
                    and nodes != self._nodes_seen)):
            # restart/reshard: restore the newest durable checkpoint on
            # the (possibly new) topology, losing only un-acked steps.
            # A Resharding rebind takes the direct handoff — surviving
            # hosts keep their shards, only reassigned shards are
            # fetched; any mismatch (torn manifest, version skew,
            # crashed peer) degrades to the full restore.
            restored = fetched = None
            if (phase == MIG_RESHARDING and not self._crashed
                    and self.sharded):
                out = self._reshard_restore(nodes)
                if self._crashed:
                    return  # the dying handoff consumed this quantum
                if out is not None:
                    restored, fetched = out
                    mig["bytesMoved"] = self.last_reshard["bytesMoved"]
                    mig["shardsMoved"] = self.last_reshard["shardsMoved"]
            if restored is None:
                restored = self._restore()
                manifest = (self.store.manifest(restored)
                            if hasattr(self.store, "manifest") else None)
                fetched = (sum(int(s["bytes"])
                               for s in manifest["shards"].values())
                           if manifest else self.state_bytes)
            self.step = restored
            mig["restoredStep"] = restored
            if phase in (MIG_REBOUND, MIG_RESHARDING):
                mig["phase"] = MIG_RESUMED
            set_nested(cr, mig, "status", "migration")
            update_status_with_retry(self.client, cr, live=live)
            if TIMELINE.enabled and phase in (MIG_REBOUND,
                                              MIG_RESHARDING):
                TIMELINE.record("SliceRequest", self.key,
                                "migration:" + MIG_RESUMED,
                                {"restoredStep": restored,
                                 "nodes": len(nodes)})
            log.info("workload %s restored step %d on %d node(s)",
                     self.key, restored, len(nodes))
            self._nodes_seen = nodes
            self._crashed = False
            self._pause_for(fetched or 0)
            return  # the restore consumed this quantum
        self._nodes_seen = nodes

        # one quantum of training, then the periodic checkpoint cadence
        self.step += self.steps_per_tick
        saved = False
        if self.step - (self._last_saved or 0) >= self.checkpoint_every:
            self._save(self.step)
            # goodput progress: the durably-checkpointed step is the
            # acked-work counter the fleet telemetry plane rates against
            # the generation-ideal step rate — kept outside
            # status.migration so it advances between handshakes
            set_nested(cr, self._last_saved,
                       "status", "progress", "checkpointedStep")
            saved = True

        anns = annotations_of(cr)
        intent = anns.get(L.SLICE_INTENT)
        deadline = anns.get(L.SLICE_INTENT_DEADLINE)
        if intent and phase == MIG_MIGRATING:
            try:
                expired = (deadline is not None
                           and self.clock() > float(deadline))
            except (TypeError, ValueError):
                expired = False
            if not expired:
                # checkpoint at this step boundary and ack it durably;
                # save BEFORE ack — the ack is the operator's license to
                # tear the old binding down
                self._save(self.step)
                set_nested(cr, self._last_saved,
                           "status", "progress", "checkpointedStep")
                self.max_acked = max(self.max_acked, self.step)
                self.client.patch(
                    V1ALPHA1, KIND_SLICE_REQUEST, self.name,
                    {"metadata": {"annotations": {
                        L.SLICE_INTENT_ACK: str(self.step)}}},
                    namespace=self.namespace)
                mig["phase"] = MIG_CHECKPOINTED
                mig["ackedStep"] = max(
                    int(mig.get("ackedStep", -1) or -1), self.step)
                if self.sharded and self._layout is not None:
                    # the acked checkpoint's shard map: the operator's
                    # input to the same-domain handoff planner
                    mig["layout"] = self._layout
                set_nested(cr, mig, "status", "migration")
                update_status_with_retry(self.client, cr, live=live)
                saved = False  # the handshake write carried progress too
                if TIMELINE.enabled:
                    TIMELINE.record("SliceRequest", self.key,
                                    "migration:" + MIG_CHECKPOINTED,
                                    {"intent": intent,
                                     "ackedStep": self.step})
                log.info("workload %s acked %s at step %d",
                         self.key, intent, self.step)
        if saved:
            update_status_with_retry(self.client, cr, live=live)
        if self._last_save_at is not None:
            OPERATOR_METRICS.slice_checkpoint_age.labels(
                request=self.key).set(self.clock() - self._last_save_at)
