"""Fair-share admission: hierarchical quota tree + starvation accounting.

The port's counterpart of ``tpu_operator/scheduling/quota.py``; only its
names follow the naming rule (``GPUQuota``, ``gpu-operator-quota``) and
its generation peaks are the port's hardware table's.

The batched gang pass drains Pending in strict priority/age order,
which is correct when capacity is ample and starvation-prone at the
oversubscribed steady state. Gavel (PAPERS.md) shows fairness has to be
an allocation *policy*, not a queue ordering tweak — this module is that
policy layer, sitting between the workqueue and the gang pass:

- ``QuotaTree``: a hierarchical quota config (GPUQuota CRD or the
  ``gpu-operator-quota`` ConfigMap) mapping every SliceRequest to a leaf
  class with weight, min-guarantee and max-cap. Shares are computed by
  iterative weighted water-filling per tree level, so a capped or
  demand-light class's leftover is *borrowed* by its siblings.
- ``order_batch``: pluggable batch-ordering strategies over one gang
  pass — ``priority`` (the legacy priority/age baseline, the kill
  switch), ``finish-time`` (least attained chips per unit weight first)
  and ``throughput`` (least attained chips x generation-peak-TFLOPs per
  unit weight first), selected by ``OPERATOR_ADMISSION_POLICY``.
- ``AdmissionState``: per-class deficit clocks (time a class has sat
  below its min-guarantee floor with work queued) and preemption-budget
  token buckets (how many preemptions a class may *suffer* per window).
  Both persist in the durable snapshot so an operator crash never resets
  starvation accounting.

Everything is a pure function of (config, cluster state, injected
clock), so a run driven off a virtual clock is byte-identical per seed.
"""

from __future__ import annotations

import calendar
import json
import logging
import math
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ..api import labels as L
from ..runtime.objects import annotations_of, get_nested, namespace_of
from ..workloads.hardware import CHIPS

log = logging.getLogger("tpu_operator_torch.quota")

DEFAULT_CLASS = "default"
QUOTA_CONFIGMAP = "gpu-operator-quota"
QUOTA_CONFIG_KEY = "quota.json"
KIND_GPU_QUOTA = "GPUQuota"
V1ALPHA1 = "gpu.graft.dev/v1alpha1"

POLICY_BASELINE = "priority"
POLICY_FINISH_TIME = "finish-time"
POLICY_THROUGHPUT = "throughput"
POLICIES = (POLICY_BASELINE, POLICY_FINISH_TIME, POLICY_THROUGHPUT)

# generation-peak TFLOPs for throughput-normalized allocation; unknown
# generations rate as 1.0 chip-equivalent so they still count as service
_GEN_TFLOPS = {gen: spec.peak_bf16_tflops for gen, spec in CHIPS.items()}


def env_admission_policy(env: Optional[dict] = None) -> str:
    """``OPERATOR_ADMISSION_POLICY``: priority (default, the kill
    switch) | finish-time | throughput. Unknown values fall back to the
    baseline rather than failing the controller."""
    src = os.environ if env is None else env
    v = (src.get("OPERATOR_ADMISSION_POLICY") or POLICY_BASELINE).strip()
    return v if v in POLICIES else POLICY_BASELINE


class AdmissionGate:
    """Read once at import (same pattern as PlacementIndexGate) so a
    single reconcile pass never straddles two policies; tests override
    the attribute directly."""

    def __init__(self):
        self.policy = env_admission_policy()


ADMISSION_GATE = AdmissionGate()


# --- deterministic priority/age baseline ------------------------------------

def created_epoch(cr: dict) -> float:
    """``metadata.creationTimestamp`` as epoch seconds. The legacy sort
    compared the RAW strings, which breaks total order as soon as two
    API clients serialize differently (fractional seconds, ``+00:00``
    offsets) — clock skew in disguise. Unparseable stamps sort last
    (+inf) and fall through to the (namespace, name) tie-break."""
    raw = str(get_nested(cr, "metadata", "creationTimestamp",
                         default="") or "")
    if not raw:
        return math.inf
    s = raw.strip()
    if s.endswith("Z"):
        s = s[:-1]
    elif s.endswith("+00:00"):
        s = s[:-6]
    frac = 0.0
    if "." in s:
        s, _, fpart = s.partition(".")
        try:
            frac = float("0." + fpart)
        except ValueError:
            frac = 0.0
    try:
        return calendar.timegm(time.strptime(s, "%Y-%m-%dT%H:%M:%S")) + frac
    except (ValueError, OverflowError):
        return math.inf


def baseline_key(key: str, cr: dict, spec) -> Tuple:
    """The priority/age gang-pass order: higher priority first, then
    older first, then (namespace, name) so equal-priority same-second
    requests drain in one total deterministic order under clock skew."""
    ns, _, name = key.partition("/")
    return (-int(spec.priority or 0), created_epoch(cr), ns, name)


# --- quota tree -------------------------------------------------------------

@dataclass(frozen=True)
class QuotaClass:
    """One node of the quota tree. ``parent`` "" means a child of the
    implicit root. ``preempt_tokens`` bounds how many preemptions this
    class may *suffer* per ``preempt_window_s`` — 0 (the default) makes
    the class preemption-exempt."""

    name: str
    parent: str = ""
    weight: float = 1.0
    min_chips: int = 0
    max_chips: Optional[int] = None
    starvation_bound_s: float = math.inf
    preempt_tokens: int = 0
    preempt_window_s: float = 600.0

    @classmethod
    def from_doc(cls, doc: dict) -> "QuotaClass":
        bound = doc.get("starvationBoundSeconds")
        maxc = doc.get("maxChips")
        return cls(
            name=str(doc["name"]),
            parent=str(doc.get("parent") or ""),
            weight=max(0.0, float(doc.get("weight", 1.0))),
            min_chips=max(0, int(doc.get("minChips", 0))),
            max_chips=None if maxc is None else max(0, int(maxc)),
            starvation_bound_s=(math.inf if bound is None
                                else max(0.0, float(bound))),
            preempt_tokens=max(0, int(doc.get("preemptTokens", 0))),
            preempt_window_s=max(1.0, float(doc.get("preemptWindowSeconds",
                                                    600.0))),
        )


class QuotaTree:
    """The parsed quota hierarchy. A ``default`` leaf always exists
    (synthesized, unbounded, weight 1.0, no guarantees) so unclassified
    requests are never rejected by the admission layer."""

    def __init__(self, classes: List[QuotaClass]):
        by_name: Dict[str, QuotaClass] = {}
        for qc in classes:
            if qc.name in by_name:
                raise ValueError(f"duplicate quota class {qc.name!r}")
            by_name[qc.name] = qc
        for qc in classes:
            if qc.parent and qc.parent not in by_name:
                raise ValueError(
                    f"quota class {qc.name!r} parents unknown "
                    f"{qc.parent!r}")
        children: Dict[str, List[str]] = {"": []}
        for qc in classes:
            children.setdefault(qc.name, [])
            children.setdefault(qc.parent, []).append(qc.name)
        # cycle guard: every class must reach the root
        for qc in classes:
            seen, cur = set(), qc
            while cur.parent:
                if cur.parent in seen:
                    raise ValueError(f"quota tree cycle at {qc.name!r}")
                seen.add(cur.parent)
                cur = by_name[cur.parent]
        if DEFAULT_CLASS not in by_name:
            dq = QuotaClass(name=DEFAULT_CLASS)
            by_name[DEFAULT_CLASS] = dq
            children[""].append(DEFAULT_CLASS)
            children[DEFAULT_CLASS] = []
        self.by_name = by_name
        self.children = {k: sorted(v) for k, v in children.items()}

    def get(self, name: str) -> QuotaClass:
        return self.by_name.get(name) or self.by_name[DEFAULT_CLASS]

    def leaf_names(self) -> List[str]:
        return sorted(n for n, kids in self.children.items()
                      if n and not kids)

    def class_of(self, cr: dict) -> str:
        """Leaf class of one SliceRequest: the explicit
        ``gpu.graft.dev/quota-class`` annotation wins, then a leaf named
        after the request's namespace, then ``default``."""
        leaves = set(self.leaf_names())
        ann = annotations_of(cr).get(L.QUOTA_CLASS)
        if ann and ann in leaves:
            return ann
        ns = namespace_of(cr) or ""
        if ns in leaves:
            return ns
        return DEFAULT_CLASS

    # -- share math ---------------------------------------------------------

    def shares(self, capacity: int,
               demand: Dict[str, int]) -> Dict[str, int]:
        """Fair share per LEAF class for ``capacity`` chips given
        per-leaf ``demand``: weighted water-fill per tree level with
        min-guarantee and max-cap clamping; leftover from capped or
        demand-light classes is borrowed by unsatisfied siblings."""
        eff: Dict[str, int] = {}

        def subtree_demand(name: str) -> int:
            kids = self.children.get(name, [])
            if not kids:
                d = max(0, int(demand.get(name, 0)))
            else:
                d = sum(subtree_demand(k) for k in kids)
            qc = self.by_name.get(name)
            if qc is not None and qc.max_chips is not None:
                d = min(d, qc.max_chips)
            eff[name] = d
            return d

        for top in self.children.get("", []):
            subtree_demand(top)
        out: Dict[str, int] = {}

        def distribute(avail: int, names: List[str]) -> None:
            alloc = {n: 0 for n in names}
            # min guarantees first (never above effective demand); when
            # mins oversubscribe capacity, grant in sorted-name order so
            # the outcome is total and deterministic
            for n in sorted(names):
                want = min(self.by_name[n].min_chips, eff[n])
                give = min(want, avail)
                alloc[n] += give
                avail -= give
            # weighted fill with borrow: classes at cap/demand drop out,
            # the rest absorb the remainder; sub-chip remainders hand
            # out one chip at a time in sorted-name order
            guard = 0
            while avail > 0 and guard < 10_000:
                guard += 1
                open_ = [n for n in sorted(names) if alloc[n] < eff[n]
                         and self.by_name[n].weight > 0]
                if not open_:
                    break
                total_w = sum(self.by_name[n].weight for n in open_)
                gave = 0
                for n in open_:
                    fair = int(avail * self.by_name[n].weight / total_w)
                    give = min(max(fair, 0), eff[n] - alloc[n])
                    alloc[n] += give
                    gave += give
                if gave == 0:
                    for n in open_:
                        if avail <= 0:
                            break
                        alloc[n] += 1
                        avail -= 1
                    break
                avail -= gave
            for n in names:
                kids = self.children.get(n, [])
                if kids:
                    distribute(alloc[n], kids)
                else:
                    out[n] = alloc[n]

        distribute(max(0, int(capacity)), self.children.get("", []))
        for leaf in self.leaf_names():
            out.setdefault(leaf, 0)
        return out

    # -- config loading -----------------------------------------------------

    @classmethod
    def from_config(cls, doc: dict) -> "QuotaTree":
        rows = doc.get("classes")
        if not isinstance(rows, list) or not rows:
            raise ValueError("quota config needs a non-empty 'classes' list")
        return cls([QuotaClass.from_doc(r) for r in rows])

    @classmethod
    def load(cls, client, namespace: str) -> Optional["QuotaTree"]:
        """The GPUQuota CRD wins over the ConfigMap; neither present (or
        unparseable — a bad config must not take placement down) means
        no quota: the admission layer is a strict no-op."""
        try:
            for obj in client.list(V1ALPHA1, KIND_GPU_QUOTA):
                spec = get_nested(obj, "spec", default={}) or {}
                if spec.get("classes"):
                    return cls.from_config(dict(spec))
        except Exception:
            pass
        try:
            cm = client.get_or_none("v1", "ConfigMap", QUOTA_CONFIGMAP,
                                    namespace)
        except Exception:
            cm = None
        if cm is None:
            return None
        raw = (get_nested(cm, "data", default={}) or {}).get(
            QUOTA_CONFIG_KEY)
        if not raw:
            return None
        try:
            return cls.from_config(json.loads(raw))
        except (ValueError, TypeError) as e:
            log.warning("ignoring unparseable quota config: %s", e)
            return None


# --- per-class deficit clocks and preemption budgets ------------------------

@dataclass
class AdmissionState:
    """The only mutable admission state. ``deficit_since`` anchors the
    per-class starvation clock at the moment the class dropped below its
    min-guarantee floor with work queued; ``tokens``/``window_start``
    are the preemption budget buckets. All plain JSON scalars so the
    snapshot plane persists it verbatim (schema v3)."""

    deficit_since: Dict[str, float] = field(default_factory=dict)
    tokens: Dict[str, float] = field(default_factory=dict)
    window_start: Dict[str, float] = field(default_factory=dict)

    def observe(self, tree: QuotaTree, usage: Dict[str, int],
                queued: Dict[str, int], now: float) -> Dict[str, float]:
        """Advance every leaf's deficit clock; returns class -> current
        deficit seconds. A class is starving while it has queued demand
        AND sits below ``min(min_chips, usage + queued)`` — the floor a
        min-guarantee entitles it to given what it actually wants."""
        deficits: Dict[str, float] = {}
        for name in tree.leaf_names():
            qc = tree.get(name)
            use = max(0, int(usage.get(name, 0)))
            q = max(0, int(queued.get(name, 0)))
            floor = min(qc.min_chips, use + q)
            if q > 0 and use < floor:
                since = self.deficit_since.setdefault(name, float(now))
                deficits[name] = max(0.0, float(now) - since)
            else:
                self.deficit_since.pop(name, None)
                deficits[name] = 0.0
        return deficits

    def _roll(self, qc: QuotaClass, now: float) -> None:
        start = self.window_start.get(qc.name)
        if start is None or float(now) - start >= qc.preempt_window_s:
            self.window_start[qc.name] = float(now)
            self.tokens[qc.name] = float(qc.preempt_tokens)

    def remaining(self, qc: QuotaClass, now: float) -> float:
        self._roll(qc, now)
        return max(0.0, self.tokens.get(qc.name, 0.0))

    def take_token(self, qc: QuotaClass, now: float) -> bool:
        """Consume one preemption token from ``qc``'s bucket (the class
        about to SUFFER the preemption); False when the window budget is
        exhausted — the caller must not preempt."""
        if self.remaining(qc, now) < 1.0:
            return False
        self.tokens[qc.name] -= 1.0
        return True

    def to_dict(self) -> dict:
        return {
            "deficit_since": {k: float(v)
                              for k, v in sorted(self.deficit_since.items())},
            "tokens": {k: float(v) for k, v in sorted(self.tokens.items())},
            "window_start": {k: float(v)
                             for k, v in sorted(self.window_start.items())},
        }

    @classmethod
    def from_dict(cls, doc: Optional[dict]) -> "AdmissionState":
        doc = doc or {}

        def _m(key):
            out = {}
            for k, v in (doc.get(key) or {}).items():
                try:
                    out[str(k)] = float(v)
                except (TypeError, ValueError):
                    continue
            return out

        return cls(deficit_since=_m("deficit_since"), tokens=_m("tokens"),
                   window_start=_m("window_start"))


# --- batch ordering policies ------------------------------------------------

def _item_cost(spec, policy: str, dominant_tflops: float) -> float:
    chips = max(1, int(spec.chips_needed() or 1))
    if policy == POLICY_THROUGHPUT:
        return chips * max(1.0, dominant_tflops)
    return float(chips)


def order_batch(items: List[tuple], policy: str,
                tree: Optional[QuotaTree],
                usage: Optional[Dict[str, int]] = None,
                usage_tflops: Optional[Dict[str, float]] = None,
                dominant_tflops: float = 1.0) -> List[tuple]:
    """Order one gang-pass batch of ``(key, cr, live, spec)`` items.

    ``priority`` (or no quota tree) returns the batch UNCHANGED — the
    caller already drains in baseline order, which keeps the kill switch
    byte-identical to the legacy gang pass. The fair policies interleave
    classes least-attained-first: pick the class with the smallest
    attained-service-per-weight, admit its best item, charge the class
    for it, repeat — finish-time fairness measured in chips, throughput
    fairness in chips x generation-peak-TFLOPs."""
    if policy == POLICY_BASELINE or tree is None or len(items) <= 1:
        return list(items)
    attained: Dict[str, float] = {}
    base = usage_tflops if policy == POLICY_THROUGHPUT else usage
    for name in tree.leaf_names():
        qc = tree.get(name)
        w = qc.weight if qc.weight > 0 else 1e-9
        attained[name] = float((base or {}).get(name, 0.0)) / w
    queues: Dict[str, List[tuple]] = {}
    for item in items:
        key, cr, _live, _spec = item
        queues.setdefault(tree.class_of(cr), []).append(item)
    for name, q in queues.items():
        q.sort(key=lambda it: baseline_key(it[0], it[1], it[3]))
        attained.setdefault(name, 0.0)
    out: List[tuple] = []
    while any(queues.values()):
        name = min((n for n in sorted(queues) if queues[n]),
                   key=lambda n: (attained[n], n))
        item = queues[name].pop(0)
        out.append(item)
        qc = tree.get(name)
        w = qc.weight if qc.weight > 0 else 1e-9
        attained[name] += _item_cost(item[3], policy, dominant_tflops) / w
    return out


# --- shared quota report (/debug/quota) -------------------------------------

def _capacity_chips(nodes) -> int:
    """GPU cards the placement engine could ever offer, using the SAME
    per-node chip extraction the scorer uses (lazy import — topology
    pulls in the scoring stack)."""
    from ..topology.placement import _node_chips

    return sum(max(0, int(_node_chips(n) or 0)) for n in nodes)


def quota_report(client, namespace: str,
                 tree: Optional[QuotaTree] = None,
                 state: Optional[AdmissionState] = None,
                 policy: Optional[str] = None,
                 now: Optional[Callable[[], float]] = None) -> dict:
    """The quota explainer document: per-leaf usage/queued/share/deficit
    /budget plus the breached list. Pure function of the cluster (tree
    and live admission state optional — a must-gather has neither, so
    deficits render as unknown there, never as fabricated zeros)."""
    from ..api.slicerequest import (KIND_SLICE_REQUEST, PHASE_PLACED,
                                    V1ALPHA1 as SR_API)

    if tree is None:
        tree = QuotaTree.load(client, namespace)
    if tree is None:
        return {"configured": False, "classes": [], "breached": [],
                "policy": policy or ADMISSION_GATE.policy}
    clock = now or time.time
    t = float(clock())
    usage: Dict[str, int] = {}
    queued: Dict[str, int] = {}
    queued_requests: Dict[str, int] = {}
    for cr in client.list(SR_API, KIND_SLICE_REQUEST):
        cls_name = tree.class_of(cr)
        phase = get_nested(cr, "status", "phase", default="") or ""
        if phase == PHASE_PLACED:
            usage[cls_name] = usage.get(cls_name, 0) + int(
                get_nested(cr, "status", "chips", default=0) or 0)
        else:
            from ..api.slicerequest import SliceRequestSpec

            spec = SliceRequestSpec.from_obj(cr)
            queued[cls_name] = (queued.get(cls_name, 0)
                                + int(spec.chips_needed() or 0))
            queued_requests[cls_name] = queued_requests.get(cls_name, 0) + 1
    capacity = _capacity_chips(client.list("v1", "Node"))
    demand = {n: usage.get(n, 0) + queued.get(n, 0)
              for n in tree.leaf_names()}
    shares = tree.shares(capacity, demand)
    deficits = (state.observe(tree, usage, queued, t)
                if state is not None else None)
    rows, breached = [], []
    for name in tree.leaf_names():
        qc = tree.get(name)
        row = {
            "class": name,
            "weight": qc.weight,
            "minChips": qc.min_chips,
            "maxChips": qc.max_chips,
            "usageChips": usage.get(name, 0),
            "queuedChips": queued.get(name, 0),
            "queuedRequests": queued_requests.get(name, 0),
            "shareChips": shares.get(name, 0),
            "starvationBoundSeconds": (
                None if math.isinf(qc.starvation_bound_s)
                else qc.starvation_bound_s),
            "preemptTokens": qc.preempt_tokens,
            "preemptWindowSeconds": qc.preempt_window_s,
        }
        if deficits is not None:
            row["deficitSeconds"] = round(deficits.get(name, 0.0), 3)
            row["tokensRemaining"] = state.remaining(qc, t)
            if deficits.get(name, 0.0) > qc.starvation_bound_s:
                row["starving"] = True
                breached.append(name)
        rows.append(row)
    return {"configured": True,
            "policy": policy or ADMISSION_GATE.policy,
            "capacityChips": capacity,
            "classes": rows,
            "breached": sorted(breached)}
