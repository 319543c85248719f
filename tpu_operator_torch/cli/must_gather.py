"""Diagnostic bundle collection (hack/must-gather.sh analog).

    gpuop-must-gather [-o DIR] [--kubeconfig PATH | --fake-demo]

The port's counterpart of ``tpu_operator/cli/must_gather.py``. Dumps
everything a support engineer needs into a directory tree: the CRs with
status/conditions, operand DaemonSets + pods, GPU node labels and
upgrade states, the fleet telemetry rollup (fleet/fleet.json, the same
``rollup_nodes`` as ``/debug/fleet``), operator metrics
(metrics/metrics.prom), the reconcile flight recorder
(traces/traces.json), the federation picture (federation/cells.json,
the SliceRequests grouped by cell pin: the ``gpuop-cfg cells -f``
input), and the validator barrier files when run on a node. PyYAML is
imported where the bundle is written.
"""

from __future__ import annotations

import argparse
import json
import logging
import pathlib
import sys

from ..runtime.objects import yaml_module

log = logging.getLogger("gpuop-must-gather")

DUMP_KINDS = [
    ("gpu.graft.dev/v1", "GPUClusterPolicy", "crs"),
    ("gpu.graft.dev/v1alpha1", "GPUDriver", "crs"),
    ("v1", "Node", "nodes"),
    ("apps/v1", "DaemonSet", "operands"),
    ("v1", "Pod", "pods"),
    ("v1", "ConfigMap", "config"),
    ("v1", "Service", "operands"),
    # drains block on these; a stuck upgrade is unreadable without them
    ("policy/v1", "PodDisruptionBudget", "upgrade"),
    ("coordination.k8s.io/v1", "Lease", "leader"),
    # the operator's decision trail (upgrade transitions, CR state
    # changes) — the first thing support reads in a bundle
    ("v1", "Event", "events"),
]


def _upgrade_report(nodes_list) -> dict:
    """Per-node upgrade FSM digest: state label, stage deadline stamps,
    failure reason, cordon — the first thing support needs for a stuck
    or failed rollout. Derived from an already-listed Node snapshot so
    the report and the nodes/ dump cannot diverge."""
    from ..api import labels as L

    nodes = {}
    for node in nodes_list:
        meta = node.get("metadata", {})
        labels = meta.get("labels") or {}
        anns = meta.get("annotations") or {}
        entry = {}
        if L.UPGRADE_STATE in labels:
            entry["state"] = labels[L.UPGRADE_STATE]
        for key, name in ((L.UPGRADE_STAGE_STARTED, "stageStarted"),
                          (L.UPGRADE_FAILED_AT, "failedAt"),
                          (L.UPGRADE_FAILED_REASON, "failedReason"),
                          (L.DRIVER_UPGRADE_ENABLED, "upgradeEnabled")):
            if key in anns:
                entry[name] = anns[key]
        if (node.get("spec") or {}).get("unschedulable"):
            entry["cordoned"] = True
        if entry:
            nodes[meta.get("name", "unnamed")] = entry
    return nodes


def gather(client, out_dir: pathlib.Path) -> dict:
    yaml = yaml_module()

    summary = {"kinds": {}, "errors": []}
    for api_version, kind, subdir in DUMP_KINDS:
        try:
            objs = client.list(api_version, kind)
        except Exception as e:
            summary["errors"].append(f"list {kind}: {e}")
            continue
        if kind == "Node":
            # the upgrade report derives from the SAME snapshot the
            # nodes/ dump writes (one LIST, no divergence)
            try:
                report = _upgrade_report(objs)
                if report:
                    d = out_dir / "upgrade"
                    d.mkdir(parents=True, exist_ok=True)
                    (d / "upgrade-report.yaml").write_text(
                        yaml.safe_dump(report, sort_keys=True))
                    summary["upgrade_nodes"] = len(report)
            except Exception as e:
                summary["errors"].append(f"upgrade report: {e}")
            # the fleet telemetry plane, from the SAME Node snapshot:
            # the rollup (the `gpuop-cfg top -f` input) plus each
            # node's raw health digest for chip-level drill-down
            try:
                from ..api import labels as L
                from ..metrics.fleet import rollup_nodes

                d = out_dir / "fleet"
                d.mkdir(parents=True, exist_ok=True)
                (d / "fleet.json").write_text(
                    json.dumps(rollup_nodes(objs), indent=2,
                               sort_keys=True))
                dd = d / "digests"
                count = 0
                for node in objs:
                    meta = node.get("metadata", {})
                    raw = (meta.get("annotations") or {}).get(
                        L.HEALTH_DIGEST)
                    if not raw:
                        continue
                    dd.mkdir(parents=True, exist_ok=True)
                    (dd / f"{meta.get('name', 'unnamed')}.json"
                     ).write_text(raw)
                    count += 1
                summary["fleet_digests"] = count
            except Exception as e:
                summary["errors"].append(f"fleet: {e}")
        d = out_dir / subdir
        d.mkdir(parents=True, exist_ok=True)
        for obj in objs:
            name = obj.get("metadata", {}).get("name", "unnamed")
            ns = obj.get("metadata", {}).get("namespace", "")
            fname = f"{kind.lower()}_{ns + '_' if ns else ''}{name}.yaml"
            (d / fname).write_text(yaml.safe_dump(obj, sort_keys=False))
        summary["kinds"][kind] = len(objs)

    # node-local barrier state, when run on a GPU node
    from ..validator import barrier

    vd = barrier.validation_dir()
    if vd.is_dir():
        d = out_dir / "node-local"
        d.mkdir(parents=True, exist_ok=True)
        for f in sorted(vd.iterdir()):
            if f.is_file():
                (d / f.name).write_text(f.read_text())
        summary["validation_files"] = sorted(
            f.name for f in vd.iterdir() if f.is_file())

    # the operator's own observability: the /metrics exposition and the
    # flight recorder, so a bundle carries the latency/trace evidence,
    # not just API objects (the docstring's "operator metrics" promise)
    try:
        from ..metrics.registry import render_prometheus

        d = out_dir / "metrics"
        d.mkdir(parents=True, exist_ok=True)
        (d / "metrics.prom").write_text(render_prometheus())
        summary["metrics_rendered"] = True
    except Exception as e:
        summary["errors"].append(f"metrics: {e}")
    try:
        from ..runtime.tracing import TRACER

        d = out_dir / "traces"
        d.mkdir(parents=True, exist_ok=True)
        traces = TRACER.traces()
        (d / "traces.json").write_text(
            json.dumps({"count": len(traces), "traces": traces},
                       indent=2, sort_keys=True))
        summary["traces"] = len(traces)
    except Exception as e:
        summary["errors"].append(f"traces: {e}")
    try:
        from ..runtime.timeline import TIMELINE

        snap = TIMELINE.snapshot()
        d = out_dir / "timeline"
        d.mkdir(parents=True, exist_ok=True)
        # one snapshot file (the `gpuop-cfg why -f` input) — per-object
        # files would explode on a large fleet
        (d / "timeline.json").write_text(
            json.dumps(snap, indent=2, sort_keys=True))
        summary["timeline_objects"] = len(snap)
    except Exception as e:
        summary["errors"].append(f"timeline: {e}")
    try:
        from ..metrics.slo import SLO_ENGINE

        d = out_dir / "slo"
        d.mkdir(parents=True, exist_ok=True)
        (d / "slo.json").write_text(
            json.dumps(SLO_ENGINE.evaluate(), indent=2, sort_keys=True))
        summary["slo_rendered"] = True
    except Exception as e:
        summary["errors"].append(f"slo: {e}")
    try:
        # the fair-share admission picture (the `gpuop-cfg quota -f`
        # input). A bundle has no live AdmissionState, so deficit clocks
        # render as unknown rather than fabricated zeros; shares/usage/
        # queued still explain who is entitled to what
        from ..scheduling.quota import quota_report

        d = out_dir / "quota"
        d.mkdir(parents=True, exist_ok=True)
        (d / "quota.json").write_text(
            json.dumps(quota_report(client, "gpu-operator"),
                       indent=2, sort_keys=True))
        summary["quota_rendered"] = True
    except Exception as e:
        summary["errors"].append(f"quota: {e}")
    try:
        # the federation picture (the `gpuop-cfg cells -f` input): the
        # SliceRequest fleet grouped by cell pin. A bundle has no live
        # GlobalRouter, so breaker states aren't fabricated — the
        # cluster-derived half (pins, phases, unrouted queue) still
        # explains where every request is bound
        from ..federation.router import cells_report

        d = out_dir / "federation"
        d.mkdir(parents=True, exist_ok=True)
        (d / "cells.json").write_text(
            json.dumps(cells_report(client, "default"),
                       indent=2, sort_keys=True))
        summary["federation_rendered"] = True
    except Exception as e:
        summary["errors"].append(f"federation: {e}")
    try:
        # the live-resharding picture: one file per request with a
        # non-terminal or byte-accounted migration — the handshake
        # phase, the path taken (sharded-handoff vs full-checkpoint),
        # the byte/shard bill, and the acked shard layout the planner
        # worked from. This is the reshard plan a support bundle needs
        # to explain "why did this resize move N bytes"
        from ..api.slicerequest import KIND_SLICE_REQUEST, V1ALPHA1
        from ..runtime.objects import (
            get_nested,
            name_of,
            namespace_of,
        )

        d = out_dir / "reshard"
        plans = 0
        for cr in sorted(client.list(V1ALPHA1, KIND_SLICE_REQUEST),
                         key=lambda c: (namespace_of(c), name_of(c))):
            mig = get_nested(cr, "status", "migration",
                             default={}) or {}
            if not mig:
                continue
            d.mkdir(parents=True, exist_ok=True)
            doc = {
                "namespace": namespace_of(cr) or "default",
                "name": name_of(cr),
                "phase": mig.get("phase", ""),
                "path": mig.get("path", ""),
                "bytesMoved": mig.get("bytesMoved"),
                "shardsMoved": mig.get("shardsMoved"),
                "ackedStep": mig.get("ackedStep"),
                "restoredStep": mig.get("restoredStep"),
                "layout": mig.get("layout"),
            }
            (d / f"{doc['namespace']}_{doc['name']}.json").write_text(
                json.dumps(doc, indent=2, sort_keys=True))
            plans += 1
        summary["reshard_plans"] = plans
    except Exception as e:
        summary["errors"].append(f"reshard: {e}")
    try:
        # the informer-cache picture (/debug/cache equivalent): unwrap
        # the client stack the same way Manager.find_cache does
        inner, stats = client, None
        for _ in range(8):
            if hasattr(inner, "cache_stats"):
                stats = inner.cache_stats()
                break
            nxt = getattr(inner, "inner", None)
            if nxt is None:
                break
            inner = nxt
        if stats is not None:
            d = out_dir / "cache"
            d.mkdir(parents=True, exist_ok=True)
            (d / "cache.json").write_text(
                json.dumps(stats, indent=2, sort_keys=True))
            summary["cache_rendered"] = True
    except Exception as e:
        summary["errors"].append(f"cache: {e}")
    try:
        # the durable-snapshot plane (/debug/snapshot equivalent, the
        # `gpuop-cfg snapshot -f` input): metadata only — object
        # payloads stay on the operator's disk
        from ..runtime.snapshot import env_snapshot_dir, snapshot_metadata

        d = out_dir / "snapshot"
        d.mkdir(parents=True, exist_ok=True)
        (d / "snapshot.json").write_text(
            json.dumps(snapshot_metadata(env_snapshot_dir()),
                       indent=2, sort_keys=True))
        summary["snapshot_rendered"] = True
    except Exception as e:
        summary["errors"].append(f"snapshot: {e}")

    (out_dir / "summary.json").write_text(json.dumps(summary, indent=2))
    return summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gpuop-must-gather")
    p.add_argument("-o", "--output", default="must-gather")
    p.add_argument("--kubeconfig", default=None)
    p.add_argument("--fake-demo", action="store_true",
                   help="gather from an in-memory demo cluster (self-test)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    if args.fake_demo:
        from ..api.clusterpolicy import new_cluster_policy
        from ..controllers.clusterpolicy_controller import (
            ClusterPolicyReconciler,
        )
        from ..runtime import FakeClient, Request
        from .operator import FAKE_NODE_ALLOCATABLE, FAKE_NODE_LABELS

        client = FakeClient()
        client.add_node("gpu-node-0", labels=FAKE_NODE_LABELS,
                        allocatable=FAKE_NODE_ALLOCATABLE)
        client.create(new_cluster_policy())
        ClusterPolicyReconciler(client=client, namespace="gpu-operator"
                                ).reconcile(Request(name="gpu-cluster-policy"))
    else:
        from ..runtime.kubeclient import HTTPClient, KubeConfig

        cfg = (KubeConfig.from_kubeconfig(args.kubeconfig)
               if args.kubeconfig else KubeConfig.load())
        client = HTTPClient(cfg)

    out = pathlib.Path(args.output)
    summary = gather(client, out)
    log.info("gathered %s into %s",
             {k: v for k, v in summary["kinds"].items() if v}, out)
    if summary["errors"]:
        for e in summary["errors"]:
            log.warning("%s", e)
    return 0


if __name__ == "__main__":
    sys.exit(main())
