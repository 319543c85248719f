"""gpuop-cfg: configuration + lifecycle tooling (cmd/gpuop-cfg analog,
plus the Helm-verb slot of deployments/gpu-operator/templates/*).

The port's counterpart of ``tpu_operator/cli/tpuop_cfg.py``; ``cells``
reads the federation router's ``/debug/cells`` (or a bundle's
``federation/cells.json``).
``status`` and ``top`` read the same ``rollup_nodes`` as ``/debug/fleet``
(domains keyed by nodepool, else ``{generation}-{gpu.topology}``);
``place``'s compact fleet fixture builds GPU nodes as the control-plane
benchmark's ``build_cluster`` does. PyYAML is imported where a command
reads or writes YAML.

    gpuop-cfg validate clusterpolicy -f policy.yaml
    gpuop-cfg validate gpudriver -f driver.yaml
    gpuop-cfg generate crds|operator|all|bundle|cleanup [-n NS] [--values f]
    gpuop-cfg diff [all] [--values f]
    gpuop-cfg install|upgrade [--values f] [--wait [--timeout 300]]
    gpuop-cfg uninstall [--purge-crds]
    gpuop-cfg trace [--url http://mgr:8080 | -f traces.json]
                    [--controller C] [--min-ms N] [--outcome error]
    gpuop-cfg cache [--url http://mgr:8080 | -f cache.json] [-o json]
    gpuop-cfg dag [-o json]
    gpuop-cfg place --fleet fleet.yaml --chips 8 [--explain] [-o json]
    gpuop-cfg slices [-n NS] [--migrations] [-o json]
    gpuop-cfg cells [--url http://mgr:8080 | -f cells.json|bundle/] [-o json]

``validate`` checks a CR offline: YAML wellformedness, kind/apiVersion,
schema conformance against the generated CRD (unknown fields, wrong
types, enum violations), CEL rule conformance, and that every operand
image reference is resolvable to a concrete path
(cmd/gpuop-cfg/validate/clusterpolicy/images.go analog — without the
registry round-trip, which needs network).

``install/upgrade/uninstall`` are the one-command lifecycle the
reference gets from its Helm chart: render the full stream from values,
apply it in install order (CRDs -> namespace -> RBAC -> operator -> CR),
optionally block until every GPUClusterPolicy is ready; uninstall
sequences CR teardown before the operator exits, like the pre-delete
hook Job (templates/cleanup_crd.yaml).
"""

from __future__ import annotations

import argparse
import json
import sys

from ..api.clusterpolicy import KIND_CLUSTER_POLICY
from ..api.gpudriver import KIND_GPU_DRIVER
from ..api.validate import validate_cr  # noqa: F401  (re-export; library home)
from ..runtime.objects import yaml_module


def _generate_docs(args):
    """Resolve a generate invocation to a manifest stream, or None on a
    values error (already printed)."""
    yaml = yaml_module()

    from ..deploy import values as values_mod
    from ..deploy.packaging import generate

    namespace = args.namespace or "gpu-operator"
    # CRD output is values-independent: never gate it on a values file
    if (args.values or args.what in ("bundle", "cleanup")) \
            and args.what != "crds":
        try:
            vals = values_mod.load_values(args.values or None)
            if args.namespace is not None:
                vals["namespace"] = namespace
            if args.image:
                print("--image is ignored with --values/bundle "
                      "(set operator.{repository,image,version})",
                      file=sys.stderr)
            if args.what == "bundle":
                from ..deploy.csv import render_bundle_stream

                return render_bundle_stream(vals)
            if args.what == "cleanup":
                return values_mod.render_cleanup(vals)
            if (vals.get("operator") or {}).get("cleanupCRD"):
                print("note: cleanupCRD is set — the pre-delete cleanup "
                      "Job is not part of the install stream (plain apply "
                      "would run it at install time); emit it at "
                      "uninstall with `gpuop-cfg generate cleanup`",
                      file=sys.stderr)
            return values_mod.render_bundle(
                vals, include_crds=(args.what == "all"))
        except (OSError, ValueError, yaml.YAMLError) as e:
            print(f"INVALID values: {e}", file=sys.stderr)
            return None
    return generate(args.what, namespace=namespace, image=args.image)


def _status_report(client, namespace: str) -> dict:
    """Gather the install-health picture into one plain dict — the single
    source both status renderers (text and -o json) read, so they cannot
    disagree about readiness."""
    from ..api import labels as L
    from ..api.clusterpolicy import V1
    from ..api.gpudriver import V1ALPHA1
    from ..runtime.client import ListOptions, NotFoundError
    from ..runtime.objects import get_nested, labels_of, name_of
    from ..state.skel import daemonset_ready

    # shape is stable across cluster states (nodes.gpu always an int,
    # upgradeStates always a map) — the -o json contract consumers
    # script against must not vary in exactly the failure cases
    report: dict = {"crs": [], "operands": [],
                    "nodes": {"gpu": 0, "upgradeStates": {}},
                    "ready": True}
    for av, kind in ((V1, KIND_CLUSTER_POLICY), (V1ALPHA1, KIND_GPU_DRIVER)):
        try:
            crs = client.list(av, kind)
        except NotFoundError:
            continue
        for cr in crs:
            state = get_nested(cr, "status", "state", default="unset")
            report["ready"] = report["ready"] and state == "ready"
            slices = get_nested(cr, "status", "slices", default=[]) or []
            for row in slices:
                report["ready"] = (report["ready"]
                                   and bool(row.get("validated")))
            report["crs"].append({
                "kind": kind,
                "name": name_of(cr),
                "state": state,
                "message": next(
                    (c.get("message", "") for c in
                     get_nested(cr, "status", "conditions",
                                default=[]) or []
                     if c.get("type") == "Ready"), ""),
                "clusterInfo": get_nested(cr, "status", "clusterInfo",
                                          default=None),
                "slices": slices,
            })
    nodes = list(client.list("v1", "Node"))
    for node in nodes:
        nl = labels_of(node)
        if L.PRESENT in nl:
            report["nodes"]["gpu"] += 1
        s = nl.get(L.UPGRADE_STATE)
        if s:
            states = report["nodes"]["upgradeStates"]
            states[s] = states.get(s, 0) + 1
    # one-line fleet health: same rollup formula /debug/fleet and
    # `top` use, collapsed to the numbers an on-call scans first
    from ..metrics.fleet import rollup_nodes
    roll = rollup_nodes(nodes)
    report["fleet"] = {
        "degradedChips": roll["totals"]["degraded_chips"],
        "chips": roll["totals"]["chips"],
        "reporting": roll["totals"]["reporting"],
        "condemned": roll["totals"]["condemned"],
        "worstDomain": roll["worst_domain"],
    }

    if not report["crs"]:
        report["ready"] = False
        return report

    dss = client.list("apps/v1", "DaemonSet", ListOptions(
        namespace=namespace,
        label_selector={"matchExpressions": [
            {"key": L.STATE_LABEL, "operator": "Exists"}]}))
    for ds in sorted(dss, key=name_of):
        ok, why = daemonset_ready(ds)
        status = ds.get("status") or {}
        report["operands"].append({
            "name": name_of(ds),
            "ready": ok,
            "numberReady": status.get("numberReady", 0),
            "desired": status.get("desiredNumberScheduled", 0),
            "reason": "" if ok else why,
        })
        report["ready"] = report["ready"] and ok
    return report


def _print_status_text(report: dict) -> None:
    for cr in report["crs"]:
        msg = cr["message"]
        print(f"{cr['kind']}/{cr['name']}: {cr['state']}"
              + (f" — {msg}" if msg else ""))
        info = cr["clusterInfo"]
        if info:
            print(f"  cluster: k8s {info.get('kubernetesVersion')}"
                  f", {info.get('containerRuntime')}, "
                  f"topologies {info.get('gpuTopologies')}, "
                  f"generations {info.get('gpuGenerations')}")
        # one readable row per multi-host pool (status.slices[]): an
        # NVL72 domain is one line, not 18 node lines
        for row in cr["slices"]:
            up = row.get("upgradeState")
            print(f"  slice {row.get('id')}"
                  f" [{row.get('accelerator')} {row.get('topology')}]: "
                  f"{row.get('hostsValidated', 0)}/"
                  f"{row.get('hosts', 0)} hosts validated"
                  + (f", upgrade {up}" if up else ""))
    for op in report["operands"]:
        print(f"  {op['name']}: {op['numberReady']}/{op['desired']} ready"
              + ("" if op["ready"] else f" ({op['reason']})"))
    nodes = report["nodes"]
    upgrade = nodes.get("upgradeStates") or {}
    print(f"nodes: {nodes.get('gpu', 0)} GPU"
          + (f", upgrade states {upgrade}" if upgrade else ""))
    fleet = report.get("fleet")
    if fleet and fleet.get("chips"):
        worst = fleet.get("worstDomain") or ""
        print(f"fleet health: {fleet.get('degradedChips', 0)}/"
              f"{fleet.get('chips', 0)} cards degraded, "
              f"{fleet.get('condemned', 0)} nodes condemned"
              + (f", worst domain {worst}" if worst else ""))
    cache = report.get("operatorCache")
    if cache:
        if cache.get("degraded"):
            print(f"operator cache: DEGRADED — serving reads "
                  f"{cache.get('staleness_s', 0):.0f}s stale "
                  f"({cache.get('sync_failures', 0)} consecutive "
                  f"apiserver sync failures)")
        else:
            print("operator cache: healthy")
    print("READY" if report["ready"] else "NOT READY")


def _status(args) -> int:
    """One-shot install health (kubectl-get rolled into the operator's
    own vocabulary): CR states + ready conditions, per-slice rows
    (status.slices[]), per-operand DaemonSet readiness, node
    upgrade-state histogram, cluster facts. Exit 0 only when every CR
    reports ready, every listed multi-host slice is validated, and every
    operand DaemonSet is ready — scriptable like `helm status`, with
    ``-o json`` emitting the same picture as one machine-readable
    object."""
    from ..runtime.kubeclient import HTTPClient, KubeConfig

    as_json = getattr(args, "output", "text") == "json"

    def fail_json(e: Exception) -> int:
        # -o json promises one machine-readable object on STDOUT for
        # every outcome — scripts parse `gpuop-cfg status -o json` and a
        # stderr-only failure would hand them an empty document. The
        # human diagnostic still goes to stderr.
        print(json.dumps({"ready": False,
                          "error": f"{type(e).__name__}: {e}"},
                         indent=2, sort_keys=True))
        return 1

    try:
        client = HTTPClient(KubeConfig.load())
    except Exception as e:
        print(f"cannot reach the cluster: {e}", file=sys.stderr)
        return fail_json(e) if as_json else 1

    try:
        report = _status_report(client, args.namespace)
        # best-effort degraded-mode probe against the manager's debug
        # port: an apiserver brownout is exactly when an operator runs
        # `status`, so the breaker state belongs in this picture — but
        # status must keep working with no manager reachable
        if getattr(args, "operator_url", None):
            import urllib.request

            url = args.operator_url.rstrip("/") + "/debug/cache"
            try:
                with urllib.request.urlopen(url, timeout=5.0) as resp:
                    cs = json.load(resp)
                report["operatorCache"] = {
                    "degraded": bool(cs.get("degraded")),
                    "staleness_s": cs.get("staleness_s", 0),
                    "sync_failures": cs.get("sync_failures", 0),
                }
            except Exception as e:
                print(f"warning: cannot probe operator cache at {url}: "
                      f"{e}", file=sys.stderr)
        if as_json:
            print(json.dumps(report, indent=2, sort_keys=True))
            return 0 if report["ready"] else 1
        if not report["crs"]:
            print("no GPUClusterPolicy/GPUDriver CRs found")
            return 1
        _print_status_text(report)
        return 0 if report["ready"] else 1
    except Exception as e:
        print(f"status failed: {type(e).__name__}: {e}", file=sys.stderr)
        return fail_json(e) if as_json else 1


def _slices_report(client, namespace: str) -> dict:
    """Gather every SliceRequest (one namespace or all) into one plain
    dict — the single source both renderers (text and -o json) read.
    Each row carries the placement picture (phase, chips, nodes) plus
    the elastic-migration handshake state (status.migration + the
    intent/ack annotations), so `gpuop-cfg slices --migrations` is the
    operator-side view of a drain-safe resize in flight."""
    from ..api import labels as L
    from ..api.slicerequest import KIND_SLICE_REQUEST, V1ALPHA1
    from ..runtime.client import ListOptions, NotFoundError
    from ..runtime.objects import (annotations_of, get_nested, name_of,
                                   namespace_of)

    report: dict = {"requests": [], "migrationsTotal": 0}
    try:
        opts = ListOptions(namespace=namespace) if namespace else None
        crs = client.list(V1ALPHA1, KIND_SLICE_REQUEST, opts) \
            if opts else client.list(V1ALPHA1, KIND_SLICE_REQUEST)
    except NotFoundError:
        return report

    def _num(raw):
        try:
            return int(raw) if raw is not None else None
        except (TypeError, ValueError):
            return None

    for cr in sorted(crs, key=lambda c: (namespace_of(c), name_of(c))):
        anns = annotations_of(cr)
        mig = get_nested(cr, "status", "migration", default={}) or {}
        moves = int(get_nested(cr, "status", "migrations",
                               default=0) or 0)
        report["migrationsTotal"] += moves
        report["requests"].append({
            "namespace": namespace_of(cr) or "default",
            "name": name_of(cr),
            "phase": get_nested(cr, "status", "phase",
                                default="Pending") or "Pending",
            "chips": int(get_nested(cr, "status", "chips",
                                    default=0) or 0),
            "nodes": list(get_nested(cr, "status", "nodes",
                                     default=[]) or []),
            "elastic": anns.get(L.SLICE_ELASTIC) != "false",
            "migrations": moves,
            "migration": {
                "phase": mig.get("phase", ""),
                "intent": mig.get("intent")
                or anns.get(L.SLICE_INTENT) or "",
                "deadline": mig.get("deadline")
                or anns.get(L.SLICE_INTENT_DEADLINE) or "",
                "ackedStep": _num(mig.get("ackedStep",
                                          anns.get(L.SLICE_INTENT_ACK))),
                "restoredStep": _num(mig.get("restoredStep")),
                "from": list(mig.get("from") or []),
                "to": list(mig.get("to") or []),
                "reason": mig.get("reason", ""),
                "path": mig.get("path", ""),
                "bytesMoved": _num(mig.get("bytesMoved")),
                "shardsMoved": _num(mig.get("shardsMoved")),
            },
        })
    return report


def _print_slices_text(report: dict, migrations: bool) -> None:
    for row in report["requests"]:
        mig = row["migration"]
        line = (f"{row['namespace']}/{row['name']}: {row['phase']}"
                f", chips {row['chips']}"
                f", nodes {len(row['nodes'])}")
        if not row["elastic"]:
            line += ", elastic off"
        if row["migrations"]:
            line += f", migrations {row['migrations']}"
        if mig["phase"]:
            line += f", migration {mig['phase']}"
        print(line)
        if migrations and (mig["phase"] or mig["intent"]):
            if mig["intent"]:
                print(f"  intent: {mig['intent']}"
                      + (f" (deadline {mig['deadline']})"
                         if mig["deadline"] else ""))
            if mig["ackedStep"] is not None:
                print(f"  acked step: {mig['ackedStep']}")
            if mig["restoredStep"] is not None:
                print(f"  restored step: {mig['restoredStep']}")
            if mig["from"] or mig["to"]:
                print(f"  move: {', '.join(mig['from']) or '-'}"
                      f" -> {', '.join(mig['to']) or '-'}")
            if mig["path"]:
                line = f"  path: {mig['path']}"
                if mig["path"] == "sharded-handoff" \
                        and mig["bytesMoved"] is not None:
                    line += (f" ({mig['shardsMoved'] or 0} shard(s), "
                             f"{mig['bytesMoved']} bytes moved)")
                print(line)
            if mig["reason"]:
                print(f"  reason: {mig['reason']}")
    print(f"requests: {len(report['requests'])}, completed migrations: "
          f"{report['migrationsTotal']}")


def _slices(args) -> int:
    """SliceRequest fleet view: placement phase + binding per request,
    and with ``--migrations`` the live elastic handshake (intent,
    deadline, acked/restored steps, old->new binding, abort reason).
    Exit 0 whenever the listing succeeds — an in-flight migration is a
    normal state, not a failure."""
    from ..runtime.kubeclient import HTTPClient, KubeConfig

    as_json = getattr(args, "output", "text") == "json"

    def fail_json(e: Exception) -> int:
        print(json.dumps({"requests": [],
                          "error": f"{type(e).__name__}: {e}"},
                         indent=2, sort_keys=True))
        return 1

    try:
        client = HTTPClient(KubeConfig.load())
    except Exception as e:
        print(f"cannot reach the cluster: {e}", file=sys.stderr)
        return fail_json(e) if as_json else 1

    try:
        report = _slices_report(client, args.namespace)
        if as_json:
            print(json.dumps(report, indent=2, sort_keys=True))
            return 0
        if not report["requests"]:
            print("no SliceRequests found")
            return 0
        _print_slices_text(report, migrations=args.migrations)
        return 0
    except Exception as e:
        print(f"slices failed: {type(e).__name__}: {e}", file=sys.stderr)
        return fail_json(e) if as_json else 1


def _lifecycle(args) -> int:
    """install / upgrade / uninstall against the cluster KubeConfig.load()
    resolves (in-cluster SA or $KUBECONFIG) — the Helm-verb UX without
    Helm (VERDICT r3 #4: the one-command install artifact)."""
    yaml = yaml_module()

    from ..deploy import values as values_mod
    from ..runtime.kubeclient import HTTPClient, KubeConfig

    if args.image:
        print("--image is ignored by lifecycle verbs "
              "(set operator.{repository,image,version} in --values)",
              file=sys.stderr)
    try:
        vals = values_mod.load_values(args.values or None)
        if args.namespace is not None:
            vals["namespace"] = args.namespace
        docs = values_mod.render_bundle(vals, include_crds=True)
    except (OSError, ValueError, yaml.YAMLError) as e:
        print(f"INVALID values: {e}", file=sys.stderr)
        return 1
    try:
        client = HTTPClient(KubeConfig.load())
    except Exception as e:
        print(f"cannot reach the cluster: {e}", file=sys.stderr)
        return 1
    log = lambda s: print(s, file=sys.stderr)  # noqa: E731

    try:
        return _lifecycle_verbs(args, client, docs, log)
    except Exception as e:
        # request-time failures (apiserver down, RBAC deny, CRD not yet
        # established) must be a clean message + rc 1, not a traceback —
        # same contract as the diff subcommand
        print(f"{args.cmd} failed: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 1


def _lifecycle_verbs(args, client, docs, log) -> int:
    from ..deploy import apply as apply_mod

    if args.cmd == "uninstall":
        from .maintenance import cleanup

        ok = cleanup(client, timeout_s=args.timeout,
                     drop_crds=args.purge_crds)
        if not ok:
            # CRs stuck tearing down (finalizers): deleting the operator
            # (or the CRDs) now would strand them with nothing left to
            # finish the job — leave everything and have the admin re-run
            print("uninstall incomplete: CRs still present",
                  file=sys.stderr)
            return 1
        ns = next((d["metadata"]["name"] for d in docs
                   if d.get("kind") == "Namespace"), "gpu-operator")
        swept = apply_mod.sweep_operands(client, log, namespace=ns)
        keep = ("Namespace", "CustomResourceDefinition") \
            if not args.purge_crds else ("Namespace",)
        n = apply_mod.delete_docs(client, docs, log=log, keep_kinds=keep)
        print(f"uninstalled ({n + swept} objects deleted; namespace kept)")
        return 0

    if args.cmd == "upgrade":
        # pre-upgrade hook semantics: package managers don't upgrade
        # CRDs, so land schema changes before anything renders against
        # them (templates/upgrade_crd.yaml slot)
        from .maintenance import apply_crds

        apply_crds(client)
    summary = apply_mod.apply_docs(client, docs, log=log)
    created = sum(1 for v, _, _ in summary if v == "created")
    past = {"install": "installed", "upgrade": "upgraded"}[args.cmd]
    print(f"{past}: {created} created, "
          f"{len(summary) - created} configured")
    if args.wait:
        ok = apply_mod.wait_policy_ready(client, timeout_s=args.timeout,
                                         log=log)
        return 0 if ok else 1
    return 0


def render_trace(trace: dict) -> str:
    """One flight-recorder trace as an indented span tree (text)."""

    def ms(v) -> str:
        return f"{(v or 0.0) * 1000.0:.3f}ms"

    lines = []
    head = (f"trace #{trace.get('id')} {trace.get('controller')} "
            f"{trace.get('key')} outcome={trace.get('outcome')} "
            f"duration={ms(trace.get('duration_s'))}")
    if trace.get("queue_wait_s") is not None:
        head += f" queue_wait={ms(trace['queue_wait_s'])}"
    if trace.get("error"):
        head += f" error={trace['error']!r}"
    lines.append(head)

    def walk(span: dict, depth: int) -> None:
        line = (f"{'  ' * depth}{span.get('name')}  "
                f"{ms(span.get('duration_s'))}")
        tags = span.get("tags") or {}
        if tags:
            line += "  [" + " ".join(
                f"{k}={tags[k]}" for k in sorted(tags)) + "]"
        if span.get("error"):
            line += f"  !{span['error']}"
        lines.append(line)
        for child in span.get("children") or []:
            walk(child, depth + 1)

    root = trace.get("root")
    if root:
        walk(root, 1)
    return "\n".join(lines)


def _trace(args) -> int:
    """Fetch traces from a manager's /debug/traces (or a dumped
    traces.json) and print them as indented span trees."""
    import pathlib
    import urllib.parse
    import urllib.request

    if args.file:
        try:
            data = json.loads(pathlib.Path(args.file).read_text())
        except (OSError, ValueError) as e:
            print(f"cannot read traces from {args.file}: {e}",
                  file=sys.stderr)
            return 1
        traces = data.get("traces", []) if isinstance(data, dict) else data
        # the server-side filters, applied client-side for files
        if args.controller:
            traces = [t for t in traces
                      if t.get("controller") == args.controller]
        if args.min_ms is not None:
            traces = [t for t in traces
                      if (t.get("duration_s") or 0) * 1000.0 >= args.min_ms]
        if args.outcome:
            traces = [t for t in traces if t.get("outcome") == args.outcome]
        if args.limit:
            traces = traces[:args.limit]
    else:
        params = {}
        if args.controller:
            params["controller"] = args.controller
        if args.min_ms is not None:
            params["min_ms"] = str(args.min_ms)
        if args.outcome:
            params["outcome"] = args.outcome
        if args.limit:
            params["limit"] = str(args.limit)
        url = args.url.rstrip("/") + "/debug/traces"
        if params:
            url += "?" + urllib.parse.urlencode(params)
        try:
            with urllib.request.urlopen(url, timeout=args.timeout) as resp:
                data = json.load(resp)
        except Exception as e:
            print(f"cannot fetch {url}: {e}", file=sys.stderr)
            return 1
        traces = data.get("traces", [])

    if args.id is not None:
        traces = [t for t in traces if t.get("id") == args.id]
    if not traces:
        print("no traces matched")
        return 0
    print("\n\n".join(render_trace(t) for t in traces))
    return 0


def render_cache_stats(stats: dict) -> str:
    """The /debug/cache body as a human-readable table: one row per
    cached kind with object count, measured store bytes (and what the
    full objects would have cost when the kind is projected), index
    bucket counts, and per-store relists."""

    def human(n) -> str:
        n = float(n or 0)
        for unit in ("B", "KiB", "MiB", "GiB"):
            if n < 1024.0 or unit == "GiB":
                return (f"{n:.0f}{unit}" if unit == "B"
                        else f"{n:.1f}{unit}")
            n /= 1024.0
        return f"{n:.1f}GiB"  # pragma: no cover - unreachable

    lines = [
        f"projection: {'on' if stats.get('projection_enabled') else 'off'}"
        f", relist chunk: {stats.get('relist_chunk')}"
        f", cache reads: {stats.get('cache_reads')}"
        f", relists: {stats.get('relists')}"]
    for gvk, st in sorted((stats.get("kinds") or {}).items()):
        line = (f"{gvk}: {st.get('objects')} objects"
                f", {human(st.get('bytes'))}")
        if st.get("projected"):
            line += (f" projected ({human(st.get('full_bytes'))} full)")
        if st.get("relists"):
            line += f", {st['relists']} relists"
        lines.append(line)
        idx = st.get("indexes") or {}
        if idx:
            lines.append("  indexes: " + ", ".join(
                f"{name}={n}" for name, n in sorted(idx.items())))
    return "\n".join(lines)


def _cache(args) -> int:
    """Fetch the manager's /debug/cache snapshot (or a must-gather
    cache.json) and print the per-kind store picture: object counts,
    measured projected-vs-full bytes, index buckets, relists."""
    import pathlib
    import urllib.request

    if args.file:
        try:
            stats = json.loads(pathlib.Path(args.file).read_text())
        except (OSError, ValueError) as e:
            print(f"cannot read cache stats from {args.file}: {e}",
                  file=sys.stderr)
            return 1
    else:
        url = args.url.rstrip("/") + "/debug/cache"
        try:
            with urllib.request.urlopen(url, timeout=args.timeout) as resp:
                stats = json.load(resp)
        except Exception as e:
            print(f"cannot fetch {url}: {e}", file=sys.stderr)
            return 1
    if not isinstance(stats, dict):
        print("cache stats payload is not an object", file=sys.stderr)
        return 1
    if getattr(args, "output", "text") == "json":
        print(json.dumps(stats, indent=2, sort_keys=True))
        return 0
    print(render_cache_stats(stats))
    return 0


def render_snapshot_meta(meta: dict) -> str:
    """The /debug/snapshot body (snapshot.snapshot_metadata) as a
    human-readable report: plane on/off, files on disk, the newest
    valid snapshot's stamps and per-kind counts, last restore
    outcome."""
    if not meta.get("enabled"):
        return "snapshot plane: disabled (OPERATOR_SNAPSHOT_DIR unset)"
    lines = [f"snapshot dir: {meta.get('dir')}"]
    files = meta.get("snapshots") or []
    lines.append(f"files on disk: {len(files)}")
    for row in files:
        lines.append(f"  {row.get('path')} ({row.get('bytes', 0)}B)")
    latest = meta.get("latest")
    if latest:
        lines.append(
            f"latest valid: schema {latest.get('schema')}, "
            f"age {latest.get('age_s', 0):.0f}s"
            + (", has index" if latest.get("has_index") else ""))
        objs = latest.get("objects") or {}
        total = sum(objs.values())
        lines.append(f"  {total} objects across {len(objs)} kinds:")
        for gvk, n in sorted(objs.items()):
            lines.append(f"    {gvk}: {n}")
    else:
        lines.append("latest valid: none (no trustworthy snapshot "
                     "on disk — next start is cold)")
    restore = (meta.get("last_restore")
               or meta.get("last_restore_in_memory"))
    if restore:
        lines.append("last restore: " + ", ".join(
            f"{k}={restore[k]}" for k in sorted(restore)))
    return "\n".join(lines)


def _snapshot(args) -> int:
    """Report the durable-snapshot plane: newest valid snapshot on
    disk, its age/schema/per-kind object counts, and the last warm
    restore's outcome — from the manager's /debug/snapshot, a local
    snapshot directory (--dir, no manager needed), or a must-gather
    snapshot.json."""
    import pathlib
    import urllib.request

    if args.file:
        try:
            meta = json.loads(pathlib.Path(args.file).read_text())
        except (OSError, ValueError) as e:
            print(f"cannot read snapshot metadata from {args.file}: {e}",
                  file=sys.stderr)
            return 1
    elif args.dir:
        from ..runtime.snapshot import snapshot_metadata

        meta = snapshot_metadata(args.dir)
    else:
        url = args.url.rstrip("/") + "/debug/snapshot"
        try:
            with urllib.request.urlopen(url, timeout=args.timeout) as resp:
                meta = json.load(resp)
        except Exception as e:
            print(f"cannot fetch {url}: {e}", file=sys.stderr)
            return 1
    if not isinstance(meta, dict):
        print("snapshot metadata payload is not an object", file=sys.stderr)
        return 1
    if getattr(args, "output", "text") == "json":
        print(json.dumps(meta, indent=2, sort_keys=True))
        return 0
    print(render_snapshot_meta(meta))
    return 0


def render_timeline(payload: dict) -> str:
    """One object's /debug/timeline body as the causal story `why`
    tells: each event with its timestamp, detail, and the cause chain
    (reason, origin object, and the trace id of the reconcile whose
    write fired it) indented under it."""
    events = payload.get("events") or []
    lines = [f"{payload.get('kind')}/{payload.get('name')} — "
             f"{len(events)} event(s)"]
    for ev in events:
        detail = ev.get("detail") or {}
        detail_s = " ".join(f"{k}={detail[k]}" for k in sorted(detail))
        lines.append(f"  t={ev.get('ts', 0):>10.3f}  "
                     f"{ev.get('event', ''):<22s} {detail_s}".rstrip())
        for cause in ev.get("causes") or []:
            line = f"      <- {cause.get('reason', '')}"
            if cause.get("origin"):
                line += f" {cause['origin']}"
            if cause.get("trace_id", -1) >= 0:
                line += f" (trace #{cause['trace_id']})"
            lines.append(line)
            origin = cause.get("origin") or ""
            if origin.startswith("cell/"):
                # a cause that crossed clusters: make the hop visible
                # so `why` tells the cross-cell story at a glance
                lines.append(
                    f"         ↪ cell boundary: {origin[5:]}")
    return "\n".join(lines)


def _why(args) -> int:
    """Answer "why is this object in this state": fetch the object's
    timeline from the manager's /debug/timeline (or a must-gather
    timeline dump) and render it as a causal story — every enqueue with
    its cause chain, reconcile outcome, FSM/migration transition and
    placement decision, oldest first."""
    import pathlib
    import urllib.parse
    import urllib.request

    if "/" not in args.object:
        print("object must be <Kind>/[namespace/]<name>", file=sys.stderr)
        return 1
    kind, name = args.object.split("/", 1)
    if args.file:
        try:
            data = json.loads(pathlib.Path(args.file).read_text())
        except (OSError, ValueError) as e:
            print(f"cannot read timeline from {args.file}: {e}",
                  file=sys.stderr)
            return 1
        # must-gather dumps TIMELINE.snapshot(): {"Kind/name": [events]}
        events = data.get(f"{kind}/{name}", []) if isinstance(data, dict) \
            else data
        payload = {"kind": kind, "name": name, "count": len(events),
                   "events": events}
    else:
        url = (args.url.rstrip("/") + "/debug/timeline?"
               + urllib.parse.urlencode({"kind": kind, "name": name}))
        try:
            with urllib.request.urlopen(url, timeout=args.timeout) as resp:
                payload = json.load(resp)
        except Exception as e:
            print(f"cannot fetch {url}: {e}", file=sys.stderr)
            return 1
    if getattr(args, "output", "text") == "json":
        print(json.dumps(payload, indent=2, sort_keys=True))
        return 0
    if not payload.get("events"):
        print(f"no timeline recorded for {kind}/{name} (is the lineage "
              f"plane enabled? OPERATOR_TRACE=0 disables it)")
        return 1
    print(render_timeline(payload))
    return 0


def render_slo_report(report: dict) -> str:
    """The /debug/slo body as a table: one row per SLO with its
    objective, breach verdict, remaining error budget, and per-window
    burn rates."""
    lines = []
    for slo in report.get("slos") or []:
        verdict = "BREACHED" if slo.get("breached") else "ok"
        total = slo.get("total") or {}
        lines.append(
            f"{slo.get('name', ''):<22s} {verdict:<9s}"
            f" objective={slo.get('objective', 0):.2%}"
            f" budget={slo.get('budget_remaining', 0):.1%}"
            f" good={total.get('good', 0):g} bad={total.get('bad', 0):g}")
        for wname, w in sorted((slo.get("windows") or {}).items()):
            lines.append(
                f"    {wname:<6s} burn={w.get('burn_rate', 0):g}"
                f" (threshold {w.get('threshold', 0):g}"
                f", {w.get('seconds', 0):g}s)"
                + ("  BREACHED" if w.get("breached") else ""))
    return "\n".join(lines) if lines else "no SLOs configured"


def _slo(args) -> int:
    """Fetch the SLO burn-rate report from the manager's /debug/slo (or
    a must-gather slo.json) and print it; exit 2 when any SLO is
    breached so the command scripts as a health probe."""
    import pathlib
    import urllib.parse
    import urllib.request

    if args.file:
        try:
            report = json.loads(pathlib.Path(args.file).read_text())
        except (OSError, ValueError) as e:
            print(f"cannot read SLO report from {args.file}: {e}",
                  file=sys.stderr)
            return 1
    else:
        url = args.url.rstrip("/") + "/debug/slo"
        if args.window is not None:
            url += "?" + urllib.parse.urlencode({"window": args.window})
        try:
            with urllib.request.urlopen(url, timeout=args.timeout) as resp:
                report = json.load(resp)
        except Exception as e:
            print(f"cannot fetch {url}: {e}", file=sys.stderr)
            return 1
    if not isinstance(report, dict):
        print("SLO report payload is not an object", file=sys.stderr)
        return 1
    breached = [s["name"] for s in report.get("slos") or []
                if s.get("breached")]
    if getattr(args, "output", "text") == "json":
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        print(render_slo_report(report))
        if breached:
            print("breached: " + ", ".join(sorted(breached)))
    return 2 if breached else 0


def render_quota_report(report: dict) -> str:
    """The /debug/quota body as a table: one row per leaf class with its
    weight, min/max bounds, live usage vs water-filled share, queued
    demand, deficit clock vs starvation bound, and the remaining
    preemption-budget tokens. A must-gather bundle carries no live
    admission state, so deficit/token columns render as ``-`` there
    rather than fabricated zeros."""
    if not report.get("configured"):
        return "no quota configured (admission layer is a no-op)"

    def _n(v, unit=""):
        return "-" if v is None else f"{v:g}{unit}"

    lines = [f"policy: {report.get('policy', '')}   "
             f"capacity: {report.get('capacityChips', 0)} chips"]
    lines.append(
        f"{'CLASS':<12s} {'W':>4s} {'MIN':>5s} {'MAX':>5s} {'USE':>5s}"
        f" {'SHARE':>5s} {'QUEUED':>10s} {'DEFICIT':>12s} {'TOKENS':>6s}")
    for row in report.get("classes") or []:
        queued = f"{row.get('queuedChips', 0)}c" \
                 f"/{row.get('queuedRequests', 0)}r"
        bound = row.get("starvationBoundSeconds")
        deficit = row.get("deficitSeconds")
        dcol = "-" if deficit is None else (
            f"{deficit:g}s/{_n(bound, 's')}")
        tokens = row.get("tokensRemaining")
        lines.append(
            f"{row.get('class', ''):<12s} {row.get('weight', 0):>4g}"
            f" {row.get('minChips', 0):>5d} {_n(row.get('maxChips')):>5s}"
            f" {row.get('usageChips', 0):>5d} {row.get('shareChips', 0):>5d}"
            f" {queued:>10s} {dcol:>12s} {_n(tokens):>6s}"
            + ("  STARVING" if row.get("starving") else ""))
    return "\n".join(lines)


def _quota(args) -> int:
    """Fetch the fair-share admission explainer from the manager's
    /debug/quota (or a must-gather's quota/quota.json) and print the
    per-class table; exit 2 when any class sits past its starvation
    bound so the command scripts as a fairness probe."""
    import pathlib
    import urllib.request

    if args.file:
        path = pathlib.Path(args.file)
        if path.is_dir():
            # a must-gather bundle: the admission plane lives at a
            # fixed relative path inside it
            path = path / "quota" / "quota.json"
        try:
            report = json.loads(path.read_text())
        except (OSError, ValueError) as e:
            print(f"cannot read quota report from {path}: {e}",
                  file=sys.stderr)
            return 1
    else:
        url = args.url.rstrip("/") + "/debug/quota"
        try:
            with urllib.request.urlopen(url, timeout=args.timeout) as resp:
                report = json.load(resp)
        except Exception as e:
            print(f"cannot fetch {url}: {e}", file=sys.stderr)
            return 1
    if not isinstance(report, dict):
        print("quota report payload is not an object", file=sys.stderr)
        return 1
    breached = sorted(str(c) for c in report.get("breached") or [])
    if getattr(args, "output", "text") == "json":
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        print(render_quota_report(report))
        if breached:
            print("starving: " + ", ".join(breached))
    return 2 if breached else 0


def render_fleet_top(snapshot: dict) -> str:
    """The /debug/fleet body as a per-domain heatmap: one row per
    domain (GKE nodepool, else ``{generation}-{gpu.topology}``) with its
    digest coverage, degraded-card count, duty-cycle heat bar and max
    card temperature, then the hysteresis scorer's live state and the
    worst-goodput slices."""
    lines = []
    totals = snapshot.get("totals") or {}
    lines.append(
        f"fleet: {totals.get('nodes', 0)} GPU nodes "
        f"({totals.get('reporting', 0)} reporting, "
        f"{totals.get('silent', 0)} silent, "
        f"{totals.get('condemned', 0)} condemned), "
        f"{totals.get('chips', 0)} cards, "
        f"{totals.get('degraded_chips', 0)} degraded")
    domains = snapshot.get("domains") or {}
    if domains:
        lines.append(f"{'DOMAIN':<22s} {'GEN':<9s} {'NODES':>5s} "
                     f"{'REP':>4s} {'CHIPS':>5s} {'BAD':>4s} "
                     f"{'COND':>4s} {'DUTY%':>6s} {'HBM':>5s} "
                     f"{'TEMP':>6s}  HEAT")
    worst = snapshot.get("worst_domain") or ""
    for dom in sorted(domains):
        e = domains[dom]
        duty = float(e.get("duty_cycle_pct", 0.0))
        # ten-cell heat bar scaled on duty cycle — the at-a-glance
        # load picture `top` owes its name to
        filled = max(0, min(10, int(round(duty / 10.0))))
        bar = "#" * filled + "." * (10 - filled)
        lines.append(
            f"{dom:<22s} {e.get('generation', ''):<9s}"
            f" {e.get('nodes', 0):>5d} {e.get('reporting', 0):>4d}"
            f" {e.get('chips', 0):>5d} {e.get('degraded_chips', 0):>4d}"
            f" {e.get('condemned', 0):>4d} {duty:>6.1f}"
            f" {e.get('hbm_headroom_frac', 1.0):>5.2f}"
            f" {e.get('temp_max_c', 0.0):>6.1f}  {bar}"
            + ("  << WORST" if dom == worst else ""))
    scorer = snapshot.get("scorer") or {}
    if scorer:
        streaks = scorer.get("fail_streaks") or {}
        parts = [f"condemn after {scorer.get('condemn_after', 0)} FAILs",
                 f"absolve after {scorer.get('absolve_after', 0)} OKs"]
        condemned = scorer.get("condemned") or []
        parts.append("condemned: " + (", ".join(condemned)
                                      if condemned else "none"))
        lines.append("scorer: " + "; ".join(parts))
        active = {n: s for n, s in streaks.items()
                  if n not in set(condemned)}
        if active:
            lines.append("  fail streaks: " + ", ".join(
                f"{n}={s}" for n, s in sorted(active.items())))
    slices = snapshot.get("slices") or {}
    if slices:
        lines.append("slices (worst goodput first):")
        order = list(snapshot.get("worst_slices") or [])
        order += [k for k in sorted(slices) if k not in set(order)]
        for key in order:
            s = slices.get(key) or {}
            ratio = s.get("goodput_ratio")
            rated = f"{ratio:.2f}x" if ratio is not None else "n/a"
            lines.append(
                f"  {key:<28s} {s.get('generation') or '?':<9s}"
                f" acked {s.get('acked_steps', 0):>5}  goodput {rated}"
                + ("  DEGRADED" if ratio is not None
                   and ratio < 0.5 else ""))
    return "\n".join(lines)


def _top(args) -> int:
    """Fetch the fleet telemetry rollup from the manager's /debug/fleet
    (or a must-gather's fleet/fleet.json) and render the per-domain
    heatmap; exit 2 when any node is condemned so the command scripts
    as a fleet-health probe."""
    import pathlib
    import urllib.request

    if args.file:
        path = pathlib.Path(args.file)
        if path.is_dir():
            # a must-gather bundle: the fleet plane lives at a fixed
            # relative path inside it
            path = path / "fleet" / "fleet.json"
        try:
            snapshot = json.loads(path.read_text())
        except (OSError, ValueError) as e:
            print(f"cannot read fleet snapshot from {path}: {e}",
                  file=sys.stderr)
            return 1
    else:
        url = args.url.rstrip("/") + "/debug/fleet"
        try:
            with urllib.request.urlopen(url, timeout=args.timeout) as resp:
                snapshot = json.load(resp)
        except Exception as e:
            print(f"cannot fetch {url}: {e}", file=sys.stderr)
            return 1
    if not isinstance(snapshot, dict):
        print("fleet snapshot payload is not an object", file=sys.stderr)
        return 1
    condemned = (snapshot.get("totals") or {}).get("condemned", 0)
    if getattr(args, "output", "text") == "json":
        print(json.dumps(snapshot, indent=2, sort_keys=True))
    else:
        print(render_fleet_top(snapshot))
    return 2 if condemned else 0


def render_cells_report(report: dict) -> str:
    """The federation cells report as two tables: per-cell breaker rows
    (state, failure streak, probe ledger, digest age, routed total,
    pinned load) and the globally-queued requests still owed a cell."""
    router = report.get("router") or {}
    breaker = router.get("cells") or {}
    pinned = report.get("cells") or {}
    names = sorted(set(breaker) | set(pinned))
    lines = [f"{'CELL':<14s} {'STATE':<9s} {'STREAK':>6s} "
             f"{'PROBES':>6s} {'DIGEST-AGE':>10s} {'ROUTED':>6s} "
             f"{'REQS':>5s} {'CHIPS':>6s}"]
    for name in names:
        b = breaker.get(name) or {}
        p = pinned.get(name) or {}
        age = b.get("digest_age_s")
        lines.append(
            f"{name:<14s} {b.get('state', '-'):<9s} "
            f"{b.get('failure_streak', 0):>6d} "
            f"{b.get('probes', 0):>6d} "
            f"{age if age is not None else '-':>10} "
            f"{b.get('routed_total', 0):>6d} "
            f"{len(p.get('requests') or []):>5d} "
            f"{p.get('chips', 0):>6d}")
    unrouted = report.get("unrouted") or []
    if unrouted:
        lines.append("")
        lines.append(f"unrouted ({len(unrouted)}):")
        for row in unrouted:
            lines.append(f"  {row.get('name', ''):<30s} "
                         f"{row.get('phase', ''):<14s} "
                         f"chips={row.get('chips', 0)}")
    horizon = router.get("condemnation_horizon_s")
    if horizon is not None:
        lines.append("")
        lines.append(f"condemnation horizon: {horizon}s (an Open cell "
                     f"past it gets its slices migrated out)")
    return "\n".join(lines)


def _cells(args) -> int:
    """Fetch the federation cells report from the manager's
    /debug/cells (or a must-gather's federation/cells.json) and render
    the per-cell breaker table; exit 2 when any cell's breaker is Open
    so the command scripts as a partition probe."""
    import pathlib
    import urllib.request

    if args.file:
        path = pathlib.Path(args.file)
        if path.is_dir():
            # a must-gather bundle: the federation plane lives at a
            # fixed relative path inside it
            path = path / "federation" / "cells.json"
        try:
            report = json.loads(path.read_text())
        except (OSError, ValueError) as e:
            print(f"cannot read cells report from {path}: {e}",
                  file=sys.stderr)
            return 1
    else:
        url = args.url.rstrip("/") + "/debug/cells"
        try:
            with urllib.request.urlopen(url, timeout=args.timeout) as resp:
                report = json.load(resp)
        except Exception as e:
            print(f"cannot fetch {url}: {e}", file=sys.stderr)
            return 1
    if not isinstance(report, dict):
        print("cells report payload is not an object", file=sys.stderr)
        return 1
    breaker = (report.get("router") or {}).get("cells") or {}
    open_cells = sorted(n for n, b in breaker.items()
                        if (b or {}).get("state") == "Open")
    if getattr(args, "output", "text") == "json":
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        print(render_cells_report(report))
        if open_cells:
            print("open breakers: " + ", ".join(open_cells))
    return 2 if open_cells else 0


def _dag(args) -> int:
    """Render the operand dependency DAG the scheduler compiles at
    startup: every state with its requires(), the parallel sync waves
    (level order = execution order), and the critical path that bounds
    install-to-ready. Entirely offline — the plan is a pure function of
    the state declarations, so what this prints IS what the operator
    runs."""
    from ..state.operands import build_states
    from ..state.scheduler import DagPlan, DependencyCycleError

    try:
        plan = DagPlan.build(build_states())
    except (DependencyCycleError, ValueError) as e:
        print(f"INVALID operand DAG: {e}", file=sys.stderr)
        return 1
    if getattr(args, "output", "text") == "json":
        print(json.dumps({
            "states": {name: list(reqs)
                       for name, reqs in sorted(plan.requires.items())},
            "levels": [list(level) for level in plan.levels],
            "critical_path": list(plan.critical_path),
        }, indent=2, sort_keys=True))
        return 0
    print(f"{len(plan.order)} states, {len(plan.levels)} waves, "
          f"critical path {len(plan.critical_path)} deep")
    for i, level in enumerate(plan.levels):
        print(f"wave {i}:")
        for name in level:
            reqs = plan.requires[name]
            print(f"  {name}"
                  + (f"  <- {', '.join(reqs)}" if reqs else ""))
    print("critical path: " + " -> ".join(plan.critical_path))
    return 0


# the compact fixture's card names by GKE accelerator, as the
# control-plane benchmark's POOL_MIX labels them
FIXTURE_PRODUCTS = {
    "nvidia-h100-80gb": "NVIDIA-H100-80GB-HBM3",
    "nvidia-h100-mega-80gb": "NVIDIA-H100-80GB-HBM3",
    "nvidia-a100-80gb": "NVIDIA-A100-SXM4-80GB",
    "nvidia-gb200": "NVIDIA-GB200",
}
# cards one multi-host NVLink domain holds (GB200 NVL72)
MNNVL_DOMAIN_CARDS = 72


def _fixture_nodes(doc) -> list:
    """Expand a fleet fixture into Node objects. Two shapes: a YAML list
    of Node dicts (used verbatim), or the compact ``pools:`` form —
    ``{pools: [{accelerator, topology, chips, count, product, hosts}]}``
    — expanded with the labels a GKE GPU node carries once feature
    discovery ran, as ``benchmarks/controlplane.build_cluster`` builds
    them: GKE's accelerator and card count, ``gpu.product`` (by default
    the accelerator's card), ``gpu.topology`` and ``nvidia.com/gpu``. An
    ``mnnvl`` pool's hosts are grouped into GKE nodepools of ``hosts``
    hosts each (default: an NVL72 domain's cards over the host's), one
    nodepool an NVLink domain; other fabrics end at the host and get no
    nodepool."""
    from ..api import labels as L
    from ..state.nodepool import FABRIC_MNNVL, fabric_of

    if isinstance(doc, list):
        return doc
    if not isinstance(doc, dict) or not isinstance(doc.get("pools"), list):
        raise ValueError("fleet fixture must be a node list or {pools: [...]}")
    nodes = []
    for pool in doc["pools"]:
        accel = str(pool.get("accelerator", ""))
        topo = str(pool.get("topology", ""))
        chips = int(pool.get("chips", 4))
        count = int(pool.get("count", 0))
        product = str(pool.get("product") or FIXTURE_PRODUCTS.get(accel, ""))
        multi_host = fabric_of(topo) == FABRIC_MNNVL
        hosts = int(pool.get("hosts") or max(1, MNNVL_DOMAIN_CARDS // chips))
        short = accel.split("-")[1] if "-" in accel else accel
        for i in range(count):
            labels = {
                L.GKE_ACCELERATOR: accel,
                L.GKE_ACCELERATOR_COUNT: str(chips),
                L.GPU_PRODUCT: product,
                L.GPU_TOPOLOGY: topo,
            }
            if multi_host:
                labels[L.GKE_NODEPOOL] = f"{short}-{topo}-np{i // hosts}"
            nodes.append({
                "apiVersion": "v1", "kind": "Node",
                "metadata": {"name": f"{short}-{topo}-{i}",
                             "labels": labels},
                "spec": {},
                "status": {
                    "allocatable": {L.GPU_RESOURCE: str(chips)},
                    "conditions": [{"type": "Ready", "status": "True"}],
                },
            })
    return nodes


def _place(args) -> int:
    """Dry-run the slice placement engine against a fleet fixture: rank
    every candidate window exactly as the placement controller would and
    print the winner — or, with --explain, the full ranked table with
    the per-term score breakdown (throughput / adjacency / fragmentation
    / preference). Entirely offline: the scorer is a pure function of
    the fleet and the request, so what this prints IS what the
    controller would bind."""
    from ..api.slicerequest import SliceRequestSpec
    yaml = yaml_module()

    from ..topology.placement import (
        FleetState,
        rank_candidates,
        unschedulable_reason,
    )

    try:
        with open(args.fleet) as f:
            nodes = _fixture_nodes(yaml.safe_load(f))
    except (OSError, ValueError, yaml.YAMLError) as e:
        print(f"INVALID fleet fixture {args.fleet}: {e}", file=sys.stderr)
        return 2
    spec = SliceRequestSpec(
        chips=args.chips, topology=args.topology or None,
        accelerator=args.accelerator or None, priority=args.priority,
        preferred_generations=[g for g in args.prefer.split(",") if g]
        or None)
    fleet = FleetState(nodes)
    ranked = rank_candidates(spec, fleet)
    shown = ranked[:args.top] if args.top > 0 else ranked
    stats = None
    if getattr(args, "index_stats", False):
        # the same fixture through the incremental index the controller
        # runs: structure counters plus an agreement bit against the
        # from-scratch ranking just computed — the field check for
        # "is the index serving what a rescan would"
        from ..topology.index import FleetIndex

        index = FleetIndex(nodes)
        served = index.rank(spec)
        stats = index.index_stats()
        stats["agrees_with_rescan"] = (
            [c.sort_key() for c in served]
            == [c.sort_key() for c in ranked])
    if args.output == "json":
        doc = {
            "request": spec.to_obj(),
            "candidates": [{
                "pool": c.pool, "slice": c.slice_id,
                "generation": c.generation, "nodes": list(c.nodes),
                "chips": c.chips, "score": f"{c.score:.6f}",
                "breakdown": {k: f"{v:.6f}"
                              for k, v in sorted(c.breakdown.items())},
            } for c in shown],
            "reason": None if ranked else unschedulable_reason(spec, fleet),
        }
        if stats is not None:
            doc["index_stats"] = stats
        print(json.dumps(doc, indent=2, sort_keys=True))
        return 0 if ranked else 1
    totals = fleet.chip_totals()
    fleet_line = " ".join(
        f"{gen}:{t['free']}/{t['free'] + t['placed']}"
        for gen, t in sorted(totals.items()))
    print(f"fleet: {len(fleet.slices)} NVLink domains, free cards "
          f"{fleet_line}")
    print(f"request: chips={spec.chips_needed()}"
          + (f" topology={spec.topology}" if spec.topology else "")
          + (f" accelerator={spec.accelerator}" if spec.accelerator else "")
          + (f" prefer={','.join(spec.preferred_generations)}"
             if spec.preferred_generations else ""))
    if stats is not None:
        print(f"index: nodes={stats['nodes']} pools={stats['pools']} "
              f"domains={stats['domains']} leases={stats['leases']} "
              f"spec_shapes={stats['spec_shapes']} "
              f"heap_entries={stats['heap_entries']}")
        print("index agrees with rescan: "
              + ("yes" if stats["agrees_with_rescan"] else "NO"))
    if not ranked:
        print(f"UNSCHEDULABLE: {unschedulable_reason(spec, fleet)}")
        return 1
    if args.explain:
        print(f"{len(ranked)} candidates (top {len(shown)}):")
        for rank, c in enumerate(shown, 1):
            b = c.breakdown
            print(f"{rank:3d}. {c.score:.6f}  {c.pool}/{c.slice_id}  "
                  f"{c.chips} cards on {len(c.nodes)} host(s)")
            print(f"     throughput={b['throughput']:.6f} "
                  f"adjacency={b['adjacency']:.6f} "
                  f"fragmentation={b['fragmentation']:.6f} "
                  f"preference={b['preference']:.6f}")
            print(f"     nodes: {', '.join(c.nodes)}")
    else:
        best = ranked[0]
        print(f"PLACED: {best.pool}/{best.slice_id} score={best.score:.6f}")
        print(f"  nodes: {', '.join(best.nodes)}")
    return 0


def main(argv=None) -> int:
    yaml = yaml_module()

    p = argparse.ArgumentParser(prog="gpuop-cfg")
    from .. import __version__

    p.add_argument("--version", action="version",
                   version=f"%(prog)s {__version__}")
    sub = p.add_subparsers(dest="cmd", required=True)

    v = sub.add_parser("validate", help="offline CR validation")
    v.add_argument("what", choices=["clusterpolicy", "gpudriver"])
    v.add_argument("-f", "--file", required=True)
    v.add_argument("--verify-images", action="store_true",
                   help="also check every explicitly-configured operand "
                        "image resolves in its registry (needs network; "
                        "the gpuop-cfg regclient check, images.go:172)")
    v.add_argument("--plain-http", action="store_true",
                   help="with --verify-images: talk http:// to the "
                        "registry (local/test registries)")
    v.add_argument("--registry-timeout", type=float, default=10.0)

    g = sub.add_parser("generate", help="emit deployment manifests")
    g.add_argument("what",
                   choices=["crds", "operator", "all", "bundle", "cleanup",
                            "helm-chart"])
    g.add_argument("-n", "--namespace", default=None,
                   help="default gpu-operator; with --values, an explicit "
                        "flag overrides the values file")
    g.add_argument("--image", default="")
    g.add_argument("--values", default="",
                   help="values file merged over deploy/values.yaml "
                        "(Helm-values slot); implies schema validation of "
                        "the rendered ClusterPolicy")
    g.add_argument("--dir", default="",
                   help="with `bundle`: write the registry+v1 bundle "
                        "DIRECTORY layout (manifests/ metadata/ "
                        "tests/scorecard/) OLM tooling consumes, instead "
                        "of a YAML stream")

    d = sub.add_parser(
        "diff", help="compare the rendered install stream against the "
                     "live cluster (kubectl-diff/helm-diff slot); exit 1 "
                     "on drift or missing objects")
    d.add_argument("what", nargs="?", default="all",
                   choices=["crds", "operator", "all"])
    d.add_argument("-n", "--namespace", default=None)
    d.add_argument("--image", default="")
    d.add_argument("--values", default="")

    # the Helm-verb slot (deployments/gpu-operator/templates/*): one
    # command from empty cluster to all-operands-ready, and back
    for verb, help_ in (("install", "render + apply the full stream "
                                    "(helm install slot)"),
                        ("upgrade", "re-apply CRDs first, then the "
                                    "stream (helm upgrade + pre-upgrade "
                                    "hook slot)")):
        i = sub.add_parser(verb, help=help_)
        i.add_argument("-n", "--namespace", default=None)
        i.add_argument("--image", default="")
        i.add_argument("--values", default="")
        i.add_argument("--wait", action="store_true",
                       help="block until every GPUClusterPolicy is ready "
                            "(helm --wait)")
        i.add_argument("--timeout", type=float, default=300.0,
                       help="--wait budget; default matches the "
                            "reference e2e's 5-minute install budget")
    st = sub.add_parser(
        "status", help="one-shot install health: CR states, multi-host "
                       "slice rows, per-operand readiness, node upgrade "
                       "states, cluster facts; exit 1 unless every CR is "
                       "ready, every slice validated, every operand ready")
    st.add_argument("-n", "--namespace", default="gpu-operator")
    st.add_argument("-o", "--output", choices=("text", "json"),
                    default="text",
                    help="json: the same health picture as one "
                         "machine-readable object (same exit code)")
    st.add_argument("--operator-url", default=None, dest="operator_url",
                    help="also probe the manager's /debug/cache at this "
                         "base URL and report Degraded-mode breaker "
                         "state (stale reads under apiserver brownout); "
                         "unreachable = warning, not failure")

    sl = sub.add_parser(
        "slices", help="SliceRequest fleet view: placement phase, chips, "
                       "binding size per request; --migrations adds the "
                       "elastic handshake (intent, deadline, acked/"
                       "restored steps, old->new binding)")
    sl.add_argument("-n", "--namespace", default="",
                    help="restrict to one namespace (default: all)")
    sl.add_argument("--migrations", action="store_true",
                    help="show the per-request migration handshake "
                         "detail, not just the one-line summary")
    sl.add_argument("-o", "--output", choices=("text", "json"),
                    default="text",
                    help="json: the same listing as one machine-"
                         "readable object")

    u = sub.add_parser("uninstall",
                       help="delete CRs (waiting for operand teardown), "
                            "then the operator stream (pre-delete hook "
                            "sequencing, no Helm required)")
    u.add_argument("-n", "--namespace", default=None)
    u.add_argument("--image", default="")
    u.add_argument("--values", default="")
    u.add_argument("--purge-crds", action="store_true",
                   help="also drop the CRDs after the CRs are gone")
    u.add_argument("--timeout", type=float, default=300.0)

    t = sub.add_parser(
        "trace", help="render reconcile traces from the manager's "
                      "/debug/traces flight recorder (or a must-gather "
                      "traces.json) as indented span trees")
    t.add_argument("--url", default="http://127.0.0.1:8080",
                   help="manager health endpoint base URL")
    t.add_argument("-f", "--file", default=None,
                   help="read a traces.json dump instead of fetching")
    t.add_argument("--controller", default=None,
                   help="only traces from this controller")
    t.add_argument("--min-ms", type=float, default=None,
                   help="only traces at least this slow")
    t.add_argument("--outcome", choices=("ok", "error"), default=None)
    t.add_argument("--limit", type=int, default=None,
                   help="at most N traces (newest first)")
    t.add_argument("--id", type=int, default=None,
                   help="render only the trace with this id")
    t.add_argument("--timeout", type=float, default=10.0)

    ca = sub.add_parser(
        "cache", help="show the manager's informer-cache picture from "
                      "/debug/cache (or a must-gather cache.json): per-"
                      "kind object counts, measured projected-vs-full "
                      "store bytes, index buckets, relists")
    ca.add_argument("--url", default="http://127.0.0.1:8080",
                    help="manager health endpoint base URL")
    ca.add_argument("-f", "--file", default=None,
                    help="read a cache.json dump instead of fetching")
    ca.add_argument("-o", "--output", choices=("text", "json"),
                    default="text")
    ca.add_argument("--timeout", type=float, default=10.0)

    sn = sub.add_parser(
        "snapshot", help="durable-snapshot plane report from "
                         "/debug/snapshot (or --dir locally, or a "
                         "must-gather snapshot.json): newest valid "
                         "snapshot, age/schema/per-kind counts, last "
                         "warm-restore outcome")
    sn.add_argument("--url", default="http://127.0.0.1:8080",
                    help="manager health endpoint base URL")
    sn.add_argument("--dir", default=None,
                    help="read a snapshot directory directly instead "
                         "of fetching (works with the manager down)")
    sn.add_argument("-f", "--file", default=None,
                    help="read a snapshot.json dump instead of fetching")
    sn.add_argument("-o", "--output", choices=("text", "json"),
                    default="text")
    sn.add_argument("--timeout", type=float, default=10.0)

    wy = sub.add_parser(
        "why", help="per-object causal timeline from /debug/timeline "
                    "(or a must-gather timeline dump): every enqueue "
                    "with its cause chain, reconcile outcome, FSM/"
                    "migration transition and placement decision, in "
                    "order — 'why is this object in this state'")
    wy.add_argument("object",
                    help="<Kind>/[namespace/]<name>, e.g. "
                         "SliceRequest/gpu-operator/ereq-001")
    wy.add_argument("--url", default="http://127.0.0.1:8080",
                    help="manager health endpoint base URL")
    wy.add_argument("-f", "--file", default=None,
                    help="read a must-gather timeline snapshot JSON "
                         "instead of fetching")
    wy.add_argument("-o", "--output", choices=("text", "json"),
                    default="text")
    wy.add_argument("--timeout", type=float, default=10.0)

    so = sub.add_parser(
        "slo", help="SLO burn-rate report from /debug/slo (or a "
                    "must-gather slo.json): per-SLO breach verdict, "
                    "remaining error budget and multi-window burn "
                    "rates; exit 2 when any SLO is breached")
    so.add_argument("--url", default="http://127.0.0.1:8080",
                    help="manager health endpoint base URL")
    so.add_argument("-f", "--file", default=None,
                    help="read an slo.json dump instead of fetching")
    so.add_argument("--window", type=float, default=None,
                    help="add one ad-hoc burn window of this many "
                         "seconds to the report")
    so.add_argument("-o", "--output", choices=("text", "json"),
                    default="text")
    so.add_argument("--timeout", type=float, default=10.0)

    qo = sub.add_parser(
        "quota", help="fair-share admission explainer from /debug/quota "
                      "(or a must-gather quota/quota.json): per-class "
                      "usage vs water-filled share, queued demand, "
                      "deficit clocks and preemption-budget tokens; "
                      "exit 2 when any class is past its starvation "
                      "bound")
    qo.add_argument("--url", default="http://127.0.0.1:8080",
                    help="manager health endpoint base URL")
    qo.add_argument("-f", "--file", default=None,
                    help="read a quota.json dump (or a must-gather "
                         "directory containing quota/quota.json) "
                         "instead of fetching")
    qo.add_argument("-o", "--output", choices=("text", "json"),
                    default="text")
    qo.add_argument("--timeout", type=float, default=10.0)

    tp = sub.add_parser(
        "top", help="fleet telemetry heatmap from /debug/fleet (or a "
                    "must-gather's fleet/fleet.json): per-domain "
                    "digest coverage, degraded cards, duty/memory/temp, "
                    "scorer state and worst-goodput slices; exit 2 "
                    "when any node is condemned")
    tp.add_argument("--url", default="http://127.0.0.1:8080",
                    help="manager health endpoint base URL")
    tp.add_argument("-f", "--file", default=None,
                    help="read a fleet.json dump (or a must-gather "
                         "directory containing fleet/fleet.json) "
                         "instead of fetching")
    tp.add_argument("-o", "--output", choices=("text", "json"),
                    default="text")
    tp.add_argument("--timeout", type=float, default=10.0)

    ce = sub.add_parser(
        "cells", help="federation view from /debug/cells (or a "
                      "must-gather's federation/cells.json): per-cell "
                      "breaker state, probe ledger, digest age and "
                      "pinned load, plus the globally-queued requests; "
                      "exit 2 when any cell's breaker is Open")
    ce.add_argument("--url", default="http://127.0.0.1:8080",
                    help="manager health endpoint base URL")
    ce.add_argument("-f", "--file", default=None,
                    help="read a cells.json dump (or a must-gather "
                         "directory containing federation/cells.json) "
                         "instead of fetching")
    ce.add_argument("-o", "--output", choices=("text", "json"),
                    default="text")
    ce.add_argument("--timeout", type=float, default=10.0)

    dg = sub.add_parser(
        "dag", help="show the operand state dependency DAG the scheduler "
                    "compiles at startup: sync waves, per-state "
                    "requires(), and the critical path that bounds "
                    "install-to-ready")
    dg.add_argument("-o", "--output", choices=("text", "json"),
                    default="text")

    pl = sub.add_parser(
        "place", help="dry-run the slice placement engine against a "
                      "fleet fixture: rank candidate windows with the "
                      "per-term score breakdown the controller would "
                      "use; exit 1 when unschedulable")
    pl.add_argument("--fleet", required=True,
                    help="fleet fixture YAML: a Node list, or the "
                         "compact {pools: [{accelerator, topology, "
                         "chips, count, product, hosts}]} form, e.g. "
                         "{accelerator: nvidia-gb200, topology: mnnvl-4, "
                         "chips: 4, count: 36}")
    pl.add_argument("--chips", type=int, default=0)
    pl.add_argument("--topology", default="",
                    help="requested fabric (mnnvl, nvswitch, nvlink, "
                         "pcie) or a whole gpu.topology value, e.g. "
                         "mnnvl-4")
    pl.add_argument("--accelerator", default="",
                    help="hard gpu.product pin, e.g. "
                         "NVIDIA-H100-80GB-HBM3")
    pl.add_argument("--priority", type=int, default=0)
    pl.add_argument("--prefer", default="",
                    help="comma-separated soft generation preference "
                         "order, e.g. gb200,h100-sxm")
    pl.add_argument("--explain", action="store_true",
                    help="print every ranked candidate with the "
                         "per-term score breakdown, not just the winner")
    pl.add_argument("--top", type=int, default=10,
                    help="candidates shown with --explain/-o json "
                         "(0 = all)")
    pl.add_argument("--index-stats", action="store_true",
                    dest="index_stats",
                    help="also build the incremental placement index "
                         "over the fixture and print its structure "
                         "counters plus an agreement check against "
                         "the from-scratch ranking")
    pl.add_argument("-o", "--output", choices=("text", "json"),
                    default="text")

    args = p.parse_args(argv)

    if args.cmd in ("install", "upgrade", "uninstall"):
        return _lifecycle(args)
    if args.cmd == "status":
        return _status(args)
    if args.cmd == "slices":
        return _slices(args)
    if args.cmd == "trace":
        return _trace(args)
    if args.cmd == "cache":
        return _cache(args)
    if args.cmd == "snapshot":
        return _snapshot(args)
    if args.cmd == "why":
        return _why(args)
    if args.cmd == "slo":
        return _slo(args)
    if args.cmd == "quota":
        return _quota(args)
    if args.cmd == "top":
        return _top(args)
    if args.cmd == "cells":
        return _cells(args)
    if args.cmd == "dag":
        return _dag(args)
    if args.cmd == "place":
        return _place(args)

    if args.cmd == "diff":
        docs = _generate_docs(args)
        if docs is None:
            return 1
        from ..deploy.diff import diff_bundle, render_report
        from ..runtime.kubeclient import HTTPClient, KubeConfig

        try:
            # request-time failures (apiserver down, RBAC denies a GET)
            # must be a clean message + rc 1, not a traceback
            client = HTTPClient(KubeConfig.load())
            results = diff_bundle(client, docs)
        except Exception as e:
            print(f"cannot diff against the cluster: {e}", file=sys.stderr)
            return 1
        report, clean = render_report(results)
        print(report)
        return 0 if clean else 1

    if args.cmd == "generate":
        if args.what == "helm-chart":
            if args.values or args.namespace is not None or args.image:
                # the chart always embeds the canonical defaults; values
                # belong at `helm install -f` time — silently accepting
                # these flags would let users believe they were baked in
                print("--values/-n/--image do not apply to `generate "
                      "helm-chart` (pass values to helm install -f; "
                      "-n is helm's namespace flag)", file=sys.stderr)
                return 2
            from ..deploy.helmchart import write_chart

            target = write_chart(args.dir or None)
            for rel in sorted(p.relative_to(target).as_posix()
                              for p in target.rglob("*") if p.is_file()):
                print(rel)
            return 0
        if args.dir:
            if args.what != "bundle":
                print("--dir is only meaningful with `generate bundle` "
                      "or `generate helm-chart`",
                      file=sys.stderr)
                return 2
            from ..deploy import values as values_mod
            from ..deploy.csv import write_bundle_dir

            try:
                vals = values_mod.load_values(args.values or None)
                if args.namespace is not None:
                    vals["namespace"] = args.namespace
                written = write_bundle_dir(vals, args.dir)
            except (OSError, ValueError, yaml.YAMLError) as e:
                print(f"INVALID values: {e}", file=sys.stderr)
                return 1
            for rel in written:
                print(rel)
            return 0
        docs = _generate_docs(args)
        if docs is None:
            return 1
        try:
            print(yaml.safe_dump_all(docs, sort_keys=False), end="")
            sys.stdout.flush()
        except BrokenPipeError:
            # consumer (e.g. `| head`) closed the pipe — not an error
            import os

            os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
            return 141 - 128  # conventional SIGPIPE-style exit, quiet
        return 0

    try:
        with open(args.file) as f:
            cr = yaml.safe_load(f)
    except OSError as e:
        print(f"cannot read {args.file}: {e.strerror}", file=sys.stderr)
        return 1
    except yaml.YAMLError as e:
        print(f"invalid YAML: {e}", file=sys.stderr)
        return 1
    if not isinstance(cr, dict):
        print("file does not contain a mapping", file=sys.stderr)
        return 1
    want_kind = {"clusterpolicy": KIND_CLUSTER_POLICY,
                 "gpudriver": KIND_GPU_DRIVER}[args.what]
    if cr.get("kind") != want_kind:
        print(f"INVALID kind: validating a {args.what} requires kind "
              f"{want_kind}, file has {cr.get('kind')!r}", file=sys.stderr)
        return 1
    errs, kind = validate_cr(cr)
    if not errs and args.verify_images:
        from ..api.registry import RegistryResolver, resolve_cr_images

        resolver = RegistryResolver(
            plain_http=args.plain_http, timeout=args.registry_timeout)
        errs = resolve_cr_images(cr, resolver)
    if errs:
        for e in errs:
            print(f"INVALID {e}", file=sys.stderr)
        return 1
    print(f"{kind} {(cr.get('metadata') or {}).get('name')!r} is valid")
    return 0


if __name__ == "__main__":
    sys.exit(main())
