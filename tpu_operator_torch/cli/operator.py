"""gpu-operator manager entrypoint (cmd/gpu-operator/main.go:72-220 analog).

The port's counterpart of ``tpu_operator/cli/operator.py``, with the same
flags (``--fake-gpu-nodes`` for ``--fake-tpu-nodes``). It registers the
GPUClusterPolicy, GPUDriver and driver-upgrade reconcilers; placement's
joins them when it is ported.

Run against a real cluster (in-cluster config or kubeconfig):

    gpu-operator --health-port 8080

Or drive a complete self-contained demo cluster (the fake apiserver plus a
simulated kubelet):

    gpu-operator --fake-cluster --once
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import threading
import time

# a fake node: one GKE H100 host of four cards
FAKE_NODE_LABELS = {"cloud.google.com/gke-accelerator": "nvidia-h100-80gb",
                    "cloud.google.com/gke-accelerator-count": "4"}
FAKE_NODE_ALLOCATABLE = {"nvidia.com/gpu": "4"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gpu-operator",
        description="GPU cluster operator controller manager")
    from .. import __version__

    p.add_argument("--version", action="version",
                   version=f"%(prog)s {__version__}")
    p.add_argument("--namespace",
                   default=os.environ.get("OPERATOR_NAMESPACE", "gpu-operator"),
                   help="namespace operands are deployed into")
    p.add_argument("--health-port", type=int, default=None,
                   help="serve /healthz and /metrics on this port")
    p.add_argument("--fake-cluster", action="store_true",
                   help="run against an in-memory cluster with a simulated "
                        "kubelet (demo/verification mode)")
    p.add_argument("--fake-gpu-nodes", type=int, default=2,
                   help="GPU node count for --fake-cluster")
    p.add_argument("--once", action="store_true",
                   help="exit once the policy reaches ready (fake mode)")
    p.add_argument("--leader-elect", action="store_true",
                   help="gate controllers behind a coordination.k8s.io "
                        "Lease (for multi-replica deployments)")
    p.add_argument("--no-cache", action="store_true",
                   help="read through to the apiserver instead of the "
                        "informer-backed cache (debugging escape hatch)")
    p.add_argument("--workers", type=int,
                   default=int(os.environ.get("OPERATOR_WORKERS", "1")),
                   help="reconcile workers per controller "
                        "(MaxConcurrentReconciles analog)")
    p.add_argument("--shards", type=int, default=None,
                   help="workqueue shards per controller, rendezvous-"
                        "hashed by key (default OPERATOR_SHARDS or 1 = "
                        "a single queue)")
    p.add_argument("--write-qps", type=float, default=None,
                   help="shared apiserver write budget in writes/sec, "
                        "0 = unlimited (default OPERATOR_WRITE_QPS)")
    from ..runtime.tracing import env_trace_enabled

    p.add_argument("--no-trace", action="store_true",
                   default=not env_trace_enabled(),
                   help="disable reconcile tracing (flight recorder + "
                        "/debug/traces); also OPERATOR_TRACE=0. The "
                        "latency histograms stay on either way")
    from ..runtime.client import env_spec_hash_enabled

    p.add_argument("--no-spec-hash", action="store_true",
                   default=not env_spec_hash_enabled(),
                   help="disable spec-hash write avoidance: every "
                        "reconcile re-issues the pre-optimization "
                        "create/update/status writes; also "
                        "OPERATOR_SPEC_HASH=0 (debugging escape hatch "
                        "when a suspected skip masks operand drift)")
    from ..state.scheduler import env_dag_enabled

    p.add_argument("--serial-states", action="store_true",
                   default=not env_dag_enabled(),
                   help="disable the DAG operand scheduler: states sync "
                        "one at a time in declaration order; also "
                        "OPERATOR_DAG=0 (debugging escape hatch when a "
                        "suspected ordering race needs ruling out)")
    p.add_argument("--kubeconfig", default=None)
    p.add_argument("-v", "--verbose", action="count", default=0)
    return p


def wire_manager(client, args, snapshot_dir=None):
    """The manager over ``client`` as the operator runs it: reads through
    the informer cache (unless ``--no-cache``), the spec-hash and DAG
    gates set from the flags, every verb traced (unless ``--no-trace``),
    and the GPUClusterPolicy, GPUDriver and upgrade reconcilers
    registered, in the reference's order. ``snapshot_dir``
    overrides ``OPERATOR_SNAPSHOT_DIR``. Returns the manager, not yet
    started."""
    from ..controllers.clusterpolicy_controller import ClusterPolicyReconciler
    from ..controllers.gpudriver_controller import GPUDriverReconciler
    from ..controllers.upgrade_controller import UpgradeReconciler
    from ..runtime import Manager

    # controllers read through the informer cache by default; the raw
    # client stays with the caller for the kubelet sim and status polling
    # (the "apiserver side" of the demo)
    if args.no_cache:
        api = client
    else:
        from ..runtime import CachedClient
        api = CachedClient(client)

    from ..runtime.client import SPEC_HASH_GATE

    SPEC_HASH_GATE.enabled = not args.no_spec_hash

    from ..state.scheduler import DAG_GATE

    DAG_GATE.enabled = not args.serial_states

    from ..runtime.tracing import TRACER, TracingClient

    if args.no_trace:
        TRACER.enabled = False
    else:
        TRACER.enabled = True
        # outermost wrapper: every controller verb gets a trace span and
        # a latency sample, tagged cache-hit vs apiserver round-trip
        api = TracingClient(api)

    mgr = Manager(api, namespace=args.namespace,
                  health_port=args.health_port,
                  leader_elect=args.leader_elect,
                  write_qps=args.write_qps,
                  snapshot_dir=snapshot_dir)
    for rec in (ClusterPolicyReconciler, GPUDriverReconciler,
                UpgradeReconciler):
        mgr.add_reconciler(rec(client=api, namespace=args.namespace),
                           workers=args.workers, shards=args.shards)
    return mgr


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname).1s %(name)s %(message)s")
    log = logging.getLogger("tpu_operator_torch")

    from ..api.clusterpolicy import KIND_CLUSTER_POLICY, V1, new_cluster_policy

    if args.fake_cluster:
        from ..runtime import FakeClient
        client = FakeClient()
        for i in range(args.fake_gpu_nodes):
            client.add_node(f"gpu-node-{i}", labels=FAKE_NODE_LABELS,
                            allocatable=FAKE_NODE_ALLOCATABLE)
        client.create(new_cluster_policy())

        stop = threading.Event()

        def kubelet_loop():
            while not stop.is_set():
                try:
                    client.simulate_kubelet(ready=True)
                except Exception:
                    log.exception("kubelet sim failed")
                stop.wait(0.2)

        threading.Thread(target=kubelet_loop, daemon=True).start()
    else:
        from ..runtime.kubeclient import HTTPClient, KubeConfig
        cfg = (KubeConfig.from_kubeconfig(args.kubeconfig)
               if args.kubeconfig else KubeConfig.load())
        client = HTTPClient(cfg)
        stop = None

    mgr = wire_manager(client, args)
    mgr.start()
    log.info("gpu-operator started (namespace=%s, fake=%s, cache=%s, "
             "workers=%d, shards=%s)", args.namespace, args.fake_cluster,
             not args.no_cache, args.workers,
             args.shards if args.shards is not None else "env")

    try:
        start = time.monotonic()
        while True:
            if args.fake_cluster:
                try:
                    crs = client.list(V1, KIND_CLUSTER_POLICY)
                except Exception:
                    crs = []
                if crs:
                    state = (crs[0].get("status") or {}).get("state", "unknown")
                    log.info("policy %s state=%s (t=%.1fs)",
                             crs[0]["metadata"]["name"], state,
                             time.monotonic() - start)
                    if args.once and state == "ready":
                        log.info("reached ready in %.2fs — exiting (--once)",
                                 time.monotonic() - start)
                        return 0
            time.sleep(1.0)
    except KeyboardInterrupt:
        return 0
    finally:
        if stop:
            stop.set()
        mgr.stop()


if __name__ == "__main__":
    sys.exit(main())
