"""Seeded chaos soak of the port's operator over HTTP: the counterpart of
the reference's ``tests/test_soak.py``, with its seed and its scripted
adversary (policy edits, operand deletion, node churn, watch-stream
drops, injected write conflicts, a driver rollout), against the Manager
``gpu-operator`` wires (``--no-cache``, as the reference's soak runs its
Manager on the raw client) over the live mock apiserver. After every
disruption the policy converges to ``ready`` with the desired config in
effect. ``GPU_SOAK_SEED`` and ``GPU_SOAK_STEPS`` widen it, as
``TPU_SOAK_SEED`` and ``TPU_SOAK_STEPS`` widen the reference's."""

from __future__ import annotations

import json
import os
import random
import time

from conftest import load_factor
from mock_apiserver import MockApiServer
from torch_http_e2e import (DEVICE_PLUGIN_DS, DRIVER_COMPONENT, DRIVER_DS,
                            NS, boot, config, cr_state, gpu_node, install,
                            operator_globals,  # noqa: F401
                            plugin_env, shutdown)
from tpu_operator_torch.api.clusterpolicy import KIND_CLUSTER_POLICY, V1
from tpu_operator_torch.api import labels as L
from tpu_operator_torch.runtime import ListOptions
from tpu_operator_torch.runtime.fake import simulate_kubelet
from tpu_operator_torch.runtime.kubeclient import HTTPClient
from tpu_operator_torch.runtime.objects import get_nested, labels_of, thaw_obj
from tpu_operator_torch.utils.hash import object_hash

SEED = int(os.environ.get("GPU_SOAK_SEED", "20260730"))


def wait_converged(ops, pred, desc, timeout=90.0):
    """``pred`` runs every pass even when the kubelet tick loses a write
    race; kubelet and pred errors are reported apart."""
    end = time.time() + timeout * load_factor()
    kubelet_err = None
    pred_err = None
    while time.time() < end:
        try:
            simulate_kubelet(ops, ready=True)
        except Exception as e:
            kubelet_err = e
        try:
            if pred():
                return
        except Exception as e:
            pred_err = e
        time.sleep(0.25)
    raise AssertionError(f"soak: no convergence after {desc} "
                         f"(kubelet error: {kubelet_err}; "
                         f"pred error: {pred_err})")


def test_chaos_soak_converges_after_every_disruption():
    rng = random.Random(SEED)
    srv = MockApiServer().start()
    ops = HTTPClient(config(srv, "soak"))
    next_node = [2]

    def ready():
        return cr_state(ops) == "ready"

    def update_policy(mutate_fn):
        """Conflict-retried CR mutation; a move that never lands fails
        loudly."""
        for _ in range(10):
            cr = thaw_obj(ops.get(V1, KIND_CLUSTER_POLICY,
                                  "gpu-cluster-policy"))
            mutate_fn(cr.setdefault("spec", {}))
            try:
                ops.update(cr)
                return
            except Exception:
                time.sleep(0.1)
        raise AssertionError("soak: policy mutation never landed "
                             "after 10 conflict retries")

    # -- the adversary's moves (each returns a description, a predicate)
    def mutate_policy():
        marker = f"SOAK_{rng.randrange(1_000_000)}"
        update_policy(lambda spec: spec.setdefault("devicePlugin", {})
                      .__setitem__("env", [{"name": "SOAK_MARKER",
                                            "value": marker}]))

        def applied():
            return any(e.get("value") == marker
                       for e in plugin_env(ops)) and ready()

        return f"policy mutation {marker}", applied

    def delete_operand():
        victims = [d for d in ops.list(
            "apps/v1", "DaemonSet", ListOptions(namespace=NS))
            if "device-plugin" in d["metadata"]["name"]
            or "metrics" in d["metadata"]["name"]]
        if victims:
            v = rng.choice(victims)
            ops.delete("apps/v1", "DaemonSet", v["metadata"]["name"], NS)
            name = v["metadata"]["name"]
        else:
            name = "(none)"

        def recreated():
            return ready() and all(
                ops.get_or_none("apps/v1", "DaemonSet",
                                d["metadata"]["name"], NS) is not None
                for d in victims)

        return f"operand {name} deleted", recreated

    def add_node():
        name = f"gpu-{next_node[0]}"
        next_node[0] += 1
        ops.create(gpu_node(name))

        def labeled():
            n = ops.get("v1", "Node", name)
            return labels_of(n).get(L.PRESENT) == "true" and ready()

        return f"node {name} joined", labeled

    def remove_node():
        nodes = [n for n in ops.list("v1", "Node")
                 if n["metadata"]["name"] != "gpu-0"]  # keep a GPU node
        if nodes:
            victim = rng.choice(nodes)["metadata"]["name"]
            # a vanished node takes its pods along
            for p in ops.list("v1", "Pod", ListOptions(namespace=NS)):
                if get_nested(p, "spec", "nodeName") == victim:
                    ops.delete("v1", "Pod", p["metadata"]["name"], NS)
            ops.delete("v1", "Node", victim)
        return "node removed", ready

    def drop_watches():
        # a mutation the operator must still apply proves the resume
        srv.drop_watch_streams()
        desc, pred = mutate_policy()
        return f"watch streams dropped + {desc}", pred

    def inject_conflicts():
        # mutate first, then arm: armed first, the adversary's own retry
        # loop would take the 409s
        desc, pred = mutate_policy()
        n = rng.randrange(1, 4)
        srv.fail_next_writes = n
        return f"{desc} + {n} write conflicts injected", pred

    def trigger_upgrade():
        # an OnDelete driver template change: nothing rolls until the
        # upgrade FSM walks every node through cordon, drain, pod
        # restart, re-validation and uncordon
        marker = f"/opt/soak-driver-{rng.randrange(1_000_000)}"
        update_policy(lambda spec: spec.setdefault("driver", {})
                      .__setitem__("installDir", marker))

        def rolled():
            if not ready():
                return False
            nodes = ops.list("v1", "Node")
            gpu_nodes = [n for n in nodes
                         if labels_of(n).get(L.GKE_ACCELERATOR)]
            if any(labels_of(n).get(L.UPGRADE_STATE) not in (None, "done")
                   for n in gpu_nodes):
                return False
            if any(get_nested(n, "spec", "unschedulable", default=False)
                   for n in nodes):
                return False
            # the marker reached the template, and one live driver pod a
            # GPU node runs the new revision
            ds = ops.get_or_none("apps/v1", "DaemonSet", DRIVER_DS, NS)
            if ds is None or marker not in json.dumps(ds):
                return False
            want = object_hash(
                get_nested(ds, "spec", "template", default={}))
            pods = [p for p in ops.list("v1", "Pod", ListOptions(
                        namespace=NS, label_selector=DRIVER_COMPONENT))
                    if not get_nested(p, "metadata", "deletionTimestamp")]
            return (len(pods) == len(gpu_nodes)
                    and all(get_nested(p, "metadata", "labels",
                                       "controller-revision-hash") == want
                            for p in pods))

        return f"driver template changed ({marker}): FSM rollout", rolled

    moves = [mutate_policy, delete_operand, add_node, remove_node,
             drop_watches, inject_conflicts, trigger_upgrade]

    mgr, client = boot(srv)
    try:
        for i in range(2):
            ops.create(gpu_node(f"gpu-{i}"))
        # autoUpgrade on, wide budget: the rollout move needs the FSM
        install(ops, spec={"upgradePolicy": {"autoUpgrade": True,
                                             "maxParallelUpgrades": 4}})
        wait_converged(ops, ready, "initial install")
        for step in range(int(os.environ.get("GPU_SOAK_STEPS", "10"))):
            move = rng.choice(moves)
            desc, pred = move()
            wait_converged(ops, pred, f"step {step}: {desc}",
                           timeout=180.0 if move is trigger_upgrade
                           else 90.0)
        # one fleet rollout whatever the seed drew, over the cluster the
        # chaos left
        desc, pred = trigger_upgrade()
        wait_converged(ops, pred, f"final: {desc}", timeout=180.0)
        assert DEVICE_PLUGIN_DS in {d["metadata"]["name"] for d in ops.list(
            "apps/v1", "DaemonSet", ListOptions(namespace=NS))}
    finally:
        shutdown(mgr, client)
        ops.close()
        srv.stop()
