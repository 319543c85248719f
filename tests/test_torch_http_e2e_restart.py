"""The port's operator restarted over HTTP: the reference's restart tier
(``tests/test_http_e2e.py:565-632``: a fresh Manager against the same
apiserver rewrites no unchanged operand and still acts), read-through as
the reference's tier runs it, and the case that tier never runs: the
same install and restart with the informer cache on, which is
``wire_manager``'s default and what ``gpu-operator`` runs.

Over HTTP that cache has C5's start-up race (ROADMAP §C): a kind read for
the first time subscribes an informer whose list has not landed, so the
read misses. Run on both packages (the reference wired as its
``cli/operator.py`` wires it), the cache-on restart pays the same cost:
creates of objects that exist, answered 409, a state's sync failing on
them and the ready policy written notReady until the next pass. No
DaemonSet is rewritten, and the install itself, on an empty cluster,
meets no 409. This is pinned in both packages."""

import time

import pytest

from conftest import load_factor
from mock_apiserver import MockApiServer
from torch_http_e2e import (NS, Answers, boot, config, cr_state,
                            daemonset_rvs, env_present, gpu_node, install,
                            operator_globals,  # noqa: F401
                            set_plugin_env, shutdown, update_spec, wait_for)
from tpu_operator_torch.runtime.kubeclient import HTTPClient


def test_operator_restart_over_http_no_churn_then_converges():
    """Kill the whole Manager in a steady state and boot a fresh one
    against the same apiserver: the hash-skip annotations keep every
    unchanged operand as it is, and the new Manager still acts."""
    srv = MockApiServer().start()
    ops = HTTPClient(config(srv))
    try:
        for i in range(2):
            ops.create(gpu_node(f"gpu-{i}"))
        mgr, client = boot(srv)
        try:
            install(ops)
            wait_for(ops, lambda: cr_state(ops) == "ready", "initial ready")
        finally:
            shutdown(mgr, client)
        rvs_before = daemonset_rvs(ops)
        assert rvs_before, "no DaemonSets before restart"
        mgr, client = boot(srv)
        try:
            wait_for(ops, lambda: cr_state(ops) == "ready",
                     "ready after restart")
            time.sleep(2.0)  # full resync passes of the fresh manager
            assert daemonset_rvs(ops) == rvs_before, \
                "operator restart rewrote unchanged operands"
            update_spec(ops, set_plugin_env("AFTER_RESTART"))
            wait_for(ops, env_present(ops, "AFTER_RESTART"),
                     "post-restart mutation applied")
        finally:
            shutdown(mgr, client)
    finally:
        ops.close()
        srv.stop()


def reference_side(srv):
    """The reference's operator over ``srv`` as its ``cli/operator.py``
    wires it by default: the tracing client over the informer cache over
    ``HTTPClient``, its four reconcilers."""
    import test_http_e2e as R
    from tpu_operator.controllers.clusterpolicy_controller import (
        ClusterPolicyReconciler)
    from tpu_operator.controllers.placement_controller import (
        PlacementReconciler)
    from tpu_operator.controllers.tpudriver_controller import (
        TPUDriverReconciler)
    from tpu_operator.controllers.upgrade_controller import UpgradeReconciler
    from tpu_operator.runtime import CachedClient, Manager, TracingClient
    from tpu_operator.runtime.kubeclient import HTTPClient as RHTTP
    from tpu_operator.runtime.kubeclient import KubeConfig as RConfig
    from tpu_operator.runtime.tracing import TRACER

    cfg = RConfig(server=srv.url, token="e2e-token", namespace=R.NS)

    def start():
        client = RHTTP(config=cfg)
        api = TracingClient(CachedClient(client))
        mgr = Manager(api, namespace=R.NS)
        for rec in (ClusterPolicyReconciler, TPUDriverReconciler,
                    UpgradeReconciler, PlacementReconciler):
            mgr.add_reconciler(rec(client=api, namespace=R.NS))
        mgr.start()
        return mgr, client

    def stop(mgr, client):
        mgr.stop()
        client._stop.set()

    ops = RHTTP(config=cfg)
    return {"ops": ops, "node": R.tpu_node, "start": start, "stop": stop,
            "install": R.install, "cr_state": R.cr_state,
            "wait_for": R.wait_for, "update_spec": R.update_spec,
            "close": ops._stop.set, "tracer": TRACER, "ns": R.NS,
            "env_ds": "tpu-device-plugin-daemonset"}


def port_side(srv):
    from tpu_operator_torch.runtime.tracing import TRACER

    ops = HTTPClient(config(srv))
    return {"ops": ops, "node": gpu_node,
            "start": lambda: boot(srv, cache=True), "stop": shutdown,
            "install": install, "cr_state": cr_state, "wait_for": wait_for,
            "update_spec": update_spec, "close": ops.close,
            "tracer": TRACER, "ns": NS,
            "env_ds": "gpu-device-plugin-daemonset"}


@pytest.mark.parametrize("ref", [True, False], ids=["reference", "port"])
def test_cache_on_restart_pays_c5_and_rewrites_no_operand(ref):
    """The policy is created before the operator starts, as an install
    creates it before the operator's pods run (a policy created under a
    running cache-on operator can be dropped: C12, below)."""
    from tpu_operator_torch.runtime.client import ListOptions

    srv = MockApiServer().start()
    answers = Answers(srv)
    side = (reference_side if ref else port_side)(srv)
    ops, st = side["ops"], side["cr_state"]
    tracer_was = side["tracer"].enabled

    def daemonsets():
        return {d["metadata"]["name"]: d["metadata"]["resourceVersion"]
                for d in ops.list("apps/v1", "DaemonSet",
                                  ListOptions(namespace=side["ns"]))}

    try:
        for i in range(2):
            ops.create(side["node"](f"node-{i}"))
        side["install"](ops)
        answers.take()
        mgr, client = side["start"]()
        try:
            side["wait_for"](ops, lambda: st(ops) == "ready",
                             "ready with the cache on")
        finally:
            side["stop"](mgr, client)
        at_start = answers.take()
        created = {p for m, p, code, _ in at_start
                   if m == "POST" and code == 201}
        rvs_before = daemonsets()
        mgr, client = side["start"]()
        try:
            deadline = time.time() + 30.0 * load_factor()
            while time.time() < deadline and not any(
                    s for *_, s in answers.entries):
                time.sleep(0.05)  # the restarted pass's first status write
            side["wait_for"](ops, lambda: st(ops) == "ready",
                             "ready after the restart")
            time.sleep(2.0)  # full resync passes of the fresh manager
            rvs_after = daemonsets()
            at_restart = answers.take()
        finally:
            side["stop"](mgr, client)
    finally:
        side["tracer"].enabled = tracer_was
        side["close"]()
        srv.stop()
    # the first start, on a cluster with no operand: every create lands
    assert created and not [a for a in at_start if a[2] == 409]
    # the restart: creates of objects the first start made, answered 409
    conflicts = [(m, p) for m, p, code, _ in at_restart if code == 409]
    assert conflicts and {m for m, _ in conflicts} == {"POST"}
    assert {p for _, p in conflicts} <= created, conflicts
    # the ready policy is written notReady, then ready again
    states = [s for *_, s in at_restart if s]
    assert states[0] == "notReady" and states[-1] == "ready"
    # and no DaemonSet is rewritten
    assert rvs_after == rvs_before


@pytest.mark.parametrize("ref", [True, False], ids=["reference", "port"])
def test_c12_a_watch_event_can_reach_the_controller_before_the_cache(ref):
    """C12, kept: over HTTP the informer's watch and a controller's are two
    streams, each read by its own thread. Subscribing the informer first
    orders their handlers on a client that delivers synchronously, not
    here: when the informer's stream is the slower, the controller's
    handler reads the object it is told of from a store that does not
    have it yet. A new object reads NotFound and its key is dropped; a
    changed one reads stale and the reconcile writes nothing."""
    from tpu_operator.runtime import cache as rcache
    from tpu_operator.runtime import kubeclient as rkube
    from tpu_operator_torch.runtime import cache, kubeclient

    kube, cache_mod = (rkube, rcache) if ref else (kubeclient, cache)
    srv = MockApiServer().start()
    cfg = kube.KubeConfig(server=srv.url, token="t", namespace=NS)
    inner, writer = kube.HTTPClient(cfg), kube.HTTPClient(cfg)
    streams = []
    watch = inner.watch

    def watch_with_a_slow_informer(api_version, kind, handler, **kw):
        if not streams:  # the first subscriber is the informer's store

            def late(evt, _handler=handler):
                if evt.type != "ADDED" or streams[0]:
                    time.sleep(0.5)
                _handler(evt)
            streams.append(False)
            cancel = watch(api_version, kind, late, **kw)
            streams[0] = True  # its initial list has landed
            return cancel
        return watch(api_version, kind, handler, **kw)

    inner.watch = watch_with_a_slow_informer
    c = cache_mod.CachedClient(inner)
    read = []

    def controller(evt):
        name = evt.obj["metadata"]["name"]
        if evt.type == "ADDED" and name == "new":
            read.append(("new", c.get_or_none("v1", "ConfigMap", name, NS)))
        elif evt.type == "MODIFIED":
            obj = c.get("v1", "ConfigMap", name, NS)
            read.append((name, (obj.get("data") or {}).get("k")))

    def cm(name, k):
        return {"apiVersion": "v1", "kind": "ConfigMap",
                "metadata": {"name": name, "namespace": NS},
                "data": {"k": k}}

    try:
        writer.create(cm("old", "v0"))
        cancel = c.watch("v1", "ConfigMap", controller)
        deadline = time.monotonic() + 10.0 * load_factor()
        while c.get_or_none("v1", "ConfigMap", "old", NS) is None and \
                time.monotonic() < deadline:
            time.sleep(0.05)
        writer.create(cm("new", "v0"))
        obj = dict(writer.get("v1", "ConfigMap", "old", NS))
        obj["data"] = {"k": "v1"}
        writer.update(obj)
        while len(read) < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        cancel()
        # the controller read the new object as absent, the changed one
        # as it was; the store catches up half a second later
        assert read == [("new", None), ("old", "v0")]
        while time.monotonic() < deadline and (c.get_or_none(
                "v1", "ConfigMap", "new", NS) is None or c.get(
                "v1", "ConfigMap", "old", NS)["data"]["k"] != "v1"):
            time.sleep(0.05)
        assert c.get("v1", "ConfigMap", "old", NS)["data"]["k"] == "v1"
    finally:
        c.close()
        for client in (inner, writer):
            (client._stop.set if ref else client.close)()
        srv.stop()
