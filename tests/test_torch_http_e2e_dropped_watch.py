"""Where the seconds of a change made after every watch stream dropped go
(``chip_smoke.py`` phase N3; ROADMAP C12's record), run on both packages.

Phase N3 changes the policy's spec after ``drop_watch_streams()`` and has
seen it reach the DaemonSet 3.07 s, 7.08 s or 12.1 s later, where a plain
change takes ~60 ms. Every stream ends cleanly there (the mock writes its
last chunk), so each client resumes from its resourceVersion at once: no
2 s back-off, no relist. But every stream of the process reconnects in
the same few milliseconds, and ``tests/mock_apiserver.py``'s
``ThreadingHTTPServer`` listens with a backlog of 5
(``request_queue_size``): the kernel queues backlog + 1 connections and
drops the other SYNs, which TCP sends again 1 s later, then 2 s and 4 s
after that (3 s and 7 s in all); a stream still unanswered at the watch's
10 s connect timeout takes the 2 s back-off and re-lists. A stream
carries the change only once it is back, and where the controller's
stream is back before its informer's, the controller reads the policy
stale from the cache and the change waits for another event (C12). Both packages' clients do exactly this; the
port's, a connection a request, also sends the change's own PUT through
the same queue, where the reference's reuses a pooled connection.

``WatchStreamLog`` (``chip_smoke.py``) records each stream as the
apiserver sees it; a spy on the operator's own ``HTTPClient`` records,
per stream, whether its client resumed or re-listed, when it was back and
when the informer's store and each controller's handler got the change."""

import importlib
import json
import logging
import threading
import time

import pytest

import chip_smoke
from conftest import load_factor
from mock_apiserver import MockApiServer
from test_torch_http_e2e_restart import port_side, reference_side
from torch_http_e2e import operator_globals  # noqa: F401

MARKER = "N3_AFTER_DROP"
KUBECLIENT = {True: "tpu_operator.runtime.kubeclient",
              False: "tpu_operator_torch.runtime.kubeclient"}
POLICY_PATH = {True: "/tpuclusterpolicies/tpu-cluster-policy",
               False: "/gpuclusterpolicies/gpu-cluster-policy"}
LOGGER = {True: "tpu_operator.kubeclient",
          False: "tpu_operator_torch.kubeclient"}


class StreamSpy(logging.Handler):
    """Per watch stream of one ``HTTPClient``: its kind and role (the
    first subscriber of a kind is the informer's store, ``cache``; later
    ones are controllers'), each stream opened (time, the resourceVersion
    it resumed from), the warnings its thread logged (the exception
    path's "re-listing in 2s", a 410's error event), and when an event
    carrying ``MARKER`` reached its handler. Detach with ``close()``."""

    def __init__(self, client, ref: bool):
        super().__init__(logging.WARNING)
        self.streams = {}  # thread ident -> record
        self.subscribers = {}
        self.logger = logging.getLogger(LOGGER[ref])
        self.logger.addHandler(self)
        watch = client.watch

        def spy_watch(api_version, kind, handler, **kw):
            role = "cache" if kind not in self.subscribers else "controller"
            self.subscribers[kind] = self.subscribers.get(kind, 0) + 1
            rec = {"kind": kind, "role": role, "warnings": [], "opens": [],
                   "marked": None}

            def spy(evt):
                if rec["marked"] is None and MARKER in json.dumps(evt.obj):
                    rec["marked"] = time.monotonic()
                return handler(evt)

            before = set(threading.enumerate())
            cancel = watch(api_version, kind, spy, **kw)
            for th in set(threading.enumerate()) - before:
                if th.name == f"watch-{kind}":
                    self.streams[th.ident] = rec
            return cancel

        def opened(params):
            rec = self.streams.get(threading.get_ident())
            if rec is not None:
                rec["opens"].append((time.monotonic(),
                                     params.get("resourceVersion")))

        client.watch = spy_watch
        if ref:
            get = client.session.get

            def spy_get(url, params=None, **kw):
                out = get(url, params=params, **kw)
                if (params or {}).get("watch") == "true":
                    opened(params)
                return out

            client.session.get = spy_get
        else:
            open_stream = client._open_stream

            def spy_open(url, params):
                out = open_stream(url, params)
                opened(params)
                return out

            client._open_stream = spy_open

    def emit(self, record):
        rec = self.streams.get(record.thread)
        if rec is not None:
            rec["warnings"].append((record.created, record.getMessage()))

    def close(self):
        self.logger.removeHandler(self)
        super().close()

    def after(self, t0: float) -> list:
        """Each stream's path after ``t0`` (a ``time.monotonic()``): (kind,
        role, "resume" or "relist", s until it was back, s until the
        change reached it, the resourceVersion it came back from)."""
        wall0 = time.time() - (time.monotonic() - t0)
        out = []
        for rec in self.streams.values():
            opens = [(t, rv) for t, rv in rec["opens"] if t >= t0]
            if not opens:
                out.append((rec["kind"], rec["role"], None, None, None,
                            None))
                continue
            relisted = any(t >= wall0 for t, _ in rec["warnings"])
            marked = None if rec["marked"] is None else rec["marked"] - t0
            out.append((rec["kind"], rec["role"],
                        "relist" if relisted else "resume",
                        opens[0][0] - t0, marked, opens[0][1]))
        return sorted(out, key=lambda r: (r[0], r[1]))


def retrying(fn, *args):
    """``fn(*args)``, again after a refused or reset connection, as phase
    N retries its own requests: while every stream reconnects, a new
    connection (each of the port's requests opens one) can be reset."""
    for attempt in range(10):
        try:
            return fn(*args)
        except OSError:
            if attempt == 9:
                raise
            time.sleep(0.2)


def n3_sequence(ref: bool) -> dict:
    """N3 on the CPU with the informer cache on, as ``gpu-operator`` runs:
    a plain change, a change through injected 409s, every watch stream
    dropped, then a spec change. The policy is created before the
    operator starts, as the cache-on restart tier does (C12 can drop a
    policy created under a running cache-on operator)."""
    srv = MockApiServer().start()
    streams = chip_smoke.WatchStreamLog(srv)
    side = (reference_side if ref else port_side)(srv)
    ops, st = side["ops"], side["cr_state"]
    tracer_was = side["tracer"].enabled

    def change(name):
        retrying(side["update_spec"], ops, lambda spec: spec.setdefault(
            "devicePlugin", {}).update({"env": [{"name": name,
                                                 "value": "1"}]}))

    spies = []
    kube = importlib.import_module(KUBECLIENT[ref])
    client_cls = kube.HTTPClient
    init = client_cls.__init__

    def spied_init(self, *a, **kw):  # the operator's client, made in start
        init(self, *a, **kw)
        spies.append(StreamSpy(self, ref))

    try:
        for i in range(2):
            ops.create(side["node"](f"node-{i}"))
        side["install"](ops)
        client_cls.__init__ = spied_init
        try:
            mgr, client = side["start"]()
        finally:
            client_cls.__init__ = init
        try:
            side["wait_for"](ops, lambda: st(ops) == "ready", "ready")
            change("N3_PLAIN")
            srv.fail_next_writes = chip_smoke.INJECTED_CONFLICTS
            change("N3_AFTER_CONFLICTS")
            deadline = time.monotonic() + 30.0 * load_factor()
            while srv.fail_next_writes and time.monotonic() < deadline:
                side["wait_for"](ops, lambda: True, "a kubelet tick")
            assert srv.fail_next_writes == 0, "the 409s were never taken"
            streams.marker = json.dumps(MARKER).encode()
            open_before = sum(s["ended"] is None for s in streams.streams)
            t_drop = time.monotonic()
            srv.drop_watch_streams()
            change(MARKER)
            [spy] = [s for s in spies if s.streams]
            deadline = time.monotonic() + 20.0 * load_factor()
            while time.monotonic() < deadline and any(
                    r[2] is None or (r[0].endswith("ClusterPolicy")
                                     and r[4] is None)
                    for r in spy.after(t_drop)):
                time.sleep(0.05)
        finally:
            side["stop"](mgr, client)
    finally:
        for s in spies:
            s.close()
        side["tracer"].enabled = tracer_was
        side["close"]()
        srv.stop()
    return {"open_before": open_before,
            "server": streams.after(t_drop, (), POLICY_PATH[ref]),
            "client": spy.after(t_drop)}


@pytest.mark.parametrize("ref", [True, False], ids=["reference", "port"])
def test_n3_every_stream_resumes_and_carries_the_change_once_back(ref):
    """Per stream: it ended at the drop, its client took the clean path
    (resumed from its resourceVersion; the 2 s back-off and relist only
    after a reset or a connect timing out), and the change reached the
    informer's store and each controller no sooner than that stream was
    back and the PUT had landed, and soon after the later of the two."""
    out = n3_sequence(ref)
    server, client = out["server"], out["client"]
    # every stream open at the drop ended with it, and each came back
    assert server["dropped"] == out["open_before"] > 10
    assert server["ended_ms"][1] < 1000 * load_factor()
    assert server["reopened"] >= server["dropped"]
    assert len(client) == server["dropped"]
    put = server["puts_ms"][0] / 1e3
    policy = [r for r in client if r[0].endswith("ClusterPolicy")]
    assert {r[1] for r in policy} == {"cache", "controller"}
    for kind, role, path, back, marked, rv in client:
        assert path in ("resume", "relist"), (kind, role)
        if path == "relist":  # a reset: the exception path's back-off
            assert back >= 2.0, (kind, role, back)
        else:
            assert rv, (kind, role)
    for kind, role, path, back, marked, rv in policy:
        assert marked is not None, (kind, role)
        assert marked >= max(back, put) - 0.01, (role, back, put, marked)
        assert marked - max(back, put) < 1.0 * load_factor(), (role, back)


@pytest.mark.parametrize("ref", [True, False], ids=["reference", "port"])
def test_n3_reconnects_past_the_accept_queue_wait_for_a_syn_resent(ref):
    """The seconds themselves, held still: with the mock's accept loop
    paused across the drop, sixteen clients' streams reconnect into a
    listen backlog of 5. The kernel queues backlog + 1 of them, which are
    back as soon as the loop accepts again; every other reconnect waits
    for its SYN to be sent again, 1 s after the first. Each still
    resumes from its resourceVersion (no relist), and gets the change
    only once back."""
    from http.server import ThreadingHTTPServer

    kube = importlib.import_module(KUBECLIENT[ref])
    backlog = ThreadingHTTPServer.request_queue_size
    n = 16
    srv = MockApiServer().start()
    streams = chip_smoke.WatchStreamLog(srv)
    accepting = threading.Event()
    accepting.set()
    accept = srv.http.get_request

    def get_request():
        accepting.wait()
        return accept()

    srv.http.get_request = get_request
    cfg = kube.KubeConfig(server=srv.url, token="t", namespace="n3")
    writer = kube.HTTPClient(cfg)
    clients = [kube.HTTPClient(cfg) for _ in range(n)]
    spies = [StreamSpy(c, ref) for c in clients]
    cm = {"apiVersion": "v1", "kind": "ConfigMap",
          "metadata": {"name": "cm", "namespace": "n3"}, "data": {"k": "0"}}
    try:
        writer.create(cm)
        for c in clients:
            c.watch("v1", "ConfigMap", lambda evt: None)
        deadline = time.monotonic() + 10.0 * load_factor()
        while len(streams.streams) < n and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.2)
        accepting.clear()
        t_drop = time.monotonic()
        srv.drop_watch_streams()
        time.sleep(0.5)
        accepting.set()
        streams.marker = json.dumps(MARKER).encode()
        obj = dict(retrying(writer.get, "v1", "ConfigMap", "cm", "n3"))
        obj["data"] = {"k": MARKER}
        retrying(writer.update, obj)
        deadline = time.monotonic() + 10.0 * load_factor()
        while time.monotonic() < deadline and any(
                r[4] is None for s in spies for r in s.after(t_drop)):
            time.sleep(0.05)
        paths = [r for s in spies for r in s.after(t_drop)]
    finally:
        accepting.set()
        for s in spies:
            s.close()
        for c in [writer, *clients]:
            (c._stop.set if ref else c.close)()
        srv.stop()
    backs = sorted(r[3] for r in paths)
    on_time = [b for b in backs if b < chip_smoke.RETRANSMIT_S]
    assert [r[2] for r in paths] == ["resume"] * n
    assert all(r[5] for r in paths)
    assert 1 <= len(on_time) <= backlog + 1, backs
    assert all(b >= 0.5 for b in on_time), backs  # the loop held them
    assert len(backs) - len(on_time) >= n - (backlog + 1), backs
    assert all(r[4] is not None and r[4] >= r[3] - 0.01 for r in paths)


def summary(out: dict) -> dict:
    """One run's attribution, in ms after the drop: when the streams came
    back, how many past RETRANSMIT_S, each path, when the PUT landed, and
    each policy stream's (role, back, the change reached it)."""
    client = out["client"]
    backs = sorted(round(r[3] * 1e3, 1) for r in client if r[3] is not None)
    paths = {}
    for r in client:
        paths[r[2]] = paths.get(r[2], 0) + 1
    return {"streams": out["server"]["dropped"], "paths": paths,
            "back_ms": backs,
            "past_retransmit": sum(b >= chip_smoke.RETRANSMIT_S * 1e3
                                   for b in backs),
            "put_ms": out["server"]["puts_ms"][:1],
            "policy": [(r[1], round(r[3] * 1e3, 1), round(r[4] * 1e3, 1))
                       for r in client if r[0].endswith("ClusterPolicy")]}


if __name__ == "__main__":
    # PYTHONPATH=. python tests/test_torch_http_e2e_dropped_watch.py [runs]:
    # N3's sequence in each package, one JSON line a run
    import sys

    for ref in (True, False):
        for _ in range(int(sys.argv[1]) if len(sys.argv) > 1 else 1):
            print(json.dumps({"package": "reference" if ref else "port",
                              **summary(n3_sequence(ref))}), flush=True)
