"""The port's ``HTTPClient`` (over ``urllib``) held to the reference's
(over ``requests``) against a live HTTP apiserver: each scenario runs on
both clients and compares what each server saw, the events each watch
delivered and the errors each raised. ``tests/mock_apiserver.py`` serves
CRUD, lists, watches that resume after ``drop_watch_streams`` and 409
conflicts; a small stub server does what the mock does not (pages, 429
with Retry-After, a 410 in the watch stream). One difference is on
purpose and asserted as such: the port pages a list (``limit`` and
``continue``), the reference's client ignores both (ROADMAP §C).
``test_torch_manager_http.py`` runs the whole operator over HTTP."""

import json
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import pytest

import torch_naming as N
from mock_apiserver import MockApiServer

from conftest import load_factor
from tpu_operator.api import clusterpolicy as rcp
from tpu_operator.runtime import kubeclient as rkube
from tpu_operator_torch.api import clusterpolicy as cp
from tpu_operator_torch.runtime import kubeclient as kube
from tpu_operator_torch.runtime.client import ListOptions

NS = "ops"
SIDES = {"reference": (rkube, rcp), "port": (kube, cp)}


def wait_until(pred, what, timeout=20.0):
    deadline = time.monotonic() + timeout * load_factor()
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def client_of(side, url, **kw):
    mod = SIDES[side][0]
    return mod.HTTPClient(mod.KubeConfig(server=url, **kw))


def cm(name, **data):
    return {"apiVersion": "v1", "kind": "ConfigMap",
            "metadata": {"name": name, "namespace": NS}, "data": data}


def summary(r):
    """What a call gave, minus the uid the mock draws at random."""
    if isinstance(r, dict):
        meta = r.get("metadata") or {}
        return [r.get("kind"), meta.get("name"), meta.get("resourceVersion"),
                bool(meta.get("uid")), r.get("data"),
                (r.get("status") or {}).get("state")]
    if isinstance(r, list):
        return [[o["kind"], o["metadata"]["name"]] for o in r]
    return r


def crud_transcript(side):
    """One CRUD script against a fresh mock: each step's summary, or the
    name of the error it raised."""
    srv = MockApiServer().start()
    c = client_of(side, srv.url, token="t", namespace=NS)
    api = SIDES[side][1]
    out = []

    def step(what, fn):
        try:
            r = fn()
        except Exception as e:  # the error is the result
            out.append([what, type(e).__name__])
            return None
        out.append([what, summary(r)])
        return r

    try:
        step("create", lambda: c.create(cm("a", k="1")))
        step("create again", lambda: c.create(cm("a")))
        got = step("get", lambda: c.get("v1", "ConfigMap", "a", NS))
        got["data"]["k"] = "2"
        step("update", lambda: c.update(got))
        step("update stale", lambda: c.update(got))
        srv.fail_next_writes = 1
        patch = {"data": {"x": "y"}}
        step("patch injected 409",
             lambda: c.patch("v1", "ConfigMap", "a", patch, NS))
        step("patch", lambda: c.patch("v1", "ConfigMap", "a", patch, NS))
        pol = step("create policy",
                   lambda: c.create(api.new_cluster_policy()))
        pol["status"] = {"state": "notReady"}
        step("update_status", lambda: c.update_status(pol))
        name = pol["metadata"]["name"]
        step("get policy",
             lambda: c.get(api.V1, api.KIND_CLUSTER_POLICY, name))
        for n, pool in (("n0", "a"), ("n1", "b")):
            step("create node", lambda: c.create(
                {"apiVersion": "v1", "kind": "Node",
                 "metadata": {"name": n, "labels": {"pool": pool}}}))
        page = step("list by label", lambda: c.list(
            "v1", "Node", ListOptions(label_selector={"pool": "a"},
                                      limit=1)))
        out.append(["continue", getattr(page, "continue_", None)])
        step("list", lambda: c.list("v1", "ConfigMap"))
        step("delete", lambda: c.delete("v1", "ConfigMap", "a", NS))
        step("get deleted", lambda: c.get("v1", "ConfigMap", "a", NS))
        step("delete again", lambda: c.delete("v1", "ConfigMap", "a", NS))
        out.append(["plurals", [SIDES[side][0].plural_of(k) for k in (
            api.KIND_CLUSTER_POLICY, "Policy", "Ingress")]])
    finally:
        c.close()
        srv.stop()
    return out


def test_crud_against_the_mock():
    ref, port = crud_transcript("reference"), crud_transcript("port")
    assert N.obj(ref) == port
    steps = dict((s[0], s[1]) for s in port)
    assert steps["create"][3] and steps["create"][2]
    assert steps["create again"] == "AlreadyExistsError"
    assert steps["update stale"] == "ConflictError"
    assert steps["patch injected 409"] == "ConflictError"
    assert steps["patch"][4] == {"k": "2", "x": "y"}
    assert int(steps["update"][2]) > int(steps["create"][2])
    assert steps["get policy"][5] == "notReady"
    assert steps["list by label"] == [["Node", "n0"]]
    assert steps["continue"] is None
    assert steps["list"] == [["ConfigMap", "a"]]
    assert steps["get deleted"] == steps["delete again"] == "NotFoundError"
    assert steps["plurals"] == ["gpuclusterpolicies", "policies",
                                "ingresses"]


def watch_transcript(side):
    srv = MockApiServer().start()
    c = client_of(side, srv.url, token="t", namespace=NS)
    try:
        c.create(cm("first"))
        events = []
        cancel = c.watch("v1", "ConfigMap",
                         lambda e: events.append([e.type, e.obj["metadata"][
                             "name"], e.obj["kind"]]))
        wait_until(lambda: len(events) == 1, "the initial list")
        c.create(cm("live"))
        wait_until(lambda: len(events) == 2, "a live event")
        srv.drop_watch_streams()
        c.create(cm("gap"))          # lands while the stream is down
        c.delete("v1", "ConfigMap", "first", NS)
        wait_until(lambda: len(events) == 4, "the missed events")
        time.sleep(0.3)
        cancel()
        return events
    finally:
        c.close()
        srv.stop()


def test_watch_resumes_after_a_dropped_stream():
    ref, port = watch_transcript("reference"), watch_transcript("port")
    # resumed from the last resourceVersion: no re-list replayed "first"
    assert ref == port == [["ADDED", "first", "ConfigMap"],
                           ["ADDED", "live", "ConfigMap"],
                           ["ADDED", "gap", "ConfigMap"],
                           ["DELETED", "first", "ConfigMap"]]


class Stub:
    """An apiserver that pages lists, throttles with 429, and sends a 410
    ERROR in its watch stream; it counts what it was asked."""

    def __init__(self):
        self.seen = []
        self.throttle = 0
        self.retry_after = "0"
        self.items = [{"metadata": {"name": f"n{i}",
                                    "resourceVersion": str(10 + i)}}
                      for i in range(5)]
        stub = self

        class H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def send_json(self, code, doc, extra=()):
                body = json.dumps(doc).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in extra:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                u = urlparse(self.path)
                q = {k: v[-1] for k, v in parse_qs(u.query).items()}
                stub.seen.append((u.path, q, self.headers.get(
                    "Authorization")))
                if stub.throttle > 0:
                    stub.throttle -= 1
                    return self.send_json(429, {"reason": "TooManyRequests"},
                                          [("Retry-After", stub.retry_after)])
                if q.get("watch") == "true":
                    evt = json.dumps({"type": "ERROR", "object": {
                        "kind": "Status", "code": 410,
                        "reason": "Expired"}}) + "\n"
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(evt)))
                    self.send_header("Connection", "close")
                    self.end_headers()
                    self.wfile.write(evt.encode())
                    self.close_connection = True
                    return
                if u.path.endswith("/nodes"):
                    start = int(q.get("continue", "0"))
                    limit = int(q.get("limit", "100"))
                    page = stub.items[start:start + limit]
                    nxt = start + limit
                    meta = {"resourceVersion": "20"}
                    if nxt < len(stub.items):
                        meta["continue"] = str(nxt)
                    return self.send_json(200, {"items": page,
                                                "metadata": meta})
                return self.send_json(200, {"metadata": {"name": "x"}})

        self.http = ThreadingHTTPServer(("127.0.0.1", 0), H)
        threading.Thread(target=self.http.serve_forever, args=(0.05,),
                         daemon=True).start()
        self.url = f"http://127.0.0.1:{self.http.server_address[1]}"

    def stop(self):
        self.http.shutdown()
        self.http.server_close()


def on_stub(script):
    """Run ``script(stub, side)`` on both clients, each on a fresh stub:
    {side: (what the script returned, what the stub saw)}."""
    out = {}
    for side in SIDES:
        stub = Stub()
        try:
            out[side] = (script(stub, side), stub.seen)
        finally:
            stub.stop()
    return out


def test_paged_list_follows_continue():
    def pages(stub, side):
        c = client_of(side, stub.url, token="tok")
        names, token, pages = [], None, 0
        while True:
            page = c.list("v1", "Node", ListOptions(limit=2, continue_=token))
            names += [n["metadata"]["name"] for n in page]
            pages += 1
            token = getattr(page, "continue_", None)
            if not token:
                break
        c.close()
        return names, pages

    got = on_stub(pages)
    (ref_names, ref_pages), ref_seen = got["reference"]
    (names, n_pages), seen = got["port"]
    assert names == ref_names == [f"n{i}" for i in range(5)]
    # the port pages on purpose; the reference's client sends neither
    # limit nor continue and takes the whole list in one answer
    assert n_pages == 3 and ref_pages == 1
    assert ref_seen == [("/api/v1/nodes", {}, "Bearer tok")]
    assert seen == [("/api/v1/nodes", {"limit": "2"}, "Bearer tok"),
                    ("/api/v1/nodes", {"limit": "2", "continue": "2"},
                     "Bearer tok"),
                    ("/api/v1/nodes", {"limit": "2", "continue": "4"},
                     "Bearer tok")]
    assert kube.HTTPClient.supports_chunked_list
    assert not rkube.HTTPClient.supports_chunked_list


def test_429_is_retried_then_surfaces():
    def throttled(stub, side):
        c = client_of(side, stub.url)
        out = []
        for throttle, av, kind, name in (
                (2, "v1", "ConfigMap", "x"),
                (3, "v1", "ConfigMap", "x"),
                # a Lease is never retried: a renew must not outlive it
                (1, "coordination.k8s.io/v1", "Lease", "l")):
            stub.throttle = throttle
            try:
                out.append(c.get(av, kind, name, "ns")["metadata"]["name"])
            except Exception as e:
                out.append((type(e).__name__, getattr(e, "code", None)))
            out.append(len(stub.seen))
        c.close()
        return out

    got = on_stub(throttled)
    assert got["reference"] == got["port"]
    assert got["port"][0] == ["x", 3, ("ApiError", 429), 6,
                              ("ApiError", 429), 7]


def test_close_interrupts_the_retry_wait():
    def interrupted(stub, side):
        c = client_of(side, stub.url)
        stub.throttle = 3
        stub.retry_after = "30"
        threading.Timer(0.2, c.close).start()
        t0 = time.monotonic()
        try:
            c.get("v1", "ConfigMap", "x", "ns")
        except Exception as e:
            return type(e).__name__, e.code, time.monotonic() - t0 < 5.0

    got = on_stub(interrupted)
    assert got["reference"] == got["port"]
    assert got["port"][0] == ("ApiError", 429, True)
    assert len(got["port"][1]) == 1


def test_410_in_the_stream_relists():
    def relisted(stub, side):
        c = client_of(side, stub.url)
        added = []
        cancel = c.watch("v1", "Node", lambda e: added.append(
            e.obj["metadata"]["name"]))
        wait_until(lambda: len(added) >= 10, "a relist after the 410")
        cancel()
        c.close()
        return added[:10]

    got = on_stub(relisted)
    assert got["reference"][0] == got["port"][0] == \
        [f"n{i}" for i in range(5)] * 2
    # list, watch from the list's resourceVersion, 410, list again, ...
    first = [(path, q) for path, q, _ in got["port"][1][:3]]
    assert first == [(path, q) for path, q, _ in got["reference"][1][:3]]
    assert first == [("/api/v1/nodes", {}),
                     ("/api/v1/nodes", {"watch": "true",
                                        "allowWatchBookmarks": "true",
                                        "resourceVersion": "20"}),
                     ("/api/v1/nodes", {})]


def test_watch_connect_times_out_into_the_relist_backoff():
    """A watch whose connect hangs (an apiserver blackholed or failing
    over) gives up after the connect timeout, the reference's 10 s and
    not the 300 s read timeout, then re-lists after the 2 s backoff."""
    rc = client_of("reference", "http://127.0.0.1:1")
    asked = []

    def refuse(url, **kw):
        asked.append(kw.get("timeout"))
        raise OSError("refused")

    rc.session.get = refuse
    rc._list_raw = lambda *a, **kw: ([], "1")
    cancel = rc.watch("v1", "Node", lambda e: None)
    wait_until(lambda: asked, "the reference's watch to connect")
    cancel()
    rc.close()
    limits = (kube.HTTPClient.WATCH_CONNECT_TIMEOUT_S,
              kube.HTTPClient.WATCH_READ_TIMEOUT_S)
    assert asked[0] == limits == (10, 300)

    # a listener whose backlog is full: a further connect hangs
    lst = socket.socket()
    lst.bind(("127.0.0.1", 0))
    lst.listen(0)
    held = []
    while True:
        s = socket.socket()
        s.settimeout(0.5)
        try:
            s.connect(lst.getsockname())
        except OSError:
            s.close()
            break
        held.append(s)
        assert len(held) < 8
    c = client_of("port", f"http://127.0.0.1:{lst.getsockname()[1]}")
    c.WATCH_CONNECT_TIMEOUT_S = 0.3
    c.WATCH_READ_TIMEOUT_S = 60.0
    lists = []

    def listed(*a, **kw):
        lists.append(time.monotonic())
        return [], "1"

    c._list_raw = listed
    cancel = c.watch("v1", "Node", lambda e: None)
    try:
        wait_until(lambda: len(lists) >= 2,
                   "a re-list after the connect timeout", timeout=8.0)
    finally:
        cancel()
        c.close()
        for s in held + [lst]:
            s.close()
    assert lists[1] - lists[0] >= 2.0  # the backoff, not a tight resume
