"""The reference's wire conformance tier (``tests/test_kubeclient_conformance.py``,
its 14 cases) held on both packages' ``HTTPClient``: the port's over
``urllib`` and ``http.client`` (``for line in resp``), the reference's over
``requests``. Each case replays the reference's byte-exact apiserver
payloads through its raw TCP server (``WireApiServer``: chunked frames
split mid-JSON and mid-UTF-8, CRLF, BOOKMARK resume, 410 then relist,
v1.Status bodies for 409/422, Eviction 201/429, 429 with Retry-After, a
Lease's 429), once a package, and asserts the reference's behaviour on
each and the same request sequence on the wire under ``torch_naming.py``.

Declared differences (ROADMAP §C), none of which these cases reach: the
port pages a list when asked (``limit``/``continue``), the reference's
ignores both; the port's ``evict`` posts once, outside the throttle
retry, as the reference's does. A case naming a TPU CRD or the
reference's Lease names the port's through the rule, payload and all."""

import time
import urllib.parse

import pytest

import torch_naming as N
from test_kubeclient_conformance import (CHUNKED_HEAD, END_CHUNKS, Exchange,
                                         WireApiServer, chunk, plain, pod,
                                         pod_list, throttled, watch_frame)
from tpu_operator.runtime import client as rclient
from tpu_operator.runtime import kubeclient as rkube
from tpu_operator_torch.runtime import client as pclient
from tpu_operator_torch.runtime import kubeclient as pkube

SIDES = {"reference": (rkube, rclient), "port": (pkube, pclient)}


class Side:
    """One package's client over a fresh wire server, and the names a case
    states in it."""

    def __init__(self, side: str):
        self.ref = side == "reference"
        self.kube, self.errors = SIDES[side]
        self.srv = WireApiServer().start()
        self.client = self.kube.HTTPClient(self.kube.KubeConfig(
            server=self.srv.url, token="t", namespace="default"))

    def name(self, value):
        return value if self.ref else N.name(value)

    def close(self):
        if self.ref:
            self.client._stop.set()
        else:
            self.client.close()
        self.srv.stop()


def wire_path(path: str) -> str:
    """A reference request path under the rule: the CRD's group and
    version, then each segment."""
    for a, b in N.CRD.items():
        if "/" in a:
            path = path.replace(f"/{a}/", f"/{b}/")
    return "/".join(N.CRD_NAMES.get(seg, N.name(seg))
                    for seg in path.split("/"))


def run(case, side: str):
    """``case(s)`` on one package: (what the client did, the requests it
    put on the wire)."""
    s = Side(side)
    try:
        outcome = case(s)
        return outcome, list(s.srv.requests)
    finally:
        s.close()


def both(case):
    """``case`` on both packages; the port's wire sequence equals the
    reference's under the rule, and each outcome is returned."""
    ref, ref_wire = run(case, "reference")
    port, port_wire = run(case, "port")
    assert port_wire == [(m, wire_path(p), q) for m, p, q in ref_wire]
    return ref, port


def kinds(reqs):
    return ["watch" if q.get("watch") == "true" else "list"
            for _, _, q in reqs]


def watches(reqs):
    return [q for _, _, q in reqs if q.get("watch") == "true"]


def watched(s, exchanges_plain, exchanges_watch, n_watches=2,
            project=lambda e: (e.type, e.obj["metadata"]["resourceVersion"])):
    """Script a Pod list+watch, subscribe, wait for ``n_watches`` watch
    requests: (the events as ``project`` sees them, the requests)."""
    s.srv.script("GET", "plain", *exchanges_plain)
    s.srv.script("GET", "watch", *exchanges_watch)
    events = []
    cancel = s.client.watch("v1", "Pod", events.append)
    try:
        reqs = s.srv.wait_requests(lambda r: len(
            [x for x in r if x[2].get("watch") == "true"]) >= n_watches)
        return [project(e) for e in events], reqs
    finally:
        cancel()


def raised(fn, *a, **kw):
    """(error class name, its message, its code) of ``fn(*a)``, or None."""
    try:
        fn(*a, **kw)
    except Exception as e:  # the error is the outcome
        return type(e).__name__, str(e), getattr(e, "code", None)
    return None


# -- the watch wire -----------------------------------------------------------


def test_chunk_boundaries_split_mid_frame():
    def case(s):
        e1 = watch_frame("ADDED", pod("a", "101"))
        e2 = watch_frame("MODIFIED", pod("a", "102"))
        body = chunk(e1[:11]) + chunk(e1[11:] + e2[:5]) + chunk(e2[5:]) \
            + END_CHUNKS
        events, _ = watched(
            s, [Exchange(pod_list("100"))],
            [Exchange(CHUNKED_HEAD + body, split=7, frame_delay_s=0.001),
             Exchange(CHUNKED_HEAD, hold=True)])
        return events

    ref, port = both(case)
    assert ref == port == [("ADDED", "101"), ("MODIFIED", "102")]


def test_multibyte_utf8_split_across_chunks():
    def case(s):
        import json

        p = pod("a", "101")
        p["metadata"]["annotations"] = {"note": "tpü✓"}
        e1 = json.dumps({"type": "ADDED", "object": p},
                        ensure_ascii=False).encode() + b"\n"
        cut = e1.index("✓".encode()) + 1  # inside the 3-byte char
        body = chunk(e1[:cut]) + chunk(e1[cut:]) + END_CHUNKS
        events, _ = watched(
            s, [Exchange(pod_list("100"))],
            [Exchange(CHUNKED_HEAD + body, split=3, frame_delay_s=0.001),
             Exchange(CHUNKED_HEAD, hold=True)],
            project=lambda e: (e.type, e.obj["metadata"]["annotations"]
                               ["note"]))
        return events

    ref, port = both(case)
    assert ref == port == [("ADDED", "tpü✓")]


def test_bookmark_advances_resume_rv_without_relist():
    bookmark = {"kind": "Pod", "apiVersion": "v1",
                "metadata": {"resourceVersion": "500",
                             "creationTimestamp": None}}

    def case(s):
        events, reqs = watched(
            s, [Exchange(pod_list("100", pod("a", "90")))],
            [Exchange(CHUNKED_HEAD
                      + chunk(watch_frame("MODIFIED", pod("a", "101")))
                      + chunk(watch_frame("BOOKMARK", bookmark))
                      + END_CHUNKS),
             Exchange(CHUNKED_HEAD, hold=True)],
            project=lambda e: e.type)
        return events, reqs

    (ref, reqs), (port, port_reqs) = both(case)
    for events, r in ((ref, reqs), (port, port_reqs)):
        assert kinds(r).count("list") == 1, f"re-listed after bookmark: {r}"
        ws = watches(r)
        assert ws[0].get("resourceVersion") == "100"
        assert ws[1].get("resourceVersion") == "500"
        assert ws[1].get("allowWatchBookmarks") == "true"
        assert events == ["ADDED", "MODIFIED"]  # the bookmark is not one


def test_410_gone_relists_then_watches_from_new_rv():
    status_410 = {"kind": "Status", "apiVersion": "v1",
                  "metadata": {}, "status": "Failure",
                  "message": "too old resource version: 100 (652)",
                  "reason": "Expired", "code": 410}

    def case(s):
        return watched(
            s, [Exchange(pod_list("100", pod("a", "90"))),
                Exchange(pod_list("652", pod("a", "650")))],
            [Exchange(CHUNKED_HEAD
                      + chunk(watch_frame("ERROR", status_410))
                      + END_CHUNKS),
             Exchange(CHUNKED_HEAD, hold=True)],
            project=lambda e: e.type)

    (ref, reqs), (port, port_reqs) = both(case)
    for events, r in ((ref, reqs), (port, port_reqs)):
        assert kinds(r)[:4] == ["list", "watch", "list", "watch"], r
        ws = watches(r)
        assert ws[0].get("resourceVersion") == "100"
        assert ws[1].get("resourceVersion") == "652"
        assert events.count("ADDED") == 2  # both lists surfaced


def test_crlf_line_endings():
    def case(s):
        import json

        frame = json.dumps({"type": "ADDED",
                            "object": pod("b", "201")}).encode() + b"\r\n"
        events, _ = watched(
            s, [Exchange(pod_list("200"))],
            [Exchange(CHUNKED_HEAD + chunk(frame) + END_CHUNKS),
             Exchange(CHUNKED_HEAD, hold=True)],
            project=lambda e: (e.type, e.obj["metadata"]["name"]))
        return events

    ref, port = both(case)
    assert ref == port == [("ADDED", "b")]


# -- the write wire -----------------------------------------------------------

CONFLICT = {
    "kind": "Status", "apiVersion": "v1", "metadata": {},
    "status": "Failure",
    "message": 'Operation cannot be fulfilled on pods "a": the object has '
               'been modified; please apply your changes to the latest '
               'version and try again',
    "reason": "Conflict", "details": {"name": "a", "kind": "pods"},
    "code": 409}
PDB_BLOCKED = {
    "kind": "Status", "apiVersion": "v1", "metadata": {},
    "status": "Failure",
    "message": "Cannot evict pod as it would violate the pod's disruption "
               "budget.",
    "reason": "TooManyRequests",
    "details": {"causes": [{
        "reason": "DisruptionBudget",
        "message": "The disruption budget worker needs 3 healthy pods and "
                   "has 3 currently"}]},
    "code": 429}


def test_conflict_409_status_body():
    def case(s):
        s.srv.script("PUT", "any", Exchange(plain(409, "Conflict",
                                                  CONFLICT)))
        return raised(s.client.update, pod("a", "90"))

    ref, port = both(case)
    for err in (ref, port):
        assert err[0] == "ConflictError"
        assert "object has been modified" in err[1]


def test_eviction_429_pdb_wire_shape():
    def case(s):
        s.srv.script("POST", "any", Exchange(plain(
            429, "Too Many Requests", PDB_BLOCKED)))
        return raised(s.client.evict, "a", "default"), list(s.srv.requests)

    (ref, reqs), (port, port_reqs) = both(case)
    for err, r in ((ref, reqs), (port, port_reqs)):
        assert err[0] == "EvictionBlockedError"
        assert "disruption budget" in err[1]
        [(method, path, _)] = r
        assert method == "POST"
        assert path.endswith("/namespaces/default/pods/a/eviction")


def test_eviction_created_201():
    def case(s):
        s.srv.script("POST", "any", Exchange(plain(201, "Created", {
            "kind": "Status", "apiVersion": "v1", "metadata": {},
            "status": "Success", "code": 201})))
        return raised(s.client.evict, "a", "default")

    assert both(case) == (None, None)  # no raise


def test_422_invalid_status_body():
    """The reference's TPUDriver refuses a channel outside its enum; the
    port's GPUDriver has no channel (ROADMAP §C's install surface), so
    its case refuses a driverType outside its enum, in the same v1.Status
    shape and words."""
    def case(s):
        field, value, enum = (("channel", "weekly", "stable nightly custom")
                              if s.ref else
                              ("driverType", "weekly", "driver host"))
        kind = s.name("TPUDriver")
        group = s.name("tpu.graft.dev/v1alpha1")
        s.srv.script("POST", "any", Exchange(plain(
            422, "Unprocessable Entity", {
                "kind": "Status", "apiVersion": "v1", "metadata": {},
                "status": "Failure",
                "message": f'{kind}.{group.split("/")[0]} "d" is invalid: '
                           f'spec.{field}: Invalid value: "{value}": '
                           f'spec.{field} in body should be one of '
                           f'[{enum}]',
                "reason": "Invalid", "code": 422})))
        return raised(s.client.create, {"apiVersion": group, "kind": kind,
                                        "metadata": {"name": "d"},
                                        "spec": {field: value}})

    ref, port = both(case)
    for err in (ref, port):
        assert err[0] == "InvalidError" and err[2] == 422
        assert "should be one of" in err[1]


# -- the throttle wire --------------------------------------------------------


def test_429_retry_after_then_success():
    def case(s):
        s.srv.script("GET", "any", Exchange(throttled("0")),
                     Exchange(plain(200, "OK", pod("a", "7"))))
        obj = s.client.get("v1", "Pod", "a", "default")
        return obj["metadata"]["resourceVersion"], [
            m for m, _, _ in s.srv.requests]

    assert both(case) == (("7", ["GET", "GET"]),) * 2


def test_429_exhausts_retries_surfaces_apierror():
    def case(s):
        s.srv.script("GET", "any", Exchange(throttled("0")),
                     Exchange(throttled("0")), Exchange(throttled("0")))
        err = raised(s.client.get, "v1", "Pod", "a", "default")
        return err[0], err[2], len(s.srv.requests)

    # bounded: the first request and two retries
    assert both(case) == (("ApiError", 429, 3),) * 2


def test_eviction_429_never_retried():
    def case(s):
        s.srv.script("POST", "any", Exchange(plain(
            429, "Too Many Requests",
            {k: v for k, v in PDB_BLOCKED.items() if k != "details"})))
        return raised(s.client.evict, "a", "default")[0], len(
            s.srv.requests)

    assert both(case) == (("EvictionBlockedError", 1),) * 2


def test_lease_429_never_retried():
    def case(s):
        s.srv.script("GET", "any", Exchange(throttled("30")))
        t0 = time.monotonic()
        err = raised(s.client.get, "coordination.k8s.io/v1", "Lease",
                     s.name("tpu-operator"), s.name("tpu-operator"))
        slept = time.monotonic() - t0
        return err[0], err[2], slept < 5, len(s.srv.requests), \
            "/leases/" in s.srv.requests[0][1]

    assert both(case) == (("ApiError", 429, True, 1, True),) * 2


def test_429_retried_in_namespace_named_leases():
    def case(s):
        s.srv.script("GET", "any", Exchange(throttled("0")),
                     Exchange(plain(200, "OK", {
                         "kind": "Pod", "apiVersion": "v1",
                         "metadata": {"name": "a", "namespace": "leases",
                                      "resourceVersion": "5"}})))
        obj = s.client.get("v1", "Pod", "a", "leases")
        return obj["metadata"]["resourceVersion"], len(s.srv.requests), \
            "/namespaces/leases/pods/a" in s.srv.requests[0][1]

    assert both(case) == (("5", 2, True),) * 2


@pytest.mark.parametrize("path,expect", [
    ("/apis/tpu.graft.dev/v1alpha1/tpudrivers",
     "/apis/gpu.graft.dev/v1alpha1/gpudrivers"),
    ("/apis/coordination.k8s.io/v1/namespaces/tpu-operator/leases/"
     "tpu-operator",
     "/apis/coordination.k8s.io/v1/namespaces/gpu-operator/leases/"
     "gpu-operator"),
    ("/api/v1/namespaces/default/pods/a/eviction",
     "/api/v1/namespaces/default/pods/a/eviction")])
def test_wire_paths_map_through_the_rule(path, expect):
    assert wire_path(path) == expect
    assert urllib.parse.urlsplit(expect).path == expect
