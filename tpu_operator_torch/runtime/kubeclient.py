"""Kubernetes apiserver clients over ``urllib``.

The port's counterpart of ``tpu_operator/runtime/kubeclient.py``, written
over the standard library where the reference's is over ``requests``:

- ``HTTPClient`` is the operator's client: in-cluster service-account
  config when it runs as a pod, kubeconfig otherwise (``KubeConfig``). It
  has every verb of the ``Client`` contract (get, a paged list, create,
  update, ``update_status``, merge patch, delete), retries a 429 the way
  client-go does (``close()`` interrupts the wait), and watches in a
  thread that resumes from the last resourceVersion after a dropped
  stream and relists on 410 Gone. ``evict`` posts the ``policy/v1``
  Eviction subresource; its 429 is ``EvictionBlockedError``.
- ``InClusterClient`` is the pods' and node agents' small client: get,
  create and delete a pod; get a node (whole, or its metadata alone),
  list nodes and merge-patch one, on the service account's token and CA
  and the ``KUBERNETES_SERVICE_HOST``/``_PORT`` contract.

Errors are the port's own ``runtime/client.py`` classes, each with its HTTP
status ``code``: ``NotFoundError`` is 404. The proofs treat any exception whose ``code`` is
404 as not-found, so the reference's ``FakeClient`` drives them in tests.
"""

from __future__ import annotations

import base64
import contextlib
import http.client
import json
import logging
import os
import socket
import ssl
import tempfile
import threading
import urllib.error
import urllib.parse
import urllib.request
from typing import Callable, List, Mapping, Optional

from .client import (
    AlreadyExistsError,
    ApiError,
    Client,
    ConflictError,
    EvictionBlockedError,
    InvalidError,
    ListOptions,
    NotFoundError,
    PagedList,
    WatchEvent,
)
from .objects import is_namespaced

SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"
REQUEST_TIMEOUT_S = 30.0

# kind -> (plural, namespaced): only the kinds the validator touches
_KINDS = {"Pod": ("pods", True), "Node": ("nodes", False)}


class InClusterClient:
    """``get``/``get_or_none``/``create``/``delete`` of pods, ``get``,
    ``list`` and ``patch`` of nodes. ``server`` is the apiserver's base URL; the bearer
    token is read from ``token_file`` on every request (bound service-account
    tokens rotate), and ``ca_file`` verifies an https server."""

    # PartialObjectMetadata negotiation: the apiserver serialises only the
    # metadata, sparing a poller that reads one label the full Node
    METADATA_ACCEPT = ("application/json;as=PartialObjectMetadata;"
                       "g=meta.k8s.io;v=v1,application/json")

    def __init__(self, server: str, token_file: Optional[str] = None,
                 ca_file: Optional[str] = None, namespace: str = "default",
                 timeout: float = REQUEST_TIMEOUT_S):
        self.server = server.rstrip("/")
        self.token_file = token_file
        self.namespace = namespace
        self.timeout = timeout
        self._ssl = (ssl.create_default_context(cafile=ca_file)
                     if self.server.startswith("https:") else None)

    @classmethod
    def from_env(cls, sa_dir: str = SA_DIR) -> "InClusterClient":
        """The pod's own apiserver and service account."""
        host = os.environ["KUBERNETES_SERVICE_HOST"]
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        if ":" in host and not host.startswith("["):
            host = f"[{host}]"  # an IPv6 service address
        ns_file = os.path.join(sa_dir, "namespace")
        namespace = "default"
        if os.path.exists(ns_file):
            with open(ns_file) as f:
                namespace = f.read().strip() or namespace
        return cls(f"https://{host}:{port}",
                   token_file=os.path.join(sa_dir, "token"),
                   ca_file=os.path.join(sa_dir, "ca.crt"),
                   namespace=namespace)

    def _url(self, api_version: str, kind: str, name: Optional[str],
             namespace: Optional[str]) -> str:
        if kind not in _KINDS:
            raise ValueError(f"this client has no verbs for kind {kind!r}")
        plural, namespaced = _KINDS[kind]
        group = "apis" if "/" in api_version else "api"
        parts = [self.server, group, api_version]
        if namespaced:
            parts += ["namespaces", namespace or self.namespace]
        parts.append(plural)
        if name:
            parts.append(name)
        return "/".join(parts)

    def _request(self, method: str, url: str, what: str,
                 body: Optional[dict] = None,
                 content_type: str = "application/json",
                 accept: str = "application/json") -> dict:
        headers = {"Accept": accept}
        if self.token_file:
            with open(self.token_file) as f:
                headers["Authorization"] = f"Bearer {f.read().strip()}"
        data = None
        if body is not None:
            data = json.dumps(body).encode()
            headers["Content-Type"] = content_type
        req = urllib.request.Request(url, data=data, headers=headers,
                                     method=method)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout,
                                        context=self._ssl) as resp:
                raw = resp.read()
        except urllib.error.HTTPError as e:
            msg = f"{what}: {e.code} {e.read()[:500].decode(errors='replace')}"
            if e.code == 404:
                raise NotFoundError(msg) from None
            raise ApiError(msg, code=e.code) from None
        return json.loads(raw) if raw else {}

    def get(self, api_version: str, kind: str, name: str,
            namespace: Optional[str] = None,
            metadata_only: bool = False) -> dict:
        return self._request(
            "GET", self._url(api_version, kind, name, namespace),
            f"get {kind}/{name}",
            accept=self.METADATA_ACCEPT if metadata_only
            else "application/json")

    def get_or_none(self, api_version: str, kind: str, name: str,
                    namespace: Optional[str] = None) -> Optional[dict]:
        try:
            return self.get(api_version, kind, name, namespace)
        except NotFoundError:
            return None

    def list(self, api_version: str, kind: str,
             label_selector: Optional[Mapping[str, str]] = None,
             namespace: Optional[str] = None) -> List[dict]:
        """The collection's ``items``; ``label_selector`` is matchLabels
        (``{key: value}``), sent as the apiserver's ``labelSelector``."""
        url = self._url(api_version, kind, None, namespace)
        if label_selector:
            url += "?" + urllib.parse.urlencode({"labelSelector": ",".join(
                f"{k}={v}" for k, v in label_selector.items())})
        return self._request("GET", url, f"list {kind}").get("items") or []

    def create(self, obj: dict) -> dict:
        meta = obj.get("metadata", {})
        kind = obj["kind"]
        url = self._url(obj["apiVersion"], kind, None, meta.get("namespace"))
        return self._request("POST", url, f"create {kind}/{meta.get('name')}",
                             body=obj)

    def patch(self, api_version: str, kind: str, name: str, patch: dict,
              namespace: Optional[str] = None) -> dict:
        """A JSON merge patch (RFC 7386): a key set to None is removed."""
        return self._request(
            "PATCH", self._url(api_version, kind, name, namespace),
            f"patch {kind}/{name}", body=patch,
            content_type="application/merge-patch+json")

    def delete(self, api_version: str, kind: str, name: str,
               namespace: Optional[str] = None) -> None:
        self._request("DELETE", self._url(api_version, kind, name, namespace),
                      f"delete {kind}/{name}")


# -- the operator's client -----------------------------------------------------

# Irregular plurals; everything else is lowercase(kind) + "s" / "es".
_PLURALS = {
    "Endpoints": "endpoints",
    "NetworkPolicy": "networkpolicies",
    "PodSecurityPolicy": "podsecuritypolicies",
    "Ingress": "ingresses",
    "RuntimeClass": "runtimeclasses",
    "PriorityClass": "priorityclasses",
    "CustomResourceDefinition": "customresourcedefinitions",
    "GPUClusterPolicy": "gpuclusterpolicies",
}


def plural_of(kind: str) -> str:
    if kind in _PLURALS:
        return _PLURALS[kind]
    lower = kind.lower()
    if lower.endswith(("s", "x", "z", "ch", "sh")):
        return lower + "es"
    if lower.endswith("y") and lower[-2] not in "aeiou":
        return lower[:-1] + "ies"
    return lower + "s"


class KubeConfig:
    def __init__(self, server: str, token: Optional[str] = None,
                 ca_file: Optional[str] = None,
                 client_cert: Optional[tuple] = None,
                 namespace: str = "default",
                 token_file: Optional[str] = None):
        self.server = server.rstrip("/")
        self.token = token
        self.ca_file = ca_file
        self.client_cert = client_cert
        self.namespace = namespace
        # projected bound SA tokens expire (~1h) and kubelet refreshes
        # only the FILE — long-lived clients must re-read it, not pin the
        # startup value
        self.token_file = token_file

    @classmethod
    def in_cluster(cls) -> "KubeConfig":
        host = os.environ["KUBERNETES_SERVICE_HOST"]
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        if ":" in host and not host.startswith("["):
            host = f"[{host}]"  # an IPv6 service address
        token_file = os.path.join(SA_DIR, "token")
        with open(token_file) as f:
            token = f.read().strip()
        ns_file = os.path.join(SA_DIR, "namespace")
        ns = "default"
        if os.path.exists(ns_file):
            with open(ns_file) as f:
                ns = f.read().strip()
        return cls(server=f"https://{host}:{port}", token=token,
                   ca_file=os.path.join(SA_DIR, "ca.crt"), namespace=ns,
                   token_file=token_file)

    @classmethod
    def from_kubeconfig(cls, path: Optional[str] = None,
                        context: Optional[str] = None) -> "KubeConfig":
        import yaml

        path = path or os.environ.get("KUBECONFIG",
                                      os.path.expanduser("~/.kube/config"))
        with open(path) as f:
            cfg = yaml.safe_load(f)
        ctx_name = context or cfg.get("current-context")
        ctx = next(c["context"] for c in cfg["contexts"] if c["name"] == ctx_name)
        cluster = next(c["cluster"] for c in cfg["clusters"]
                       if c["name"] == ctx["cluster"])
        user = next(u["user"] for u in cfg["users"] if u["name"] == ctx["user"])

        def materialize(data_key: str, file_key: str) -> Optional[str]:
            if file_key in cluster or file_key in user:
                return cluster.get(file_key) or user.get(file_key)
            blob = cluster.get(data_key) or user.get(data_key)
            if not blob:
                return None
            f = tempfile.NamedTemporaryFile(delete=False, suffix=".pem")
            f.write(base64.b64decode(blob))
            f.close()
            return f.name

        ca = (cluster.get("certificate-authority")
              or materialize("certificate-authority-data", "certificate-authority"))
        cert = (user.get("client-certificate")
                or materialize("client-certificate-data", "client-certificate"))
        key = (user.get("client-key")
               or materialize("client-key-data", "client-key"))
        return cls(server=cluster["server"], token=user.get("token"),
                   ca_file=ca,
                   client_cert=(cert, key) if cert and key else None,
                   namespace=ctx.get("namespace", "default"))

    @classmethod
    def load(cls) -> "KubeConfig":
        if "KUBERNETES_SERVICE_HOST" in os.environ and os.path.exists(SA_DIR):
            return cls.in_cluster()
        return cls.from_kubeconfig()


class _Response:
    """One answered request: status, headers and the body's bytes."""

    def __init__(self, status: int, headers, body: bytes):
        self.status_code = status
        self.headers = headers
        self.body = body

    @property
    def text(self) -> str:
        return self.body.decode(errors="replace")

    def json(self):
        return json.loads(self.body) if self.body else {}


class HTTPClient(Client):
    """Every verb of the ``Client`` contract against a real apiserver, over
    ``urllib``. Bearer auth re-reads a token file when it rotates (bound
    service-account tokens expire; kubelet refreshes the projected file
    in place); ``ca_file`` verifies an https server and ``client_cert``
    (cert, key) authenticates with a certificate."""

    # idle-watch read timeout: real apiservers recycle streams every few
    # minutes anyway; a quiet stream past this resumes from the last rv
    # (no re-list). A watch connects (TLS included) within the connect
    # timeout, so an unreachable apiserver takes the re-list backoff in
    # seconds. Class attributes so tests can shrink them.
    WATCH_READ_TIMEOUT_S = 300.0
    WATCH_CONNECT_TIMEOUT_S = 10.0
    REQUEST_TIMEOUT_S = REQUEST_TIMEOUT_S

    # the list honors ListOptions.limit/continue_ (the apiserver's
    # ?limit=&continue= chunking)
    supports_chunked_list = True

    def __init__(self, config: Optional[KubeConfig] = None):
        self.config = config or KubeConfig.load()
        self._ssl = None
        if self.config.server.startswith("https:"):
            self._ssl = ssl.create_default_context(cafile=self.config.ca_file)
            if self.config.client_cert:
                self._ssl.load_cert_chain(*self.config.client_cert)
        self._token = self.config.token
        self._token_mtime: Optional[float] = None
        self._token_lock = threading.Lock()
        self._stop = threading.Event()

    def close(self) -> None:
        """Shut the client down: wakes any throttle-retry sleep (the 429
        surfaces immediately) and stops watch threads at their next loop
        check."""
        self._stop.set()

    # -- auth and path construction ----------------------------------------

    def _bearer(self) -> Optional[str]:
        if self.config.token_file:
            with self._token_lock:
                try:
                    mtime = os.stat(self.config.token_file).st_mtime
                    if mtime != self._token_mtime:
                        with open(self.config.token_file) as f:
                            self._token = f.read().strip()
                        self._token_mtime = mtime
                except OSError:
                    pass  # keep the last good token
        return self._token

    def _base(self, api_version: str) -> str:
        if "/" in api_version:
            return f"{self.config.server}/apis/{api_version}"
        return f"{self.config.server}/api/{api_version}"

    def _url(self, api_version: str, kind: str, name: Optional[str],
             namespace: Optional[str], subresource: str = "") -> str:
        parts = [self._base(api_version)]
        if is_namespaced(kind):
            parts.append(f"namespaces/{namespace or self.config.namespace}")
        parts.append(plural_of(kind))
        if name:
            parts.append(name)
        if subresource:
            parts.append(subresource)
        return "/".join(parts)

    def _headers(self, body: Optional[bytes] = None,
                 headers: Optional[dict] = None) -> dict:
        hdrs = {"Accept": "application/json"}
        token = self._bearer()
        if token:
            hdrs["Authorization"] = f"Bearer {token}"
        if body is not None:
            hdrs["Content-Type"] = "application/json"
        hdrs.update(headers or {})
        return hdrs

    def _open(self, method: str, url: str, params: Optional[dict] = None,
              body: Optional[bytes] = None,
              headers: Optional[dict] = None):
        """urlopen one request; an HTTP error status comes back as the
        response it is, not as an exception."""
        if params:
            url = f"{url}?{urllib.parse.urlencode(params)}"
        req = urllib.request.Request(url, data=body,
                                     headers=self._headers(body, headers),
                                     method=method.upper())
        try:
            return urllib.request.urlopen(
                req, timeout=self.REQUEST_TIMEOUT_S, context=self._ssl)
        except urllib.error.HTTPError as e:
            return e

    def _open_stream(self, url: str, params: dict):
        """GET a watch stream: connect within WATCH_CONNECT_TIMEOUT_S,
        then read with WATCH_READ_TIMEOUT_S (urlopen has one timeout for
        both). Returns (connection, response); the caller closes both."""
        u = urllib.parse.urlsplit(url)
        if u.scheme == "https":
            conn = http.client.HTTPSConnection(
                u.hostname, u.port, timeout=self.WATCH_CONNECT_TIMEOUT_S,
                context=self._ssl)
        else:
            conn = http.client.HTTPConnection(
                u.hostname, u.port, timeout=self.WATCH_CONNECT_TIMEOUT_S)
        try:
            try:
                conn.connect()
            except OSError as e:
                # a connect timeout is not the idle read timeout a watch
                # resumes from: an unreachable server takes the backoff
                raise ConnectionError(f"connect {u.netloc}: {e}") from e
            conn.sock.settimeout(self.WATCH_READ_TIMEOUT_S)
            conn.request("GET", f"{u.path}?{urllib.parse.urlencode(params)}",
                         headers=self._headers())
            return conn, conn.getresponse()
        except BaseException:
            conn.close()
            raise

    def _request(self, method: str, url: str, **kw) -> _Response:
        with self._open(method, url, **kw) as resp:
            return _Response(resp.status, resp.headers, resp.read())

    def _send(self, method: str, url: str, **kw) -> _Response:
        """Issue one API request, honoring apiserver throttling the way
        client-go does: a 429 from API priority-and-fairness means the
        request was REJECTED BEFORE EXECUTION (so every verb is safe to
        re-issue) and carries Retry-After. Bounded: two retries, sleep
        capped at 10s, then the 429 surfaces as a plain ApiError for the
        reconcile loop's own backoff. The sleep wakes on client
        shutdown (close()).

        Exemption: coordination.k8s.io Lease operations are NOT retried —
        a leader blocking tens of seconds inside a renew during an
        apiserver load spike would outlive its own lease and churn
        leadership; client-go deliberately runs leader election on a
        non-retrying client for the same reason. The match is on the API
        group, not a path substring, so a user namespace or object named
        'leases' keeps its retries."""
        retriable = "/apis/coordination.k8s.io/" not in url or \
            not ("/leases/" in url or url.endswith("/leases"))
        for attempt in range(3):
            resp = self._request(method, url, **kw)
            if resp.status_code != 429 or attempt == 2 or not retriable:
                return resp
            try:
                delay = float(resp.headers.get("Retry-After", 1))
            except (TypeError, ValueError):
                delay = 1.0
            if self._stop.wait(min(max(delay, 0.0), 10.0)):
                return resp  # client is shutting down: surface the 429
        return resp  # pragma: no cover - loop always returns

    @staticmethod
    def _raise_for(resp: _Response, what: str):
        if resp.status_code < 400:
            return
        msg = f"{what}: {resp.status_code} {resp.text[:500]}"
        if resp.status_code == 404:
            raise NotFoundError(msg)
        if resp.status_code == 409:
            body = {}
            try:
                body = resp.json()
            except ValueError:
                pass
            if body.get("reason") == "AlreadyExists":
                raise AlreadyExistsError(msg)
            raise ConflictError(msg)
        if resp.status_code == 422:
            raise InvalidError(msg)
        raise ApiError(msg, code=resp.status_code)

    # -- CRUD --------------------------------------------------------------

    # PartialObjectMetadata negotiation: the apiserver serializes only
    # metadata (labels/annotations/ownerRefs), sparing the full object —
    # matters for pollers reading one label off fat objects like Nodes
    METADATA_ACCEPT = ("application/json;as=PartialObjectMetadata;"
                       "g=meta.k8s.io;v=v1,application/json")

    def get(self, api_version, kind, name, namespace=None,
            metadata_only=False):
        headers = {"Accept": self.METADATA_ACCEPT} if metadata_only else None
        resp = self._send(
            "get", self._url(api_version, kind, name, namespace),
            headers=headers)
        self._raise_for(resp, f"get {kind}/{name}")
        return resp.json()

    @staticmethod
    def _selector_param(selector) -> str:
        """Render a LabelSelector (matchLabels + matchExpressions) or plain
        matchLabels dict into the apiserver's set-based selector syntax."""
        if "matchLabels" in selector or "matchExpressions" in selector:
            match = selector.get("matchLabels") or {}
            exprs = selector.get("matchExpressions") or []
        else:
            match, exprs = selector, []
        parts = [f"{k}={v}" for k, v in match.items()]
        for e in exprs:
            key, op = e.get("key"), e.get("operator")
            values = ",".join(e.get("values") or [])
            if op == "In":
                parts.append(f"{key} in ({values})")
            elif op == "NotIn":
                parts.append(f"{key} notin ({values})")
            elif op == "Exists":
                parts.append(key)
            elif op == "DoesNotExist":
                parts.append(f"!{key}")
            else:
                raise ValueError(f"unknown matchExpressions operator: {op!r}")
        return ",".join(parts)

    def _list_raw(self, api_version, kind, opts: Optional[ListOptions] = None):
        """One list call: (items as a PagedList, collection
        resourceVersion). ``opts.limit``/``continue_`` page it, and the
        page carries the server's ``metadata.continue`` token."""
        opts = opts or ListOptions()
        params = {}
        if opts.label_selector:
            params["labelSelector"] = self._selector_param(opts.label_selector)
        if opts.field_selector:
            params["fieldSelector"] = ",".join(
                f"{k}={v}" for k, v in opts.field_selector.items())
        if opts.limit:
            params["limit"] = str(opts.limit)
        if opts.continue_:
            params["continue"] = opts.continue_
        url = self._url(api_version, kind, None, opts.namespace)
        if not opts.namespace and is_namespaced(kind):
            # all-namespaces list
            url = f"{self._base(api_version)}/{plural_of(kind)}"
        resp = self._send("get", url, params=params)
        self._raise_for(resp, f"list {kind}")
        body = resp.json()
        items = PagedList(body.get("items") or [])
        for item in items:  # k8s omits these on list items
            item.setdefault("apiVersion", api_version)
            item.setdefault("kind", kind)
        meta = body.get("metadata") or {}
        items.continue_ = meta.get("continue") or None
        return items, meta.get("resourceVersion")

    def list(self, api_version, kind, opts: Optional[ListOptions] = None):
        return self._list_raw(api_version, kind, opts)[0]

    def _write(self, method: str, url: str, body, what: str,
               headers: Optional[dict] = None):
        resp = self._send(method, url, body=json.dumps(body).encode(),
                          headers=headers)
        self._raise_for(resp, what)
        return resp.json()

    def create(self, obj):
        av, kind = obj.get("apiVersion", ""), obj.get("kind", "")
        ns = obj.get("metadata", {}).get("namespace")
        return self._write("post", self._url(av, kind, None, ns), obj,
                           f"create {kind}")

    def update(self, obj):
        av, kind = obj.get("apiVersion", ""), obj.get("kind", "")
        meta = obj.get("metadata", {})
        return self._write(
            "put", self._url(av, kind, meta.get("name"), meta.get("namespace")),
            obj, f"update {kind}/{meta.get('name')}")

    def update_status(self, obj):
        av, kind = obj.get("apiVersion", ""), obj.get("kind", "")
        meta = obj.get("metadata", {})
        return self._write(
            "put", self._url(av, kind, meta.get("name"), meta.get("namespace"),
                             "status"),
            obj, f"update status {kind}/{meta.get('name')}")

    def patch(self, api_version, kind, name, patch, namespace=None):
        return self._write(
            "patch", self._url(api_version, kind, name, namespace), patch,
            f"patch {kind}/{name}",
            headers={"Content-Type": "application/merge-patch+json"})

    def delete(self, api_version, kind, name, namespace=None):
        resp = self._send("delete",
                          self._url(api_version, kind, name, namespace))
        self._raise_for(resp, f"delete {kind}/{name}")

    def evict(self, name, namespace=None):
        """POST to the pods/eviction subresource — the apiserver enforces
        PodDisruptionBudgets server-side and answers 429 while the budget
        has no disruptions left. Sent once: that 429 is an answer, not
        the throttling ``_send`` retries."""
        ns = namespace or self.config.namespace
        body = {"apiVersion": "policy/v1", "kind": "Eviction",
                "metadata": {"name": name, "namespace": ns}}
        resp = self._request(
            "post", self._url("v1", "Pod", name, ns, "eviction"),
            body=json.dumps(body).encode())
        if resp.status_code == 429:
            raise EvictionBlockedError(
                f"evict {ns}/{name}: {resp.text[:300]}")
        self._raise_for(resp, f"evict pod/{name}")

    # -- watch -------------------------------------------------------------

    def watch(self, api_version, kind, handler: Callable[[WatchEvent], None]):
        """List+watch in a daemon thread (informer-lite). A dropped
        stream RESUMES from the last seen resourceVersion — the apiserver
        replays anything missed — instead of re-listing the world; only
        410 Gone (version fell out of the server's window) or a transport
        failure forces a fresh list. Server-side watch timeouts recycle
        every stream every few minutes, so re-listing per drop would be
        steady O(collection) apiserver load per watcher on big clusters.
        Returns an unsubscribe callable."""
        stop = threading.Event()
        log = logging.getLogger("tpu_operator_torch.kubeclient")

        def run():
            rv = None  # None -> list before watching
            while not stop.is_set() and not self._stop.is_set():
                try:
                    if rv is None:
                        items, rv = self._list_raw(api_version, kind)
                        for obj in items:
                            handler(WatchEvent("ADDED", obj))
                    url = self._url(api_version, kind, None, None)
                    if is_namespaced(kind):
                        url = f"{self._base(api_version)}/{plural_of(kind)}"
                    params = {"watch": "true",
                              "allowWatchBookmarks": "true"}
                    if rv:
                        params["resourceVersion"] = rv
                    conn, resp = self._open_stream(url, params)
                    with contextlib.closing(conn), resp:
                        if resp.status >= 400:
                            self._raise_for(
                                _Response(resp.status, resp.headers,
                                          resp.read()), f"watch {kind}")
                        for line in resp:
                            if stop.is_set():
                                return
                            line = line.strip()
                            if not line:
                                continue
                            evt = json.loads(line)
                            etype = evt.get("type", "MODIFIED")
                            obj = evt.get("object", {})
                            new_rv = (obj.get("metadata")
                                      or {}).get("resourceVersion")
                            if etype == "BOOKMARK":
                                if new_rv:
                                    rv = new_rv
                                continue
                            if etype == "ERROR":
                                # 410 Gone: resourceVersion too old — the
                                # ONE case that requires a fresh list
                                log.warning("watch %s error event: %s",
                                            kind, evt.get("object"))
                                rv = None
                                break
                            if new_rv:
                                rv = new_rv
                            obj.setdefault("apiVersion", api_version)
                            obj.setdefault("kind", kind)
                            handler(WatchEvent(etype, obj))
                    # normal stream end (server recycle): loop resumes the
                    # watch from rv without re-listing
                except (socket.timeout, TimeoutError):
                    # quiet collection: the read timeout fired before the
                    # server recycled the stream. rv tracks the last fully
                    # parsed event, so resuming from it is safe — nulling
                    # it would re-list + replay ADDED for the whole
                    # collection every few minutes per idle watcher.
                    log.debug("watch %s idle read timeout; resuming from "
                              "rv=%s", kind, rv)
                    continue
                except Exception as e:
                    # a failed connect lands here as ConnectionError: an
                    # unreachable server needs the backoff path, not a
                    # tight resume loop
                    log.warning("watch %s failed (%s: %s); re-listing in 2s",
                                kind, type(e).__name__, e)
                    rv = None  # transport fault: state unknown, re-list
                    if stop.wait(2.0):
                        return

        threading.Thread(target=run, daemon=True,
                         name=f"watch-{kind}").start()
        return stop.set
