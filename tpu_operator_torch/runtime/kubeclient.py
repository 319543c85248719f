"""A small in-cluster Kubernetes client: the verbs the validator uses.

Counterpart of the parts of ``tpu_operator/runtime/kubeclient.py`` (an
HTTPS client over ``requests``, every verb, watches and retries) that the
pod proofs reach: get, create and delete a pod, and get a node. It runs
inside a pod on the service account's token and CA and the
``KUBERNETES_SERVICE_HOST``/``_PORT`` contract, over ``urllib``.

Errors carry an HTTP status ``code`` as the reference's ``ApiError`` does:
``NotFoundError`` is 404. The proofs treat any exception whose ``code`` is
404 as not-found, so the reference's ``FakeClient`` drives them in tests.
"""

from __future__ import annotations

import json
import os
import ssl
import urllib.error
import urllib.request
from typing import Optional

SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"
REQUEST_TIMEOUT_S = 30.0

# kind -> (plural, namespaced): only the kinds the validator touches
_KINDS = {"Pod": ("pods", True), "Node": ("nodes", False)}


class ApiError(Exception):
    """An apiserver answer that is not a success; ``code`` is its status."""

    code = 500

    def __init__(self, message: str, code: Optional[int] = None):
        super().__init__(message)
        if code is not None:
            self.code = code


class NotFoundError(ApiError):
    code = 404


class InClusterClient:
    """``get``/``get_or_none``/``create``/``delete`` of pods, ``get`` of
    nodes. ``server`` is the apiserver's base URL; the bearer token is
    read from ``token_file`` on every request (bound service-account
    tokens rotate), and ``ca_file`` verifies an https server."""

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
                 body: Optional[dict] = None) -> dict:
        headers = {"Accept": "application/json"}
        if self.token_file:
            with open(self.token_file) as f:
                headers["Authorization"] = f"Bearer {f.read().strip()}"
        data = None
        if body is not None:
            data = json.dumps(body).encode()
            headers["Content-Type"] = "application/json"
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
            namespace: Optional[str] = None) -> dict:
        return self._request("GET", self._url(api_version, kind, name,
                                              namespace), f"get {kind}/{name}")

    def get_or_none(self, api_version: str, kind: str, name: str,
                    namespace: Optional[str] = None) -> Optional[dict]:
        try:
            return self.get(api_version, kind, name, namespace)
        except NotFoundError:
            return None

    def create(self, obj: dict) -> dict:
        meta = obj.get("metadata", {})
        kind = obj["kind"]
        url = self._url(obj["apiVersion"], kind, None, meta.get("namespace"))
        return self._request("POST", url, f"create {kind}/{meta.get('name')}",
                             body=obj)

    def delete(self, api_version: str, kind: str, name: str,
               namespace: Optional[str] = None) -> None:
        self._request("DELETE", self._url(api_version, kind, name, namespace),
                      f"delete {kind}/{name}")
