"""Image-reference resolvability against a container registry.

The port's counterpart of ``tpu_operator/api/registry.py``. A driver CR
is wrapped as the ``driver`` component (the reference's ``libtpu``), and
the resolver speaks HTTP through ``urllib`` (the port's HTTP client does
too; the reference's uses ``requests``).

The reference's gpuop-cfg verifies every image tag in a ClusterPolicy
actually resolves — a manifest fetch via regclient
(cmd/gpuop-cfg/validate/clusterpolicy/images.go:172) — so a typo'd tag
fails validation before anything reaches the cluster. Same here, with the
resolver pluggable so tests run against a local fake registry and other
tooling can inject an allowlist resolver:

- ``parse_image_ref`` splits ``[registry/]repository[:tag|@digest]``
  with docker.io/library normalization;
- ``RegistryResolver`` performs the real OCI distribution-spec check:
  HEAD/GET ``/v2/<repo>/manifests/<ref>`` with the token-auth dance;
- ``resolve_cr_images`` walks a GPUClusterPolicy/GPUDriver CR and
  resolves every operand image that is explicitly configured.

CLI: ``gpuop-cfg validate clusterpolicy -f p.yaml --verify-images``.
"""

from __future__ import annotations

import json
import re
import urllib.error
import urllib.parse
import urllib.request
from typing import Dict, List, NamedTuple, Optional, Protocol, Tuple

MANIFEST_ACCEPT = ", ".join([
    "application/vnd.oci.image.index.v1+json",
    "application/vnd.oci.image.manifest.v1+json",
    "application/vnd.docker.distribution.manifest.list.v2+json",
    "application/vnd.docker.distribution.manifest.v2+json",
])

_TAG_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9._-]{0,127}$")
_DIGEST_RE = re.compile(r"^sha256:[0-9a-f]{64}$")


class ImageResolveError(Exception):
    pass


class ImageRef(NamedTuple):
    registry: str
    repository: str
    tag: Optional[str]
    digest: Optional[str]

    @property
    def reference(self) -> str:
        """What goes in the manifest URL: digest wins over tag."""
        return self.digest or self.tag or "latest"

    def __str__(self) -> str:
        base = f"{self.registry}/{self.repository}"
        if self.digest:
            return f"{base}@{self.digest}"
        return f"{base}:{self.tag or 'latest'}"


def parse_image_ref(ref: str) -> ImageRef:
    """Split ``[registry/]repository[:tag|@digest]``; normalizes bare
    Docker Hub references the way the docker CLI does."""
    if not ref or ref != ref.strip():
        raise ImageResolveError(f"malformed image reference {ref!r}")
    digest = None
    if "@" in ref:
        ref, digest = ref.rsplit("@", 1)
        if not _DIGEST_RE.match(digest):
            raise ImageResolveError(f"malformed digest {digest!r}")
    tag = None
    # a colon after the last slash is a tag; earlier ones are port numbers
    last = ref.rsplit("/", 1)[-1]
    if ":" in last:
        ref, tag = ref.rsplit(":", 1)
        if not _TAG_RE.match(tag):
            raise ImageResolveError(f"malformed tag {tag!r}")
    parts = ref.split("/")
    if len(parts) == 1:
        registry, repository = "registry-1.docker.io", f"library/{parts[0]}"
    elif "." in parts[0] or ":" in parts[0] or parts[0] == "localhost":
        registry, repository = parts[0], "/".join(parts[1:])
    else:
        registry, repository = "registry-1.docker.io", "/".join(parts)
    if not repository:
        raise ImageResolveError(f"malformed image reference {ref!r}")
    return ImageRef(registry, repository, tag, digest)


class Resolver(Protocol):
    def resolve(self, ref: str) -> None:
        """Raise ImageResolveError when ``ref`` does not resolve."""


class RegistryResolver:
    """OCI distribution-spec manifest check with token auth (the regclient
    slot). ``plain_http=True`` targets http:// registries (local fakes)."""

    def __init__(self, plain_http: bool = False, timeout: float = 10.0):
        self.plain_http = plain_http
        self.timeout = timeout

    def _get(self, url: str, headers: Optional[Dict[str, str]] = None
             ) -> Tuple[int, Dict[str, str], bytes]:
        """(status, headers, body) of one GET; an HTTP error status is an
        answer, not an exception."""
        req = urllib.request.Request(url, headers=headers or {})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return resp.status, dict(resp.headers), resp.read()
        except urllib.error.HTTPError as e:
            return e.code, dict(e.headers or {}), e.read()

    def _token(self, challenge: str, repository: str) -> Optional[str]:
        """Follow a Bearer WWW-Authenticate challenge (Docker Hub et al)."""
        m = dict(re.findall(r'(\w+)="([^"]*)"', challenge))
        realm = m.get("realm")
        if not challenge.lower().startswith("bearer") or not realm:
            return None
        params: Dict[str, str] = {}
        if m.get("service"):
            params["service"] = m["service"]
        params["scope"] = m.get("scope") or f"repository:{repository}:pull"
        status, _, body = self._get(
            f"{realm}?{urllib.parse.urlencode(params)}")
        if status != 200:
            return None
        doc = json.loads(body or b"{}")
        return doc.get("token") or doc.get("access_token")

    def resolve(self, ref: str) -> None:
        parsed = parse_image_ref(ref)
        scheme = "http" if self.plain_http else "https"
        url = (f"{scheme}://{parsed.registry}/v2/{parsed.repository}"
               f"/manifests/{parsed.reference}")
        headers = {"Accept": MANIFEST_ACCEPT}
        try:
            status, resp_headers, _ = self._get(url, headers)
            if status == 401:
                token = self._token(
                    resp_headers.get("WWW-Authenticate", ""),
                    parsed.repository)
                if token:
                    headers["Authorization"] = f"Bearer {token}"
                    status, _, _ = self._get(url, headers)
        except Exception as e:
            raise ImageResolveError(
                f"{parsed}: registry unreachable ({type(e).__name__}: {e})")
        if status == 404:
            raise ImageResolveError(
                f"{parsed}: manifest not found (tag or repository "
                f"does not exist)")
        if status != 200:
            raise ImageResolveError(
                f"{parsed}: registry answered {status}")


def collect_cr_images(cr: dict) -> List[tuple]:
    """(spec path, resolved ref) for every operand that explicitly
    configures an image (built-in defaults are release-baked and not the
    CR author's to verify)."""
    from .gpudriver import KIND_GPU_DRIVER
    from .image import image_path

    out = []
    spec = cr.get("spec") or {}
    if cr.get("kind") == KIND_GPU_DRIVER:
        # the GPUDriver spec IS a component spec at top level
        spec = {"driver": spec} if any(
            spec.get(k) for k in ("repository", "image", "version")) else {}
    for component, body in sorted(spec.items()):
        if not isinstance(body, dict):
            continue
        if not any(body.get(k) for k in ("repository", "image", "version")):
            continue
        try:
            ref = image_path(component, body.get("repository"),
                             body.get("image"), body.get("version"))
        except ValueError:
            continue  # static resolvability already reported by validate_cr
        out.append((f"/spec/{component}", ref))
    return out


def resolve_cr_images(cr: dict, resolver: Resolver) -> List[str]:
    """Errors for every explicitly-configured operand image that does not
    resolve against its registry."""
    errs = []
    for path, ref in collect_cr_images(cr):
        try:
            resolver.resolve(ref)
        except ImageResolveError as e:
            errs.append(f"{path}: {e}")
    return errs
