"""gpu-operator-maintenance: in-cluster lifecycle hook commands.

The port's counterpart of ``tpu_operator/cli/maintenance.py``, over the
GPUClusterPolicy and GPUDriver kinds.

The reference's chart ships two hook Jobs (deployments/gpu-operator/
templates/upgrade_crd.yaml, cleanup_crd.yaml) that shell out to kubectl
inside the operator image:

- pre-upgrade: apply the CRDs (package managers don't upgrade CRDs, so a
  new chart version's schema changes would silently not land);
- pre-delete: delete the CRs and then the CRDs, so operands tear down
  through owner GC while the operator still exists to handle it.

This image carries no kubectl; the same two operations are first-class
commands against the API server:

    gpu-operator-maintenance apply-crds
    gpu-operator-maintenance cleanup [--timeout 300]

Both are idempotent and safe to re-run (hook Jobs restart on failure).
"""

from __future__ import annotations

import argparse
import logging
import sys
import time

from ..api.clusterpolicy import KIND_CLUSTER_POLICY, V1
from ..api.gpudriver import KIND_GPU_DRIVER, V1ALPHA1
from ..runtime.client import Client, NotFoundError

log = logging.getLogger("tpu_operator_torch.maintenance")

CRD_API = "apiextensions.k8s.io/v1"

# each CR kind with the group/version it is served under
CR_KINDS = ((V1, KIND_CLUSTER_POLICY), (V1ALPHA1, KIND_GPU_DRIVER))


def apply_crds(client: Client) -> int:
    """Create-or-update every CRD from the in-image schemas (the
    upgrade_crd.yaml hook's `kubectl apply -f /opt/.../crds`). Returns
    the number of CRDs written (created or updated)."""
    from ..api.crd import all_crds

    written = 0
    for crd in all_crds():
        name = crd["metadata"]["name"]
        existing = client.get_or_none(CRD_API, "CustomResourceDefinition",
                                      name)
        if existing is None:
            client.create(crd)
            log.info("created CRD %s", name)
            written += 1
            continue
        # carry the concurrency token; schema payload fully replaced
        crd = dict(crd)
        crd.setdefault("metadata", {})
        crd["metadata"]["resourceVersion"] = (
            existing.get("metadata") or {}).get("resourceVersion")
        client.update(crd)
        log.info("updated CRD %s", name)
        written += 1
    return written


def cleanup(client: Client, timeout_s: float = 300.0,
            poll_s: float = 2.0, drop_crds: bool = True) -> bool:
    """Delete every GPUClusterPolicy/GPUDriver CR, wait for them to go
    (operands tear down via owner GC / the reconcilers' delete paths
    while the operator still runs), then drop the CRDs themselves — the
    cleanup_crd.yaml pre-delete hook. ``drop_crds=False`` keeps the CRDs
    (the `gpuop-cfg uninstall` default: CRD removal is a separate,
    explicit decision, like Helm's keep-CRDs-on-uninstall convention).
    Returns True when fully cleaned."""
    for api_version, kind in CR_KINDS:
        try:
            for cr in client.list(api_version, kind):
                name = cr["metadata"]["name"]
                try:
                    client.delete(api_version, kind, name)
                    log.info("deleted %s %s", kind, name)
                except NotFoundError:
                    pass
        except NotFoundError:
            continue  # CRD already gone
    deadline = time.monotonic() + timeout_s
    remaining = list(CR_KINDS)
    while remaining and time.monotonic() < deadline:
        still = []
        for api_version, kind in remaining:
            try:
                if client.list(api_version, kind):
                    still.append((api_version, kind))
            except NotFoundError:
                pass
        remaining = still
        if remaining:
            time.sleep(poll_s)
    if remaining:
        log.error("CRs still present after %.0fs: %s — leaving CRDs in "
                  "place (finalizers/operands may still be tearing down)",
                  timeout_s, remaining)
        return False
    if not drop_crds:
        return True
    from ..api.crd import all_crds

    for crd in all_crds():
        try:
            client.delete(CRD_API, "CustomResourceDefinition",
                          crd["metadata"]["name"])
            log.info("deleted CRD %s", crd["metadata"]["name"])
        except NotFoundError:
            pass
    return True


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(prog="gpu-operator-maintenance",
                                description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("apply-crds", help="create-or-update the CRDs "
                                      "(pre-upgrade hook)")
    c = sub.add_parser("cleanup", help="delete CRs, wait, drop CRDs "
                                       "(pre-delete hook)")
    c.add_argument("--timeout", type=float, default=300.0)
    args = p.parse_args(argv)

    from ..runtime.kubeclient import HTTPClient, KubeConfig

    client = HTTPClient(KubeConfig.load())
    if args.cmd == "apply-crds":
        n = apply_crds(client)
        print(f"applied {n} CRDs")
        return 0
    ok = cleanup(client, timeout_s=args.timeout)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
