"""OLM ClusterServiceVersion generation — the bundle/ slot.

The port's counterpart of ``tpu_operator/deploy/csv.py``: its texts,
samples and descriptors speak of the card's stack.

The reference ships a real OLM bundle per release
(bundle/manifests/gpu-operator-certified.clusterserviceversion.yaml:
alm-examples annotation, owned CRDs with descriptors, an install strategy
embedding the manager Deployment + clusterPermissions, installModes,
relatedImages) and CI keeps it consistent with the CRD
(``make validate-csv``, Makefile:233-236). Here the CSV is generated from
the same code that renders the Deployment/RBAC/CRDs, so it cannot drift:

    gpuop-cfg generate bundle [--values my-values.yaml]

emits the bundle manifest stream: the CSV, every CRD, and the OLM bundle
annotations document (metadata/annotations.yaml content).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List

from .. import __version__
from ..api.clusterpolicy import KIND_CLUSTER_POLICY
from ..api.crd import all_crds
from ..api.gpudriver import KIND_GPU_DRIVER
from ..runtime.objects import yaml_module
from .packaging import (
    cluster_role,
    namespaced_role,
    operator_deployment,
    sample_cluster_policy,
)

PACKAGE_NAME = "gpu-operator"
DEFAULT_CHANNEL = "stable"

_DESCRIPTION = """\
The GPU Operator manages the software stack GPU nodes need to serve
accelerated workloads in Kubernetes: driver verification, device/runtime
hookup, the nvidia.com/gpu device plugin, telemetry exporters, feature
discovery, topology/slice shaping, and a per-node validation gate that
proves each layer (through a real CUDA matmul + NVLink collective) before
workloads schedule. A singleton GPUClusterPolicy CR configures the whole
stack; per-pool GPUDriver CRs pin the driver version per node pool."""


def _sample_gpudriver() -> dict:
    from ..api.gpudriver import V1ALPHA1

    return {
        "apiVersion": V1ALPHA1,
        "kind": KIND_GPU_DRIVER,
        "metadata": {"name": "h100-any"},
        "spec": {"nodeSelector": {
                     "cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}},
    }


def _sample_slicerequest() -> dict:
    from ..api.slicerequest import new_slice_request

    return new_slice_request(
        "train-8x", spec={"chips": 8, "topology": "nvswitch",
                          "preferredGenerations": ["h100-sxm", "a100-sxm"]})


def _owned_crds() -> List[dict]:
    from ..api.clusterpolicy import V1
    from ..api.gpudriver import V1ALPHA1
    from ..api.slicerequest import KIND_SLICE_REQUEST
    from ..api.slicerequest import V1ALPHA1 as SR_V1ALPHA1

    return [
        {
            "name": "gpuclusterpolicies.gpu.graft.dev",
            "kind": KIND_CLUSTER_POLICY,
            "version": V1.split("/")[-1],
            "displayName": "GPUClusterPolicy",
            "description": "Singleton configuration of the whole GPU "
                           "software stack; one sub-spec per operand.",
            "resources": [
                {"kind": "DaemonSet", "name": "", "version": "apps/v1"},
                {"kind": "Service", "name": "", "version": "v1"},
                {"kind": "RuntimeClass", "name": "",
                 "version": "node.k8s.io/v1"},
            ],
            "specDescriptors": [
                {"path": "devicePlugin.enabled",
                 "displayName": "Device Plugin",
                 "description": "Advertise nvidia.com/gpu to kubelet",
                 "x-descriptors": [
                     "urn:alm:descriptor:com.tectonic.ui:booleanSwitch"]},
                {"path": "validator.nvlinkBandwidthThreshold",
                 "displayName": "NVLink bandwidth threshold",
                 "description": "Fraction of one-way NVLink bandwidth "
                                "the collective proof must reach"},
                {"path": "upgradePolicy.autoUpgrade",
                 "displayName": "Auto upgrade",
                 "description": "Allow automatic rolling driver upgrades",
                 "x-descriptors": [
                     "urn:alm:descriptor:com.tectonic.ui:booleanSwitch"]},
            ],
            "statusDescriptors": [
                {"path": "state", "displayName": "State",
                 "description": "ignored|ready|notReady|disabled"},
            ],
        },
        {
            "name": "gpudrivers.gpu.graft.dev",
            "kind": KIND_GPU_DRIVER,
            "version": V1ALPHA1.split("/")[-1],
            "displayName": "GPUDriver",
            "description": "Per-node-pool driver flavor (driver version "
                           "per product x topology pool).",
            "statusDescriptors": [
                {"path": "state", "displayName": "State"},
            ],
        },
        {
            "name": "slicerequests.gpu.graft.dev",
            "kind": KIND_SLICE_REQUEST,
            "version": SR_V1ALPHA1.split("/")[-1],
            "displayName": "SliceRequest",
            "description": "A request for GPU cards in one NVLink "
                           "domain; the placement engine binds it to "
                           "concrete nodes.",
            "statusDescriptors": [
                {"path": "phase", "displayName": "Phase",
                 "description": "Pending|Placed|Unschedulable"},
            ],
        },
    ]


def render_csv(values: Dict[str, Any]) -> dict:
    """A real, structurally-complete ClusterServiceVersion for the
    current version and values-resolved operator image."""
    from .values import operator_image

    image = operator_image(values)
    deployment = operator_deployment(
        values.get("namespace", "gpu-operator"), image,
        values.get("operator") or {})
    # OLM owns name/namespace placement; the install strategy embeds only
    # the Deployment's spec
    alm_examples = [sample_cluster_policy(), _sample_gpudriver(),
                    _sample_slicerequest()]
    return {
        "apiVersion": "operators.coreos.com/v1alpha1",
        "kind": "ClusterServiceVersion",
        "metadata": {
            "name": f"{PACKAGE_NAME}.v{__version__}",
            "namespace": "placeholder",
            "labels": {
                "operatorframework.io/arch.amd64": "supported",
                "operatorframework.io/arch.arm64": "supported",
                "pod-security.kubernetes.io/enforce": "privileged",
                "pod-security.kubernetes.io/audit": "privileged",
                "pod-security.kubernetes.io/warn": "privileged",
            },
            "annotations": {
                "alm-examples": json.dumps(alm_examples, indent=2),
                "capabilities": "Deep Insights",
                "categories": "AI/Machine Learning, OpenShift Optional",
                "containerImage": image,
                "description": "Automates GPU software stack lifecycle "
                               "management in Kubernetes",
                "support": PACKAGE_NAME,
                # OLM reads this from the CSV object (the copy in
                # metadata/annotations.yaml is informational)
                "operatorframework.io/suggested-namespace": "gpu-operator",
            },
        },
        "spec": {
            "displayName": "GPU Operator",
            "description": _DESCRIPTION,
            "keywords": ["gpu", "cuda", "nvlink", "device-plugin",
                         "accelerator", "operator"],
            "maintainers": [{"name": "gpu-operator maintainers",
                             "email": "maintainers@gpu-operator.dev"}],
            "provider": {"name": PACKAGE_NAME},
            "links": [{"name": "Source",
                       "url": "https://github.com/gpu-operator/gpu-operator"}],
            "maturity": "stable",
            "version": __version__,
            "minKubeVersion": "1.27.0",
            "installModes": [
                {"type": "OwnNamespace", "supported": True},
                {"type": "SingleNamespace", "supported": True},
                {"type": "MultiNamespace", "supported": False},
                {"type": "AllNamespaces", "supported": False},
            ],
            "install": {
                "strategy": "deployment",
                "spec": {
                    "clusterPermissions": [{
                        "serviceAccountName": "gpu-operator",
                        "rules": cluster_role()["rules"],
                    }],
                    # OLM's native namespaced-permission slot carries the
                    # Role rules (the chart's role.yaml split)
                    "permissions": [{
                        "serviceAccountName": "gpu-operator",
                        "rules": namespaced_role("gpu-operator")["rules"],
                    }],
                    "deployments": [{
                        "name": "gpu-operator",
                        "spec": deployment["spec"],
                    }],
                },
            },
            "customresourcedefinitions": {"owned": _owned_crds()},
            "relatedImages": [{"name": "gpu-operator", "image": image}],
        },
    }


def bundle_annotations() -> dict:
    """metadata/annotations.yaml content of an OLM registry+v1 bundle,
    including the scorecard test-config pointers OLM tooling reads
    (ref bundle/metadata/annotations.yaml)."""
    return {
        "annotations": {
            "operators.operatorframework.io.bundle.mediatype.v1":
                "registry+v1",
            "operators.operatorframework.io.bundle.manifests.v1":
                "manifests/",
            "operators.operatorframework.io.bundle.metadata.v1": "metadata/",
            "operators.operatorframework.io.bundle.package.v1": PACKAGE_NAME,
            "operators.operatorframework.io.bundle.channels.v1":
                DEFAULT_CHANNEL,
            "operators.operatorframework.io.bundle.channel.default.v1":
                DEFAULT_CHANNEL,
            "operators.operatorframework.io.test.config.v1":
                "tests/scorecard/",
            "operators.operatorframework.io.test.mediatype.v1":
                "scorecard+v1",
            "operatorframework.io/suggested-namespace": "gpu-operator",
        },
    }


def scorecard_config() -> dict:
    """tests/scorecard/config.yaml — the operator-sdk scorecard stages
    the reference bundle carries (bundle/tests/scorecard/config.yaml):
    basic spec sanity plus OLM bundle validation, run in parallel."""
    test = "quay.io/operator-framework/scorecard-test:latest"
    return {
        "kind": "Configuration",
        "apiVersion": "scorecard.operatorframework.io/v1alpha3",
        "metadata": {"name": "config"},
        "stages": [{
            "parallel": True,
            "tests": [
                {"image": test,
                 "entrypoint": ["scorecard-test", "basic-check-spec"],
                 "labels": {"suite": "basic",
                            "test": "basic-check-spec-test"}},
                {"image": test,
                 "entrypoint": ["scorecard-test", "olm-bundle-validation"],
                 "labels": {"suite": "olm",
                            "test": "olm-bundle-validation-test"}},
            ],
        }],
    }


def render_bundle_stream(values: Dict[str, Any]) -> List[dict]:
    """The full bundle: CSV + owned CRDs (the manifests/ dir content)
    followed by the bundle annotations (the metadata/ dir content)."""
    return [render_csv(values)] + all_crds() + [bundle_annotations()]


def write_bundle_dir(values: Dict[str, Any], out_dir: str) -> List[str]:
    """Write the registry+v1 bundle DIRECTORY layout OLM tooling
    consumes (`opm`, `operator-sdk bundle validate`, scorecard):

        manifests/<csv>.clusterserviceversion.yaml + one file per CRD
        metadata/annotations.yaml
        tests/scorecard/config.yaml

    CRD filenames follow the reference's `<group>_<plural>.yaml` form
    (bundle/v24.3.0/manifests/nvidia.com_clusterpolicies.yaml). Returns
    the relative paths written."""
    import os

    yaml = yaml_module()

    def write(rel: str, doc: dict) -> str:
        path = os.path.join(out_dir, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            yaml.safe_dump(doc, f, sort_keys=False)
        return rel

    written = [write(
        f"manifests/{PACKAGE_NAME}.clusterserviceversion.yaml",
        render_csv(values))]
    for crd in all_crds():
        group, plural = crd["spec"]["group"], crd["spec"]["names"]["plural"]
        written.append(write(f"manifests/{group}_{plural}.yaml", crd))
    written.append(write("metadata/annotations.yaml",
                         bundle_annotations()))
    written.append(write("tests/scorecard/config.yaml",
                         scorecard_config()))
    return written
