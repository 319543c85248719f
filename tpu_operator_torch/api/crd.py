"""CustomResourceDefinition generation.

The port's counterpart of ``tpu_operator/api/crd.py``: the CRDs are
derived directly from the dataclass schemas so they can never drift from
the types (the failure mode the reference guards with `make
validate-generated-assets`, Makefile:241-243). Where the reference's
rules name TPU facts, the port's stand on its own fields:

- the core proofs no policy may disable are ``driver``, ``cuda``,
  ``nvlink`` and ``plugin`` (the reference's ``jax`` and ``ici``);
- ``GPUDriverSpec`` has no ``channel``: the reference's immutable
  ``channel``, its enum and its ``custom``-needs-a-version rule have no
  field to stand on and are dropped. ``driverType`` stays immutable
  (enum ``driver``/``host``, default ``driver``), and ``driverVersion``
  stays mutable, since changing it is the driver rollout;
- a SliceRequest's ``topology`` names a fabric or a whole
  ``gpu.topology`` value (``mnnvl``, ``nvswitch-8``), never a TPU grid.
"""

from __future__ import annotations

from .clusterpolicy import GROUP, KIND_CLUSTER_POLICY, GPUClusterPolicySpec
from .convert import schema_of
from .gpudriver import KIND_GPU_DRIVER, GPUDriverSpec
from .slicerequest import KIND_SLICE_REQUEST, SliceRequestSpec

def _status_schema() -> dict:
    return {
        "type": "object",
        "properties": {
            "state": {"type": "string",
                      "enum": ["ignored", "ready", "notReady", "disabled"]},
            "namespace": {"type": "string"},
            "conditions": {"type": "array",
                           "items": {"type": "object",
                                     "x-kubernetes-preserve-unknown-fields": True}},
            "clusterInfo": {"type": "object",
                            "x-kubernetes-preserve-unknown-fields": True},
            "slices": {"type": "array",
                       "items": {
                           "type": "object",
                           "properties": {
                               "id": {"type": "string"},
                               "accelerator": {"type": "string"},
                               "topology": {"type": "string"},
                               "hosts": {"type": "integer"},
                               "hostsValidated": {"type": "integer"},
                               "validated": {"type": "boolean"},
                               "upgradeState": {"type": "string"},
                           }}},
            # true when status.slices was capped at MAX_ROWS — large
            # fleets can tell rows were dropped (the gauges stay full)
            "slicesTruncated": {"type": "boolean"},
        },
    }


def _slice_request_status_schema() -> dict:
    return {
        "type": "object",
        "properties": {
            "phase": {"type": "string",
                      "enum": ["Pending", "Placed", "Unschedulable"]},
            "nodes": {"type": "array", "items": {"type": "string"}},
            "pool": {"type": "string"},
            "sliceId": {"type": "string"},
            "reason": {"type": "string"},
            "score": {"type": "string"},
            "evictions": {"type": "integer"},
            "lastEvictionReason": {"type": "string"},
            # chips actually bound (spec.chips_needed() at bind time);
            # a later spec edit that diverges from this is what triggers
            # the shrink/grow intent
            "chips": {"type": "integer"},
            # completed migrations/resizes (monotone; the placement-stable
            # chaos invariant accepts a bound-node change only when this
            # or evictions advanced)
            "migrations": {"type": "integer"},
            # current/last elastic-slice attempt (slice-intent contract)
            "migration": {
                "type": "object",
                "properties": {
                    "phase": {"type": "string",
                              "enum": ["Migrating", "Checkpointed",
                                       "Rebound", "Resumed", "Aborted"]},
                    "intent": {"type": "string",
                               "enum": ["migrate", "shrink", "grow"]},
                    "deadline": {"type": "string"},
                    "startedAt": {"type": "string"},
                    "ackedStep": {"type": "integer"},
                    "restoredStep": {"type": "integer"},
                    "from": {"type": "array", "items": {"type": "string"}},
                    "to": {"type": "array", "items": {"type": "string"}},
                    "forGeneration": {"type": "integer"},
                    "reason": {"type": "string"},
                },
            },
            "conditions": {"type": "array",
                           "items": {"type": "object",
                                     "x-kubernetes-preserve-unknown-fields": True}},
        },
    }


def _crd(kind: str, plural: str, singular: str, version: str,
         spec_schema: dict, short_names: list,
         extra_printer_cols: list | None = None,
         scope: str = "Cluster",
         status_schema: dict | None = None) -> dict:
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": f"{plural}.{GROUP}"},
        "spec": {
            "group": GROUP,
            "names": {"kind": kind, "plural": plural, "singular": singular,
                      "shortNames": short_names},
            "scope": scope,
            "versions": [{
                "name": version,
                "served": True,
                "storage": True,
                "subresources": {"status": {}},
                "additionalPrinterColumns": [
                    {"name": "Status", "type": "string",
                     "jsonPath": ".status.state"},
                    {"name": "Age", "type": "date",
                     "jsonPath": ".metadata.creationTimestamp"},
                ] + (extra_printer_cols or []),
                "schema": {"openAPIV3Schema": {
                    "type": "object",
                    "properties": {
                        "spec": spec_schema,
                        "status": status_schema or _status_schema(),
                    },
                }},
            }],
        },
    }


# the proofs whose barrier files every operand's initContainer gates on;
# a policy disabling one renders cleanly and then wedges every node, so
# it must bounce at `kubectl apply` (admission), not sit NotReady
CORE_PROOFS = ("driver", "cuda", "nvlink", "plugin")

# a SliceRequest's topology: a fabric, optionally with a card count
# (state/nodepool.py topology_of's vocabulary)
TOPOLOGY_PATTERN = r"^(mnnvl|nvswitch|nvlink|pcie)(-\d+)?$"


def cluster_policy_crd() -> dict:
    schema = schema_of(GPUClusterPolicySpec)
    # admission-time analog of validate.py's _semantic_errors core-proof
    # rule, as CEL like the reference's XValidation blocks
    # (nvidiadriver_types.go:40-186)
    schema["x-kubernetes-validations"] = [
        {"rule": (f"!has(self.validator) || !has(self.validator.{p}) || "
                  f"!has(self.validator.{p}.enabled) || "
                  f"self.validator.{p}.enabled != false"),
         "message": (f"validator core proof '{p}' cannot be disabled — "
                     f"{p}-ready gates downstream operands (disable aux "
                     f"proofs instead: hbm/dcn/runtime)")}
        for p in CORE_PROOFS]
    return _crd(KIND_CLUSTER_POLICY, "gpuclusterpolicies", "gpuclusterpolicy",
                "v1", schema, ["gcp", "gpucp"])


def gpu_driver_crd() -> dict:
    schema = schema_of(GPUDriverSpec)
    # driverType is immutable, like the reference's CEL XValidation rules on
    # NVIDIADriver (nvidiadriver_types.go:40-186). driverVersion stays
    # mutable: changing it IS the rolling-upgrade path
    schema["properties"]["driverType"]["x-kubernetes-validations"] = [
        {"rule": "self == oldSelf",
         "message": "driverType is immutable — create a new GPUDriver "
                    "resource instead"}]
    # enum tightening: catch typos at apply time, not reconcile time
    schema["properties"]["driverType"]["enum"] = ["driver", "host"]
    # the default pairs with the immutability rule above: without it a CR
    # created without driverType has no oldSelf at this node, so the
    # transition rule is skipped and the flip it forbids slips through
    schema["properties"]["driverType"]["default"] = "driver"
    schema["properties"]["imagePullPolicy"]["enum"] = [
        "Always", "IfNotPresent", "Never"]
    return _crd(KIND_GPU_DRIVER, "gpudrivers", "gpudriver", "v1alpha1",
                schema, ["gpud"],
                [{"name": "DriverVersion", "type": "string",
                  "jsonPath": ".spec.driverVersion"}])


def slice_request_crd() -> dict:
    schema = schema_of(SliceRequestSpec)
    schema["properties"]["chips"]["minimum"] = 0
    schema["properties"]["topology"]["pattern"] = TOPOLOGY_PATTERN
    # a request must ask for something: chips > 0 or an explicit topology
    schema["x-kubernetes-validations"] = [
        {"rule": "(has(self.chips) && self.chips > 0) || "
                 "(has(self.topology) && self.topology != '')",
         "message": "request must name chips > 0 or a topology fabric"}]
    return _crd(KIND_SLICE_REQUEST, "slicerequests", "slicerequest",
                "v1alpha1", schema, ["sreq"],
                [{"name": "Phase", "type": "string",
                  "jsonPath": ".status.phase"},
                 {"name": "Chips", "type": "integer",
                  "jsonPath": ".spec.chips"}],
                scope="Namespaced",
                status_schema=_slice_request_status_schema())


def all_crds() -> list:
    return [cluster_policy_crd(), gpu_driver_crd(), slice_request_crd()]
