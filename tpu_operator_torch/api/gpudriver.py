"""GPUDriver: per-node-pool driver flavor CRD.

The port's counterpart of ``tpu_operator/api/tpudriver.py`` and the analog
of NVIDIADriver (api/nvidia/v1alpha1/nvidiadriver_types.go:40): one CR
selects the driver a GPU node pool runs (``driverVersion``, the NVML
driver version ``gpu-driver-install`` must find, where the reference's CR
selects a libtpu channel). Multiple CRs must not select the same node
(internal/validator/validator.go:31-110 analog lives in
controllers/validation.py). The cluster-policy reconciler reads the kind
to stand its own driver state down while driver CRs own the rollout.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from .clusterpolicy import GROUP, DriverUpgradePolicySpec
from .convert import field, from_dict, to_dict

V1ALPHA1 = f"{GROUP}/v1alpha1"
KIND_GPU_DRIVER = "GPUDriver"


@dataclass
class GPUDriverSpec:
    driver_type: Optional[str] = field(
        default="driver", description="driver (container) | host "
        "(preinstalled)")
    repository: Optional[str] = None
    image: Optional[str] = field(default="gpu-driver-installer")
    version: Optional[str] = field(description="installer image tag or "
                                   "digest")
    driver_version: Optional[str] = field(
        description="NVML driver version the pool's nodes must run "
        "(GPU_DRIVER_VERSION); empty accepts any")
    image_pull_policy: Optional[str] = None
    image_pull_secrets: Optional[List[str]] = None
    node_selector: Optional[Dict[str, str]] = field(
        description="Selects the GPU node pool this flavor applies to")
    tolerations: Optional[List[Any]] = None
    priority_class_name: Optional[str] = None
    env: Optional[List[Any]] = None
    resources: Optional[Any] = None
    install_dir: Optional[str] = field(default="/usr/local/nvidia/lib64")
    upgrade_policy: Optional[DriverUpgradePolicySpec] = None

    @classmethod
    def from_obj(cls, cr: dict) -> "GPUDriverSpec":
        return from_dict(cls, cr.get("spec") or {})

    def to_obj(self) -> dict:
        return to_dict(self)


def new_gpu_driver(name: str, spec: Optional[dict] = None) -> dict:
    return {
        "apiVersion": V1ALPHA1,
        "kind": KIND_GPU_DRIVER,
        "metadata": {"name": name},
        "spec": spec or {},
    }
