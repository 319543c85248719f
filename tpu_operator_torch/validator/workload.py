"""Workload-pod proofs: the validations that go through the scheduler.

Counterpart of ``tpu_operator/validator/workload.py``. A proof creates a
real pod (requesting ``nvidia.com/gpu`` or not) and waits for it to
succeed, which proves admission, scheduling, device allocation and the
runtime end to end (the NVIDIA validator's plugin and CUDA workload
pods).

The client is duck-typed: ``get_or_none``, ``create`` and ``delete``, as
``runtime.kubeclient.InClusterClient`` has them. Any exception whose
``code`` is 404 counts as not-found, so the reference's in-memory client
drives these proofs in tests.

The pod runs ``python -m tpu_operator_torch.workloads.matmul`` with
``MATMUL_SIZE`` in its env, as the reference's runs the JAX matmul;
like the reference's, that ``main()`` runs ``run()`` at its default size
whatever the env says.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, Mapping

from ..api import labels as L
from . import barrier
from .components import ValidationFailed

log = logging.getLogger("gpu_validator")

POD_WAIT_ATTEMPTS = 60     # the NVIDIA validator's pod wait: 60 x 5 s
POD_WAIT_INTERVAL_S = 5.0
RESOURCE_WAIT_ATTEMPTS = 30  # the resource wait: 30 x 5 s


def get_nested(obj: Mapping, *path: str, default: Any = None) -> Any:
    """Walk ``path`` through nested mappings; ``default`` on a miss."""
    cur: Any = obj
    for key in path:
        if not isinstance(cur, Mapping) or key not in cur:
            return default
        cur = cur[key]
    return cur


def cuda_workload_pod(namespace: str, node_name: str, image: str,
                      matmul_size: int = 4096,
                      request_gpu: bool = True) -> dict:
    """The CUDA matmul proof pod (cuda-workload-validation.yaml's)."""
    resources = ({"limits": {L.GPU_RESOURCE: "1"}} if request_gpu else {})
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {
            "name": "gpu-cuda-validator" + ("" if request_gpu else "-nores"),
            "namespace": namespace,
            "labels": {"app": "gpu-cuda-validator"},
        },
        "spec": {
            "restartPolicy": "Never",
            "nodeName": node_name,
            "tolerations": [{"key": L.GPU_RESOURCE, "operator": "Exists",
                             "effect": "NoSchedule"}],
            "containers": [{
                "name": "cuda-matmul",
                "image": image,
                "command": ["python", "-m",
                            "tpu_operator_torch.workloads.matmul"],
                "env": [{"name": "MATMUL_SIZE", "value": str(matmul_size)}],
                "resources": resources,
            }],
        },
    }


def wait_for_pod_phase(client, name: str, namespace: str,
                       want=("Succeeded",),
                       attempts: int = POD_WAIT_ATTEMPTS,
                       interval: float = POD_WAIT_INTERVAL_S) -> str:
    for _ in range(attempts):
        pod = client.get_or_none("v1", "Pod", name, namespace)
        phase = get_nested(pod or {}, "status", "phase", default="")
        if phase in want:
            return phase
        if phase == "Failed" and "Failed" not in want:
            raise ValidationFailed(f"workload pod {name} failed")
        time.sleep(interval)
    raise ValidationFailed(
        f"workload pod {name} did not reach {want} in "
        f"{attempts * interval:.0f}s")


def _delete_if_present(client, name: str, namespace: str) -> None:
    try:
        client.delete("v1", "Pod", name, namespace)
    except Exception as e:  # noqa: BLE001 — any client's not-found
        if getattr(e, "code", None) != 404:
            raise


def spawn_and_wait(client, pod: dict,
                   attempts: int = POD_WAIT_ATTEMPTS,
                   interval: float = POD_WAIT_INTERVAL_S) -> str:
    name = pod["metadata"]["name"]
    ns = pod["metadata"]["namespace"]
    _delete_if_present(client, name, ns)  # clear a previous attempt
    client.create(pod)
    try:
        return wait_for_pod_phase(client, name, ns, attempts=attempts,
                                  interval=interval)
    finally:
        _delete_if_present(client, name, ns)


def validate_plugin(client, node_name: str, namespace: str, image: str,
                    attempts: int = RESOURCE_WAIT_ATTEMPTS,
                    interval: float = POD_WAIT_INTERVAL_S) -> Dict[str, str]:
    """``nvidia.com/gpu`` allocatable on the node, then a pod requesting
    one card runs to completion -> plugin-ready."""
    allocatable = "0"
    for _ in range(attempts):
        node = client.get_or_none("v1", "Node", node_name)
        allocatable = str(get_nested(node or {}, "status", "allocatable",
                                     L.GPU_RESOURCE, default="0"))
        if allocatable not in ("", "0"):
            break
        time.sleep(interval)
    else:
        raise ValidationFailed(
            f"node {node_name} never advertised {L.GPU_RESOURCE}")

    pod = cuda_workload_pod(namespace, node_name, image, request_gpu=True)
    pod["metadata"]["name"] = "gpu-plugin-validator"
    phase = spawn_and_wait(client, pod, interval=interval)
    info = {"ALLOCATABLE": allocatable, "WORKLOAD_PHASE": phase}
    barrier.write_status("plugin-ready", info)
    return info


def validate_cuda_pod(client, node_name: str, namespace: str, image: str,
                      matmul_size: int = 4096) -> Dict[str, str]:
    """The matmul proof as a pod that requests no card -> cuda-ready."""
    pod = cuda_workload_pod(namespace, node_name, image,
                            matmul_size=matmul_size, request_gpu=False)
    phase = spawn_and_wait(client, pod)
    info = {"WORKLOAD_PHASE": phase, "MATMUL_SIZE": str(matmul_size)}
    barrier.write_status("cuda-ready", info)
    return info
