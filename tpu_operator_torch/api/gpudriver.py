"""GPUDriver: the per-node-pool driver CRD's kind and version.

The counterpart of ``tpu_operator/api/tpudriver.py``'s constants, which
the cluster-policy reconciler reads to stand its driver state down while
driver CRs own the rollout. The CRD's spec and its controller are not
ported yet.
"""

from __future__ import annotations

from .clusterpolicy import GROUP

V1ALPHA1 = f"{GROUP}/v1alpha1"
KIND_GPU_DRIVER = "GPUDriver"
