"""tpu-operator's accelerator half on PyTorch and CUDA (NVIDIA H100).

The per-node validation chain of ``tpu_operator`` rebuilt on PyTorch: each
proof runs on a CUDA card and writes the same barrier files the operands
wait on. The package imports ``torch`` and never JAX or ``tpu_operator``;
where it needs logic of a framework-neutral module there (the barrier
protocol, the collective bus factors) it keeps its own copy.

Package map:

- ``workloads/``  hardware specs, CUDA bring-up, the matmul, HBM-triad and
                  collective proofs; long-context attention, the burn-in
                  trainers (transformer, conv), pipeline and MoE, the
                  elastic workload's DCP checkpoint store
- ``kernels/``    builds the hand-written CUDA kernels and host programs
                  under ``csrc/``
- ``parallel/``   process groups and meshes (NCCL on the card, gloo on the
                  CPU), the multi-node backend, differentiable collectives
- ``validator/``  barrier files, the validation components, the workload
                  pod proofs and the node-status exporter
- ``metrics/``    per-card telemetry (NVML through ``csrc/gpu_telemetry.cc``)
                  as Prometheus gauges, the health engine and its digests'
                  fleet fold; the operator's own metrics
- ``runtime/``    the client contract, an in-memory fake apiserver, and a
                  small in-cluster client for the pod proofs and agents
- ``api/``        the GPUClusterPolicy, GPUDriver and SliceRequest types,
                  their CRDs with CEL admission, offline validation, the
                  typed clientset, conditions, labels and resource names
                  (``nvidia.com/gpu``)
- ``render/``     the template engine over ``manifests/``
- ``state/``      the operand states, their apply/readiness skeleton and
                  dependency DAG; node pools
- ``controllers/`` the GPUClusterPolicy, GPUDriver, upgrade, placement and
                  telemetry reconcilers and the state manager
- ``deploy/``     the install bundle from ``values.yaml``, the Helm chart
                  (``deployments/gpu-operator/``), the OLM bundle, apply
                  and drift checks
- ``manifests/``  one directory per operand state; every ``command:``
                  names one of the port's agents
- ``cli/``        the validator, node agents, ``gpu-operator``, ``gpuop-cfg``,
                  ``gpuop-must-gather``, ``gpu-operator-maintenance``
- ``entry.py``    the burn-in model's forward on one card
- ``convert.py``  numpy (and JAX-as-numpy) arrays into torch tensors

Entry points take a ``device``: ``None`` means ``cuda:0`` and raises where
there is no CUDA; the CPU runs only when the caller passes ``"cpu"``.
"""

__version__ = "0.1.0"
