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
                  as Prometheus gauges
- ``runtime/``    a small in-cluster Kubernetes client for the pod proofs
- ``api/``        resource names (``nvidia.com/gpu``)
- ``cli/``        ``python -m tpu_operator_torch.cli.validator``
- ``entry.py``    the burn-in model's forward on one card
- ``convert.py``  numpy (and JAX-as-numpy) arrays into torch tensors

Entry points take a ``device``: ``None`` means ``cuda:0`` and raises where
there is no CUDA; the CPU runs only when the caller passes ``"cpu"``.
"""
