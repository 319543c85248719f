"""tpu-operator's accelerator half on PyTorch and CUDA (NVIDIA H100).

The per-node validation chain of ``tpu_operator`` rebuilt on PyTorch: each
proof runs on a CUDA card and writes the same barrier files the operands
wait on. The package imports ``torch`` and never JAX or ``tpu_operator``;
where it needs logic of a framework-neutral module there (the barrier
protocol, the collective bus factors) it keeps its own copy.

Package map:

- ``workloads/``  hardware specs, CUDA bring-up, the matmul, HBM-triad and
                  collective proofs; long-context attention, the burn-in
                  trainers (transformer, conv), pipeline and MoE
- ``kernels/``    builds the hand-written CUDA kernels under ``csrc/``
- ``parallel/``   process groups and meshes (NCCL on the card, gloo on the
                  CPU), the multi-node backend, differentiable collectives
- ``validator/``  barrier files and the validation components
- ``cli/``        ``python -m tpu_operator_torch.cli.validator``
- ``convert.py``  numpy (and JAX-as-numpy) arrays into torch tensors

Entry points take a ``device``: ``None`` means ``cuda:0`` and raises where
there is no CUDA; the CPU runs only when the caller passes ``"cpu"``.
"""
