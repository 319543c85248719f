"""Per-node validation plane on CUDA: barrier files and proofs."""
