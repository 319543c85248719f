"""PyTorch validation workloads: matmul, HBM triad and collective proofs."""
