"""The port's benchmarks: ``controlplane`` measures the operator's own
reconcile cost on the in-memory fake apiserver."""
