"""A small in-cluster Kubernetes client."""
