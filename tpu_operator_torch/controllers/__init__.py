"""Controllers of the port: the cluster-policy reconcile path."""
