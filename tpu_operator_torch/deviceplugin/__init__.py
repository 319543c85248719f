"""The kubelet device plugins of the port."""
