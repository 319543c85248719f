from .agent import FeatureDiscovery, compute_feature_labels  # noqa: F401
