"""Chip telemetry: the node exporter of per-card gauges."""
