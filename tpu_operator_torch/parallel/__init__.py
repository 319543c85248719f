"""Process-group helpers for the collective workloads."""
