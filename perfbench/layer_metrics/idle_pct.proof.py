"""idle_pct.proof: the share of the traced window in which no operation
ran on the card (rank 0's card on four). Moves proof_gbps."""


def read(t):
    if t.busy_s <= 0 or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
