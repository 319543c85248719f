"""idle_pct.attn: the share of the traced window in which no operation
ran on the card. Moves attn_tok_s."""


def read(t):
    if t.busy_s <= 0 or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
