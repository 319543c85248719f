"""bwd_ms: the device time launched under the backward span, a step
(``flash_bwd``'s chunked recompute). Moves attn_tok_s."""


def read(t):
    bwd = t.device_s(span="perfbench.bwd")
    if bwd <= 0 or t.steps == 0:
        return None
    return 1e3 * bwd / t.steps
