"""attn_mfu: the attention calls' model FLOPs over the traced window,
as a share of the card's bf16 peak. Moves attn_tok_s."""


def read(t):
    flops = t.facts.get("model_flops_per_call")
    if not flops or t.steps == 0 or t.peak is None or t.busy_s <= 0:
        return None
    return 100.0 * flops * t.steps / t.window_s / t.peak.bf16_flops
