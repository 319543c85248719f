"""b2_layers_roofline: the summed bounds (``roofline_layers``) of every
forward call of the traced window, over kernel B2's device time. Moves
attn_tok_s."""

from perfbench import roofline_layers

KERNEL = ("flash_fwd",)


def read(t):
    calls = t.facts.get("layer_calls")
    dev = t.device_s(KERNEL)
    if not calls or t.steps == 0 or t.peak is None or dev <= 0:
        return None
    return 100.0 * roofline_layers.calls_bound(t.peak, calls) * t.steps / dev
