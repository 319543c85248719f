"""b2_split_roofline: the summed bounds (``roofline_split``) of the full
layers' forward calls of the traced window, keys wider than values, over
kernel B2's device time launched under ``perfbench.full_fwd``. Moves
attn_tok_s."""

from perfbench import roofline_split

KERNEL = ("flash_fwd",)
SPAN = "perfbench.full_fwd"


def read(t):
    calls = [c for c in t.facts.get("layer_calls") or ()
             if c["kind"] == "full" and "d_v" in c]
    dev = t.device_s(KERNEL, span=SPAN)
    if not calls or t.steps == 0 or t.peak is None or dev <= 0:
        return None
    return 100.0 * roofline_split.calls_bound(t.peak, calls) * t.steps / dev
