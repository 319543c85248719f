"""The operand render path's property tier on the port, states six to
ten (b) or eleven to fifteen (c) of ``build_states()``: see
``test_torch_fuzz_operands_a.py``."""

from test_torch_fuzz_operands_a import STATE_NAMES, properties

TestOperandRenderFuzz = properties(STATE_NAMES[10:])
