"""A run with the timed path broken underneath comes out not correct:
each fault a cell can have, planted in the port (``faults.py``), on the
CPU at a small size; and the same run unbroken comes out correct."""

import pytest

from perfbench.tests import cpu

CELLS = {
    "attn.prefill-64k": ["attention_state_unchanged", "attention_half_batch",
                         "attention_answer_altered"],
    "attn.train-16k": ["attention_state_unchanged", "attention_half_batch",
                       "attention_answer_altered"],
    "proofs.hbm-1card": ["triad_state_unchanged", "triad_half_batch",
                         "triad_answer_altered"],
    "proofs.nvlink-4card": ["allreduce_state_unchanged",
                            "allreduce_half_batch",
                            "allreduce_exchange_left_out",
                            "allreduce_answer_altered"],
}
CASES = [(c, f) for c, faults in CELLS.items() for f in faults]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_not_correct(cell, fault):
    line = cpu.run(cpu.small_cell(cell), seconds=0.4,
                   patch=f"perfbench.tests.faults:{fault}")
    assert line["correct"] is False, line["checks"]
    assert line["failed"] >= 1


@pytest.mark.parametrize("cell", list(CELLS))
def test_sound_run_is_correct(cell):
    line = cpu.run(cpu.small_cell(cell), seconds=0.4)
    assert line["correct"] is True, line["checks"]
