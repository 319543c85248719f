"""On the card: each control at its cell's own size, on three seeds, is
not correct; and a short run of each one-card cell is. Skips without a
card."""

import time

import pytest

from perfbench import controls, harness, manifest

SEEDS = (3500000001, 3500000002, 3500000003)


@pytest.mark.card
@pytest.mark.parametrize("cell", ["attn.prefill-64k", "attn.train-16k",
                                  "proofs.hbm-1card", "proofs.nvlink-4card"])
def test_control_fails_at_the_cells_size(card, cell):
    c = manifest.load_cell(cell)
    for seed in SEEDS:
        got = controls.readings(c, seed, "cuda")
        assert any(not v <= lim for v, lim in got.values()), (seed, got)


@pytest.mark.card
@pytest.mark.parametrize("cell", ["attn.prefill-64k", "attn.train-16k",
                                  "proofs.hbm-1card"])
def test_short_run_is_correct(card, cell):
    spec = harness.RunSpec(cell=manifest.load_cell(cell), seed=SEEDS[0],
                           seconds=2.0, trace=False,
                           t_start=time.perf_counter())
    line = harness.result(spec, harness.run_ranks(spec), "card", None)
    assert line["correct"], line["checks"]
    assert all(v["value"] > 0 for v in line["metrics"].values())
