"""Checkpoint/resume of the port (DCP-backed ``TrainCheckpointer``) in one
process, mirroring tests/test_checkpoint.py: round trip, a missing or
torn latest step, retention, the manifest, and an interrupted burn-in
that resumes to the same result. Resharding across layouts runs on four
ranks in tests/test_torch_burnin_run.py."""

import math
import os
import shutil

import pytest
import torch

from tpu_operator_torch.workloads import burnin
from tpu_operator_torch.workloads.checkpoint import TrainCheckpointer

CFG = burnin.BurninConfig(vocab=64, d_model=32, n_heads=2, n_layers=1,
                          d_ff=64, seq_len=16, batch=8, dtype=torch.float32)


def small_state(seed=0):
    step, init_state, _ = burnin.make_train_step(None, CFG, device="cpu")
    return step, init_state(seed)


def batch(seed):
    return burnin.make_batch(CFG, None, seed, device="cpu")


def tear(path):
    """Empty a step directory but keep it enumerable — the torn shape a
    mid-write crash leaves behind."""
    for entry in os.listdir(path):
        p = path / entry
        shutil.rmtree(p) if p.is_dir() else os.remove(p)


def test_roundtrip_restores_params_moments_and_step(tmp_path):
    step, state = small_state()
    state, _ = step(state, batch(1))
    ckpt = TrainCheckpointer(str(tmp_path))
    ckpt.save(state, 1)
    assert ckpt.latest_step() == 1 and ckpt.all_steps() == [1]
    _, fresh = small_state(seed=7)
    restored = ckpt.restore(fresh)
    ckpt.close()
    assert restored is fresh and restored.step == 1
    for (name, p), q in zip(state.model.named_parameters(),
                            restored.model.parameters()):
        assert torch.equal(p, q), name
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(state.optimizer.state[p][key],
                               restored.optimizer.state[q][key]), (name, key)


def test_restore_without_checkpoint_raises(tmp_path):
    ckpt = TrainCheckpointer(str(tmp_path))
    _, state = small_state()
    with pytest.raises(FileNotFoundError):
        ckpt.restore(state)


def test_restore_skips_corrupt_latest_and_counts_fallback(tmp_path):
    step, state = small_state()
    ckpt = TrainCheckpointer(str(tmp_path), max_to_keep=3)
    state, _ = step(state, batch(1))
    ckpt.save(state, 1)
    good_embed = state.model.embed.detach().clone()
    state, _ = step(state, batch(2))
    ckpt.save(state, 2)
    assert ckpt.all_steps() == [1, 2]
    tear(tmp_path / "2")
    assert ckpt.all_steps() == [1, 2]
    _, fresh = small_state(seed=5)
    restored = ckpt.restore(fresh)
    assert ckpt.restore_fallbacks == 1
    assert restored.step == 1
    assert torch.equal(restored.model.embed, good_embed)
    # an explicit step raises: the caller asked for that step
    with pytest.raises(Exception):
        ckpt.restore(small_state()[1], step=2)
    assert ckpt.restore_fallbacks == 1


def test_restore_raises_when_every_step_is_corrupt(tmp_path):
    _, state = small_state()
    ckpt = TrainCheckpointer(str(tmp_path))
    ckpt.save(state, 1)
    tear(tmp_path / "1")
    with pytest.raises(FileNotFoundError, match="no restorable"):
        ckpt.restore(state)
    # a single candidate is no fallback
    assert ckpt.restore_fallbacks == 0


def test_partial_save_is_never_enumerated(tmp_path):
    ckpt = TrainCheckpointer(str(tmp_path))
    _, state = small_state()
    ckpt.save(state, 1)
    # a save cut before its commit leaves only the temporary directory
    (tmp_path / ".tmp-2").mkdir()
    assert ckpt.all_steps() == [1] and ckpt.latest_step() == 1


def test_keeps_the_newest_three_steps(tmp_path):
    step, state = small_state()
    ckpt = TrainCheckpointer(str(tmp_path))
    for i in range(1, 6):
        state, _ = step(state, batch(i))
        ckpt.save(state, i)
    assert ckpt.all_steps() == [3, 4, 5]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["3", "4", "5"]
    assert ckpt.restore(small_state()[1]).step == 5


def test_manifest_round_trip_and_unreadable_manifest(tmp_path):
    ckpt = TrainCheckpointer(str(tmp_path))
    _, state = small_state()
    ckpt.save(state, 1)
    lay = {"hosts": ["h0", "h1"], "shards": {"0": "h0", "1": "h1"}}
    ckpt.save_manifest(1, lay)
    assert ckpt.read_manifest(1) == lay
    assert ckpt.read_manifest(2) is None
    assert not list(tmp_path.glob(".manifest-*.tmp"))
    (tmp_path / "manifest-1.json").write_text("{not json")
    assert ckpt.read_manifest(1) is None


def test_interrupted_run_resumes_to_the_same_result(tmp_path):
    # uninterrupted 4 steps vs 2 steps + resume: the same final loss, and
    # `first` spans the WHOLE run (sidecar), not the resumed tail
    cpu = torch.device("cpu")
    first_a, last_a = burnin.burnin_rank(0, 1, cpu, CFG, 4)
    d = str(tmp_path / "ck")
    first_0, _ = burnin.burnin_rank(0, 1, cpu, CFG, 2, checkpoint_dir=d,
                                    checkpoint_every=1)
    first_b, last_b = burnin.burnin_rank(0, 1, cpu, CFG, 4, checkpoint_dir=d,
                                         checkpoint_every=1)
    assert last_b == last_a
    assert first_b == first_0 == first_a
    assert TrainCheckpointer(d).all_steps() == [2, 3, 4]


def test_rerun_past_target_returns_current_loss(tmp_path):
    # a retry after the final save must not return (None, None)
    cpu = torch.device("cpu")
    d = str(tmp_path / "ck")
    first_a, _ = burnin.burnin_rank(0, 1, cpu, CFG, 2, checkpoint_dir=d,
                                    checkpoint_every=1)
    first_b, last_b = burnin.burnin_rank(0, 1, cpu, CFG, 2, checkpoint_dir=d,
                                         checkpoint_every=1)
    assert first_b == first_a
    assert last_b is not None and math.isfinite(last_b)
