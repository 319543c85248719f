"""The port's multi-card dry run on four gloo ranks (one spawn): the
TP+SP step and the FSDP step that reproduces it, the conv burn-in's
channel-parallel step, ring attention, the pipeline and the MoE held to
their oracles, and the two-slice stage (hybrid and training meshes, a
step, a bit-exact resume, the DCN probe): every stage of the JAX dry
run."""

import math

import pytest

from tpu_operator_torch import dryrun


@pytest.fixture(scope="module")
def summary():
    return dryrun.dryrun_multichip(4, "cpu")


def test_training_steps(summary):
    assert summary["mesh"] == {"data": 2, "model": 2}
    assert math.isfinite(summary["loss"]) and summary["step"] == 1
    assert summary["fsdp_loss"] == pytest.approx(summary["loss"], rel=5e-4)


def test_ring_attention_matches_the_oracle(summary):
    # f32 on the CPU: the harness's 1e-4
    assert summary["ring_attention_err"] < 1e-4


def test_two_slice_stage(summary):
    hyb = summary["hybrid"]
    assert hyb["hybrid"] == {"dcn": 2, "data": 2, "model": 1}
    assert hyb["training"]["model"] <= 2
    assert hyb["resume_bitexact"] and hyb["resumed_step"] == 2
    assert math.isfinite(hyb["loss"]) and hyb["dcn_probe_bus_gbps"] > 0


def test_unported_stages_are_named_not_passed(summary):
    # every stage of the JAX dry run is ported: none is named unported
    assert "not_ported" not in summary


@pytest.mark.parametrize("stage", ["conv", "pipeline", "moe"])
def test_jax_stages_ran_and_passed(summary, stage):
    if stage == "conv":
        assert math.isfinite(summary["conv_loss"])
    else:  # one stage / expert a rank, f32 on the CPU: the harness's 1e-4
        count = "stages" if stage == "pipeline" else "experts"
        assert summary[f"{stage}_{count}"] == 4
        assert summary[f"{stage}_err"] < 1e-4


@pytest.mark.parametrize("corrupt", [None, "exp_avg", "exp_avg_sq", "step"])
def test_resume_check_holds_every_restored_tensor(corrupt, monkeypatch,
                                                  tmp_path):
    """One process, no mesh: an intact restore passes with its timings;
    a restore that loses one AdamW moment or step count of one parameter
    is caught, although the next loss depends on the parameters alone."""
    cfg = dryrun.burnin.BurninConfig(vocab=32, d_model=16, n_heads=2,
                                     n_layers=1, d_ff=32, seq_len=8, batch=2,
                                     dtype=dryrun.torch.float32)
    step, init_state, _ = dryrun.burnin.make_train_step(None, cfg,
                                                        device="cpu")
    state, _ = step(init_state(0), dryrun.burnin.make_batch(cfg, None, 0,
                                                            device="cpu"))
    if corrupt is not None:
        restore = dryrun.TrainCheckpointer.restore

        def lossy_restore(self, state_like, step=None):
            out = restore(self, state_like, step)
            p = next(out.model.parameters())
            out.optimizer.state[p][corrupt].add_(1.0)
            return out

        monkeypatch.setattr(dryrun.TrainCheckpointer, "restore",
                            lossy_restore)
    batch = dryrun.burnin.make_batch(cfg, None, 1, device="cpu")
    if corrupt is None:
        got = dryrun.resume_matches(step, init_state, state, batch,
                                    str(tmp_path))
        assert got["resumed_step"] == 2 and math.isfinite(got["loss"])
        # every parameter, then its exp_avg, exp_avg_sq and step
        assert got["tensors_restored"] == 4 * 9
        assert got["save_s"] > 0 and got["restore_s"] > 0
    else:
        with pytest.raises(AssertionError, match="optimizer state differ"):
            dryrun.resume_matches(step, init_state, state, batch,
                                  str(tmp_path))


def test_too_few_cards_is_refused_before_any_rank_starts(monkeypatch):
    monkeypatch.setattr(dryrun, "resolve_device", lambda d: None)
    monkeypatch.setattr(dryrun.torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="need 4 cards, have 2"):
        dryrun.dryrun_multichip(4, "cuda")
