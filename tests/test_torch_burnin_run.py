"""The sharded burn-in on four gloo ranks (one spawn, body in
tests/torch_burnin_ranks.py), f32: a 2x2 TP+SP step equals world size 1,
FSDP+TP equals TP over 3 steps within JAX's own bound, a TP checkpoint
restores into the FSDP layout, the 2-slice training mesh steps and
resumes bit for bit, and the DCN probe is right on 2 fake slices x 2."""

import math

import numpy as np
import pytest
import torch

import torch_burnin_ranks as body
from tpu_operator_torch import convert
from tpu_operator_torch.parallel import mesh
from tpu_operator_torch.workloads import burnin

WORLD = 4
# a 2x2 TP+SP step sums in another order than one device; f32
TP_RTOL = 1e-5
# FSDP against TP, JAX's own bound (tests/test_workloads.py)
FSDP_RTOL = 2e-4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    ckdir = str(tmp_path_factory.mktemp("ckpt"))
    return mesh.spawn(body.rank_body, WORLD, "cpu", args=(ckdir,))


@pytest.fixture(scope="module")
def single():
    """World size 1, no process group: the same init and batches."""
    step, init_state, _ = burnin.make_train_step(None, body.CFG,
                                                 device="cpu")
    state = init_state(body.SEED)
    init = convert.burnin_params_to_jax(state.model, body.CFG)
    losses = []
    for seed in body.BATCH_SEEDS:
        state, loss = step(state, burnin.make_batch(body.CFG, None, seed,
                                                    device="cpu"))
        losses.append(float(loss))
    return init, losses, convert.burnin_params_to_jax(state.model, body.CFG)


def leaves(tree):
    out = {k: tree[k] for k in ("embed", "unembed", "final_norm")}
    for i, layer in enumerate(tree["layers"]):
        out.update({f"layers.{i}.{k}": v for k, v in layer.items()})
    return out


def test_tp_sp_step_equals_world_size_one(ranks, single):
    _, losses, params = single
    for r in ranks:
        assert r["tp_losses"] == pytest.approx(losses, rel=TP_RTOL)
    for name, w in leaves(params).items():
        np.testing.assert_allclose(leaves(ranks[0]["tp_params"])[name], w,
                                   rtol=0, atol=1e-5, err_msg=name)


def test_fsdp_equals_tp_over_three_steps(ranks):
    for r in ranks:
        assert r["fsdp_losses"] == pytest.approx(r["tp_losses"],
                                                 rel=FSDP_RTOL)
    fs, tp = leaves(ranks[0]["fsdp_params"]), leaves(ranks[0]["tp_params"])
    for name in tp:
        np.testing.assert_allclose(fs[name], tp[name], rtol=0, atol=1e-5,
                                   err_msg=name)


def test_every_parameter_moved(ranks, single):
    init = leaves(single[0])
    for key in ("tp_params", "fsdp_params"):
        for name, w in leaves(ranks[0][key]).items():
            assert np.abs(w - init[name]).max() > 1e-3, (key, name)


def test_fsdp_shards_parameters_and_moments_over_both_axes(ranks):
    tp, fs = ranks[0]["tp_placements"], ranks[0]["fsdp_placements"]
    # the sharded tensor dim over (model,) and (data, model); None:
    # replicated
    assert tp["layers.0.qkv"] == (1,)
    assert tp["layers.0.attn_out"] == (0,)
    assert tp["final_norm"] == (None,)
    # JAX's P(d, "model") / P("model", d)
    assert fs["layers.0.qkv"] == (0, 1)
    assert fs["layers.0.attn_out"] == (1, 0)
    assert fs["embed"] == (0, 1)
    assert fs["final_norm"] == (0, None)
    assert ranks[0]["fsdp_moment_placements"] == fs


def test_tp_checkpoint_restores_into_the_fsdp_layout(ranks):
    for r in ranks:
        assert r["restored_step"] == len(body.BATCH_SEEDS)
        assert r["restored_placements"] == r["fsdp_placements"]
        assert float(r["restored_next_loss"]) == pytest.approx(
            float(r["tp_next_loss"]), rel=FSDP_RTOL)


def test_two_slice_training_mesh_steps_and_resumes_bit_for_bit(ranks):
    # each model group (row) lies inside one slice of two ranks
    assert ranks[0]["training_mesh"] == [[0, 1], [2, 3]]
    assert ranks[0]["env_mesh"] == {"data": 2, "model": 2}
    for r in ranks:
        hyb = r["hybrid"]
        assert hyb["hybrid"] == {"dcn": 2, "data": 2, "model": 1}
        assert hyb["training"] == {"data": 4, "model": 1}
        assert math.isfinite(hyb["loss"]) and hyb["resume_bitexact"]
        assert hyb["resumed_step"] == 2


def test_dcn_probe_is_right_on_two_fake_slices(ranks):
    for r in ranks:
        probe = r["probe"]
        assert probe.correct and probe.slices == 2
        assert probe.devices_per_slice == 2 and probe.device_kind == "cpu"
        assert probe.bus_bw_gbps > 0 and probe.seconds > 0
        assert probe.bytes_per_device == int(0.01 * 1e6 / 4) * 4
    # one node: every rank on slice 0
    assert ranks[0]["node_ids"] == [0] * WORLD


def test_loss_is_reported_alike_on_every_rank(ranks):
    assert len({tuple(r["tp_losses"]) for r in ranks}) == 1
    assert all(isinstance(r["tp_next_loss"], torch.Tensor) for r in ranks)
