"""The burn-in transformer of the port against the JAX package's, on the
CPU: JAX's parameters carried across (``convert.burnin_params_from_jax``)
give the same logits and loss, and one AdamW step the same loss and
parameters; ``run()`` on gloo makes the loss fall."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from tpu_operator.parallel.mesh import build_mesh
from tpu_operator.workloads import burnin as jax_burnin
from tpu_operator_torch import convert
from tpu_operator_torch.workloads import burnin

SMALL = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
             seq_len=16, batch=4)
CFG32 = burnin.BurninConfig(**SMALL, dtype=torch.float32)
JAX32 = jax_burnin.BurninConfig(**SMALL, dtype=jnp.float32)
CFG16 = burnin.BurninConfig(**SMALL)
JAX16 = jax_burnin.BurninConfig(**SMALL)
# f32: the two frameworks sum in other orders, nothing else differs
F32_RTOL = 1e-5
# bf16: both round at the places the JAX code casts (the embedding, the
# 1/sqrt(head_dim) and the mask value in bf16, RMSNorm's bf16 products),
# but XLA keeps fused elementwise chains in f32 where torch rounds each op
# to bf16 (unit roundoff 2**-8). Over two blocks the logits, |logit| up to
# ~4.4, move by up to two bf16 steps of their magnitude (0.031 measured)
# and by 0.0066 of their norm: held to 2**-4 each and 2**-6 of the norm
# (four unit roundoffs). The loss, a mean over 64 positions, moved 7e-5
# relative; held to 1e-3
BF16_LOGITS_ATOL = 2.0 ** -4
BF16_LOGITS_NORM_RTOL = 2.0 ** -6
BF16_LOSS_RTOL = 1e-3


def jax_params(cfg, seed=0):
    return jax.tree.map(np.asarray,
                        jax_burnin.init_params(cfg, jax.random.PRNGKey(seed)))


def tokens(cfg, seed=1):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, cfg.vocab, (cfg.batch, cfg.seq_len), dtype=np.int32)
    return {"tokens": t, "targets": np.roll(t, -1, axis=1)}


def torch_batch(batch):
    return {k: torch.from_numpy(v.astype(np.int64)) for k, v in batch.items()}


@pytest.mark.parametrize("cfg, jcfg", [(CFG32, JAX32), (CFG16, JAX16)],
                         ids=["f32", "bf16"])
def test_forward_and_loss_match_jax(cfg, jcfg):
    params = jax_params(jcfg)
    batch = tokens(jcfg)
    # jitted: one compile, where eager JAX compiles each op on first use
    want_logits = np.asarray(jax.jit(jax_burnin.forward, static_argnums=2)(
        params, batch["tokens"], jcfg))
    want_loss = float(jax.jit(jax_burnin.loss_fn, static_argnums=2)(
        params, batch, jcfg))
    model = convert.burnin_params_from_jax(params, cfg, device="cpu")
    tb = torch_batch(batch)
    with torch.no_grad():
        logits = burnin.forward(model, tb["tokens"]).numpy()
        loss = float(burnin.loss_fn(model, tb))
    assert logits.dtype == np.float32 and logits.shape == want_logits.shape
    if cfg.dtype == torch.float32:
        np.testing.assert_allclose(logits, want_logits, rtol=F32_RTOL,
                                   atol=F32_RTOL * np.abs(want_logits).max())
        assert loss == pytest.approx(want_loss, rel=F32_RTOL)
    else:
        np.testing.assert_allclose(logits, want_logits, rtol=0,
                                   atol=BF16_LOGITS_ATOL)
        assert np.linalg.norm(logits - want_logits) <= \
            BF16_LOGITS_NORM_RTOL * np.linalg.norm(want_logits)
        assert loss == pytest.approx(want_loss, rel=BF16_LOSS_RTOL)


def test_attention_scale_and_mask_round_as_jax_does():
    # sqrt(32) in bf16 is 5.65625, and -1e9 in bf16 is -998244352
    assert torch.tensor(32.0, dtype=torch.bfloat16).sqrt().item() == 5.65625
    assert float(jnp.sqrt(jnp.array(32, jnp.bfloat16))) == 5.65625
    masked = torch.where(torch.tensor([False]),
                         torch.zeros(1, dtype=torch.bfloat16),
                         burnin.MASK_VALUE)
    assert masked.item() == -998244352.0
    assert float(jnp.where(False, jnp.zeros((), jnp.bfloat16), -1e9)) \
        == -998244352.0


def test_one_adamw_step_matches_jax():
    """One step at world size 1 against JAX's make_train_step on a
    1-device mesh: the same loss, and parameters within 1e-5 — which pins
    optax's weight decay of 1e-4 (torch's default 0.01 moves each weight
    by lr * 0.01 * w, far past it)."""
    mesh = build_mesh(devices=jax.devices()[:1])
    jstep, jinit, _ = jax_burnin.make_train_step(mesh, JAX32)
    state = jinit(jax.random.PRNGKey(0))
    before = jax.tree.map(np.asarray, state["params"])
    batch = tokens(JAX32)
    jbatch = {k: jax.device_put(v, NamedSharding(mesh, P("data", None)))
              for k, v in batch.items()}
    state, jloss = jstep(state, jbatch)
    after = jax.tree.map(np.asarray, state["params"])

    step, _, shard_batch = burnin.make_train_step(None, CFG32, device="cpu")
    model = convert.burnin_params_from_jax(before, CFG32, device="cpu")
    tstate = burnin.TrainState(model, burnin.adamw(CFG32.learning_rate)(
        model.parameters()))
    tstate, loss = step(tstate, shard_batch(torch_batch(batch)))
    assert tstate.step == 1
    assert float(loss) == pytest.approx(float(jloss), rel=F32_RTOL)
    got = convert.burnin_params_to_jax(tstate.model, CFG32)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(after),
                            jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))
    # and every parameter moved by about the learning rate
    for w0, w1 in zip(jax.tree_util.tree_leaves(before),
                      jax.tree_util.tree_leaves(got)):
        assert np.abs(w1 - w0).max() > 0.5 * CFG32.learning_rate


def test_converter_round_trips_and_groups_qkv_by_head():
    params = jax_params(JAX32)
    model = convert.burnin_params_from_jax(params, CFG32, device="cpu")
    back = convert.burnin_params_to_jax(model, CFG32)
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)
    # the port's first head_dim columns are JAX's q of head 0, the next
    # ones its k of head 0
    d, hd = CFG32.d_model, CFG32.head_dim
    w = params["layers"][0]["qkv"]
    port = model.layers[0].qkv.detach().numpy()
    np.testing.assert_array_equal(port[:, :hd], w[:, :hd])
    np.testing.assert_array_equal(port[:, hd:2 * hd], w[:, d:d + hd])


def test_init_params_follows_the_jax_init():
    model = burnin.init_params(CFG32, seed=3, device="cpu")
    again = burnin.init_params(CFG32, seed=3, device="cpu")
    ref = jax_params(JAX32)
    for (name, p), q in zip(model.named_parameters(), again.parameters()):
        assert torch.equal(p, q), name
    got = convert.burnin_params_to_jax(model, CFG32)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(ref),
                            jax.tree_util.tree_leaves(got)):
        assert g.shape == w.shape and g.dtype == np.float32
        # the same scale: std within 15% of JAX's draw's
        assert np.std(g) == pytest.approx(np.std(w), rel=0.15, abs=1e-6), \
            jax.tree_util.keystr(path)


def test_param_specs_are_jax_layouts_as_placements():
    from torch.distributed.tensor import Replicate, Shard

    jspecs = jax_burnin.param_specs(JAX32, fsdp=True)
    specs = burnin.param_specs(CFG32, fsdp=True)

    def placement(spec, axis):
        dims = [i for i, a in enumerate(tuple(spec)) if a == axis]
        return Shard(dims[0]) if dims else Replicate()

    flat = {k: jspecs[k] for k in ("embed", "unembed", "final_norm")}
    for i, layer in enumerate(jspecs["layers"]):
        flat.update({f"layers.{i}.{k}": v for k, v in layer.items()})
    assert set(specs) == set(flat)
    for name, spec in flat.items():
        assert specs[name] == (placement(spec, "data"),
                               placement(spec, "model")), name
    tp_only = burnin.param_specs(CFG32)
    assert all(d == Replicate() for d, _ in tp_only.values())


def test_make_batch_rows_are_the_global_batch():
    b = burnin.make_batch(CFG32, None, seed=5, device="cpu")
    g = burnin.global_batch(CFG32, 5)
    assert torch.equal(b["tokens"], g["tokens"])
    assert torch.equal(b["targets"], torch.roll(g["tokens"], -1, dims=1))
    assert int(b["tokens"].max()) < CFG32.vocab


def test_run_on_the_cpu_makes_the_loss_fall():
    cfg = dataclasses.replace(CFG32, batch=8)
    first, last = burnin.run(cfg, steps=8, device="cpu", world_size=2)
    assert np.isfinite(first) and np.isfinite(last)
    assert last < first


@pytest.mark.parametrize("torchrun_env", [{}, {"MASTER_ADDR": "127.0.0.1"}],
                         ids=["alone", "under-torchrun"])
def test_run_without_a_device_needs_cuda(monkeypatch, torchrun_env):
    # refused before any group is joined, under torchrun's env too
    for k in ("MASTER_ADDR", "GPU_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(k, raising=False)
    for k, v in torchrun_env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        burnin.run(CFG32, steps=1)
