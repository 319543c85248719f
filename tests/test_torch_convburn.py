"""The conv burn-in of the port (tpu_operator_torch.workloads.convburn)
against the JAX package's, on the CPU: JAX's parameters carried across
(``convert.conv_params_from_jax``, HWIO filters to OIHW) give the same
logits and loss, and one AdamW step the same loss and parameters, in f32
within 1e-5; bf16 logits within the burn-in's 2**-4. One spawn of four
gloo ranks (body in tests/torch_parallel_ranks.py): the channel-parallel
2x2 [data, model] step equals world size 1 within 1e-5 in f32, and
``run()``'s body makes the loss fall. At JAX's own test configuration,
JAX's init and JAX's eight batches carried into the port's train step
give JAX's eight losses."""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

import torch_parallel_ranks as body
from tpu_operator.workloads import convburn as jax_conv
from tpu_operator_torch import convert
from tpu_operator_torch.parallel import mesh
from tpu_operator_torch.workloads import burnin, convburn

SMALL = dict(image_size=8, width=8, n_blocks=2, n_classes=8, batch=4)
CFG32 = convburn.ConvBurninConfig(**SMALL, dtype=torch.float32)
JAX32 = jax_conv.ConvBurninConfig(**SMALL, dtype=jnp.float32)
CFG16 = convburn.ConvBurninConfig(**SMALL)
JAX16 = jax_conv.ConvBurninConfig(**SMALL)
# f32: the two frameworks sum in other orders, nothing else differs
F32_RTOL = 1e-5
# bf16: the burn-in's bound (tests/test_torch_burnin.py): XLA keeps fused
# elementwise chains in f32 where torch rounds each op to bf16
BF16_LOGITS_ATOL = 2.0 ** -4
# the 2x2 step against world size 1, f32
TP_ATOL = 1e-5
# JAX's test configuration (tests/test_workloads.py, TestConvBurnin), f32
JAX_TEST = dict(image_size=16, width=16, n_blocks=2, n_classes=8, batch=8)
JAX_TEST_STEPS = 8


def jax_params(cfg, seed=0):
    return jax.tree.map(np.asarray,
                        jax_conv.init_params(cfg, jax.random.PRNGKey(seed)))


def batch_np(cfg, seed=1):
    """NHWC images for JAX, int labels."""
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((cfg.batch, cfg.image_size, cfg.image_size,
                                  cfg.in_channels), dtype=np.float32)
    labels = rng.integers(0, cfg.n_classes, cfg.batch, dtype=np.int32)
    return {"images": images, "labels": labels}


def torch_batch(batch):
    return {"images": torch.from_numpy(
                np.ascontiguousarray(batch["images"].transpose(0, 3, 1, 2))),
            "labels": torch.from_numpy(batch["labels"].astype(np.int64))}


@pytest.fixture(scope="module", autouse=True)
def spawned():
    """The four gloo ranks, started before the first test so that they
    run while JAX compiles the single-process tests' side."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield pool.submit(mesh.spawn, body.conv_body, body.WORLD, "cpu",
                          timeout_s=120)


@pytest.fixture
def ranks(spawned):
    return spawned.result()


@pytest.mark.parametrize("cfg, jcfg", [(CFG32, JAX32), (CFG16, JAX16)],
                         ids=["f32", "bf16"])
def test_forward_and_loss_match_jax(cfg, jcfg):
    params, batch = jax_params(jcfg), batch_np(jcfg)
    want_logits = np.asarray(jax.jit(jax_conv.forward, static_argnums=2)(
        params, batch["images"], jcfg))
    want_loss = float(jax.jit(jax_conv.loss_fn, static_argnums=2)(
        params, batch, jcfg))
    tparams = convert.conv_params_from_jax(params, "cpu")
    tb = torch_batch(batch)
    with torch.no_grad():
        logits = convburn.forward(tparams, tb["images"], cfg).numpy()
        loss = float(convburn.loss_fn(tparams, tb, cfg))
    assert logits.dtype == np.float32 and logits.shape == want_logits.shape
    if cfg.dtype == torch.float32:
        np.testing.assert_allclose(logits, want_logits, rtol=F32_RTOL,
                                   atol=F32_RTOL * np.abs(want_logits).max())
        assert loss == pytest.approx(want_loss, rel=F32_RTOL)
    else:
        np.testing.assert_allclose(logits, want_logits, rtol=0,
                                   atol=BF16_LOGITS_ATOL)


def test_one_adamw_step_matches_jax():
    """optax.adamw on JAX's side, ``burnin.adamw`` (optax's defaults) in
    the port's train step: the loss and every updated parameter agree."""
    params, batch = jax_params(JAX32), batch_np(JAX32)
    opt = optax.adamw(JAX32.learning_rate)

    @jax.jit
    def jstep(p):
        loss, grads = jax.value_and_grad(jax_conv.loss_fn)(p, batch, JAX32)
        updates, _ = opt.update(grads, opt.init(p), p)
        return optax.apply_updates(p, updates), loss

    want_params, want_loss = jstep(params)
    step, _ = convburn.make_train_step(None, CFG32, device="cpu")
    tparams = convert.conv_params_from_jax(params, "cpu")
    leaves = convburn.leaves(tparams)
    for p in leaves:
        p.requires_grad_(True)
    state = convburn.ConvTrainState(
        tparams, burnin.adamw(CFG32.learning_rate)(leaves))
    state, loss = step(state, torch_batch(batch))
    assert state.step == 1
    assert float(loss) == pytest.approx(float(want_loss), rel=F32_RTOL)
    got = convert.conv_params_to_jax(state.params)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want_params),
                            jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=F32_RTOL,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.fixture(scope="module")
def eight_losses():
    """JAX's ``run()`` body on a 1x1 mesh at its test configuration in
    f32: ``init_params(PRNGKey(0))`` and ``make_batch`` on
    ``fold_in(PRNGKey(0), i)``; the same init and batches (NHWC -> NCHW)
    through the port's train step. Returns (JAX's losses, the port's)."""
    jcfg = jax_conv.ConvBurninConfig(**JAX_TEST, dtype=jnp.float32)
    cfg = convburn.ConvBurninConfig(**JAX_TEST, dtype=torch.float32)
    jmesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jstep, jinit = jax_conv.make_train_step(jmesh, jcfg)
    key = jax.random.PRNGKey(0)
    params = jax.tree.map(np.asarray, jax_conv.init_params(jcfg, key))
    jstate = jinit(key)
    batches, want = [], []
    for i in range(JAX_TEST_STEPS):
        b = jax_conv.make_batch(jcfg, jmesh, jax.random.fold_in(key, i))
        batches.append({k: np.asarray(v) for k, v in b.items()})
        jstate, loss = jstep(jstate, b)
        want.append(float(loss))
    step, _ = convburn.make_train_step(None, cfg, device="cpu")
    tparams = convert.conv_params_from_jax(params, "cpu")
    tleaves = convburn.leaves(tparams)
    for p in tleaves:
        p.requires_grad_(True)
    state = convburn.ConvTrainState(
        tparams, burnin.adamw(cfg.learning_rate)(tleaves))
    got = []
    for b in batches:
        state, loss = step(state, torch_batch(b))
        got.append(float(loss))
    return want, got


@pytest.mark.parametrize("i", range(JAX_TEST_STEPS))
def test_eight_losses_match_jax_at_its_test_config(eight_losses, i):
    """With JAX's init and draws the port's losses are JAX's, step by
    step (so the port's own draws, not its step, made its loss rise
    at this size)."""
    want, got = eight_losses
    assert got[i] == pytest.approx(want[i], rel=F32_RTOL)


def test_params_round_trip_through_convert():
    params = jax_params(JAX32)
    back = convert.conv_params_to_jax(convert.conv_params_from_jax(params,
                                                                   "cpu"))
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)


def test_init_params_follows_the_jax_init():
    got = convert.conv_params_to_jax(convburn.init_params(CFG32, 3, "cpu"))
    again = convert.conv_params_to_jax(convburn.init_params(CFG32, 3, "cpu"))
    ref = jax_params(JAX32)
    for (path, w), g, h in zip(jax.tree_util.tree_leaves_with_path(ref),
                               jax.tree_util.tree_leaves(got),
                               jax.tree_util.tree_leaves(again)):
        name = jax.tree_util.keystr(path)
        np.testing.assert_array_equal(g, h, err_msg=name)
        assert g.shape == w.shape and g.dtype == np.float32, name
        # the same scale: std within 25% of JAX's draw's (the stem has
        # only 216 draws)
        assert np.std(g) == pytest.approx(np.std(w), rel=0.25, abs=1e-6), name


def test_param_specs_are_the_jax_placements():
    """JAX's HWIO dim on "model", moved to OIHW, is the port's dim."""
    oihw = {0: 2, 1: 3, 2: 1, 3: 0}  # HWIO dim -> OIHW dim
    jspecs, specs = jax_conv.param_specs(JAX32), convburn.param_specs(CFG32)

    def model_dim(spec, conv):
        dims = [i for i, a in enumerate(tuple(spec)) if a == "model"]
        return (oihw[dims[0]] if conv else dims[0]) if dims else None

    assert specs["stem"] == model_dim(jspecs["stem"], True)
    assert specs["head"] == model_dim(jspecs["head"], False)
    for jb, b in zip(jspecs["blocks"], specs["blocks"]):
        assert set(jb) == set(b)
        for k in jb:
            assert b[k] == model_dim(jb[k], k.startswith("conv")), k


def test_two_by_two_step_equals_world_size_one(ranks):
    losses, params = body.conv_single()
    for r in ranks:
        assert r["mesh"] == {"data": 2, "model": 2}
        np.testing.assert_allclose(r["losses"], losses, rtol=0, atol=TP_ATOL)
        for i, (g, w) in enumerate(zip(r["params"], params)):
            np.testing.assert_allclose(g, w, rtol=0, atol=TP_ATOL,
                                       err_msg=f"leaf {i}")


def test_shards_follow_param_specs(ranks):
    # stem, head, then conv1, conv2, scale1, scale2 per block; width 8
    # and 8 classes over a model axis of 2
    w, c = body.CONV_CFG.width, body.CONV_CFG.in_channels
    want = {0: (w, c, 3, 3), 1: (w, body.CONV_CFG.n_classes // 2)}
    for b in range(body.CONV_CFG.n_blocks):
        want.update({2 + 4 * b: (w // 2, w, 3, 3), 3 + 4 * b: (w, w // 2, 3, 3),
                     4 + 4 * b: (w // 2,), 5 + 4 * b: (w,)})
    for r in ranks:
        assert r["local_shapes"] == want


def test_run_body_loss_falls(ranks):
    first, last = ranks[0]["run"]
    assert np.isfinite(first) and last < first
    assert all(r["run"] == (first, last) for r in ranks)


def test_run_spawns_or_joins(monkeypatch):
    calls = []

    def fake(fn, world_size, device_type, args=()):
        calls.append((fn, world_size, device_type, args))
        return [(2.0, 1.0)] * world_size

    monkeypatch.setattr(convburn.multihost.mesh, "spawn", fake)
    for k in ("MASTER_ADDR", "GPU_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(k, raising=False)
    cfg = dataclasses.replace(CFG32, batch=8)
    assert convburn.run(cfg, steps=3, model_parallel=2, device="cpu",
                        world_size=4) == (2.0, 1.0)
    assert calls == [(convburn.convburn_rank, 4, "cpu", (cfg, 3, 2))]
