"""Per-rank bodies of tests/test_torch_pipeline.py, test_torch_moe.py and
test_torch_convburn.py, in a module of its own that imports no JAX, so the
spawned gloo ranks start quickly. Inputs arrive as numpy arrays (JAX's
parameters and inputs); results go back as numpy."""

import numpy as np
import torch

from tpu_operator_torch import convert
from tpu_operator_torch.parallel.mesh import build_mesh
from tpu_operator_torch.workloads import convburn, moe, pipeline

WORLD = 4

# pipeline: name -> (batch, n_microbatches); seq 8, d_model 16, d_ff 32
PIPELINE_CASES = {"m4": (8, 4), "m2_bubbles": (8, 2), "m8": (8, 8)}
PIPELINE_DIMS = dict(seq=8, d_model=16, d_ff=32)
# MoE: name -> (tokens per rank, capacity); d_model 16, d_ff 32
MOE_CASES = {"full_capacity": (8, 8), "capacity_2": (12, 2)}
MOE_DIMS = dict(d_model=16, d_ff=32)
# the conv burn-in at f32 on a [data 2, model 2] mesh
CONV_CFG = convburn.ConvBurninConfig(image_size=8, width=8, n_blocks=2,
                                     n_classes=8, batch=8,
                                     dtype=torch.float32)
CONV_STEPS = 3
# run()'s body at run()'s defaults: ConvBurninConfig(), 5 steps
CONV_RUN_CFG = convburn.ConvBurninConfig()


def pipeline_body(rank, world_size, device, params, inputs, grad_x):
    """Each case's output (the same on every rank), then the gradients of
    sum(out**2) for this rank's stage, then ``run()``'s body."""
    mine = convert.pipeline_params_from_jax(params, rank, "cpu")
    res = {}
    for name, (batch, m) in PIPELINE_CASES.items():
        x = torch.from_numpy(inputs[name])
        res[name] = pipeline.pipeline_forward(mine, x,
                                              n_microbatches=m).numpy()
    leaves = {k: v.requires_grad_() for k, v in mine.items()}
    out = pipeline.pipeline_forward(leaves, torch.from_numpy(grad_x),
                                    n_microbatches=4)
    (out ** 2).sum().backward()
    res["grads"] = {k: v.grad.numpy() for k, v in leaves.items()}
    res["run_body"] = pipeline.pipeline_rank(rank, world_size, device, {})
    return res


def moe_body(rank, world_size, device, params, inputs, grad_x):
    """Each case's output rows of this rank, the gradients of the summed
    sum(out**2) for the router and this rank's expert, then ``run()``'s
    body."""
    res = {}
    for name, (b_local, cap) in MOE_CASES.items():
        mine = convert.moe_params_from_jax(params, rank, "cpu")
        x = torch.from_numpy(inputs[name][rank * b_local:(rank + 1) * b_local])
        res[name] = moe.moe_forward(mine, x, capacity=cap).numpy()
    leaves = {k: v.requires_grad_()
              for k, v in convert.moe_params_from_jax(params, rank,
                                                      "cpu").items()}
    b = grad_x.shape[0] // world_size
    x = torch.from_numpy(grad_x[rank * b:(rank + 1) * b])
    (moe.moe_forward(leaves, x, capacity=b) ** 2).sum().backward()
    res["grads"] = {k: v.grad.numpy() for k, v in leaves.items()}
    res["run_body"] = moe.moe_rank(rank, world_size, device, {})
    return res


def conv_body(rank, world_size, device):
    """``CONV_STEPS`` f32 steps on a [data 2, model 2] mesh from the port's
    own init: the losses and the whole parameters after; then
    ``run()``'s body on the training mesh."""
    mesh = build_mesh(model_parallel=2)
    step, init_state = convburn.make_train_step(mesh, CONV_CFG)
    state = init_state(0)
    shapes = {i: tuple(t.shape) for i, t in
              enumerate(convburn.leaves(state.params))}
    losses = []
    for seed in range(CONV_STEPS):
        state, loss = step(state, convburn.make_batch(CONV_CFG, mesh, seed))
        losses.append(float(loss))
    full = convburn.full_params(state.params, mesh, CONV_CFG)
    run = convburn.convburn_rank(rank, world_size, device, CONV_RUN_CFG,
                                 steps=5)
    return {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "local_shapes": shapes, "losses": losses,
            "params": [t.numpy() for t in convburn.leaves(full)],
            "run": run}


def conv_single():
    """The same steps at world size 1 (no process group)."""
    step, init_state = convburn.make_train_step(None, CONV_CFG, device="cpu")
    state = init_state(0)
    losses = []
    for seed in range(CONV_STEPS):
        state, loss = step(state, convburn.make_batch(CONV_CFG, None, seed,
                                                      device="cpu"))
        losses.append(float(loss))
    return losses, [t.detach().numpy().copy()
                    for t in convburn.leaves(state.params)]


def seeded(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape,
                                                       dtype=np.float32)
