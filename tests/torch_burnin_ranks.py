"""Per-rank body of tests/test_torch_burnin_run.py, in a module of its own
that imports no JAX, so the spawned gloo ranks start quickly."""

import dataclasses

import torch

from tpu_operator_torch import convert, dryrun
from tpu_operator_torch.parallel import multihost
from tpu_operator_torch.parallel.mesh import build_mesh
from tpu_operator_torch.workloads import burnin
from tpu_operator_torch.workloads.checkpoint import TrainCheckpointer

CFG = burnin.BurninConfig(vocab=64, d_model=32, n_heads=2, n_layers=1,
                          d_ff=64, seq_len=16, batch=8, dtype=torch.float32)
SEED = 0
BATCH_SEEDS = (1, 2, 3)


def dims(placements):
    """Each mesh dim's sharded tensor dim, None where replicated."""
    return tuple(p.dim if p.is_shard() else None for p in placements)


def placements(model):
    return {n: dims(q.placements) for n, q in model.named_parameters()}


def rank_body(rank, world_size, device, ckdir):
    res = {}
    mesh = build_mesh(model_parallel=2)            # [data 2, model 2]
    step, init_state, _ = burnin.make_train_step(mesh, CFG)
    fstep, finit, _ = burnin.make_train_step(mesh, CFG, fsdp=True)
    tp, fs = init_state(SEED), finit(SEED)
    res["tp_placements"] = placements(tp.model)
    res["fsdp_placements"] = placements(fs.model)
    res["tp_losses"], res["fsdp_losses"] = [], []
    for seed in BATCH_SEEDS:
        batch = burnin.make_batch(CFG, mesh, seed)
        tp, loss = step(tp, batch)
        fs, floss = fstep(fs, batch)
        res["tp_losses"].append(float(loss))
        res["fsdp_losses"].append(float(floss))
    res["fsdp_moment_placements"] = {
        n: dims(fs.optimizer.state[q]["exp_avg"].placements)
        for n, q in fs.model.named_parameters()}
    res["tp_params"] = convert.burnin_params_to_jax(tp.model, CFG)
    res["fsdp_params"] = convert.burnin_params_to_jax(fs.model, CFG)

    # a TP checkpoint restored into the FSDP layout: the next step agrees
    ckpt = TrainCheckpointer(f"{ckdir}/tp")
    ckpt.save(tp, tp.step)
    restored = ckpt.restore(finit(42))
    ckpt.close()
    res["restored_placements"] = placements(restored.model)
    res["restored_step"] = restored.step
    batch = burnin.make_batch(CFG, mesh, 4)
    _, res["tp_next_loss"] = step(tp, batch)
    _, res["restored_next_loss"] = fstep(restored, batch)

    # the 2-slice training mesh (model axis inside a slice), a step there
    # and a bit-exact resume
    ranks = list(range(world_size))
    fake = multihost.fake_slice_getter(ranks, 2)
    tmesh = multihost.training_mesh(ranks, model_parallel=2,
                                    slice_getter=fake)
    res["training_mesh"] = tmesh.mesh.tolist()
    env_mesh = multihost.mesh_for_env()  # one node: the plain 2D mesh
    res["env_mesh"] = dict(zip(env_mesh.mesh_dim_names, env_mesh.shape))
    res["hybrid"] = dryrun.hybrid_and_resume(
        dataclasses.replace(CFG, batch=4))
    # the DCN probe over 2 fake slices of 2 ranks, each rank's own check
    probe = multihost.dcn_allreduce_probe(size_mb=0.01, iters=2, repeats=1,
                                          ranks=ranks, slice_getter=fake)
    res["probe"] = probe
    res["node_ids"] = [multihost.slice_id_of(r) for r in ranks]
    return res
