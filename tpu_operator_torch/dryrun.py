"""Multi-card dry run of the port's training stack.

Counterpart of ``dryrun_multichip`` in ``__graft_entry__.py``:

    python -m tpu_operator_torch.dryrun 4            # one rank per card
    python -m tpu_operator_torch.dryrun 4 cpu        # gloo ranks

``dryrun_multichip(n)`` spawns ``n`` ranks and runs, on every rank:

1. one burn-in training step on an n-rank [data, model] mesh —
   tensor-parallel parameters, data-parallel batch, sequence-parallel
   norms, AdamW; the loss must be finite. A second step runs the FSDP
   layout (parameters and AdamW moments sharded over both axes) on the
   same batch and must reproduce the loss;
2. one conv burn-in training step on the same mesh (channel-parallel
   convs: column-parallel conv1, row-parallel conv2), a finite loss;
3. context-parallel ring attention over the same ranks (``ringattention``
   at ``seq_len=16·n, n_heads=2, head_dim=8``, the einsum tile), the
   GPipe pipeline with one stage a rank (``batch=8``, 4 microbatches) and
   the expert-parallel MoE with one expert a rank (8 tokens an expert),
   each held to its single-device oracle on rank 0;
4. (n >= 4 and even) two fake slices of n/2 ranks: the hybrid
   [dcn, data, model] and training meshes, a step on the training mesh,
   a checkpoint resume that restores every parameter, AdamW moment and
   step count bit for bit and whose next loss equals the uninterrupted
   run's bit for bit, and the DCN probe over the two slices.
"""

from __future__ import annotations

import contextlib
import dataclasses
import shutil
import sys
import tempfile
import time
from typing import Dict, List

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from .parallel import mesh as pmesh
from .parallel import multihost
from .workloads import burnin, convburn, moe, pipeline, ringattention
from .workloads.backend import resolve_device
from .workloads.checkpoint import TrainCheckpointer


def log(msg: str) -> None:
    if dist.get_rank() == 0:
        print(msg, flush=True)


@contextlib.contextmanager
def shared_tmpdir():
    """A temporary directory made by rank 0, the same path on every rank
    (the ranks of one host share its disk); removed on exit."""
    path = [tempfile.mkdtemp(prefix="burnin-ckpt-") if dist.get_rank() == 0
            else None]
    dist.broadcast_object_list(path, src=0)
    try:
        yield path[0]
    finally:
        dist.barrier()
        if dist.get_rank() == 0:
            shutil.rmtree(path[0], ignore_errors=True)


def all_ranks(flag: bool) -> bool:
    """True where ``flag`` holds on every rank of the group."""
    flags: List = [None] * dist.get_world_size()
    dist.all_gather_object(flags, bool(flag))
    return all(flags)


def batch_for(cfg: burnin.BurninConfig, dp: int) -> burnin.BurninConfig:
    """``cfg`` with a batch the data axis divides, at least 8 rows."""
    return dataclasses.replace(cfg, batch=dp * max(2, -(-8 // dp)))


def state_tensors(state) -> List[torch.Tensor]:
    """This rank's shard of every parameter of ``state`` and of its
    optimizer state (AdamW's moments and step count), in parameter
    order."""
    out: List[torch.Tensor] = []
    for p in state.model.parameters():
        out.append(p)
        out += [v for _, v in sorted(state.optimizer.state[p].items())
                if isinstance(v, torch.Tensor)]
    return [t.to_local() if isinstance(t, DTensor) else t for t in out]


def _synced_seconds(state, fn):
    """(``fn()``, its wall seconds), the card drained before and after."""
    dev = next(state.model.parameters()).device
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def resume_matches(step, init_state, state, batch, ckdir: str) -> Dict:
    """Save ``state`` and restore the save into a fresh, differently
    seeded state: every parameter, AdamW moment and step count must come
    back bit for bit. Then step both on ``batch`` (the uninterrupted run
    and the resumed one): the two losses must be equal bit for bit.
    Returns the resumed step and loss and the save and restore seconds."""
    ckpt = TrainCheckpointer(ckdir)
    saved_step = state.step
    _, save_s = _synced_seconds(state, lambda: ckpt.save(state, saved_step))
    fresh = init_state(99)
    restored, restore_s = _synced_seconds(fresh, lambda: ckpt.restore(fresh))
    ckpt.close()
    if restored.step != saved_step:
        raise AssertionError(f"restored step {restored.step} != {saved_step}")
    want, got = state_tensors(state), state_tensors(restored)
    if len(got) != len(want) or not all(
            torch.equal(a, b.to(a.device)) for a, b in zip(got, want)):
        raise AssertionError("restored parameters or optimizer state differ "
                             "from the saved ones")
    _, loss_oracle = step(state, batch)
    state2, loss_resumed = step(restored, batch)
    if not torch.equal(loss_resumed, loss_oracle):
        raise AssertionError(f"resume diverged: {float(loss_resumed)!r} != "
                             f"{float(loss_oracle)!r}")
    return {"resumed_step": state2.step, "loss": float(loss_resumed),
            "tensors_restored": len(got), "save_s": save_s,
            "restore_s": restore_s}


def hybrid_and_resume(cfg: burnin.BurninConfig) -> Dict:
    """Stage 3 on this rank: two fake slices of the group's ranks."""
    n = dist.get_world_size()
    ranks = list(range(n))
    per_slice = n // 2
    fake = multihost.fake_slice_getter(ranks, 2)
    hmesh = multihost.hybrid_mesh(ranks, slice_getter=fake)
    if hmesh["dcn"].size() != 2:
        raise AssertionError(f"bad hybrid mesh: {hmesh}")
    tmesh = multihost.training_mesh(ranks, slice_getter=fake)
    # the model axis must fit inside one slice (never cross the DCN)
    if tmesh["model"].size() > per_slice:
        raise AssertionError(f"model axis crosses the DCN: {tmesh}")
    cfg = batch_for(cfg, tmesh["data"].size())
    step, init_state, _ = burnin.make_train_step(tmesh, cfg)
    state = init_state(2)
    state, loss_h = step(state, burnin.make_batch(cfg, tmesh, 3))
    if not torch.isfinite(loss_h):
        raise AssertionError(f"non-finite hybrid loss: {float(loss_h)}")
    with shared_tmpdir() as ckdir:
        resumed = resume_matches(step, init_state, state,
                                 burnin.make_batch(cfg, tmesh, 4), ckdir)
    # the cross-slice gradient-sync path, measured: an all-reduce over the
    # dcn axis only (what validate_dcn's DCN_BANDWIDTH_PROBE runs)
    probe = multihost.dcn_allreduce_probe(size_mb=0.5, iters=2, repeats=1,
                                          ranks=ranks, slice_getter=fake)
    if not all_ranks(probe.correct) or probe.slices != 2:
        raise AssertionError(f"DCN all-reduce diverged from oracle: {probe}")
    return {"hybrid": dict(zip(hmesh.mesh_dim_names, hmesh.shape)),
            "training": dict(zip(tmesh.mesh_dim_names, tmesh.shape)),
            "loss": float(loss_h), "resume_bitexact": True, **resumed,
            "dcn_probe_bus_gbps": probe.bus_bw_gbps}


def dryrun_rank(rank, world_size, device) -> Dict:
    """Every stage on this rank; returns the summary (rank 0's is whole)."""
    n = world_size
    mesh = pmesh.build_mesh()
    dp = mesh["data"].size()
    # the batch must divide evenly across the data axis; >= 8 for signal
    cfg = batch_for(burnin.BurninConfig(vocab=128, d_model=64, n_heads=2,
                                        n_layers=2, d_ff=128, seq_len=32), dp)
    step, init_state, _ = burnin.make_train_step(mesh, cfg)
    batch = burnin.make_batch(cfg, mesh, 1)
    state, loss = step(init_state(0), batch)
    if not torch.isfinite(loss):
        raise AssertionError(f"non-finite loss: {float(loss)}")
    summary = {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
               "loss": float(loss), "step": state.step}
    # FSDP: parameters and AdamW moments sharded over both axes; the
    # fully sharded step must reproduce the loss — its all-gathers and
    # reduce-scatters are layout, not math
    fstep, finit, _ = burnin.make_train_step(mesh, cfg, fsdp=True)
    _, floss = fstep(finit(0), batch)
    if not abs(float(floss) - float(loss)) < 5e-4 * max(1.0, abs(float(loss))):
        raise AssertionError(f"fsdp loss {float(floss)} != tp loss "
                             f"{float(loss)}")
    summary["fsdp_loss"] = float(floss)

    # the conv model family: channel-parallel convs on the same mesh,
    # sharded through a full train step
    mp = mesh["model"].size()
    ccfg = convburn.ConvBurninConfig(image_size=8, width=8 * mp, n_blocks=1,
                                     n_classes=8, batch=dp * 2)
    cstep, cinit = convburn.make_train_step(mesh, ccfg)
    _, closs = cstep(cinit(5), convburn.make_batch(ccfg, mesh, 6))
    if not torch.isfinite(closs):
        raise AssertionError(f"non-finite conv loss: {float(closs)}")
    summary["conv_loss"] = float(closs)

    res = ringattention.context_parallel_case(
        device, "ring", seq_len=16 * n, n_heads=2, head_dim=8, batch=1)
    if rank == 0 and not res.result.correct:
        raise AssertionError(f"ring attention diverged from oracle: {res}")
    summary["ring_attention_err"] = res.result.max_abs_err
    pp = pipeline.pipeline_case(device, batch=8, n_microbatches=4).result
    if rank == 0 and not pp.correct:
        raise AssertionError(f"pipeline forward diverged from oracle: {pp}")
    ep = moe.moe_case(device, tokens_per_expert=8).result
    if rank == 0 and not ep.correct:
        raise AssertionError(f"expert-parallel MoE diverged from oracle: {ep}")
    summary.update(pipeline_stages=pp.stages, pipeline_err=pp.max_abs_err,
                   moe_experts=ep.experts, moe_err=ep.max_abs_err)
    log(f"dryrun_multichip({n}): mesh={summary['mesh']} "
        f"loss={summary['loss']:.4f} fsdp_loss={summary['fsdp_loss']:.4f} "
        f"step={state.step} conv_loss={summary['conv_loss']:.4f} "
        f"ring_attention_err={res.result.max_abs_err:.2e} "
        f"pipeline_stages={pp.stages} pipeline_err={pp.max_abs_err:.2e} "
        f"moe_experts={ep.experts} moe_err={ep.max_abs_err:.2e}")

    if n >= 4 and n % 2 == 0:
        summary["hybrid"] = hybrid_and_resume(cfg)
        log(f"dryrun_hybrid(2x{n // 2}): {summary['hybrid']}")
    else:
        log(f"dryrun_hybrid: skipped (needs even n_devices >= 4, got {n})")
    return summary


def dryrun_multichip(n_devices: int, device_type: str = "cuda") -> Dict:
    """The dry run over ``n_devices`` spawned ranks (one per card; on
    ``"cpu"``, gloo ranks); returns rank 0's summary. Raises if a stage
    fails, and on ``"cuda"`` where there is no card to run on."""
    resolve_device(device_type)
    if device_type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"need {n_devices} cards, have "
                           f"{torch.cuda.device_count()}")
    return pmesh.spawn(dryrun_rank, n_devices, device_type)[0]


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else max(
        1, torch.cuda.device_count())
    dryrun_multichip(n, sys.argv[2] if len(sys.argv) > 2 else "cuda")
