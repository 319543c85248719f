"""The port's elastic checkpoint store (``DCPCheckpointStore``, over the
DCP ``TrainCheckpointer``) replaying the reference's
``OrbaxCheckpointStore`` tests (tests/test_checkpoint.py): the round
trip, the torn-latest fallback, the manifest's round trip and its fall
back to None. Then the reference's ``ElasticWorkload`` (framework-free)
drives the port's store through a crash and its restore, as it drives
its own in-memory store."""

import os
import shutil

import pytest
import torch

from tpu_operator.api import labels as L
from tpu_operator.api.slicerequest import (
    KIND_SLICE_REQUEST,
    PHASE_PLACED,
    V1ALPHA1,
    SliceRequestSpec,
    new_slice_request,
)
from tpu_operator.controllers.placement_controller import PlacementReconciler
from tpu_operator.runtime import FakeClient, Request
from tpu_operator.runtime.objects import get_nested
from tpu_operator.workloads.elastic import (
    ElasticWorkload,
    MemoryCheckpointStore,
    build_layout,
)
from tpu_operator_torch.workloads import burnin
from tpu_operator_torch.workloads.checkpoint import TrainCheckpointer
from tpu_operator_torch.workloads.elastic import DCPCheckpointStore

CFG = burnin.BurninConfig(vocab=64, d_model=32, n_heads=2, n_layers=1,
                          d_ff=64, seq_len=16, batch=8, dtype=torch.float32)


def small_state(seed=0):
    step, init_state, _ = burnin.make_train_step(None, CFG, device="cpu")
    return step, init_state(seed)


def batch(seed):
    return burnin.make_batch(CFG, None, seed, device="cpu")


def make_store(tmp_path):
    step_fn, state = small_state()
    box = {"state": state}
    ckpt = TrainCheckpointer(str(tmp_path), max_to_keep=3)
    store = DCPCheckpointStore(ckpt, state_fn=lambda: box["state"],
                               state_like_fn=lambda: small_state(seed=7)[1])
    return ckpt, box, store, step_fn


def test_save_restore_roundtrip(tmp_path):
    ckpt, box, store, step_fn = make_store(tmp_path)
    box["state"], _ = step_fn(box["state"], batch(1))
    store.save(1)
    assert store.latest_step() == 1
    step, restored = store.restore()
    ckpt.close()
    assert step == 1 and restored.step == 1
    for (name, p), q in zip(box["state"].model.named_parameters(),
                            restored.model.parameters()):
        assert torch.equal(p, q), name


def test_torn_latest_falls_back_to_previous_step(tmp_path):
    ckpt, box, store, step_fn = make_store(tmp_path)
    box["state"], _ = step_fn(box["state"], batch(1))
    store.save(1)
    box["state"], _ = step_fn(box["state"], batch(2))
    store.save(2)
    torn = tmp_path / "2"
    for entry in os.listdir(torn):
        p = torn / entry
        shutil.rmtree(p) if p.is_dir() else os.remove(p)
    step, restored = store.restore()
    ckpt.close()
    assert step == 1 and restored.step == 1
    assert ckpt.restore_fallbacks == 1


def test_manifest_persists_and_reads_back(tmp_path):
    ckpt, _, store, _ = make_store(tmp_path)
    lay = build_layout(["h0", "h1"], 1 << 16)
    store.save(1, layout=lay)
    assert store.manifest(1) == lay
    # a step saved without a layout reads back as None: full restore only
    store.save(2)
    assert store.manifest(2) is None
    # the manifest write is tmp + rename: no tmp residue
    assert not list(tmp_path.glob(".manifest-*.tmp"))
    assert (tmp_path / "manifest-1.json").exists()
    ckpt.close()


def test_unreadable_manifest_degrades_to_none(tmp_path):
    ckpt, _, store, _ = make_store(tmp_path)
    store.save(1, layout=build_layout(["h0"], 64))
    (tmp_path / "manifest-1.json").write_text("{not json")
    assert store.manifest(1) is None
    ckpt.close()


def test_partial_save_writes_no_manifest(tmp_path):
    ckpt, _, store, _ = make_store(tmp_path)
    store.save(3, partial=True, layout=build_layout(["h0"], 64))
    assert store.manifest(3) is None
    ckpt.close()


def test_empty_store_raises(tmp_path):
    _, _, store, _ = make_store(tmp_path)
    assert store.latest_step() is None
    with pytest.raises(FileNotFoundError):
        store.restore()


# --- the reference's ElasticWorkload on the port's store -------------------


class Clock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


def placed_job():
    """One 2-host v5e slice and a SliceRequest placed on it."""
    c = FakeClient()
    for i, name in enumerate(("a0", "a1")):
        c.add_node(name, labels={
            L.GKE_TPU_ACCELERATOR: "tpu-v5e-slice", L.GKE_TPU_TOPOLOGY: "2x4",
            L.GKE_NODEPOOL: "pool-a", L.GKE_TPU_WORKER_ID: str(i),
            L.GKE_ACCELERATOR_COUNT: "4"},
            allocatable={"google.com/tpu": "4"})
    clock = Clock()
    rec = PlacementReconciler(client=c, namespace="default", now=clock)
    c.create(new_slice_request("job", spec=SliceRequestSpec(chips=8).to_obj(),
                               namespace="default"))
    rec.reconcile(Request(name="job", namespace="default"))
    cr = c.get(V1ALPHA1, KIND_SLICE_REQUEST, "job", "default")
    assert get_nested(cr, "status", "phase") == PHASE_PLACED
    return c, clock


def drive(store_for, tmp_path):
    """Four quanta of training, un-acked progress, a crash (no torn
    save) and two more quanta; returns what the workload and the CR
    report at each point."""
    c, clock = placed_job()
    wl = ElasticWorkload(c, "job", "default", clock=clock,
                         checkpoint_every=6, steps_per_tick=3)
    wl.store = store_for(wl, tmp_path)
    for _ in range(4):
        wl.tick()
        clock.t += 1
    durable = wl.store.latest_step()
    wl.step += wl.steps_per_tick  # progress that no save covers
    wl.crash(partial=False)
    wl.tick()  # the restart: the restore takes the quantum
    cr = c.get(V1ALPHA1, KIND_SLICE_REQUEST, "job", "default")
    restored = get_nested(cr, "status", "migration", "restoredStep")
    after_restore = wl.step
    wl.tick()
    cr = c.get(V1ALPHA1, KIND_SLICE_REQUEST, "job", "default")
    return {"durable": durable, "restored": restored,
            "after_restore": after_restore, "after_next": wl.step,
            "checkpointed": get_nested(cr, "status", "progress",
                                       "checkpointedStep")}


def memory_store(wl, tmp_path):
    return MemoryCheckpointStore()


def dcp_store(wl, tmp_path):
    """The live train state's step is the job's: a real training loop
    would have taken ``wl.step`` steps."""
    _, state = small_state()

    def live():
        state.step = wl.step
        return state

    return DCPCheckpointStore(TrainCheckpointer(str(tmp_path / "ck")),
                              state_fn=live,
                              state_like_fn=lambda: small_state(seed=3)[1])


def test_elastic_workload_crash_restores_durable_step(tmp_path):
    want = drive(memory_store, tmp_path)
    got = drive(dcp_store, tmp_path)
    assert got == want
    assert got["durable"] == 12 and got["restored"] == 12
    assert got["after_restore"] == 12 and got["after_next"] == 15
