"""The elastic workload's checkpoint store on DCP.

Counterpart of ``OrbaxCheckpointStore`` in
``tpu_operator/workloads/elastic.py``: the store interface that the
reference's ``ElasticWorkload`` (the slice-intent handshake, which
imports no framework) speaks, over the port's ``TrainCheckpointer``
(``workloads/checkpoint.py``) in place of orbax. Only the store is
ported: the workload shim is framework-neutral and drives this store as
it drives the reference's.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

from .checkpoint import TrainCheckpointer


class DCPCheckpointStore:
    """``save``/``manifest``/``latest_step``/``restore`` over a
    ``TrainCheckpointer``: ``state_fn`` yields the live train state to
    persist (a DCP ``Stateful`` with a ``step``, such as
    ``burnin.TrainState``), ``state_like_fn`` the freshly built state a
    restore loads into, whose placements the values take (which is what
    makes a resume on another layout work).

    A save that carries a ``layout`` also persists the layout manifest
    beside the step, through the checkpointer's tmp-and-rename write,
    after the step is committed: the manifest is the only artefact this
    layer adds, and its rename is the commit point of the handoff
    planner. DCP saves are synchronous, so a ``partial`` save is
    committed too; it only goes without its manifest."""

    def __init__(self, checkpointer: TrainCheckpointer,
                 state_fn: Callable[[], Any],
                 state_like_fn: Callable[[], Any]):
        self._ckpt = checkpointer
        self._state_fn = state_fn
        self._state_like_fn = state_like_fn

    def save(self, step: int, payload: Any = None,
             partial: bool = False, layout: Optional[dict] = None) -> None:
        self._ckpt.save(self._state_fn(), int(step), wait=not partial)
        if layout is not None and not partial:
            # the manifest after the committed save: a crash in between
            # leaves a restorable step that falls back to a full restore
            self._ckpt.save_manifest(int(step), layout)

    def manifest(self, step: int) -> Optional[dict]:
        return self._ckpt.read_manifest(int(step))

    def latest_step(self) -> Optional[int]:
        return self._ckpt.latest_step()

    def restore(self) -> Tuple[int, Any]:
        """(step, state) of the newest readable checkpoint: the step is
        the restored state's own, so a torn latest step that the
        checkpointer skipped is not reported."""
        state = self._ckpt.restore(self._state_like_fn())
        return int(state.step), state
