"""Checkpoint/resume for the sharded training workloads (DCP-backed).

Counterpart of ``tpu_operator/workloads/checkpoint.py``, on
``torch.distributed.checkpoint`` (DCP) in place of orbax. Long burn-ins
and validation runs must survive preemption, which means saving the
sharded train state to durable storage and restoring it into the
placements of a possibly different incarnation of the job.

DCP writes each rank's shards and one metadata file; this module adds
the framework contract orbax gave the JAX package:

- ``save(state, step)`` writes into a temporary directory and, once
  every rank has written, rank 0 renames it to ``<dir>/<step>``: a step
  is committed by the rename, so a partial step is never enumerated.
  The newest ``max_to_keep`` steps are kept.
- ``restore(state_like)`` loads into the live state's placements
  (``TrainState``'s state dict comes from ``get_state_dict``, keyed by
  parameter name), so a checkpoint taken under one layout (TP) restores
  into another (FSDP). With no explicit step, a corrupt latest step
  falls back to the previous one, logged and counted in
  ``restore_fallbacks``.

All ranks of the process group call every method but the manifest's;
without a process group one process does it all.
"""

from __future__ import annotations

import json
import logging
import os
import pathlib
import shutil
from typing import Any, List, Optional

import torch.distributed as dist

log = logging.getLogger("tpu_operator_torch.checkpoint")


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


class TrainCheckpointer:
    """Step-numbered DCP checkpoints of a train state (a DCP ``Stateful``
    such as ``burnin.TrainState``) under one directory."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self._dir = pathlib.Path(directory).absolute()
        self._dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.restore_fallbacks = 0  # corrupt latest steps skipped

    def save(self, state: Any, step: int, wait: bool = True) -> None:
        """Write ``state`` as ``step``. Saves are synchronous: the step is
        committed when this returns, whatever ``wait`` says."""
        import torch.distributed.checkpoint as dcp

        step = int(step)
        tmp = self._dir / f".tmp-{step}"
        if _rank() == 0:
            shutil.rmtree(tmp, ignore_errors=True)
        _barrier()
        dcp.save({"train": state}, checkpoint_id=str(tmp),
                 no_dist=not dist.is_initialized())
        _barrier()  # every rank's shards are written
        if _rank() == 0:
            final = self._dir / str(step)
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self._dir / str(old), ignore_errors=True)
        _barrier()

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        return sorted(int(p.name) for p in self._dir.iterdir()
                      if p.is_dir() and p.name.isdigit())

    def save_manifest(self, step: int, manifest: dict) -> None:
        """Persist the shard-layout manifest for a COMMITTED step: written
        to a tmp name and os.replace'd into place, so a crash mid-write
        never leaves a readable half-manifest. Only ever called after
        save() returned, which keeps the ordering invariant: a manifest's
        existence implies its step is complete."""
        path = self._dir / f"manifest-{int(step)}.json"
        tmp = self._dir / f".manifest-{int(step)}.json.tmp"
        tmp.write_text(json.dumps(manifest, sort_keys=True))
        os.replace(tmp, path)

    def read_manifest(self, step: int) -> Optional[dict]:
        """Shard-layout manifest for ``step``, or None when the step was
        saved without one or the manifest is unreadable — callers treat
        None as 'full restore only'."""
        path = self._dir / f"manifest-{int(step)}.json"
        try:
            return json.loads(path.read_text())
        except (OSError, ValueError):
            return None

    def _load(self, state_like: Any, step: int) -> Any:
        import torch.distributed.checkpoint as dcp
        from torch.distributed.checkpoint.api import CheckpointException

        try:
            dcp.load({"train": state_like},
                     checkpoint_id=str(self._dir / str(step)),
                     no_dist=not dist.is_initialized())
        except CheckpointException as e:
            # DCP reports a failed read, on every rank, as a
            # CheckpointException, a BaseException: callers get an Exception
            raise RuntimeError(f"checkpoint step {step} under {self._dir} "
                               f"is unreadable: {e}") from e
        return state_like

    def restore(self, state_like: Any, step: Optional[int] = None) -> Any:
        """Load a step into ``state_like`` (the freshly built state, whose
        placements the values take) and return it.

        With no explicit ``step``, an unreadable latest checkpoint (a
        crash can leave a torn step directory that still enumerates)
        falls back to the previous retained step instead of failing the
        job — each skip is logged and counted (``restore_fallbacks``). An
        explicit ``step`` still raises: the caller asked for that step,
        not "the newest restorable one"."""
        if step is not None:
            return self._load(state_like, step)
        candidates = sorted(self.all_steps(), reverse=True)
        if not candidates:
            raise FileNotFoundError(f"no checkpoints under {self._dir}")
        last_err: Optional[Exception] = None
        for i, s in enumerate(candidates):
            try:
                return self._load(state_like, s)
            except Exception as e:  # noqa: BLE001 — any unreadable step
                last_err = e
                if i + 1 < len(candidates):
                    self.restore_fallbacks += 1
                    log.warning(
                        "checkpoint step %s under %s is partial/corrupt "
                        "(%s); falling back to step %s",
                        s, self._dir, e, candidates[i + 1])
        raise FileNotFoundError(
            f"no restorable checkpoint under {self._dir}") from last_err

    def close(self) -> None:
        """Nothing to release (saves are synchronous); kept so callers
        treat this as the JAX package's checkpointer."""
