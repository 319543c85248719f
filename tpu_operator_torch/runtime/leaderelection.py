"""Lease-based leader election.

The port's own copy of ``tpu_operator/runtime/leaderelection.py``; the
default Lease is named ``gpu-operator`` in the ``gpu-operator`` namespace
(the reference's ``tpu-operator``).

NVIDIA's manager runs with controller-runtime leader election
(cmd/gpu-operator/main.go:123-128, flag --leader-elect) so only one
operator replica reconciles. Same protocol here: a coordination.k8s.io/v1
Lease named after the operator, acquired/renewed with resourceVersion-
compare-and-swap; on lost renewal the callbacks fire and the manager
stands down.
"""

from __future__ import annotations

import datetime
import logging
import threading
import uuid
from typing import Callable, Optional

from .client import Client, ConflictError, NotFoundError
from .objects import thaw_obj

log = logging.getLogger("tpu_operator_torch.leaderelection")


def _now() -> str:
    return datetime.datetime.now(datetime.timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%S.%fZ")


def _parse(ts: str) -> datetime.datetime:
    return datetime.datetime.strptime(
        ts, "%Y-%m-%dT%H:%M:%S.%fZ").replace(tzinfo=datetime.timezone.utc)


class LeaderElector:
    def __init__(self, client: Client, name: str = "gpu-operator",
                 namespace: str = "gpu-operator",
                 identity: Optional[str] = None,
                 lease_duration_s: float = 15.0,
                 renew_interval_s: float = 5.0,
                 on_started_leading: Optional[Callable[[], None]] = None,
                 on_stopped_leading: Optional[Callable[[], None]] = None):
        self.client = client
        self.name = name
        self.namespace = namespace
        self.identity = identity or f"{name}-{uuid.uuid4().hex[:8]}"
        self.lease_duration_s = lease_duration_s
        self.renew_interval_s = renew_interval_s
        self.on_started_leading = on_started_leading
        self.on_stopped_leading = on_stopped_leading
        self.is_leader = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def _duration_seconds(self) -> int:
        # Lease stores integer seconds; never round a short duration to 0
        # or the lease is born expired
        import math

        return max(1, math.ceil(self.lease_duration_s))

    def _lease_obj(self) -> dict:
        return {
            "apiVersion": "coordination.k8s.io/v1",
            "kind": "Lease",
            "metadata": {"name": self.name, "namespace": self.namespace},
            "spec": {
                "holderIdentity": self.identity,
                "leaseDurationSeconds": self._duration_seconds,
                "acquireTime": _now(),
                "renewTime": _now(),
            },
        }

    def try_acquire_or_renew(self) -> bool:
        """One CAS attempt; returns True when we hold the lease."""
        lease = self.client.get_or_none("coordination.k8s.io/v1", "Lease",
                                        self.name, self.namespace)
        if lease is not None:
            lease = thaw_obj(lease)  # reads are frozen views
        if lease is None:
            try:
                self.client.create(self._lease_obj())
                return True
            except Exception:
                return False
        spec = lease.get("spec") or {}
        holder = spec.get("holderIdentity")
        if holder == self.identity:
            spec["renewTime"] = _now()
            lease["spec"] = spec
            try:
                self.client.update(lease)
                return True
            except ConflictError:
                return False
        # someone else holds it — expired?
        renew = spec.get("renewTime")
        duration = float(spec.get("leaseDurationSeconds",
                                  self.lease_duration_s))
        expired = True
        if renew:
            try:
                age = (datetime.datetime.now(datetime.timezone.utc)
                       - _parse(renew)).total_seconds()
                expired = age > duration
            except ValueError:
                expired = True
        if not expired:
            return False
        lease["spec"] = {
            "holderIdentity": self.identity,
            "leaseDurationSeconds": self._duration_seconds,
            "acquireTime": _now(),
            "renewTime": _now(),
        }
        try:
            self.client.update(lease)
            log.info("%s took over expired lease from %s", self.identity,
                     holder)
            return True
        except (ConflictError, NotFoundError):
            return False

    def _loop(self):
        import time as _time

        last_success: Optional[float] = None
        while not self._stop.is_set():
            held = False
            try:
                held = self.try_acquire_or_renew()
            except Exception:
                log.exception("leader election attempt failed")
            now = _time.monotonic()
            if held:
                last_success = now
                if not self.is_leader:
                    self.is_leader = True
                    log.info("%s became leader", self.identity)
                    if self.on_started_leading:
                        self.on_started_leading()
            elif self.is_leader:
                # a single failed renew is a blip, not lost leadership —
                # the lease we hold stays valid until it expires; only
                # stand down once renewal has failed past the deadline
                # (client-go's renewDeadline semantics)
                if last_success is None or (
                        now - last_success > self.lease_duration_s):
                    self.is_leader = False
                    log.warning("%s lost leadership", self.identity)
                    if self.on_stopped_leading:
                        self.on_stopped_leading()
                else:
                    log.warning("renew failed; retrying (lease still valid "
                                "for %.1fs)",
                                self.lease_duration_s - (now - last_success))
            self._stop.wait(self.renew_interval_s)

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="leader-election")
        self._thread.start()

    def stop(self, release: bool = True):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2.0)
        if release and self.is_leader:
            try:
                lease = self.client.get("coordination.k8s.io/v1", "Lease",
                                        self.name, self.namespace)
                if (lease.get("spec") or {}).get("holderIdentity") == self.identity:
                    self.client.delete("coordination.k8s.io/v1", "Lease",
                                       self.name, self.namespace)
            except Exception:
                pass
            self.is_leader = False
