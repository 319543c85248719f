"""Card-group manager: the mig-manager slot.

Counterpart of ``tpu_operator/topology/manager.py``. The node label
``gpu.graft.dev/slice.config`` names a profile from the profiles
ConfigMap; the manager splits the node's whole cards into the profile's
``subslices`` contiguous groups (NVML's index order, ``gpu<i>``),
publishes them to the device plugin through a shared hostPath file
(/run/nvidia/slice-config.json), and reports through
``gpu.graft.dev/slice.config.state`` (pending|success|failed). No card
is partitioned: the fraction of a card is the vGPU manager's.

**Multi-host pools are grouped**: where the node's NVLink domain spans
hosts (``NodePool.multi_host``), every node of the pool must ask for the
same profile before any of them flips to success, as a TPU slice's hosts
must.
"""

from __future__ import annotations

import json
import logging
import os
import pathlib
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from ..api import labels as L
from ..runtime.objects import get_nested, labels_of, name_of
from ..state.nodepool import NodePool

log = logging.getLogger("gpu_topology_manager")

DEFAULT_SLICE_FILE = "/run/nvidia/slice-config.json"

STATE_PENDING = "pending"
STATE_SUCCESS = "success"
STATE_FAILED = "failed"


@dataclass
class Profile:
    name: str
    subslices: int
    description: str = ""


def load_profiles(config_file: str) -> Dict[str, Profile]:
    import yaml

    with open(config_file) as f:
        raw = yaml.safe_load(f) or {}
    out = {}
    for name, body in (raw.get("profiles") or {}).items():
        # name the offending profile: one bad entry in a shared config map
        # must say which profile is broken
        if not isinstance(body, dict):
            raise ValueError(
                f"profile {name!r} in {config_file}: body must be a "
                f"mapping, got {type(body).__name__}")
        subslices = body.get("subslices", 1)
        if isinstance(subslices, bool) or not isinstance(subslices, int):
            raise ValueError(
                f"profile {name!r} in {config_file}: subslices must be "
                f"an integer, got {subslices!r}")
        if subslices < 1:
            raise ValueError(
                f"profile {name!r} in {config_file}: subslices must be "
                f">= 1, got {subslices}")
        out[name] = Profile(name=name, subslices=subslices,
                            description=body.get("description", ""))
    if not out:
        raise ValueError(f"no profiles in {config_file}")
    return out


def chip_groups(chip_ids: List[str], subslices: int) -> List[List[str]]:
    """Partition cards into contiguous groups of NVML's index order."""
    if subslices < 1 or len(chip_ids) % subslices:
        raise ValueError(
            f"cannot split {len(chip_ids)} cards into {subslices} groups")
    per = len(chip_ids) // subslices
    return [chip_ids[i * per:(i + 1) * per] for i in range(subslices)]


def write_slice_file(path: str, profile: Profile,
                     groups: List[List[str]]) -> None:
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = p.with_suffix(".tmp")
    tmp.write_text(json.dumps({
        "profile": profile.name,
        "subslices": profile.subslices,
        "groups": groups,
    }, indent=2))
    tmp.rename(p)


def read_slice_file(path: str = DEFAULT_SLICE_FILE) -> Optional[dict]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


class TopologyManager:
    def __init__(self, client, node_name: str, config_file: str,
                 default_profile: str = "full",
                 slice_file: str = DEFAULT_SLICE_FILE):
        self.client = client   # get, list and merge-patch of Nodes
        self.node_name = node_name
        self.profiles = load_profiles(config_file)
        self.default_profile = default_profile
        self.slice_file = slice_file

    def _set_state(self, state: str) -> None:
        self.client.patch("v1", "Node", self.node_name,
                          {"metadata": {"labels":
                                        {L.SLICE_CONFIG_STATE: state}}})

    def _pool_peers(self, node: dict) -> List[dict]:
        """Nodes of the same NVLink domain as this node: same (product,
        topology) AND the same node-pool identity, so two pools of one
        shape form two agreement groups."""
        nl = labels_of(node)
        product = nl.get(L.GPU_PRODUCT, "")
        topo = nl.get(L.GPU_TOPOLOGY, "")
        pool = nl.get(L.GKE_NODEPOOL)
        out = []
        for n in self.client.list("v1", "Node"):
            other = labels_of(n)
            if other.get(L.GPU_PRODUCT) != product:
                continue
            if other.get(L.GPU_TOPOLOGY) != topo:
                continue
            if pool is not None and other.get(L.GKE_NODEPOOL) != pool:
                continue
            out.append(n)
        return out

    def apply_once(self) -> str:
        """One reconcile pass; returns the state written to the node."""
        node = self.client.get("v1", "Node", self.node_name)
        nl = labels_of(node)
        wanted = nl.get(L.SLICE_CONFIG, self.default_profile)
        profile = self.profiles.get(wanted)
        if profile is None:
            log.error("unknown slice profile %r (have %s)", wanted,
                      sorted(self.profiles))
            self._set_state(STATE_FAILED)
            return STATE_FAILED

        pool = NodePool(product=nl.get(L.GPU_PRODUCT, ""),
                        topology=nl.get(L.GPU_TOPOLOGY, ""))
        if pool.multi_host:
            # grouped semantics: every host of the domain must agree first
            peers = self._pool_peers(node)
            disagreeing = [
                name_of(p) for p in peers
                if labels_of(p).get(L.SLICE_CONFIG,
                                    self.default_profile) != wanted]
            if disagreeing:
                log.info("multi-host pool not converged on %r yet "
                         "(disagreeing: %s)", wanted, disagreeing)
                self._set_state(STATE_PENDING)
                return STATE_PENDING

        cards = int(nl.get(L.GPU_CHIP_COUNT) or
                    get_nested(node, "status", "allocatable", L.GPU_RESOURCE,
                               default="0") or 0)
        if cards == 0:
            self._set_state(STATE_FAILED)
            return STATE_FAILED
        # NVML's card IDs where it answers; synthesize only as a last resort
        from ..deviceplugin.plugin import discover_chips

        chip_ids = discover_chips() or [f"gpu{i}" for i in range(cards)]
        if len(chip_ids) != cards:
            log.warning("label says %d cards but NVML lists %d; using "
                        "NVML's", cards, len(chip_ids))
        try:
            groups = chip_groups(chip_ids, profile.subslices)
        except ValueError as e:
            log.error("%s", e)
            self._set_state(STATE_FAILED)
            return STATE_FAILED
        write_slice_file(self.slice_file, profile, groups)
        self._set_state(STATE_SUCCESS)
        log.info("applied profile %r: %d group(s) of %d card(s)",
                 profile.name, profile.subslices, len(groups[0]))
        return STATE_SUCCESS

    def run_forever(self, interval: float = 15.0) -> None:  # pragma: no cover
        while True:
            try:
                self.apply_once()
            except Exception:
                log.exception("slice reconcile failed")
            time.sleep(interval)


def main() -> int:
    """The container's entry: NODE_NAME, CONFIG_FILE, DEFAULT_PROFILE and
    GPU_SLICE_FILE from the env, the pod's service account for the
    apiserver."""
    logging.basicConfig(level=logging.INFO)
    from ..runtime.kubeclient import InClusterClient

    mgr = TopologyManager(
        client=InClusterClient.from_env(),
        node_name=os.environ["NODE_NAME"],
        config_file=os.environ.get("CONFIG_FILE", "/config/config.yaml"),
        default_profile=os.environ.get("DEFAULT_PROFILE", "full"),
        slice_file=os.environ.get("GPU_SLICE_FILE", DEFAULT_SLICE_FILE))
    mgr.run_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
