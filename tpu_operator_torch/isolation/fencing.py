"""Card fencing: the advertisement boundary between the shared and the
isolated pool.

Counterpart of ``tpu_operator/isolation/fencing.py``. NVIDIA's
vfio-manager unbinds a card from the driver and binds it to vfio-pci;
the reference does not rebind (libtpu opens /dev/accel* directly) and
neither does the port: the fence is an *advertisement* boundary. The
agent publishes the fenced card set to a hostPath file
(/run/nvidia/fencing.json); the shared device plugin leaves fenced cards
out of ``nvidia.com/gpu``, and the isolated device plugin serves exactly
the fenced set as ``nvidia.com/gpu-isolated`` (or carves it into vGPUs).
A card is in one pool or the other, never both.

Config comes from the node label ``gpu.graft.dev/fencing.config``
(``all`` | ``none`` | a comma-separated list of ``gpu<i>`` IDs), falling
back to the DaemonSet's default; the agent reports through
``gpu.graft.dev/fencing.state``.
"""

from __future__ import annotations

import json
import logging
import os
import pathlib
import time
from typing import List, Optional

from ..api import labels as L
from ..runtime.objects import labels_of

log = logging.getLogger("gpu_chip_fencing")

DEFAULT_FENCING_FILE = "/run/nvidia/fencing.json"

STATE_SUCCESS = "success"
STATE_FAILED = "failed"


def resolve_fence_set(config: str, chips: List[str]) -> List[str]:
    """``all`` -> every card, ``none`` -> [], else the named subset.

    Naming a card that does not exist is a hard error, not a silent
    no-op: a fence list that doesn't match the hardware means the node
    was relabelled for different hardware, and guessing would leak an
    unfenced card into the shared pool.
    """
    config = (config or "all").strip()
    if config == "all":
        return list(chips)
    if config == "none":
        return []
    wanted = [c.strip() for c in config.split(",") if c.strip()]
    unknown = [c for c in wanted if c not in chips]
    if unknown:
        raise ValueError(f"fencing config names unknown chips {unknown} "
                         f"(have {chips})")
    return wanted


def write_fencing_file(path: str, fenced: List[str], config: str) -> None:
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = p.with_suffix(".tmp")
    tmp.write_text(json.dumps({"config": config, "fenced": fenced},
                              indent=2))
    tmp.rename(p)


def fencing_file_path(path: Optional[str] = None) -> str:
    """The one place the fence file's location is resolved: an explicit
    path, else GPU_FENCING_FILE, else the default. The agent, both
    plugins and the validator read through here, so they never drift
    onto different files."""
    return path or os.environ.get("GPU_FENCING_FILE", DEFAULT_FENCING_FILE)


def read_fencing_file(path: Optional[str] = None) -> Optional[dict]:
    try:
        with open(fencing_file_path(path)) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def fenced_chips(path: Optional[str] = None) -> List[str]:
    """The fence list (empty when no fence is active)."""
    cfg = read_fencing_file(path)
    if not cfg:
        return []
    return list(cfg.get("fenced") or [])


def _unlink(path: str) -> bool:
    try:
        pathlib.Path(path).unlink()
        return True
    except FileNotFoundError:
        return False


class FencingAgent:
    """Per-node reconcile loop: label -> fence file -> state label.
    ``client`` has the apiserver's ``get`` and merge-``patch`` of a Node
    (``runtime.kubeclient.InClusterClient``)."""

    def __init__(self, client, node_name: str,
                 default_config: str = "all",
                 fencing_file: str = DEFAULT_FENCING_FILE,
                 default_workload: str = "isolated"):
        self.client = client
        self.node_name = node_name
        self.default_config = default_config
        self.fencing_file = fencing_file
        # how an unlabelled node on this DaemonSet is routed: the plane's
        # default workload, passed down by the manifest, because the
        # operator routes by default without stamping the label
        self.default_workload = default_workload

    def _set_state(self, state: str) -> None:
        self.client.patch("v1", "Node", self.node_name,
                          {"metadata": {"labels": {L.FENCING_STATE: state}}})

    def apply_once(self) -> str:
        from ..deviceplugin.plugin import discover_chips

        node = self.client.get("v1", "Node", self.node_name)
        nl = labels_of(node)
        config = nl.get(L.FENCING_CONFIG, self.default_config)
        chips = discover_chips()
        try:
            fenced = resolve_fence_set(config, chips)
        except ValueError as e:
            log.error("%s", e)
            self._set_state(STATE_FAILED)
            return STATE_FAILED
        write_fencing_file(self.fencing_file, fenced, config)
        # a node flipped virtual -> isolated keeps its vGPU inventory on
        # disk, and the vGPU manager is no longer scheduled there to
        # withdraw it; this agent still is. An unlabelled node resolves
        # to the plane's default workload (withdrawing on a node that is
        # virtual by default would fight the vGPU manager forever)
        if nl.get(L.WORKLOAD_CONFIG, self.default_workload) != "virtual":
            self._withdraw_vgpu_file("node is not in virtual mode")
        self._set_state(STATE_SUCCESS)
        log.info("fenced %d/%d card(s) (config=%r)", len(fenced),
                 len(chips), config)
        return STATE_SUCCESS

    def _withdraw_vgpu_file(self, why: str) -> None:
        from .vgpu import vgpu_file_path

        path = vgpu_file_path()
        if _unlink(path):
            log.info("%s; withdrew the vGPU inventory %s", why, path)

    def cleanup(self) -> None:
        """Operator teardown (``gpu-chip-fencing cleanup``): withdraw the
        fence and the vGPU inventory. Not a preStop: a pod restart would
        briefly re-admit fenced cards to the shared pool; the shared
        plugin withdraws stale files at its start on nodes that left the
        plane (``GpuDevicePlugin._converge_node_regime``)."""
        _unlink(self.fencing_file)
        self._withdraw_vgpu_file("fence withdrawn")
        log.info("fence withdrawn")

    def run_forever(self, interval: float = 15.0) -> None:  # pragma: no cover
        while True:
            try:
                self.apply_once()
            except Exception:
                log.exception("fencing reconcile failed")
            time.sleep(interval)


def main(argv=None) -> int:  # pragma: no cover - container entrypoint
    import argparse

    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(prog="gpu-chip-fencing")
    p.add_argument("action", nargs="?", default="run",
                   choices=["run", "cleanup"])
    args = p.parse_args(argv)
    from ..runtime.kubeclient import InClusterClient

    agent = FencingAgent(
        client=InClusterClient.from_env(),
        node_name=os.environ["NODE_NAME"],
        default_config=os.environ.get("FENCING_CONFIG", "all"),
        fencing_file=fencing_file_path(),
        default_workload=os.environ.get("GPU_DEFAULT_WORKLOAD_CONFIG",
                                        "isolated"))
    if args.action == "cleanup":
        agent.cleanup()
        return 0
    agent.run_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
