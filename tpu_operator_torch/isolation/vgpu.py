"""Fractional vGPU manager: fenced cards carved into units under a memory
budget that PyTorch's caching allocator enforces.

Counterpart of ``tpu_operator/isolation/vtpu.py`` (the
vgpu-device-manager slot). NVIDIA's vgpu-device-manager creates mediated
devices on the host; the reference has no such layer and gives each
fraction an HBM budget that the XLA client allocator enforces
(``XLA_PYTHON_CLIENT_MEM_FRACTION``). The port does the same with the
allocator PyTorch ships: the isolated device plugin turns a vGPU's
fraction into ``PYTORCH_CUDA_ALLOC_CONF=per_process_memory_fraction:<f>``,
which the caching allocator of the container's process reads itself.
The budget covers that allocator only, not the CUDA context or a
library's workspace: soft isolation, as XLA's fraction is (ROADMAP §C).

Each fenced card is carved into N vGPUs; the inventory is published to
/run/nvidia/vgpu-config.json for the isolated plugin, and the manager
reports through ``gpu.graft.dev/vgpu.config.state``
(pending|success|failed).

Profile ConfigMap shape::

    profiles:
      vgpu-2:
        vgpusPerCard: 2
        description: half-card inference units
      vgpu-4:
        vgpusPerCard: 4
        memMbPerVgpu: 19456   # optional explicit budget
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
from ..runtime.objects import labels_of
from .fencing import fenced_chips

log = logging.getLogger("gpu_vgpu_manager")

DEFAULT_VGPU_FILE = "/run/nvidia/vgpu-config.json"

STATE_PENDING = "pending"
STATE_SUCCESS = "success"
STATE_FAILED = "failed"


@dataclass
class VGPUProfile:
    name: str
    vgpus_per_card: int
    mem_mb_per_vgpu: Optional[int] = None
    description: str = ""


def load_vgpu_profiles(config_file: str) -> Dict[str, VGPUProfile]:
    import yaml

    with open(config_file) as f:
        raw = yaml.safe_load(f) or {}
    out = {}
    for name, body in (raw.get("profiles") or {}).items():
        out[name] = VGPUProfile(
            name=name,
            vgpus_per_card=int(body.get("vgpusPerCard", 1)),
            mem_mb_per_vgpu=(int(body["memMbPerVgpu"])
                             if body.get("memMbPerVgpu") else None),
            description=body.get("description", ""))
    if not out:
        raise ValueError(f"no profiles in {config_file}")
    return out


def card_memory_mb(node_labels: Dict[str, str],
                   card_name: str = "") -> Optional[int]:
    """Memory per card: the GPU_CARD_MEMORY_MB override, the feature
    label, else the hardware table keyed by the product — the product
    label, GKE's accelerator label, or ``card_name`` (NVML's name of the
    node's cards), in that order."""
    env = os.environ.get("GPU_CARD_MEMORY_MB")
    if env:
        return int(env)
    label = node_labels.get(L.GPU_MEMORY_GB)
    if label:
        return int(float(label) * 1024)
    product = (node_labels.get(L.GPU_PRODUCT)
               or node_labels.get(L.GKE_ACCELERATOR) or card_name)
    if product:
        from ..workloads.hardware import chip_spec_for

        spec = chip_spec_for(product)
        if spec:
            return int(spec.hbm_gb * 1024)
    return None


def build_vgpu_devices(chips: List[str], profile: VGPUProfile,
                       mem_mb: Optional[int]) -> List[dict]:
    """The vGPU inventory: one entry per (card, slot). The budget is the
    profile's explicit figure, else an even split of the card's memory;
    when neither is known it is 0 and the plugin sets no limit env (the
    fraction still applies)."""
    n = max(1, profile.vgpus_per_card)
    per = profile.mem_mb_per_vgpu or (mem_mb // n if mem_mb else 0)
    return [{"id": f"{chip}-vgpu{j}", "chip": chip, "mem_mb": per,
             "fraction": round(1.0 / n, 4)}
            for chip in chips for j in range(n)]


def write_vgpu_file(path: str, profile: VGPUProfile,
                    devices: List[dict]) -> None:
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = p.with_suffix(".tmp")
    tmp.write_text(json.dumps({
        "profile": profile.name,
        "vgpus_per_card": profile.vgpus_per_card,
        "devices": devices,
    }, indent=2))
    tmp.rename(p)


def vgpu_file_path(path: Optional[str] = None) -> str:
    return path or os.environ.get("GPU_VGPU_FILE", DEFAULT_VGPU_FILE)


def read_vgpu_file(path: Optional[str] = None) -> Optional[dict]:
    try:
        with open(vgpu_file_path(path)) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


class VGPUDeviceManager:
    """Per-node reconcile: vgpu.config label -> profile -> inventory."""

    def __init__(self, client, node_name: str, config_file: str,
                 default_profile: str = "vgpu-2",
                 vgpu_file: str = DEFAULT_VGPU_FILE):
        self.client = client
        self.node_name = node_name
        self.profiles = load_vgpu_profiles(config_file)
        self.default_profile = default_profile
        self.vgpu_file = vgpu_file

    def _set_state(self, state: str) -> None:
        self.client.patch("v1", "Node", self.node_name,
                          {"metadata": {"labels":
                                        {L.VGPU_CONFIG_STATE: state}}})

    def apply_once(self) -> str:
        node = self.client.get("v1", "Node", self.node_name)
        nl = labels_of(node)
        wanted = nl.get(L.VGPU_CONFIG, self.default_profile)
        profile = self.profiles.get(wanted)
        if profile is None:
            log.error("unknown vGPU profile %r (have %s)", wanted,
                      sorted(self.profiles))
            self._set_state(STATE_FAILED)
            return STATE_FAILED
        chips = fenced_chips()
        if not chips:
            # vGPUs are carved from fenced cards only: wait for the fence.
            # An inventory published before must go too, or the isolated
            # plugin would go on advertising vGPUs over cards the shared
            # pool just took back (double allocation)
            try:
                pathlib.Path(self.vgpu_file).unlink()
                log.info("fence empty; withdrew stale vGPU inventory")
            except FileNotFoundError:
                pass
            log.info("no fenced cards; vgpu config pending")
            self._set_state(STATE_PENDING)
            return STATE_PENDING
        from ..deviceplugin.plugin import card_inventory

        names = [c.name for c in card_inventory().cards if c.name]
        mem_mb = card_memory_mb(nl, names[0] if names else "")
        devices = build_vgpu_devices(chips, profile, mem_mb)
        write_vgpu_file(self.vgpu_file, profile, devices)
        self._set_state(STATE_SUCCESS)
        log.info("applied vGPU profile %r: %d device(s) over %d card(s)",
                 profile.name, len(devices), len(chips))
        return STATE_SUCCESS

    def run_forever(self, interval: float = 15.0) -> None:  # pragma: no cover
        while True:
            try:
                self.apply_once()
            except Exception:
                log.exception("vgpu reconcile failed")
            time.sleep(interval)


def main(argv=None) -> int:  # pragma: no cover - container entrypoint
    import argparse

    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(prog="gpu-vgpu-device-manager")
    p.add_argument("action", nargs="?", default="run",
                   choices=["run", "cleanup"])
    args = p.parse_args(argv)
    vgpu_file = vgpu_file_path()
    if args.action == "cleanup":
        # operator teardown, not a preStop: a restart must not flap the
        # isolated plugin's advertised resource
        try:
            pathlib.Path(vgpu_file).unlink()
            log.info("vGPU inventory withdrawn")
        except FileNotFoundError:
            pass
        return 0
    from ..runtime.kubeclient import InClusterClient

    mgr = VGPUDeviceManager(
        client=InClusterClient.from_env(),
        node_name=os.environ["NODE_NAME"],
        config_file=os.environ.get("CONFIG_FILE", "/config/config.yaml"),
        default_profile=os.environ.get("DEFAULT_PROFILE", "vgpu-2"),
        vgpu_file=vgpu_file)
    mgr.run_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
