"""The chaos plane's verdicts held between the JAX package and the port.

Both packages run a scenario at 32 nodes, seed 7, over fleets mapped one
to one (``torch_placement_fleets``): 4-chip single hosts that are the
reference's ``tpu-v5p-slice`` ``2x2x1`` pool (the pool its NODE_ADD joins)
and the port's H100 ``nvswitch-4`` pool (the pool the port's NODE_ADD
joins), and 4-host multi-host slices (a ``1x16`` row <-> an ``mnnvl-4``
nodepool), with CPU nodes on top. The port's placement scorer is read
with the H100 at half the fastest card's peak, as v5p is half of v6e's
in the reference's table, so the scores are equal too.

The reference's verdict is put in the port's words before the compare:
every name through ``torch_naming``, the generation ``v5p`` and its pools
through :data:`GENERATIONS`, the rollout markers' ``libtpu`` through
``driver``, the settled digests recomputed over the renamed settled
state, and an Event's content-hash suffix left out on both sides (it
hashes the renamed text). The port's renamed operands sort and hash
differently from the reference's (ROADMAP §C, C10), so the port is run
with its operand order, its shard hash and its kubelet's DaemonSet order
read through the reference's names. One difference of the domain models
is declared (:data:`DECLARED`).

Run as a script, it prints one package's verdicts as one JSON object:
``python tests/torch_chaos_parity.py ref|port <scenario>...``; a test
file starts four such processes (two a package) and compares.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import torch_naming as N
import torch_placement_fleets as F

NODES = 32
SEED = 7
# the single hosts' generation on each side (reference GKE accelerator,
# port GKE accelerator, port gpu.product)
GEN = ("tpu-v5p-slice", "nvidia-h100-80gb", "NVIDIA-H100-80GB-HBM3")
# the reference's generation and pools in the port's words
GENERATIONS = {"v5p": "h100-sxm",
               "v5p-2x2x1": "nvidia-h100-80gb-hbm3-nvswitch-4",
               "v5p-1x16": "nvidia-h100-80gb-hbm3-mnnvl-4"}
# the fleet fold's rollup domain of a single-host pool
ROLLUP_DOMAIN = ("nvidia-h100-80gb-hbm3-nvswitch-4", "h100-sxm-nvswitch-4")
# declared differences, per scenario: (reference text in the port's
# words, the port's). A node removal shrinks an NVLink domain's capacity
# to the hosts it still has, where a TPU grid keeps the chips of its
# topology label, so the 16-chip request that lost a host reads "no free
# capacity" where the reference reads the 3-host run that is left
DECLARED = {
    "slice-migrate": [(
        "16 chips requested; largest free contiguous run in an admitting "
        "domain is 12 chips (pool nvidia-h100-80gb-hbm3-mnnvl-4)",
        "16 chips requested; no free capacity")],
}


def single_labels(ref: bool) -> tuple:
    """A mapped single host's labels and allocatable, on one side."""
    if ref:
        from tpu_operator.api import labels as RL

        return ({RL.GKE_TPU_ACCELERATOR: GEN[0],
                 RL.GKE_TPU_TOPOLOGY: "2x2x1",
                 RL.GKE_ACCELERATOR_COUNT: "4"}, {RL.TPU_RESOURCE: "4"})
    from tpu_operator_torch.api import labels as L

    return ({L.GKE_ACCELERATOR: GEN[1], L.GPU_PRODUCT: GEN[2],
             L.GPU_TOPOLOGY: "nvswitch-4", L.GKE_ACCELERATOR_COUNT: "4"},
            {L.GPU_RESOURCE: "4"})


def build(ref: bool):
    """The mapped ``build_cluster`` of one side: n GPU (TPU) nodes, n // 8
    of them 4-host slices and the rest single hosts, and n // 10 CPU
    nodes."""
    def build_cluster(n):
        if ref:
            from tpu_operator.runtime import FakeClient as Fake
        else:
            from tpu_operator_torch.runtime.fake import FakeClient as Fake
        c = Fake()
        n_slices = max(1, n // 8)
        labels, alloc = single_labels(ref)
        for i in range(n - 4 * n_slices):
            c.add_node(f"s-{i:02d}", labels=dict(labels),
                       allocatable=dict(alloc))
        for p in range(n_slices):
            for w in range(4):
                name, lab, al = F._multi(ref, GEN, f"p{p:03d}", w, 4)
                c.add_node(name, labels=lab, allocatable=al)
        for i in range(n // 10):
            c.add_node(f"cpu-{i}")
        return c
    return build_cluster


# -- the port, read through the reference's names ---------------------------

_INV = {v: k for k, v in {**N.OBJECTS, **N.CRD}.items()}
_INV_PREFIXES = sorted(((v, k) for k, v in N.OBJECTS.items() if len(k) > 4),
                       key=lambda kv: -len(kv[0]))


def _ref_token(t: str) -> str:
    if t in _INV:
        return _INV[t]
    for port, ref in _INV_PREFIXES:
        if t.startswith(port + "-"):
            return ref + t[len(port):]
    return t


def ref_name(value: str) -> str:
    """A port object name or key as the reference names it."""
    return "".join(_ref_token(p) for p in re.split(r"([/:])", value))


def patch_port(monkeypatch) -> None:
    """Run the port over the mapped fleet, in the reference's orders."""
    from tpu_operator.runtime.manager import shard_of as ref_shard_of
    from tpu_operator_torch.chaos import federation as pf
    from tpu_operator_torch.chaos import runner as pr
    from tpu_operator_torch.runtime import fake as pfake
    from tpu_operator_torch.runtime.objects import name_of, namespace_of
    from tpu_operator_torch.topology import placement as pp

    port = build(False)
    monkeypatch.setattr(pr, "build_cluster", lambda n_gpu: port(n_gpu))
    monkeypatch.setattr(pf, "build_cluster", lambda n_gpu: port(n_gpu))
    monkeypatch.setattr(pp, "_MAX_PEAK",
                        2 * pp.CHIPS["h100-sxm"].peak_bf16_tflops)
    monkeypatch.setattr(pr, "OPERAND_ORDER",
                        lambda obj: ref_name(name_of(obj)))
    monkeypatch.setattr(pr, "shard_of",
                        lambda key, live: ref_shard_of(ref_name(key), live))

    def kubelet(client, ready=True, stale_hash=False):
        for ds in sorted(client.list("apps/v1", "DaemonSet"),
                         key=lambda o: (ref_name(namespace_of(o) or ""),
                                        ref_name(name_of(o)))):
            try:
                pfake._kubelet_tick_ds(client, ds, ready=ready,
                                       stale_hash=stale_hash)
            except (pfake.ConflictError, pfake.NotFoundError,
                    pfake.AlreadyExistsError):
                continue

    monkeypatch.setattr(pr, "simulate_kubelet", kubelet)
    monkeypatch.setattr(pf, "simulate_kubelet", kubelet)


# -- the reference's verdict in the port's words ----------------------------

_PREFIXES = sorted(((k, v) for k, v in N.OBJECTS.items() if len(k) > 4),
                   key=lambda kv: -len(kv[0]))
_EVENT = re.compile(r"(.*cluster-policy)\.[0-9a-f]{12}")
_MARKER = re.compile(r"(/opt/[a-z]+)-libtpu(-[0-9]+)")


def _token(t: str, ref: bool) -> str:
    m = _EVENT.fullmatch(t)
    if m:
        return (_token(m.group(1), ref) if ref else m.group(1)) + ".<event>"
    if not ref:
        return t
    if t in N.EXACT:
        return N.EXACT[t]
    if t in GENERATIONS:
        return GENERATIONS[t]
    if t.startswith("tpu.graft.dev/"):
        return N.label_key(t)
    for a, b in _PREFIXES:
        if t.startswith(a + "-"):
            return b + t[len(a):]
    return t


def _text(value: str, ref: bool) -> str:
    m = _MARKER.fullmatch(value)
    if ref and m:
        return m.group(1) + "-driver" + m.group(2)
    if ref and value in N.EXACT:
        return N.EXACT[value]
    if ref and value.startswith("tpu.graft.dev/"):
        return N.label_key(value)
    parts = re.split(r"([\s/:,()'\"\[\]=]+)", value)
    return "".join(_token(p, ref) for p in parts)


def _tree(t, ref: bool):
    if isinstance(t, dict):
        return {_text(k, ref): _tree(v, ref) for k, v in t.items()}
    if isinstance(t, list):
        return [_tree(v, ref) for v in t]
    if isinstance(t, str):
        return _text(t, ref)
    return t


def port_words(verdict: dict, scenario: str) -> dict:
    """The reference's verdict in the port's words."""
    from tpu_operator_torch.chaos.invariants import settled_state_digest

    out = _tree(verdict, ref=True)
    tel = out.get("telemetry")
    if tel is not None:
        for part in tel["rollup"].values():
            if isinstance(part, dict) and ROLLUP_DOMAIN[0] in part:
                part[ROLLUP_DOMAIN[1]] = part.pop(ROLLUP_DOMAIN[0])
    if "settled_state" in out:
        old = verdict["settled_digest"]
        new = settled_state_digest(out["settled_state"])
        out["settled_digest"] = new
        rc = out.get("restart_coherent")
        if rc is not None:
            for k in ("digest", "baseline_digest"):
                if rc[k] == old:
                    rc[k] = new
    blob = json.dumps(out, sort_keys=True)
    for ref_text, port_text in DECLARED.get(scenario, ()):
        blob = blob.replace(json.dumps(ref_text), json.dumps(port_text))
    return json.loads(blob)


def normalized(verdict: dict) -> dict:
    """The port's verdict with an Event's content hash left out."""
    return _tree(verdict, ref=False)


def canonical(verdict: dict) -> str:
    return json.dumps(verdict, indent=1, sort_keys=True)


# -- the runs, as processes -------------------------------------------------

# seconds a scenario's run took on one CPU core at 32 nodes (either
# package): what the runs are balanced over processes by
COST = {"saturation-storm": 5.4, "operator-crash": 4.2,
        "placement-storm": 2.7, "slice-migrate": 2.4,
        "placement-contention": 2.1, "shard-failover": 1.9,
        "upgrade-under-fire": 1.7, "operand-drift": 1.5,
        "chip-degrade": 1.3, "conflict-storm": 1.3, "dag-race": 1.3,
        "apiserver-brownout": 1.2, "watch-flap": 1.1, "node-churn": 1.0,
        "chip-loss": 0.9, "cell-partition": 0.2, "stale-digest": 0.1,
        "split-brain-router": 0.1}


def _halves(scenarios) -> list:
    bins = [[], []]
    for s in sorted(scenarios, key=lambda s: -COST.get(s, 1.0)):
        min(bins, key=lambda b: sum(COST.get(x, 1.0) for x in b)).append(s)
    return [b for b in bins if b]


def start(scenarios) -> list:
    """Start both packages' runs of ``scenarios``, each package's over
    two processes; read them with :func:`verdicts`."""
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(here)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [root, here, os.environ.get("PYTHONPATH", "")]))
    return [(side, subprocess.Popen(
        [sys.executable, os.path.join(here, "torch_chaos_parity.py"),
         side, *part], cwd=root, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True))
        for side in ("ref", "port") for part in _halves(scenarios)]


def verdicts(procs) -> dict:
    """``{"ref": {scenario: verdict}, "port": {...}}`` from :func:`start`."""
    out = {"ref": {}, "port": {}}
    for side, proc in procs:
        stdout, err = proc.communicate(timeout=120)
        if proc.returncode != 0:
            raise RuntimeError(f"{side} runs failed:\n{err[-4000:]}")
        out[side].update(json.loads(stdout))
    return out


def stop(procs) -> None:
    for _, proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


class _Patch:
    """``monkeypatch.setattr`` for a process of its own."""

    @staticmethod
    def setattr(target, name, value):
        setattr(target, name, value)


def _run(side: str, scenarios) -> dict:
    if side == "ref":
        from tpu_operator.chaos import federation as rf
        from tpu_operator.chaos import runner as run

        ref = build(True)
        rf.build_cluster = run.build_cluster = lambda n_tpu: ref(n_tpu)
    else:
        from tpu_operator_torch.chaos import runner as run

        patch_port(_Patch)
    return {s: run.run_scenario(s, nodes=NODES, seed=SEED)
            for s in scenarios}


if __name__ == "__main__":
    json.dump(_run(sys.argv[1], sys.argv[2:]), sys.stdout, sort_keys=True)
