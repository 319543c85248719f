"""``gpuop-cfg`` offline (``cli/gpuop_cfg.py``) against the JAX
package's ``tpuop-cfg``: ``validate``, ``generate``, ``dag``, ``place``
and the renderers behind ``trace``, ``cache``, ``snapshot``, ``why``,
``slo``, ``quota`` and ``top``.

Each subcommand runs on both CLIs with inputs mapped by
``torch_naming``; exit codes are equal, and outputs equal under the map
(a renderer fed the same JSON prints the same text). The manager-backed
subcommands fetch from a live port Manager's health port, and the
reference's renderer is fed what they fetched. ``place`` holds the
port's GPU fleet fixture (an ``mnnvl-4`` pool in nodepools of four
hosts) against the reference's worker-labelled ``1x16`` TPU slices,
which the two placement models score alike.
"""

import json

import pytest
import yaml

import torch_naming as N
from tpu_operator.cli import tpuop_cfg as rcfg
from tpu_operator_torch.cli import gpuop_cfg as cfg


def write(tmp_path, name, doc):
    p = tmp_path / name
    p.write_text(yaml.safe_dump(doc))
    return str(p)


def run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


# (reference spec, reference kind) -> the port's by the rule
VALIDATE = {
    "valid": ({"validator": {"matmulSize": 2048}}, "TPUClusterPolicy"),
    "unknown-field": ({"libtpu": {"instalDir": "/x"}}, "TPUClusterPolicy"),
    "wrong-type": ({"validator": {"matmulSize": "big"}}, "TPUClusterPolicy"),
    "incomplete-image": ({"libtpu": {"repository": "gcr.io/x"}},
                         "TPUClusterPolicy"),
    "core-proof-off": ({"validator": {"ici": {"enabled": False}}},
                       "TPUClusterPolicy"),
    "driver": ({"driverType": "host"}, "TPUDriver"),
}


@pytest.mark.parametrize("case", sorted(VALIDATE))
def test_validate_agrees(case, tmp_path, capsys, monkeypatch):
    monkeypatch.delenv("DRIVER_IMAGE", raising=False)
    monkeypatch.delenv("LIBTPU_IMAGE", raising=False)
    spec, kind = VALIDATE[case]
    what = "clusterpolicy" if kind == "TPUClusterPolicy" else None
    rdoc = {"apiVersion": "tpu.graft.dev/v1" if what else
            "tpu.graft.dev/v1alpha1", "kind": kind,
            "metadata": {"name": "p"}, "spec": spec}
    doc = {"apiVersion": N.name(rdoc["apiVersion"]), "kind": N.name(kind),
           "metadata": {"name": "p"}, "spec": N.spec(spec)}
    rrc, rout, rerr = run(rcfg.main, ["validate", what or "tpudriver", "-f",
                                      write(tmp_path, "r.yaml", rdoc)],
                          capsys)
    rc, out, err = run(cfg.main, ["validate", what or "gpudriver", "-f",
                                  write(tmp_path, "p.yaml", doc)], capsys)
    assert rc == rrc
    for a, b in N.CRD.items():
        rout = rout.replace(a, b)
    assert out == rout
    assert [line.split(":")[0] for line in err.splitlines()] == \
        [N.name(line.split(":")[0]).replace("libtpu", "driver")
         for line in rerr.splitlines()]


def test_validate_refusals(tmp_path, capsys):
    f = write(tmp_path, "p.yaml", {"apiVersion": "gpu.graft.dev/v1",
                                   "kind": "GPUClusterPolicy",
                                   "metadata": {"name": "p"}, "spec": {}})
    rc, _, err = run(cfg.main, ["validate", "gpudriver", "-f", f], capsys)
    assert rc == 1 and "requires kind GPUDriver" in err
    (tmp_path / "bad.yaml").write_text("a: [\n")
    rc, _, err = run(cfg.main, ["validate", "clusterpolicy", "-f",
                                str(tmp_path / "bad.yaml")], capsys)
    assert rc == 1 and "invalid YAML" in err
    rc, _, err = run(cfg.main, ["validate", "clusterpolicy", "-f",
                                str(tmp_path / "none.yaml")], capsys)
    assert rc == 1 and "cannot read" in err


@pytest.mark.parametrize("target", ["crds", "operator", "all", "bundle",
                                    "cleanup"])
def test_generate_agrees(target, capsys):
    rrc, rout, _ = run(rcfg.main, ["generate", target], capsys)
    rc, out, _ = run(cfg.main, ["generate", target], capsys)
    assert rc == rrc == 0
    rkinds = [N.CRD.get(d.get("kind"), d.get("kind"))
              for d in yaml.safe_load_all(rout) if d]
    docs = [d for d in yaml.safe_load_all(out) if d]
    assert [d.get("kind") for d in docs] == rkinds
    text = yaml.safe_dump_all(docs)
    for word in ("tpu.graft.dev", "tpu-operator", "libtpu",
                 "google.com/tpu"):
        assert word not in text, word


def test_generate_with_values_and_errors(tmp_path, capsys):
    vals = write(tmp_path, "v.yaml", {"namespace": "gpu-sys", "gpuDrivers": [
        {"name": "h100", "spec": {"driverVersion": "580.159.03",
                                  "nodeSelector": {"p": "a"}}}]})
    rc, out, _ = run(cfg.main, ["generate", "all", "--values", vals], capsys)
    docs = list(yaml.safe_load_all(out))
    assert rc == 0
    assert [d["metadata"]["name"] for d in docs
            if d["kind"] == "GPUDriver"] == ["h100"]
    assert {d["metadata"].get("namespace") for d in docs
            if d["kind"] == "Deployment"} == {"gpu-sys"}
    bad = write(tmp_path, "b.yaml", {"clusterPolicy": {"spec": {
        "validator": {"cuda": {"enabled": False}}}}})
    rc, _, err = run(cfg.main, ["generate", "all", "--values", bad], capsys)
    assert rc == 1 and "core proof 'cuda'" in err
    rc, out, _ = run(cfg.main, ["generate", "helm-chart", "--dir",
                                str(tmp_path / "chart")], capsys)
    assert rc == 0 and "templates/gpudrivers.yaml" in out.split()
    rc, _, _ = run(cfg.main, ["generate", "helm-chart", "-n", "x"], capsys)
    assert rc == 2
    rc, out, _ = run(cfg.main, ["generate", "bundle", "--dir",
                                str(tmp_path / "bundle")], capsys)
    assert rc == 0 and "manifests/gpu-operator.clusterserviceversion.yaml" \
        in out.split()


def test_dag_agrees(capsys):
    rrc, rout, _ = run(rcfg.main, ["dag", "-o", "json"], capsys)
    rc, out, _ = run(cfg.main, ["dag", "-o", "json"], capsys)
    assert rc == rrc == 0
    ref, port = json.loads(rout), json.loads(out)
    assert port == N.obj(ref)
    rc, text, _ = run(cfg.main, ["dag"], capsys)
    assert rc == 0 and text.splitlines()[-1] == \
        "critical path: " + " -> ".join(port["critical_path"])


# a worker-labelled 1x16 TPU slice of four hosts <-> an mnnvl-4 nodepool of
# four GB200 hosts (the fastest generation of each table), plus
# single-host pools: TPU v6e 2x2 hosts <-> nvswitch-4 GB200 hosts
FLEETS = (
    {"pools": [{"accelerator": "tpu-v6e-slice", "topology": "1x16",
                "chips": 4, "count": 8},
               {"accelerator": "tpu-v6e-slice", "topology": "2x2",
                "chips": 4, "count": 3}]},
    {"pools": [{"accelerator": "nvidia-gb200", "topology": "mnnvl-4",
                "chips": 4, "count": 8, "hosts": 4},
               {"accelerator": "nvidia-gb200", "topology": "nvswitch-4",
                "chips": 4, "count": 3}]},
)


@pytest.mark.parametrize("chips", [4, 8, 16, 32])
def test_place_scores_agree(chips, tmp_path, capsys):
    rfleet = write(tmp_path, "r.yaml", FLEETS[0])
    fleet = write(tmp_path, "p.yaml", FLEETS[1])
    rrc, rout, _ = run(rcfg.main, ["place", "--fleet", rfleet, "--chips",
                                   str(chips), "--top", "0", "-o", "json"],
                       capsys)
    rc, out, _ = run(cfg.main, ["place", "--fleet", fleet, "--chips",
                                str(chips), "--top", "0", "-o", "json",
                                "--index-stats"], capsys)
    assert rc == rrc
    ref, port = json.loads(rout), json.loads(out)
    assert [(c["chips"], len(c["nodes"]), c["score"], c["breakdown"])
            for c in port["candidates"]] == \
        [(c["chips"], len(c["nodes"]), c["score"], c["breakdown"])
         for c in ref["candidates"]]
    assert port["index_stats"]["agrees_with_rescan"] is True
    if port["candidates"]:
        best = port["candidates"][0]
        assert best["generation"] == "gb200"
    else:
        assert "NVLink domain" in port["reason"] or port["reason"]


def test_place_fixture_is_gke_gpu_nodes(tmp_path, capsys):
    from tpu_operator_torch.api import labels as L

    nodes = cfg._fixture_nodes(FLEETS[1])
    assert len(nodes) == 11
    gb = nodes[0]["metadata"]["labels"]
    assert gb == {L.GKE_ACCELERATOR: "nvidia-gb200",
                  L.GKE_ACCELERATOR_COUNT: "4", L.GPU_PRODUCT: "NVIDIA-GB200",
                  L.GPU_TOPOLOGY: "mnnvl-4",
                  L.GKE_NODEPOOL: "gb200-mnnvl-4-np0"}
    assert nodes[4]["metadata"]["labels"][L.GKE_NODEPOOL] == \
        "gb200-mnnvl-4-np1"
    assert L.GKE_NODEPOOL not in nodes[8]["metadata"]["labels"]
    assert nodes[8]["status"]["allocatable"] == {L.GPU_RESOURCE: "4"}
    # an NVL72 domain by default: 72 cards over 4 a host
    big = cfg._fixture_nodes({"pools": [{"accelerator": "nvidia-gb200",
                                         "topology": "mnnvl-4",
                                         "count": 19}]})
    assert {n["metadata"]["labels"][L.GKE_NODEPOOL] for n in big} == \
        {"gb200-mnnvl-4-np0", "gb200-mnnvl-4-np1"}
    fleet = write(tmp_path, "p.yaml", FLEETS[1])
    rc, out, _ = run(cfg.main, ["place", "--fleet", fleet, "--chips", "12",
                                "--explain", "--top", "2"], capsys)
    assert rc == 0 and "12 cards on 3 host(s)" in out
    rc, out, _ = run(cfg.main, ["place", "--fleet", fleet, "--chips", "64"],
                     capsys)
    assert rc == 1 and out.splitlines()[-1].startswith("UNSCHEDULABLE")
    rc, _, err = run(cfg.main, ["place", "--fleet", write(
        tmp_path, "bad.yaml", {"x": 1}), "--chips", "4"], capsys)
    assert rc == 2 and "INVALID fleet fixture" in err


@pytest.fixture(scope="module")
def live_manager():
    """A port Manager on its health port after one reconcile of the
    default policy on a FakeClient with one GPU node."""
    from tpu_operator_torch.api.clusterpolicy import new_cluster_policy
    from tpu_operator_torch.cli.operator import (
        FAKE_NODE_ALLOCATABLE,
        FAKE_NODE_LABELS,
    )
    from tpu_operator_torch.controllers.clusterpolicy_controller import (
        ClusterPolicyReconciler,
    )
    from tpu_operator_torch.runtime import CachedClient, FakeClient, Manager
    from tpu_operator_torch.runtime.tracing import TRACER, TracingClient

    TRACER.enabled = True
    fake = FakeClient()
    fake.add_node("gpu-node-0", labels=FAKE_NODE_LABELS,
                  allocatable=FAKE_NODE_ALLOCATABLE)
    fake.create(new_cluster_policy())
    api = TracingClient(CachedClient(fake))
    mgr = Manager(api, health_port=0)
    mgr.add_reconciler(ClusterPolicyReconciler(client=api,
                                               namespace="gpu-operator"))
    mgr.start()
    # the notReady pass requeues in 5 s: idle up to that horizon
    assert mgr.wait_idle(timeout=10.0, horizon=1.0)
    try:
        yield f"http://127.0.0.1:{mgr._http.server_address[1]}"
    finally:
        mgr.stop()


RENDERED = {
    # subcommand argv, its debug path
    "trace": (["trace", "--limit", "2"], "/debug/traces"),
    "cache": (["cache"], "/debug/cache"),
    "snapshot": (["snapshot"], "/debug/snapshot"),
    "why": (["why", "GPUClusterPolicy/gpu-cluster-policy"],
            "/debug/timeline?kind=GPUClusterPolicy&name=gpu-cluster-policy"),
    "slo": (["slo"], "/debug/slo"),
    "quota": (["quota"], "/debug/quota"),
}


@pytest.mark.parametrize("name", sorted(RENDERED))
def test_manager_views_render_alike(name, live_manager, tmp_path, capsys):
    import urllib.request

    argv, path = RENDERED[name]
    rc, out, err = run(cfg.main, argv + ["--url", live_manager], capsys)
    with urllib.request.urlopen(live_manager + path, timeout=10) as r:
        payload = json.load(r)
    f = tmp_path / "payload.json"
    f.write_text(json.dumps(payload))
    rrc, rout, _ = run(rcfg.main, argv + ["-f", str(f)], capsys)
    prc, pout, _ = run(cfg.main, argv + ["-f", str(f)], capsys)
    assert (prc, pout) == (rrc, rout)
    # a live `why` reads one object's timeline, its -f form a whole
    # must-gather snapshot
    if name != "why":
        assert rc == prc and out == pout, err


def test_top_renders_the_gpu_rollup(tmp_path, capsys):
    from test_torch_fleet import digest, nodes
    from tpu_operator.metrics import fleet as rfleet
    from tpu_operator_torch.metrics import fleet

    pairs = [nodes(f"n{i}", dig=digest("fail" if i == 0 else "ok", 3),
                   nodepool="" if i else "pool-a",
                   condition="False" if i == 1 else None)
             for i in range(3)]
    roll = fleet.rollup_nodes([p for _, p in pairs])
    rroll = rfleet.rollup_nodes([r for r, _ in pairs])
    f, rf = tmp_path / "f.json", tmp_path / "r.json"
    f.write_text(json.dumps(roll))
    rf.write_text(json.dumps(rroll))
    rrc, rout, _ = run(rcfg.main, ["top", "-f", str(rf)], capsys)
    rc, out, _ = run(cfg.main, ["top", "-f", str(f)], capsys)
    assert rc == rrc == 2
    assert out.splitlines()[0] == rout.splitlines()[0].replace(
        "TPU nodes", "GPU nodes").replace("chips", "cards")
    assert sorted(line.split()[0] for line in out.splitlines()[2:]) == \
        ["h100-sxm-nvswitch-4", "pool-a"]
    assert "h100-sxm" in out and "<< WORST" in out
    rc, out, _ = run(cfg.main, ["top", "-f", str(f), "-o", "json"], capsys)
    assert rc == 2 and json.loads(out) == roll
    rc, _, err = run(cfg.main, ["top", "-f", str(tmp_path / "no.json")],
                     capsys)
    assert rc == 1 and "cannot read" in err


def test_cells_waits_for_federation(capsys, tmp_path):
    """``cells`` reads a router's report (a file, or a bundle's
    ``federation/cells.json``) and renders what the reference's renders;
    an Open breaker exits 2, an unreadable report 1."""
    from tpu_operator.federation.router import GlobalRouter as RRouter
    from tpu_operator_torch.federation.router import GlobalRouter

    reports = []
    for router in (RRouter, GlobalRouter):
        r = router(["east", "west"], now=lambda: 30.0,
                   failure_threshold=1)
        r.record_failure("west")
        reports.append({"cells": {"east": {"requests": [
            {"name": "a1", "phase": "Placed", "chips": 8}], "chips": 8}},
            "unrouted": [{"name": "q1", "phase": "Pending", "chips": 4}],
            "router": r.report()})
    assert reports[0] == reports[1]
    bundle = tmp_path / "bundle" / "federation"
    bundle.mkdir(parents=True)
    (bundle / "cells.json").write_text(json.dumps(reports[1]))
    rrc, rout, _ = run(rcfg.main, ["cells", "-f", str(bundle.parent)],
                       capsys)
    rc, out, _ = run(cfg.main, ["cells", "-f", str(bundle.parent)], capsys)
    assert (rc, out) == (rrc, rout) == (2, rout)
    assert "open breakers: west" in out and "q1" in out
    rc, out, _ = run(cfg.main, ["cells", "-f", str(bundle / "cells.json"),
                                "-o", "json"], capsys)
    assert rc == 2 and json.loads(out) == reports[1]
    rc, _, err = run(cfg.main, ["cells", "-f", str(tmp_path / "no.json")],
                     capsys)
    assert rc == 1 and "cannot read" in err
