"""The port's install surface (``deploy/values.py`` with its own
``values.yaml``, ``deploy/packaging.py``, ``deploy/helmchart.py``,
``deploy/csv.py``) and its chart ``deployments/gpu-operator/``.

Three proofs, as the reference's ``tests/test_helm_chart.py`` makes for
its own chart: the committed chart is exactly what ``write_chart``
emits, the chart's values are the canonical ``values.yaml``, and
chart-render equals ``render_bundle`` across a values matrix, rendered
with the port's ``render/engine.py`` (no helm binary). Against the
reference the comparison is structural, not bytes: the same kinds, the
same templates and the same hooks under ``torch_naming``'s map. At
default values the bundle's GPUClusterPolicy is ``new_cluster_policy()``
exactly, and it validates against the port's CRDs.
"""

import copy

import pytest
import yaml

import torch_naming as N
from tpu_operator.deploy import csv as rcsv
from tpu_operator.deploy import helmchart as rhelm
from tpu_operator.deploy import packaging as rpack
from tpu_operator.deploy import values as rvm
from tpu_operator_torch.api.clusterpolicy import (
    GPUClusterPolicySpec,
    new_cluster_policy,
)
from tpu_operator_torch.deploy import csv
from tpu_operator_torch.deploy import helmchart as helm
from tpu_operator_torch.deploy import packaging as pack
from tpu_operator_torch.deploy import values as vm


def _key(d):
    return (d.get("apiVersion", ""), d.get("kind", ""),
            (d.get("metadata") or {}).get("namespace", ""),
            (d.get("metadata") or {}).get("name", ""))


def _assert_stream_equal(chart_docs, bundle_docs, context):
    # helm owns the release namespace (--create-namespace); the chart
    # ships no Namespace object while the plain-apply bundle does
    bundle_docs = [d for d in bundle_docs if d.get("kind") != "Namespace"]
    ck = {_key(d): d for d in chart_docs}
    bk = {_key(d): d for d in bundle_docs}
    assert set(ck) == set(bk), (
        f"{context}: chart-only={sorted(set(ck) - set(bk))} "
        f"bundle-only={sorted(set(bk) - set(ck))}")
    for k in sorted(ck):
        assert ck[k] == bk[k], f"{context}: object {k} differs"


def test_default_values_render_new_cluster_policy():
    cr = vm.render_cluster_policy(vm.default_values())
    assert cr == new_cluster_policy(spec=cr["spec"])
    assert GPUClusterPolicySpec.from_obj(cr).to_obj() == \
        GPUClusterPolicySpec.from_obj(new_cluster_policy()).to_obj()
    # the spec states the defaults and nothing else
    assert cr["spec"] == GPUClusterPolicySpec.from_obj(
        new_cluster_policy()).to_obj()
    from tpu_operator_torch.api.validate import validate_cr

    assert validate_cr(cr) == ([], "GPUClusterPolicy")


def test_values_keys_follow_the_rule():
    ref, port = rvm.default_values(), vm.default_values()
    assert set(port) == {N.VALUES_KEYS.get(k, k) for k in ref}
    assert vm.TOP_LEVEL_KEYS == {N.VALUES_KEYS.get(k, k)
                                 for k in rvm.TOP_LEVEL_KEYS}
    assert port["namespace"] == N.name(ref["namespace"])
    assert port["operator"] == dict(N.obj(ref["operator"]),
                                    repository=N.IMAGE_REPOSITORY[1])
    # every spec key the reference's values set is a spec key here
    assert set(port["clusterPolicy"]["spec"]) == {
        N.SPEC_FIELDS.get(k, k) for k in ref["clusterPolicy"]["spec"]}


def test_load_values_merges_and_rejects(tmp_path):
    f = tmp_path / "v.yaml"
    f.write_text("operator: {replicas: 3}\nbogus: 1\n")
    for mod in (rvm, vm):
        with pytest.raises(ValueError, match="unknown top-level keys"):
            mod.load_values(str(f))
    f.write_text("operator: {replicas: 3}\ngpuDrivers: [{name: a}]\n")
    vals = vm.load_values(str(f))
    assert vals["operator"]["replicas"] == 3
    assert vals["operator"]["image"] == "gpu-operator"
    assert [d["metadata"]["name"] for d in vm.render_gpu_drivers(vals)] == \
        ["a"]
    for bad, match in (([{"name": "a"}, {"name": "a"}], "duplicate"),
                       ([{"name": "a"}, {"name": "b"}], "omit nodeSelector"),
                       ([{"spec": {}}], "needs a name"),
                       ([{"name": "a", "spec": {"driverType": "x"}}],
                        "invalid GPUDriver")):
        with pytest.raises(ValueError, match=match):
            vm.render_gpu_drivers({"gpuDrivers": bad})


def test_bundle_kinds_and_names_follow_the_rule():
    ref = rvm.render_bundle(rvm.default_values())
    port = vm.render_bundle(vm.default_values())
    assert [N.CRD.get(d["kind"], d["kind"]) for d in ref] == \
        [d["kind"] for d in port]
    rnames = [N.CRD_NAMES.get(d["metadata"]["name"].split(".")[0],
                              d["metadata"]["name"].split(".")[0])
              if d["kind"] == "CustomResourceDefinition"
              else N.name(d["metadata"]["name"]) for d in ref]
    names = [d["metadata"]["name"].split(".")[0]
             if d["kind"] == "CustomResourceDefinition"
             else d["metadata"]["name"] for d in port]
    assert names == rnames
    # the RBAC grants the same verbs on the renamed resources
    for rdoc, doc in zip(ref, port):
        if rdoc["kind"] in ("ClusterRole", "Role"):
            assert doc["rules"] == [
                {**r, "apiGroups": [g.replace("tpu.graft.dev",
                                              "gpu.graft.dev")
                                    for g in r["apiGroups"]],
                 "resources": [N.CRD_NAMES.get(x.split("/")[0],
                                               x.split("/")[0])
                               + x[len(x.split("/")[0]):]
                               for x in r["resources"]]}
                for r in rdoc["rules"]]
    dep = next(d for d in port if d["kind"] == "Deployment")
    ctr = dep["spec"]["template"]["spec"]["containers"][0]
    assert ctr["command"][0] == "gpu-operator"
    assert ctr["image"] == "ghcr.io/gpu-operator/gpu-operator:v0.1.0"


def test_hooks_and_generate_targets():
    vals = vm.deep_merge(vm.default_values(),
                         {"operator": {"upgradeCRD": True}})
    docs = vm.render_bundle(vals)
    job = next(d for d in docs if d["kind"] == "Job")
    assert job["spec"]["template"]["spec"]["containers"][0]["command"] == \
        ["gpu-operator-maintenance", "apply-crds"]
    cleanup = vm.render_cleanup(vals)
    assert [d["kind"] for d in cleanup] == \
        [d["kind"] for d in rvm.render_cleanup(rvm.default_values())]
    assert cleanup[-1]["spec"]["template"]["spec"]["containers"][0][
        "command"] == ["gpu-operator-maintenance", "cleanup"]
    rules = cleanup[1]["rules"][0]
    assert rules["resources"] == ["gpuclusterpolicies", "gpudrivers"]
    for what in ("crds", "operator", "all"):
        assert [d["kind"] for d in pack.generate(what)] == \
            [N.CRD.get(d["kind"], d["kind"]) for d in rpack.generate(what)]
    sample = pack.sample_cluster_policy()
    assert GPUClusterPolicySpec.from_obj(sample).to_obj() == \
        GPUClusterPolicySpec.from_obj(new_cluster_policy()).to_obj()
    with pytest.raises(ValueError):
        pack.generate("bogus")


def test_committed_chart_matches_generator():
    """``gpuop-cfg generate helm-chart`` is the only edit path."""
    files = helm.generate_chart()
    committed = {p.relative_to(helm.CHART_DIR).as_posix(): p.read_text()
                 for p in helm.CHART_DIR.rglob("*") if p.is_file()}
    assert set(files) == set(committed), sorted(set(files) ^ set(committed))
    for rel in files:
        assert files[rel] == committed[rel], f"{rel} drifted"
    assert (helm.CHART_DIR / "values.yaml").read_text() == \
        vm.VALUES_FILE.read_text()
    assert helm.CHART_DIR.name == "gpu-operator"
    meta = yaml.safe_load((helm.CHART_DIR / "Chart.yaml").read_text())
    assert meta["apiVersion"] == "v2" and meta["name"] == "gpu-operator"


def test_chart_structure_follows_the_reference():
    ref, port = rhelm.generate_chart(), helm.generate_chart()
    assert set(port) == {N.CHART_FILES.get(f, f) for f in ref}
    for rel in ref:
        assert ref[rel].count("helm.sh/hook:") == \
            port[N.CHART_FILES.get(rel, rel)].count("helm.sh/hook:"), rel
    # the same kinds and the same hooks, every hook on
    over = {"operator": {"upgradeCRD": True, "cleanupCRD": True}}
    rdocs = rhelm.render_chart(values=copy.deepcopy(over))
    docs = helm.render_chart(values=copy.deepcopy(over))
    assert sorted(d["kind"] for d in docs) == \
        sorted(N.CRD.get(d["kind"], d["kind"]) for d in rdocs)

    def hooks(stream):
        return sorted((d["kind"], d["metadata"]["annotations"][
            "helm.sh/hook"]) for d in stream
            if (d.get("metadata") or {}).get("annotations", {}).get(
                "helm.sh/hook"))

    assert hooks(docs) == hooks(rdocs)


def test_crds_dir_matches_generated_crds():
    from tpu_operator_torch.api.crd import all_crds

    committed = []
    for p in sorted((helm.CHART_DIR / "crds").glob("*.yaml")):
        committed.extend(yaml.safe_load_all(p.read_text()))
    by_name = {c["metadata"]["name"]: c for c in committed if c}
    for c in all_crds():
        assert by_name[c["metadata"]["name"]] == c


def test_csv_follows_the_reference(tmp_path):
    ref = rcsv.render_csv(rvm.default_values())
    port = csv.render_csv(vm.default_values())
    assert set(port) == set(ref)
    assert set(port["spec"]) == set(ref["spec"])
    assert port["metadata"]["name"] == N.name(ref["metadata"]["name"]
                                              .split(".v")[0]) + ".v0.1.0"
    owned = port["spec"]["customresourcedefinitions"]["owned"]
    assert [o["name"] for o in owned] == [
        o["name"].replace("tpuclusterpolicies", "gpuclusterpolicies")
        .replace("tpudrivers", "gpudrivers").replace("tpu.graft.dev",
                                                     "gpu.graft.dev")
        for o in ref["spec"]["customresourcedefinitions"]["owned"]]
    strategy = port["spec"]["install"]["spec"]
    assert strategy["clusterPermissions"][0]["rules"] == \
        pack.cluster_role()["rules"]
    text = yaml.safe_dump(port)
    for word in ("tpu", "TPU", "libtpu", "jax", "ICI"):
        assert word not in text, word
    examples = yaml.safe_load(port["metadata"]["annotations"][
        "alm-examples"])
    from tpu_operator_torch.api.validate import validate_cr

    for ex in examples[:2]:
        assert validate_cr(ex)[0] == [], ex["kind"]
    written = csv.write_bundle_dir(vm.default_values(), str(tmp_path))
    assert written == [p.replace("tpu-operator", "gpu-operator")
                       .replace("tpu.graft.dev_tpu", "gpu.graft.dev_gpu")
                       .replace("tpu.graft.dev", "gpu.graft.dev")
                       for p in rcsv.write_bundle_dir(
                           rvm.default_values(), str(tmp_path / "ref"))]
    assert len(csv.render_bundle_stream(vm.default_values())) == 5
