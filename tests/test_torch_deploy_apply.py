"""The port's Helm-verb engine (``deploy/apply.py``), drift report
(``deploy/diff.py``) and lifecycle hooks (``cli/maintenance.py``)
against the JAX package's.

One script runs on each package's FakeClient with that package's
install bundle at default values: apply (create, then configure),
diff (match, drift after a live edit, missing after a delete), delete
with kept kinds, the ready wait with a pending driver CR, and the
maintenance hooks' ``apply_crds`` and ``cleanup`` (a stuck CR keeps the
CRDs). What each step returned is compared under ``torch_naming``'s
map; equality throughout.
"""

import pytest

import torch_naming as N
from tpu_operator.api.clusterpolicy import new_cluster_policy as r_policy
from tpu_operator.api.tpudriver import new_tpu_driver
from tpu_operator.cli import maintenance as rmaint
from tpu_operator.deploy import apply as rapply
from tpu_operator.deploy import diff as rdiff
from tpu_operator.deploy import values as rvm
from tpu_operator.runtime.fake import FakeClient as RFake
from tpu_operator_torch.api.clusterpolicy import new_cluster_policy
from tpu_operator_torch.api.gpudriver import new_gpu_driver
from tpu_operator_torch.cli import maintenance
from tpu_operator_torch.deploy import apply
from tpu_operator_torch.deploy import diff
from tpu_operator_torch.deploy import values as vm
from tpu_operator_torch.runtime.fake import FakeClient
from tpu_operator_torch.runtime.objects import thaw_obj

SIDES = {
    "ref": dict(apply=rapply, diff=rdiff, vm=rvm, maint=rmaint, fake=RFake,
                policy=r_policy, driver=new_tpu_driver),
    "port": dict(apply=apply, diff=diff, vm=vm, maint=maintenance,
                 fake=FakeClient, policy=new_cluster_policy,
                 driver=new_gpu_driver),
}


def _name(kind, name):
    """A reference (kind, name) under the rule."""
    if kind == "CustomResourceDefinition":
        plural = name.partition(".")[0]
        return kind, f"{N.CRD_NAMES.get(plural, plural)}.gpu.graft.dev"
    return N.CRD.get(kind, kind), N.name(name)


def lifecycle(side) -> list:
    a, d, v = side["apply"], side["diff"], side["vm"]
    out = []
    c = side["fake"]()
    docs = v.render_bundle(v.default_values())
    out.append(("apply", [(verb, kind, name) for verb, kind, name in
                          a.apply_docs(c, docs)]))
    out.append(("reapply", sorted({verb for verb, _, _ in
                                   a.apply_docs(c, docs)})))
    res = d.diff_bundle(c, docs)
    out.append(("diff", sorted({r["verdict"] for r in res}),
                d.render_report(res)[1]))
    dep = next(x for x in docs if x["kind"] == "Deployment")
    live = thaw_obj(c.get("apps/v1", "Deployment", dep["metadata"]["name"],
                          dep["metadata"]["namespace"]))
    live["spec"]["replicas"] = 5
    c.update(live)
    c.delete("v1", "ServiceAccount", dep["metadata"]["name"],
             dep["metadata"]["namespace"])
    res = d.diff_bundle(c, docs)
    bad = [(r["verdict"], r["kind"], r["name"]) for r in res
           if r["verdict"] != "match"]
    drift = next(r for r in res if r["verdict"] == "drift")
    out.append(("drift", bad, "replicas: 5" in drift["diff"],
                d.render_report(res)[1]))
    deleted = a.delete_docs(c, docs, keep_kinds=(
        "Namespace", "CustomResourceDefinition"))
    out.append(("deleted", deleted,
                len(c.list("apiextensions.k8s.io/v1",
                           "CustomResourceDefinition"))))
    return out


def test_apply_diff_delete_agree():
    ref, port = lifecycle(SIDES["ref"]), lifecycle(SIDES["port"])
    want = [("apply", [(verb,) + _name(kind, name)
                       for verb, kind, name in ref[0][1]])]
    want += ref[1:3]
    want.append(("drift", [(v,) + _name(k, n) for v, k, n in ref[3][1]],
                 ref[3][2], ref[3][3]))
    want.append(ref[4])
    assert port == want
    assert port[2] == ("diff", ["match"], True)
    assert sorted(v for v, _, _ in port[3][1]) == ["drift", "missing"]


def test_apply_edges():
    c = FakeClient()
    stream = [{"apiVersion": "v1", "kind": "ConfigMap",
               "metadata": {"name": "a", "namespace": "x"}, "spec": {}}]
    assert apply.apply_docs(c, stream) == [("created", "ConfigMap", "a")]
    stream[0]["spec"] = {"k": "v2"}
    assert apply.apply_docs(c, stream) == [("configured", "ConfigMap", "a")]
    assert "resourceVersion" not in stream[0]["metadata"]
    assert apply.delete_docs(c, stream) == 1
    assert apply.delete_docs(c, stream) == 0


def test_cr_create_retries_only_for_a_stream_crd(monkeypatch):
    from tpu_operator_torch.runtime.client import NotFoundError

    calls = []

    class Flaky:
        def get_or_none(self, *a, **kw):
            return None

        def create(self, doc):
            if doc.get("kind") == "CustomResourceDefinition":
                return doc
            calls.append(1)
            if doc["kind"] == "ConfigMap" or len(calls) < 3:
                raise NotFoundError("no matches for kind")
            return doc

    monkeypatch.setattr(apply.time, "sleep", lambda s: None)
    from tpu_operator_torch.api.crd import gpu_driver_crd

    out = apply.apply_docs(Flaky(), [gpu_driver_crd(),
                                     new_gpu_driver("d")])
    assert ("created", "GPUDriver", "d") in out and len(calls) == 3
    calls.clear()
    with pytest.raises(NotFoundError):
        apply.apply_docs(Flaky(), [{"apiVersion": "v1", "kind": "ConfigMap",
                                    "metadata": {"name": "a"}}])
    assert len(calls) == 1


def waits(side) -> list:
    a = side["apply"]
    out = []
    c = side["fake"]()
    out.append(a.wait_policy_ready(c, timeout_s=0.2, poll_s=0.05))
    cr = side["policy"]()
    cr["status"] = {"state": "ready"}
    c.create(cr)
    out.append(a.wait_policy_ready(c, timeout_s=1.0, poll_s=0.05))
    c.create(side["driver"]("pool-a"))
    out.append(a.wait_policy_ready(c, timeout_s=0.2, poll_s=0.05))
    live = thaw_obj(c.list(*_driver_kind(side))[0])
    live["status"] = {"state": "ready"}
    c.update(live)
    out.append(a.wait_policy_ready(c, timeout_s=1.0, poll_s=0.05))
    return out


def _driver_kind(side):
    d = side["driver"]("x")
    return d["apiVersion"], d["kind"]


def test_wait_policy_ready_agrees():
    assert waits(SIDES["port"]) == waits(SIDES["ref"]) == \
        [False, True, False, True]


def hooks(side) -> list:
    m = side["maint"]
    out = []
    c = side["fake"]()
    out.append(m.apply_crds(c))
    crd_kind = ("apiextensions.k8s.io/v1", "CustomResourceDefinition")
    first = sorted(x["metadata"]["name"] for x in c.list(*crd_kind))
    live = thaw_obj(c.list(*crd_kind)[0])
    live["spec"]["versions"][0]["schema"] = {
        "openAPIV3Schema": {"type": "object"}}
    c.update(live)
    out.append(m.apply_crds(c))
    out.append("spec" in c.get(*crd_kind, live["metadata"]["name"])[
        "spec"]["versions"][0]["schema"]["openAPIV3Schema"]["properties"])
    c.create(side["policy"]())
    c.create(side["driver"]("pool-a"))
    out.append(m.cleanup(c, timeout_s=5.0, poll_s=0.01))
    out.append([len(c.list(av, k)) for av, k in m.CR_KINDS])
    out.append(len(c.list(*crd_kind)))

    class Sticky(side["fake"]):
        def delete(self, api_version, kind, name, namespace=None):
            if kind == _driver_kind(side)[1]:
                return None  # a finalizer blocks the delete
            return super().delete(api_version, kind, name, namespace)

    s = Sticky()
    m.apply_crds(s)
    s.create(side["driver"]("pool-a"))
    out.append(m.cleanup(s, timeout_s=0.1, poll_s=0.02))
    out.append(len(s.list(*crd_kind)))
    out.append(m.cleanup(side["fake"](), timeout_s=1.0, poll_s=0.01))
    return out, first


def test_maintenance_hooks_agree():
    (ref, rfirst), (port, first) = hooks(SIDES["ref"]), hooks(SIDES["port"])
    assert port == ref == [3, 3, True, True, [0, 0], 0, False, 3, True]
    assert first == sorted(_name("CustomResourceDefinition", n)[1]
                           for n in rfirst)
    assert maintenance.CR_KINDS == (("gpu.graft.dev/v1", "GPUClusterPolicy"),
                                    ("gpu.graft.dev/v1alpha1", "GPUDriver"))


def test_maintenance_cli_names():
    import pathlib

    root = pathlib.Path(__file__).resolve().parent.parent
    text = (root / "pyproject.toml").read_text()
    for ref, port in N.CLIS.items():
        assert f"{ref} = \"tpu_operator.cli." in text
        assert f"{port} = \"tpu_operator_torch.cli." in text
    assert '"tpu_operator_torch.deploy" = ["values.yaml"]' in text
