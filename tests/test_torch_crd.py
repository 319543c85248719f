"""The port's CRD schemas, CEL evaluator and offline validation
(``api/crd.py``, ``api/cel.py``, ``api/validate.py``) against the JAX
package's.

The reference's admission cases (``tests/test_cel_admission.py``) run on
both packages where the rule exists on both sides, the CRs mapped by
``torch_naming.spec``; equality of verdicts and messages throughout.
The rules the port changes get tests of their own: the core proofs are
``driver``/``cuda``/``nvlink``/``plugin``; the driver CRD has no
``channel`` (its immutability, enum and ``custom`` rules are dropped),
``driverType`` stays immutable and ``driverVersion`` mutable; a
SliceRequest's topology is a fabric, never a TPU grid.
"""

import copy
import json

import pytest

import torch_naming as N
from tpu_operator.api import cel as rcel
from tpu_operator.api import crd as rcrd
from tpu_operator.api import validate as rval
from tpu_operator.api.clusterpolicy import new_cluster_policy as r_policy
from tpu_operator.api.tpudriver import new_tpu_driver
from tpu_operator_torch.api import cel, crd, validate
from tpu_operator_torch.api.clusterpolicy import new_cluster_policy
from tpu_operator_torch.api.gpudriver import new_gpu_driver

# CEL expressions over (self, oldSelf): both evaluators must agree on the
# value or on raising
EXPRESSIONS = [
    ("1 < 2", None, None), ("'a' != 'b'", None, None),
    ("true == false", None, None), ("2.5 >= 2", None, None),
    ("self.a.b == 3", {"a": {"b": 3}}, None),
    ("self.a.missing == 3", {"a": {}}, None),
    ("has(self.a)", {"a": 1}, None), ("has(self.a)", {}, None),
    ("has(self.a.b)", {"a": {}}, None), ("has(self.a)", {"a": None}, None),
    ("self.missing == 1 || true", {}, None),
    ("true || self.missing == 1", {}, None),
    ("self.missing == 1 || false", {}, None),
    ("self.missing == 1 && false", {}, None),
    ("self.missing == 1 && true", {}, None),
    ("'a' in ['a', 'b']", None, None), ("'z' in ['a', 'b']", None, None),
    ("'k' in self", {"k": 1}, None), ("size(self.xs) == 2", {"xs": [1, 2]},
                                      None),
    ("'a' in 'abc'", None, None),
    ("self == oldSelf", "x", "x"), ("self == oldSelf", "x", "y"),
    ("-self.n < 0", {"n": 3}, None), ("!(self.n > 2)", {"n": 3}, None),
    ("self ==", None, None), ("self @ 1", None, None),
    ("self + 1 > 0", 3, None),
]


def _outcome(mod, rule, new, old):
    try:
        return ("value", mod.evaluate(rule, new, old))
    except mod.EvalError as e:
        return ("error", str(e))


@pytest.mark.parametrize("case", range(len(EXPRESSIONS)))
def test_cel_evaluator_agrees(case):
    rule, new, old = EXPRESSIONS[case]
    assert _outcome(cel, rule, new, old) == _outcome(rcel, rule, new, old)
    assert cel.references_old_self(rule) == rcel.references_old_self(rule)


def test_cel_schema_walk_agrees():
    schema = {
        "type": "object",
        "x-kubernetes-validations": [
            {"rule": "!has(self.a) || self.a != 'bad'",
             "message": "a must not be bad"}],
        "properties": {
            "a": {"type": "string"},
            "b": {"type": "string", "x-kubernetes-validations": [
                {"rule": "self == oldSelf", "message": "b is immutable"}]},
            "c": {"type": "integer", "x-kubernetes-validations": [
                {"rule": "self + 1 > 0", "message": "bad"}]},
        },
    }
    for new, old in (({"a": "ok"}, None), ({"a": "bad"}, None),
                     ({"b": "x"}, None), ({"b": "x"}, {"b": "x"}),
                     ({"b": "y"}, {"b": "x"}), ({"c": 3}, None)):
        assert cel.schema_cel_errors(new, old, schema) == \
            rcel.schema_cel_errors(new, old, schema)


def _spec_schema(c):
    return c["spec"]["versions"][0]["schema"]["openAPIV3Schema"][
        "properties"]["spec"]


def _rename(tree, fields):
    """A reference schema's property names under the spec-field map."""
    if isinstance(tree, dict):
        return {(fields.get(k, k) if isinstance(v, dict) else k):
                _rename(v, fields) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rename(v, fields) for v in tree]
    return tree


def test_crd_names_follow_the_rule():
    ref = {c["spec"]["names"]["kind"]: c for c in rcrd.all_crds()}
    port = {c["spec"]["names"]["kind"]: c for c in crd.all_crds()}
    assert set(port) == {N.CRD.get(k, k) for k in ref}
    for kind, c in ref.items():
        p = port[N.CRD.get(kind, kind)]
        names = c["spec"]["names"]
        assert p["spec"]["names"] == {
            "kind": N.CRD.get(kind, kind),
            "plural": N.CRD_NAMES.get(names["plural"], names["plural"]),
            "singular": N.CRD_NAMES.get(names["singular"],
                                        names["singular"]),
            "shortNames": [N.CRD_NAMES.get(s, s)
                           for s in names["shortNames"]]}
        assert p["metadata"]["name"] == \
            f"{p['spec']['names']['plural']}.gpu.graft.dev"
        assert p["spec"]["scope"] == c["spec"]["scope"]
        (rv,), (pv,) = c["spec"]["versions"], p["spec"]["versions"]
        assert pv["name"] == rv["name"]
        assert pv["subresources"] == rv["subresources"]
        # the status schemas carry no TPU fact
        assert pv["schema"]["openAPIV3Schema"]["properties"]["status"] == \
            rv["schema"]["openAPIV3Schema"]["properties"]["status"]


def test_cluster_policy_crd_rules_over_the_ports_proofs():
    assert crd.CORE_PROOFS == tuple(N.ARGS.get(p, p)
                                    for p in rcrd.CORE_PROOFS)
    ref, port = _spec_schema(rcrd.cluster_policy_crd()), \
        _spec_schema(crd.cluster_policy_crd())
    want = json.loads(json.dumps(ref["x-kubernetes-validations"])
                      .replace("'jax'", "'cuda'").replace(".jax", ".cuda")
                      .replace("jax-ready", "cuda-ready")
                      .replace("'ici'", "'nvlink'").replace(".ici",
                                                            ".nvlink")
                      .replace("ici-ready", "nvlink-ready"))
    assert port["x-kubernetes-validations"] == want
    # the CRD's spec schema is the reference's under the spec-field map
    # wherever the two specs have the same fields
    renamed = _rename(ref, N.SPEC_FIELDS)
    assert set(port["properties"]) == set(renamed["properties"])


def test_driver_crd_drops_the_channel_rules():
    ref, port = _spec_schema(rcrd.tpu_driver_crd()), \
        _spec_schema(crd.gpu_driver_crd())
    assert "channel" not in port["properties"]
    assert "x-kubernetes-validations" not in port
    dt = port["properties"]["driverType"]
    assert dt["enum"] == ["driver", "host"] and dt["default"] == "driver"
    assert [r["rule"] for r in dt["x-kubernetes-validations"]] == \
        [r["rule"] for r in ref["properties"]["driverType"][
            "x-kubernetes-validations"]]
    assert "x-kubernetes-validations" not in port["properties"][
        "driverVersion"]
    assert port["properties"]["imagePullPolicy"]["enum"] == \
        ref["properties"]["imagePullPolicy"]["enum"]
    cols = crd.gpu_driver_crd()["spec"]["versions"][0][
        "additionalPrinterColumns"]
    assert cols[-1] == {"name": "DriverVersion", "type": "string",
                        "jsonPath": ".spec.driverVersion"}


@pytest.mark.parametrize("topology,ok", [
    ("mnnvl", True), ("mnnvl-4", True), ("nvswitch-8", True),
    ("nvlink-2", True), ("pcie", True), ("pcie-1", True),
    ("2x4", False), ("4x4x4", False), ("infiniband", False),
    ("nvswitch-", False), ("", True)])
def test_slicerequest_topology_pattern(topology, ok):
    import re

    schema = _spec_schema(crd.slice_request_crd())
    pattern = schema["properties"]["topology"]["pattern"]
    assert pattern == crd.TOPOLOGY_PATTERN
    if topology:
        assert bool(re.fullmatch(pattern, topology)) == ok
    spec = {"chips": 0, "topology": topology}
    errs = cel.schema_cel_errors(spec, None, schema)
    assert bool(errs) == (topology == "")
    if errs:
        assert errs == [".: request must name chips > 0 or a topology "
                        "fabric"]


def test_slicerequest_crd_rules_otherwise_the_references():
    ref = _spec_schema(rcrd.slice_request_crd())
    port = _spec_schema(crd.slice_request_crd())
    assert {k: v for k, v in port["properties"]["chips"].items()
            if k != "description"} == \
        {k: v for k, v in ref["properties"]["chips"].items()
         if k != "description"}
    for spec in ({"chips": 4}, {"chips": 0}, {}):
        want = rcel.schema_cel_errors(spec, None, ref)
        for a, b in N.CRD_TEXT:
            want = [e.replace(a, b) for e in want]
        assert cel.schema_cel_errors(spec, None, port) == want


# policies, each a reference spec (the port's by torch_naming.spec)
POLICIES = {
    "empty": {},
    "core-driver-off": {"validator": {"driver": {"enabled": False}}},
    "core-jax-off": {"validator": {"jax": {"enabled": False}}},
    "core-ici-off": {"validator": {"ici": {"enabled": False}}},
    "core-plugin-off": {"validator": {"plugin": {"enabled": False}}},
    "aux-hbm-off": {"validator": {"hbm": {"enabled": False}}},
    "aux-dcn-runtime-off": {"validator": {"dcn": {"enabled": False},
                                          "runtime": {"enabled": False}}},
    "unknown-field": {"devicePlugin": {"bogus": 1}},
    "wrong-type": {"validator": {"matmulSize": "big"}},
    "enum": {"sandboxWorkloads": {"enabled": "yes"}},
    "image-resolves": {"devicePlugin": {"repository": "r.io/x",
                                        "image": "p", "version": "v1"}},
    "image-unresolved": {"devicePlugin": {"image": "p"}},
    "digest": {"devicePlugin": {"repository": "r.io/x", "image": "p",
                                "version": "sha256:" + "ab" * 32}},
}


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_validate_cluster_policy_agrees(name, monkeypatch):
    for var in ("DEVICE_PLUGIN_IMAGE",):
        monkeypatch.delenv(var, raising=False)
    spec = POLICIES[name]
    rerrs, rkind = rval.validate_cr(r_policy(spec=copy.deepcopy(spec)))
    errs, kind = validate.validate_cr(new_cluster_policy(
        spec=N.spec(copy.deepcopy(spec))))
    assert kind == N.name(rkind)
    want = [N.name(e).replace("'jax'", "'cuda'").replace("jax-ready",
                                                          "cuda-ready")
            .replace("'ici'", "'nvlink'").replace("ici-ready",
                                                  "nvlink-ready")
            for e in rerrs]
    assert errs == want
    assert bool(errs) == (name.startswith("core-") or name in (
        "unknown-field", "wrong-type", "enum", "image-unresolved"))


# driver CRs on both sides where the fields exist on both
DRIVERS = {
    "empty": ({}, {}),
    "host": ({"driverType": "host"}, {"driverType": "host"}),
    "driver-type-typo": ({"driverType": "libtpux"},
                         {"driverType": "driverx"}),
    "pull-policy-typo": ({"imagePullPolicy": "Sometimes"},
                         {"imagePullPolicy": "Sometimes"}),
    "selector": ({"nodeSelector": {"p": "a"}}, {"nodeSelector": {"p": "a"}}),
    "unknown-field": ({"bogus": 1}, {"bogus": 1}),
}


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_validate_driver_agrees(name):
    rspec, spec = DRIVERS[name]
    rerrs, _ = rval.validate_cr(new_tpu_driver("d", spec=rspec))
    errs, kind = validate.validate_cr(new_gpu_driver("d", spec=spec))
    assert kind == "GPUDriver"
    assert len(errs) == len(rerrs)
    assert [e.split(":")[0] for e in errs] == \
        [e.split(":")[0] for e in rerrs]


def test_driver_rules_of_the_port():
    # no channel: its `custom` and enum rules are gone with it
    errs, _ = validate.validate_cr(new_gpu_driver("d", spec={
        "channel": "custom"}))
    assert errs == ["/spec/channel: unknown field"]
    # driverType is immutable, driverVersion is the rollout's knob
    schema = crd.gpu_driver_crd()["spec"]["versions"][0]["schema"][
        "openAPIV3Schema"]
    old = {"spec": {"driverVersion": "580.1"}}
    new = {"spec": {"driverVersion": "580.2"}}
    assert validate.admission_errors(new, copy.deepcopy(old), schema) == []
    assert new["spec"]["driverType"] == "driver"        # defaulted
    flip = {"spec": {"driverType": "host"}}
    assert validate.admission_errors(flip, copy.deepcopy(old), schema) == [
        "/spec/driverType: driverType is immutable — create a new "
        "GPUDriver resource instead"]
    # apiVersion and name are checked as the reference checks them
    bad = new_gpu_driver("", spec={})
    bad["apiVersion"] = "gpu.graft.dev/v1"
    errs, _ = validate.validate_cr(bad)
    assert errs[:2] == ["apiVersion: want gpu.graft.dev/v1alpha1, got "
                        "gpu.graft.dev/v1", "metadata.name: required"]
    assert validate.validate_cr({"kind": "Pod"}) == (
        ["unsupported kind 'Pod'"], "Pod")


def test_schema_defaults_apply_alike():
    ref = _spec_schema(rcrd.cluster_policy_crd())
    port = _spec_schema(crd.cluster_policy_crd())
    for spec in ({}, {"validator": {}}, {"upgradePolicy": {}},
                 {"validator": {"hbm": {}}, "hostPaths": {}}):
        r = rval.apply_schema_defaults(copy.deepcopy(spec), ref)
        p = validate.apply_schema_defaults(N.spec(copy.deepcopy(spec)), port)
        assert p == N.spec(r)


class TestApiserverAdmission:
    """``kubectl apply``-shaped rejection through the mock apiserver,
    with its admission gate running the port's ``admission_errors``
    over the port's CRDs."""

    @pytest.fixture()
    def client(self, monkeypatch):
        import mock_apiserver
        from mock_apiserver import MockApiServer

        from tpu_operator_torch.runtime.kubeclient import (
            HTTPClient,
            KubeConfig,
        )

        def admission(handler, coll_path, new, old):
            schema = handler.st.schema_for_collection(coll_path)
            return [] if schema is None else \
                validate.admission_errors(new, old, schema)

        monkeypatch.setattr(mock_apiserver._Handler, "_admission", admission)
        srv = MockApiServer().start()
        client = HTTPClient(KubeConfig(server=srv.url, token="t",
                                       namespace="default"))
        for c in crd.all_crds():
            client.create(c)
        try:
            yield client
        finally:
            client.close()
            srv.stop()

    def test_core_proof_disable_bounces_with_422(self, client):
        from tpu_operator_torch.runtime.client import InvalidError

        for proof in crd.CORE_PROOFS:
            with pytest.raises(InvalidError,
                               match=f"core proof '{proof}'"):
                client.create(new_cluster_policy(spec={
                    "validator": {proof: {"enabled": False}}}))
        assert client.list("gpu.graft.dev/v1", "GPUClusterPolicy") == []
        client.create(new_cluster_policy(spec={
            "validator": {"hbm": {"enabled": False}}}))
        assert len(client.list("gpu.graft.dev/v1", "GPUClusterPolicy")) == 1

    def test_driver_type_immutable_driver_version_mutable(self, client):
        from tpu_operator_torch.runtime.client import InvalidError

        av = "gpu.graft.dev/v1alpha1"
        client.create(new_gpu_driver("pool-a", spec={}))
        live = client.get(av, "GPUDriver", "pool-a")
        assert live["spec"]["driverType"] == "driver"   # defaulted
        live["spec"]["driverVersion"] = "580.159.03"
        client.update(live)
        client.patch(av, "GPUDriver", "pool-a",
                     {"spec": {"driverVersion": "580.160.01"}})
        assert client.get(av, "GPUDriver", "pool-a")["spec"][
            "driverVersion"] == "580.160.01"
        with pytest.raises(InvalidError, match="driverType is immutable"):
            client.patch(av, "GPUDriver", "pool-a",
                         {"spec": {"driverType": "host"}})
        with pytest.raises(InvalidError):
            client.create(new_gpu_driver("pool-b", spec={
                "imagePullPolicy": "Sometimes"}))

    def test_slicerequest_rule_bounces(self, client):
        """An empty request bounces on the CEL rule. The topology
        ``pattern`` rides in the stored CRD for a real apiserver; the
        offline gate checks types, enums and CEL, as the reference's
        does."""
        from tpu_operator_torch.api.slicerequest import new_slice_request
        from tpu_operator_torch.runtime.client import InvalidError

        client.create(new_slice_request("ok", spec={
            "chips": 4, "topology": "nvswitch"}))
        with pytest.raises(InvalidError, match="topology fabric"):
            client.create(new_slice_request("empty", spec={"chips": 0}))
        stored = client.get("apiextensions.k8s.io/v1",
                            "CustomResourceDefinition",
                            "slicerequests.gpu.graft.dev")
        assert _spec_schema(stored)["properties"]["topology"][
            "pattern"] == crd.TOPOLOGY_PATTERN
