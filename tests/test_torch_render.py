"""The port's manifests and render path against the JAX package's: every
operand state of every spec permutation of ``test_golden_render.py``,
rendered live in both packages, gives the same object stream through the
name map of ``torch_naming.py`` (kinds, order, names, namespaces,
nodeSelectors, containers with their commands, args and env, volumes,
tolerations, labels, and each object's hash recomputed after the map);
the template engine's behaviour, errors included; and the dependency DAG
the states compile to."""

import pathlib

import pytest

import torch_naming as N
from test_golden_render import PERMUTATIONS
from tpu_operator import render as rrender
from tpu_operator.api.clusterpolicy import (TPUClusterPolicySpec,
                                            new_cluster_policy as rnew)
from tpu_operator.state import scheduler as rsched
from tpu_operator.state.operands import build_states as rbuild
from tpu_operator.state.state import State as RState
from tpu_operator.state.state import SyncContext as RCtx
from tpu_operator.utils.hash import object_hash as rhash
from tpu_operator_torch import render
from tpu_operator_torch.api.clusterpolicy import (GPUClusterPolicySpec,
                                                  new_cluster_policy)
from tpu_operator_torch.state import scheduler
from tpu_operator_torch.state.operands import MANIFESTS_ROOT, build_states
from tpu_operator_torch.state.state import State, SyncContext
from tpu_operator_torch.utils.hash import object_hash

REF_STATES = rbuild()
STATES = build_states()


def contexts(name):
    """(reference, port) render contexts of one permutation, the port's
    spec the reference's through the map."""
    rp = rnew(spec=PERMUTATIONS[name])
    pp = new_cluster_policy(spec=N.spec(PERMUTATIONS[name]))
    return (RCtx(client=None, policy=rp, spec=TPUClusterPolicySpec.from_obj(rp),
                 namespace="tpu-operator"),
            SyncContext(client=None, policy=pp,
                        spec=GPUClusterPolicySpec.from_obj(pp),
                        namespace="gpu-operator"))


def test_states_keep_order_edges_and_the_label_sets():
    assert [s.name for s in STATES] == [N.name(s.name) for s in REF_STATES]
    for r, p in zip(REF_STATES, STATES):
        assert p.requires() == [N.name(x) for x in r.requires()]
        assert p.watch_sources() == r.watch_sources()
    from tpu_operator_torch.api import labels as L

    # the deploy labels select the states the manifests are rendered for
    assert set(L.ALL_DEPLOY_STATES) <= {s.name for s in STATES}
    assert sorted(p.name for p in MANIFESTS_ROOT.iterdir()) == sorted(
        f"state-{s.name}" for s in STATES)


@pytest.mark.parametrize("state", range(len(STATES)),
                         ids=[s.name for s in STATES])
@pytest.mark.parametrize("perm", sorted(PERMUTATIONS))
def test_rendered_objects_match_through_the_map(perm, state):
    rctx, pctx = contexts(perm)
    ref, port = REF_STATES[state], STATES[state]
    assert port.enabled(pctx) == ref.enabled(rctx)
    if not ref.enabled(rctx):
        return
    mapped = [N.obj(o) for o in ref.render(rctx)]
    ours = port.render(pctx)
    assert [(o["kind"], o["metadata"]["name"]) for o in ours] == [
        (o["kind"], o["metadata"]["name"]) for o in mapped]
    assert ours == mapped
    assert [object_hash(o) for o in ours] == [rhash(o) for o in mapped]
    assert port.sweep_kinds() == ref.sweep_kinds()


def _validator_containers(objects):
    ds = next(o for o in objects if o["kind"] == "DaemonSet")
    pod = ds["spec"]["template"]["spec"]
    return pod["initContainers"] + pod["containers"]


def test_custom_validation_dir_reaches_no_container_env():
    """C3, kept: with hostPaths.validationDir set, both packages mount the
    host dir at that path in every validator container, and no container
    carries the env var the validator reads for its directory
    (TPU_VALIDATION_DIR / GPU_VALIDATION_DIR), so the proofs write their
    barrier files under the default dir inside each container."""
    rctx, pctx = contexts("custom-hostpaths")
    ref = next(s for s in REF_STATES if s.name == "operator-validation")
    port = next(s for s in STATES if s.name == "operator-validation")
    for objects, var in ((ref.render(rctx), "TPU_VALIDATION_DIR"),
                         (port.render(pctx), "GPU_VALIDATION_DIR")):
        ctrs = _validator_containers(objects)
        assert len(ctrs) == 8
        for ctr in ctrs:
            mounts = {m["name"]: m["mountPath"] for m in ctr["volumeMounts"]}
            assert mounts["validations"] == "/var/run/tpu/v"
            assert var not in {e["name"] for e in ctr.get("env") or []}


def test_validator_chain_carries_the_gate_from_the_spec():
    _, pctx = contexts("validator-tuned")
    port = next(s for s in STATES if s.name == "operator-validation")
    ctrs = {c["name"]: c for c in _validator_containers(port.render(pctx))}
    assert list(ctrs) == ["driver-validation", "cuda-validation",
                          "nvlink-validation", "hbm-validation",
                          "dcn-validation", "gpu-operator-validator"]
    env = {e["name"]: e.get("value") for e in ctrs["nvlink-validation"]["env"]}
    assert env["NVLINK_THRESHOLD"] == "0.9"
    env = {e["name"]: e.get("value") for e in ctrs["cuda-validation"]["env"]}
    assert (env["MATMUL_SIZE"], env["NVLINK_THRESHOLD"]) == ("16384", "0.9")


# -- the template engine: each case through both engines ---------------------

ENGINE_CASES = {
    "field": ("v={{ .A.B }}", {"A": {"B": 3}}),
    "if-true": ("{{ if .On }}yes{{ else }}no{{ end }}", {"On": True}),
    "if-empty-list": ("{{ if .On }}yes{{ else }}no{{ end }}", {"On": []}),
    "else-if": ("{{ if eq .X 1 }}one{{ else if eq .X 2 }}two{{ else }}"
                "many{{ end }}", {"X": 2}),
    "range": ("{{ range .Items }}{{ . }}:{{ $.Sep }} {{ end }}",
              {"Items": [1, 2], "Sep": ";"}),
    "quote": ('{{ .N | quote }}', {"N": "ab"}),
    "default": ('{{ default "d" .M }}', {"M": None}),
    "pipes": ('{{ .S | upper | quote }}', {"S": "x"}),
    "toyaml-nindent": ("sel:{{ .Sel | toYaml | nindent 2 }}",
                       {"Sel": {"app": "x", "tier": "db"}}),
    "trim-markers": ("a\n{{- if .On }}\nb\n{{- end }}\nc", {"On": False}),
    "comment": ("a{{/* hidden */}}b", {}),
    "nested": ("{{ range .P }}{{ if .on }}[{{ .name }}]{{ end }}{{ end }}",
               {"P": [{"on": True, "name": "a"}, {"on": False, "name": "b"}]}),
    "and-or-not": ("{{ if and .A (not .B) }}y{{ else }}n{{ end }}"
                   "{{ if or .B .A }}y{{ end }}", {"A": 1, "B": ""}),
    "pipe-in-parens": ('{{ default (.X | upper) .Y }}', {"X": "fb", "Y": None}),
    "bool": ("{{ .B }}", {"B": True}),
    "printf-ternary": ('{{ printf "%s-%d" .A .B }}{{ ternary "a" "b" .C }}',
                       {"A": "x", "B": 7, "C": True}),
    "missing-key": ("{{ .A.Missing }}", {"A": {}}),
    "unbalanced-end": ("{{ end }}", {}),
    "unclosed-if": ("{{ if .X }}a", {"X": 1}),
    "else-outside-if": ("{{ else }}", {}),
    "bad-token": ("{{ .A @ }}", {"A": 1}),
    "pipe-into-value": ("{{ .A | .B }}", {"A": 1, "B": 2}),
    "unknown-token": ("{{ bogus }}", {}),
    "unbalanced-paren": ("{{ (eq .A 1 }}", {"A": 1}),
    "function-without-call": ("{{ eq (quote) }}", {}),
}


def _outcome(mod, source, data):
    try:
        return "ok", mod.render_string(source, data, name="t")
    except Exception as e:  # noqa: BLE001 — the class and text are compared
        return type(e).__name__, str(e)


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_matches_the_reference(case):
    source, data = ENGINE_CASES[case]
    assert _outcome(render, source, data) == _outcome(rrender, source, data)


@pytest.mark.parametrize("case", ["order", "conditional", "invalid-yaml",
                                  "no-kind", "missing-dir", "empty-dir"])
def test_renderer_matches_the_reference(case, tmp_path):
    files = {
        "order": {"0200_b.yaml": "apiVersion: v1\nkind: ConfigMap\n"
                                 "metadata:\n  name: {{ .Name }}-b\n",
                  "0100_a.yaml": "apiVersion: v1\nkind: ServiceAccount\n"
                                 "metadata:\n  name: {{ .Name }}-a\n"},
        "conditional": {"0100_opt.yaml": "{{ if .On }}\napiVersion: v1\n"
                        "kind: ConfigMap\nmetadata:\n  name: opt\n{{ end }}\n"},
        "invalid-yaml": {"0100_bad.yaml": "kind: [unclosed\n"},
        "no-kind": {"0100_x.yaml": "metadata:\n  name: x\n"},
        "missing-dir": None,
        "empty-dir": {},
    }[case]
    d = tmp_path / "state"
    if files is not None:
        d.mkdir()
        for fname, text in files.items():
            (d / fname).write_text(text)
    data = {"Name": "x", "On": True}

    def outcome(mod):
        try:
            return "ok", mod.Renderer(d).render_objects(data)
        except Exception as e:  # noqa: BLE001
            return type(e).__name__, str(e).splitlines()[0].replace(
                str(d), "<dir>")

    assert outcome(render) == outcome(rrender)


# -- the DAG ------------------------------------------------------------------


def test_dag_plan_matches_the_reference():
    ref = rsched.DagPlan.build(REF_STATES)
    ours = scheduler.DagPlan.build(STATES)
    assert ours.levels == tuple(tuple(N.name(n) for n in wave)
                                for wave in ref.levels)
    assert ours.order == tuple(N.name(n) for n in ref.order)
    assert ours.critical_path == tuple(N.name(n) for n in ref.critical_path)
    assert ours.requires == {N.name(k): tuple(N.name(x) for x in v)
                             for k, v in ref.requires.items()}


def _stubs(base, graph):
    class Stub(base):
        def __init__(self, name, requires):
            self.name, self._requires = name, requires

        def requires(self):
            return self._requires

    return [Stub(n, r) for n, r in graph]


GRAPHS = {
    "cycle": [("a", ["c"]), ("b", ["a"]), ("c", ["b"])],
    "two-cycle": [("a", ["b"]), ("b", ["a"])],
    "unknown": [("a", ["ghost"])],
    "duplicate": [("x", None), ("x", None)],
    "undeclared-chain": [("a", None), ("b", None), ("c", None)],
    "mixed": [("a", None), ("b", []), ("c", ["a"]), ("d", [])],
}


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_dag_errors_and_plans_match_the_reference(graph):
    def outcome(sched, base):
        try:
            plan = sched.DagPlan.build(_stubs(base, GRAPHS[graph]))
            return "ok", plan.levels, plan.critical_path
        except Exception as e:  # noqa: BLE001
            return type(e).__name__, str(e)

    assert outcome(scheduler, State) == outcome(rsched, RState)


def test_serial_walk_and_virtual_mode_match_the_reference():
    import random

    graph = GRAPHS["mixed"]
    for seed in range(4):
        ours, ref = [], []
        scheduler.run_plan(scheduler.DagPlan.build(_stubs(State, graph)),
                           ours.append, rng=random.Random(seed))
        rsched.run_plan(rsched.DagPlan.build(_stubs(RState, graph)),
                        ref.append, rng=random.Random(seed))
        assert ours == ref


def test_manifests_name_no_tpu_agent():
    """Every manifest of the port: no reference command, env or path."""
    text = "\n".join(p.read_text() for p in
                     sorted(pathlib.Path(MANIFESTS_ROOT).rglob("*.yaml")))
    for token in ("tpu-validator", "libtpu", "ICI_THRESHOLD", "-c\", \"jax",
                  "google.com/tpu", "/run/tpu", "TPU_"):
        assert token not in text, token
