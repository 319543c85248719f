"""The port's FakeClient against the JAX package's over the same verb
sequences: every result equal (uids, random in both, aside), every error
of the matching class, and the watch events in the same order. The port's
reconcile catches the port's own NotFoundError and ConflictError, so it
needs a fake that raises them."""

import pytest

from tpu_operator.runtime import client as rclient
from tpu_operator.runtime import fake as rfake
from tpu_operator_torch.runtime import client, fake, kubeclient


def scrub(value):
    """A result with the random uids dropped, as plain data."""
    if isinstance(value, dict):
        return {k: scrub(v) for k, v in value.items() if k != "uid"}
    if isinstance(value, list):
        return [scrub(v) for v in value]
    return value


def ds(name, gen_labels=None, selector=None):
    return {"apiVersion": "apps/v1", "kind": "DaemonSet",
            "metadata": {"name": name, "namespace": "ops",
                         "labels": dict(gen_labels or {})},
            "spec": {"template": {"metadata": {"labels": {"app": name}},
                                  "spec": {"nodeSelector": selector or {}}}}}


# each step: (verb, args...); a step's outcome is its scrubbed result or
# its error's class name
SEQUENCES = {
    "create-get-list": [
        ("add_node", "n1", {"a": "1"}, {"nvidia.com/gpu": "2"}),
        ("add_node", "n2", {"a": "2"}, None),
        ("create", ds("x", {"team": "a"})),
        ("get", "apps/v1", "DaemonSet", "x", "ops"),
        ("list", "v1", "Node", None),
        ("list", "v1", "Node", {"a": "2"}),
        ("list", "apps/v1", "DaemonSet", {"matchExpressions": [
            {"key": "team", "operator": "In", "values": ["a"]}]}),
        ("get", "v1", "Node", "ghost", None),
    ],
    "create-twice": [
        ("create", ds("x")),
        ("create", ds("x")),
    ],
    "update-and-conflict": [
        ("create", ds("x")),
        ("update_spec", "x", {"template": {"spec": {"nodeSelector":
                                                    {"k": "v"}}}}, "1"),
        ("update_spec", "x", {"paused": True}, "1"),      # stale RV
        ("update_spec", "x", {"paused": True}, None),      # no RV: wins
        ("update_spec", "ghost", {}, None),
        ("get", "apps/v1", "DaemonSet", "x", "ops"),
    ],
    "no-op-update": [
        ("create", ds("x")),
        ("update_spec", "x", ds("x")["spec"], None),
        ("get", "apps/v1", "DaemonSet", "x", "ops"),
    ],
    "patch": [
        ("add_node", "n1", {"a": "1", "b": "2"}, None),
        ("patch", "v1", "Node", "n1", {"metadata": {"labels": {
            "a": None, "c": "3"}}}),
        ("patch", "v1", "Node", "n1", {"metadata": {"labels": {"c": "3"}}}),
        ("patch", "v1", "Node", "ghost", {"metadata": {}}),
    ],
    "status": [
        ("create", ds("x")),
        ("update_status", "x", {"numberReady": 1}),
        ("update_status", "x", {"numberReady": 1}),
        ("get", "apps/v1", "DaemonSet", "x", "ops"),
    ],
    "delete-and-gc": [
        ("create", ds("x")),
        ("create_owned_pod", "p", "x"),
        ("delete", "apps/v1", "DaemonSet", "x", "ops"),
        ("get", "v1", "Pod", "p", "ops"),
        ("delete", "apps/v1", "DaemonSet", "x", "ops"),
    ],
    "kubelet": [
        ("add_node", "n1", {"gpu": "yes"}, None),
        ("add_node", "n2", {}, None),
        ("create", ds("x", selector={"gpu": "yes"})),
        ("create", ds("y")),
        ("simulate_kubelet", False, False),
        ("list", "v1", "Pod", None),
        ("simulate_kubelet", True, False),
        ("get", "apps/v1", "DaemonSet", "x", "ops"),
        ("simulate_kubelet", True, True),
        ("get", "apps/v1", "DaemonSet", "y", "ops"),
        ("simulate_pod_phase", "x-n1", "ops", "Succeeded"),
        ("get", "v1", "Pod", "x-n1", "ops"),
    ],
    "pages": [
        ("add_node", "n1", {}, None), ("add_node", "n2", {}, None),
        ("add_node", "n3", {}, None),
        ("page", 2, None), ("page", 2, "/n2"),
    ],
}


def run(mod, cmod, steps):
    c = mod.FakeClient()
    events = []
    c.watch("apps/v1", "DaemonSet", lambda e: events.append(
        (e.type, e.obj["metadata"]["name"])))
    out = []
    for verb, *args in steps:
        try:
            if verb == "add_node":
                res = c.add_node(args[0], labels=args[1], allocatable=args[2])
            elif verb == "list":
                opts = cmod.ListOptions(label_selector=args[2]) \
                    if args[2] is not None else None
                res = c.list(args[0], args[1], opts)
            elif verb == "page":
                res = c.list("v1", "Node", cmod.ListOptions(
                    limit=args[0], continue_=args[1]))
                res = [list(res), getattr(res, "continue_", None)]
            elif verb == "update_spec":
                obj = mod.thaw_obj(c.get_or_none("apps/v1", "DaemonSet",
                                                 args[0], "ops")
                                   or ds(args[0]))
                obj["spec"] = args[1]
                if args[2] is None:
                    obj["metadata"].pop("resourceVersion", None)
                else:
                    obj["metadata"]["resourceVersion"] = args[2]
                res = c.update(obj)
            elif verb == "update_status":
                obj = mod.thaw_obj(c.get("apps/v1", "DaemonSet", args[0],
                                         "ops"))
                obj["status"] = args[1]
                res = c.update_status(obj)
            elif verb == "create_owned_pod":
                owner = c.get("apps/v1", "DaemonSet", args[1], "ops")
                res = c.create({"apiVersion": "v1", "kind": "Pod",
                                "metadata": {"name": args[0],
                                             "namespace": "ops",
                                             "ownerReferences": [{
                                                 "uid": owner["metadata"]
                                                 ["uid"]}]}})
            elif verb == "simulate_kubelet":
                res = c.simulate_kubelet(ready=args[0], stale_hash=args[1])
            elif verb == "simulate_pod_phase":
                res = c.simulate_pod_phase(*args)
            else:
                res = getattr(c, verb)(*args)
            out.append(("ok", scrub(res)))
        except Exception as e:  # noqa: BLE001 — the class is compared
            out.append((type(e).__name__, getattr(e, "code", None)))
    return out, events, c.reset_verb_counts()


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_verbs_match_the_reference(name):
    ours = run(fake, client, SEQUENCES[name])
    ref = run(rfake, rclient, SEQUENCES[name])
    assert ours == ref


@pytest.mark.parametrize("cls", ["ApiError", "NotFoundError",
                                 "AlreadyExistsError", "ConflictError",
                                 "InvalidError", "TooManyRequestsError",
                                 "ServerUnavailableError", "WatchGoneError"])
def test_error_classes_and_codes(cls):
    ours, ref = getattr(client, cls), getattr(rclient, cls)
    assert ours.code == ref.code
    assert [b.__name__ for b in ours.__mro__] == [b.__name__
                                                  for b in ref.__mro__]


def test_one_error_hierarchy():
    """The in-cluster client raises the same classes the fake does."""
    assert kubeclient.ApiError is client.ApiError
    assert kubeclient.NotFoundError is client.NotFoundError


def test_frozen_reads_refuse_mutation():
    from tpu_operator_torch.runtime.objects import FrozenObjectError

    c = fake.FakeClient()
    node = c.add_node("n1")
    with pytest.raises(FrozenObjectError):
        node["metadata"]["labels"]["x"] = "y"


def test_merge_patch_matches_the_reference():
    base = {"a": {"b": 1, "c": 2}, "d": [1, 2], "e": "x"}
    patch = {"a": {"b": None, "f": {"g": None, "h": 1}}, "d": [3], "e": None}
    assert client.merge_patch(base, patch) == rclient.merge_patch(base, patch)
