"""The reference's metrics-docs contract (``tests/test_metrics_docs.py``, 3
tests) held on the port: every ``gpu_operator_*`` name written in
``tpu_operator_torch/OPERATIONS.md``, in ``README.md``'s port section and
in ``PERF.md`` is a series the port registers, every series the port's
``OperatorMetrics`` and node-status exporter register has a row in
``tpu_operator_torch/OPERATIONS.md``, and its series count is current.
One more: the port registers the reference's families, each under the
naming rule (``torch_naming.metric``), with the same type."""

import pathlib
import re

from prometheus_client import CollectorRegistry

import torch_naming as N
from tpu_operator.metrics.operator_metrics import (
    OperatorMetrics as RefOperatorMetrics)
from tpu_operator.validator.metrics import NodeMetrics as RefNodeMetrics
from tpu_operator_torch.metrics.operator_metrics import OperatorMetrics
from tpu_operator_torch.validator.metrics import NodeMetrics

REPO = pathlib.Path(__file__).resolve().parent.parent
DOC = REPO / "tpu_operator_torch" / "OPERATIONS.md"

# a name, then maybe a {...} group (labels, or a brace expansion when the
# name ends in "_"), as the reference's test reads its docs
TOKEN_RE = re.compile(r"(gpu_operator_[a-z0-9_]+)(\{([a-zA-Z0-9_,\s]+)\})?")


def families(operator_metrics, node_metrics):
    """(name, type) of every operator and node-exporter family."""
    reg = CollectorRegistry()
    operator_metrics(registry=reg)
    fams = [(f.name, f.type) for f in reg.collect()]
    node = node_metrics(node_name="doc-parity")
    for attr in vars(node).values():
        if hasattr(attr, "_name") and hasattr(attr, "_type"):
            fams.append((attr._name, attr._type))
    return fams


def registered_families():
    return families(OperatorMetrics, NodeMetrics)


def accepted_sample_names():
    """Every name a doc may use for a registered family."""
    names = set()
    for name, typ in registered_families():
        names.add(name)
        if typ == "counter":
            names.add(name + "_total")
        elif typ == "histogram":
            names.update({name + s for s in ("_bucket", "_sum", "_count")})
    return names


def doc_tokens(text):
    """Every series name a text references, brace groups expanded."""
    out = set()
    for name, _, group in TOKEN_RE.findall(text):
        if name.endswith("_"):
            if not group:
                continue  # a wildcard such as gpu_operator_node_*
            out.update(name + item.strip() for item in group.split(",")
                       if item.strip())
        else:
            out.add(name)  # a {label} group annotates the series
    return out


def readme_port_section():
    text = (REPO / "README.md").read_text()
    start = text.index("## PyTorch/CUDA port")
    end = text.index("\n## ", start + 1)
    return text[start:end]


def test_docs_reference_only_real_series():
    accepted = accepted_sample_names()
    docs = {"tpu_operator_torch/OPERATIONS.md": DOC.read_text(),
            "README.md's port section": readme_port_section(),
            "PERF.md": (REPO / "PERF.md").read_text()}
    assert doc_tokens(docs["tpu_operator_torch/OPERATIONS.md"])
    for where, text in docs.items():
        unknown = sorted(doc_tokens(text) - accepted)
        assert not unknown, (f"{where} names series the port does not "
                             f"register: {unknown}")
    assert "tpu_operator_torch/OPERATIONS.md" in docs[
        "README.md's port section"]


def test_operations_documents_every_operator_series():
    tokens = doc_tokens(DOC.read_text())
    missing = []
    for name, typ in registered_families():
        shown = name + "_total" if typ == "counter" else name
        if shown not in tokens and name not in tokens:
            missing.append(shown)
    assert not missing, ("series the port registers with no row in "
                         f"tpu_operator_torch/OPERATIONS.md: {missing}")


def test_operations_series_count_is_current():
    reg = CollectorRegistry()
    OperatorMetrics(registry=reg)
    n = len(list(reg.collect()))
    m = re.search(r"\((\d+) series:", DOC.read_text())
    assert m, "tpu_operator_torch/OPERATIONS.md lost its '(N series:'"
    assert int(m.group(1)) == n


def test_registered_families_equal_the_references_under_the_rule():
    ref = families(RefOperatorMetrics, RefNodeMetrics)
    ours = registered_families()
    assert len(ours) == len(ref) == 74 + 8
    assert sorted(ours) == sorted((N.metric(name), typ) for name, typ in ref)
