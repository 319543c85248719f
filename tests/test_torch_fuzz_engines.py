"""The reference's property tier for its two from-scratch engines
(``tests/test_fuzz_engines.py``, 13 properties) held on the port's
``render/engine.py`` and ``api/cel.py``. Each drawn example goes through
both packages: each engine fails closed (its own TemplateError or
EvalError, never a raw Python error), each property's oracle holds on
the port, and the two packages' outcomes are equal (the same rendered
string, the same bool, or the same error class), which is stronger than
the property alone.

The reference's example counts and its fixed seed (``derandomize``);
``GPU_FUZZ_EXAMPLES`` (the reference's ``TPU_FUZZ_EXAMPLES``) raises the
count for a deep run."""

import os
import string

import pytest
import yaml
from hypothesis import HealthCheck, given, settings, strategies as st

import torch_naming as N
from test_fuzz_engines import _CEL_TOKENS, _RENDER_DATA, _TEMPLATE_TOKENS
from tpu_operator.api import cel as rcel
from tpu_operator.render import engine as rengine
from tpu_operator_torch.api import cel
from tpu_operator_torch.render import engine

KNOB = N.FUZZ_ENV["TPU_FUZZ_EXAMPLES"]
FUZZ = settings(
    max_examples=int(os.environ.get(KNOB, "60")),
    deadline=None, derandomize=True, database=None,
    suppress_health_check=[HealthCheck.too_slow])


def rendered(mod, src, data):
    """("ok", the output) or ("error", the error class's name); any
    other exception propagates and fails the property."""
    try:
        return "ok", mod.render_string(src, data)
    except mod.TemplateError as e:
        return "error", type(e).__name__


def evaluated(mod, src, self_val, old=None):
    try:
        out = (mod.evaluate(src, self_val) if old is None
               else mod.evaluate(src, self_val, old))
    except mod.EvalError:
        return "error", None
    assert isinstance(out, bool), (src, out)
    return "ok", out


# -- the renderer -------------------------------------------------------------


class TestRendererFuzz:
    @FUZZ
    @given(st.lists(_TEMPLATE_TOKENS, min_size=0, max_size=12))
    def test_token_soup_fails_closed(self, parts):
        src = "".join(parts)
        ours = rendered(engine, src, _RENDER_DATA)
        if ours[0] == "ok":
            assert isinstance(ours[1], str)
        assert ours == rendered(rengine, src, _RENDER_DATA)

    @FUZZ
    @given(st.recursive(
        st.one_of(st.integers(-10**6, 10**6), st.booleans(),
                  st.text(string.ascii_letters + string.digits + " _-",
                          max_size=20)),
        lambda inner: st.one_of(
            st.lists(inner, max_size=4),
            st.dictionaries(st.text(string.ascii_lowercase, min_size=1,
                                    max_size=8), inner, max_size=4)),
        max_leaves=12))
    def test_to_yaml_roundtrip(self, value):
        out = engine.render_string("{{ toYaml .v }}", {"v": value})
        assert yaml.safe_load(out) == value
        assert out == rengine.render_string("{{ toYaml .v }}", {"v": value})

    @FUZZ
    @given(st.text(string.ascii_lowercase, min_size=1, max_size=10))
    def test_missingkey_always_errors(self, key):
        data = {"present": 1}
        src = "{{ .%s }}" % key
        if key == "present":
            assert engine.render_string(src, data) == "1"
        else:
            with pytest.raises(engine.MissingKeyError):
                engine.render_string(src, data)
        assert rendered(engine, src, data) == rendered(rengine, src, data)

    @FUZZ
    @given(st.text(" \t\n", max_size=6),
           st.text(string.ascii_letters, min_size=1, max_size=8))
    def test_trim_markers(self, ws, val):
        for mod in (engine, rengine):
            assert mod.render_string("A" + ws + "{{- .v }}",
                                     {"v": val}) == "A" + val
            assert mod.render_string("{{ .v -}}" + ws + "B",
                                     {"v": val}) == val + "B"

    @FUZZ
    @given(st.lists(_TEMPLATE_TOKENS, min_size=1, max_size=8))
    def test_deterministic(self, parts):
        src = "".join(parts)
        first = rendered(engine, src, _RENDER_DATA)
        assert rendered(engine, src, _RENDER_DATA) == first
        assert rendered(rengine, src, _RENDER_DATA) == first


# -- the mini-CEL -------------------------------------------------------------


class TestCelFuzz:
    @FUZZ
    @given(st.lists(_CEL_TOKENS, min_size=0, max_size=10),
           st.sampled_from([{"x": 1}, {}, "abc", [1, 2], 3, None]))
    def test_token_soup_fails_closed(self, parts, self_val):
        src = " ".join(parts)
        assert evaluated(cel, src, self_val, {"x": 2}) == \
            evaluated(rcel, src, self_val, {"x": 2})

    @FUZZ
    @given(st.lists(st.booleans(), min_size=1, max_size=6),
           st.lists(st.sampled_from(["&&", "||"]), min_size=5, max_size=5),
           st.lists(st.booleans(), min_size=6, max_size=6))
    def test_boolean_precedence_matches_python(self, lits, ops, negs):
        n = len(lits)
        cel_parts, py_parts = [], []
        for i, lit in enumerate(lits):
            cel_parts.append(("!" if negs[i] else "") + str(lit).lower())
            py_parts.append(("not " if negs[i] else "") + str(lit))
            if i < n - 1:
                cel_parts.append(ops[i])
                py_parts.append("and" if ops[i] == "&&" else "or")
        expected = bool(eval(" ".join(py_parts)))  # noqa: S307 - literals
        src = " ".join(cel_parts)
        assert cel.evaluate(src, None) is expected
        assert rcel.evaluate(src, None) is expected

    @FUZZ
    @given(st.integers(-1000, 1000), st.integers(-1000, 1000),
           st.sampled_from(["==", "!=", "<", "<=", ">", ">="]))
    def test_int_comparisons_match_python(self, a, b, op):
        expected = eval(f"{a} {op} {b}")  # noqa: S307 - int literals only
        assert cel.evaluate(f"{a} {op} {b}", None) is expected
        assert rcel.evaluate(f"{a} {op} {b}", None) is expected

    @FUZZ
    @given(st.integers(0, 9), st.lists(st.integers(0, 9), max_size=6))
    def test_in_over_lists_is_membership(self, needle, hay):
        src = f"{needle} in [{', '.join(map(str, hay))}]"
        assert cel.evaluate(src, None) is (needle in hay)
        assert rcel.evaluate(src, None) is (needle in hay)

    @FUZZ
    @given(st.integers(-9, 9), st.integers(1, 9))
    def test_list_commas_mandatory(self, a, b):
        for mod in (cel, rcel):
            with pytest.raises(mod.EvalError):
                mod.evaluate(f"{a} in [{a}-{b}]", None)
            with pytest.raises(mod.EvalError):
                mod.evaluate(f"[{a} {b}] == [{a} {b}]", None)

    @FUZZ
    @given(st.text(string.ascii_lowercase, min_size=1, max_size=6),
           st.text(string.ascii_lowercase, min_size=1, max_size=12))
    def test_in_over_strings_rejected(self, needle, hay):
        for mod in (cel, rcel):
            with pytest.raises(mod.EvalError):
                mod.evaluate(f"'{needle}' in '{hay}'", None)

    @FUZZ
    @given(st.dictionaries(st.sampled_from(["x", "y", "z"]),
                           st.integers(0, 5), max_size=3))
    def test_has_vs_member_access(self, obj):
        for key in ("x", "y"):
            assert cel.evaluate(f"has(self.{key})", obj) is (key in obj)
            if key in obj:
                assert cel.evaluate(f"self.{key} >= 0", obj) is True
            else:
                with pytest.raises(cel.EvalError):
                    cel.evaluate(f"self.{key} >= 0", obj)
            for src in (f"has(self.{key})", f"self.{key} >= 0"):
                assert evaluated(cel, src, obj) == evaluated(rcel, src, obj)

    @FUZZ
    @given(st.one_of(
        st.text(string.ascii_letters, max_size=12),
        st.lists(st.integers(), max_size=6),
        st.dictionaries(st.text(string.ascii_lowercase, min_size=1,
                                max_size=4), st.integers(), max_size=4)))
    def test_size_matches_len(self, val):
        assert cel.evaluate(f"size(self) == {len(val)}", val) is True
        assert rcel.evaluate(f"size(self) == {len(val)}", val) is True
