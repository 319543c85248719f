"""Mini-CEL evaluator for CRD ``x-kubernetes-validations`` rules.

The port's own copy of ``tpu_operator/api/cel.py``: it holds no TPU
fact.

The reference bakes CEL XValidation rules into its CRDs so invalid or
forbidden spec transitions bounce at ``kubectl apply`` instead of sitting
NotReady (api/nvidia/v1alpha1/nvidiadriver_types.go:40-186). Kubernetes
evaluates those rules inside the apiserver; this module is the
admission-time evaluator for this framework's CRDs — used by the offline
``gpuop-cfg validate`` path and by the e2e mock apiserver, so the same
rule text is enforced in both places.

Supported subset (everything the operator's CRDs emit, plus the common
admission shapes): ``||  &&  !  ==  !=  <  <=  >  >=  in``, unary
minus, member access, ``has(...)``, ``size(...)``,
string/int/float/bool/null literals, and parentheses. CEL semantics that matter for admission are
kept: accessing an absent field is an evaluation error, ``has()`` is the
presence test, transition rules (any rule mentioning ``oldSelf``) apply
only to UPDATE, and a rule that errors at runtime REJECTS the write
(fail closed, like the apiserver).
"""

from __future__ import annotations

import re
from typing import Any, List, Optional

__all__ = ["EvalError", "evaluate", "references_old_self",
           "schema_cel_errors"]


class EvalError(Exception):
    """Runtime evaluation failure (absent field, bad operand types)."""


_TOKEN_RE = re.compile(r"""
    \s*(?:
      (?P<num>\d+\.\d+|\d+)
    | (?P<str>'(?:[^'\\]|\\.)*'|"(?:[^"\\]|\\.)*")
    | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
    | (?P<op>\|\||&&|==|!=|<=|>=|[!<>().,\[\]-])
    )""", re.VERBOSE)

_ABSENT = object()


def _tokenize(src: str) -> List[tuple]:
    out, pos = [], 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if m is None or m.end() == pos:
            rest = src[pos:].strip()
            if not rest:
                break
            raise EvalError(f"cannot tokenize at {rest[:20]!r}")
        pos = m.end()
        if m.group("num") is not None:
            text = m.group("num")
            out.append(("num", float(text) if "." in text else int(text)))
        elif m.group("str") is not None:
            body = m.group("str")[1:-1]
            out.append(("str", re.sub(r"\\(.)", r"\1", body)))
        elif m.group("ident") is not None:
            out.append(("ident", m.group("ident")))
        else:
            out.append(("op", m.group("op")))
    return out


class _Parser:
    """Recursive descent over the token list; precedence (low->high):
    || ; && ; ==/!=/in/relational ; unary ! ; member access/calls."""

    def __init__(self, tokens: List[tuple]):
        self.toks = tokens
        self.i = 0

    def peek(self) -> Optional[tuple]:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def take(self, kind=None, value=None) -> tuple:
        tok = self.peek()
        if tok is None or (kind and tok[0] != kind) or \
                (value is not None and tok[1] != value):
            raise EvalError(f"unexpected token {tok!r}, wanted "
                            f"{value or kind}")
        self.i += 1
        return tok

    def parse(self):
        node = self.parse_or()
        if self.peek() is not None:
            raise EvalError(f"trailing tokens at {self.peek()!r}")
        return node

    def parse_or(self):
        node = self.parse_and()
        while self.peek() == ("op", "||"):
            self.take()
            node = ("or", node, self.parse_and())
        return node

    def parse_and(self):
        node = self.parse_cmp()
        while self.peek() == ("op", "&&"):
            self.take()
            node = ("and", node, self.parse_cmp())
        return node

    _CMP = {"==", "!=", "<", "<=", ">", ">="}

    def parse_cmp(self):
        node = self.parse_unary()
        tok = self.peek()
        if tok is not None and tok[0] == "op" and tok[1] in self._CMP:
            self.take()
            return ("cmp", tok[1], node, self.parse_unary())
        if tok == ("ident", "in"):
            self.take()
            return ("in", node, self.parse_unary())
        return node

    def parse_unary(self):
        if self.peek() == ("op", "!"):
            self.take()
            return ("not", self.parse_unary())
        if self.peek() == ("op", "-"):  # CEL unary minus (negative literals)
            self.take()
            return ("neg", self.parse_unary())
        return self.parse_postfix()

    def parse_postfix(self):
        node = self.parse_primary()
        while True:
            if self.peek() == ("op", "."):
                self.take()
                name = self.take("ident")[1]
                node = ("member", node, name)
            else:
                return node

    _LITERALS = {"true": True, "false": False, "null": None}

    def parse_primary(self):
        tok = self.peek()
        if tok is None:
            raise EvalError("unexpected end of expression")
        if tok[0] in ("num", "str"):
            self.take()
            return ("lit", tok[1])
        if tok == ("op", "("):
            self.take()
            node = self.parse_or()
            self.take("op", ")")
            return node
        if tok == ("op", "["):
            self.take()
            items = []
            while self.peek() != ("op", "]"):
                items.append(self.parse_or())
                if self.peek() == ("op", ","):
                    self.take()
                elif self.peek() != ("op", "]"):
                    # commas are mandatory: without this, "[1-2]" (binary
                    # minus, unsupported here) silently parses as the
                    # two-element list [1, -2] instead of failing closed
                    raise EvalError(
                        f"expected ',' or ']' in list, got {self.peek()!r}")
            self.take("op", "]")
            return ("list", items)
        if tok[0] == "ident":
            self.take()
            name = tok[1]
            if name in self._LITERALS:
                return ("lit", self._LITERALS[name])
            if self.peek() == ("op", "("):  # has(...) / size(...)
                self.take()
                arg = self.parse_or()
                self.take("op", ")")
                return ("call", name, arg)
            return ("var", name)
        raise EvalError(f"unexpected token {tok!r}")


def _truthy(v: Any) -> bool:
    if not isinstance(v, bool):
        raise EvalError(f"non-boolean in boolean context: {v!r}")
    return v


def _eval(node, env: dict) -> Any:
    op = node[0]
    if op == "lit":
        return node[1]
    if op == "list":
        return [_eval(n, env) for n in node[1]]
    if op == "var":
        if node[1] not in env:
            raise EvalError(f"unknown identifier {node[1]!r}")
        val = env[node[1]]
        if val is _ABSENT:
            raise EvalError(f"{node[1]} is absent")
        return val
    if op == "member":
        base = _eval(node[1], env)
        if not isinstance(base, dict):
            raise EvalError(f"member access .{node[2]} on non-object")
        if node[2] not in base or base[node[2]] is None:
            raise EvalError(f"no such field {node[2]!r}")
        return base[node[2]]
    if op == "not":
        return not _truthy(_eval(node[1], env))
    if op == "neg":
        val = _eval(node[1], env)
        if isinstance(val, bool) or not isinstance(val, (int, float)):
            raise EvalError(f"unary - on non-numeric {val!r}")
        return -val
    if op == "or":  # CEL logical-or is commutative over errors: true wins
        lhs_err = None
        try:
            if _truthy(_eval(node[1], env)):
                return True
        except EvalError as e:
            lhs_err = e
        rhs = _truthy(_eval(node[2], env))
        if rhs:
            return True
        if lhs_err is not None:
            raise lhs_err
        return False
    if op == "and":  # dually: false wins over an error on the other side
        lhs_err = None
        lhs = False
        try:
            lhs = _truthy(_eval(node[1], env))
            if not lhs:
                return False
        except EvalError as e:
            lhs_err = e
        rhs = _truthy(_eval(node[2], env))
        if not rhs:
            return False
        if lhs_err is not None:
            raise lhs_err
        return lhs and rhs
    if op == "cmp":
        a, b = _eval(node[2], env), _eval(node[3], env)
        sym = node[1]
        if sym == "==":
            return a == b
        if sym == "!=":
            return a != b
        if type(a) is bool or type(b) is bool or \
                not isinstance(a, (int, float, str)) or \
                not isinstance(b, (int, float, str)) or \
                isinstance(a, str) != isinstance(b, str):
            raise EvalError(f"cannot order {a!r} and {b!r}")
        return {"<": a < b, "<=": a <= b, ">": a > b, ">=": a >= b}[sym]
    if op == "in":
        item, coll = _eval(node[1], env), _eval(node[2], env)
        # real CEL defines `in` over lists and maps only — no substring
        # test; accepting strings here would let a rule validate offline
        # and then fail to compile on a real apiserver
        if isinstance(coll, (dict, list)):
            return item in coll
        raise EvalError(f"'in' on non-collection {coll!r}")
    if op == "call":
        name, arg = node[1], node[2]
        if name == "has":
            # presence test: absent-field errors mean "not present"
            if arg[0] != "member":
                raise EvalError("has() requires a field selection")
            try:
                _eval(arg, env)
                return True
            except EvalError:
                return False
        if name == "size":
            val = _eval(arg, env)
            if isinstance(val, (list, dict, str)):
                return len(val)
            raise EvalError(f"size() on {type(val).__name__}")
        raise EvalError(f"unknown function {name!r}")
    raise EvalError(f"bad node {node!r}")


def references_old_self(rule: str) -> bool:
    """True when the rule mentions ``oldSelf`` (a transition rule).
    An untokenizable rule returns False so the caller's evaluate() is
    the one place that raises — the rule then lands in the fail-closed
    rejection path instead of crashing admission from this probe."""
    try:
        return any(t == ("ident", "oldSelf") for t in _tokenize(rule))
    except EvalError:
        return False


def evaluate(rule: str, self_val: Any, old_self: Any = _ABSENT) -> bool:
    """Evaluate one rule. Raises EvalError on malformed expressions or
    CEL runtime errors (callers treat errors as rejection — fail closed,
    matching the apiserver)."""
    ast = _Parser(_tokenize(rule)).parse()
    return _truthy(_eval(ast, {"self": self_val, "oldSelf": old_self}))


def schema_cel_errors(new: Any, old: Any, schema: dict,
                      path: str = "") -> List[str]:
    """Walk an openAPIV3Schema alongside the (new, old) values and
    evaluate every ``x-kubernetes-validations`` rule with ``self`` bound
    at that node — the apiserver's structural-schema CEL semantics:

    - rules at absent nodes are skipped (nothing to validate);
    - transition rules (mentioning ``oldSelf``) apply only when the old
      value exists at the same node, i.e. only on UPDATE;
    - a rule that evaluates false OR errors appends its message.
    """
    errs: List[str] = []
    if new is None:
        return errs
    for rule in schema.get("x-kubernetes-validations", []) or []:
        expr = rule.get("rule", "")
        if references_old_self(expr) and old is None:
            continue
        try:
            ok = evaluate(expr, new,
                          _ABSENT if old is None else old)
        except EvalError as e:
            ok = False
            errs.append(f"{path or '.'}: rule {expr!r} failed to "
                        f"evaluate: {e}")
            continue
        if not ok:
            errs.append(f"{path or '.'}: "
                        f"{rule.get('message') or expr}")
    t = schema.get("type")
    if t == "object" and isinstance(new, dict):
        for key, sub in (schema.get("properties") or {}).items():
            old_v = old.get(key) if isinstance(old, dict) else None
            errs.extend(schema_cel_errors(new.get(key), old_v, sub,
                                          f"{path}/{key}"))
    elif t == "array" and isinstance(new, list):
        items = schema.get("items") or {}
        for i, v in enumerate(new):
            # array identity across updates is positional in the
            # apiserver only for listType=map; be conservative: treat
            # array elements as create-time (no oldSelf)
            errs.extend(schema_cel_errors(v, None, items, f"{path}[{i}]"))
    return errs
