"""Minimal go-template-compatible rendering engine (the port's own copy of
``tpu_operator/render/engine.py``; PyYAML is imported where it is used).

The reference renders operand manifests with text/template + sprig
(internal/render/render.go:64-151, option missingkey=error, custom funcs
``yaml`` and ``deref``). This engine implements the subset those manifests
actually use, with the same strictness: referencing a missing key is an
error, not an empty string — template bugs must fail loudly at render
time, not produce subtly-wrong YAML.

Supported syntax:

- ``{{ .Path.To.Field }}`` — dot navigation on the render data
- ``{{ if EXPR }} … {{ else if EXPR }} … {{ else }} … {{ end }}``
- ``{{ range .List }} … {{ end }}`` — ``.`` rebinds to the element,
  ``$`` always refers to the root data
- pipelines: ``{{ .X | quote | indent 4 }}``
- function call form: ``{{ default "v" .X }}``, ``{{ eq .A "b" }}``
- functions: quote, squote, upper, lower, title, trim, join, split,
  default, indent, nindent, toYaml, fromYaml, deref, eq, ne, lt, gt,
  and, or, not, len, contains, hasPrefix, hasSuffix, replace, int, toString
- comments ``{{/* … */}}`` and whitespace trimming ``{{-`` / ``-}}``
"""

from __future__ import annotations

import re
from typing import Any, Callable, List


class TemplateError(Exception):
    pass


class MissingKeyError(TemplateError):
    pass


# ---------------------------------------------------------------------------
# Lexer: split into text and {{ action }} chunks, honoring {{- and -}}
# ---------------------------------------------------------------------------

_ACTION_RE = re.compile(r"\{\{(-)?\s*(.*?)\s*(-)?\}\}", re.DOTALL)


def _lex(source: str) -> List[tuple]:
    """Yields ("text", str) and ("action", str) chunks."""
    chunks: List[tuple] = []
    pos = 0
    for m in _ACTION_RE.finditer(source):
        text = source[pos:m.start()]
        if m.group(1):  # {{- trims preceding whitespace
            text = text.rstrip(" \t\n\r")
        if text:
            chunks.append(("text", text))
        body = m.group(2)
        if not body.startswith("/*"):
            chunks.append(("action", body))
        pos = m.end()
        if m.group(3):  # -}} trims following whitespace
            rest = source[pos:]
            trimmed = rest.lstrip(" \t\n\r")
            pos += len(rest) - len(trimmed)
    tail = source[pos:]
    if tail:
        chunks.append(("text", tail))
    return chunks


# ---------------------------------------------------------------------------
# Parser: nest if/range blocks
# ---------------------------------------------------------------------------


class _Node:
    pass


class _Text(_Node):
    def __init__(self, s):
        self.s = s


class _Expr(_Node):
    def __init__(self, expr):
        self.expr = expr


class _If(_Node):
    def __init__(self):
        # list of (condition_expr | None for else, body nodes)
        self.branches: List[tuple] = []


class _Range(_Node):
    def __init__(self, expr):
        self.expr = expr
        self.body: List[_Node] = []


def _parse(chunks: List[tuple]) -> List[_Node]:
    root: List[_Node] = []
    # stack of (container_list, open_node)
    stack: List[tuple] = [(root, None)]

    def top() -> List[_Node]:
        node = stack[-1][1]
        if isinstance(node, _If):
            return node.branches[-1][1]
        if isinstance(node, _Range):
            return node.body
        return stack[-1][0]

    for kind, val in chunks:
        if kind == "text":
            top().append(_Text(val))
            continue
        stripped = val.strip()
        if stripped.startswith("if "):
            node = _If()
            node.branches.append((stripped[3:].strip(), []))
            top().append(node)
            stack.append(([], node))
        elif stripped.startswith("range "):
            node = _Range(stripped[6:].strip())
            top().append(node)
            stack.append(([], node))
        elif stripped == "else" or stripped.startswith("else if "):
            node = stack[-1][1]
            if not isinstance(node, _If):
                raise TemplateError("'else' outside of if block")
            cond = stripped[8:].strip() if stripped.startswith("else if ") else None
            node.branches.append((cond, []))
        elif stripped == "end":
            if len(stack) == 1:
                raise TemplateError("unbalanced 'end'")
            stack.pop()
        else:
            top().append(_Expr(stripped))
    if len(stack) != 1:
        raise TemplateError("unclosed if/range block")
    return root


# ---------------------------------------------------------------------------
# Expression evaluation
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(r"""
    "(?:[^"\\]|\\.)*"        # double-quoted string
  | '(?:[^'\\]|\\.)*'        # single-quoted string
  | -?\d+\.\d+               # float
  | -?\d+                    # int
  | \$\.?[A-Za-z0-9_.]*      # $ root ref
  | \.[A-Za-z0-9_.]*         # dot path
  | [A-Za-z_][A-Za-z0-9_]*   # identifier
  | \(|\)|\|
""", re.VERBOSE)


def _tokenize_expr(expr: str) -> List[str]:
    tokens = []
    pos = 0
    while pos < len(expr):
        if expr[pos].isspace():
            pos += 1
            continue
        m = _TOKEN_RE.match(expr, pos)
        if not m:
            raise TemplateError(f"bad token at {expr[pos:]!r}")
        tokens.append(m.group(0))
        pos = m.end()
    return tokens


def _truthy(v: Any) -> bool:
    """Go template truthiness: nil, zero, empty string/list/map are false."""
    if v is None:
        return False
    if isinstance(v, (str, list, dict, tuple)):
        return len(v) > 0
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)):
        return v != 0
    return True


def _yaml():
    """PyYAML, taught the clients' frozen views (it resolves representers
    by exact type)."""
    import yaml

    from ..runtime.objects import FrozenDict, FrozenList

    if FrozenDict not in yaml.SafeDumper.yaml_representers:
        for dumper in (yaml.SafeDumper, yaml.Dumper):
            dumper.add_representer(
                FrozenDict, yaml.representer.SafeRepresenter.represent_dict)
            dumper.add_representer(
                FrozenList, yaml.representer.SafeRepresenter.represent_list)
    return yaml


def _to_yaml(v: Any) -> str:
    return _yaml().safe_dump(v, default_flow_style=False,
                             sort_keys=False).rstrip("\n")


def _indent(n: Any, s: Any) -> str:
    pad = " " * int(n)
    return "\n".join(pad + line for line in str(s).split("\n"))


BUILTINS: dict[str, Callable] = {
    "quote": lambda v: '"' + str(v).replace("\\", "\\\\").replace('"', '\\"') + '"',
    "squote": lambda v: "'" + str(v).replace("'", "''") + "'",
    "upper": lambda v: str(v).upper(),
    "lower": lambda v: str(v).lower(),
    "title": lambda v: str(v).title(),
    "trim": lambda v: str(v).strip(),
    "join": lambda sep, lst: str(sep).join(str(x) for x in lst),
    "split": lambda sep, v: str(v).split(str(sep)),
    "default": lambda dflt, v=None: v if _truthy(v) else dflt,
    "indent": _indent,
    "nindent": lambda n, s: "\n" + _indent(n, s),
    "toYaml": _to_yaml,
    "yaml": _to_yaml,  # reference's custom func name (render.go)
    "fromYaml": lambda s: _yaml().safe_load(s),
    "deref": lambda v: v,  # pointers don't exist here; identity for parity
    "eq": lambda a, b: a == b,
    "ne": lambda a, b: a != b,
    "lt": lambda a, b: a < b,
    "le": lambda a, b: a <= b,
    "gt": lambda a, b: a > b,
    "ge": lambda a, b: a >= b,
    "and": lambda *vs: vs[-1] if all(_truthy(v) for v in vs) else next(
        (v for v in vs if not _truthy(v)), False),
    "or": lambda *vs: next((v for v in vs if _truthy(v)), vs[-1] if vs else None),
    "not": lambda v: not _truthy(v),
    "len": lambda v: len(v),
    "contains": lambda needle, hay: str(needle) in str(hay),
    "hasPrefix": lambda p, s: str(s).startswith(str(p)),
    "hasSuffix": lambda p, s: str(s).endswith(str(p)),
    "replace": lambda old, new, s: str(s).replace(str(old), str(new)),
    "int": lambda v: int(v),
    "toString": lambda v: str(v),
    "printf": lambda fmt, *a: str(fmt) % tuple(a),
    "ternary": lambda t, f, c: t if _truthy(c) else f,
    # sprig parity for the reference's helm chart templates:
    # the upgrade-hook Job name is versioned by an image digest prefix
    "sha256sum": lambda v: __import__("hashlib").sha256(
        str(v).encode()).hexdigest(),
    "trunc": lambda n, s: str(s)[:int(n)] if int(n) >= 0
    else str(s)[int(n):],
    # sprig's safe map access — the escape from missingkey=error for
    # genuinely-optional keys (user-supplied list entries, nulled maps)
    "get": lambda d, k: d.get(k, "") if isinstance(d, dict) else "",
    "dict": lambda *kv: dict(zip(kv[::2], kv[1::2])),
    "kindIs": lambda kind, v: {
        "string": isinstance(v, str),
        "map": isinstance(v, dict),
        "slice": isinstance(v, list),
        "bool": isinstance(v, bool),
        "int": isinstance(v, int) and not isinstance(v, bool),
        "float64": isinstance(v, float),
        "invalid": v is None,
    }.get(str(kind), False),
}


class _Scope:
    def __init__(self, root: Any, dot: Any):
        self.root = root
        self.dot = dot

    def resolve_path(self, token: str) -> Any:
        if token.startswith("$"):
            base = self.root
            path = token[1:].lstrip(".")
        else:
            base = self.dot
            path = token[1:]  # strip leading '.'
        if not path:
            return base
        cur = base
        for part in path.split("."):
            if isinstance(cur, dict):
                if part not in cur:
                    raise MissingKeyError(
                        f"map has no entry for key {part!r} (in {token})")
                cur = cur[part]
            elif hasattr(cur, part):
                cur = getattr(cur, part)
            else:
                raise MissingKeyError(f"cannot access {part!r} (in {token})")
        return cur


_NO_PIPE = object()


def _eval_expr(expr: str, scope: _Scope) -> Any:
    return _eval_tokens(_tokenize_expr(expr), scope)


def _eval_tokens(tokens: List[str], scope: _Scope) -> Any:
    """Full pipeline evaluation of a token list: split on top-level pipes,
    evaluate each stage as ``fn arg arg…`` with the previous stage's value
    appended (go pipeline semantics). Used both for whole {{ actions }} and
    for parenthesized groups, so pipes nest correctly inside parens."""
    stages: List[List[str]] = [[]]
    depth = 0
    for t in tokens:
        if t == "(":
            depth += 1
        elif t == ")":
            depth -= 1
        if t == "|" and depth == 0:
            stages.append([])
        else:
            stages[-1].append(t)
    value: Any = None
    have_value = False
    for stage in stages:
        if not stage:
            raise TemplateError(f"empty pipeline stage in {tokens!r}")
        value = _eval_stage(stage, scope,
                            piped=value if have_value else _NO_PIPE)
        have_value = True
    return value


def _matching_paren(tokens: List[str], i: int) -> int:
    """Index of the ')' matching the '(' at ``i``."""
    depth = 0
    for j in range(i, len(tokens)):
        if tokens[j] == "(":
            depth += 1
        elif tokens[j] == ")":
            depth -= 1
            if depth == 0:
                return j
    raise TemplateError("unbalanced parenthesis")


def _eval_atom(tokens: List[str], i: int, scope: _Scope):
    t = tokens[i]
    if t == "(":
        close = _matching_paren(tokens, i)
        return _eval_tokens(tokens[i + 1:close], scope), close + 1
    if t.startswith('"') or t.startswith("'"):
        body = t[1:-1]
        return body.encode().decode("unicode_escape"), i + 1
    if re.fullmatch(r"-?\d+", t):
        return int(t), i + 1
    if re.fullmatch(r"-?\d+\.\d+", t):
        return float(t), i + 1
    if t.startswith(".") or t.startswith("$"):
        return scope.resolve_path(t), i + 1
    if t == "true":
        return True, i + 1
    if t == "false":
        return False, i + 1
    if t in ("nil", "null"):
        return None, i + 1
    if t in BUILTINS:
        raise TemplateError(f"function {t!r} needs call context")
    raise TemplateError(f"unknown token {t!r}")


def _eval_stage(tokens: List[str], scope: _Scope, piped: Any) -> Any:
    """One pipeline stage: ``fn arg arg…`` or a single atom. ``tokens``
    contains no top-level pipes by construction."""
    t = tokens[0]
    if t in BUILTINS:
        fn = BUILTINS[t]
        args = []
        j = 1
        while j < len(tokens):
            val, j = _eval_atom(tokens, j, scope)
            args.append(val)
        if piped is not _NO_PIPE:
            args.append(piped)
        return fn(*args)
    val, j = _eval_atom(tokens, 0, scope)
    if piped is not _NO_PIPE:
        raise TemplateError(f"cannot pipe into non-function {t!r}")
    if j < len(tokens):
        raise TemplateError(f"unexpected token {tokens[j]!r}")
    return val


# ---------------------------------------------------------------------------
# Renderer
# ---------------------------------------------------------------------------


def _render_nodes(nodes: List[_Node], scope: _Scope, out: List[str]) -> None:
    for node in nodes:
        if isinstance(node, _Text):
            out.append(node.s)
        elif isinstance(node, _Expr):
            val = _eval_expr(node.expr, scope)
            if val is None:
                val = ""
            elif isinstance(val, bool):
                val = "true" if val else "false"
            out.append(str(val))
        elif isinstance(node, _If):
            for cond, body in node.branches:
                if cond is None or _truthy(_eval_expr(cond, scope)):
                    _render_nodes(body, scope, out)
                    break
        elif isinstance(node, _Range):
            coll = _eval_expr(node.expr, scope)
            if coll is None:
                continue
            items = coll.items() if isinstance(coll, dict) else coll
            for item in items:
                _render_nodes(node.body, _Scope(scope.root, item), out)


# parse memoization: every reconcile re-reads the same manifest sources,
# and lex+parse is pure in the source text — one AST per distinct source
# serves every Template instance process-wide. Only successful parses are
# cached so error paths keep their name-prefixed TemplateError. The AST
# is shared read-only (_render_nodes never mutates nodes), so concurrent
# renders of the same template are safe; a racing double-parse just
# stores the same AST twice.
_AST_CACHE: dict = {}


class Template:
    def __init__(self, source: str, name: str = "<template>"):
        self.name = name
        nodes = _AST_CACHE.get(source)
        if nodes is None:
            try:
                nodes = _parse(_lex(source))
            except TemplateError as e:
                raise TemplateError(f"{name}: {e}") from e
            _AST_CACHE[source] = nodes
        self.nodes = nodes

    def render(self, data: Any) -> str:
        out: List[str] = []
        try:
            _render_nodes(self.nodes, _Scope(data, data), out)
        except TemplateError as e:
            raise type(e)(f"{self.name}: {e}") from e
        return "".join(out)


def render_string(source: str, data: Any, name: str = "<template>") -> str:
    return Template(source, name).render(data)
