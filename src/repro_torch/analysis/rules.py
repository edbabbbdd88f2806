"""turbolint rules for the port: the four AST checks of the JAX
package's `repro.analysis.rules` plus the suppression grammar, with the
JAX package's meaning and the port's idioms added.

Rules
-----
- **TL001 host-sync** — device→host transfers inside hot-path modules.
  The JAX package's sinks (``.item()``, ``int()/float()/bool()`` of a
  device value, ``np.asarray``/``np.array`` of one, ``jax.device_get``,
  any ``block_until_ready``) and PyTorch's: ``.tolist()``, ``.cpu()`` and
  ``.numpy()`` of a device value, any ``.synchronize()``
  (``torch.cuda.synchronize``, an event's or a stream's), and a call of a
  configured ``sync_functions`` helper (the engine's ``_host``) on a
  device value.  A per-function intraprocedural taint walk decides
  "device value": sources are calls rooted at the configured device
  namespaces (``torch``; the JAX package's ``jnp``/``jax``/``lax``),
  attribute loads of configured device-state names, parameters named
  after device state, and method calls on a device value (``x.max()``)
  but for the ones that return host data (``.size()``, ``.numel()``,
  ``.dim()``, ``.data_ptr()``, ... and the sinks themselves).  A call
  named in ``host_calls`` (``torch.cuda.is_available``, ...) returns host
  data.  ``np.asarray`` both *sinks* (flagged) and *washes*.
- **TL002 recompile-hazard** — a static that varies per call where a
  compiled artefact is keyed: the JAX package's jitted closure capturing
  an enclosing factory parameter and ``pl.pallas_call`` construction
  using one; in the port, a CUDA-graph cell (a configured
  ``cell_calls`` call such as ``CellTable.run(key, body, ...)``) whose
  key or body uses such a parameter, and a ``with torch.cuda.graph(...)``
  capture whose body reads one — each value is a fresh capture.  The
  parameter passes where it is in ``bucketed``, or, in a capture, in
  ``operands`` (tensors the graph reads by address).
- **TL003 lock-discipline** — writes to guarded attributes, or calls to
  mutating methods on them, outside a ``with self.<lock>:`` block in
  the configured multi-threaded modules (unchanged).
- **TL004 kernel-parity** — every kernel entry point maps to an oracle
  in the reference module and to tests.  The JAX package's form: each
  ``*_pallas`` entry of ``kernels/`` declared, its dispatch called in
  interpret mode under ``tests/``.  The port's form (``entry_module``
  and ``card_tests`` set): each public wrapper of ``kernels/ops.py``
  declared, its oracle in ``kernels/ref.py``, a call of it in a CPU
  test and in the card tests (``tests/test_torch_cuda.py``).

Suppressions
------------
``# turbolint: allow-<key>(<reason>)`` with key one of ``sync``,
``static``, ``lock``, ``parity`` silences the matching rule on its own
line and the line directly below (so the comment can ride inline or
stand alone above the statement).  The reason is mandatory; malformed
or unused suppressions are themselves findings (TL000).
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.config import LintConfig

RULE_SUPPRESS = "TL000"
RULE_SYNC = "TL001"
RULE_STATIC = "TL002"
RULE_LOCK = "TL003"
RULE_PARITY = "TL004"

_KEY_TO_RULE = {"sync": RULE_SYNC, "static": RULE_STATIC,
                "lock": RULE_LOCK, "parity": RULE_PARITY}

# attrs that are host metadata even on a device array
_HOST_META_ATTRS = {"shape", "dtype", "ndim", "size", "device", "is_cuda",
                    "requires_grad", "layout"}
# calls whose result is host data regardless of argument taint
_WASH_CALLS = {"len", "isinstance", "type", "repr", "str"}
# methods of a device tensor that return host data without a transfer
_HOST_METHODS = {"size", "dim", "numel", "element_size", "data_ptr",
                 "stride", "storage_offset", "is_contiguous",
                 "is_floating_point", "get_device", "untyped_storage"}
# methods of a device tensor that copy it to the host (sinks; their
# result is host data)
_SINK_METHODS = ("item", "tolist", "cpu", "numpy")


@dataclass(frozen=True)
class Finding:
    path: str          # repo-relative, forward slashes
    line: int
    col: int
    rule: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} " \
               f"{self.message}"


# ---------------------------------------------------------------------------
# Suppressions
# ---------------------------------------------------------------------------

_SUPPRESS_RE = re.compile(
    r"#\s*turbolint:\s*allow-([a-z]+)\(([^)]*)\)")
_SUPPRESS_ANY_RE = re.compile(r"#\s*turbolint\b")


@dataclass
class _Suppression:
    line: int
    rule: str
    reason: str
    used: bool = False


class Suppressions:
    """Per-file suppression table parsed from raw source lines."""

    def __init__(self, source: str, path: str) -> None:
        self.path = path
        self.entries: List[_Suppression] = []
        self.malformed: List[Finding] = []
        for i, text in enumerate(source.splitlines(), start=1):
            if not _SUPPRESS_ANY_RE.search(text):
                continue
            m = _SUPPRESS_RE.search(text)
            if m is None:
                self.malformed.append(Finding(
                    path, i, 1, RULE_SUPPRESS,
                    "malformed turbolint comment (grammar: "
                    "`# turbolint: allow-<sync|static|lock|parity>"
                    "(<reason>)`)"))
                continue
            key, reason = m.group(1), m.group(2).strip()
            rule = _KEY_TO_RULE.get(key)
            if rule is None:
                self.malformed.append(Finding(
                    path, i, 1, RULE_SUPPRESS,
                    f"unknown suppression key {key!r} (expected one of "
                    f"{sorted(_KEY_TO_RULE)})"))
                continue
            if not reason:
                self.malformed.append(Finding(
                    path, i, 1, RULE_SUPPRESS,
                    f"allow-{key} requires a non-empty reason"))
                continue
            self.entries.append(_Suppression(i, rule, reason))

    def allows(self, line: int, rule: str) -> bool:
        """A suppression covers its own line and the line directly
        below it (inline vs standalone-above placement).  Exact-line
        matches win so two adjacent inline suppressions each claim
        their own finding."""
        for want in (line, line - 1):
            for s in self.entries:
                if s.rule == rule and s.line == want:
                    s.used = True
                    return True
        return False

    def unused(self) -> List[Finding]:
        return [Finding(self.path, s.line, 1, RULE_SUPPRESS,
                        f"unused suppression for {s.rule} "
                        f"({s.reason!r}) — remove it")
                for s in self.entries if not s.used]


# ---------------------------------------------------------------------------
# TL001 host-sync
# ---------------------------------------------------------------------------

def _root_name(node: ast.AST) -> Optional[str]:
    """Leftmost Name of a dotted chain: jnp.foo.bar -> 'jnp'."""
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


class _TaintScope:
    """One function (or module) body, walked in statement order with a
    mutable set of tainted local names."""

    def __init__(self, rule_cfg, path: str) -> None:
        self.device_attrs = set(rule_cfg.strings("device_attrs"))
        self.device_roots = set(rule_cfg.strings(
            "device_roots", ["jnp", "jax", "lax"]))
        self.numpy_roots = set(rule_cfg.strings(
            "numpy_roots", ["np", "numpy"]))
        self.sync_functions = set(rule_cfg.strings("sync_functions"))
        self.host_calls = set(rule_cfg.strings("host_calls"))
        self.path = path
        self.findings: List[Finding] = []

    # -- taint query --------------------------------------------------
    def tainted(self, node: ast.AST, env: Set[str]) -> bool:
        if isinstance(node, ast.Name):
            return node.id in env
        if isinstance(node, ast.Attribute):
            if node.attr in _HOST_META_ATTRS:
                return False
            if node.attr in self.device_attrs:
                return True
            return self.tainted(node.value, env)
        if isinstance(node, ast.Call):
            root = _root_name(node.func)
            fname = node.func.attr if isinstance(node.func,
                                                 ast.Attribute) \
                else (node.func.id if isinstance(node.func, ast.Name)
                      else None)
            if fname in self.host_calls or fname in self.sync_functions:
                return False      # host data (a sync helper: a sink)
            if root in self.device_roots:
                return True
            if fname in _WASH_CALLS:
                return False
            if root in self.numpy_roots and fname in ("asarray",
                                                      "array"):
                return False      # washed to host (the call is a sink)
            if fname in ("int", "float", "bool") and root == fname:
                return False      # washed (and a sink when tainted)
            if isinstance(node.func, ast.Attribute):
                if fname in _HOST_METHODS or fname in _SINK_METHODS:
                    return False  # host data (a sink where it copies)
                if self.tainted(node.func.value, env):
                    return True   # a method of a device value: x.max()
            return any(self.tainted(a, env) for a in node.args) or \
                any(self.tainted(k.value, env) for k in node.keywords)
        if isinstance(node, (ast.BinOp,)):
            return self.tainted(node.left, env) or \
                self.tainted(node.right, env)
        if isinstance(node, ast.UnaryOp):
            return self.tainted(node.operand, env)
        if isinstance(node, ast.Compare):
            return self.tainted(node.left, env) or \
                any(self.tainted(c, env) for c in node.comparators)
        if isinstance(node, ast.BoolOp):
            return any(self.tainted(v, env) for v in node.values)
        if isinstance(node, ast.Subscript):
            return self.tainted(node.value, env)
        if isinstance(node, ast.IfExp):
            return self.tainted(node.body, env) or \
                self.tainted(node.orelse, env)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return any(self.tainted(e, env) for e in node.elts)
        if isinstance(node, ast.Starred):
            return self.tainted(node.value, env)
        if isinstance(node, (ast.ListComp, ast.SetComp,
                             ast.GeneratorExp)):
            inner = set(env)
            for gen in node.generators:
                if self.tainted(gen.iter, env):
                    for n in ast.walk(gen.target):
                        if isinstance(n, ast.Name):
                            inner.add(n.id)
            return self.tainted(node.elt, inner)
        return False

    # -- sinks --------------------------------------------------------
    def _flag(self, node: ast.AST, msg: str) -> None:
        self.findings.append(Finding(
            self.path, node.lineno, node.col_offset + 1, RULE_SYNC,
            msg + " — hot-path host sync; annotate "
            "`# turbolint: allow-sync(<why>)` if deliberate"))

    def scan_sinks(self, stmt: ast.stmt, env: Set[str]) -> None:
        for node in ast.walk(stmt):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if isinstance(func, ast.Attribute):
                if func.attr in _SINK_METHODS and not node.args and \
                        self.tainted(func.value, env):
                    self._flag(node, f"`.{func.attr}()` on a device value")
                    continue
                if func.attr in ("block_until_ready", "synchronize"):
                    self._flag(node, f"`{func.attr}` call")
                    continue
                if func.attr in self.sync_functions and node.args and \
                        self.tainted(node.args[0], env):
                    self._flag(node, f"`{func.attr}()` of a device value")
                    continue
                if func.attr == "device_get" and \
                        _root_name(func) in self.device_roots:
                    self._flag(node, "`jax.device_get` call")
                    continue
                root = _root_name(func)
                if root in self.numpy_roots and \
                        func.attr in ("asarray", "array") and \
                        node.args and self.tainted(node.args[0], env):
                    self._flag(node, f"`{root}.{func.attr}` of a "
                               "device value")
                    continue
            elif isinstance(func, ast.Name):
                if func.id in ("int", "float", "bool") and \
                        len(node.args) == 1 and \
                        self.tainted(node.args[0], env):
                    self._flag(node, f"`{func.id}()` of a device value")
                elif func.id in self.sync_functions and node.args and \
                        self.tainted(node.args[0], env):
                    self._flag(node, f"`{func.id}()` of a device value")

    # -- statement walk ----------------------------------------------
    def _bind(self, target: ast.AST, taint: bool, env: Set[str]) -> None:
        for n in ast.walk(target):
            if isinstance(n, ast.Name):
                (env.add if taint else env.discard)(n.id)

    def walk(self, body: Sequence[ast.stmt], env: Set[str]) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
                self.run_function(stmt)
                continue
            if isinstance(stmt, ast.ClassDef):
                self.walk(stmt.body, set(env))
                continue
            self.scan_sinks(stmt, env)
            if isinstance(stmt, ast.Assign):
                t = self.tainted(stmt.value, env)
                if isinstance(stmt.value, ast.Tuple) and \
                        len(stmt.targets) == 1 and \
                        isinstance(stmt.targets[0], ast.Tuple) and \
                        len(stmt.targets[0].elts) == \
                        len(stmt.value.elts):
                    for tgt, val in zip(stmt.targets[0].elts,
                                        stmt.value.elts):
                        self._bind(tgt, self.tainted(val, env), env)
                else:
                    for tgt in stmt.targets:
                        self._bind(tgt, t, env)
            elif isinstance(stmt, ast.AnnAssign) and stmt.value:
                self._bind(stmt.target, self.tainted(stmt.value, env),
                           env)
            elif isinstance(stmt, ast.AugAssign):
                if self.tainted(stmt.value, env):
                    self._bind(stmt.target, True, env)
            elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                # two passes: taint set in the body feeds back into the
                # body's own earlier statements on the next iteration
                for _ in range(2):
                    self._bind(stmt.target,
                               self.tainted(stmt.iter, env), env)
                    self.walk(stmt.body, env)
                self.walk(stmt.orelse, env)
            elif isinstance(stmt, ast.While):
                for _ in range(2):
                    self.walk(stmt.body, env)
                self.walk(stmt.orelse, env)
            elif isinstance(stmt, ast.If):
                then_env, else_env = set(env), set(env)
                self.walk(stmt.body, then_env)
                self.walk(stmt.orelse, else_env)
                env |= then_env | else_env
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    if item.optional_vars is not None:
                        self._bind(item.optional_vars,
                                   self.tainted(item.context_expr,
                                                env), env)
                self.walk(stmt.body, env)
            elif isinstance(stmt, ast.Try):
                self.walk(stmt.body, env)
                for h in stmt.handlers:
                    self.walk(h.body, set(env))
                self.walk(stmt.orelse, env)
                self.walk(stmt.finalbody, env)

    def run_function(self, fn: ast.FunctionDef) -> None:
        args = fn.args
        params = [a.arg for a in (args.posonlyargs + args.args +
                                  args.kwonlyargs)]
        env = {p for p in params if p in self.device_attrs}
        self.walk(fn.body, env)

    def run_module(self, tree: ast.Module) -> None:
        self.walk(tree.body, set())


def check_host_sync(cfg: LintConfig, path: Path, tree: ast.Module,
                    rel: str) -> List[Finding]:
    scope = _TaintScope(cfg.rule("host_sync"), rel)
    scope.run_module(tree)
    return scope.findings


# ---------------------------------------------------------------------------
# TL002 recompile-hazard
# ---------------------------------------------------------------------------

def _is_jit_decorator(dec: ast.AST) -> bool:
    """Matches @jax.jit, @jit, @partial(jax.jit, ...), @functools.partial
    (jax.jit, ...)."""
    for node in ast.walk(dec):
        if isinstance(node, ast.Attribute) and node.attr == "jit":
            return True
        if isinstance(node, ast.Name) and node.id == "jit":
            return True
    return False


def _free_loads(fn: ast.FunctionDef) -> Set[str]:
    bound: Set[str] = {a.arg for a in (fn.args.posonlyargs +
                                       fn.args.args + fn.args.kwonlyargs)}
    if fn.args.vararg:
        bound.add(fn.args.vararg.arg)
    if fn.args.kwarg:
        bound.add(fn.args.kwarg.arg)
    loads: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Name):
            if isinstance(node.ctx, ast.Store):
                bound.add(node.id)
            elif isinstance(node.ctx, ast.Load):
                loads.add(node.id)
    return loads - bound


def _loads(node: Optional[ast.AST]) -> Set[str]:
    if node is None:
        return set()
    return {n.id for n in ast.walk(node)
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)}


def _call_name(call: ast.Call) -> Optional[str]:
    func = call.func
    if isinstance(func, ast.Attribute):
        return func.attr
    return func.id if isinstance(func, ast.Name) else None


def _is_graph_capture(expr: ast.AST) -> bool:
    """``torch.cuda.graph(...)``: the region a CUDA graph records."""
    return isinstance(expr, ast.Call) and \
        isinstance(expr.func, ast.Attribute) and \
        expr.func.attr == "graph" and _root_name(expr.func) == "torch"


def _cell_calls(rule) -> Dict[str, Tuple[int, int]]:
    """``name:key_index:body_index`` entries of ``cell_calls``."""
    out = {}
    for raw in rule.strings("cell_calls"):
        name, key, body = raw.split(":")
        out[name] = (int(key), int(body))
    return out


def check_recompile(cfg: LintConfig, path: Path, tree: ast.Module,
                    rel: str) -> List[Finding]:
    rule = cfg.rule("recompile")
    bucketed = set(rule.strings("bucketed"))
    operands = set(rule.strings("operands"))
    cells = _cell_calls(rule)
    findings: List[Finding] = []
    own = {"self", "cls"}

    class V(ast.NodeVisitor):
        def __init__(self) -> None:
            self.param_stack: List[Set[str]] = []
            self.handled: Set[int] = set()

        def visit_FunctionDef(self, fn: ast.FunctionDef) -> None:
            params = {a.arg for a in (fn.args.posonlyargs +
                                      fn.args.args + fn.args.kwonlyargs)}
            enclosing = set().union(*self.param_stack) \
                if self.param_stack else set()
            if self.param_stack and \
                    any(_is_jit_decorator(d) for d in
                        fn.decorator_list):
                bad = sorted((_free_loads(fn) & enclosing) - bucketed)
                for name in bad:
                    findings.append(Finding(
                        rel, fn.lineno, fn.col_offset + 1, RULE_STATIC,
                        f"jitted closure `{fn.name}` captures factory "
                        f"parameter `{name}` that is not in the "
                        "declared bucketed set — every distinct value "
                        "recompiles; draw it from a BucketLadder or "
                        "declare it in [recompile].bucketed"))
            self.param_stack.append(params)
            self.generic_visit(fn)
            self.param_stack.pop()

        visit_AsyncFunctionDef = visit_FunctionDef

        def visit_With(self, stmt: ast.With) -> None:
            if self.param_stack and any(_is_graph_capture(i.context_expr)
                                        for i in stmt.items):
                enclosing = set().union(*self.param_stack)
                used: Set[str] = set()
                for inner in stmt.body:
                    used |= _loads(inner)
                for name in sorted((used & enclosing) - bucketed -
                                   operands - own):
                    findings.append(Finding(
                        rel, stmt.lineno, stmt.col_offset + 1, RULE_STATIC,
                        f"CUDA-graph capture reads parameter `{name}` "
                        "that is neither in the declared bucketed set nor "
                        "a declared operand — every distinct value is a "
                        "fresh capture"))
            self.generic_visit(stmt)

        def visit_Call(self, call: ast.Call) -> None:
            name = _call_name(call)
            if name in cells and self.param_stack:
                key_at, body_at = cells[name]
                if len(call.args) > max(key_at, body_at):
                    enclosing = set().union(*self.param_stack)
                    used = _loads(call.args[key_at]) | \
                        _loads(call.args[body_at])
                    for bad in sorted((used & enclosing) - bucketed - own):
                        findings.append(Finding(
                            rel, call.lineno, call.col_offset + 1,
                            RULE_STATIC,
                            f"CUDA-graph cell `{name}` keys or captures "
                            f"parameter `{bad}` that is not in the declared "
                            "bucketed set — every distinct value is a fresh "
                            "capture; draw it from a BucketLadder or "
                            "declare it in [recompile].bucketed"))
            if id(call) in self.handled:
                self.generic_visit(call)
                return
            # pattern: pl.pallas_call(<construction>)(operands...)
            inner, operands = call, []
            if isinstance(call.func, ast.Call):
                inner, operands = call.func, call.args
                self.handled.add(id(inner))
            func = inner.func
            is_pallas = (isinstance(func, ast.Attribute) and
                         func.attr == "pallas_call") or \
                (isinstance(func, ast.Name) and
                 func.id == "pallas_call")
            if is_pallas and self.param_stack:
                enclosing = set().union(*self.param_stack)
                used: Set[str] = set()
                for arg in list(inner.args) + \
                        [k.value for k in inner.keywords]:
                    for n in ast.walk(arg):
                        if isinstance(n, ast.Name) and \
                                isinstance(n.ctx, ast.Load):
                            used.add(n.id)
                operand_names: Set[str] = set()
                for op in operands:
                    for n in ast.walk(op):
                        if isinstance(n, ast.Name):
                            operand_names.add(n.id)
                bad = sorted((used & enclosing) - bucketed -
                             operand_names)
                for name in bad:
                    findings.append(Finding(
                        rel, inner.lineno, inner.col_offset + 1,
                        RULE_STATIC,
                        f"pallas_call construction uses parameter "
                        f"`{name}` that is not in the declared "
                        "bucketed set — every distinct value is a "
                        "fresh kernel compile"))
            self.generic_visit(call)

    V().visit(tree)
    return findings


# ---------------------------------------------------------------------------
# TL003 lock-discipline
# ---------------------------------------------------------------------------

def _self_attr_chain(node: ast.AST) -> List[str]:
    """`self.a.b.c` -> ['a', 'b', 'c']; [] if not rooted at `self`."""
    chain: List[str] = []
    while isinstance(node, ast.Attribute):
        chain.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name) and node.id == "self":
        return list(reversed(chain))
    return []


def check_locks(cfg: LintConfig, path: Path, tree: ast.Module,
                rel: str) -> List[Finding]:
    rule = cfg.rule("locks")
    lock_attr = rule.string("lock_attr", "_cv")
    guarded = set(rule.strings("guarded_attrs"))
    mutators = set(rule.strings("mutating_methods"))
    exempt = set(rule.strings("exempt_methods", ["__init__"]))
    findings: List[Finding] = []

    def is_lock_with(stmt: ast.With) -> bool:
        for item in stmt.items:
            chain = _self_attr_chain(item.context_expr)
            if chain and chain[-1] == lock_attr:
                return True
        return False

    def walk(body: Sequence[ast.stmt], locked: bool) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue  # nested defs get their own method-level walk
            if isinstance(stmt, ast.With) and is_lock_with(stmt):
                walk(stmt.body, True)
                continue
            if not locked:
                scan_stmt(stmt)
            # recurse into compound statements preserving lock state
            for attr in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, attr, None)
                if isinstance(sub, list) and sub and \
                        isinstance(sub[0], ast.stmt):
                    walk(sub, locked)
            for h in getattr(stmt, "handlers", []):
                walk(h.body, locked)

    def scan_stmt(stmt: ast.stmt) -> None:
        """Scan only this statement's own expressions — nested
        statement bodies are walked separately so a lock acquired
        inside them is honoured."""
        if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = stmt.targets if isinstance(stmt, ast.Assign) \
                else [stmt.target]
            for tgt in targets:
                base = tgt
                while isinstance(base, ast.Subscript):
                    base = base.value
                chain = _self_attr_chain(base)
                if chain and chain[0] in guarded:
                    findings.append(Finding(
                        rel, stmt.lineno, stmt.col_offset + 1,
                        RULE_LOCK,
                        f"write to `self.{'.'.join(chain)}` outside "
                        f"`with self.{lock_attr}:` — pump-thread races "
                        "with the caller"))
        exprs: List[ast.AST] = []
        if isinstance(stmt, (ast.Assign,)):
            exprs.append(stmt.value)
        elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
            if stmt.value is not None:
                exprs.append(stmt.value)
        elif isinstance(stmt, (ast.Expr, ast.Return)):
            if stmt.value is not None:
                exprs.append(stmt.value)
        elif isinstance(stmt, (ast.If, ast.While)):
            exprs.append(stmt.test)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            exprs.append(stmt.iter)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            exprs.extend(i.context_expr for i in stmt.items)
        elif isinstance(stmt, (ast.Raise, ast.Assert)):
            exprs.extend(n for n in ast.iter_child_nodes(stmt)
                         if isinstance(n, ast.expr))
        for expr in exprs:
            for node in ast.walk(expr):
                if isinstance(node, ast.Call) and \
                        isinstance(node.func, ast.Attribute):
                    chain = _self_attr_chain(node.func)
                    if len(chain) >= 2 and chain[0] in guarded and \
                            chain[-1] in mutators:
                        findings.append(Finding(
                            rel, node.lineno, node.col_offset + 1,
                            RULE_LOCK,
                            f"call `self.{'.'.join(chain)}()` mutates "
                            f"shared state outside `with "
                            f"self.{lock_attr}:`"))

    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            for item in node.body:
                if isinstance(item, ast.FunctionDef) and \
                        item.name not in exempt:
                    walk(item.body, False)
    return findings


# ---------------------------------------------------------------------------
# TL004 kernel-parity
# ---------------------------------------------------------------------------

def _top_level_defs(tree: ast.Module) -> Dict[str, int]:
    return {n.name: n.lineno for n in tree.body
            if isinstance(n, ast.FunctionDef)}


def _test_covers(tree: ast.Module, source: str, dispatch: str) -> bool:
    """True if the test module calls `dispatch` in interpret mode —
    either a literal impl="interpret" / interpret=True keyword, or a
    dynamic keyword in a file that mentions the "interpret" constant
    (the `for impl in ("xla", "interpret")` sweep idiom)."""
    has_interp_const = '"interpret"' in source or \
        "'interpret'" in source
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fname = node.func.attr if isinstance(node.func, ast.Attribute) \
            else (node.func.id if isinstance(node.func, ast.Name)
                  else None)
        if fname != dispatch:
            continue
        for kw in node.keywords:
            if kw.arg == "impl":
                if isinstance(kw.value, ast.Constant):
                    if kw.value.value == "interpret":
                        return True
                elif has_interp_const:
                    return True
            if kw.arg == "interpret" and \
                    isinstance(kw.value, ast.Constant) and \
                    kw.value.value is True:
                return True
    return False


def _calls(tree: ast.Module, name: str) -> bool:
    return any(isinstance(n, ast.Call) and _call_name(n) == name
               for n in ast.walk(tree))


def _parity_triples(rule, config_name: str):
    triples = []
    for raw in rule.strings("parity"):
        parts = raw.split(":")
        if len(parts) != 3:
            return None, [Finding(config_name, 1, 1, RULE_PARITY,
                                  f"malformed parity triple {raw!r} "
                                  "(want kernel:ref:dispatch)")]
        triples.append(tuple(parts))
    return triples, []


def _check_wrapper_parity(rule, sources: Dict[Path, Tuple[ast.Module, str]]
                          ) -> List[Finding]:
    """The port's form: each public wrapper of ``entry_module`` declared
    as ``wrapper:oracle:wrapper``, its oracle defined in ``ref_module``,
    and the wrapper called by a test on the CPU (a test file other than
    ``card_tests``) and by one of ``card_tests``."""
    from repro_torch.analysis.config import CONFIG_NAME
    entry_rel = rule.string("entry_module")
    ref_rel = rule.string("ref_module")
    card_rel = rule.string("card_tests")
    excluded = set(rule.strings("exclude_entries"))
    triples, bad = _parity_triples(rule, CONFIG_NAME)
    if bad:
        return bad

    def find(rel: str):
        for p, (tree, _) in sources.items():
            if p.as_posix().endswith(rel):
                return p, tree
        return None, None

    entry_path, entry_tree = find(entry_rel)
    _, ref_tree = find(ref_rel)
    card_path, card_tree = find(card_rel)
    entry_defs = _top_level_defs(entry_tree) if entry_tree else {}
    ref_defs = _top_level_defs(ref_tree) if ref_tree else {}
    cpu_tests = [t for p, (t, _) in sources.items()
                 if p.name.startswith("test_") and p != card_path]
    findings: List[Finding] = []
    declared = set()
    for entry, ref, dispatch in triples:
        declared.add(entry)
        if entry not in entry_defs:
            findings.append(Finding(
                CONFIG_NAME, 1, 1, RULE_PARITY,
                f"parity entry `{entry}` not found in {entry_rel}"))
            continue
        where = (entry_path.as_posix(), entry_defs[entry])
        if ref not in ref_defs:
            findings.append(Finding(
                *where, 1, RULE_PARITY,
                f"wrapper `{entry}` declares oracle `{ref}` but "
                f"{ref_rel} does not define it"))
        if not any(_calls(t, dispatch) for t in cpu_tests):
            findings.append(Finding(
                *where, 1, RULE_PARITY,
                f"wrapper `{entry}` has no CPU test calling `{dispatch}` "
                "under tests/"))
        if card_tree is None or not _calls(card_tree, dispatch):
            findings.append(Finding(
                *where, 1, RULE_PARITY,
                f"wrapper `{entry}` has no card test calling `{dispatch}` "
                f"in {card_rel}"))
    for name, lineno in entry_defs.items():
        if not name.startswith("_") and name not in declared and \
                name not in excluded:
            findings.append(Finding(
                entry_path.as_posix(), lineno, 1, RULE_PARITY,
                f"wrapper `{name}` has no [kernel_parity] triple — add "
                f"`\"{name}:<oracle>:{name}\"` with a CPU and a card test"))
    return findings


def check_kernel_parity(cfg: LintConfig,
                        sources: Dict[Path, Tuple[ast.Module, str]]
                        ) -> List[Finding]:
    """Repo-wide rule (not per-file): cross-references kernels/, ref.py
    and tests/."""
    rule = cfg.rule("kernel_parity")
    if rule.options.get("card_tests"):
        return _check_wrapper_parity(rule, sources)
    excludes = set(rule.strings("exclude", ["ref.py", "ops.py",
                                            "__init__.py"]))
    ref_rel = rule.string("ref_module", "src/repro/kernels/ref.py")
    triples = []
    for raw in rule.strings("parity"):
        parts = raw.split(":")
        if len(parts) != 3:
            return [Finding("turbolint.toml", 1, 1, RULE_PARITY,
                            f"malformed parity triple {raw!r} "
                            "(want kernel:ref:dispatch)")]
        triples.append(tuple(parts))
    findings: List[Finding] = []

    kernel_files = {p: v for p, v in sources.items()
                    if p.name not in excludes}
    ref_tree = None
    for p, (tree, _) in sources.items():
        if p.as_posix().endswith(ref_rel):
            ref_tree = tree
    ref_defs = _top_level_defs(ref_tree) if ref_tree else {}

    test_sources = [(p, t, s) for p, (t, s) in sources.items()
                    if p.name.startswith("test_")]

    # direction 1: every declared triple must resolve
    entry_names = set()
    for entry, ref, dispatch in triples:
        entry_names.add(entry)
        loc = None
        for p, (tree, _) in kernel_files.items():
            defs = _top_level_defs(tree)
            if entry in defs:
                loc = (p, defs[entry])
                break
        if loc is None:
            findings.append(Finding(
                "turbolint.toml", 1, 1, RULE_PARITY,
                f"parity entry `{entry}` not found in any kernel "
                "module"))
            continue
        rel = loc[0].as_posix()
        if ref not in ref_defs:
            findings.append(Finding(
                rel, loc[1], 1, RULE_PARITY,
                f"kernel `{entry}` declares reference `{ref}` but "
                f"{ref_rel} does not define it"))
        if not any(_test_covers(t, s, dispatch)
                   for _, t, s in test_sources):
            findings.append(Finding(
                rel, loc[1], 1, RULE_PARITY,
                f"kernel `{entry}` has no interpret-mode parity test "
                f"calling `{dispatch}` under tests/"))

    # direction 2: every public *_pallas entry point must be declared
    for p, (tree, _) in kernel_files.items():
        if not p.as_posix().split("/")[-2:-1] == ["kernels"]:
            continue
        for name, lineno in _top_level_defs(tree).items():
            if name.endswith("_pallas") and not name.startswith("_") \
                    and name not in entry_names:
                findings.append(Finding(
                    p.as_posix(), lineno, 1, RULE_PARITY,
                    f"kernel entry `{name}` has no [kernel_parity] "
                    "triple — add `\"" + name +
                    ":<ref>:<dispatch>\"` plus an interpret-mode test"))
    return findings


__all__ = ["Finding", "Suppressions", "check_host_sync",
           "check_recompile", "check_locks", "check_kernel_parity",
           "RULE_SYNC", "RULE_STATIC", "RULE_LOCK", "RULE_PARITY",
           "RULE_SUPPRESS"]
