"""racelint — whole-program concurrency lint for the threaded serve tier.

Port of ``dalle_pytorch_tpu/analysis/racelint.py``: the same six rules,
the same fixpoints and the same lock ids, so the two tools give the same
findings and the same lock-order graph on any tree. The port's serve
tier is the same multi-threaded fleet — the engine, thread replicas and
their supervisor, live migration, the gateway's hedged sends, the WFQ
scheduler, tenancy token buckets, transport heartbeats, the flight
recorder ring, the autoscaler — plus locks of its own (kernel K4's
counter lock, ``ops/paged_attention.py::_LOCK``, which replica threads
take concurrently), all sharing state under ``threading.Lock``s spread
across ten-plus modules. Built on ``lintcore``: the finding schema, the
``# racelint: disable=RL00x — reason`` waiver convention (the same
comment satisfies both tools), the ``--json``/``--select``/``--ignore``
CLI and the exit codes.

What it computes (stdlib only, whole-program over every linted file):

* a per-class LOCK TABLE — ``self._x = threading.Lock()`` attrs, plus
  module-level locks — each identified as ``ClassName.attr`` so a lock
  means the same thing in every module that touches it;
* RECEIVER TYPES — locals from constructor calls and annotations, attr
  types from ``self.x = Engine(...)`` and cross-object assignments
  (``r.engine = engine``), candidate SETS where assignment sites
  disagree, so ``eng._lock.acquire(timeout=0.2)`` in replica.py
  resolves to ``Engine._lock`` without imports saying so;
* a CALL GRAPH over resolved receivers (``self.m()``, typed locals and
  attrs, imported module functions, unique-method fallback with a
  common-name blocklist; ambiguity resolves to silence);
* fixpoints over that graph: which locks a call EVENTUALLY acquires
  (for the lock-order graph through method boundaries) and whether it
  eventually blocks (for blocking-reached-under-lock), plus per
  private method the locks ALWAYS held at entry (intersection over
  resolved self-call sites — the ``_reject``-style helper that is only
  ever called under the queue lock is guarded, not a race).

The statically computed lock-order graph is exported via
``lock_order_edges()`` and validated at runtime: ``analysis/guards.py``
ships a debug lock wrapper that records real acquisition order — under
the test suite on the CPU, and in ``chip_smoke.py``'s ``replicas``
phase on the card, K4 running in both replicas — and asserts it is a
subset of this graph: the static analysis is tested against reality,
not trusted.

Rules prefer missing a finding over flagging working idioms — the gate
only stays on in CI if the merged tree lints clean. Every finding can
be silenced in place with

    # racelint: disable=RL001 — reason why this one is fine

on the offending line (or the line above); the reason is part of the
convention, not enforced syntax.

Usage (the paths default to the package):
    python -m dalle_pytorch_tpu_torch.analysis.racelint [paths...] \
        [--json] [--select RL001,..] [--ignore RL00x,..] [--list-rules]
    python -m dalle_pytorch_tpu_torch.analysis.racelint \
        dalle_pytorch_tpu_torch chip_smoke.py

Exit status: 0 clean, 1 findings, 2 usage/parse errors.
"""

from __future__ import annotations

import argparse
import ast
import json
import sys
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Sequence, Set, Tuple

from . import lintcore
from .lintcore import (DEFAULT_EXCLUDES, Finding, iter_py_files,
                       dotted as _dotted, last as _last,
                       mod_parts as _mod_parts)

# rule id -> (slug, one-line description). docs/STATIC_ANALYSIS.md holds
# the long-form rationale; keep the two in sync.
RULES: Dict[str, Tuple[str, str]] = {
    "RL001": ("lock-guard",
              "attribute written both under its inferred lock and "
              "without it — a data-race candidate"),
    "RL002": ("lock-order-cycle",
              "cycle in the acquires-while-holding graph (through "
              "method calls) — a potential deadlock; also reentrant "
              "acquire of a non-reentrant self lock"),
    "RL003": ("blocking-under-lock",
              "blocking call (transport send/recv, sleep, select, "
              "subprocess, unbounded get/join/wait, device sync) "
              "reached while a lock is held"),
    "RL004": ("condvar-misuse",
              "Condition.wait() outside a while-predicate loop, or "
              "wait/notify without holding the condition"),
    "RL005": ("thread-lifecycle",
              "non-daemon thread that is never joined — it outlives "
              "shutdown and wedges interpreter exit"),
    "RL006": ("wallclock-deadline",
              "time.time() in deadline/duration arithmetic — wall "
              "clock steps under NTP; use time.monotonic()"),
}
lintcore.register_rules(RULES)

# self.<attr>.<mutator>(...) counts as a write to <attr>
_MUTATORS = {
    "append", "add", "update", "pop", "extend", "remove", "discard",
    "clear", "insert", "setdefault", "popitem", "appendleft",
    "popleft", "rotate",
}

# methods too common for the unique-name call-resolution fallback —
# a `.get()` is a dict far more often than it is the one class in the
# tree that happens to define get()
_COMMON_METHODS = {
    "get", "put", "pop", "push", "append", "add", "update", "remove",
    "clear", "close", "start", "stop", "run", "join", "wait", "notify",
    "send", "recv", "read", "write", "flush", "acquire", "release",
    "submit", "step", "reset", "items", "keys", "values", "copy",
    "result", "cancel", "set", "emit", "render", "open", "fileno",
    "encode", "decode", "next", "count", "index", "sort", "name",
}

_THREADING_CTORS = {
    "Lock": "lock", "RLock": "rlock", "Condition": "condition",
    "Event": "event", "Semaphore": "event", "BoundedSemaphore": "event",
    "Barrier": "event", "Thread": "thread", "Timer": "thread",
    "local": "event",
}
_QUEUE_CTORS = {"Queue", "SimpleQueue", "LifoQueue", "PriorityQueue"}

_BLOCKING_SUBPROCESS = {"run", "call", "check_call", "check_output",
                        "Popen", "communicate"}
_BLOCKING_SOCKETISH = {"recv", "recv_into", "recvfrom", "accept",
                       "connect", "sendall", "send_frame", "recv_frame",
                       "read_frame", "write_frame"}
# zero-argument forms of these block without bound
_BLOCKING_ZERO_ARG = {"join", "wait", "get", "result"}


class _Held(NamedTuple):
    lockid: str       # "ClassName.attr" / "module.name" / "scope.local"
    via_self: bool    # acquired on literal `self` (same instance)
    timed: bool       # acquire carried a timeout / non-blocking flag
    kind: str         # lock | rlock | condition


class _ClassInfo:
    __slots__ = ("name", "mod", "node", "bases", "lock_attrs",
                 "excluded_attrs", "attr_types", "methods")

    def __init__(self, name: str, mod: "_Mod", node: ast.ClassDef):
        self.name = name
        self.mod = mod
        self.node = node
        self.bases: List[str] = [_last(b) for b in node.bases if _last(b)]
        self.lock_attrs: Dict[str, str] = {}     # attr -> kind
        self.excluded_attrs: Set[str] = set()    # events/queues/threads
        self.attr_types: Dict[str, Set[str]] = {}  # attr -> class names
        self.methods: Dict[str, ast.AST] = {}


class _Mod:
    __slots__ = ("path", "src", "tree", "parts", "import_from",
                 "module_alias", "threading_aliases", "time_aliases",
                 "queue_aliases", "classes", "functions", "module_locks")

    def __init__(self, path: str, src: str):
        self.path = path
        self.src = src
        self.tree = ast.parse(src, filename=path)
        self.parts = _mod_parts(path)
        self.import_from: Dict[str, Tuple[str, str]] = {}
        self.module_alias: Dict[str, str] = {}
        self.threading_aliases: Set[str] = set()
        self.time_aliases: Set[str] = set()
        self.queue_aliases: Set[str] = set()
        self.classes: Dict[str, _ClassInfo] = {}
        self.functions: Dict[str, ast.AST] = {}
        self.module_locks: Dict[str, str] = {}   # name -> kind
        self._collect()

    def _collect(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    alias = a.asname or a.name.split(".")[0]
                    if a.name == "threading":
                        self.threading_aliases.add(alias)
                    elif a.name == "time":
                        self.time_aliases.add(alias)
                    elif a.name == "queue":
                        self.queue_aliases.add(alias)
                    self.module_alias[alias] = a.name if a.asname \
                        else alias
            elif isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                for a in node.names:
                    if a.name == "*":
                        continue
                    alias = a.asname or a.name
                    self.import_from[alias] = (mod, a.name)
                    self.module_alias[alias] = f"{mod}.{a.name}" \
                        if mod else a.name
        for stmt in self.tree.body:
            if isinstance(stmt, ast.ClassDef):
                info = _ClassInfo(stmt.name, self, stmt)
                self.classes[stmt.name] = info
                for sub in stmt.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        info.methods[sub.name] = sub
                self._collect_class_attrs(info)
            elif isinstance(stmt, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                self.functions[stmt.name] = stmt
            elif isinstance(stmt, ast.Assign):
                kind = self.ctor_kind(stmt.value)
                if kind in ("lock", "rlock", "condition"):
                    for tgt in stmt.targets:
                        if isinstance(tgt, ast.Name):
                            self.module_locks[tgt.id] = kind

    def ctor_kind(self, expr: ast.AST) -> Optional[str]:
        """'lock'/'rlock'/'condition'/'event'/'queue'/'thread' when
        ``expr`` constructs a threading/queue primitive, else None."""
        if not isinstance(expr, ast.Call):
            return None
        name = _last(expr.func)
        base = _dotted(expr.func).rsplit(".", 1)[0] \
            if isinstance(expr.func, ast.Attribute) else ""
        if base in self.threading_aliases and name in _THREADING_CTORS:
            return _THREADING_CTORS[name]
        if base in self.queue_aliases and name in _QUEUE_CTORS:
            return "queue"
        if not base and name in self.import_from:
            m, orig = self.import_from[name]
            if m == "threading" and orig in _THREADING_CTORS:
                return _THREADING_CTORS[orig]
            if m == "queue" and orig in _QUEUE_CTORS:
                return "queue"
        return None

    def _collect_class_attrs(self, info: _ClassInfo) -> None:
        for method in info.methods.values():
            for node in ast.walk(method):
                tgt = val = None
                if isinstance(node, ast.Assign) \
                        and len(node.targets) == 1:
                    tgt, val = node.targets[0], node.value
                elif isinstance(node, ast.AnnAssign):
                    tgt, val = node.target, node.value
                if not (isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"):
                    continue
                attr = tgt.attr
                kind = self.ctor_kind(val) if val is not None else None
                if kind in ("lock", "rlock", "condition"):
                    info.lock_attrs[attr] = kind
                    info.excluded_attrs.add(attr)
                elif kind in ("event", "queue", "thread"):
                    info.excluded_attrs.add(attr)
                if isinstance(node, ast.AnnAssign) \
                        and node.annotation is not None:
                    hint = _ann_class_names(node.annotation)
                    if hint:
                        info.attr_types.setdefault(attr,
                                                   set()).update(hint)


def _ann_class_names(ann: ast.AST) -> Set[str]:
    """Capitalized identifiers named in an annotation (including string
    annotations) — candidate project class names, filtered against the
    registry later."""
    out: Set[str] = set()
    for node in ast.walk(ann):
        if isinstance(node, (ast.Name, ast.Attribute)):
            n = _last(node)
            if n[:1].isupper():
                out.add(n)
        elif isinstance(node, ast.Constant) \
                and isinstance(node.value, str):
            for tokstr in node.value.replace("[", " ").replace(
                    "]", " ").replace(",", " ").replace(".", " ").split():
                if tokstr[:1].isupper():
                    out.add(tokstr)
    out -= {"Optional", "List", "Dict", "Set", "Tuple", "Sequence",
            "Iterable", "Iterator", "Callable", "Any", "Union",
            "Mapping", "FrozenSet", "Deque", "Type", "None", "True",
            "False"}
    return out


# fn key: (module parts, class name or None, function name)
_FnKey = Tuple[Tuple[str, ...], Optional[str], str]


class _FnFacts:
    __slots__ = ("key", "node", "cls", "mod", "acquire_events",
                 "call_events", "block_events", "write_events",
                 "is_private")

    def __init__(self, key: _FnKey, node: ast.AST, cls: Optional[_ClassInfo],
                 mod: _Mod):
        self.key = key
        self.node = node
        self.cls = cls
        self.mod = mod
        # (held_snapshot, new _Held, line, col)
        self.acquire_events: List[Tuple] = []
        # (callee_keys, receiver_is_self, held_snapshot, line, col, label)
        self.call_events: List[Tuple] = []
        # (desc, held_snapshot, line, col)
        self.block_events: List[Tuple] = []
        # (attr, frozenset(self-held lockids), line, col)
        self.write_events: List[Tuple] = []
        name = key[2].rsplit(".", 1)[-1]
        self.is_private = name.startswith("_") and not name.startswith("__")


class _Project:
    def __init__(self, mods: List[_Mod]):
        self.mods = mods
        self.classes_by_name: Dict[str, List[_ClassInfo]] = {}
        for m in mods:
            for c in m.classes.values():
                self.classes_by_name.setdefault(c.name, []).append(c)
        self.methods_by_name: Dict[str, List[_ClassInfo]] = {}
        for m in mods:
            for c in m.classes.values():
                for name in c.methods:
                    self.methods_by_name.setdefault(name, []).append(c)
        self.facts: Dict[_FnKey, _FnFacts] = {}

    def resolve_class(self, name: str) -> Optional[_ClassInfo]:
        cands = self.classes_by_name.get(name, [])
        return cands[0] if len(cands) == 1 else None

    def mro(self, cls: _ClassInfo) -> List[_ClassInfo]:
        out, seen, work = [], set(), [cls]
        while work and len(out) < 12:
            c = work.pop(0)
            if c.name in seen:
                continue
            seen.add(c.name)
            out.append(c)
            for b in c.bases:
                bc = self.resolve_class(b)
                if bc is not None:
                    work.append(bc)
        return out

    def find_method(self, cls: _ClassInfo,
                    name: str) -> Optional[Tuple[_ClassInfo, ast.AST]]:
        for c in self.mro(cls):
            if name in c.methods:
                return c, c.methods[name]
        return None

    def find_lock_attr(self, cls: _ClassInfo,
                       attr: str) -> Optional[Tuple[_ClassInfo, str]]:
        for c in self.mro(cls):
            if attr in c.lock_attrs:
                return c, c.lock_attrs[attr]
        return None

    def attr_type_names(self, cls: _ClassInfo, attr: str) -> Set[str]:
        out: Set[str] = set()
        for c in self.mro(cls):
            out |= c.attr_types.get(attr, set())
        return out

    def excluded_attr(self, cls: _ClassInfo, attr: str) -> bool:
        return any(attr in c.excluded_attrs for c in self.mro(cls))

    def find_mod(self, modref: str,
                 importer: Optional[_Mod] = None) -> Optional[_Mod]:
        """Longest-suffix module resolution: ambiguity resolves to None;
        a bare one-part name binds only a same-directory sibling of the
        importer."""
        parts = tuple(p for p in modref.split(".") if p)
        if not parts:
            return None
        best: List[_Mod] = []
        best_k = 0
        for m in self.mods:
            k = min(len(parts), len(m.parts))
            if k and parts[-k:] == m.parts[-k:]:
                if k == 1 and len(parts) == 1 and importer is not None \
                        and m.parts[:-1] != importer.parts[:-1]:
                    continue
                if k > best_k:
                    best, best_k = [m], k
                elif k == best_k:
                    best.append(m)
        return best[0] if len(best) == 1 else None


class _FnCtx:
    __slots__ = ("project", "mod", "cls", "node", "key", "local_types",
                 "local_locks")

    def __init__(self, project: _Project, mod: _Mod,
                 cls: Optional[_ClassInfo], node: ast.AST, key: _FnKey):
        self.project = project
        self.mod = mod
        self.cls = cls
        self.node = node
        self.key = key
        self.local_types: Dict[str, Set[str]] = {}
        self.local_locks: Dict[str, Tuple[str, str]] = {}
        self._collect_locals()

    def _known(self, names: Set[str]) -> Set[str]:
        return {n for n in names
                if self.project.resolve_class(n) is not None}

    def expr_types(self, expr: ast.AST) -> Set[str]:
        """Candidate project-class names for an expression's value."""
        if isinstance(expr, ast.Name):
            if expr.id == "self" and self.cls is not None:
                return {self.cls.name}
            return self.local_types.get(expr.id, set())
        if isinstance(expr, ast.Attribute):
            recv_types = self.expr_types(expr.value)
            out: Set[str] = set()
            for tname in recv_types:
                c = self.project.resolve_class(tname)
                if c is not None:
                    out |= self._known(
                        self.project.attr_type_names(c, expr.attr))
            return out
        if isinstance(expr, ast.Subscript):
            # container-of-T access types as T (List[Engine] etc.)
            return self.expr_types(expr.value)
        if isinstance(expr, ast.Call):
            name = _last(expr.func)
            if self.project.resolve_class(name) is not None:
                return {name}
            return set()
        if isinstance(expr, ast.IfExp):
            return self.expr_types(expr.body) | self.expr_types(expr.orelse)
        if isinstance(expr, ast.Await):
            return self.expr_types(expr.value)
        return set()

    def _bind(self, tgt: ast.AST, val: ast.AST) -> None:
        if isinstance(tgt, ast.Name):
            t = self.expr_types(val)
            if t:
                self.local_types.setdefault(tgt.id, set()).update(t)
            kind = self.mod.ctor_kind(val)
            if kind in ("lock", "rlock", "condition"):
                scope = self.key[1] or self.mod.parts[-1]
                self.local_locks[tgt.id] = (
                    f"{scope}.{self.key[2]}.{tgt.id}", kind)
        elif isinstance(tgt, (ast.Tuple, ast.List)) \
                and isinstance(val, (ast.Tuple, ast.List)) \
                and len(tgt.elts) == len(val.elts):
            for t, v in zip(tgt.elts, val.elts):
                self._bind(t, v)

    def _collect_locals(self) -> None:
        args = getattr(self.node, "args", None)
        if args is not None:
            for p in args.posonlyargs + args.args + args.kwonlyargs:
                if p.annotation is not None:
                    names = self._known(_ann_class_names(p.annotation))
                    if len(names) == 1:
                        self.local_types[p.arg] = names
        for node in _shallow_walk_body(self.node):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                self._bind(node.targets[0], node.value)
            elif isinstance(node, ast.AnnAssign) \
                    and isinstance(node.target, ast.Name):
                names = self._known(_ann_class_names(node.annotation))
                if len(names) == 1:
                    self.local_types[node.target.id] = names
                if node.value is not None:
                    self._bind(node.target, node.value)

    def resolve_lock(self, expr: ast.AST) -> Optional[Tuple[str, bool, str]]:
        """(lockid, via_self, kind) when ``expr`` denotes a known lock."""
        if isinstance(expr, ast.Name):
            if expr.id in self.local_locks:
                lid, kind = self.local_locks[expr.id]
                return lid, False, kind
            if expr.id in self.mod.module_locks:
                return (f"{self.mod.parts[-1]}.{expr.id}", False,
                        self.mod.module_locks[expr.id])
            if expr.id in self.mod.import_from:
                modref, orig = self.mod.import_from[expr.id]
                t = self.project.find_mod(modref, self.mod)
                if t is not None and orig in t.module_locks:
                    return (f"{t.parts[-1]}.{orig}", False,
                            t.module_locks[orig])
            return None
        if not isinstance(expr, ast.Attribute):
            return None
        attr = expr.attr
        if isinstance(expr.value, ast.Name) and expr.value.id == "self" \
                and self.cls is not None:
            hit = self.project.find_lock_attr(self.cls, attr)
            if hit is not None:
                defcls, kind = hit
                return f"{defcls.name}.{attr}", True, kind
            return None
        # typed receiver: unique lock-owning candidate wins
        hits = []
        for tname in self.expr_types(expr.value):
            c = self.project.resolve_class(tname)
            if c is not None:
                hit = self.project.find_lock_attr(c, attr)
                if hit is not None:
                    hits.append(hit)
        ids = {(dc.name, kind) for dc, kind in hits}
        if len(ids) == 1:
            (defname, kind), = ids
            return f"{defname}.{attr}", False, kind
        # module-qualified lock: native._lock style
        modref = self.mod.module_alias.get(_dotted(expr.value), "")
        if modref:
            t = self.project.find_mod(modref, self.mod)
            if t is not None and attr in t.module_locks:
                return (f"{t.parts[-1]}.{attr}", False,
                        t.module_locks[attr])
        return None

    def resolve_call(self, call: ast.Call) -> Tuple[List[_FnKey], bool]:
        """(callee fn keys, receiver-is-literal-self)."""
        func = call.func
        if isinstance(func, ast.Name):
            name = func.id
            if name in self.mod.functions:
                return [(self.mod.parts, None, name)], False
            if name in self.mod.import_from:
                modref, orig = self.mod.import_from[name]
                t = self.project.find_mod(modref, self.mod)
                if t is not None and orig in t.functions:
                    return [(t.parts, None, orig)], False
            return [], False
        if not isinstance(func, ast.Attribute):
            return [], False
        mname = func.attr
        recv = func.value
        if isinstance(recv, ast.Name) and recv.id == "self" \
                and self.cls is not None:
            hit = self.project.find_method(self.cls, mname)
            if hit is not None:
                defcls, _ = hit
                return [(defcls.mod.parts, defcls.name, mname)], True
            return [], False
        keys: List[_FnKey] = []
        for tname in self.expr_types(recv):
            c = self.project.resolve_class(tname)
            if c is not None:
                hit = self.project.find_method(c, mname)
                if hit is not None:
                    defcls, _ = hit
                    keys.append((defcls.mod.parts, defcls.name, mname))
        if keys:
            return sorted(set(keys)), False
        modref = self.mod.module_alias.get(_dotted(recv), "")
        if modref:
            t = self.project.find_mod(modref, self.mod)
            if t is not None and mname in t.functions:
                return [(t.parts, None, mname)], False
        # unique-method fallback: exactly one class in the whole linted
        # set defines this (non-common) method name
        if mname not in _COMMON_METHODS:
            owners = self.project.methods_by_name.get(mname, [])
            if len(owners) == 1:
                c = owners[0]
                return [(c.mod.parts, c.name, mname)], False
        return [], False


def _shallow_walk_body(fn: ast.AST):
    """Walk a function's body without descending into nested defs,
    lambdas, or class bodies."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        n = stack.pop()
        yield n
        if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef, ast.Lambda)):
            stack.extend(ast.iter_child_nodes(n))


def _inorder(node: ast.AST):
    """Source-order expression walk within one statement, not crossing
    nested function/class/lambda scopes."""
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef, ast.Lambda)):
            continue
        yield child
        yield from _inorder(child)


def _self_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) \
            and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


class _Analyzer:
    """Lexical pass over one function: tracks the set of locks held at
    every point, records acquire/call/block/write events into the
    function's facts, and emits the purely-lexical findings (RL004,
    RL006, RL002's reentrancy half, RL005's raw thread ctors)."""

    def __init__(self, ctx: _FnCtx, facts: _FnFacts,
                 findings: List[Finding],
                 thread_ctors: List[Tuple]):
        self.ctx = ctx
        self.facts = facts
        self.findings = findings
        self.thread_ctors = thread_ctors
        self.path = ctx.mod.path

    # -- statement walker ---------------------------------------------------
    def walk(self) -> None:
        self._walk_body(list(getattr(self.facts.node, "body", [])),
                        [], 0)

    def _walk_body(self, stmts: Sequence[ast.stmt], held: List[_Held],
                   in_while: int) -> None:
        held = list(held)
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                new: List[_Held] = []
                for item in stmt.items:
                    r = self.ctx.resolve_lock(item.context_expr)
                    if r is not None:
                        lid, via_self, kind = r
                        h = _Held(lid, via_self, False, kind)
                        self._on_acquire(h, held + new,
                                         item.context_expr)
                        new.append(h)
                    else:
                        self._scan_expr(item.context_expr, held + new,
                                        in_while)
                self._walk_body(stmt.body, held + new, in_while)
            elif isinstance(stmt, ast.If):
                self._scan_expr(stmt.test, held, in_while)
                self._walk_body(stmt.body, held, in_while)
                self._walk_body(stmt.orelse, held, in_while)
            elif isinstance(stmt, ast.While):
                self._scan_expr(stmt.test, held, in_while + 1)
                self._walk_body(stmt.body, held, in_while + 1)
                self._walk_body(stmt.orelse, held, in_while)
            elif isinstance(stmt, ast.For):
                self._scan_expr(stmt.iter, held, in_while)
                self._walk_body(stmt.body, held, in_while)
                self._walk_body(stmt.orelse, held, in_while)
            elif isinstance(stmt, ast.Try):
                self._walk_body(stmt.body, held, in_while)
                for h in stmt.handlers:
                    self._walk_body(h.body, held, in_while)
                self._walk_body(stmt.orelse, held, in_while)
                self._walk_body(stmt.finalbody, held, in_while)
            else:
                self._scan_stmt(stmt, held, in_while)

    # -- events -------------------------------------------------------------
    def _on_acquire(self, new: _Held, held: List[_Held],
                    site: ast.AST) -> None:
        self.facts.acquire_events.append(
            (tuple(held), new, site.lineno, site.col_offset))
        # reentrant self-acquire of a non-reentrant Lock is a definite
        # single-thread deadlock (with self._lock: ... with self._lock:)
        if new.kind == "lock" and not new.timed:
            for h in held:
                if h.lockid == new.lockid and h.via_self and new.via_self:
                    self.findings.append(Finding(
                        "RL002", self.path, site.lineno,
                        site.col_offset,
                        f"reentrant acquire of non-reentrant lock "
                        f"{new.lockid} already held by this thread — "
                        f"deadlock (use RLock or hoist the outer "
                        f"acquire)"))
                    break

    def _scan_stmt(self, stmt: ast.stmt, held: List[_Held],
                   in_while: int) -> None:
        self._record_writes(stmt, held)
        self._scan_expr(stmt, held, in_while)

    def _record_writes(self, stmt: ast.stmt, held: List[_Held]) -> None:
        if self.ctx.cls is None \
                or self.facts.key[2].split(".")[0] == "__init__":
            return
        targets: List[ast.AST] = []
        if isinstance(stmt, ast.Assign):
            targets = list(stmt.targets)
        elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
            targets = [stmt.target]
        elif isinstance(stmt, ast.Delete):
            targets = list(stmt.targets)
        attrs: List[Tuple[str, ast.AST]] = []
        for tgt in targets:
            els = tgt.elts if isinstance(tgt, (ast.Tuple, ast.List)) \
                else [tgt]
            for el in els:
                a = _self_attr(el)
                if a is not None and isinstance(stmt, (ast.Assign,
                                                       ast.AugAssign,
                                                       ast.AnnAssign)):
                    attrs.append((a, el))
                elif isinstance(el, ast.Subscript):
                    a = _self_attr(el.value)
                    if a is not None:
                        attrs.append((a, el))
        # mutator calls: self.X.append(...)
        for node in _inorder(stmt):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _MUTATORS:
                a = _self_attr(node.func.value)
                if a is not None:
                    attrs.append((a, node))
        self_locks = frozenset(h.lockid for h in held if h.via_self)
        for attr, node in attrs:
            self.facts.write_events.append(
                (attr, self_locks, node.lineno, node.col_offset))

    def _scan_expr(self, root: ast.AST, held: List[_Held],
                   in_while: int) -> None:
        nodes = [root] if isinstance(root, ast.expr) else []
        nodes += list(_inorder(root))
        for node in nodes:
            if not isinstance(node, ast.Call):
                if isinstance(node, ast.expr):
                    self._check_wallclock(node)
                continue
            func = node.func
            if isinstance(func, ast.Attribute):
                recv_lock = self.ctx.resolve_lock(func.value)
                if func.attr == "acquire" and recv_lock is not None:
                    lid, via_self, kind = recv_lock
                    timed = any(kw.arg == "timeout"
                                for kw in node.keywords) \
                        or len(node.args) > 1 \
                        or (len(node.args) == 1
                            and not (isinstance(node.args[0], ast.Constant)
                                     and node.args[0].value is True))
                    h = _Held(lid, via_self, timed, kind)
                    self._on_acquire(h, held, node)
                    held.append(h)
                    continue
                if func.attr == "release" and recv_lock is not None:
                    lid = recv_lock[0]
                    for i in range(len(held) - 1, -1, -1):
                        if held[i].lockid == lid:
                            del held[i]
                            break
                    continue
                if recv_lock is not None and recv_lock[2] == "condition" \
                        and func.attr in ("wait", "wait_for", "notify",
                                          "notify_all"):
                    self._check_condvar(node, func.attr, recv_lock,
                                        held, in_while)
                    continue
            if self.ctx.mod.ctor_kind(node) == "thread":
                self.thread_ctors.append((self.ctx.mod, node))
                continue
            desc = self._blocking_desc(node)
            if desc is not None:
                self.facts.block_events.append(
                    (desc, tuple(held), node.lineno, node.col_offset))
                continue
            keys, via_self = self.ctx.resolve_call(node)
            if keys:
                self.facts.call_events.append(
                    (keys, via_self, tuple(held), node.lineno,
                     node.col_offset, _dotted(node.func) or "<call>"))

    # -- rule helpers -------------------------------------------------------
    def _blocking_desc(self, call: ast.Call) -> Optional[str]:
        func = call.func
        name = _last(func)
        base = _dotted(func).rsplit(".", 1)[0] \
            if isinstance(func, ast.Attribute) else ""
        mod = self.ctx.mod
        if base in mod.time_aliases and name == "sleep":
            return "time.sleep()"
        if mod.module_alias.get(base) == "select" \
                and name in ("select", "poll", "epoll"):
            return f"select.{name}()"
        if mod.module_alias.get(base) == "subprocess" \
                and name in _BLOCKING_SUBPROCESS:
            return f"subprocess.{name}()"
        if isinstance(func, ast.Name) and name in mod.import_from:
            m, orig = mod.import_from[name]
            if m == "subprocess" and orig in _BLOCKING_SUBPROCESS:
                return f"subprocess.{orig}()"
        # the JAX package's host syncs, kept so that both tools read any
        # tree alike
        if name == "device_get":
            return "jax.device_get() (host-device sync)"
        if name == "block_until_ready":
            return ".block_until_ready() (host-device sync)"
        if isinstance(func, ast.Attribute):
            if name in _BLOCKING_SOCKETISH:
                return f".{name}() (transport/socket I/O)"
            if name in _BLOCKING_ZERO_ARG and not call.args \
                    and not call.keywords:
                return f".{name}() with no timeout"
        return None

    def _check_condvar(self, node: ast.Call, op: str,
                       recv_lock: Tuple[str, bool, str],
                       held: List[_Held], in_while: int) -> None:
        lid = recv_lock[0]
        holds_cv = any(h.lockid == lid for h in held)
        if not holds_cv:
            self.findings.append(Finding(
                "RL004", self.path, node.lineno, node.col_offset,
                f"{op}() on condition {lid} without holding it — "
                f"RuntimeError at runtime, or a lost wakeup"))
        if op == "wait" and not in_while:
            self.findings.append(Finding(
                "RL004", self.path, node.lineno, node.col_offset,
                f"wait() on {lid} outside a while-predicate loop — "
                f"spurious wakeups make the predicate false on return; "
                f"re-test in a while (or use wait_for)"))
        if op in ("wait", "wait_for"):
            others = sorted({h.lockid for h in held
                             if h.lockid != lid})
            if others:
                self.facts.block_events.append(
                    (f"Condition.wait() on {lid}", tuple(
                        h for h in held if h.lockid != lid),
                     node.lineno, node.col_offset))

    def _check_wallclock(self, node: ast.expr) -> None:
        """RL006: time.time() as a direct operand of +/- arithmetic or
        a comparison — deadline/duration math on the wall clock."""
        is_arith = (isinstance(node, ast.BinOp)
                    and isinstance(node.op, (ast.Add, ast.Sub))) \
            or isinstance(node, ast.Compare)
        if not is_arith:
            return
        operands: List[ast.AST] = []
        if isinstance(node, ast.BinOp):
            operands = [node.left, node.right]
        elif isinstance(node, ast.Compare):
            operands = [node.left] + list(node.comparators)
        for opnd in operands:
            if isinstance(opnd, ast.Call) \
                    and isinstance(opnd.func, ast.Attribute) \
                    and opnd.func.attr == "time" \
                    and _dotted(opnd.func.value) in \
                    self.ctx.mod.time_aliases:
                self.findings.append(Finding(
                    "RL006", self.path, opnd.lineno, opnd.col_offset,
                    "time.time() in deadline/duration arithmetic — "
                    "wall clock steps under NTP slew; use "
                    "time.monotonic() for timeouts"))


# ---------------------------------------------------------------------------
# whole-program passes
# ---------------------------------------------------------------------------

def _collect_functions(project: _Project) -> List[_FnCtx]:
    ctxs: List[_FnCtx] = []
    for mod in project.mods:
        for name, fn in mod.functions.items():
            ctxs.append(_FnCtx(project, mod, None, fn,
                               (mod.parts, None, name)))
        for cls in mod.classes.values():
            for name, fn in cls.methods.items():
                ctxs.append(_FnCtx(project, mod, cls, fn,
                                   (mod.parts, cls.name, name)))
                # nested defs (callbacks, thread bodies) get their own
                # facts — entry-held never applies to them
                for sub in ast.walk(fn):
                    if sub is not fn and isinstance(
                            sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        ctxs.append(_FnCtx(
                            project, mod, cls, sub,
                            (mod.parts, cls.name,
                             f"{name}.{sub.name}")))
    return ctxs


def _fn_label(key: _FnKey) -> str:
    mod = key[0][-1] if key[0] else "?"
    if key[1]:
        return f"{key[1]}.{key[2]}"
    return f"{mod}.{key[2]}"


def _fixpoint_acquires(project: _Project
                       ) -> Dict[_FnKey, Dict[str, Tuple[bool, str]]]:
    """lockid -> (timed, via) each function eventually acquires,
    propagated through resolved calls."""
    ev: Dict[_FnKey, Dict[str, Tuple[bool, str]]] = {}
    for key, facts in project.facts.items():
        d: Dict[str, Tuple[bool, str]] = {}
        for _held, h, _l, _c in facts.acquire_events:
            prev = d.get(h.lockid)
            if prev is None or (prev[0] and not h.timed):
                d[h.lockid] = (h.timed, "")
        ev[key] = d
    for _ in range(24):
        changed = False
        for key, facts in project.facts.items():
            d = ev[key]
            for keys, _vs, _held, _l, _c, _label in facts.call_events:
                for k2 in keys:
                    for lid, (timed, via) in ev.get(k2, {}).items():
                        nvia = f"via {_fn_label(k2)}()" \
                            if not via else f"via {_fn_label(k2)}() {via}"
                        prev = d.get(lid)
                        if prev is None:
                            d[lid] = (timed, nvia)
                            changed = True
                        elif prev[0] and not timed:
                            d[lid] = (timed, nvia)
                            changed = True
        if not changed:
            break
    return ev


def _fixpoint_blocking(project: _Project
                       ) -> Dict[_FnKey, Tuple[str, str]]:
    """First blocking operation each function eventually reaches
    (desc, via-chain), propagated through resolved calls."""
    ev: Dict[_FnKey, Tuple[str, str]] = {}
    for key, facts in project.facts.items():
        if facts.block_events:
            desc = facts.block_events[0][0]
            ev[key] = (desc, "")
    for _ in range(24):
        changed = False
        for key, facts in project.facts.items():
            if key in ev:
                continue
            for keys, _vs, _held, _l, _c, _label in facts.call_events:
                for k2 in keys:
                    if k2 in ev:
                        desc, via = ev[k2]
                        nvia = f"via {_fn_label(k2)}()" if not via \
                            else f"via {_fn_label(k2)}() {via}"
                        ev[key] = (desc, nvia)
                        changed = True
                        break
                if key in ev:
                    break
        if not changed:
            break
    return ev


def _fixpoint_entry_held(project: _Project
                         ) -> Dict[_FnKey, Optional[frozenset]]:
    """For each private method, the set of own-instance locks held at
    EVERY resolved self-call site (None = never observed called = no
    evidence either way; treated as guarded so never-called helpers
    don't flood RL001)."""
    entry: Dict[_FnKey, Optional[frozenset]] = {
        key: None for key, f in project.facts.items()
        if f.is_private and key[1] is not None}
    for _ in range(24):
        changed = False
        for key, facts in project.facts.items():
            caller_entry = entry.get(key)
            for keys, via_self, held, _l, _c, _label in facts.call_events:
                for k2 in keys:
                    if k2 not in entry:
                        continue
                    if via_self and key[1] is not None:
                        if caller_entry is None and key in entry:
                            # unconstrained caller: skip this site
                            continue
                        contrib = frozenset(
                            h.lockid for h in held if h.via_self)
                        if key in entry and caller_entry is not None:
                            contrib |= caller_entry
                    else:
                        contrib = frozenset()
                    cur = entry[k2]
                    new = contrib if cur is None else (cur & contrib)
                    if new != cur:
                        entry[k2] = new
                        changed = True
        if not changed:
            break
    return entry


def _check_lock_guards(project: _Project,
                       entry: Dict[_FnKey, Optional[frozenset]],
                       out: Dict[str, List[Finding]]) -> None:
    """RL001: per (class, attr), if some writes happen under an
    own-instance lock and others under none, flag the unguarded
    sites."""
    per_attr: Dict[Tuple[str, str], List[Tuple]] = {}
    for key, facts in project.facts.items():
        if facts.cls is None:
            continue
        extra: frozenset = frozenset()
        if key in entry:
            e = entry[key]
            if e is None:
                continue       # never-observed-called private helper
            extra = e
        for attr, self_locks, line, col in facts.write_events:
            if project.excluded_attr(facts.cls, attr):
                continue
            eff = self_locks | extra
            per_attr.setdefault((facts.cls.name, attr), []).append(
                (eff, facts.mod.path, line, col))
    for (cls_name, attr), events in per_attr.items():
        guarded = [e for e in events if e[0]]
        unguarded = [e for e in events if not e[0]]
        if not guarded or not unguarded:
            continue
        locks: Dict[str, int] = {}
        for eff, _p, _l, _c in guarded:
            for lid in eff:
                locks[lid] = locks.get(lid, 0) + 1
        guard = max(locks, key=lambda k: locks[k])
        for _eff, path, line, col in unguarded:
            out.setdefault(path, []).append(Finding(
                "RL001", path, line, col,
                f"'self.{attr}' written without {guard}, which guards "
                f"{len(guarded)} of {len(events)} writes to it in "
                f"{cls_name} — data-race candidate"))


class _Edge(NamedTuple):
    src: str
    dst: str
    path: str
    line: int
    col: int
    timed: bool
    via: str


def _collect_edges(project: _Project,
                   eventual: Dict[_FnKey, Dict[str, Tuple[bool, str]]]
                   ) -> List[_Edge]:
    edges: List[_Edge] = []
    for key, facts in project.facts.items():
        for held, h, line, col in facts.acquire_events:
            for hh in held:
                if hh.lockid != h.lockid:
                    edges.append(_Edge(hh.lockid, h.lockid,
                                       facts.mod.path, line, col,
                                       h.timed, ""))
        for keys, _vs, held, line, col, label in facts.call_events:
            if not held:
                continue
            for k2 in keys:
                for lid, (timed, via) in eventual.get(k2, {}).items():
                    for hh in held:
                        if hh.lockid != lid:
                            edges.append(_Edge(
                                hh.lockid, lid, facts.mod.path, line,
                                col, timed,
                                via or f"via {_fn_label(k2)}()"))
    return edges


def _check_lock_order(edges: List[_Edge],
                      out: Dict[str, List[Finding]]) -> None:
    """RL002's cycle half: Tarjan SCC over untimed cross-lock edges;
    every SCC with more than one lock is a potential deadlock."""
    graph: Dict[str, Set[str]] = {}
    sites: Dict[Tuple[str, str], _Edge] = {}
    for e in edges:
        if e.timed or e.src == e.dst:
            continue
        graph.setdefault(e.src, set()).add(e.dst)
        graph.setdefault(e.dst, set())
        k = (e.src, e.dst)
        if k not in sites or (e.path, e.line) < (sites[k].path,
                                                 sites[k].line):
            sites[k] = e

    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    sccs: List[List[str]] = []
    counter = [0]

    def strongconnect(v: str) -> None:
        work = [(v, iter(sorted(graph[v])))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(graph[w]))))
                    advanced = True
                    break
                if w in on_stack:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                sccs.append(comp)

    for v in sorted(graph):
        if v not in index:
            strongconnect(v)

    for comp in sccs:
        if len(comp) < 2:
            continue
        comp_set = set(comp)
        cyc_edges = sorted(
            (sites[(a, b)] for (a, b) in sites
             if a in comp_set and b in comp_set),
            key=lambda e: (e.path, e.line, e.col))
        if not cyc_edges:
            continue
        anchor = cyc_edges[0]
        detail = "; ".join(
            f"{e.src} -> {e.dst} at {e.path}:{e.line}"
            + (f" ({e.via})" if e.via else "")
            for e in cyc_edges[:6])
        out.setdefault(anchor.path, []).append(Finding(
            "RL002", anchor.path, anchor.line, anchor.col,
            f"lock-order cycle over {{{', '.join(sorted(comp_set))}}} "
            f"— potential deadlock: {detail}"))


def _check_blocking(project: _Project,
                    blocking: Dict[_FnKey, Tuple[str, str]],
                    out: Dict[str, List[Finding]]) -> None:
    """RL003: blocking operations at sites where a lock is LEXICALLY
    held (the caller holding the lock owns the finding; callees are not
    re-flagged for their callers' locks)."""
    for key, facts in project.facts.items():
        path = facts.mod.path
        for desc, held, line, col in facts.block_events:
            if not held:
                continue
            locks = ", ".join(sorted({h.lockid for h in held}))
            out.setdefault(path, []).append(Finding(
                "RL003", path, line, col,
                f"blocking {desc} while holding {locks} — every other "
                f"thread contending on the lock stalls behind this"))
        for keys, _vs, held, line, col, label in facts.call_events:
            if not held:
                continue
            for k2 in keys:
                if k2 in blocking:
                    desc, via = blocking[k2]
                    locks = ", ".join(sorted({h.lockid for h in held}))
                    chain = f"{via} " if via else ""
                    out.setdefault(path, []).append(Finding(
                        "RL003", path, line, col,
                        f"call to {label}() reaches blocking {desc} "
                        f"({chain}while holding {locks})"))
                    break


def _check_thread_lifecycle(thread_ctors: List[Tuple],
                            out: Dict[str, List[Finding]]) -> None:
    """RL005: threads constructed without daemon=True and never joined
    anywhere in their module — they outlive shutdown."""
    for mod, call in thread_ctors:
        daemon = None
        for kw in call.keywords:
            if kw.arg == "daemon" and isinstance(kw.value, ast.Constant):
                daemon = bool(kw.value.value)
        if daemon:
            continue
        target = None
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Assign) and node.value is call \
                    and len(node.targets) == 1:
                target = _last(node.targets[0])
        joined = daemoned = False
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "join":
                if target is None or _last(node.func.value) == target:
                    joined = True
            elif isinstance(node, ast.Assign) \
                    and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Attribute) \
                    and node.targets[0].attr == "daemon":
                if target is None \
                        or _last(node.targets[0].value) == target:
                    daemoned = True
        if joined or daemoned:
            continue
        what = f"'{target}'" if target else "anonymous thread"
        out.setdefault(mod.path, []).append(Finding(
            "RL005", mod.path, call.lineno, call.col_offset,
            f"non-daemon thread {what} is never joined — it outlives "
            f"shutdown and wedges interpreter exit (set daemon=True "
            f"or join it on the shutdown path)"))


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def _analyze(mods: List[_Mod]) -> Tuple[Dict[str, List[Finding]],
                                        List[_Edge]]:
    project = _Project(mods)
    per_path: Dict[str, List[Finding]] = {m.path: [] for m in mods}
    thread_ctors: List[Tuple] = []
    for ctx in _collect_functions(project):
        facts = _FnFacts(ctx.key, ctx.node, ctx.cls, ctx.mod)
        project.facts[ctx.key] = facts
        lexical: List[Finding] = []
        _Analyzer(ctx, facts, lexical, thread_ctors).walk()
        per_path.setdefault(ctx.mod.path, []).extend(lexical)

    eventual = _fixpoint_acquires(project)
    blocking = _fixpoint_blocking(project)
    entry = _fixpoint_entry_held(project)
    edges = _collect_edges(project, eventual)

    _check_lock_guards(project, entry, per_path)
    _check_lock_order(edges, per_path)
    _check_blocking(project, blocking, per_path)
    _check_thread_lifecycle(thread_ctors, per_path)
    return per_path, edges


def _attr_type_pass(project_mods: List[_Mod]) -> None:
    """Cross-object attribute typing: ``r.engine = engine`` where ``r``
    is typed ``_Replica`` and ``engine`` is an ``Engine(...)`` records
    Engine as a candidate type for ``_Replica.engine``. Two rounds so a
    type learned in round one can feed a chain in round two."""
    project = _Project(project_mods)
    for _ in range(2):
        for mod in project_mods:
            fns: List[Tuple[Optional[_ClassInfo], str, ast.AST]] = \
                [(None, n, f) for n, f in mod.functions.items()]
            for cls in mod.classes.values():
                fns.extend((cls, n, f) for n, f in cls.methods.items())
            for cls, name, fn in fns:
                ctx = _FnCtx(project, mod, cls, fn,
                             (mod.parts, cls.name if cls else None,
                              name))

                def bind_attr(tgt: ast.AST, val: ast.AST) -> None:
                    if isinstance(tgt, ast.Attribute):
                        vtypes = {t for t in ctx.expr_types(val)
                                  if project.resolve_class(t)}
                        if not vtypes:
                            return
                        for rname in ctx.expr_types(tgt.value):
                            c = project.resolve_class(rname)
                            if c is not None:
                                c.attr_types.setdefault(
                                    tgt.attr, set()).update(vtypes)
                    elif isinstance(tgt, (ast.Tuple, ast.List)) \
                            and isinstance(val, (ast.Tuple, ast.List)) \
                            and len(tgt.elts) == len(val.elts):
                        for t, v in zip(tgt.elts, val.elts):
                            bind_attr(t, v)

                for node in _shallow_walk_body(fn):
                    if isinstance(node, ast.Assign) \
                            and len(node.targets) == 1:
                        bind_attr(node.targets[0], node.value)
                    elif isinstance(node, ast.AnnAssign) \
                            and isinstance(node.target, ast.Attribute):
                        names = _ann_class_names(node.annotation)
                        names = {n for n in names
                                 if project.resolve_class(n)}
                        if names:
                            for rname in ctx.expr_types(
                                    node.target.value):
                                c = project.resolve_class(rname)
                                if c is not None:
                                    c.attr_types.setdefault(
                                        node.target.attr,
                                        set()).update(names)


def _lint_mods(mods: List[_Mod]) -> List[Finding]:
    _attr_type_pass(mods)
    per_path, _edges = _analyze(mods)
    out: List[Finding] = []
    by_path = {m.path: m for m in mods}
    for path, findings in per_path.items():
        mod = by_path.get(path)
        src = mod.src if mod is not None else ""
        out.extend(lintcore.filter_findings(findings, src, "racelint",
                                            RULES))
    out.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return out


def lint_source(src: str, path: str = "<string>") -> List[Finding]:
    """Single-file mode (fixtures and tests) — same rules, no
    cross-module knowledge."""
    return _lint_mods([_Mod(path, src)])


def lint_file(path: Path) -> List[Finding]:
    return lint_source(path.read_text(encoding="utf-8"), str(path))


def lint_files(paths: Sequence[Path]) -> List[Finding]:
    """Project mode: whole-program analysis over every file (what
    ``main`` and the repo-clean test run). An unparseable file raises
    SyntaxError up front (``main`` reports per-file and lints the
    rest)."""
    return _lint_mods([_Mod(str(p), Path(p).read_text(encoding="utf-8"))
                       for p in paths])


def lock_order_edges(paths: Sequence[Path]) -> Set[Tuple[str, str]]:
    """The statically computed acquires-while-holding graph over
    ``paths`` as (held, acquired) lock-id pairs — including timed
    acquires, excluding same-lock (cross-instance) pairs. guards.py's
    LockOrderRecorder asserts the runtime-observed order is a subset of
    this set, which is how the static graph is validated by tests
    rather than trusted."""
    mods = [_Mod(str(p), Path(p).read_text(encoding="utf-8"))
            for p in paths]
    _attr_type_pass(mods)
    _per_path, edges = _analyze(mods)
    return {(e.src, e.dst) for e in edges if e.src != e.dst}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="racelint",
        description="whole-program concurrency lint for the threaded "
                    "serve tier (docs/STATIC_ANALYSIS.md)")
    ap.add_argument("paths", nargs="*",
                    default=["dalle_pytorch_tpu_torch"],
                    help="files or directories (default: the package)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable findings on stdout")
    ap.add_argument("--select", default="",
                    help="comma-separated rule ids to run (default all)")
    ap.add_argument("--ignore", default="",
                    help="comma-separated rule ids to skip")
    ap.add_argument("--no-default-excludes", action="store_true",
                    help=f"also lint {DEFAULT_EXCLUDES} (the linters' "
                         f"own true-positive corpora)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rid, (slug, desc) in sorted(RULES.items()):
            print(f"{rid}  {slug:22s} {desc}")
        return 0

    select = {r.strip().upper() for r in args.select.split(",")
              if r.strip()}
    ignore = {r.strip().upper() for r in args.ignore.split(",")
              if r.strip()}
    bad = (select | ignore) - set(RULES)
    if bad:
        print(f"racelint: unknown rule(s): {', '.join(sorted(bad))}",
              file=sys.stderr)
        return 2

    excludes = () if args.no_default_excludes else DEFAULT_EXCLUDES
    files = iter_py_files(args.paths, excludes)
    if not files:
        print("racelint: no python files found", file=sys.stderr)
        return 2

    mods: List[_Mod] = []
    errors = 0
    for f in files:
        try:
            mods.append(_Mod(str(f), f.read_text(encoding="utf-8")))
        except SyntaxError as e:
            errors += 1
            print(f"{f}:{e.lineno or 0}:0: parse error: {e.msg}",
                  file=sys.stderr)
    findings = _lint_mods(mods)
    if select:
        findings = [f for f in findings if f.rule in select]
    if ignore:
        findings = [f for f in findings if f.rule not in ignore]

    if args.as_json:
        print(json.dumps({"findings": [f.to_dict() for f in findings],
                          "files": len(files)}, indent=2))
    else:
        for f in findings:
            print(f.render())
        n = len(findings)
        print(f"racelint: {n} finding{'s' if n != 1 else ''} in "
              f"{len(files)} files", file=sys.stderr)
    if errors:
        return 2
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
