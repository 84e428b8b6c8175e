"""Static concurrency analyzer — thread-safety lints over the AST (the
port of ``deeplearning4j_tpu/analysis/concurrency.py``).

The production fit/serve path now runs 10+ cooperating threads
(DevicePrefetcher and AsyncDataSetIterator workers, the async
checkpoint writer, DispatchWatchdog dispatch threads, ModelServer's
serve/drainer threads, UIServer's HTTP pool), and the bug class this
breeds — a bare read-modify-write on a shared counter, the
``ModelServer._count`` lost-increment — is exactly the kind review
misses and tooling catches (the TensorFlow/PyGraph systems-paper
position: async-runtime correctness must be checked mechanically, not
socially). This module is the static half of that tooling; the dynamic
halves are :mod:`deeplearning4j_tpu_torch.profiler.locks` (instrumented
locks + runtime lock-order witness) and the seeded interleaving
harness in :mod:`deeplearning4j_tpu_torch.faults`.

What it infers, per class, with no imports executed (pure ``ast``):

- **Thread entry points** — methods passed as ``threading.Thread(
  target=self.m)`` anywhere in the class, plus ``run`` on
  ``threading.Thread`` subclasses; the *thread-reachable* set is their
  closure over ``self.m()`` calls.  MODULE-LEVEL functions spawned via
  ``Thread(target=fn)`` get the same analysis over the module's
  globals (rebinding through ``global``, container mutation, subscript
  stores) against module-level locks; a Thread on a local closure or a
  bound method resolves to no module function and contributes nothing.
- **Shared state** — attributes the thread-reachable methods touch
  that are also touched by ``__init__`` or any main-side method
  (the cross-thread-visible object contract). Attributes holding
  thread-safe primitives (locks, queues, events) are exempt.
- **Lock guards** — ``with self._lock:`` scopes over attributes
  assigned ``threading.Lock/RLock/Condition`` (or their instrumented
  wrappers from ``profiler.locks``); a lock-owning class additionally
  promises that state it ever touches under a lock is touched under
  the lock everywhere.

Diagnostic codes (E = error, W = warning; all in ``DIAGNOSTIC_CODES``
with per-code suppression and ``# dl4j: noqa=E201`` line comments):

- ``E201`` unguarded cross-thread mutation of shared state
- ``E202`` read-modify-write on shared state outside any lock
  (the lost-increment class: ``self._count += 1``)
- ``E203`` lock-order cycle in the static acquisition graph
  (potential deadlock)
- ``W210`` ``time.time()`` in deadline/timeout arithmetic (NTP steps
  wall clock; use ``time.monotonic()``)
- ``W211`` ``Condition.wait()`` outside a predicate loop (spurious /
  stolen wakeups)
- ``W212`` a stored worker thread with no ``join()`` on any
  close/drain path
- ``W213`` double-checked / lazy attribute initialization without a
  lock (racing initializers)

Entry points: :func:`analyze_concurrency` over a file, directory, or
module name; ``python -m deeplearning4j_tpu_torch.analysis --concurrency
<target>`` (with no target it lints this package); the tests keep the
whole package clean.

It lints source text and never executes it (module targets are
resolved via ``importlib.util.find_spec`` without import).
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from deeplearning4j_tpu_torch.analysis.diagnostics import (
    Diagnostic, Severity, ValidationReport)

#: constructors (last dotted name) that create lock-like objects
LOCK_CTORS = frozenset({
    "Lock", "RLock", "Condition", "InstrumentedLock", "InstrumentedRLock",
    "InstrumentedCondition", "instrumented_lock", "instrumented_rlock",
    "instrumented_condition",
})
CONDITION_CTORS = frozenset({"Condition", "InstrumentedCondition",
                             "instrumented_condition"})
#: thread-safe primitives: calling methods on (or sharing) these is fine
THREADSAFE_CTORS = LOCK_CTORS | frozenset({
    "Queue", "LifoQueue", "PriorityQueue", "SimpleQueue",
    "InstrumentedQueue", "Event", "Semaphore", "BoundedSemaphore",
    "Barrier", "local",
})
#: plain-container constructors whose mutating METHOD calls count as writes
MUTABLE_CTORS = frozenset({"list", "dict", "set", "deque", "Counter",
                           "defaultdict", "OrderedDict"})
#: try/except statement forms (TryStar is py3.11+)
_TRY_TYPES = (ast.Try,) + ((ast.TryStar,) if hasattr(ast, "TryStar") else ())

MUTATING_METHODS = frozenset({
    "append", "extend", "insert", "remove", "sort", "reverse", "add",
    "discard", "update", "setdefault", "popitem", "appendleft", "popleft",
    "extendleft", "rotate", "clear", "pop",
})

#: a code is ``E201`` / ``DL4J-E201``; the codes group stops at the first
#: non-code token so trailing prose cannot corrupt the suppression set
_NOQA_RE = re.compile(
    r"#\s*dl4j:\s*noqa(?P<eq>\s*=\s*)?"
    r"(?(eq)(?P<codes>(?:DL4J-)?[A-Z]+[0-9]+"
    r"(?:\s*,\s*(?:DL4J-)?[A-Z]+[0-9]+)*)?)", re.I)


def _last_name(node) -> Optional[str]:
    """Last dotted component of a call target: ``threading.Lock`` ->
    ``Lock``, ``Lock`` -> ``Lock``."""
    if isinstance(node, ast.Call):
        node = node.func
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _self_attr(node) -> Optional[str]:
    """``self.X`` -> ``"X"`` (else None)."""
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


def _reads_of(node) -> Set[str]:
    """Every ``self.X`` loaded anywhere under ``node``."""
    out = set()
    for n in ast.walk(node):
        a = _self_attr(n)
        if a is not None and isinstance(n.ctx, ast.Load):
            out.add(a)
    return out


def _name_reads_of(node) -> Set[str]:
    """Every bare NAME loaded anywhere under ``node`` (module-global
    read-modify-write detection)."""
    return {n.id for n in ast.walk(node)
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)}


class _Write:
    __slots__ = ("attr", "line", "rmw", "guarded", "method")

    def __init__(self, attr, line, rmw, guarded, method):
        self.attr, self.line, self.rmw = attr, line, rmw
        self.guarded, self.method = guarded, method


class _MethodScan:
    """Everything one method contributes to the class-level analysis."""

    def __init__(self, name: str):
        self.name = name
        self.reads: List[Tuple[str, bool]] = []        # (attr, guarded)
        self.writes: List[_Write] = []
        # (callee, held-guards, call line) / (attr, method, held, line)
        self.self_calls: List[Tuple[str, Tuple[str, ...], int]] = []
        self.typed_calls: List[Tuple[str, str, Tuple[str, ...], int]] = []
        self.acquisitions: List[Tuple[str, Tuple[str, ...], int]] = []
        self.waits: List[Tuple[str, int, bool]] = []   # (attr, line, in_loop)
        self.lazy_inits: List[Tuple[str, int, bool]] = []  # (attr, line, safe)
        self.joins: Set[str] = set()


class _ClassScan:
    def __init__(self, name: str, path: str, node: ast.ClassDef):
        self.name, self.path, self.node = name, path, node
        self.methods: Dict[str, _MethodScan] = {}
        self.lock_attrs: Dict[str, str] = {}       # attr -> ctor name
        self.init_ctors: Dict[str, str] = {}       # attr -> ctor last name
        self.mutable_attrs: Set[str] = set()
        self.attr_types: Dict[str, str] = {}       # attr -> class name
        self.entries: Set[str] = set()
        self.creates_threads = False
        self.thread_attrs: Dict[str, int] = {}     # attr -> line
        self.is_thread_subclass = False

    # -- derived ---------------------------------------------------------
    def condition_attrs(self) -> Set[str]:
        return {a for a, c in self.lock_attrs.items() if c in CONDITION_CTORS}

    def thread_reachable(self) -> Set[str]:
        """Entries plus the transitive closure over ``self.m()`` calls."""
        seen: Set[str] = set()
        frontier = list(self.entries)
        while frontier:
            m = frontier.pop()
            if m in seen or m not in self.methods:
                continue
            seen.add(m)
            frontier.extend(c for c, _, _ in self.methods[m].self_calls)
        return seen

    def init_only_methods(self) -> Set[str]:
        """Helpers reachable only from ``__init__`` (e.g. a metric's
        ``_init_value``): they run before any thread exists, so their
        writes are constructor writes."""
        callers: Dict[str, Set[str]] = {}
        for m, scan in self.methods.items():
            for callee, _, _ in scan.self_calls:
                callers.setdefault(callee, set()).add(m)
        out: Set[str] = set()
        frontier = [c for c, _, _ in
                    self.methods.get("__init__", _MethodScan("")).self_calls]
        while frontier:
            m = frontier.pop()
            if m in out or m not in self.methods or m == "__init__":
                continue
            if callers.get(m, set()) - out - {"__init__"}:
                continue                # also called from a live method
            out.add(m)
            frontier.extend(c for c, _, _ in self.methods[m].self_calls)
        return out


class _ModuleScan:
    def __init__(self, path: str):
        self.path = path
        self.classes: List[_ClassScan] = []
        self.module_locks: Set[str] = set()
        #: W210 sites found in module-level functions and methods
        self.time_findings: List[Tuple[int, str]] = []
        self.acquisitions: List[Tuple[str, Tuple[str, ...], int]] = []
        #: module-level function scans (E201/E202 over shared globals)
        self.functions: Dict[str, _MethodScan] = {}
        #: module-level functions spawned via ``Thread(target=fn)``
        self.fn_entries: Set[str] = set()
        #: module-level names bound to mutable containers / thread-safe
        #: primitives / anything at all (the shared-global candidates)
        self.module_mutables: Set[str] = set()
        self.module_threadsafe: Set[str] = set()
        self.module_names: Set[str] = set()

    def thread_reachable_functions(self) -> Set[str]:
        """fn_entries plus the closure over plain ``fn()`` calls between
        module-level functions — the module-scope analog of
        ``_ClassScan.thread_reachable``."""
        seen: Set[str] = set()
        frontier = [f for f in self.fn_entries if f in self.functions]
        while frontier:
            f = frontier.pop()
            if f in seen:
                continue
            seen.add(f)
            frontier.extend(c for c, _, _ in self.functions[f].self_calls
                            if c in self.functions)
        return seen


def _is_thread_ctor(call: ast.Call) -> bool:
    return _last_name(call) == "Thread"


def _thread_target_method(call: ast.Call) -> Optional[str]:
    for kw in call.keywords:
        if kw.arg == "target":
            return _self_attr(kw.value)
    return None


def _thread_target_name(call: ast.Call) -> Optional[str]:
    """``Thread(target=fn)`` with a bare NAME target (module functions
    and closures; resolved against module-level defs by the caller)."""
    for kw in call.keywords:
        if kw.arg == "target" and isinstance(kw.value, ast.Name):
            return kw.value.id
    return None


class _Scanner:
    """One pass over a method (or module-level function) body, tracking
    the lexical lock-guard stack and loop depth."""

    def __init__(self, cls: Optional[_ClassScan], scan: _MethodScan,
                 module: _ModuleScan, in_init: bool):
        self.cls = cls
        self.scan = scan
        self.module = module
        self.in_init = in_init
        self.guards: List[str] = []     # lock names currently held
        self.loop_depth = 0
        self._globals: Set[str] = set()  # `global X` names (module fns)
        self._locals: Set[str] = set()   # names LOCAL to the module fn
        # (python scoping: any plain assignment anywhere in the function
        # makes the name local for the WHOLE function — a local that
        # shadows a module global must never be reported as one)

    # -- lock identification --------------------------------------------
    def _lock_name(self, expr) -> Optional[str]:
        """A with-item / call target that denotes a known lock: returns
        its graph-node name (``Class.attr`` or ``module.NAME``)."""
        a = _self_attr(expr)
        if a is not None and self.cls is not None \
                and a in self.cls.lock_attrs:
            return f"{self.cls.name}.{a}"
        if isinstance(expr, ast.Name) and expr.id in self.module.module_locks:
            return f"<module>.{expr.id}"
        return None

    def _guarded(self) -> bool:
        return bool(self.guards)

    # -- statement walk --------------------------------------------------
    def walk(self, stmts: Iterable[ast.stmt]) -> None:
        for node in stmts:
            self._stmt(node)

    def _stmt(self, node: ast.stmt) -> None:
        if isinstance(node, (ast.With, ast.AsyncWith)):
            pushed = 0
            for item in node.items:
                self._expr(item.context_expr)
                lock = self._lock_name(item.context_expr)
                if lock is not None:
                    # one record per acquisition; downstream consumers
                    # (fixpoint sets, add_edge) skip self-edges, so a
                    # re-entrant record is harmless
                    rec = (self.scan.acquisitions if self.cls
                           else self.module.acquisitions)
                    rec.append((lock, tuple(self.guards), node.lineno))
                    self.guards.append(lock)
                    pushed += 1
            self.walk(node.body)
            for _ in range(pushed):
                self.guards.pop()
        elif isinstance(node, (ast.While, ast.For, ast.AsyncFor)):
            self._expr(node.test if isinstance(node, ast.While)
                       else node.iter)
            self.loop_depth += 1
            self.walk(node.body)
            self.walk(node.orelse)
            self.loop_depth -= 1
        elif isinstance(node, ast.If):
            self._lazy_init(node)
            self._expr(node.test)
            self.walk(node.body)
            self.walk(node.orelse)
        elif isinstance(node, _TRY_TYPES):
            self.walk(node.body)
            for h in node.handlers:
                self.walk(h.body)
            self.walk(node.orelse)
            self.walk(node.finalbody)
        elif isinstance(node, ast.Match):
            self._expr(node.subject)
            for case in node.cases:
                if case.guard is not None:
                    self._expr(case.guard)
                self.walk(case.body)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # a closure (e.g. a dispatch thunk) runs with whatever locks
            # its *caller* holds, which we cannot know — scan it with an
            # empty guard stack so a guarded-looking closure body never
            # silences a finding
            saved, self.guards = self.guards, []
            self.walk(node.body)
            self.guards = saved
        elif isinstance(node, ast.Assign):
            self._expr(node.value)
            read = _reads_of(node.value)
            for tgt in node.targets:
                self._assign_target(tgt, node, read)
        elif isinstance(node, ast.AnnAssign):
            if node.value is not None:
                self._expr(node.value)
                self._assign_target(node.target, node,
                                    _reads_of(node.value))
        elif isinstance(node, ast.AugAssign):
            self._expr(node.value)
            attr = _self_attr(node.target)
            if attr is None and isinstance(node.target, ast.Subscript):
                attr = _self_attr(node.target.value)
            if attr is not None:
                self._record_write(attr, node.lineno, rmw=True)
            elif self.cls is None:
                name = self._module_target_name(node.target)
                if name is not None:
                    self._record_write(name, node.lineno, rmw=True)
        else:
            self._expr(node)

    def _module_target_name(self, tgt) -> Optional[str]:
        """A module-function assignment target that denotes module
        state: a ``global``-declared NAME (rebinding), or a subscript /
        known-mutable NAME defined at module level (in-place mutation —
        no ``global`` statement required to ``X[k] = v``).  A name the
        function binds locally shadows the module global and is never
        module state."""
        if isinstance(tgt, ast.Name):
            if tgt.id in self._globals:
                return tgt.id
            return None
        if isinstance(tgt, ast.Subscript) and \
                isinstance(tgt.value, ast.Name) and \
                tgt.value.id in self.module.module_names and \
                tgt.value.id not in self._locals:
            return tgt.value.id
        return None

    def _assign_target(self, tgt, node, read: Set[str]) -> None:
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for el in tgt.elts:
                self._assign_target(el, node, read)
            return
        if self.cls is None:
            name = self._module_target_name(tgt)
            if name is not None:
                self._record_write(name, tgt.lineno,
                                   rmw=name in _name_reads_of(node.value)
                                   if node.value is not None else False)
            return
        attr = _self_attr(tgt)
        sub = None
        if attr is None and isinstance(tgt, ast.Subscript):
            sub = _self_attr(tgt.value)
        if attr is not None:
            if self.in_init and self.cls is not None:
                self._record_init_assign(attr, node)
            self._record_write(attr, tgt.lineno, rmw=attr in read)
        elif sub is not None:
            # self.X[k] = v — mutates the container X
            self._record_write(sub, tgt.lineno, rmw=sub in read)
        if self.cls is not None and isinstance(node, ast.Assign) \
                and isinstance(node.value, ast.Call) \
                and _is_thread_ctor(node.value):
            a = _self_attr(tgt)
            if a is not None:
                self.cls.thread_attrs.setdefault(a, node.lineno)

    def _record_init_assign(self, attr: str, node) -> None:
        value = node.value
        # `self.b = b` where __init__ annotates `b: B` (or `b: "B"`)
        # types the attribute for the cross-class lock graph
        if isinstance(value, ast.Name):
            ptype = getattr(self, "_param_types", {}).get(value.id)
            if ptype:
                self.cls.attr_types.setdefault(attr, ptype)
            return
        ctor = _last_name(value) if isinstance(value, ast.Call) else None
        if ctor:
            self.cls.init_ctors.setdefault(attr, ctor)
            if ctor in LOCK_CTORS:
                self.cls.lock_attrs.setdefault(attr, ctor)
            if ctor in MUTABLE_CTORS:
                self.cls.mutable_attrs.add(attr)
            if ctor[:1].isupper() and ctor not in THREADSAFE_CTORS:
                self.cls.attr_types.setdefault(attr, ctor)
        elif isinstance(value, (ast.List, ast.ListComp)):
            self.cls.mutable_attrs.add(attr)
            self.cls.init_ctors.setdefault(attr, "list")
        elif isinstance(value, (ast.Dict, ast.DictComp)):
            self.cls.mutable_attrs.add(attr)
            self.cls.init_ctors.setdefault(attr, "dict")
        elif isinstance(value, (ast.Set, ast.SetComp)):
            self.cls.mutable_attrs.add(attr)
            self.cls.init_ctors.setdefault(attr, "set")

    def _record_write(self, attr: str, line: int, rmw: bool) -> None:
        self.scan.writes.append(_Write(attr, line, rmw, self._guarded(),
                                       self.scan.name))

    # -- expression walk -------------------------------------------------
    def _expr(self, node) -> None:
        if node is None:
            return
        for n in ast.walk(node):
            a = _self_attr(n)
            if a is not None and isinstance(n.ctx, ast.Load):
                self.scan.reads.append((a, self._guarded()))
            if self.cls is None and isinstance(n, ast.Name) \
                    and isinstance(n.ctx, ast.Load) \
                    and n.id in self.module.module_names \
                    and n.id not in self._locals:
                self.scan.reads.append((n.id, self._guarded()))
            if isinstance(n, ast.Call):
                self._call(n)
            if isinstance(n, (ast.BinOp, ast.Compare)):
                self._time_arith(n)

    def _call(self, call: ast.Call) -> None:
        func = call.func
        if _is_thread_ctor(call):
            if self.cls is not None:
                self.cls.creates_threads = True
                target = _thread_target_method(call)
                if target is not None:
                    self.cls.entries.add(target)
            # Thread(target=module_fn): a MODULE-LEVEL function becomes
            # a thread entry — the globals it shares with the rest of
            # the module are cross-thread state (resolved against the
            # module's function defs later, so closures stay exempt)
            name_target = _thread_target_name(call)
            if name_target is not None:
                self.module.fn_entries.add(name_target)
        # self.m(...)
        attr = _self_attr(func)
        if attr is not None and self.cls is not None:
            self.scan.self_calls.append((attr, tuple(self.guards),
                                         call.lineno))
            return
        # fn(...) in a module-level function: closure edge for the
        # module-scope thread-reachability computation
        if self.cls is None and isinstance(func, ast.Name):
            self.scan.self_calls.append((func.id, tuple(self.guards),
                                         call.lineno))
        # X.m(...) on a module-level mutable in a module function
        if self.cls is None and isinstance(func, ast.Attribute) \
                and isinstance(func.value, ast.Name) \
                and func.value.id in self.module.module_mutables \
                and func.value.id not in self._locals \
                and func.attr in MUTATING_METHODS:
            self._record_write(func.value.id, call.lineno, rmw=False)
        # self.X.m(...)
        if isinstance(func, ast.Attribute):
            owner = _self_attr(func.value)
            if owner is not None and self.cls is not None:
                meth = func.attr
                if meth == "join":
                    self.scan.joins.add(owner)
                if meth == "wait" and owner in self.cls.condition_attrs():
                    self.scan.waits.append((owner, call.lineno,
                                            self.loop_depth > 0))
                if meth in MUTATING_METHODS \
                        and owner in self.cls.mutable_attrs:
                    self._record_write(owner, call.lineno, rmw=False)
                if owner in self.cls.attr_types:
                    self.scan.typed_calls.append(
                        (owner, meth, tuple(self.guards), call.lineno))

    # -- W210: wall clock in deadline arithmetic ------------------------
    def _time_arith(self, node) -> None:
        """``time.time()`` (or a name/attr assigned from it) as an
        operand of arithmetic or a comparison — deadline math on the
        wall clock."""
        operands = []
        if isinstance(node, ast.BinOp):
            if not isinstance(node.op, (ast.Add, ast.Sub)):
                return
            operands = [node.left, node.right]
        elif isinstance(node, ast.Compare):
            operands = [node.left] + list(node.comparators)
        for op in operands:
            if self._is_wall_clock(op):
                self.module.time_findings.append(
                    (node.lineno,
                     self._owner_label()))
                return

    def _is_wall_clock(self, node) -> bool:
        if isinstance(node, ast.Call):
            f = node.func
            return (isinstance(f, ast.Attribute) and f.attr == "time"
                    and isinstance(f.value, ast.Name)
                    and f.value.id == "time")
        if isinstance(node, ast.Name):
            return node.id in getattr(self, "_wall_names", ())
        a = _self_attr(node)
        if a is not None and self.cls is not None:
            return a in getattr(self.cls, "_wall_attrs", ())
        return False

    def _owner_label(self) -> str:
        if self.cls is not None:
            return f"{self.cls.name}.{self.scan.name}"
        return self.scan.name or "<module>"

    # -- W213: unlocked lazy initialization ------------------------------
    def _lazy_init(self, node: ast.If) -> None:
        attr = self._none_test_attr(node.test)
        if attr is None or self.cls is None:
            return
        if self._guarded():
            return                      # checked under a lock: fine
        assigned_plain = False
        locked_assign = False
        locked_recheck = False
        for stmt in node.body:
            if isinstance(stmt, ast.Assign) and any(
                    _self_attr(t) == attr for t in stmt.targets):
                assigned_plain = True
            if isinstance(stmt, (ast.With, ast.AsyncWith)) and any(
                    self._lock_name(i.context_expr) is not None
                    for i in stmt.items):
                for inner in ast.walk(stmt):
                    if isinstance(inner, ast.Assign) and any(
                            _self_attr(t) == attr for t in inner.targets):
                        locked_assign = True
                    if isinstance(inner, ast.If) \
                            and self._none_test_attr(inner.test) == attr:
                        locked_recheck = True
        if assigned_plain or (locked_assign and not locked_recheck):
            self.scan.lazy_inits.append((attr, node.lineno, False))

    @staticmethod
    def _none_test_attr(test) -> Optional[str]:
        """``self.X is None`` / ``not self.X`` -> ``X``."""
        if isinstance(test, ast.Compare) and len(test.ops) == 1 \
                and isinstance(test.ops[0], ast.Is) \
                and isinstance(test.comparators[0], ast.Constant) \
                and test.comparators[0].value is None:
            return _self_attr(test.left)
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            return _self_attr(test.operand)
        return None


# --------------------------------------------------------------- file scan
def _scan_module(path: str, rel: str, tree: ast.Module) -> _ModuleScan:
    module = _ModuleScan(rel)
    for node in tree.body:
        if isinstance(node, ast.Assign):
            names = [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and node.value is not None \
                and isinstance(node.target, ast.Name):
            names = [node.target.id]       # `COUNTS: dict = {}` counts too
        else:
            continue
        if not names:
            continue
        module.module_names.update(names)
        value = node.value
        ctor = _last_name(value) if isinstance(value, ast.Call) else None
        if ctor in LOCK_CTORS:
            module.module_locks.update(names)
        if ctor in THREADSAFE_CTORS:
            module.module_threadsafe.update(names)
        if ctor in MUTABLE_CTORS or isinstance(
                value, (ast.List, ast.ListComp, ast.Dict, ast.DictComp,
                        ast.Set, ast.SetComp)):
            module.module_mutables.update(names)
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            module.classes.append(_scan_class(node, rel, module))
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            _scan_function(node, module)
    return module


def _scan_class(node: ast.ClassDef, rel: str, module: _ModuleScan) \
        -> _ClassScan:
    cls = _ClassScan(node.name, rel, node)
    for base in node.bases:
        if _last_name(base) == "Thread":
            cls.is_thread_subclass = True
            cls.entries.add("run")
            cls.creates_threads = True
    # pass 1: __init__ first so lock/type inference is available to every
    # other method's guard tracking; _wall_attrs is a read-only sweep of
    # the raw class AST, so computing it up front lets _is_wall_clock
    # catch attribute operands in the same pass
    cls._wall_attrs = _wall_clock_attrs(node)
    methods = [m for m in node.body
               if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))]
    for m in sorted(methods, key=lambda m: m.name != "__init__"):
        scan = _MethodScan(m.name)
        cls.methods[m.name] = scan
        sc = _Scanner(cls, scan, module, in_init=(m.name == "__init__"))
        sc._wall_names = _wall_clock_names(m)
        sc._param_types = _param_type_names(m)
        sc.walk(m.body)
    return cls


def _local_bindings(fn, globals_: Set[str]) -> Set[str]:
    """Names ``fn`` (or a nested scope inside it) binds with a plain
    assignment / loop target / with-alias — by Python scoping those are
    LOCAL to their function for its whole body, so a module global of
    the same name is shadowed, not shared.  Collected over the full
    subtree: nested closures share the scanner's walk, and a
    closure-local must not read as module state either."""
    out: Set[str] = set()
    for n in ast.walk(fn):
        targets = []
        if isinstance(n, ast.Assign):
            targets = n.targets
        elif isinstance(n, (ast.AnnAssign, ast.AugAssign, ast.NamedExpr)):
            targets = [n.target]
        elif isinstance(n, (ast.For, ast.AsyncFor)):
            targets = [n.target]
        elif isinstance(n, ast.withitem) and n.optional_vars is not None:
            targets = [n.optional_vars]
        elif isinstance(n, ast.comprehension):
            targets = [n.target]
        elif isinstance(n, ast.arg):
            # parameters (of fn AND nested scopes) bind locally too — a
            # parameter shadowing a module name is never module state
            out.add(n.arg)
        for t in targets:
            _binding_names(t, out)
    return out - globals_


def _binding_names(tgt, out: Set[str]) -> None:
    """Names a target BINDS: a bare NAME (or tuple/starred unpacking of
    them).  A subscript/attribute store mutates the container instead —
    the container name is NOT bound, so it must not read as local."""
    if isinstance(tgt, ast.Name):
        out.add(tgt.id)
    elif isinstance(tgt, (ast.Tuple, ast.List)):
        for el in tgt.elts:
            _binding_names(el, out)
    elif isinstance(tgt, ast.Starred):
        _binding_names(tgt.value, out)


def _scan_function(node, module: _ModuleScan) -> None:
    scan = _MethodScan(node.name)
    module.functions[node.name] = scan
    sc = _Scanner(None, scan, module, in_init=False)
    sc._wall_names = _wall_clock_names(node)
    sc._globals = {name for n in ast.walk(node)
                   if isinstance(n, ast.Global) for name in n.names}
    sc._locals = _local_bindings(node, sc._globals)
    sc.walk(node.body)


def _param_type_names(fn) -> Dict[str, str]:
    """Parameter name -> annotated class name (``b: B`` / ``b: "B"``)."""
    out: Dict[str, str] = {}
    args = list(fn.args.posonlyargs) + list(fn.args.args) \
        + list(fn.args.kwonlyargs)
    for a in args:
        ann = a.annotation
        if isinstance(ann, ast.Name):
            out[a.arg] = ann.id
        elif isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            out[a.arg] = ann.value.split(".")[-1]
    return out


def _wall_clock_names(fn) -> Set[str]:
    """Local names assigned from ``time.time()`` inside ``fn``."""
    out = set()
    for n in ast.walk(fn):
        if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call):
            f = n.value.func
            if isinstance(f, ast.Attribute) and f.attr == "time" \
                    and isinstance(f.value, ast.Name) \
                    and f.value.id == "time":
                out.update(t.id for t in n.targets
                           if isinstance(t, ast.Name))
    return out


def _wall_clock_attrs(cls_node: ast.ClassDef) -> Set[str]:
    """``self.X`` attributes assigned from ``time.time()`` anywhere in
    the class (the ``self.start = time.time()`` ... ``time.time() -
    self.start`` split-across-methods pattern)."""
    out = set()
    for n in ast.walk(cls_node):
        if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call):
            f = n.value.func
            if isinstance(f, ast.Attribute) and f.attr == "time" \
                    and isinstance(f.value, ast.Name) \
                    and f.value.id == "time":
                out.update(a for a in (_self_attr(t) for t in n.targets)
                           if a is not None)
    return out


# ------------------------------------------------------------- diagnostics
def _loc(rel: str, line: int, label: str = "") -> str:
    where = f"{rel}:{line}"
    return f"{where} {label}" if label else where


def _class_findings(cls: _ClassScan) -> List[Diagnostic]:
    out: List[Diagnostic] = []
    reachable = cls.thread_reachable()
    init_only = cls.init_only_methods() | {"__init__"}
    exempt = set(cls.lock_attrs) | {
        a for a, c in cls.init_ctors.items() if c in THREADSAFE_CTORS}

    # attribute access sets
    acc_thread: Set[str] = set()
    acc_main: Set[str] = set()
    guarded_acc: Set[str] = set()
    for name, scan in cls.methods.items():
        attrs = {a for a, _ in scan.reads} | {w.attr for w in scan.writes}
        if name in reachable:
            acc_thread |= attrs
        else:
            acc_main |= attrs
        guarded_acc |= {a for a, g in scan.reads if g}
        guarded_acc |= {w.attr for w in scan.writes if w.guarded}
    shared = (acc_thread & acc_main) - exempt
    lock_hint = next(iter(sorted(cls.lock_attrs)), None)
    hint = (f"guard the access with `with self.{lock_hint}:`"
            if lock_hint else
            "add a threading.Lock (or profiler.locks.InstrumentedLock) "
            "and guard every access")

    for name, scan in cls.methods.items():
        if name in init_only:
            continue
        thread_side = name in reachable
        for w in scan.writes:
            if w.guarded or w.attr in exempt:
                continue
            is_shared = w.attr in shared
            # rule (b): a lock-owning class touching this attribute
            # under a lock elsewhere promised to guard it everywhere
            inconsistent = w.attr in guarded_acc and bool(cls.lock_attrs)
            if not (is_shared or inconsistent):
                continue
            if thread_side:
                side = "a thread-entry path"
            elif reachable:
                side = "the caller side while worker threads run"
            else:
                # rule (b) on a threadless lock owner: the class itself
                # guards this state elsewhere, so callers may share it
                side = ("a path of a lock-owning class that guards this "
                        "state elsewhere")
            if w.rmw:
                out.append(Diagnostic(
                    "DL4J-E202", Severity.ERROR,
                    _loc(cls.path, w.line, f"{cls.name}.{name}"),
                    f"read-modify-write on shared attribute "
                    f"`self.{w.attr}` outside any lock on {side} — a "
                    f"concurrent writer loses one of the updates (the "
                    f"ModelServer._count bug class)", fix_hint=hint))
            else:
                out.append(Diagnostic(
                    "DL4J-E201", Severity.ERROR,
                    _loc(cls.path, w.line, f"{cls.name}.{name}"),
                    f"unguarded mutation of shared attribute "
                    f"`self.{w.attr}` on {side} — other threads can "
                    f"observe (or clobber) intermediate state",
                    fix_hint=hint))

    # W211: Condition.wait outside a predicate loop
    for name, scan in cls.methods.items():
        for attr, line, in_loop in scan.waits:
            if not in_loop:
                out.append(Diagnostic(
                    "DL4J-W211", Severity.WARNING,
                    _loc(cls.path, line, f"{cls.name}.{name}"),
                    f"`self.{attr}.wait()` outside a predicate loop — "
                    "spurious wakeups and stolen notifications make a "
                    "single un-looped wait() return with the condition "
                    "still false",
                    fix_hint="wrap the wait in `while not <predicate>: "
                             "cond.wait(timeout)`"))

    # W212: stored worker threads never joined on any close/drain path
    joined: Set[str] = set()
    for scan in cls.methods.values():
        joined |= scan.joins
    for attr, line in cls.thread_attrs.items():
        if attr not in joined:
            out.append(Diagnostic(
                "DL4J-W212", Severity.WARNING,
                _loc(cls.path, line, cls.name),
                f"worker thread `self.{attr}` is started but never "
                "joined — no close/drain path waits for it, so shutdown "
                "can race its last writes (and leak the thread)",
                fix_hint="join the thread (with a timeout) in close()/"
                         "stop()/drain()"))

    # W213: unlocked lazy initialization
    if cls.creates_threads or cls.lock_attrs:
        for name, scan in cls.methods.items():
            if name in init_only:
                continue
            for attr, line, _ in scan.lazy_inits:
                if attr in exempt:
                    continue
                out.append(Diagnostic(
                    "DL4J-W213", Severity.WARNING,
                    _loc(cls.path, line, f"{cls.name}.{name}"),
                    f"unlocked lazy initialization of `self.{attr}` — "
                    "two threads can both observe None and both "
                    "initialize (double-checked locking needs the check "
                    "under the lock)",
                    fix_hint="take the lock, re-check for None inside "
                             "it, then assign"))
    return out


def _module_findings(mod: _ModuleScan) -> List[Diagnostic]:
    """E201/E202 over module-level functions sharing globals via
    ``threading.Thread(target=fn)`` — the module-scope mirror of
    ``_class_findings``.  Fires only when some MODULE-LEVEL function is
    actually spawned as a thread (a Thread on a local closure or a
    bound method resolves to no module function and contributes
    nothing)."""
    out: List[Diagnostic] = []
    reachable = mod.thread_reachable_functions()
    if not reachable:
        return out
    exempt = mod.module_locks | mod.module_threadsafe
    acc_thread: Set[str] = set()
    acc_main: Set[str] = set()
    for name, scan in mod.functions.items():
        touched = {a for a, _ in scan.reads} | {w.attr for w in scan.writes}
        if name in reachable:
            acc_thread |= touched
        else:
            acc_main |= touched
    # module-level bindings are initialized (and importable) on the main
    # side by construction — the __init__ analog
    shared = (acc_thread & (acc_main | mod.module_names)) - exempt
    lock_hint = next(iter(sorted(mod.module_locks)), None)
    hint = (f"guard the access with `with {lock_hint}:`" if lock_hint
            else "add a module-level threading.Lock (or "
                 "profiler.locks.InstrumentedLock) and guard every access")
    for name, scan in mod.functions.items():
        side = ("a thread-entry path" if name in reachable
                else "the caller side while worker threads run")
        for w in scan.writes:
            if w.guarded or w.attr not in shared:
                continue
            if w.rmw:
                out.append(Diagnostic(
                    "DL4J-E202", Severity.ERROR,
                    _loc(mod.path, w.line, name),
                    f"read-modify-write on module global `{w.attr}` "
                    f"outside any lock on {side} — "
                    f"`threading.Thread(target={sorted(reachable)[0]})` "
                    f"makes this module state cross-thread, and a "
                    f"concurrent writer loses one of the updates",
                    fix_hint=hint))
            else:
                out.append(Diagnostic(
                    "DL4J-E201", Severity.ERROR,
                    _loc(mod.path, w.line, name),
                    f"unguarded mutation of module global `{w.attr}` on "
                    f"{side} — shared with the "
                    f"Thread(target=...) entry function(s) "
                    f"{sorted(reachable & mod.fn_entries)}, so other "
                    f"threads can observe (or clobber) intermediate "
                    f"state",
                    fix_hint=hint))
    return out


def _lock_graph(modules: List[_ModuleScan]) -> List[Diagnostic]:
    """E203: cycles in the static lock-acquisition graph."""
    classes = [cls for mod in modules for cls in mod.classes]
    # typed-attribute calls resolve by bare class name; same-named
    # classes in different modules all contribute (a conservative union
    # — keying a dict on the bare name used to let the FIRST such class
    # shadow the rest and silently drop their edges)
    by_name: Dict[str, List[_ClassScan]] = {}
    for cls in classes:
        by_name.setdefault(cls.name, []).append(cls)

    # per-method transitively-acquired lock sets (fixpoint over self and
    # typed-attribute calls); keyed by class identity, not name
    acquired: Dict[Tuple[int, str], Set[str]] = {}
    for cls in classes:
        for m, scan in cls.methods.items():
            acquired[(id(cls), m)] = {lock for lock, _, _
                                      in scan.acquisitions}

    def typed_acquired(cls: _ClassScan, attr: str, meth: str) -> Set[str]:
        out: Set[str] = set()
        for tcls in by_name.get(cls.attr_types.get(attr), ()):
            out |= acquired.get((id(tcls), meth), set())
        return out

    changed = True
    while changed:
        changed = False
        for cls in classes:
            for m, scan in cls.methods.items():
                cur = acquired[(id(cls), m)]
                for callee, _, _ in scan.self_calls:
                    extra = acquired.get((id(cls), callee), set())
                    if not extra <= cur:
                        cur |= extra
                        changed = True
                for attr, meth, _, _ in scan.typed_calls:
                    extra = typed_acquired(cls, attr, meth)
                    if not extra <= cur:
                        cur |= extra
                        changed = True

    edges: Dict[str, Set[str]] = {}
    sites: Dict[Tuple[str, str], Tuple[str, int]] = {}

    def add_edge(a: str, b: str, path: str, line: int):
        if a == b:
            return          # re-entrant RLock/Condition, not an ordering
        edges.setdefault(a, set()).add(b)
        sites.setdefault((a, b), (path, line))

    for mod in modules:
        for cls in mod.classes:
            for m, scan in cls.methods.items():
                for lock, held, line in scan.acquisitions:
                    for h in held:
                        add_edge(h, lock, cls.path, line)
                for callee, held, line in scan.self_calls:
                    if not held:
                        continue
                    for lock in acquired.get((id(cls), callee), ()):
                        for h in held:
                            add_edge(h, lock, cls.path, line)
                for attr, meth, held, line in scan.typed_calls:
                    if not held:
                        continue
                    for lock in typed_acquired(cls, attr, meth):
                        for h in held:
                            add_edge(h, lock, cls.path, line)
        for lock, held, line in mod.acquisitions:
            for h in held:
                add_edge(h, lock, mod.path, line)

    # cycle detection: DFS with colors; report each cycle once
    out: List[Diagnostic] = []
    seen_cycles: Set[Tuple[str, ...]] = set()
    WHITE, GRAY, BLACK = 0, 1, 2
    color = {n: WHITE for n in
             set(edges) | {b for bs in edges.values() for b in bs}}

    def dfs(n: str, stack: List[str]):
        color[n] = GRAY
        stack.append(n)
        for b in sorted(edges.get(n, ())):
            if color[b] == GRAY:
                cyc = tuple(stack[stack.index(b):]) + (b,)
                key = tuple(sorted(set(cyc)))
                if key not in seen_cycles:
                    seen_cycles.add(key)
                    path, line = sites.get((n, b), ("", 0))
                    out.append(Diagnostic(
                        "DL4J-E203", Severity.ERROR,
                        _loc(path, line, " -> ".join(cyc)),
                        f"lock-order cycle: {' -> '.join(cyc)} — two "
                        "threads taking these locks in opposite orders "
                        "deadlock",
                        fix_hint="impose one global acquisition order "
                                 "(or release the outer lock before "
                                 "taking the inner one)"))
            elif color[b] == WHITE:
                dfs(b, stack)
        stack.pop()
        color[n] = BLACK

    for n in sorted(color):
        if color[n] == WHITE:
            dfs(n, [])
    return out


# ----------------------------------------------------------------- driver
def _resolve_target(target: str) -> List[Tuple[str, str]]:
    """-> [(abs_path, display_path)] of .py files to lint. ``target`` is
    a file, a directory, or an importable module/package NAME (resolved
    without importing it)."""
    if os.path.isfile(target):
        return [(os.path.abspath(target), target)]
    if os.path.isdir(target):
        root = os.path.abspath(target)
        out = []
        for dirpath, _, names in sorted(os.walk(root)):
            for n in sorted(names):
                if n.endswith(".py"):
                    p = os.path.join(dirpath, n)
                    out.append((p, os.path.relpath(p, os.path.dirname(root))))
        return out
    import importlib.util
    try:
        spec = importlib.util.find_spec(target)
    except (ImportError, ValueError) as e:
        raise FileNotFoundError(
            f"concurrency target {target!r} could not be resolved: {e}")
    if spec is None:
        raise FileNotFoundError(
            f"concurrency target {target!r} is neither a path nor an "
            "importable module")
    if spec.submodule_search_locations:
        return _resolve_target(list(spec.submodule_search_locations)[0])
    if not spec.origin or not os.path.isfile(spec.origin):
        raise FileNotFoundError(
            f"concurrency target {target!r} has no lintable source "
            f"(origin: {spec.origin!r}) — built-in and extension modules "
            "cannot be AST-linted")
    return [(spec.origin, os.path.basename(spec.origin))]


def _noqa_codes(source: str) -> Dict[int, Set[str]]:
    out: Dict[int, Set[str]] = {}
    for i, line in enumerate(source.splitlines(), 1):
        m = _NOQA_RE.search(line)
        if not m:
            continue
        if m.group("eq"):
            codes = m.group("codes")
            if not codes:
                # 'noqa=<not-a-code>': suppressing NOTHING beats silently
                # suppressing everything
                continue
            out[i] = {c.strip().upper().replace("DL4J-", "")
                      for c in codes.split(",") if c.strip()}
        else:
            out[i] = set()      # bare noqa: suppress every code on the line
    return out


_LINE_RE = re.compile(r":(\d+)(?:\s|$)")


def analyze_concurrency(target: str, suppress: Iterable[str] = (),
                        severity_overrides=None) -> ValidationReport:
    """Run every concurrency lint over ``target`` (path or module name);
    returns a :class:`ValidationReport` whose diagnostics carry
    ``file:line Class.method`` locations. ``# dl4j: noqa=E201`` (or a
    bare ``# dl4j: noqa``) on the flagged source line suppresses it;
    ``suppress``/``severity_overrides`` shape the report like every
    other analysis entry point."""
    files = _resolve_target(target)
    modules: List[_ModuleScan] = []
    noqa: Dict[str, Dict[int, Set[str]]] = {}
    diags: List[Diagnostic] = []
    for abspath, rel in files:
        with open(abspath, encoding="utf-8") as f:
            source = f.read()
        try:
            tree = ast.parse(source, filename=abspath)
        except SyntaxError as e:
            diags.append(Diagnostic(
                "DL4J-E299", Severity.ERROR, _loc(rel, e.lineno or 0),
                f"could not parse: {e.msg}"))
            continue
        noqa[rel] = _noqa_codes(source)
        modules.append(_scan_module(abspath, rel, tree))

    for mod in modules:
        for cls in mod.classes:
            diags.extend(_class_findings(cls))
        diags.extend(_module_findings(mod))
        seen_lines: Set[Tuple[str, int]] = set()
        for line, label in mod.time_findings:
            if (mod.path, line) in seen_lines:
                continue
            seen_lines.add((mod.path, line))
            diags.append(Diagnostic(
                "DL4J-W210", Severity.WARNING, _loc(mod.path, line, label),
                "wall-clock time.time() used in deadline/timeout "
                "arithmetic — an NTP step moves the wall clock and "
                "spuriously expires (or never expires) the deadline",
                fix_hint="use time.monotonic() (or time.perf_counter()) "
                         "for durations and deadlines; keep time.time() "
                         "only for timestamps"))
    diags.extend(_lock_graph(modules))

    def kept(d: Diagnostic) -> bool:
        rel = d.location.split(":", 1)[0]
        m = _LINE_RE.search(d.location)
        if rel in noqa and m:
            line = int(m.group(1))
            codes = noqa[rel].get(line)
            if codes is not None:
                short = d.code.replace("DL4J-", "")
                return bool(codes) and short not in codes \
                    and d.code not in codes
        return True

    report = ValidationReport([d for d in diags if kept(d)],
                              subject=f"concurrency:{target}")
    report.diagnostics.sort(key=lambda d: (d.location, d.code))
    return report.apply_config(suppress=list(suppress) or None,
                               severity_overrides=severity_overrides)
