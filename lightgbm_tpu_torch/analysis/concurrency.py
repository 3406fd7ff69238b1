"""Concurrency lint ("conlint", rules CL001-CL005) over the port's
threaded modules.

The port's copy of ``lightgbm_tpu/analysis/concurrency.py``: an AST pass
over the port's lock-bearing modules (serving, service, the heartbeat,
the gang supervisor, fault injection and the native build lock) that
builds a per-module lock-acquisition graph and flags these defect
classes:

CL001  lock-order inversion: the module's acquisition graph (lock B
       taken while lock A is held => edge A->B, including one level of
       same-module call expansion) contains a cycle — two threads
       entering the cycle from different ends deadlock.
CL002  blocking call while holding a lock: ``queue.put/get``,
       socket/HTTP I/O, ``subprocess`` spawn/wait, ``time.sleep``,
       thread ``join`` / event ``wait``, file I/O, and a device sync
       (``torch.cuda.synchronize``, ``.synchronize()`` on a stream or an
       event, ``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()``,
       ``.to("cpu")`` / ``.to(device=...)``, ``np.asarray`` of a device
       value) — each one stretches the critical section by an unbounded
       external latency and starves every waiter.
CL003  shared-state escape: a ``self.attr`` written OUTSIDE any lock in
       a method reachable from one thread entry point while another
       entry point reads it — the classic unsynchronized publish.
       (GIL-atomic single-reference swaps are a deliberate idiom here;
       they get a suppression with a reason, which is the audit.)
CL004  ``Condition.wait`` outside a ``while`` predicate loop — wakeups
       are spurious and stealable; an ``if`` check sleeps forever or
       proceeds on a consumed predicate.
CL005  ``threading.Thread`` without daemon/join discipline: a
       non-daemon thread that nobody joins outlives shutdown and hangs
       interpreter exit (or leaks into the next test).

The JAX package's device-sync vocabulary (``block_until_ready``,
``jax.device_get`` / ``device_put``, ``jnp.asarray``) is replaced by
torch's; everything else is the JAX package's rule for rule.

Stands on :mod:`.astcore` (``FileContext``: suppression comments and
finding fingerprints; the baseline helpers). Suppress in source with
``# conlint: disable=CL00x`` (the ``jaxlint:`` tag works too) plus a
reason; accepted findings live in this directory's
``concurrency_baseline.json``, where EVERY entry must carry a one-line
``reason``: the baseline is the triage record, and a reasonless entry
fails the gate.

The runtime half (lock-order tracking under ``LGBM_TPU_GUARDS=
lockorder``) lives in :mod:`.lockorder` and shares :class:`LockGraph`.

CLI: ``python -m lightgbm_tpu_torch.analysis``. Pure stdlib.
"""
from __future__ import annotations

import ast
import json
import os
import re
from typing import Dict, List, Optional, Set, Tuple

from .astcore import (FileContext, Finding, FuncInfo, callee_chain,
                      diff_against_baseline, iter_py_files,
                      load_baseline_records)

BASELINE_NAME = "concurrency_baseline.json"

# the lock-bearing modules this pass instruments (repo-relative); the
# runtime tracker (lockorder.py) wraps lock creation in the same set
TARGET_MODULES = (
    "lightgbm_tpu_torch/serving/server.py",
    "lightgbm_tpu_torch/serving/batcher.py",
    "lightgbm_tpu_torch/serving/fleet.py",
    "lightgbm_tpu_torch/serving/metrics.py",
    "lightgbm_tpu_torch/serving/mesh.py",
    "lightgbm_tpu_torch/service/__init__.py",
    "lightgbm_tpu_torch/service/trainer.py",
    "lightgbm_tpu_torch/service/frontdoor.py",
    "lightgbm_tpu_torch/robustness/heartbeat.py",
    "lightgbm_tpu_torch/robustness/gang.py",
    "lightgbm_tpu_torch/robustness/faults.py",
    "lightgbm_tpu_torch/native/__init__.py",
)

LOCK_CTORS = {"Lock", "RLock", "Condition"}
# with-target names that count as locks even without a visible ctor
# (cross-file attributes, fixtures)
_LOCKISH_RE = re.compile(r"(^|_)(lock|lk|mutex|cv|cond)s?$", re.I)

_NUMPY_ALIASES = {"np", "numpy", "onp", "_np"}
_QUEUEISH_RE = re.compile(r"(^|_)(q|queue|inbox|outbox)s?$", re.I)
_SOCKET_ATTRS = {"recv", "recvfrom", "recv_into", "accept", "connect",
                 "sendall", "makefile", "urlopen", "getresponse"}
# `.join` / `.wait` receivers that look like threads/processes — a bare
# attr match would flag every `", ".join(...)` string join
_THREADISH_RE = re.compile(
    r"(thread|proc|work|child|pump|loop|supervis|keepaliv|dispatch|"
    r"writer|server|gang|rank|watch)|(^|\.)_?t\d*$", re.I)
_FILE_CALLS = {"open", "os.replace", "os.rename", "os.fsync"}
# tensor methods that wait for the device and copy to the host
_TORCH_READS = {"item", "cpu", "tolist", "numpy"}


def _to_host_or_device(node: ast.Call) -> bool:
    """``x.to("cpu")``, ``x.to(torch.device("cpu"))`` or
    ``x.to(device=...)``: a tensor copied across devices (a dtype cast,
    ``x.to(torch.float32)``, is not)."""
    if any(kw.arg == "device" for kw in node.keywords):
        return True
    if not node.args:
        return False
    a = node.args[0]
    if isinstance(a, ast.Call) and \
            callee_chain(a.func).rpartition(".")[2] == "device" and a.args:
        a = a.args[0]
    return isinstance(a, ast.Constant) and isinstance(a.value, str) and \
        a.value.split(":")[0] == "cpu"


def _iter_own_exprs(node: ast.AST):
    """Yield the expression nodes belonging to ``node`` itself, without
    descending into nested statements or nested function bodies — so a
    lock-scope walker can attribute each access to the held-lock context
    it actually executes under."""
    stack = [node]
    while stack:
        n = stack.pop()
        yield n
        for c in ast.iter_child_nodes(n):
            if isinstance(c, (ast.stmt, ast.excepthandler,
                              ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                continue
            stack.append(c)


def _name_of(expr: ast.AST) -> str:
    """Dotted name of a plain Name/Attribute chain ('' otherwise)."""
    return callee_chain(expr)


class ModuleLocks:
    """Lock inventory + per-function lock behavior for one module."""

    def __init__(self, ctx: FileContext):
        self.ctx = ctx
        # dotted target name -> ctor kind ("Lock"/"RLock"/"Condition")
        self.declared: Dict[str, str] = {}
        self.condition_names: Set[str] = set()
        self._collect_declared()
        # function-id -> summary dicts, filled lazily
        self._acq_memo: Dict[int, Set[str]] = {}
        self._blk_memo: Dict[int, List[Tuple[str, ast.AST]]] = {}

    # -- inventory ------------------------------------------------------
    def _collect_declared(self) -> None:
        for node in ast.walk(self.ctx.tree):
            if not (isinstance(node, ast.Assign) and
                    isinstance(node.value, ast.Call)):
                continue
            chain = callee_chain(node.value.func)
            base, _, tail = chain.rpartition(".")
            if tail not in LOCK_CTORS or base not in ("", "threading"):
                continue
            for tgt in node.targets:
                name = _name_of(tgt)
                if not name:
                    continue
                self.declared[name] = tail
                if tail == "Condition":
                    self.condition_names.add(name)

    def is_lock_expr(self, expr: ast.AST) -> Optional[str]:
        """Dotted name when ``expr`` denotes a lock (declared in this
        module, or lock-ish by name); None otherwise."""
        name = _name_of(expr)
        if not name:
            return None
        if name in self.declared:
            return name
        if _LOCKISH_RE.search(name.rpartition(".")[2]):
            return name
        return None

    def qualify(self, name: str, fi: Optional[FuncInfo]) -> str:
        """Stable per-module lock identity: self attrs are scoped to the
        enclosing class, locals to the enclosing function."""
        if fi is None:
            return name
        if name.startswith("self."):
            cls = fi.qualname.rpartition(".")[0]
            return f"{cls}.{name}" if cls else name
        if name in self.declared:        # module-level lock
            return name
        return f"{fi.qualname}.{name}"

    # -- per-function summaries (transitive through same-module calls) --
    def _resolve_call(self, call: ast.Call,
                      fi: Optional[FuncInfo]) -> List[FuncInfo]:
        """Same-module callees of ``f(...)`` / ``self.m(...)``."""
        func = call.func
        name = None
        if isinstance(func, ast.Name):
            name = func.id
        elif (isinstance(func, ast.Attribute) and
                isinstance(func.value, ast.Name) and
                func.value.id == "self"):
            name = func.attr
        if name is None:
            return []
        cands = self.ctx._by_name.get(name, [])
        if (fi is not None and isinstance(func, ast.Attribute) and
                len(cands) > 1):
            # prefer the method of the SAME class
            cls = fi.qualname.rpartition(".")[0]
            same = [c for c in cands
                    if c.qualname.rpartition(".")[0] == cls]
            if same:
                return same
        return list(cands)

    def acquired_anywhere(self, fi: FuncInfo,
                          _stack: Optional[Set[int]] = None) -> Set[str]:
        """Qualified lock names acquired anywhere inside ``fi``,
        transitively through same-module simple calls."""
        nid = id(fi.node)
        if nid in self._acq_memo:
            return self._acq_memo[nid]
        stack = _stack if _stack is not None else set()
        if nid in stack:
            return set()
        stack.add(nid)
        out: Set[str] = set()
        for node in ast.walk(fi.node):
            if isinstance(node, ast.With):
                for item in node.items:
                    name = self.is_lock_expr(item.context_expr)
                    if name:
                        out.add(self.qualify(name, fi))
            elif isinstance(node, ast.Call):
                chain = callee_chain(node.func)
                base, _, tail = chain.rpartition(".")
                if tail == "acquire" and self.is_lock_expr(node.func.value):
                    out.add(self.qualify(base, fi))
                for cal in self._resolve_call(node, fi):
                    out |= self.acquired_anywhere(cal, stack)
        stack.discard(nid)
        self._acq_memo[nid] = out
        return out

    def blocking_anywhere(self, fi: FuncInfo,
                          _stack: Optional[Set[int]] = None
                          ) -> List[Tuple[str, ast.AST]]:
        """(label, node) blocking operations inside ``fi``, transitively
        through same-module calls (label prefixed with the callee path)."""
        nid = id(fi.node)
        if nid in self._blk_memo:
            return self._blk_memo[nid]
        stack = _stack if _stack is not None else set()
        if nid in stack:
            return []
        stack.add(nid)
        out: List[Tuple[str, ast.AST]] = []
        for node in ast.walk(fi.node):
            if not isinstance(node, ast.Call):
                continue
            label = blocking_label(node)
            if label:
                out.append((label, node))
            for cal in self._resolve_call(node, fi):
                for lab, _n in self.blocking_anywhere(cal, stack):
                    out.append((f"{cal.qualname}: {lab}", node))
        stack.discard(nid)
        self._blk_memo[nid] = out
        return out


def blocking_label(node: ast.Call) -> Optional[str]:
    """Category label when ``node`` is a blocking call (CL002), else
    None. Curated for this codebase's I/O surface."""
    chain = callee_chain(node.func)
    base, _, tail = chain.rpartition(".")
    recv_tail = base.rpartition(".")[2]
    if tail in ("put", "get") and _QUEUEISH_RE.search(recv_tail):
        return f"queue {tail} (`{chain}`)"
    if chain == "time.sleep":
        return "time.sleep"
    if tail == "join" and isinstance(node.func, ast.Attribute) and \
            _THREADISH_RE.search(base):
        return f"thread/process join (`{chain}`)"
    if tail == "wait" and isinstance(node.func, ast.Attribute):
        return f"wait (`{chain}`)"
    if chain.startswith("subprocess.") and tail in (
            "run", "Popen", "call", "check_call", "check_output"):
        return f"subprocess spawn/wait (`{chain}`)"
    if tail == "communicate":
        return f"subprocess communicate (`{chain}`)"
    if chain.split(".", 1)[0] == "socket" or tail in _SOCKET_ATTRS:
        return f"socket/HTTP I/O (`{chain}`)"
    if tail == "synchronize":
        return f"device sync (`{chain}`)"
    if isinstance(node.func, ast.Attribute) and not node.args and \
            not node.keywords and tail in _TORCH_READS:
        return f"device sync / host copy (`.{tail}()`)"
    if tail == "to" and isinstance(node.func, ast.Attribute) and \
            _to_host_or_device(node):
        return f"device sync / cross-device copy (`{chain}`)"
    if base in _NUMPY_ALIASES and tail in ("asarray", "array"):
        return f"possible device sync / host copy (`{chain}`)"
    if chain in _FILE_CALLS:
        return f"file I/O (`{chain}`)"
    return None


class LockGraph:
    """Directed lock-acquisition-order graph with cycle detection.

    Shared by the CL001 static rule and the runtime tracker
    (:mod:`.lockorder`): nodes are lock identities, an edge A->B means
    "B was acquired while A was held", and a cycle is a lock-order
    inversion (two threads entering from different ends deadlock).
    """

    def __init__(self):
        self.edges: Dict[str, Dict[str, object]] = {}

    def add_edge(self, a: str, b: str,
                 site: object = None) -> Optional[List[str]]:
        """Record A->B; returns the cycle path ``[b, ..., a, b]`` when
        this edge closes one (the edge stays recorded), else None."""
        if a == b:          # reentrant acquisition is not an inversion
            return None
        fresh = b not in self.edges.get(a, ())
        self.edges.setdefault(a, {}).setdefault(b, site)
        if not fresh:
            return None
        path = self.find_path(b, a)
        if path is not None:
            return path + [b]
        return None

    def find_path(self, src: str, dst: str) -> Optional[List[str]]:
        """DFS path src->dst along recorded edges, or None."""
        seen: Set[str] = set()
        stack: List[Tuple[str, List[str]]] = [(src, [src])]
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            if node in seen:
                continue
            seen.add(node)
            for nxt in self.edges.get(node, ()):
                if nxt not in seen:
                    stack.append((nxt, path + [nxt]))
        return None

    def site(self, a: str, b: str) -> object:
        return self.edges.get(a, {}).get(b)


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------

class LockOrderRule:
    """CL001: cycle in the module's lock-acquisition graph."""

    rule = "CL001"

    def visit(self, ctx: FileContext, locks: ModuleLocks) -> List:
        graph = LockGraph()
        edge_sites: Dict[Tuple[str, str], Tuple[ast.AST, FuncInfo]] = {}

        def scan(body, held: Tuple[str, ...], fi: FuncInfo) -> None:
            for node in body:
                self._scan_node(node, held, fi, graph, edge_sites, locks)

        for fi in ctx.all_funcs:
            if fi.is_lambda:
                continue
            scan(fi.node.body, (), fi)

        out = []
        for (a, b), (node, fi) in sorted(
                edge_sites.items(),
                key=lambda kv: getattr(kv[1][0], "lineno", 0)):
            cyc = graph.find_path(b, a)
            if cyc is None:
                continue
            path = " -> ".join([a] + cyc)
            f = ctx.finding(
                self.rule, node, fi,
                f"lock-order inversion: `{b}` acquired while `{a}` held "
                f"closes the cycle [{path}] — another thread entering "
                "the cycle elsewhere deadlocks")
            if f:
                out.append(f)
        return out

    def _scan_node(self, node, held, fi, graph, edge_sites, locks) -> None:
        """Walk one statement, tracking held locks through nested withs
        and expanding same-module calls one transitive level."""
        if isinstance(node, ast.With):
            new_held = held
            for item in node.items:
                name = locks.is_lock_expr(item.context_expr)
                if name:
                    q = locks.qualify(name, fi)
                    for h in new_held:
                        graph.add_edge(h, q)
                        edge_sites.setdefault((h, q), (node, fi))
                    new_held = new_held + (q,)
            for sub in node.body:
                self._scan_node(sub, new_held, fi, graph, edge_sites,
                                locks)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return          # nested defs scanned from their own FuncInfo
        # calls made while holding: pull in the callee's acquisitions
        if held:
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call):
                    for cal in locks._resolve_call(sub, fi):
                        for q in locks.acquired_anywhere(cal):
                            for h in held:
                                graph.add_edge(h, q)
                                edge_sites.setdefault((h, q), (sub, fi))
        for sub in ast.iter_child_nodes(node):
            if isinstance(sub, (ast.stmt, ast.excepthandler)):
                self._scan_node(sub, held, fi, graph, edge_sites, locks)
            elif hasattr(sub, "body") and isinstance(
                    getattr(sub, "body", None), list):
                for s in sub.body:
                    if isinstance(s, ast.stmt):
                        self._scan_node(s, held, fi, graph, edge_sites,
                                        locks)


class BlockingUnderLockRule:
    """CL002: blocking call while >=1 lock is held."""

    rule = "CL002"

    def visit(self, ctx: FileContext, locks: ModuleLocks) -> List:
        out: List = []
        seen: Set[int] = set()

        for fi in ctx.all_funcs:
            if fi.is_lambda:
                continue
            for node in fi.node.body:
                self._scan_node(node, (), fi, out, ctx, locks, seen)
        return out

    def _scan_node(self, node, held, fi, out, ctx, locks, seen) -> None:
        if isinstance(node, ast.With):
            new_held = held
            for item in node.items:
                name = locks.is_lock_expr(item.context_expr)
                if name:
                    new_held = new_held + (locks.qualify(name, fi),)
            for sub in node.body:
                self._scan_node(sub, new_held, fi, out, ctx, locks, seen)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return
        if held:
            for sub in ast.walk(node):
                if not isinstance(sub, ast.Call) or id(sub) in seen:
                    continue
                seen.add(id(sub))
                label = blocking_label(sub)
                if label:
                    # Condition.wait on the innermost held lock RELEASES
                    # it while sleeping — that's CL004's domain, not a
                    # blocking-while-holding hazard unless outer locks
                    # stay pinned
                    recv = _name_of(sub.func)[:-5] \
                        if _name_of(sub.func).endswith(".wait") else None
                    if recv is not None:
                        rq = locks.qualify(recv, fi)
                        if rq == held[-1] and len(held) == 1:
                            continue
                    f = ctx.finding(
                        self.rule, sub, fi,
                        f"blocking {label} while holding "
                        f"{list(held)} — the critical section now waits "
                        "on external latency and starves every waiter")
                    if f:
                        out.append(f)
                    continue
                # one transitive level: callee that blocks
                for cal in locks._resolve_call(sub, fi):
                    blk = locks.blocking_anywhere(cal)
                    if blk:
                        lab = blk[0][0]
                        f = ctx.finding(
                            self.rule, sub, fi,
                            f"call to `{cal.qualname}` performs blocking "
                            f"{lab} while holding {list(held)}")
                        if f:
                            out.append(f)
                        break
        for sub in ast.iter_child_nodes(node):
            if isinstance(sub, (ast.stmt, ast.excepthandler)):
                self._scan_node(sub, held, fi, out, ctx, locks, seen)


class SharedStateEscapeRule:
    """CL003: unlocked ``self.attr`` write visible to another thread
    entry point. Only classes that actually spawn threads are audited;
    ``__init__`` writes (pre-thread) and threading/queue primitive
    attributes (internally synchronized) are exempt."""

    rule = "CL003"
    _SYNC_CTORS = {"Lock", "RLock", "Condition", "Event", "Semaphore",
                   "BoundedSemaphore", "Barrier", "Queue", "SimpleQueue",
                   "LifoQueue", "PriorityQueue", "local", "Thread",
                   "Timer"}

    def visit(self, ctx: FileContext, locks: ModuleLocks) -> List:
        out: List = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef):
                out.extend(self._visit_class(node, ctx, locks))
        return out

    def _visit_class(self, cls: ast.ClassDef, ctx: FileContext,
                     locks: ModuleLocks) -> List:
        methods = {n.name: n for n in cls.body
                   if isinstance(n, (ast.FunctionDef,
                                     ast.AsyncFunctionDef))}
        thread_roots = self._thread_targets(cls) & set(methods)
        if not thread_roots:
            return []
        public_roots = {m for m in methods
                        if not m.startswith("_") or
                        m in ("__call__", "__enter__", "__exit__")}
        roots = thread_roots | public_roots

        # call graph over self.m() calls
        calls: Dict[str, Set[str]] = {m: set() for m in methods}
        for m, node in methods.items():
            for sub in ast.walk(node):
                if (isinstance(sub, ast.Call) and
                        isinstance(sub.func, ast.Attribute) and
                        isinstance(sub.func.value, ast.Name) and
                        sub.func.value.id == "self" and
                        sub.func.attr in methods):
                    calls[m].add(sub.func.attr)
        reach: Dict[str, Set[str]] = {}
        for r in roots:
            seen: Set[str] = set()
            stack = [r]
            while stack:
                m = stack.pop()
                if m in seen:
                    continue
                seen.add(m)
                stack.extend(calls.get(m, ()))
            reach[r] = seen
        root_sets: Dict[str, Set[str]] = {
            m: {r for r in roots if m in reach[r]} for m in methods}

        sync_attrs = self._sync_attrs(cls)
        # accesses: attr -> list of (method, kind, locked, node)
        accesses: Dict[str, List[Tuple[str, str, bool, ast.AST]]] = {}
        for m, node in methods.items():
            if m == "__init__":
                continue
            self._collect(node.body, m, (), accesses, locks, ctx)

        out: List = []
        for attr, accs in sorted(accesses.items()):
            if attr in sync_attrs or _LOCKISH_RE.search(attr):
                continue
            acc_roots: Set[str] = set()
            for meth, _k, _l, _n in accs:
                acc_roots |= root_sets.get(meth, set())
            if len(acc_roots) < 2 or not (acc_roots & thread_roots):
                continue
            has_read = any(k == "read" for _m, k, _l, _n in accs)
            for meth, kind, locked, node in accs:
                if kind != "write" or locked or not root_sets.get(meth):
                    continue
                if not has_read:
                    break
                readers = sorted({m2 for m2, k2, _l2, _n2 in accs
                                  if k2 == "read" and m2 != meth})
                f = ctx.finding(
                    self.rule, node, ctx.enclosing(node),
                    f"`self.{attr}` written without a lock in "
                    f"`{meth}` (reached from {sorted(root_sets[meth])}) "
                    f"but read from other thread entry points "
                    f"(via {readers[:3]}) — unsynchronized shared state")
                if f:
                    out.append(f)
                break       # one finding per (class, attr)
        return out

    def _collect(self, body, meth, held, accesses, locks, ctx) -> None:
        for node in body:
            if isinstance(node, ast.With):
                new_held = held
                for item in node.items:
                    if locks.is_lock_expr(item.context_expr):
                        new_held = new_held + (1,)
                self._collect(node.body, meth, new_held, accesses,
                              locks, ctx)
                continue
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for sub in _iter_own_exprs(node):
                if not (isinstance(sub, ast.Attribute) and
                        isinstance(sub.value, ast.Name) and
                        sub.value.id == "self"):
                    continue
                kind = ("write" if isinstance(sub.ctx,
                                              (ast.Store, ast.Del))
                        else "read")
                accesses.setdefault(sub.attr, []).append(
                    (meth, kind, bool(held), sub))
            for sub in ast.iter_child_nodes(node):
                if isinstance(sub, ast.excepthandler):
                    self._collect(sub.body, meth, held, accesses,
                                  locks, ctx)
                elif isinstance(sub, ast.stmt):
                    self._collect([sub], meth, held, accesses, locks,
                                  ctx)

    @staticmethod
    def _thread_targets(cls: ast.ClassDef) -> Set[str]:
        """Method names handed to ``threading.Thread(target=self.m)``
        within this class (plus the conventional ``run``)."""
        out: Set[str] = set()
        for node in ast.walk(cls):
            if not (isinstance(node, ast.Call) and
                    callee_chain(node.func).rpartition(".")[2] ==
                    "Thread"):
                continue
            for kw in node.keywords:
                if kw.arg == "target" and \
                        isinstance(kw.value, ast.Attribute) and \
                        isinstance(kw.value.value, ast.Name) and \
                        kw.value.value.id == "self":
                    out.add(kw.value.attr)
        if "run" in {n.name for n in cls.body
                     if isinstance(n, ast.FunctionDef)}:
            out.add("run")
        return out

    def _sync_attrs(self, cls: ast.ClassDef) -> Set[str]:
        """self attrs assigned from threading/queue primitives — they
        synchronize internally and are exempt from CL003."""
        out: Set[str] = set()
        for node in ast.walk(cls):
            if not (isinstance(node, ast.Assign) and
                    isinstance(node.value, ast.Call)):
                continue
            tail = callee_chain(node.value.func).rpartition(".")[2]
            if tail not in self._SYNC_CTORS:
                continue
            for tgt in node.targets:
                if isinstance(tgt, ast.Attribute) and \
                        isinstance(tgt.value, ast.Name) and \
                        tgt.value.id == "self":
                    out.add(tgt.attr)
        return out


class ConditionWaitRule:
    """CL004: ``Condition.wait`` outside a predicate ``while`` loop."""

    rule = "CL004"

    def visit(self, ctx: FileContext, locks: ModuleLocks) -> List:
        out: List = []
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call) and
                    isinstance(node.func, ast.Attribute) and
                    node.func.attr == "wait"):
                continue
            recv = _name_of(node.func.value)
            if recv not in locks.condition_names and not \
                    re.search(r"(^|_)(cv|cond)(ition)?s?$",
                              recv.rpartition(".")[2], re.I):
                continue
            cur = node
            in_while = False
            while cur is not None:
                cur = ctx._parents.get(id(cur))
                if isinstance(cur, ast.While):
                    in_while = True
                    break
                if isinstance(cur, (ast.FunctionDef,
                                    ast.AsyncFunctionDef, ast.Lambda)):
                    break
            if in_while:
                continue
            f = ctx.finding(
                self.rule, node, ctx.enclosing(node),
                f"`{recv}.wait()` outside a `while` predicate loop — "
                "wakeups are spurious and stealable; re-check the "
                "predicate in a while loop (or use wait_for)")
            if f:
                out.append(f)
        return out


class ThreadDisciplineRule:
    """CL005: ``threading.Thread`` without daemon/join discipline."""

    rule = "CL005"

    def visit(self, ctx: FileContext, locks: ModuleLocks) -> List:
        out: List = []
        joined, daemonized = self._module_discipline(ctx.tree)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            chain = callee_chain(node.func)
            base, _, tail = chain.rpartition(".")
            if tail != "Thread" or base not in ("", "threading"):
                continue
            if any(kw.arg == "daemon" and
                   isinstance(kw.value, ast.Constant) and
                   kw.value.value is True for kw in node.keywords):
                continue
            # find the handle the Thread is bound to
            parent = ctx._parents.get(id(node))
            handle = None
            if isinstance(parent, ast.Assign):
                for tgt in parent.targets:
                    handle = _name_of(tgt) or handle
            if handle and (handle in joined or handle in daemonized):
                continue
            what = (f"`{handle}`" if handle
                    else "an unbound threading.Thread")
            f = ctx.finding(
                self.rule, node, ctx.enclosing(node),
                f"{what} created without daemon=True and never joined "
                "or daemonized — a non-daemon thread that nobody joins "
                "outlives shutdown and wedges interpreter exit")
            if f:
                out.append(f)
        return out

    @staticmethod
    def _module_discipline(tree: ast.Module
                           ) -> Tuple[Set[str], Set[str]]:
        """Names with a ``.join(...)`` call / ``.daemon = True`` assign
        anywhere in the module."""
        joined: Set[str] = set()
        daemonized: Set[str] = set()
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call) and
                    isinstance(node.func, ast.Attribute) and
                    node.func.attr == "join"):
                name = _name_of(node.func.value)
                if name:
                    joined.add(name)
                    # `for t in self._threads: t.join()` style: credit
                    # the container too
                    joined.add(name.rpartition(".")[0] or name)
            elif (isinstance(node, ast.Assign) and
                    isinstance(node.targets[0], ast.Attribute) and
                    node.targets[0].attr == "daemon" and
                    isinstance(node.value, ast.Constant) and
                    node.value.value is True):
                name = _name_of(node.targets[0].value)
                if name:
                    daemonized.add(name)
        return joined, daemonized


CONCURRENCY_RULES = (LockOrderRule, BlockingUnderLockRule,
                     SharedStateEscapeRule, ConditionWaitRule,
                     ThreadDisciplineRule)
CONCURRENCY_RULE_IDS = tuple(r.rule for r in CONCURRENCY_RULES)


# ---------------------------------------------------------------------------
# driving + baseline (reason-carrying variant of jaxlint's)
# ---------------------------------------------------------------------------

def lint_source(src: str, rel: str) -> List[Finding]:
    """Concurrency-lint one source string (rel names the module)."""
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        return [Finding(rule="CL000", path=rel, line=e.lineno or 1,
                        col=0, scope="<module>",
                        message=f"syntax error: {e.msg}", line_text="")]
    ctx = FileContext(rel, src, tree)
    locks = ModuleLocks(ctx)
    findings: List[Finding] = []
    for rule_cls in CONCURRENCY_RULES:
        for f in rule_cls().visit(ctx, locks):
            if f is not None:
                findings.append(f)
    findings.sort(key=lambda f: (f.line, f.col, f.rule))
    return findings


def default_targets(root: str) -> List[str]:
    return [os.path.join(root, m) for m in TARGET_MODULES
            if os.path.exists(os.path.join(root, m))]


def run_paths(paths, root: str) -> List[Finding]:
    """Lint files/dirs (module-local analysis; no cross-file pass)."""
    findings: List[Finding] = []
    for f in sorted(iter_py_files(paths)):
        rel = os.path.relpath(os.path.abspath(f),
                              os.path.abspath(root)).replace(os.sep, "/")
        try:
            with open(f, encoding="utf-8") as fh:
                src = fh.read()
        except OSError:
            continue
        findings.extend(lint_source(src, rel))
    return findings


def default_baseline_path(root: str) -> str:
    """The port's baseline, beside this module (``root`` is the repo
    root that holds ``lightgbm_tpu_torch/``)."""
    return os.path.join(root, "lightgbm_tpu_torch", "analysis",
                        BASELINE_NAME)


def save_baseline(path: str, findings: List[Finding],
                  keep_records: List[dict] = (),
                  prior_records: List[dict] = ()) -> None:
    """Write the triage baseline. Reasons survive regeneration (matched
    by fingerprint against ``prior_records``); new entries get a TODO
    placeholder that the gate refuses until a human fills it in."""
    reasons = {e.get("fingerprint"): e.get("reason", "")
               for e in prior_records}
    records = [
        {"fingerprint": f.fingerprint, "rule": f.rule, "file": f.path,
         "scope": f.scope, "line_text": f.line_text.strip(),
         "reason": reasons.get(f.fingerprint) or
         "TODO: one-line triage reason required"}
        for f in findings] + list(keep_records)
    records.sort(key=lambda e: (e.get("file", ""), e.get("rule", ""),
                                e.get("line_text", "")))
    data = {
        "version": 1,
        "tool": "conlint",
        "note": ("triaged concurrency findings; only NEW findings gate, "
                 "and every entry MUST carry a one-line reason (the "
                 "baseline is the triage record). Regenerate with: "
                 "python -m lightgbm_tpu_torch.analysis "
                 "--update-baseline"),
        "findings": records,
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(data, fh, indent=1)
        fh.write("\n")


def reasonless_entries(records: List[dict]) -> List[dict]:
    return [e for e in records
            if not str(e.get("reason", "")).strip() or
            str(e.get("reason", "")).strip().lower().startswith("todo")]


def main(argv: Optional[List[str]] = None,
         root: Optional[str] = None) -> int:
    import argparse
    parser = argparse.ArgumentParser(
        prog="conlint",
        description="concurrency static analysis (rules CL001-CL005 "
                    "over the port's lock-bearing modules; see "
                    "lightgbm_tpu_torch/analysis/concurrency.py)")
    parser.add_argument("paths", nargs="*")
    parser.add_argument("--baseline", default=None)
    parser.add_argument("--update-baseline", action="store_true")
    parser.add_argument("--no-baseline", action="store_true")
    parser.add_argument("--list", action="store_true", dest="list_all")
    args = parser.parse_args(argv)

    if root is None:
        root = os.getcwd()
    paths, missing = [], []
    for p in args.paths:
        if os.path.exists(p):
            paths.append(p)
        elif os.path.exists(os.path.join(root, p)):
            paths.append(os.path.join(root, p))
        else:
            missing.append(p)
    if missing:
        print(f"conlint: path(s) not found: {', '.join(missing)}")
        return 2
    if not args.paths:
        paths = default_targets(root)
    if not iter_py_files(paths):
        print("conlint: no .py files under the given path(s) — "
              "nothing was linted")
        return 2
    findings = run_paths(paths, root)
    findings_real = [f for f in findings if f.rule != "CL000"]
    syntax_errors = [f for f in findings if f.rule == "CL000"]

    bl_path = args.baseline or default_baseline_path(root)
    prior = load_baseline_records(bl_path)
    if args.update_baseline:
        if syntax_errors:
            for f in syntax_errors:
                print(f.format())
            print("conlint: refusing to update the baseline while files "
                  "fail to parse")
            return 1
        keep: List[dict] = []
        if args.paths:
            scanned = {
                os.path.relpath(os.path.abspath(f), os.path.abspath(root))
                .replace(os.sep, "/") for f in iter_py_files(paths)}
            keep = [e for e in prior if e.get("file") not in scanned]
        save_baseline(bl_path, findings_real, keep, prior)
        todo = reasonless_entries(load_baseline_records(bl_path))
        print(f"conlint: baseline updated with {len(findings_real)} "
              f"finding(s) -> {bl_path}")
        if todo:
            print(f"conlint: {len(todo)} entr(ies) still need a reason "
                  "— the gate fails until each carries one")
        return 0

    baseline = set() if args.no_baseline else \
        {e["fingerprint"] for e in prior}
    new, known = diff_against_baseline(findings_real, baseline)
    for f in syntax_errors:
        print(f.format())
    for f in new:
        print(f.format())
    if args.list_all:
        for f in known:
            print(f"{f.format()}  [known]")
    todo = [] if args.no_baseline else reasonless_entries(prior)
    for e in todo:
        print(f"conlint: baseline entry {e.get('fingerprint')} "
              f"({e.get('file')}: {e.get('rule')}) has no triage "
              "reason — every accepted finding must say why")
    by_rule: Dict[str, int] = {}
    for f in findings_real:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    breakdown = " ".join(f"{r}={by_rule.get(r, 0)}"
                         for r in CONCURRENCY_RULE_IDS)
    print(f"conlint: {len(findings_real)} finding(s): {len(new)} new, "
          f"{len(known)} known (baselined) [{breakdown}]")
    if new:
        print("conlint: new findings — fix them, add a targeted "
              "`# conlint: disable=<RULE>` with a reason, or accept "
              "via --update-baseline (then fill in the reason)")
    return 1 if (new or syntax_errors or todo) else 0
