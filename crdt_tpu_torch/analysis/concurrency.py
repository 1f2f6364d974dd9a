"""Whole-tree lock-order analyzer + runtime deadlock sanitizer.

Port of ``crdt_tpu/analysis/concurrency.py``: the same contracts, rules,
messages and witness paths, over this package's sources; the runtime
half reports into this package's metrics registry, trace ring and
flight recorder.

The control plane runs at least six thread families (serve loop,
flusher, gossip rounds, ReplicaGroup monitors, the autoscaler daemon,
the fleet poller) whose deadlock-freedom used to rest on prose
("promote path group-lock -> control-lock, publish path control-lock
-> install_table lock-free — the cycle that doesn't happen"). This
module turns those invariants into machine-checked contracts.

**Static half** (purely lexical/AST, like host_lint): a class opts in
with a declared acquisition order::

    _CRDTLINT_LOCK_ORDER = ("_control", ("donor.lock", "ServeTier.lock"))

Each entry is either a bare attribute name — ``self.<attr>`` is a lock
this class owns, canonically named ``ClassName.attr`` — or a
``(pattern, key)`` pair: an acquisition site whose dotted expression
suffix-matches ``pattern`` on a dot boundary (``with donor.lock:``)
resolves to the canonical ``key``. Tuple position IS the permitted
acquisition order: an earlier entry may be held while acquiring a
later one, never the reverse.

The analyzer extracts every ``with <lock>:`` / ``<lock>.acquire()``
site, follows self-method and same-module function calls
interprocedurally (so a nested acquisition through a helper —
``split_hot`` -> ``_split_locked`` -> ``_ship_ranges`` -> ``with
donor.lock:`` — becomes a graph edge), and checks the observed
acquisition graph against the union of every declared contract:

- ``lock-order-cycle`` — the combined declared+observed graph contains
  a cycle; the finding carries the full witness path.
- ``lock-order-undeclared`` — an observed edge between two contract
  locks with no declared path from holder to acquiree.
- ``blocking-under-lock`` — a blocking call (``time.sleep``, socket
  I/O, a thread join, a subprocess wait) reachable while ANY declared
  lock is held, or a device dispatch (``pack_since``, the dispatch
  ledger's entry points) reachable while an OUTER lock is held.
  A lock is *outer* when some contract orders it before another lock;
  a *leaf* lock (last in every contract that names it — the store
  lock) legitimately guards device work, which is why the gossip fast
  lane and the serve commit path need no suppressions while a sleep
  under the federation ``_control`` hold is flagged (the exact wedge
  class the federation's ``_dial_upstream`` once had).

Findings accept the standard ``# crdtlint: disable=rule -- reason``
suppressions at the witness line.

**Runtime half**: :func:`make_lock` is the creation seam. With
``CRDT_TPU_SANITIZE`` unset it returns a plain ``threading.Lock`` /
``RLock`` — zero overhead, byte-identical behavior. With the env var
set at creation time it returns an :class:`OrderedLock` that keeps a
per-thread held-set and asserts every acquisition against the declared
rank order: a violation increments
``crdt_tpu_lock_order_violations_total{held,acquiring}`` and emits a
``lock_order_violation`` trace event naming both locks and the holder
thread — then proceeds normally, so the sanitizer can never introduce
a hang the unsanitized build doesn't have.
"""

from __future__ import annotations

import ast
import os
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .findings import Finding, parse_suppressions

RULES = (
    "lock-order-cycle",
    "lock-order-undeclared",
    "blocking-under-lock",
)

# How deep the interprocedural walk follows self-method / same-module
# call chains. The shipped tree needs 3 (split_hot -> _split_locked ->
# _ship_ranges); 6 leaves headroom without risking blowup on cycles
# (visited-set guarded anyway).
_MAX_CALL_DEPTH = 6

# --- blocking-call families ---

_SLEEP_CALLS = {"time.sleep", "_time.sleep"}
_SOCKET_CTORS = {"create_connection", "create_server"}
_SOCKET_METHODS = {"sendall", "recv", "accept", "connect", "makefile"}
_FRAME_HELPERS = {"send_frame", "recv_frame",
                  "send_bytes_frame", "recv_bytes_frame"}
_SUBPROCESS_CALLS = {"subprocess.run", "subprocess.call",
                     "subprocess.check_call", "subprocess.check_output",
                     "subprocess.Popen"}
# ``<thread-ish>.join()`` only: a receiver whose name mentions a
# thread/monitor/worker. ``", ".join`` (str) and ``group.join`` (the
# collective device dispatch) must not match.
_THREADISH_NAMES = ("thread", "monitor", "worker", "flusher", "poller")

# Device dispatches: pack/merge/digest entry points plus the dispatch
# ledger's entry-point list (cli._LEDGER_REQUIRED last components,
# inlined so the analyzer stays import-light; this package's kernel
# wrappers carry the same names: `fanin_step` and `fanin_stream` are
# K3's, `ingest_scatter` K2's, `model_fanin_batch` K1's). Flagged
# only under an OUTER lock — a leaf (store) lock guards device work by
# design.
_DEVICE_DISPATCH = {
    "pack_since", "merge_packed", "merge_and_repack", "drain_ingest",
    "digest_tree", "put_batch", "_pack_for_peer",
    # ledger kernel entry-point last names (obs/device.py census)
    "fanin_step", "fanin_stream", "sparse_fanin_step",
    "wire_join_step", "merge_repack_step", "delta_mask",
    "range_delta_mask", "max_logical_time", "put_scatter",
    "record_scatter", "delete_scatter", "ingest_scatter",
    "digest_tree_device", "ingest_scatter_tiles", "model_fanin_batch",
    "model_fanin_split", "pipelined_model_step",
    "pipelined_model_step_split", "typed_wire_join_step",
    "typed_sparse_join_step", "typed_fanin_step", "sharded_fanin",
    "sharded_pallas_fanin", "sharded_ingest", "sharded_digest",
    "sharded_delta_mask", "sharded_max_logical_time",
    "collective_join",
}


def _dotted(node: ast.AST) -> Optional[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


# --- contract declarations ---

class _Contract:
    """One class's ``_CRDTLINT_LOCK_ORDER`` declaration."""

    __slots__ = ("cls_name", "path", "line", "order", "self_attrs",
                 "patterns")

    def __init__(self, cls_name: str, path: str, line: int):
        self.cls_name = cls_name
        self.path = path
        self.line = line
        self.order: List[str] = []          # canonical keys, in order
        self.self_attrs: Dict[str, str] = {}  # attr -> canonical key
        self.patterns: List[Tuple[str, str]] = []  # (pattern, key)


def _order_decl(cls: ast.ClassDef, path: str) -> Optional[_Contract]:
    for stmt in cls.body:
        if not (isinstance(stmt, (ast.Assign, ast.AnnAssign))):
            continue
        if isinstance(stmt, ast.Assign):
            if len(stmt.targets) != 1 \
                    or not isinstance(stmt.targets[0], ast.Name) \
                    or stmt.targets[0].id != "_CRDTLINT_LOCK_ORDER":
                continue
            value = stmt.value
        else:
            if not isinstance(stmt.target, ast.Name) \
                    or stmt.target.id != "_CRDTLINT_LOCK_ORDER" \
                    or stmt.value is None:
                continue
            value = stmt.value
        try:
            raw = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            return None
        if not isinstance(raw, (tuple, list)):
            return None
        contract = _Contract(cls.name, path, stmt.lineno)
        for entry in raw:
            if isinstance(entry, str):
                key = f"{cls.name}.{entry}"
                contract.self_attrs[entry] = key
                contract.order.append(key)
            elif isinstance(entry, (tuple, list)) and len(entry) == 2 \
                    and all(isinstance(e, str) for e in entry):
                pattern, key = entry
                contract.patterns.append((pattern, key))
                contract.order.append(key)
        return contract
    return None


class _Model:
    """Whole-tree view: contracts + per-class/module function tables
    needed for the interprocedural walk."""

    def __init__(self):
        self.contracts: List[_Contract] = []
        #: bare attr name -> set of canonical keys that declare it
        self.attr_keys: Dict[str, Set[str]] = {}
        #: (path, cls_name) -> {method name -> FunctionDef}
        self.methods: Dict[Tuple[str, str], Dict[str, ast.AST]] = {}
        #: path -> {module-level function name -> FunctionDef}
        self.functions: Dict[str, Dict[str, ast.AST]] = {}
        #: path -> parsed tree
        self.trees: Dict[str, ast.AST] = {}
        #: path -> Suppressions
        self.suppressions: Dict[str, object] = {}
        #: per-class contract lookup
        self.by_class: Dict[Tuple[str, str], _Contract] = {}

    # -- declared-order graph --

    def declared_edges(self) -> Set[Tuple[str, str]]:
        edges: Set[Tuple[str, str]] = set()
        for c in self.contracts:
            for i, a in enumerate(c.order):
                for b in c.order[i + 1:]:
                    if a != b:
                        edges.add((a, b))
        return edges

    def outer_keys(self) -> Set[str]:
        """Keys some contract orders BEFORE another lock — holding one
        of these across a device dispatch wedges the control plane,
        unlike a leaf (store) lock that guards device work by
        design."""
        return {a for a, _ in self.declared_edges()}

    def resolve(self, dotted: str,
                contract: Optional[_Contract]) -> Optional[str]:
        """Canonical lock key for an acquisition-site expression, or
        None when the expression names no contract lock."""
        if dotted.startswith("self."):
            rest = dotted[len("self."):]
            if contract is not None and rest in contract.self_attrs:
                return contract.self_attrs[rest]
            expr = rest
        else:
            expr = dotted
        if contract is not None:
            for pattern, key in contract.patterns:
                if expr == pattern or expr.endswith("." + pattern):
                    return key
        # Unambiguous foreign reference: exactly one class in the tree
        # declares a bare lock with this attribute name.
        attr = expr.rsplit(".", 1)[-1]
        keys = self.attr_keys.get(attr)
        if keys is not None and len(keys) == 1 and "." in expr:
            return next(iter(keys))
        return None


def _build_model(sources: Sequence[Tuple[str, str]]) -> _Model:
    model = _Model()
    for path, text in sources:
        try:
            tree = ast.parse(text)
        except SyntaxError:
            continue  # host_lint reports parse errors
        model.trees[path] = tree
        model.suppressions[path] = parse_suppressions(text)
        model.functions[path] = {
            fn.name: fn for fn in tree.body
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))}
        for cls in ast.walk(tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            model.methods[(path, cls.name)] = {
                fn.name: fn for fn in cls.body
                if isinstance(fn, (ast.FunctionDef,
                                   ast.AsyncFunctionDef))}
            contract = _order_decl(cls, path)
            if contract is not None:
                model.contracts.append(contract)
                model.by_class[(path, cls.name)] = contract
                for attr, key in contract.self_attrs.items():
                    model.attr_keys.setdefault(attr, set()).add(key)
    return model


# --- the interprocedural walk ---

class _Edge:
    __slots__ = ("src", "dst", "path", "line", "witness")

    def __init__(self, src: str, dst: str, path: str, line: int,
                 witness: List[str]):
        self.src = src
        self.dst = dst
        self.path = path
        self.line = line
        self.witness = list(witness)


class _Blocked:
    __slots__ = ("what", "path", "line", "held", "witness")

    def __init__(self, what: str, path: str, line: int,
                 held: Tuple[str, ...], witness: List[str]):
        self.what = what
        self.path = path
        self.line = line
        self.held = held
        self.witness = list(witness)


def _blocking_what(node: ast.Call, outer_held: bool) -> Optional[str]:
    d = _dotted(node.func)
    last = d.rsplit(".", 1)[-1] if d else None
    if d in _SLEEP_CALLS:
        return f"{d}(...)"
    if d in _SUBPROCESS_CALLS:
        return f"{d}(...)"
    if d == "socket.socket" or (last in _SOCKET_CTORS and d
                                and "." in d):
        return f"{d}(...) [socket]"
    if last in _FRAME_HELPERS:
        return f"{last}(...) [socket frame]"
    if isinstance(node.func, ast.Attribute):
        attr = node.func.attr
        recv = _dotted(node.func.value) or ""
        low = recv.rsplit(".", 1)[-1].lower()
        if attr in _SOCKET_METHODS and recv and not recv.startswith(
                ("np.", "numpy.", "jnp.", "jax.", "torch.")):
            return f"{recv}.{attr}(...) [socket]"
        if attr == "join" and any(t in low for t in _THREADISH_NAMES):
            return f"{recv}.join() [thread join]"
        if attr in ("wait", "communicate") and "proc" in low:
            return f"{recv}.{attr}() [subprocess wait]"
        if outer_held and attr in _DEVICE_DISPATCH:
            return f"{recv + '.' if recv else ''}{attr}(...) " \
                   "[device dispatch]"
    elif isinstance(node.func, ast.Name):
        if outer_held and node.func.id in _DEVICE_DISPATCH:
            return f"{node.func.id}(...) [device dispatch]"
    return None


class _Walker:
    """Walks one function body with a held-lock set, following
    self-method and same-module calls, recording acquisition edges and
    blocking sites."""

    def __init__(self, model: _Model, outer: Set[str]):
        self.model = model
        self.outer = outer
        self.edges: List[_Edge] = []
        self.blocked: List[_Blocked] = []
        self._seen_edges: Set[Tuple[str, str, str, int]] = set()
        self._seen_blocked: Set[Tuple[str, int, str]] = set()

    def walk_method(self, path: str, cls_name: Optional[str],
                    fn: ast.AST) -> None:
        contract = self.model.by_class.get((path, cls_name)) \
            if cls_name else None
        self._visit_body(list(ast.iter_child_nodes(fn)), path,
                         cls_name, contract, frozenset(), [], set(), 0)

    # -- internals --

    def _record_edge(self, held: frozenset, key: str, path: str,
                     line: int, witness: List[str]) -> None:
        for src in held:
            if src == key:
                continue  # reentrant same-lock hold (RLock contract)
            sig = (src, key, path, line)
            if sig not in self._seen_edges:
                self._seen_edges.add(sig)
                self.edges.append(_Edge(src, key, path, line, witness))

    def _record_block(self, what: str, path: str, line: int,
                      held: frozenset, witness: List[str]) -> None:
        sig = (path, line, what)
        if sig not in self._seen_blocked:
            self._seen_blocked.add(sig)
            self.blocked.append(_Blocked(
                what, path, line, tuple(sorted(held)), witness))

    def _visit_body(self, nodes: List[ast.AST], path: str,
                    cls_name: Optional[str],
                    contract: Optional[_Contract], held: frozenset,
                    witness: List[str], visiting: Set[Tuple[str, str]],
                    depth: int) -> None:
        for node in nodes:
            self._visit(node, path, cls_name, contract, held, witness,
                        visiting, depth)

    def _visit(self, node: ast.AST, path: str,
               cls_name: Optional[str], contract: Optional[_Contract],
               held: frozenset, witness: List[str],
               visiting: Set[Tuple[str, str]], depth: int) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # nested defs get their own top-level walk
        if isinstance(node, ast.With):
            acquired: List[str] = []
            for item in node.items:
                d = _dotted(item.context_expr)
                if d is not None:
                    key = self.model.resolve(d, contract)
                    if key is not None:
                        site = f"{path}:{item.context_expr.lineno} " \
                               f"with {d}:"
                        self._record_edge(
                            held, key, path, item.context_expr.lineno,
                            witness + [site])
                        acquired.append(key)
                self._visit(item.context_expr, path, cls_name,
                            contract, held, witness, visiting, depth)
            inner = held | frozenset(acquired)
            w = witness + [f"{path}:{node.lineno} with "
                           + ", ".join(acquired)] if acquired \
                else witness
            self._visit_body(node.body, path, cls_name, contract,
                             inner, w, visiting, depth)
            return
        if isinstance(node, ast.AsyncWith):
            # asyncio locks order the EVENT LOOP, not threads — they
            # are outside the thread-lock contract (the serve loop's
            # _OwnerProxy._lock).
            self._visit_body(node.body, path, cls_name, contract,
                             held, witness, visiting, depth)
            return
        if isinstance(node, ast.Call):
            self._handle_call(node, path, cls_name, contract, held,
                              witness, visiting, depth)
        for child in ast.iter_child_nodes(node):
            self._visit(child, path, cls_name, contract, held,
                        witness, visiting, depth)

    def _handle_call(self, node: ast.Call, path: str,
                     cls_name: Optional[str],
                     contract: Optional[_Contract], held: frozenset,
                     witness: List[str],
                     visiting: Set[Tuple[str, str]],
                     depth: int) -> None:
        d = _dotted(node.func)
        # <lock>.acquire(): held for the remainder of the enclosing
        # scope (conservative — matches the try/finally idiom).
        if d is not None and d.endswith(".acquire"):
            key = self.model.resolve(d[:-len(".acquire")], contract)
            if key is not None:
                site = f"{path}:{node.lineno} {d}()"
                self._record_edge(held, key, path, node.lineno,
                                  witness + [site])
                # NOTE: scope-held tracking for .acquire() is handled
                # by the caller via _acquired_keys (statement lists).
        if held:
            what = _blocking_what(
                node, outer_held=any(k in self.outer for k in held))
            if what is not None:
                self._record_block(what, path, node.lineno, held,
                                   witness)
        # interprocedural: self-method and same-module calls
        if depth >= _MAX_CALL_DEPTH or not held:
            # Follow calls only while a lock is held: edges and
            # blocking sites need a non-empty held-set to matter,
            # and an unconditional walk would be quadratic.
            return
        callee: Optional[ast.AST] = None
        callee_cls = cls_name
        if d is not None and d.startswith("self.") \
                and "." not in d[len("self."):] and cls_name:
            callee = self.model.methods.get(
                (path, cls_name), {}).get(d[len("self."):])
        elif isinstance(node.func, ast.Name):
            callee = self.model.functions.get(path, {}).get(
                node.func.id)
            callee_cls = None
        if callee is None:
            return
        sig = (path, getattr(callee, "name", ""))
        if sig in visiting:
            return
        callee_contract = self.model.by_class.get((path, callee_cls)) \
            if callee_cls else None
        self._visit_body(
            list(ast.iter_child_nodes(callee)), path, callee_cls,
            callee_contract, held,
            witness + [f"{path}:{node.lineno} via {d or '?'}()"],
            visiting | {sig}, depth + 1)


# --- .acquire() scope tracking (statement-ordered pre-pass) ---

def _acquire_rewrite(model: _Model, path: str, tree: ast.AST) -> None:
    """Fold ``<lock>.acquire()`` statements into synthetic With
    blocks: every statement AFTER the acquire in the same body runs
    with the lock held (conservative; a matching ``release()`` ends
    the hold)."""
    class _Rewriter(ast.NodeTransformer):
        def _fold(self, body: List[ast.stmt]) -> List[ast.stmt]:
            for i, stmt in enumerate(body):
                if isinstance(stmt, ast.Expr) \
                        and isinstance(stmt.value, ast.Call):
                    d = _dotted(stmt.value.func)
                    if d is not None and d.endswith(".acquire"):
                        rest = body[i + 1:]
                        # stop the hold at an explicit release()
                        for j, later in enumerate(rest):
                            if isinstance(later, ast.Expr) \
                                    and isinstance(later.value,
                                                   ast.Call):
                                dl = _dotted(later.value.func)
                                if dl is not None and dl.endswith(
                                        ".release") \
                                        and dl[:-len(".release")] == \
                                        d[:-len(".acquire")]:
                                    rest = rest[:j]
                                    break
                        if not rest:
                            continue
                        lock_expr = ast.parse(
                            d[:-len(".acquire")], mode="eval").body
                        ast.copy_location(lock_expr, stmt)
                        for n in ast.walk(lock_expr):
                            ast.copy_location(n, stmt)
                        wrapped = ast.With(
                            items=[ast.withitem(
                                context_expr=lock_expr,
                                optional_vars=None)],
                            body=self._fold(rest), type_comment=None)
                        ast.copy_location(wrapped, stmt)
                        return body[:i + 1] + [wrapped]
            return body

        def visit(self, node):
            node = self.generic_visit(node)
            for field in ("body", "orelse", "finalbody"):
                old = getattr(node, field, None)
                if isinstance(old, list) and old \
                        and all(isinstance(s, ast.stmt) for s in old):
                    setattr(node, field, self._fold(old))
            return node

    _Rewriter().visit(tree)


# --- graph checks ---

def _tarjan_sccs(nodes: Set[str],
                 edges: Set[Tuple[str, str]]) -> List[List[str]]:
    adj: Dict[str, List[str]] = {n: [] for n in nodes}
    for a, b in edges:
        if a in adj and b in nodes:
            adj[a].append(b)
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    sccs: List[List[str]] = []
    counter = [0]

    def strongconnect(v: str) -> None:
        # iterative Tarjan (deep graphs must not hit the recursion
        # limit inside a linter)
        work = [(v, iter(adj[v]))]
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
                    work.append((w, iter(adj[w])))
                    advanced = True
                    break
                elif w in on_stack:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.append(w)
                    if w == node:
                        break
                sccs.append(scc)

    for n in sorted(nodes):
        if n not in index:
            strongconnect(n)
    return sccs


def _reachable(edges: Set[Tuple[str, str]], src: str,
               dst: str) -> bool:
    adj: Dict[str, List[str]] = {}
    for a, b in edges:
        adj.setdefault(a, []).append(b)
    seen = {src}
    frontier = [src]
    while frontier:
        n = frontier.pop()
        if n == dst:
            return True
        for m in adj.get(n, ()):
            if m not in seen:
                seen.add(m)
                frontier.append(m)
    return dst in seen


def _graph_findings(model: _Model,
                    edges: List[_Edge]) -> List[Finding]:
    declared = model.declared_edges()
    observed = {(e.src, e.dst) for e in edges}
    nodes = {k for pair in declared | observed for k in pair}
    combined = declared | observed
    sccs = [scc for scc in _tarjan_sccs(nodes, combined)
            if len(scc) > 1]
    cyclic: Set[str] = {n for scc in sccs for n in scc}
    out: List[Finding] = []
    reported_sccs: Set[frozenset] = set()
    # One cycle finding per SCC, pinned at the OFFENDING witness: an
    # observed edge that runs against the declared order if one
    # exists, else the first witness by position. The conforming half
    # of an AB/BA inversion is not the bug.
    by_scc: Dict[frozenset, List[_Edge]] = {}
    for e in edges:
        if e.src in cyclic and e.dst in cyclic:
            for scc in sccs:
                if e.src in scc and e.dst in scc:
                    by_scc.setdefault(frozenset(scc), []).append(e)
                    break
    for scc_key, scc_edges in sorted(
            by_scc.items(), key=lambda kv: sorted(kv[0])):
        pick = min(scc_edges,
                   key=lambda e: ((e.src, e.dst) in declared,
                                  e.path, e.line))
        cycle = " -> ".join(sorted(scc_key))
        out.append(Finding(
            rule="lock-order-cycle", path=pick.path, line=pick.line,
            message=f"acquiring {pick.dst} while holding {pick.src} "
                    f"completes a lock-order cycle "
                    f"({cycle} -> ...)",
            detail="witness path:\n  " + "\n  ".join(pick.witness)
                   + "\nbreak the cycle or re-declare the "
                     "_CRDTLINT_LOCK_ORDER contracts so one "
                     "global order covers every path"))
        reported_sccs.add(scc_key)
    for e in edges:
        if e.src in cyclic and e.dst in cyclic and any(
                e.src in scc and e.dst in scc for scc in sccs):
            continue  # reported above, once per SCC
        if not _reachable(declared, e.src, e.dst):
            out.append(Finding(
                rule="lock-order-undeclared", path=e.path,
                line=e.line,
                message=f"acquiring {e.dst} while holding {e.src} — "
                        "no _CRDTLINT_LOCK_ORDER contract declares "
                        f"{e.src} before {e.dst}",
                detail="witness path:\n  " + "\n  ".join(e.witness)
                       + "\ndeclare the order (extend a contract "
                         "tuple) or restructure so the inner "
                         "acquisition happens after release"))
    # contract-only cycles (inconsistent declarations, no runtime
    # witness): pin at the first declaring contract
    for scc in sccs:
        key = frozenset(scc)
        if key in reported_sccs:
            continue
        decl = next((c for c in model.contracts
                     if any(k in scc for k in c.order)), None)
        if decl is not None:
            out.append(Finding(
                rule="lock-order-cycle", path=decl.path,
                line=decl.line,
                message="declared _CRDTLINT_LOCK_ORDER contracts are "
                        "mutually inconsistent: "
                        + " -> ".join(sorted(scc)) + " -> ...",
                detail="no acquisition site witnesses the cycle, but "
                       "the declarations themselves admit it — "
                       "re-order the contract tuples"))
    return out


def _blocking_findings(model: _Model,
                       blocked: List[_Blocked]) -> List[Finding]:
    out = []
    for b in blocked:
        held = ", ".join(b.held)
        out.append(Finding(
            rule="blocking-under-lock", path=b.path, line=b.line,
            message=f"{b.what} reachable while holding {held}",
            detail="witness path:\n  " + "\n  ".join(b.witness)
                   + "\nmove the blocking call outside the hold, or "
                     "suppress with the reason the hold is bounded "
                     "(docs/ANALYSIS.md, Concurrency)"))
    return out


# --- public API ---

def analyze_sources(sources: Sequence[Tuple[str, str]]
                    ) -> List[Finding]:
    """Run the whole-tree concurrency pass over ``(path, text)``
    pairs: one global lock graph, findings pinned at witness sites,
    per-file suppressions honored. ``suppression-without-reason`` is
    host_lint's to report — unexplained comments are simply inert
    here."""
    model = _build_model(sources)
    if not model.contracts:
        return []
    for path, tree in model.trees.items():
        _acquire_rewrite(model, path, tree)
    walker = _Walker(model, model.outer_keys())
    for (path, cls_name), methods in model.methods.items():
        for name, fn in methods.items():
            if name in ("__init__", "__new__"):
                continue  # construction happens-before publication
            walker.walk_method(path, cls_name, fn)
    for path, functions in model.functions.items():
        for fn in functions.values():
            walker.walk_method(path, None, fn)
    findings = _graph_findings(model, walker.edges)
    findings.extend(_blocking_findings(model, walker.blocked))
    kept = []
    for f in findings:
        supp = model.suppressions.get(f.path)
        if supp is not None and supp.covers(f.rule, f.line):
            continue
        kept.append(f)
    return sorted(set(kept), key=lambda f: (f.path, f.line, f.rule,
                                            f.message))


def analyze_source(text: str, path: str) -> List[Finding]:
    """Single-source convenience wrapper (fixtures, unit tests)."""
    return analyze_sources([(path, text)])


def analyze_paths(paths: Iterable[str]) -> List[Finding]:
    """Analyze files and/or directories as ONE tree (one global
    graph)."""
    sources: List[Tuple[str, str]] = []
    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(d for d in dirnames
                                     if d not in ("__pycache__",))
                for name in sorted(filenames):
                    if name.endswith(".py"):
                        full = os.path.join(dirpath, name)
                        with open(full, "r", encoding="utf-8") as fh:
                            sources.append((full, fh.read()))
        else:
            with open(p, "r", encoding="utf-8") as fh:
                sources.append((p, fh.read()))
    return analyze_sources(sources)


def analyze_package(root: str) -> List[Finding]:
    """Analyze every .py file under ``root`` as one tree — the CI
    gate surface (`python -m crdt_tpu_torch.analysis`)."""
    return analyze_paths([root])


# --- runtime twin: the deadlock sanitizer ---

_VIOLATIONS_METRIC = "crdt_tpu_lock_order_violations_total"

# Per-thread held-lock stack: list of [rank, name, lock_obj, count].
_held = threading.local()


def _held_stack() -> list:
    stack = getattr(_held, "stack", None)
    if stack is None:
        stack = _held.stack = []
    return stack


class OrderedLock:
    """Sanitizing lock proxy (``CRDT_TPU_SANITIZE=1`` at creation).

    Wraps a real ``threading.Lock``/``RLock``; every acquisition is
    checked against the per-thread held-set: acquiring a rank at or
    below an already-held rank (another lock — same-lock RLock
    re-entry is the RLock contract) is a declared-order violation.
    Violations are COUNTED and TRACED, never raised or blocked on —
    the sanitized build can only ever report a deadlock hazard, not
    introduce one.
    """

    __slots__ = ("name", "rank", "_inner")

    def __init__(self, name: str, rank: int, rlock: bool = False):
        self.name = name
        self.rank = rank
        self._inner = threading.RLock() if rlock else threading.Lock()

    def _check(self) -> None:
        stack = _held_stack()
        if getattr(_held, "reporting", False):
            return  # the violation report path takes obs locks itself
        for rank, name, lock, _count in stack:
            if lock is self:
                return  # re-entry; RLock semantics judge it
            if rank >= self.rank:
                self._report(name)
                return

    def _report(self, held_name: str) -> None:
        _held.reporting = True
        try:
            thread = threading.current_thread().name
            try:
                from ..obs.registry import default_registry
                default_registry().counter(
                    _VIOLATIONS_METRIC,
                    "runtime lock acquisitions violating the declared "
                    "_CRDTLINT_LOCK_ORDER rank order",
                ).inc(held=held_name, acquiring=self.name)
            except Exception:
                pass
            try:
                from ..obs.trace import tracer
                ring = tracer()
                if ring.enabled:
                    ring.emit("lock_order_violation", held=held_name,
                              acquiring=self.name, thread=thread)
            except Exception:
                pass
            try:
                # Flight recorder (obs/recorder.py): a lock-order
                # violation is an incident edge worth a debug bundle.
                # Same safety profile as the obs calls above — the
                # reporting guard stops recursive reports, and the
                # recorder throttles same-kind storms itself.
                from ..obs.recorder import default_recorder
                default_recorder().trigger(
                    "lock_order_violation",
                    {"held": held_name, "acquiring": self.name,
                     "thread": thread})
            except Exception:
                pass
        finally:
            _held.reporting = False

    def acquire(self, blocking: bool = True,
                timeout: float = -1) -> bool:
        self._check()
        got = self._inner.acquire(blocking, timeout)
        if got:
            stack = _held_stack()
            for entry in stack:
                if entry[2] is self:
                    entry[3] += 1
                    break
            else:
                stack.append([self.rank, self.name, self, 1])
        return got

    def release(self) -> None:
        stack = _held_stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][2] is self:
                stack[i][3] -= 1
                if stack[i][3] == 0:
                    del stack[i]
                break
        self._inner.release()

    def __enter__(self) -> "OrderedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        inner = self._inner
        return inner.locked() if hasattr(inner, "locked") else False


def make_lock(name: str, rank: int, rlock: bool = False):
    """The lock-creation seam every contract lock goes through.

    ``name`` is the canonical contract key (``"ClassName.attr"``);
    ``rank`` is its position in the global declared order (larger =
    acquired later / more leaf-ward). The sanitize env var is read at
    CREATION time: with it unset this returns a plain
    ``threading.Lock``/``RLock`` — zero per-acquisition overhead and
    byte-identical semantics for the production build."""
    from . import sanitizer
    if not sanitizer.enabled():
        return threading.RLock() if rlock else threading.Lock()
    return OrderedLock(name, rank, rlock=rlock)
