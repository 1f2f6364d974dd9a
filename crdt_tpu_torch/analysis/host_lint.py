"""Host-layer AST linter: project-specific race/discipline rules.

Port of ``crdt_tpu/analysis/host_lint.py``: the same rules (`RULES`,
with ``suppression-without-reason``), rule names, suppression syntax
and messages, run over this package. Three rules key on a spelling of
the JAX package's; each takes this package's beside it:

- ``donated-buffer-reuse`` keys on a scatter wrapper called with
  ``donate=True``. Torch donates no buffer: this package's wrappers
  write the store in place, take no ``donate`` keyword and return the
  store the caller rebinds, so the rule has no torch spelling to add
  and fires only on code that passes the keyword.
- ``pack-path-extra-copy`` keys on ``bytes(...)``, ``.tobytes()`` and
  the numpy array constructors (JAX's ``device_get`` lands through
  ``np.asarray``). The torch materializing calls ``.cpu()``,
  ``.numpy()``, ``.tolist()`` and ``.item()`` count beside them.
- the label scan of ``metric-name-unprefixed`` reads KEYWORD values
  only, which keeps it off JAX's ``.at[..].set(v)`` and torch's
  ``Tensor.set_(src)`` / ``index_put_((i,), v)`` alike: both take
  positional arguments.

The rules:

Every rule encodes a bug class this codebase has actually shipped or
is structurally exposed to (see docs/ANALYSIS.md for the catalog with
reproduced bugs):

- ``socket-no-timeout`` — a socket created without a timeout bound
  turns one silent peer into an unbounded stall of the (single-
  connection) replication endpoint.
- ``lock-discipline`` — reads/writes of attributes a class declares
  lock-guarded (``_CRDTLINT_GUARDED``) outside a ``with self.<lock>:``
  block.
- ``wall-clock-read`` — wall-clock reads outside the one sanctioned
  boundary (``hlc.wall_clock_millis``); HLC math against an ad-hoc
  clock source breaks drift accounting and injected-clock tests.
- ``hlc-wall-compare`` — comparing HLC state against a wall-clock
  read; HLCs order by ``(logical_time, node)``, not wall time.
- ``record-mutation`` — in-place mutation of a ``Record``'s
  ``hlc``/``modified``/``value``; records are handed to merge/watch
  machinery by reference and must be treated as immutable cells.
- ``add-batch-unique-keys`` — passing a keyed ``get`` callback to
  ``ChangeHub.add_batch`` without a visible uniqueness gate; ``get``
  answers a key AT MOST ONCE per batch, so repeat-capable batches
  must pass ``get=None`` (the round-5 ADVICE bug).
- ``donated-buffer-reuse`` — reusing a store buffer after passing it
  to a scatter wrapper with ``donate=True``; the donated buffer is
  aliased and its contents are undefined after the call.
- ``scatter-combiner-bypass`` — calling a store scatter wrapper
  (``put_scatter``/``record_scatter``/``delete_scatter``/
  ``ingest_scatter``/``ingest_scatter_tiles``) in a function with no
  visible ingest gate (no ``drain_ingest`` call and no ``_ingest``
  check before the call); a staged ``ingest()`` window would commit
  its backlog AFTER such a write, stamping over it out of HLC order.
  The combiner's own flush is the one sanctioned direct writer
  (reasoned suppression).
- ``pack-path-extra-copy`` — a materializing call (``bytes(...)``,
  ``.tobytes()``, ``np.asarray``/``np.ascontiguousarray``/
  ``np.array``) inside a pack→frame function; the zero-copy fast path
  frames memoryviews over the pack arena directly, and every stray
  copy silently re-inflates bytes-to-wire latency. Legitimate copies
  (a device_get, normalizing a foreign lane) carry reasoned
  suppressions and are counted in
  ``crdt_tpu_pack_copy_bytes_total`` (docs/FASTPATH.md).
- ``merkle-digest-host-hash`` — a host-side hash call (``hashlib.*``,
  builtin ``hash(...)``, ``zlib.crc32``/``zlib.adler32``) inside a
  digest/merkle-path function; the anti-entropy digest is the
  device's job (one jit-cached reduction in ``ops/digest.py``), and a
  host re-hash both drags store lanes off device and — for builtin
  ``hash`` — is salted per process, so equal stores digest unequal
  (docs/ANTIENTROPY.md).
- ``async-blocking-call`` — a blocking call (``time.sleep``, a
  ``socket.*`` constructor, a blocking socket method, or one of the
  sync frame helpers ``send_frame``/``recv_frame``/
  ``send_bytes_frame``/``recv_bytes_frame``) lexically inside an
  ``async def``; one blocked coroutine stalls the serving tier's
  entire event loop and every multiplexed session on it
  (docs/SERVING.md). Route device/file work through
  ``loop.run_in_executor`` and sleep with ``asyncio.sleep``. Passing
  a sync helper BY REFERENCE to an executor is fine — only the
  direct call blocks. Also flags a synchronous ``with self.<lock>:``
  inside an ``async def`` when ``<lock>`` is named by the class's
  ``_CRDTLINT_LOCK_ORDER`` contract: a contended thread-lock
  acquisition parks the event loop exactly like a blocking socket
  (``async with`` on an asyncio lock is the sanctioned form).
- ``thread-unnamed`` — a ``threading.Thread(...)`` constructed
  without a stable ``name=``; lock-order witness paths, the runtime
  sanitizer's violation events, and fleet traces all identify the
  holder by thread name, and ``Thread-12`` identifies nothing.
- ``metric-name-unprefixed`` — a counter/gauge/histogram registered
  outside the ``crdt_tpu_`` namespace, or a metric label whose value
  is drawn from a user key/slot. The fleet poller (obs/fleet.py)
  federates series by name, so an unprefixed name collides with
  foreign exporters; a per-key label value mints one time series per
  key — unbounded cardinality that melts the registry
  (docs/OBSERVABILITY.md).
- ``router-epoch-bypass`` — in a class carrying a partition router
  (``self.router`` assigned in ``__init__``), a keyspace-op enqueue
  (``self._q.append``/``.push``) with no router consultation
  lexically before it; such a write skips the ``moved``/stale-epoch
  admission gate and can land on a partition that no longer owns the
  slot mid-split (docs/FEDERATION.md).
- ``combiner-enqueue-unsafe`` — in a combiner-owning class
  (``self._wc`` assigned in ``__init__``, the serving-tier shape), a
  plain-list ``.append`` on the pending write queue (any
  ``self._q...`` target); multi-loop serving drains that queue from
  the committer while EVERY accept loop produces into it, so the one
  sanctioned enqueue is the MPSC gate's ``push`` — a bare list append
  races the committer's swap and can drop or double-resolve an acked
  write (docs/SERVING.md).
- ``collective-socket-fallback-silent`` — in a class carrying a
  pod-local replica group (``self._group`` assigned in ``__init__``),
  a ``try`` that attempts the collective join with an except-handler
  that neither counts the downgrade
  (``crdt_tpu_collective_fallback_total`` / ``stats.fallbacks``) nor
  re-raises; a co-located round silently landing on the socket path
  is an invisible topology regression (docs/COLLECTIVE.md).
- ``scale-decision-unfenced`` — in a class owning a federation handle
  (``self.fed`` assigned in ``__init__``, the autoscaler shape), a
  ``split_hot``/``merge_cold`` invocation without BOTH fences
  lexically before it: the table-epoch consult (any ``epoch``
  attribute/name read — the stale-observation fence) and the
  in-flight guard (any name containing ``inflight``/``in_flight``).
  A scale decision acted on a stale epoch can retire an arc a
  concurrent change just made hot, and overlapping changes race each
  other's ``_control`` hold (docs/FEDERATION.md).
- ``purge-watermark-unfenced`` — a ``.gc_purge(...)`` invocation
  without a stability-watermark consult (any name or attribute
  containing ``stability``) lexically at or before it in the same
  function. Epoch GC is only sound against a fleet stability
  watermark (`GossipNode.stability_hlc` / `ServeTier.stability_hlc`
  — min over every peer's durable delivery mark, pinned on any
  unmeasured input); purging against a local clock, a guess, or a
  single peer's ack physically deletes tombstones other replicas
  still need, and the resulting resurrection is silent data
  corruption (docs/STORAGE.md).

The linter is purely lexical/AST — no imports of the linted code — so
it runs on broken or unimportable files (the self-test fixtures).
Lock discipline is declaration-driven: a class opts in with

    _CRDTLINT_GUARDED = {"_lock": ("attr_a", "attr_b")}

and the linter enforces that every ``self.attr_a`` access in a method
sits lexically inside ``with self._lock:``. ``__init__`` is exempt
(construction happens-before publication).
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Set, Tuple

from .findings import Finding, apply_suppressions, parse_suppressions

RULES = (
    "socket-no-timeout",
    "lock-discipline",
    "wall-clock-read",
    "hlc-wall-compare",
    "record-mutation",
    "add-batch-unique-keys",
    "donated-buffer-reuse",
    "scatter-combiner-bypass",
    "pack-path-extra-copy",
    "merkle-digest-host-hash",
    "async-blocking-call",
    "metric-name-unprefixed",
    "router-epoch-bypass",
    "combiner-enqueue-unsafe",
    "collective-socket-fallback-silent",
    "ack-before-replicate",
    "scale-decision-unfenced",
    "purge-watermark-unfenced",
    "thread-unnamed",
    "histogram-ceiling-gate",
    "suppression-without-reason",
)

_SOCKET_CTORS = {"create_connection", "create_server"}
_WALL_CALLS = {
    "time.time", "time.time_ns", "_time.time", "_time.time_ns",
    "datetime.now", "datetime.utcnow",
    "datetime.datetime.now", "datetime.datetime.utcnow",
}
_HLC_ATTRS = {"hlc", "canonical_time", "_canonical_time", "logical_time"}
_DONATING_WRAPPERS = {"put_scatter", "record_scatter", "delete_scatter",
                      "ingest_scatter", "ingest_scatter_tiles"}
_COMBINER_SCATTERS = _DONATING_WRAPPERS
# Lexical evidence that a function respects the write-combiner barrier:
# it drains the window, or it branches on the staging handle.
_COMBINER_GATES = {"drain_ingest", "_ingest"}
# pack-path-extra-copy fires only inside functions on the pack→frame
# path: names containing "pack" (but not the unpack/decode direction
# or the merge ingest surface, whose np.asarray lane normalization is
# the WIRE-IN side), plus the framing entry points by exact name.
_PACK_PATH_EXACT = {"encode", "send_bytes_frame"}
_PACK_COPY_CALLS = {"np.asarray", "np.ascontiguousarray",
                    "numpy.asarray", "numpy.ascontiguousarray"}
# The torch spellings of a host copy: a device tensor's trip to the
# host (``.cpu()``, ``.numpy()``) or its unboxing (``.tolist()``,
# ``.item()``).
_PACK_COPY_METHODS = {"tobytes", "cpu", "numpy", "tolist", "item"}
# merkle-digest-host-hash: host hash calls that must never appear on
# the digest path — the digest is the device's job, and builtin hash()
# is salted per process (PYTHONHASHSEED), so equal stores would digest
# unequal across replicas.
_HOST_HASH_CALLS = {"zlib.crc32", "zlib.adler32",
                    "_zlib.crc32", "_zlib.adler32"}
# async-blocking-call: calls that park the whole event loop when made
# directly from a coroutine. The sync frame helpers (net.py) block on
# sendall/recv under the hood; coroutines must use the async codec
# path in serve.py instead.
_ASYNC_BLOCKING_SLEEPS = {"time.sleep", "_time.sleep"}
_ASYNC_FRAME_HELPERS = {"send_frame", "recv_frame",
                        "send_bytes_frame", "recv_bytes_frame"}
_ASYNC_BLOCKING_SOCK_METHODS = {"sendall", "recv", "accept", "connect",
                                "makefile"}


def _dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for nested Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _functions(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _is_wall_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    d = _dotted(node.func)
    return d in _WALL_CALLS


def _contains_wall_call(node: ast.AST) -> bool:
    return any(_is_wall_call(n) for n in ast.walk(node))


def _contains_hlc_attr(node: ast.AST) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Attribute) and n.attr in _HLC_ATTRS:
            return True
        if isinstance(n, ast.Name) and n.id in _HLC_ATTRS:
            return True
    return False


# --- rule: socket-no-timeout ---

def _check_sockets(tree: ast.AST, path: str) -> List[Finding]:
    out: List[Finding] = []
    for fn in _functions(tree):
        # assignment target (dotted) per socket-ctor call id
        targets: Dict[int, Optional[str]] = {}
        settimeout_on: Set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.value, ast.Call):
                targets[id(node.value)] = _dotted(node.targets[0])
            if isinstance(node, ast.withitem) \
                    and isinstance(node.context_expr, ast.Call) \
                    and node.optional_vars is not None:
                targets[id(node.context_expr)] = _dotted(node.optional_vars)
            if isinstance(node, ast.Call):
                d = _dotted(node.func)
                if d is not None and d.endswith(".settimeout"):
                    settimeout_on.add(d.rsplit(".", 1)[0])
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            d = _dotted(node.func)
            if d is None:
                continue
            name = d.rsplit(".", 1)[-1]
            if name not in _SOCKET_CTORS and d != "socket.socket":
                continue
            if any(kw.arg == "timeout" for kw in node.keywords):
                continue
            target = targets.get(id(node))
            if target is not None and target in settimeout_on:
                continue
            out.append(Finding(
                rule="socket-no-timeout", path=path, line=node.lineno,
                message=f"{d}(...) without a timeout bound (no timeout= "
                        "and no settimeout on the result); a silent peer "
                        "stalls this path forever"))
    # Pooled sessions: PeerConnection(..., idle_timeout=None) disables
    # the stale-session bound, so a parked connection can outlive the
    # server's io_timeout and the next round races a half-closed
    # socket. The default (20 s) is deliberately below the server's
    # 30 s — only an explicit None is flagged.
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        d = _dotted(node.func)
        if d is None or d.rsplit(".", 1)[-1] != "PeerConnection":
            continue
        for kw in node.keywords:
            if kw.arg == "idle_timeout" \
                    and isinstance(kw.value, ast.Constant) \
                    and kw.value.value is None:
                out.append(Finding(
                    rule="socket-no-timeout", path=path,
                    line=node.lineno,
                    message="PeerConnection(..., idle_timeout=None) "
                            "disables the stale-session bound; a "
                            "parked session can outlive the server's "
                            "io_timeout and the next round races a "
                            "half-closed socket"))
    return out


# --- rule: lock-discipline ---

def _guard_decl(cls: ast.ClassDef) -> Dict[str, Tuple[str, ...]]:
    for stmt in cls.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name) \
                and stmt.targets[0].id == "_CRDTLINT_GUARDED":
            try:
                raw = ast.literal_eval(stmt.value)
            except (ValueError, SyntaxError):
                return {}
            if isinstance(raw, dict):
                return {str(k): tuple(str(a) for a in v)
                        for k, v in raw.items()}
    return {}


def _check_lock_discipline(tree: ast.AST, path: str) -> List[Finding]:
    out: List[Finding] = []
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        guards = _guard_decl(cls)
        if not guards:
            continue
        attr_to_lock = {attr: lock
                        for lock, attrs in guards.items()
                        for attr in attrs}

        def visit(node: ast.AST, held: frozenset) -> None:
            if isinstance(node, (ast.With, ast.AsyncWith)):
                acquired = set()
                for item in node.items:
                    d = _dotted(item.context_expr)
                    if d is not None and d.startswith("self."):
                        lock = d[len("self."):]
                        if lock in guards:
                            acquired.add(lock)
                    # the lock expression itself runs unguarded
                    visit(item.context_expr, held)
                for child in node.body:
                    visit(child, held | frozenset(acquired))
                return
            if isinstance(node, ast.Attribute) \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id == "self" \
                    and node.attr in attr_to_lock \
                    and attr_to_lock[node.attr] not in held:
                out.append(Finding(
                    rule="lock-discipline", path=path, line=node.lineno,
                    message=f"self.{node.attr} accessed outside "
                            f"'with self.{attr_to_lock[node.attr]}:' "
                            f"(declared guarded by "
                            f"{cls.name}._CRDTLINT_GUARDED)"))
            for child in ast.iter_child_nodes(node):
                visit(child, held)

        for stmt in cls.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if stmt.name in ("__init__", "__new__", "__del__"):
                    continue
                visit(stmt, frozenset())
    return out


# --- rules: wall-clock-read / hlc-wall-compare ---

def _check_wall_clock(tree: ast.AST, path: str) -> List[Finding]:
    out: List[Finding] = []
    # calls inside the sanctioned boundary function are exempt
    exempt: Set[int] = set()
    for fn in _functions(tree):
        if fn.name == "wall_clock_millis":
            exempt.update(id(n) for n in ast.walk(fn))
    for node in ast.walk(tree):
        if _is_wall_call(node) and id(node) not in exempt:
            out.append(Finding(
                rule="wall-clock-read", path=path, line=node.lineno,
                message=f"{_dotted(node.func)}() outside "
                        "hlc.wall_clock_millis; clock-path code must "
                        "read wall time through the injectable boundary"))
        if isinstance(node, ast.Compare):
            sides = [node.left] + list(node.comparators)
            if any(_contains_wall_call(s) for s in sides) \
                    and any(_contains_hlc_attr(s) for s in sides
                            if not _contains_wall_call(s)):
                out.append(Finding(
                    rule="hlc-wall-compare", path=path, line=node.lineno,
                    message="HLC state compared against a wall-clock "
                            "read; HLCs order by (logical_time, node), "
                            "not wall time"))
    return out


# --- rule: record-mutation ---

def _check_record_mutation(tree: ast.AST, path: str) -> List[Finding]:
    out: List[Finding] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            tgts = node.targets
        elif isinstance(node, ast.AugAssign):
            tgts = [node.target]
        else:
            continue
        for tgt in tgts:
            if not isinstance(tgt, ast.Attribute):
                continue
            base = _dotted(tgt.value)
            if base == "self":
                continue  # a class assigning its own slots
            hit = (tgt.attr in ("hlc", "modified")
                   or (tgt.attr == "value" and base is not None
                       and "record" in base.lower()))
            if hit:
                out.append(Finding(
                    rule="record-mutation", path=path, line=tgt.lineno,
                    message=f"in-place mutation of {base}.{tgt.attr}; "
                            "Records are shared by reference with "
                            "merge/watch machinery — build a new "
                            "Record instead"))
    return out


# --- rule: add-batch-unique-keys ---

def _get_arg(call: ast.Call) -> Optional[ast.AST]:
    if len(call.args) >= 2:
        return call.args[1]
    for kw in call.keywords:
        if kw.arg == "get":
            return kw.value
    return None


def _check_add_batch(tree: ast.AST, path: str) -> List[Finding]:
    out: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        if not (isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_batch"):
            continue
        get = _get_arg(node)
        if get is None:
            continue
        if isinstance(get, ast.Constant) and get.value is None:
            continue
        if isinstance(get, ast.IfExp) and any(
                isinstance(b, ast.Constant) and b.value is None
                for b in (get.body, get.orelse)):
            continue  # '... if unique else None' uniqueness gate
        out.append(Finding(
            rule="add-batch-unique-keys", path=path, line=node.lineno,
            message="add_batch(..., get=...) without a visible "
                    "uniqueness gate ('get if unique else None'); "
                    "get answers a key AT MOST ONCE per batch — a "
                    "repeat-capable batch must pass get=None "
                    "(suppress with the uniqueness argument if slots "
                    "are unique by construction)"))
    return out


# --- rule: donated-buffer-reuse ---

def _check_donated_reuse(tree: ast.AST, path: str) -> List[Finding]:
    out: List[Finding] = []
    for fn in _functions(tree):
        # result-assignment targets per call id: 'store = put_scatter(
        # store, ..., donate=True)' rebinds the name, so later reads
        # see the fresh buffer and are fine.
        assigned: Dict[int, Set[str]] = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Call):
                names = {d for d in (_dotted(t) for t in node.targets)
                         if d is not None}
                assigned[id(node.value)] = names
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            d = _dotted(node.func)
            if d is None or d.rsplit(".", 1)[-1] not in _DONATING_WRAPPERS:
                continue
            donated = any(
                kw.arg == "donate"
                and isinstance(kw.value, ast.Constant)
                and kw.value.value is True
                for kw in node.keywords)
            if not donated or not node.args:
                continue
            buf = _dotted(node.args[0])
            if buf is None or buf in assigned.get(id(node), set()):
                continue
            for later in ast.walk(fn):
                if not isinstance(later, (ast.Name, ast.Attribute)):
                    continue
                if getattr(later, "lineno", 0) <= node.lineno:
                    continue
                if _dotted(later) == buf \
                        and isinstance(getattr(later, "ctx", None),
                                       ast.Load):
                    out.append(Finding(
                        rule="donated-buffer-reuse", path=path,
                        line=later.lineno,
                        message=f"{buf} read after being donated to "
                                f"{d}(donate=True) at line "
                                f"{node.lineno}; a donated buffer is "
                                "aliased and undefined afterwards"))
                    break
    return out


# --- rule: scatter-combiner-bypass ---

def _check_combiner_bypass(tree: ast.AST, path: str) -> List[Finding]:
    out: List[Finding] = []
    for fn in _functions(tree):
        if fn.name in _COMBINER_SCATTERS:
            # The public wrappers are definitionally below the barrier.
            # The combiner's own flush is NOT exempted by name — it
            # carries a reasoned suppression at its call site instead.
            continue
        gates: List[int] = []
        for node in ast.walk(fn):
            if isinstance(node, ast.Attribute) \
                    and node.attr in _COMBINER_GATES:
                gates.append(node.lineno)
            elif isinstance(node, ast.Name) and node.id in _COMBINER_GATES:
                gates.append(node.lineno)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            d = _dotted(node.func)
            if d is None or d.rsplit(".", 1)[-1] not in _COMBINER_SCATTERS:
                continue
            if any(g <= node.lineno for g in gates):
                continue
            out.append(Finding(
                rule="scatter-combiner-bypass", path=path,
                line=node.lineno,
                message=f"{d}(...) writes the store with no visible "
                        "ingest gate (no drain_ingest call or _ingest "
                        "check earlier in this function); a staged "
                        "ingest() window would commit its backlog AFTER "
                        "this write and stamp over it out of HLC order "
                        "— drain first (suppress only for the "
                        "combiner's own flush)"))
    return out


# --- rule: pack-path-extra-copy ---

def _on_pack_path(name: str) -> bool:
    """Pack→frame functions only: the OUTBOUND direction. ``unpack``
    (wire-in decode) and ``merge`` (ingest surface — its np.asarray
    calls normalize PEER lanes, not the local pack) are the two name
    families that legitimately materialize."""
    low = name.lower()
    if low in _PACK_PATH_EXACT:
        return True
    return "pack" in low and "unpack" not in low and "merge" not in low


def _check_pack_path_copies(tree: ast.AST, path: str) -> List[Finding]:
    out: List[Finding] = []
    for fn in _functions(tree):
        if not _on_pack_path(fn.name):
            continue
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            d = _dotted(node.func)
            what = None
            if d == "bytes":
                what = "bytes(...)"
            elif d in _PACK_COPY_CALLS:
                what = f"{d}(...)"
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _PACK_COPY_METHODS:
                what = f".{node.func.attr}()"
            if what is None:
                continue
            out.append(Finding(
                rule="pack-path-extra-copy", path=path,
                line=node.lineno,
                message=f"{what} in pack-path function {fn.name}() "
                        "materializes a copy between pack and frame; "
                        "the fast path frames memoryviews over the "
                        "pack arena directly — if this copy is "
                        "required (device_get, foreign-lane "
                        "normalization), suppress with a reason and "
                        "count it in crdt_tpu_pack_copy_bytes_total"))
    return out


# --- rule: merkle-digest-host-hash ---

def _on_digest_path(name: str) -> bool:
    """Digest/merkle-path functions by name — the same lexical scoping
    the pack-path rule uses."""
    low = name.lower()
    return "digest" in low or "merkle" in low


def _check_digest_host_hash(tree: ast.AST, path: str) -> List[Finding]:
    out: List[Finding] = []
    for fn in _functions(tree):
        if not _on_digest_path(fn.name):
            continue
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            d = _dotted(node.func)
            what = None
            if d == "hash":
                what = "builtin hash(...)"
            elif d in _HOST_HASH_CALLS:
                what = f"{d}(...)"
            elif d is not None and (d.startswith("hashlib.")
                                    or d.startswith("_hashlib.")):
                what = f"{d}(...)"
            if what is None:
                continue
            out.append(Finding(
                rule="merkle-digest-host-hash", path=path,
                line=node.lineno,
                message=f"{what} in digest-path function {fn.name}() "
                        "re-hashes on host; the anti-entropy digest "
                        "is computed on device (ops/digest.py) and "
                        "builtin hash() is salted per process, so a "
                        "host hash diverges across replicas — use the "
                        "device digest tree (docs/ANTIENTROPY.md)"))
    return out


# --- rule: async-blocking-call ---

def _own_nodes(fn: ast.AsyncFunctionDef):
    """The coroutine's OWN statements: nested defs are excluded — a
    nested sync helper is executor bait (called off-loop by design)
    and a nested async def gets its own visit from the outer walk."""
    def rec(node: ast.AST):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            yield child
            yield from rec(child)
    yield from rec(fn)


def _check_async_blocking(tree: ast.AST, path: str) -> List[Finding]:
    out: List[Finding] = []
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.AsyncFunctionDef):
            continue
        # a call that is directly awaited is an async API, whatever
        # its name — only the un-awaited form blocks the loop
        awaited = {id(n.value) for n in _own_nodes(fn)
                   if isinstance(n, ast.Await)}
        for node in _own_nodes(fn):
            if not isinstance(node, ast.Call) or id(node) in awaited:
                continue
            d = _dotted(node.func)
            what = None
            if d in _ASYNC_BLOCKING_SLEEPS:
                what = (f"{d}(...) parks the event loop; "
                        "await asyncio.sleep(...) instead")
            elif d is not None and (d == "socket.socket"
                                    or (d.startswith("socket.")
                                        and d.rsplit(".", 1)[-1]
                                        in _SOCKET_CTORS)):
                what = (f"{d}(...) creates a blocking socket; use "
                        "asyncio streams (asyncio.start_server / "
                        "open_connection)")
            elif d is not None and d.rsplit(".", 1)[-1] \
                    in _ASYNC_FRAME_HELPERS:
                what = (f"{d}(...) is the SYNC frame helper "
                        "(blocking sendall/recv under the hood); "
                        "coroutines must use the async frame path or "
                        "run_in_executor")
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _ASYNC_BLOCKING_SOCK_METHODS:
                what = (f".{node.func.attr}(...) is a blocking socket "
                        "call; use asyncio transports or "
                        "run_in_executor")
            if what is None:
                continue
            out.append(Finding(
                rule="async-blocking-call", path=path,
                line=node.lineno,
                message=f"{what} — inside coroutine {fn.name}() this "
                        "stalls every session multiplexed on the "
                        "serving tier's loop (docs/SERVING.md)"))
    # Synchronous acquisition of a declared-contract thread lock
    # inside a coroutine: a contended `with self.<lock>:` parks the
    # event loop exactly like a blocking socket. The contract tuple
    # (`_CRDTLINT_LOCK_ORDER`) tells us which attributes are real
    # cross-thread locks; `async with` (an asyncio lock) is the
    # sanctioned form and is a different AST node entirely.
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        attrs = _lock_order_attrs(cls)
        if not attrs:
            continue
        for fn in ast.walk(cls):
            if not isinstance(fn, ast.AsyncFunctionDef):
                continue
            for node in _own_nodes(fn):
                if not isinstance(node, ast.With):
                    continue
                for item in node.items:
                    d = _dotted(item.context_expr)
                    if d is not None and d.startswith("self.") \
                            and d[len("self."):] in attrs:
                        out.append(Finding(
                            rule="async-blocking-call", path=path,
                            line=item.context_expr.lineno,
                            message=f"sync `with {d}:` inside "
                                    f"coroutine {fn.name}() — "
                                    f"{d[len('self.'):]} is a "
                                    "declared contract lock "
                                    "(_CRDTLINT_LOCK_ORDER), and a "
                                    "contended thread-lock "
                                    "acquisition parks the event "
                                    "loop; hold it via "
                                    "run_in_executor or switch to "
                                    "an asyncio.Lock"))
    return out


def _lock_order_attrs(cls: ast.ClassDef) -> Set[str]:
    """Bare ``self.<attr>`` lock names a class's
    ``_CRDTLINT_LOCK_ORDER`` contract declares (pattern entries name
    foreign locks and don't bind a self attribute)."""
    for stmt in cls.body:
        value = None
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name) \
                and stmt.targets[0].id == "_CRDTLINT_LOCK_ORDER":
            value = stmt.value
        elif isinstance(stmt, ast.AnnAssign) \
                and isinstance(stmt.target, ast.Name) \
                and stmt.target.id == "_CRDTLINT_LOCK_ORDER" \
                and stmt.value is not None:
            value = stmt.value
        if value is None:
            continue
        try:
            raw = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            return set()
        if isinstance(raw, (tuple, list)):
            return {e for e in raw if isinstance(e, str)}
        return set()
    return set()


# --- rule: thread-unnamed ---

def _check_thread_unnamed(tree: ast.AST, path: str) -> List[Finding]:
    out: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        d = _dotted(node.func)
        if d is None or not (d == "Thread"
                             or d.endswith("threading.Thread")
                             or d == "_threading.Thread"):
            continue
        if any(kw.arg == "name" for kw in node.keywords):
            continue
        out.append(Finding(
            rule="thread-unnamed", path=path, line=node.lineno,
            message="threading.Thread(...) without a stable name= — "
                    "lock-order witness paths, sanitizer violation "
                    "events, and fleet traces identify the holder by "
                    "thread name, and the default Thread-N "
                    "identifies nothing"))
    return out


# --- rule: metric-name-unprefixed ---

# Metric registration surfaces (MetricsRegistry methods) and the
# observation methods that accept **label kwargs. jax's `.at[..].set()`
# and torch's `Tensor.set_()` / `index_put_()` take labels-free
# positional args, so restricting the cardinality scan to KEYWORD
# values keeps it off the device paths.
_METRIC_CTORS = {"counter", "gauge", "histogram"}
_METRIC_LABEL_SINKS = _METRIC_CTORS | {"inc", "observe", "set"}
# Identifier shapes that mean "this came from user data": a key or a
# store slot. Bounded enums (op/trigger/phase/lane/node/peer) are the
# sanctioned label vocabulary.
_USER_KEY_NAMES = {"key", "keys", "user_key", "raw_key",
                   "slot", "slots"}
_METRIC_PREFIX = "crdt_tpu_"


def _mentions_user_key(node: ast.AST) -> Optional[str]:
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and n.id in _USER_KEY_NAMES:
            return n.id
        if isinstance(n, ast.Attribute) and n.attr in _USER_KEY_NAMES:
            return n.attr
    return None


def _check_metric_names(tree: ast.AST, path: str) -> List[Finding]:
    out: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) \
                or not isinstance(node.func, ast.Attribute):
            continue
        attr = node.func.attr
        if attr in _METRIC_CTORS and node.args:
            first = node.args[0]
            if isinstance(first, ast.Constant) \
                    and isinstance(first.value, str) \
                    and not first.value.startswith(_METRIC_PREFIX):
                out.append(Finding(
                    rule="metric-name-unprefixed", path=path,
                    line=node.lineno,
                    message=f".{attr}({first.value!r}) registers a "
                            "metric outside the 'crdt_tpu_' "
                            "namespace; the fleet poller federates "
                            "series by name, and an unprefixed name "
                            "collides with foreign exporters "
                            "(docs/OBSERVABILITY.md)"))
        if attr in _METRIC_LABEL_SINKS:
            for kw in node.keywords:
                if kw.arg is None:
                    continue
                bad = _mentions_user_key(kw.value)
                if bad is not None:
                    out.append(Finding(
                        rule="metric-name-unprefixed", path=path,
                        line=node.lineno,
                        message=f"label {kw.arg}= draws its value "
                                f"from {bad!r} (a user key/slot); "
                                "per-key label values mint one time "
                                "series per key — unbounded "
                                "cardinality. Aggregate, bucket, or "
                                "drop the label "
                                "(docs/OBSERVABILITY.md)"))
    return out


# --- rule: router-epoch-bypass ---

# Lexical evidence that a method admits keyspace ops through the
# partition router before enqueueing: it touches self.router, or it
# calls the tier's route-verdict helper (the batched binop admission
# path goes through check_batch).
_ROUTER_GATE_CALLS = {"_route_verdict", "check", "check_batch"}

# Enqueue spellings the write-queue rules recognize: list-era append
# and the MPSC gate's push.
_ENQUEUE_CALLS = {"append", "push"}


def _check_router_bypass(tree: ast.AST, path: str) -> List[Finding]:
    """In a class that carries a partition router (``self.router``
    assigned in ``__init__``), every method that enqueues a keyspace
    op (``self._q.append``/``.push``) must consult the router FIRST —
    an enqueue lexically before any router reference is a write the
    `moved`/stale-epoch protocol never saw, which silently violates
    partition ownership during a live split (docs/FEDERATION.md)."""
    out: List[Finding] = []
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        routed = False
        for fn in cls.body:
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and fn.name == "__init__":
                for n in ast.walk(fn):
                    if isinstance(n, ast.Attribute) \
                            and n.attr == "router" \
                            and isinstance(n.value, ast.Name) \
                            and n.value.id == "self" \
                            and isinstance(n.ctx, ast.Store):
                        routed = True
        if not routed:
            continue
        for fn in cls.body:
            if not isinstance(fn, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)) \
                    or fn.name == "__init__":
                continue
            gate_line = None
            appends: List[ast.Call] = []
            for n in ast.walk(fn):
                if isinstance(n, ast.Attribute) \
                        and n.attr == "router" \
                        and isinstance(n.value, ast.Name) \
                        and n.value.id == "self":
                    if gate_line is None or n.lineno < gate_line:
                        gate_line = n.lineno
                if isinstance(n, ast.Call) \
                        and isinstance(n.func, ast.Attribute) \
                        and n.func.attr in _ROUTER_GATE_CALLS:
                    if gate_line is None or n.lineno < gate_line:
                        gate_line = n.lineno
                if isinstance(n, ast.Call) \
                        and isinstance(n.func, ast.Attribute) \
                        and n.func.attr in _ENQUEUE_CALLS:
                    tgt = _dotted(n.func.value)
                    if tgt == "self._q":
                        appends.append(n)
            for call in appends:
                if gate_line is None or call.lineno < gate_line:
                    out.append(Finding(
                        rule="router-epoch-bypass", path=path,
                        line=call.lineno,
                        message=f"{fn.name}() enqueues a keyspace op "
                                "(self._q enqueue) without first "
                                "consulting self.router — the op "
                                "bypasses the moved/stale-epoch "
                                "admission gate and can land on a "
                                "partition that no longer owns the "
                                "slot mid-split "
                                "(docs/FEDERATION.md)"))
    return out


# --- rule: combiner-enqueue-unsafe ---


def _dotted_through_subscripts(node: ast.AST) -> Optional[str]:
    """Like ``_dotted`` but a subscript link in the chain is elided
    rather than fatal: ``self._q._stripes[0].items`` reads as
    ``self._q._stripes.items`` — reaching INTO the queue's stripes is
    exactly the bypass this rule exists to catch."""
    parts: List[str] = []
    while True:
        if isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        elif isinstance(node, ast.Subscript):
            node = node.value
        else:
            break
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _check_combiner_enqueue(tree: ast.AST, path: str) -> List[Finding]:
    """In a combiner-owning class (``self._wc`` assigned in
    ``__init__`` — the serving-tier shape), every enqueue into the
    pending write queue must go through the MPSC gate (``.push``): a
    plain-list ``.append`` on any ``self._q...`` target is a producer
    that bypasses the stripe locks, racing the committer's drain swap
    from whatever thread it runs on. ``__init__`` is exempt
    (construction happens-before publication)."""
    out: List[Finding] = []
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        owns_wc = False
        for fn in cls.body:
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and fn.name == "__init__":
                for n in ast.walk(fn):
                    if isinstance(n, ast.Attribute) \
                            and n.attr == "_wc" \
                            and isinstance(n.value, ast.Name) \
                            and n.value.id == "self" \
                            and isinstance(n.ctx, ast.Store):
                        owns_wc = True
        if not owns_wc:
            continue
        for fn in cls.body:
            if not isinstance(fn, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)) \
                    or fn.name == "__init__":
                continue
            for n in ast.walk(fn):
                if not (isinstance(n, ast.Call)
                        and isinstance(n.func, ast.Attribute)
                        and n.func.attr == "append"):
                    continue
                tgt = _dotted_through_subscripts(n.func.value)
                if tgt is not None and tgt.startswith("self._q"):
                    out.append(Finding(
                        rule="combiner-enqueue-unsafe", path=path,
                        line=n.lineno,
                        message=f"{fn.name}() appends to {tgt} "
                                "directly — the pending write queue "
                                "of a combiner-owning class is "
                                "multi-producer, and only the MPSC "
                                "gate (.push) is safe against the "
                                "committer's drain swap; a bare list "
                                "append can drop or double-resolve "
                                "an acked write (docs/SERVING.md)"))
    return out


# --- rule: collective-socket-fallback-silent ---

# Lexical evidence that an except-handler counts the downgrade before
# the round lands on sockets: the fallback counter's name, or a
# fallbacks-stat bump.
_COLLECTIVE_FALLBACK_EVIDENCE = ("collective_fallback", "fallbacks")


def _check_collective_fallback(tree: ast.AST,
                               path: str) -> List[Finding]:
    """In a class that carries a pod-local replica group
    (``self._group`` assigned in ``__init__``), a ``try`` that
    attempts the collective lane (a ``.join()`` call on the group)
    must count the downgrade in every handler that swallows the
    failure — a co-located round silently landing on the socket path
    is a topology regression no dashboard would ever show
    (docs/COLLECTIVE.md). Handlers that re-raise are exempt: loud is
    fine, silent is the finding."""
    out: List[Finding] = []
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        grouped = False
        for fn in cls.body:
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and fn.name == "__init__":
                for n in ast.walk(fn):
                    if isinstance(n, ast.Attribute) \
                            and n.attr == "_group" \
                            and isinstance(n.value, ast.Name) \
                            and n.value.id == "self" \
                            and isinstance(n.ctx, ast.Store):
                        grouped = True
        if not grouped:
            continue
        for fn in cls.body:
            if not isinstance(fn, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                continue
            for tr in ast.walk(fn):
                if not isinstance(tr, ast.Try):
                    continue
                joins = [n for stmt in tr.body for n in ast.walk(stmt)
                         if isinstance(n, ast.Call)
                         and isinstance(n.func, ast.Attribute)
                         and n.func.attr == "join"
                         and "group" in (_dotted(n.func.value) or "")]
                if not joins:
                    continue
                for handler in tr.handlers:
                    body_src = ast.unparse(ast.Module(
                        body=handler.body, type_ignores=[]))
                    if any(isinstance(n, ast.Raise)
                           for stmt in handler.body
                           for n in ast.walk(stmt)):
                        continue
                    if any(ev in body_src
                           for ev in _COLLECTIVE_FALLBACK_EVIDENCE):
                        continue
                    out.append(Finding(
                        rule="collective-socket-fallback-silent",
                        path=path, line=handler.lineno,
                        message=f"{fn.name}() catches a failed "
                                "collective join without counting the "
                                "downgrade — the round lands on the "
                                "socket path invisibly; increment "
                                "crdt_tpu_collective_fallback_total "
                                "(or peer.stats.fallbacks) in the "
                                "handler, or re-raise "
                                "(docs/COLLECTIVE.md)"))
    return out


# --- rule: ack-before-replicate ---


def _check_ack_before_replicate(tree: ast.AST,
                                path: str) -> List[Finding]:
    """In a class that carries a write-concern replicator
    (``self.replicator`` assigned in ``__init__`` — the primary
    serving surface), any method that resolves a client ack future
    (``set_result``) must consult the replicator FIRST: an ack
    resolved lexically before any ``self.replicator`` read (or a
    ``.barrier()`` call) can reach the client before the tick's delta
    is confirmed on any follower, and a primary crash then loses an
    ACKED write — the exact failure write concern exists to exclude
    (docs/REPLICATION.md). Matching the bare ``set_result`` attribute
    (not just calls) also catches the callback-passing form
    (``call_soon_threadsafe(fut.set_result, ...)``)."""
    out: List[Finding] = []
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        replicated = False
        for fn in cls.body:
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and fn.name == "__init__":
                for n in ast.walk(fn):
                    if isinstance(n, ast.Attribute) \
                            and n.attr == "replicator" \
                            and isinstance(n.value, ast.Name) \
                            and n.value.id == "self" \
                            and isinstance(n.ctx, ast.Store):
                        replicated = True
        if not replicated:
            continue
        for fn in cls.body:
            if not isinstance(fn, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)) \
                    or fn.name == "__init__":
                continue
            gate_line = None
            acks: List[ast.Attribute] = []
            for n in ast.walk(fn):
                if isinstance(n, ast.Attribute) \
                        and n.attr == "replicator" \
                        and isinstance(n.value, ast.Name) \
                        and n.value.id == "self" \
                        and isinstance(n.ctx, ast.Load):
                    if gate_line is None or n.lineno < gate_line:
                        gate_line = n.lineno
                if isinstance(n, ast.Call) \
                        and isinstance(n.func, ast.Attribute) \
                        and n.func.attr == "barrier":
                    if gate_line is None or n.lineno < gate_line:
                        gate_line = n.lineno
                if isinstance(n, ast.Attribute) \
                        and n.attr == "set_result" \
                        and isinstance(n.ctx, ast.Load):
                    acks.append(n)
            for ack in acks:
                if gate_line is None or ack.lineno < gate_line:
                    out.append(Finding(
                        rule="ack-before-replicate", path=path,
                        line=ack.lineno,
                        message=f"{fn.name}() resolves a client ack "
                                "(set_result) without first "
                                "consulting self.replicator — the "
                                "ack can land before the "
                                "write-concern barrier confirmed the "
                                "tick on any follower, so a primary "
                                "crash loses an ACKED write "
                                "(docs/REPLICATION.md)"))
    return out


_SCALE_CALLS = {"split_hot", "merge_cold"}


def _ident_contains(name: str, needles: Tuple[str, ...]) -> bool:
    low = name.lower()
    return any(n in low for n in needles)


def _check_scale_fence(tree: ast.AST, path: str) -> List[Finding]:
    """In a class owning a federation handle (``self.fed`` assigned
    in ``__init__`` — the autoscaler shape), any method that fires a
    topology change (a ``split_hot``/``merge_cold`` call) must
    consult BOTH fences lexically first: the table epoch (an
    attribute or name containing ``epoch`` — the stale-observation
    fence) and the in-flight guard (a name containing ``inflight`` /
    ``in_flight``). A decision acted on a stale epoch can retire an
    arc a concurrent change just made hot; a second change fired
    while one is in flight races its ``_control`` hold
    (docs/FEDERATION.md)."""
    out: List[Finding] = []
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        owns_fed = False
        for fn in cls.body:
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and fn.name == "__init__":
                for n in ast.walk(fn):
                    if isinstance(n, ast.Attribute) \
                            and n.attr == "fed" \
                            and isinstance(n.value, ast.Name) \
                            and n.value.id == "self" \
                            and isinstance(n.ctx, ast.Store):
                        owns_fed = True
        if not owns_fed:
            continue
        for fn in cls.body:
            if not isinstance(fn, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)) \
                    or fn.name == "__init__":
                continue
            epoch_line = None
            inflight_line = None
            calls: List[ast.Call] = []
            for n in ast.walk(fn):
                if isinstance(n, ast.Attribute) \
                        and isinstance(n.ctx, ast.Load):
                    if _ident_contains(n.attr, ("epoch",)):
                        if epoch_line is None \
                                or n.lineno < epoch_line:
                            epoch_line = n.lineno
                    if _ident_contains(n.attr,
                                       ("inflight", "in_flight")):
                        if inflight_line is None \
                                or n.lineno < inflight_line:
                            inflight_line = n.lineno
                if isinstance(n, ast.Name) \
                        and isinstance(n.ctx, ast.Load):
                    if _ident_contains(n.id, ("epoch",)):
                        if epoch_line is None \
                                or n.lineno < epoch_line:
                            epoch_line = n.lineno
                    if _ident_contains(n.id,
                                       ("inflight", "in_flight")):
                        if inflight_line is None \
                                or n.lineno < inflight_line:
                            inflight_line = n.lineno
                if isinstance(n, ast.Call) \
                        and isinstance(n.func, ast.Attribute) \
                        and n.func.attr in _SCALE_CALLS:
                    calls.append(n)
            for call in calls:
                missing = []
                if epoch_line is None or call.lineno < epoch_line:
                    missing.append("the table-epoch fence")
                if inflight_line is None \
                        or call.lineno < inflight_line:
                    missing.append("the in-flight guard")
                if missing:
                    out.append(Finding(
                        rule="scale-decision-unfenced", path=path,
                        line=call.lineno,
                        message=f"{fn.name}() invokes "
                                f"{call.func.attr}() without "
                                f"consulting {' or '.join(missing)} "
                                "first — a stale observation can "
                                "retire a fresh arc, and overlapping "
                                "topology changes race each other "
                                "(docs/FEDERATION.md)"))
    return out


def _check_purge_watermark(tree: ast.AST, path: str) -> List[Finding]:
    """Any function invoking ``.gc_purge(...)`` must consult a
    stability watermark lexically at or before the call: a Load of a
    name or attribute containing ``stability`` (the
    `GossipNode.stability_hlc` / `ServeTier.stability_hlc` surfaces,
    or a local bound from them — including the call's own argument).
    Epoch GC against anything weaker than the fleet stability
    watermark physically deletes tombstones some replica still
    needs, and the eventual resurrection is silent data corruption
    (docs/STORAGE.md)."""
    out: List[Finding] = []
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        evidence: Optional[int] = None
        calls: List[ast.Call] = []
        for n in ast.walk(fn):
            if isinstance(n, ast.Attribute) \
                    and isinstance(n.ctx, ast.Load) \
                    and _ident_contains(n.attr, ("stability",)):
                if evidence is None or n.lineno < evidence:
                    evidence = n.lineno
            if isinstance(n, ast.Name) \
                    and isinstance(n.ctx, ast.Load) \
                    and _ident_contains(n.id, ("stability",)):
                if evidence is None or n.lineno < evidence:
                    evidence = n.lineno
            if isinstance(n, ast.Call) \
                    and isinstance(n.func, ast.Attribute) \
                    and n.func.attr == "gc_purge":
                calls.append(n)
        for call in calls:
            if evidence is None or call.lineno < evidence:
                out.append(Finding(
                    rule="purge-watermark-unfenced", path=path,
                    line=call.lineno,
                    message=f"{fn.name}() invokes gc_purge() without "
                            "consulting a stability watermark first "
                            "— purging against anything weaker than "
                            "the fleet stability floor deletes "
                            "tombstones other replicas still need "
                            "(docs/STORAGE.md)"))
    return out


_BUDGET_NEEDLES = ("budget",)


def _hq_tainted(node: ast.AST, tainted: Set[str]) -> bool:
    """Does ``node`` carry ``histogram_quantile`` output — a direct
    call, or a Load of a name the caller already marked tainted?"""
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            name = _dotted(n.func)
            if name and name.rsplit(".", 1)[-1] \
                    == "histogram_quantile":
                return True
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load) \
                and n.id in tainted:
            return True
    return False


def _mentions_budget(node: ast.AST) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Name) \
                and _ident_contains(n.id, _BUDGET_NEEDLES):
            return True
        if isinstance(n, ast.Attribute) \
                and _ident_contains(n.attr, _BUDGET_NEEDLES):
            return True
    return False


def _check_histogram_ceiling_gate(tree: ast.AST,
                                  path: str) -> List[Finding]:
    """Comparing ``histogram_quantile(...)`` output against an SLO
    budget is a verdict built on quantization, not latency: the log2
    histogram answers the bucket CEILING, so a true p99 of 16 ms
    reads as 31.25 ms and any off-power-of-two budget (the 14.6 ms
    serve envelope) either flaps or can never pass. Controller and
    verdict code must gate on the quantile sketch
    (``registry.sketch()`` / ``obs.fleet.fleet_sketch``), which
    answers true quantiles within ~1% relative error; ceilings are
    for display. Taint is tracked per function through assignments
    (including min/max folds), so ``v = histogram_quantile(s, .99);
    ceil = max(ceil, v); if ceil > budget:`` still fires."""
    out: List[Finding] = []
    for fn in _functions(tree):
        tainted: Set[str] = set()
        changed = True
        while changed:
            changed = False
            for n in ast.walk(fn):
                if isinstance(n, ast.Assign):
                    value, targets = n.value, n.targets
                elif isinstance(n, (ast.AugAssign, ast.AnnAssign)):
                    value, targets = n.value, [n.target]
                elif isinstance(n, ast.NamedExpr):
                    value, targets = n.value, [n.target]
                else:
                    continue
                if value is None \
                        or not _hq_tainted(value, tainted):
                    continue
                for t in targets:
                    if isinstance(t, ast.Name) \
                            and t.id not in tainted:
                        tainted.add(t.id)
                        changed = True
        for n in ast.walk(fn):
            if not isinstance(n, ast.Compare):
                continue
            sides = [n.left] + list(n.comparators)
            if any(_hq_tainted(s, tainted) for s in sides) \
                    and any(_mentions_budget(s) for s in sides):
                out.append(Finding(
                    rule="histogram-ceiling-gate", path=path,
                    line=n.lineno,
                    message=f"{fn.name}() gates an SLO budget on "
                            "histogram_quantile output — a log2 "
                            "bucket CEILING, not the latency; an "
                            "off-power-of-two budget flaps or never "
                            "passes. Gate on the quantile sketch "
                            "(obs/sketch.py, ~1% relative error); "
                            "ceilings are display-only"))
    return out


_ALL_CHECKS = (
    _check_sockets,
    _check_lock_discipline,
    _check_wall_clock,
    _check_record_mutation,
    _check_add_batch,
    _check_donated_reuse,
    _check_combiner_bypass,
    _check_pack_path_copies,
    _check_digest_host_hash,
    _check_async_blocking,
    _check_metric_names,
    _check_router_bypass,
    _check_combiner_enqueue,
    _check_collective_fallback,
    _check_ack_before_replicate,
    _check_scale_fence,
    _check_purge_watermark,
    _check_thread_unnamed,
    _check_histogram_ceiling_gate,
)


def lint_source(text: str, path: str) -> List[Finding]:
    """Lint one source text. ``path`` labels findings and is matched
    against suppression comments in ``text``."""
    try:
        tree = ast.parse(text)
    except SyntaxError as e:
        return [Finding(rule="parse-error", path=path,
                        line=e.lineno or 0,
                        message=f"file does not parse: {e.msg}")]
    findings: List[Finding] = []
    for check in _ALL_CHECKS:
        findings.extend(check(tree, path))
    findings = apply_suppressions(findings, parse_suppressions(text),
                                  path)
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))


def lint_file(path: str) -> List[Finding]:
    with open(path, "r", encoding="utf-8") as fh:
        return lint_source(fh.read(), path)


def lint_package(root: str) -> List[Finding]:
    """Lint every .py file under ``root`` (the crdt_tpu_torch
    package)."""
    findings: List[Finding] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__",))
        for name in sorted(filenames):
            if name.endswith(".py"):
                findings.extend(lint_file(os.path.join(dirpath, name)))
    return findings
