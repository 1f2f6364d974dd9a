"""TCP replication endpoints (stdlib sockets, no dependencies).

Port of ``crdt_tpu/net.py``: the same frames, byte for byte, so a
replica of this package and one of the JAX package sync over TCP in
every negotiated mode. The only changes are where the lanes live: the
split wire lanes of a card replica come to the host once, as numpy
arrays in the wire dtypes and shapes (`_pack_split`), and a received
split frame becomes torch tensors on the host, copied once from the
frame, which the replica moves to its device (`_unpack_split`).

The reference deliberately leaves transport to the application — its
example mocks the remote with a function returning a JSON string
(example/crdt_example.dart:21-25). This module is that boundary made
concrete: a :class:`SyncServer` exposes any `Crdt` over one TCP
listener, and :func:`sync_over_tcp` runs the reference's anti-entropy
round against it (full push + inclusive delta pull,
test/map_crdt_test.dart:273-279). Nothing crosses the wire but the
JSON format (crdt_json.dart:8-37), length-prefixed.

Frames (4-byte big-endian length + UTF-8 JSON):

    client -> server  {"op": "push",  "payload": <wire json>}
    server -> client  {"ok": true}
    client -> server  {"op": "delta", "since": <hlc str> | null}
    server -> client  {"payload": <wire json>}
    client -> server  {"op": "bye"}

Dense replicas can additionally sync in the KERNEL WIRE FORM
(`DenseCrdt.export_split_delta` / `merge_split`): the split 32-bit
lanes cross the wire as ONE raw binary frame (~19 B/slot vs ~90 B of
JSON text, no text codec on either side), described by a JSON meta
frame. Both peers must be dense models at the same capacity; the JSON
ops above remain the universal interop path.

    client -> server  {"op": "push_dense", "meta": {...lanes...}}
    client -> server  <raw binary frame: concatenated lanes>
    server -> client  {"ok": true}
    client -> server  {"op": "delta_dense", "since": <hlc str> | null}
    server -> client  {"meta": {...lanes...}}
    server -> client  <raw binary frame>

The sync fast path adds three NEGOTIATED extensions on top — all
opt-in via a ``hello`` handshake, so a pre-hello peer keeps speaking
the exact legacy bytes above (see docs/WIRE.md for the full matrix):

    client -> server  {"op": "hello", "proto": 1, "caps": [...]}
    server -> client  {"ok": true, "proto": 1, "caps": <intersection>}

After a successful hello, every later frame body on the connection
carries ONE leading tag byte (`FrameCodec`): 0x00 raw, 0x01
zlib-compressed (sent only when the "zlib" cap was agreed AND the
body clears a size threshold — tiny control frames never pay the
codec). The "packed" cap unlocks the O(k) incremental columnar ops
(`DenseCrdt.pack_since` / `merge_packed` — ~25 B per MODIFIED row,
vs the dense form's O(capacity) lanes):

    client -> server  {"op": "push_packed", "meta": ..., "node_ids": [...]}
    client -> server  <raw binary frame: packed lanes>
    server -> client  {"ok": true}
    client -> server  {"op": "delta_packed", "since": <hlc str> | null}
    server -> client  {"meta": ..., "node_ids": [...], "k": <rows>}
    server -> client  <raw binary frame>

:class:`PeerConnection` keeps one negotiated session alive across
rounds (connect + hello once, not per round), detecting pre-hello
servers (they answer ``unknown_op`` and hang up) and sticking to the
legacy framing for them.

Error replies carry a structured ``code`` ("merge_rejected",
"delta_failed", "dense_rejected", "packed_rejected", "unknown_op")
plus the server-side exception name/detail. Client-side, the sync
functions raise a split taxonomy: :class:`SyncTransportError` for
link faults (retryable — rounds are idempotent) and
:class:`SyncProtocolError` for peer rejections (fatal; for dense or
packed ops, fall back to the JSON path). The gossip runtime
(`crdt_tpu_torch.gossip`) keys its retry/backoff/breaker and
packed→dense→JSON fallback decisions off exactly this split.

Threading model: replicas are single-threaded state machines (same
contract as the reference's isolate model — see SqliteCrdt's notes).
The server serializes ALL replica access through :attr:`SyncServer.lock`
— it accepts up to ``max_conns`` concurrent connections (pooled
gossip peers park sessions between rounds), each on its own handler
thread, but requests still execute one at a time under the lock. An
application that also writes locally from another thread must take
the same lock around its own operations. To serve a `SqliteCrdt`,
construct it with ``check_same_thread=False`` (sqlite3's own thread
guard; the server's lock provides the actual serialization).
"""

from __future__ import annotations

import json
import socket
import struct
import threading
import zlib
from typing import Any, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from .crdt import Crdt
from .hlc import Hlc
from .ops.split import NarrowSplitChangeset, SplitChangeset
from .utils.concurrency import make_lock


# A 1M-record full-state payload is ~100 MB; anything near this cap
# is a corrupt stream or a peer speaking another protocol — reject
# before allocating, never trust a 4-byte prefix with 4 GiB.
MAX_FRAME_BYTES = 1 << 30


class SyncError(ConnectionError):
    """A sync round failed. Subclasses split the taxonomy the gossip
    runtime retries on: transport faults (retryable — the lattice join
    is idempotent, replaying a round is always safe) vs. protocol
    rejections (fatal — the peer understood the round and refused it,
    so replaying the same bytes cannot succeed). Kept a
    `ConnectionError` so pre-taxonomy callers' handlers still fire."""


class SyncTransportError(SyncError):
    """The LINK failed: refused/reset connection, timeout, EOF
    mid-frame, framing violation, or a reply desynchronized from the
    request stream. Nothing says the peer rejected the round — retry
    with backoff."""


class SyncRedirectError(SyncTransportError):
    """The PEER is not the slot's owner: a federated tier answered a
    keyspace op with ``moved``, naming the owning tier's address and
    the routing epoch it routed by (docs/FEDERATION.md). A transport
    subclass on purpose — like ``busy``, a redirect is
    retryable-by-construction (refetch the routing table, replay at
    the owner; the lattice join is idempotent) and must NEVER
    downgrade the session to the legacy protocol or mark the peer
    rejected."""

    def __init__(self, message: str, owner: Optional[str] = None,
                 epoch: Optional[int] = None):
        super().__init__(message)
        self.owner = owner
        self.epoch = epoch


class SyncProtocolError(SyncError):
    """The PEER rejected the round: a clock guard tripped, the op is
    unknown, or the dense wire form is unsupported/incompatible.
    ``code`` is the server's structured reason (see
    :class:`SyncServer`), ``error``/``detail`` the exception it maps
    from. Do not retry; for dense ops, fall back to the universal
    JSON path."""

    def __init__(self, message: str, code: str = "rejected",
                 error: Optional[str] = None,
                 detail: Optional[str] = None):
        super().__init__(message)
        self.code = code
        self.error = error
        self.detail = detail

    @classmethod
    def from_reply(cls, what: str, reply: Any) -> "SyncProtocolError":
        """Build from a server error reply, preserving the legacy
        message shape (tests match on 'rejected: ...ExceptionName')."""
        code, error, detail = "rejected", None, None
        if isinstance(reply, dict):
            code = reply.get("code", code)
            error = reply.get("error")
            detail = reply.get("detail")
        return cls(f"{what}: {reply!r}", code=code, error=error,
                   detail=detail)


class WireTally:
    """Mutable wire byte counters (frame headers included) the sync
    functions fill when given one — per-round for the gossip runtime's
    per-peer ``bytes_sent``/``bytes_received`` accounting, cumulative
    for the endpoint-lifetime tallies `SyncServer` and `GossipNode`
    attach to the metrics registry (the ``__weakref__`` slot exists so
    the registry can hold them weakly). ``z_raw``/``z_wire`` count the
    before/after bytes of every body `FrameCodec` actually compressed,
    so ``z_ratio`` is the achieved compression ratio (1.0 when nothing
    was compressed)."""

    __slots__ = ("sent", "received", "z_raw", "z_wire", "__weakref__")

    def __init__(self) -> None:
        self.sent = 0
        self.received = 0
        self.z_raw = 0
        self.z_wire = 0

    @property
    def z_ratio(self) -> float:
        return self.z_raw / self.z_wire if self.z_wire else 1.0

    def as_dict(self) -> dict:
        return {"sent": self.sent, "received": self.received,
                "z_raw": self.z_raw, "z_wire": self.z_wire,
                "z_ratio": round(self.z_ratio, 4)}


class FrameCodec:
    """Per-connection frame body transform, active only AFTER a
    successful ``hello``: every body gets one leading tag byte —
    ``0x00`` raw, ``0x01`` zlib. Compression is sent only when enabled
    (both sides advertised "zlib") and the body clears
    ``min_compress_bytes`` — a 20-byte control frame costs more as a
    zlib stream than as itself. Decoding always accepts BOTH tags
    (negotiating the cap governs what a peer may *send*, not what it
    must *understand*), with the inflated size capped at
    ``MAX_FRAME_BYTES`` so a zlib bomb rejects before allocating."""

    TAG_RAW = b"\x00"
    TAG_ZLIB = b"\x01"

    def __init__(self, compress: bool = False, level: int = 1,
                 min_compress_bytes: int = 512):
        self.compress = compress
        self.level = level
        self.min_compress_bytes = min_compress_bytes

    def encode(self, bufs: Sequence, tally: Optional[WireTally] = None
               ) -> list:
        """Tag (and maybe compress) a body given as buffer pieces;
        returns the pieces to ship. Incompressible bodies ship raw —
        the tag byte means the receiver never guesses. Raw pieces pass
        through untouched (zero-copy); zlib consumes each piece via
        the buffer protocol (no ``bytes()`` staging copy) and the
        compressed bytes it does materialize are counted in
        ``crdt_tpu_pack_copy_bytes_total{stage="encode_zlib"}``."""
        total = sum(_buf_nbytes(b) for b in bufs)
        if self.compress and total >= self.min_compress_bytes:
            co = zlib.compressobj(self.level)
            pieces = [co.compress(b) for b in bufs]
            pieces.append(co.flush())
            z_total = sum(len(p) for p in pieces)
            if z_total < total:
                if tally is not None:
                    tally.z_raw += total
                    tally.z_wire += z_total
                from .obs.registry import default_registry
                default_registry().counter(
                    "crdt_tpu_pack_copy_bytes_total",
                    "bytes copied between pack and frame (zero on the "
                    "arena fast path)").inc(z_total,
                                            stage="encode_zlib")
                return [self.TAG_ZLIB] + pieces
        return [self.TAG_RAW] + list(bufs)

    def decode(self, body: bytes) -> bytes:
        if not body:
            raise ValueError("tagged frame with empty body")
        tag, body = body[:1], body[1:]
        if tag == self.TAG_RAW:
            return body
        if tag == self.TAG_ZLIB:
            do = zlib.decompressobj()
            try:
                out = do.decompress(body, MAX_FRAME_BYTES)
            except zlib.error as e:
                raise ValueError(f"corrupt compressed frame: {e}") from e
            if do.unconsumed_tail or not do.eof or do.unused_data:
                raise ValueError(
                    "compressed frame inflates past MAX_FRAME_BYTES, "
                    "is truncated, or has trailing bytes")
            return out
        raise ValueError(f"unknown frame tag {tag!r}")


def send_frame(sock: socket.socket, obj: Any,
               tally: Optional[WireTally] = None,
               codec: Optional[FrameCodec] = None) -> None:
    """One JSON frame — the raw framing plus a dumps. ``codec`` (a
    negotiated connection) tags/compresses the body; None keeps the
    legacy untagged bytes."""
    send_bytes_frame(sock, [json.dumps(obj).encode()], tally, codec)


def recv_frame(sock: socket.socket,
               deadline: Optional[float] = None,
               tally: Optional[WireTally] = None,
               codec: Optional[FrameCodec] = None) -> Optional[Any]:
    """Receive one JSON frame; ``deadline`` (a ``time.monotonic()``
    value) bounds the WHOLE frame, not just each chunk — a peer
    trickling bytes inside the per-recv socket timeout cannot stretch
    past it."""
    body = recv_bytes_frame(sock, deadline, tally, codec)
    return None if body is None else json.loads(body)


def _recv_exact(sock: socket.socket, n: int,
                deadline: Optional[float] = None) -> Optional[bytes]:
    import time as _time
    buf = bytearray()
    while len(buf) < n:
        if deadline is not None:
            remaining = deadline - _time.monotonic()
            if remaining <= 0:
                raise socket.timeout("connection deadline exceeded")
            base = sock.gettimeout()
            sock.settimeout(remaining if base is None
                            else min(base, remaining))
            try:
                chunk = sock.recv(min(n - len(buf), 1 << 20))
            finally:
                sock.settimeout(base)
        else:
            chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            return None
        buf += chunk
    return bytes(buf)


def _buf_nbytes(b) -> int:
    """Byte length of any buffer piece. ``len()`` of a
    multi-dimensional memoryview counts FIRST-DIMENSION elements, not
    bytes (the `_pack_split` flat-cast trap) — ``nbytes`` never
    lies, whatever the shape or item size."""
    if isinstance(b, (bytes, bytearray)):
        return len(b)
    return b.nbytes if isinstance(b, memoryview) else memoryview(b).nbytes


def _flat_views(bufs) -> list:
    """Normalize buffer pieces to flat byte memoryviews — what both
    the length prefix and the vectored send below need. Flattening a
    C-contiguous view is a cast, not a copy."""
    views = []
    for b in bufs:
        v = b if isinstance(b, memoryview) else memoryview(b)
        if v.ndim != 1 or v.format != "B":
            v = v.cast("B")
        views.append(v)
    return views


def _sendmsg_all(sock: socket.socket, views: list) -> None:
    """Vectored gather-send of every view with partial-send advance —
    ONE syscall per full frame in the common case, against N
    ``sendall`` calls (and zero concatenation copies either way)."""
    views = [v for v in views if v.nbytes]
    i = 0
    while i < len(views):
        sent = sock.sendmsg(views[i:])
        while sent > 0:
            n = views[i].nbytes
            if sent >= n:
                sent -= n
                i += 1
            else:
                views[i] = views[i][sent:]
                sent = 0


def send_bytes_frame(sock: socket.socket, bufs,
                     tally: Optional[WireTally] = None,
                     codec: Optional[FrameCodec] = None) -> None:
    """One length-prefixed RAW frame from a list of buffers — sent
    piecewise, never concatenated (a 100 MB delta must not allocate a
    second copy). The header and every body piece go out in one
    vectored ``socket.sendmsg`` where the platform has it, so a
    zero-copy pack's arena views reach the kernel directly."""
    if codec is not None:
        bufs = codec.encode(bufs, tally)
    views = _flat_views(bufs)
    total = sum(v.nbytes for v in views)
    if total > MAX_FRAME_BYTES:
        raise ValueError(f"frame of {total} bytes exceeds "
                         f"MAX_FRAME_BYTES ({MAX_FRAME_BYTES})")
    header = struct.pack(">I", total)
    if hasattr(sock, "sendmsg"):
        _sendmsg_all(sock, [memoryview(header)] + views)
    else:                                   # pragma: no cover
        sock.sendall(header)
        for v in views:
            sock.sendall(v)
    if tally is not None:
        tally.sent += 4 + total


def recv_bytes_frame(sock: socket.socket,
                     deadline: Optional[float] = None,
                     tally: Optional[WireTally] = None,
                     codec: Optional[FrameCodec] = None
                     ) -> Optional[bytes]:
    """Receive one RAW frame (no JSON decode)."""
    head = _recv_exact(sock, 4, deadline)
    if head is None:
        return None
    (n,) = struct.unpack(">I", head)
    if n > MAX_FRAME_BYTES:
        raise ValueError(f"peer announced a {n}-byte frame (cap "
                         f"{MAX_FRAME_BYTES}); corrupt stream?")
    body = _recv_exact(sock, n, deadline)
    if body is not None and tally is not None:
        tally.received += 4 + n
    if body is not None and codec is not None:
        body = codec.decode(body)
    return body


# Exact lane dtypes per split form — anything else from a peer is a
# protocol violation (np.dtype on arbitrary strings is not a safe
# parser for untrusted input, and a mismatched-but-allowed dtype would
# reinterpret bytes instead of rejecting the frame).
_SPLIT_LANE_DTYPES = {
    "split": ("int32", "uint32", "int16", "int32", "uint32", "int8"),
    "narrow": ("int32", "uint32", "int16", "int32", "int8"),
}


def _host_lane(lane) -> np.ndarray:
    """One split lane as a C-contiguous host array in its wire dtype: a
    torch tensor (on the card or the host) comes over in one copy."""
    if isinstance(lane, torch.Tensor):
        return np.ascontiguousarray(lane.cpu().numpy())
    return np.ascontiguousarray(np.asarray(lane))


def _pack_split(scs):
    """(meta, bufs) for a split changeset: lane descriptors + host
    buffers in field order. The lanes keep the JAX package's dtypes
    and shapes (the pre-tiled 3-D shape included), so the meta frame
    is the same JSON."""
    # Device lanes must land on the host before framing: this copy is
    # the one the wire form needs.
    arrs = [_host_lane(lane) for lane in scs]
    meta = {
        "form": "narrow" if "val" in scs._fields else "split",
        "lanes": [[f, str(a.dtype), list(a.shape)]
                  for f, a in zip(scs._fields, arrs)],
    }
    # The framing sizes buffers by nbytes (`_buf_nbytes`), so even a
    # multi-dimensional view could not make the length prefix lie.
    return meta, [a.data.cast("B") for a in arrs]


def _unpack_split(meta, blob: bytes):
    """Validate + reconstruct the split changeset a peer announced, as
    host torch tensors. Raises ValueError on any structural violation
    (wrong fields, disallowed dtypes, size mismatch) BEFORE touching
    the replica. Each lane is copied once out of the frame (a tensor
    over the received bytes would be read-only), and the replica's
    ``merge_split`` makes one host-to-device copy per lane."""
    if not isinstance(meta, dict):
        raise ValueError("bad dense meta")
    cls = {"split": SplitChangeset,
           "narrow": NarrowSplitChangeset}.get(meta.get("form"))
    lanes_meta = meta.get("lanes")
    if cls is None or not isinstance(lanes_meta, list):
        raise ValueError("bad dense meta")
    if [l[0] for l in lanes_meta] != list(cls._fields):
        raise ValueError("dense lane fields mismatch")
    expected = _SPLIT_LANE_DTYPES[meta["form"]]
    lanes = []
    off = 0
    shape0 = None
    for (_, dt, shape), want in zip(lanes_meta, expected):
        if dt != want:
            raise ValueError(f"lane dtype {dt!r} != expected {want!r}")
        shape = tuple(int(s) for s in shape)
        # 2-D (r, n) or pre-tiled 3-D only — the shapes every kernel
        # wrapper accepts; a 1-D lane would fail deep inside the merge
        # instead of here.
        if len(shape) not in (2, 3) or any(s <= 0 for s in shape):
            raise ValueError("bad lane shape")
        if shape0 is None:
            shape0 = shape
        elif shape != shape0:
            raise ValueError("inconsistent lane shapes")
        count = 1
        for s in shape:
            count *= s
        a = np.frombuffer(blob, np.dtype(dt), count=count, offset=off)
        off += a.nbytes
        lanes.append(a.reshape(shape))
    if off != len(blob):
        raise ValueError(f"dense frame size mismatch: lanes describe "
                         f"{off} bytes, frame holds {len(blob)}")
    return cls(*(torch.from_numpy(a.copy()) for a in lanes))


# --- binary client op lane (docs/WIRE.md) ---
#
# The `binop` hello cap replaces per-op framed JSON on the client hot
# path with fixed little-endian columnar frames: one request carries
# up to 65535 put/delete/get ops as packed opcode/slot/value rows, one
# reply answers every op with a status byte (plus an optional value
# lane and a JSON detail tail for the non-OK minority). Both sides of
# the wire — the serve tier's decoder and every client encoder — live
# here so there is exactly ONE framing stack, same as the peer wire.
#
# Request body (after the usual 4-byte frame header + codec tag):
#   <BBHI  magic=0xB1, version=1, n_ops, epoch+1 (0 = no epoch)
#   u8[n]  opcodes (0=put, 1=delete, 2=get)
#   <u4[n] slots
#   <i8[n] values (ignored for delete/get rows)
# Reply body:
#   <BBHI  magic=0xB2, flags (bit0 = value lane), n_ops, detail_len
#   u8[n]  statuses (0=OK, 1=OK_NULL, 2=WRITE_REJECTED, 3=BUSY,
#          4=MOVED)
#   <i8[n] values, present iff flags bit0 (get replies; 0 elsewhere)
#   bytes  detail_len of JSON: a list of dicts carrying the non-OK
#          minority's codes/errors ("i" = op index; entries without
#          "i" apply frame-wide, e.g. a busy tick)
#
# A JSON op frame starts with '{' (0x7B) and a binop frame with 0xB1,
# so a negotiated session dispatches on the first body byte with no
# ambiguity. Malformed FRAMES (bad magic/version/size/opcode) raise
# ValueError — a protocol violation that hangs up the session, like
# any other framing fault; a bad op INSIDE a well-formed frame is a
# per-op status, never a hangup and never the batch's problem.

BINOP_MAGIC = 0xB1
BINOP_REPLY_MAGIC = 0xB2
BINOP_VERSION = 1
BINOP_MAX_OPS = 0xFFFF
BINOP_PUT, BINOP_DELETE, BINOP_GET = 0, 1, 2
(BINOP_ST_OK, BINOP_ST_OK_NULL, BINOP_ST_REJECTED,
 BINOP_ST_BUSY, BINOP_ST_MOVED) = range(5)
_BINOP_HEAD = struct.Struct("<BBHI")
_BINOP_REPLY_HEAD = struct.Struct("<BBHI")
_BINOP_ROW_BYTES = 1 + 4 + 8


def encode_binop_request(opcodes, slots, values,
                         epoch: Optional[int] = None) -> list:
    """Buffer pieces for one binary op frame, ready for
    `send_bytes_frame`/`frame_pieces` — the columnar lanes are handed
    to the transport as memoryviews, never concatenated."""
    ops = np.ascontiguousarray(opcodes, np.uint8)
    sl = np.ascontiguousarray(slots, np.uint32)
    va = np.ascontiguousarray(values, np.int64)
    n = len(ops)
    if not 1 <= n <= BINOP_MAX_OPS:
        raise ValueError(f"binop batch of {n} ops outside "
                         f"[1, {BINOP_MAX_OPS}]")
    if len(sl) != n or len(va) != n:
        raise ValueError("binop lanes must share one length")
    if int(ops.max()) > BINOP_GET:
        raise ValueError("unknown binop opcode")
    head = _BINOP_HEAD.pack(BINOP_MAGIC, BINOP_VERSION, n,
                            0 if epoch is None else int(epoch) + 1)
    return [head, ops.data, sl.data.cast("B"), va.data.cast("B")]


def decode_binop_request(body):
    """Validate + decode one binary op frame into
    ``(opcodes, slots, values, epoch)``. The lanes are zero-copy
    `np.frombuffer` views into ``body`` (uint8/uint32/int64) — the
    serve tier hands the write rows straight to the combiner's
    columnar staging. Raises ValueError on any structural violation
    BEFORE touching the replica, exactly like `_unpack_split`."""
    if len(body) < _BINOP_HEAD.size:
        raise ValueError("binop frame shorter than its header")
    magic, version, n, epoch1 = _BINOP_HEAD.unpack_from(body)
    if magic != BINOP_MAGIC:
        raise ValueError(f"bad binop magic 0x{magic:02x}")
    if version != BINOP_VERSION:
        raise ValueError(f"unsupported binop version {version}")
    if n < 1:
        raise ValueError("binop frame with zero ops")
    want = _BINOP_HEAD.size + n * _BINOP_ROW_BYTES
    if len(body) != want:
        raise ValueError(f"binop frame holds {len(body)} bytes; "
                         f"{n} ops need exactly {want}")
    off = _BINOP_HEAD.size
    ops = np.frombuffer(body, np.uint8, count=n, offset=off)
    off += n
    slots = np.frombuffer(body, "<u4", count=n, offset=off)
    off += 4 * n
    values = np.frombuffer(body, "<i8", count=n, offset=off)
    if int(ops.max()) > BINOP_GET:
        raise ValueError("unknown binop opcode")
    return ops, slots, values, (None if epoch1 == 0 else epoch1 - 1)


def encode_binop_reply(status, values=None, details=None) -> list:
    """Buffer pieces for one binop reply frame. ``values`` (int64 per
    op) is included iff given; ``details`` is the non-OK minority's
    JSON tail (empty list/None elides it)."""
    st = np.ascontiguousarray(status, np.uint8)
    n = len(st)
    if not 1 <= n <= BINOP_MAX_OPS:
        raise ValueError(f"binop reply of {n} ops outside "
                         f"[1, {BINOP_MAX_OPS}]")
    det = json.dumps(details).encode() if details else b""
    flags = 0 if values is None else 1
    head = _BINOP_REPLY_HEAD.pack(BINOP_REPLY_MAGIC, flags, n,
                                  len(det))
    bufs = [head, st.data]
    if values is not None:
        va = np.ascontiguousarray(values, np.int64)
        if len(va) != n:
            raise ValueError("binop reply lanes must share one length")
        bufs.append(va.data.cast("B"))
    if det:
        bufs.append(det)
    return bufs


def decode_binop_reply(body):
    """Validate + decode one binop reply into
    ``(statuses, values_or_None, details)`` — status/value lanes as
    zero-copy views, details as the parsed JSON tail (always a
    list)."""
    if len(body) < _BINOP_REPLY_HEAD.size:
        raise ValueError("binop reply shorter than its header")
    magic, flags, n, det_len = _BINOP_REPLY_HEAD.unpack_from(body)
    if magic != BINOP_REPLY_MAGIC:
        raise ValueError(f"bad binop reply magic 0x{magic:02x}")
    if n < 1:
        raise ValueError("binop reply with zero ops")
    want = (_BINOP_REPLY_HEAD.size + n
            + (8 * n if flags & 1 else 0) + det_len)
    if len(body) != want:
        raise ValueError(f"binop reply holds {len(body)} bytes; "
                         f"header describes {want}")
    off = _BINOP_REPLY_HEAD.size
    status = np.frombuffer(body, np.uint8, count=n, offset=off)
    off += n
    values = None
    if flags & 1:
        values = np.frombuffer(body, "<i8", count=n, offset=off)
        off += 8 * n
    details = json.loads(body[off:]) if det_len else []
    if not isinstance(details, list):
        raise ValueError("binop reply details must be a list")
    return status, values, details


def binop_round(sock: socket.socket, opcodes, slots, values,
                epoch: Optional[int] = None,
                deadline: Optional[float] = None,
                tally: Optional[WireTally] = None,
                codec: Optional[FrameCodec] = None):
    """One batched binary round over a negotiated socket: N ops out,
    N statuses back in a single frame each way — the client half of
    the lane a serve tier advertises with the ``binop`` hello cap."""
    send_bytes_frame(sock, encode_binop_request(opcodes, slots,
                                                values, epoch),
                     tally, codec)
    body = recv_bytes_frame(sock, deadline, tally, codec)
    if body is None:
        raise SyncTransportError("peer closed during binop round")
    return decode_binop_reply(body)


class SyncServer:
    """Serve a replica's merge/delta surface over TCP.

    Up to ``max_conns`` connections are served concurrently (each on
    its own handler thread), so pooled gossip peers can park keep-alive
    sessions between rounds without starving one another; every
    request still holds :attr:`lock` while it touches the replica, so
    replica access stays strictly serialized. A slow peer delays —
    and without bounds would starve — everyone contending for that
    lock, so each connection is capped: at most ``max_ops`` framed
    requests and ``conn_deadline`` seconds, after which it is dropped
    (a well-behaved anti-entropy round is 3 frames and well under a
    second); connections past ``max_conns`` are refused at accept.
    The endpoint still assumes a trusted network: there is no
    authentication and a peer can push arbitrary records.

    >>> server = SyncServer(crdt)          # port 0 = ephemeral
    >>> server.start()
    >>> ... sync_over_tcp(other, "host", server.port) ...
    >>> server.stop()
    """

    # crdtlint lock-discipline contract: every replica access holds
    # the replica lock (enforced by crdt_tpu.analysis.host_lint).
    _CRDTLINT_GUARDED = {"lock": ("crdt",)}

    def __init__(self, crdt: Crdt, host: str = "127.0.0.1",
                 port: int = 0,
                 key_encoder=None, value_encoder=None,
                 key_decoder=None, value_decoder=None,
                 max_ops: int = 1000, conn_deadline: float = 300.0,
                 io_timeout: float = 30.0, max_conns: int = 8):
        self.crdt = crdt
        self.lock = make_lock("SyncServer.lock", 42)
        self._max_ops = max_ops
        self._conn_deadline = conn_deadline
        # Per-recv socket timeout AND the bound on a push_dense/
        # push_packed continuation frame: a client that announces a
        # binary frame and never sends it holds its handler slot for
        # at most this long, not until conn_deadline.
        self._io_timeout = io_timeout
        self._max_conns = max_conns
        # codec passthrough, mirroring sync.sync_json: replicas with
        # custom-typed keys/values need the same coders over TCP
        self._kenc, self._venc = key_encoder, value_encoder
        self._kdec, self._vdec = key_decoder, value_decoder
        # Endpoint-lifetime wire byte tally, registered with the
        # process metrics registry (weakly — a test's short-lived
        # server vanishes from snapshots with the server). Touched by
        # the single handler thread only; snapshot reads are racy-but-
        # atomic int reads.
        from .obs.registry import default_registry
        self.tally = WireTally()
        default_registry().attach("wire", self.tally, replace=True,
                                  role="server", node=str(crdt.node_id))
        # Optional hook merged into the `metrics` op reply — a
        # `GossipNode` installs its lag snapshot here so the wire op
        # answers "how far behind is replica B?" without the server
        # knowing about gossip state.
        self.metrics_extra = None
        # Live connections + their handler threads, guarded by
        # _conns_lock: stop() shuts every socket down so a handler
        # blocked in a 30 s recv exits promptly.
        self._conns_lock = make_lock("SyncServer._conns_lock", 44)
        self._conns: set = set()
        self._handlers: set = set()
        self._lsock = socket.create_server((host, port))
        self._lsock.settimeout(0.2)  # poll the stop flag
        self.host, self.port = self._lsock.getsockname()[:2]
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "SyncServer":
        self._thread = threading.Thread(
            target=self._serve, daemon=True,
            name=f"sync-accept-{self.port}")
        self._thread.start()
        return self

    def _shutdown_conns(self) -> None:
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    def stop(self) -> None:
        """Stop serving and wait for quiescence: every live
        connection (a handler may be blocked in a 30 s recv) is shut
        down so its handler thread exits promptly — after stop()
        returns, no server-side thread touches the replica again."""
        self._stop.set()
        import time as _time
        deadline = _time.monotonic() + 60

        def _join(thread) -> None:
            # repeatedly shut down whatever connections are live: a
            # conn accepted concurrently with stop() would otherwise
            # slip past a single read and idle out a 30 s recv
            while thread.is_alive():
                self._shutdown_conns()
                thread.join(timeout=0.2)
                if _time.monotonic() > deadline:
                    raise RuntimeError(
                        "SyncServer thread failed to stop; the "
                        "replica may still be accessed — do not "
                        "reuse it")

        if self._thread is not None:
            _join(self._thread)
        while True:
            with self._conns_lock:
                handler = next((t for t in self._handlers
                                if t.is_alive()), None)
            if handler is None:
                break
            _join(handler)
        self._lsock.close()

    def __enter__(self) -> "SyncServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._lsock.accept()
            except socket.timeout:
                continue
            except OSError:
                if self._stop.is_set():
                    return
                # transient accept failure (e.g. EMFILE): the
                # listener is still bound — keep serving
                self._stop.wait(0.05)
                continue
            with self._conns_lock:
                self._handlers = {t for t in self._handlers
                                  if t.is_alive()}
                full = len(self._conns) >= self._max_conns
                if not full:
                    self._conns.add(conn)
            if full or self._stop.is_set():
                # Over capacity (or stopping): say WHY before hanging
                # up. The refusal predates any hello, so it crosses in
                # the untagged framing every client generation reads.
                # "busy" is deliberately absent from the gossip
                # fallback code sets — it is a retryable admission
                # signal, not a capability verdict, so the client
                # backs off and redials instead of downgrading modes
                # or marking the session legacy.
                try:
                    conn.settimeout(self._io_timeout)
                    if full and not self._stop.is_set():
                        from .obs.registry import default_registry
                        with self.lock:
                            node = str(self.crdt.node_id)
                        default_registry().counter(
                            "crdt_tpu_net_busy_refusals_total",
                            "connections refused at accept with the "
                            "busy code (max_conns reached)"
                        ).inc(node=node)
                        send_frame(conn, {
                            "ok": False, "code": "busy",
                            "error": "server at capacity "
                                     f"(max_conns={self._max_conns})"},
                            self.tally)
                except (OSError, ValueError):
                    pass
                try:
                    conn.close()
                except OSError:
                    pass
                continue
            t = threading.Thread(
                target=self._conn_main, args=(conn,), daemon=True,
                name=f"sync-conn-{self.port}-fd{conn.fileno()}")
            with self._conns_lock:
                self._handlers.add(t)
            t.start()

    def _conn_main(self, conn: socket.socket) -> None:
        try:
            with conn:
                self._handle(conn)
        except Exception:
            # one misbehaving peer must never take the server down
            # for everyone else
            pass
        finally:
            with self._conns_lock:
                self._conns.discard(conn)

    def _caps(self) -> set:
        """Capabilities this endpoint may advertise in a hello reply.
        "dense" is deliberately NOT negotiated: dense/JSON discovery
        stays rejection-based (`dense_rejected` → sticky downgrade),
        the contract the gossip fallback counters are pinned to."""
        caps = {"zlib"}
        with self.lock:
            packed = (hasattr(self.crdt, "pack_since")
                      and hasattr(self.crdt, "merge_packed"))
            # "semantics" gates the packed frame's 6th (sem tag) lane
            # (docs/TYPES.md): only a replica that can VALIDATE tags
            # may receive them, so the cap requires the typed surface,
            # not just packed framing.
            semantics = packed and hasattr(self.crdt, "set_semantics")
            # "merkle" gates the digest/digest_resp walk ops
            # (docs/ANTIENTROPY.md): it implies the range pack, so it
            # requires the full packed surface too.
            merkle = packed and callable(
                getattr(self.crdt, "digest_tree", None))
        if packed:
            caps.add("packed")
        if semantics:
            caps.add("semantics")
        if merkle:
            caps.add("merkle")
        # "trace" is pure metadata: when both ends agree, sync frames
        # may carry a compact trace context ({rid, origin, hlc_lo,
        # hlc_hi}) so initiator sync spans and responder merge spans
        # correlate in the JSONL sink (docs/OBSERVABILITY.md). Needs
        # no replica surface, so it is always advertised.
        caps.add("trace")
        # "sketch" gates the metrics op's "sketches" section (obs/
        # sketch.py quantile payloads): a session that never agreed
        # gets the pre-sketch metrics reply byte-identically, so old
        # pollers keep parsing exactly what they always parsed.
        caps.add("sketch")
        return caps

    def _handle(self, conn: socket.socket) -> None:
        conn.settimeout(self._io_timeout)
        import time as _time

        from .obs.trace import tracer as _tracer
        ring = _tracer()
        deadline = _time.monotonic() + self._conn_deadline
        ops = 0
        codec: Optional[FrameCodec] = None
        sem_ok = False   # this session negotiated the sem tag lane
        trace_ok = False  # this session negotiated trace piggyback
        sketch_ok = False  # this session negotiated sketch payloads
        while not self._stop.is_set():
            sent0, received0 = self.tally.sent, self.tally.received
            try:
                msg = recv_frame(conn, deadline=deadline,
                                 tally=self.tally, codec=codec)
            except (socket.timeout, OSError, ValueError):
                return
            if msg is None or not isinstance(msg, dict) \
                    or msg.get("op") == "bye":
                return
            # Bound what one connection can monopolize (every request
            # contends for the replica lock). Checked after recv so a
            # frame landing past the deadline is dropped, not granted
            # one more op.
            ops += 1
            if ops > self._max_ops or _time.monotonic() > deadline:
                return
            op = msg.get("op")
            tctx = msg.get("trace") if trace_ok else None
            if not isinstance(tctx, dict):
                tctx = None
            if op == "hello":
                want = msg.get("caps")
                want = set(want) if isinstance(want, list) else set()
                agreed = sorted(want & self._caps())
                if not self._reply(conn, {"ok": True, "proto": 1,
                                          "caps": agreed},
                                   self.tally, codec):
                    return
                # The reply itself crossed untagged; everything AFTER
                # it speaks the tagged framing.
                codec = FrameCodec(compress="zlib" in agreed)
                sem_ok = "semantics" in agreed
                trace_ok = "trace" in agreed
                sketch_ok = "sketch" in agreed
            elif op == "push":
                try:
                    with _recv_span("push", tctx):
                        with self.lock:
                            self.crdt.merge_json(
                                msg["payload"],
                                key_decoder=self._kdec,
                                value_decoder=self._vdec)
                except Exception as e:
                    # clock guards (duplicate node, drift) reject the
                    # push; the server survives and tells the client
                    self._reply(conn, {"ok": False,
                                       "code": "merge_rejected",
                                       "error": type(e).__name__,
                                       "detail": str(e)},
                                self.tally, codec)
                    return
                if not self._reply(conn, {"ok": True}, self.tally,
                                   codec):
                    return
            elif op == "delta":
                try:
                    since = msg.get("since")
                    with self.lock:
                        payload = self.crdt.to_json(
                            modified_since=None if since is None
                            else Hlc.parse(since),
                            key_encoder=self._kenc,
                            value_encoder=self._venc)
                except Exception as e:
                    # e.g. an unparseable `since` watermark
                    self._reply(conn, {"code": "delta_failed",
                                       "error": type(e).__name__,
                                       "detail": str(e)},
                                self.tally, codec)
                    return
                if not self._reply(conn, {"payload": payload},
                                   self.tally, codec):
                    return
            elif op == "push_dense":
                # The meta frame is followed by ONE raw binary frame,
                # bounded by io_timeout (not the whole conn_deadline):
                # a peer that announces a frame and goes silent must
                # not hold its handler slot for minutes.
                try:
                    blob = recv_bytes_frame(
                        conn, deadline=min(
                            deadline,
                            _time.monotonic() + self._io_timeout),
                        tally=self.tally, codec=codec)
                except (socket.timeout, OSError, ValueError):
                    return
                if blob is None:
                    return
                try:
                    scs = _unpack_split(msg.get("meta"), blob)
                    ids = msg.get("node_ids")
                    if not isinstance(ids, list) or not ids:
                        raise ValueError("push_dense without node_ids")
                    with _recv_span("push_dense", tctx):
                        with self.lock:
                            # AttributeError on non-dense replicas
                            # reports back like any other rejection.
                            self.crdt.merge_split(scs, ids)
                except Exception as e:
                    self._reply(conn, {"ok": False,
                                       "code": "dense_rejected",
                                       "error": type(e).__name__,
                                       "detail": str(e)},
                                self.tally, codec)
                    return
                if not self._reply(conn, {"ok": True}, self.tally,
                                   codec):
                    return
            elif op == "delta_dense":
                try:
                    since = msg.get("since")
                    with self.lock:
                        scs, ids = self.crdt.export_split_delta(
                            None if since is None else Hlc.parse(since))
                    meta, bufs = _pack_split(scs)
                    meta_msg = {"meta": meta, "node_ids": list(ids)}
                except Exception as e:
                    self._reply(conn, {"code": "dense_rejected",
                                       "error": type(e).__name__,
                                       "detail": str(e)},
                                self.tally, codec)
                    return
                if not self._reply(conn, meta_msg, self.tally, codec):
                    return
                try:
                    send_bytes_frame(conn, bufs, self.tally, codec)
                except (OSError, ValueError):
                    return
            elif op == "push_packed":
                # Same continuation-frame shape as push_dense, but the
                # lanes are the O(k) modified-rows form
                # (`ops.packing.unpack_rows` / `merge_packed`).
                try:
                    blob = recv_bytes_frame(
                        conn, deadline=min(
                            deadline,
                            _time.monotonic() + self._io_timeout),
                        tally=self.tally, codec=codec)
                except (socket.timeout, OSError, ValueError):
                    return
                if blob is None:
                    return
                try:
                    from .ops.packing import unpack_rows
                    packed = unpack_rows(msg.get("meta"), blob)
                    ids = msg.get("node_ids")
                    if not isinstance(ids, list):
                        raise ValueError("push_packed without node_ids")
                    if packed.k:
                        with _recv_span("push_packed", tctx):
                            with self.lock:
                                self.crdt.merge_packed(packed, ids)
                    # k == 0: nothing to join — skipping the merge
                    # keeps the clock (and thus the pack cache) still.
                except Exception as e:
                    self._reply(conn, {"ok": False,
                                       "code": "packed_rejected",
                                       "error": type(e).__name__,
                                       "detail": str(e)},
                                self.tally, codec)
                    return
                if not self._reply(conn, {"ok": True}, self.tally,
                                   codec):
                    return
            elif op == "digest":
                # Merkle walk probe (docs/ANTIENTROPY.md): one level's
                # digest values at the requested node indices, plus the
                # tree geometry so the peer can abort an incompatible
                # walk before any payload bytes move. The tree itself
                # is the replica's (clock, sem_version)-keyed cache —
                # a quiet store serves every probe of the walk from
                # one reduction.
                try:
                    level = msg.get("level")
                    idxs = msg.get("idx")
                    if not isinstance(level, int) or not isinstance(
                            idxs, list):
                        raise ValueError(
                            "digest needs int 'level' + list 'idx'")
                    # Frontier prefetch (docs/ANTIENTROPY.md): "more"
                    # carries extra [level, idx-list] groups so a
                    # walker can probe several tree levels in ONE
                    # round trip. Optional and additive — a request
                    # without it is answered exactly as before, so
                    # pre-prefetch walkers interoperate unchanged.
                    groups = [(level, idxs)]
                    more = msg.get("more")
                    if more is not None:
                        if not isinstance(more, list):
                            raise ValueError(
                                "digest 'more' must be a list of "
                                "[level, idx] pairs")
                        for pair in more:
                            lvl2, idx2 = pair
                            if not isinstance(lvl2, int) \
                                    or not isinstance(idx2, list):
                                raise ValueError(
                                    "digest 'more' entries need int "
                                    "level + list idx")
                            groups.append((lvl2, idx2))
                    with self.lock:
                        tree = self.crdt.digest_tree()
                        per_group = [tree.values(lvl, ix)
                                     for lvl, ix in groups]
                    # Values ride the BINARY continuation frame (8
                    # bytes/digest, big-endian u64) — decimal JSON
                    # would triple the walk's dominant byte term.
                    # Groups concatenate in request order; "ks" gives
                    # the split points.
                    import numpy as _np
                    flat = [v for vals in per_group for v in vals]
                    buf = _np.asarray(flat,
                                      _np.uint64).astype(">u8").tobytes()
                    reply = {"op": "digest_resp", "ok": True,
                             "k": len(flat),
                             "ks": [len(v) for v in per_group],
                             "n_slots": tree.n_slots,
                             "leaf_width": tree.leaf_width,
                             "depth": tree.depth}
                except Exception as e:
                    self._reply(conn, {"code": "merkle_rejected",
                                       "error": type(e).__name__,
                                       "detail": str(e)},
                                self.tally, codec)
                    return
                if not self._reply(conn, reply, self.tally, codec):
                    return
                try:
                    send_bytes_frame(conn, [buf], self.tally, codec)
                except (OSError, ValueError):
                    return
            elif op == "delta_packed":
                try:
                    since = msg.get("since")
                    ranges = msg.get("ranges")
                    if ranges is not None:
                        ranges = tuple(
                            (int(lo), int(hi)) for lo, hi in ranges)
                    with self.lock:
                        packed, ids = _pack_for_peer(
                            self.crdt,
                            None if since is None else Hlc.parse(since),
                            sem_ok, ranges=ranges)
                    from .ops.packing import pack_rows
                    meta, bufs = pack_rows(packed)
                    meta_msg = {"meta": meta, "node_ids": list(ids),
                                "k": packed.k}
                except Exception as e:
                    self._reply(conn, {"code": "packed_rejected",
                                       "error": type(e).__name__,
                                       "detail": str(e)},
                                self.tally, codec)
                    return
                if not self._reply(conn, meta_msg, self.tally, codec):
                    return
                try:
                    send_bytes_frame(conn, bufs, self.tally, codec)
                except (OSError, ValueError):
                    return
            elif op == "heartbeat":
                # Liveness probe (docs/REPLICATION.md): works pre-hello
                # on the untagged framing, so a monitor needs no
                # capability negotiation to ask "are you serving?".
                # ServeTier implements the full replica-group form
                # (lease grants, role); here the reply is just the
                # replica's durable head — enough for a health poller
                # or an election probe against a gossip node.
                try:
                    state: dict = {"ok": True, "op": "heartbeat"}
                    with self.lock:
                        state["node"] = str(self.crdt.node_id)
                        state["hlc"] = str(self.crdt.canonical_time)
                        if msg.get("want_root") and callable(
                                getattr(self.crdt, "digest_tree",
                                        None)):
                            state["root"] = int(
                                self.crdt.digest_tree().root)
                except Exception as e:
                    self._reply(conn, {"code": "hb_failed",
                                       "error": type(e).__name__,
                                       "detail": str(e)},
                                self.tally, codec)
                    return
                if not self._reply(conn, state, self.tally, codec):
                    return
            elif op == "metrics":
                # Registry snapshot + whatever the embedding runtime
                # (GossipNode: per-peer HLC lag) contributes. The
                # registry and the hook take their own locks; only the
                # replica-identity read holds the replica lock.
                try:
                    from .obs import metrics_snapshot
                    snap = metrics_snapshot()
                    extra = self.metrics_extra
                    if extra is not None:
                        snap.update(extra())
                    if "node" not in snap:
                        with self.lock:
                            snap["node"] = {
                                "node_id": str(self.crdt.node_id),
                                "hlc_head":
                                    str(self.crdt.canonical_time)}
                except Exception as e:
                    self._reply(conn, {"code": "metrics_failed",
                                       "error": type(e).__name__,
                                       "detail": str(e)},
                                self.tally, codec)
                    return
                if not sketch_ok:
                    # Pre-sketch sessions (no hello, or one that did
                    # not agree "sketch") get the reply a pre-sketch
                    # server produced, byte for byte: stripping the
                    # section restores the old key order exactly.
                    snap.pop("sketches", None)
                if not self._reply(conn, {"metrics": snap},
                                   self.tally, codec):
                    return
            elif op == "debug_dump":
                # Flight-recorder bundles (obs/recorder.py): the
                # post-incident forensics surface. New op — legacy
                # pollers never send it, so no cap gate is needed;
                # sketch sections still honor the negotiated cap.
                from .obs.recorder import default_recorder
                bundles = default_recorder().bundles()
                if not sketch_ok:
                    bundles = [
                        {k: v for k, v in b.items()
                         if k != "sketches"} for b in bundles]
                if not self._reply(conn, {"ok": True,
                                          "bundles": bundles},
                                   self.tally, codec):
                    return
            else:
                self._reply(conn, {"code": "unknown_op",
                                   "error": f"unknown op {op!r}"},
                            self.tally, codec)
                return
            if ring.enabled:
                with self.lock:
                    stamp = str(self.crdt.canonical_time)
                extra = {}
                if tctx is not None:
                    # Correlate the responder's frame with the
                    # initiator's sync span by round id.
                    for k in ("rid", "origin"):
                        if tctx.get(k) is not None:
                            extra[k] = tctx[k]
                ring.emit("wire_frame", hlc=stamp, op=op,
                          sent=self.tally.sent - sent0,
                          received=self.tally.received - received0,
                          **extra)

    @staticmethod
    def _reply(conn: socket.socket, obj: Any,
               tally: Optional[WireTally] = None,
               codec: Optional[FrameCodec] = None) -> bool:
        """Send a reply; a peer that vanished mid-reply just ends the
        connection, never the server."""
        try:
            send_frame(conn, obj, tally, codec)
            return True
        except (OSError, ValueError):
            return False


def _check_reply(what: str, reply: Any, want_field: str) -> None:
    """Classify a reply frame: a peer that vanished or desynchronized
    (None / missing field, no error report) is a TRANSPORT fault —
    retryable; an explicit error report is a PROTOCOL rejection —
    fatal. Preserves the legacy '<what>: <reply>' message shape."""
    if isinstance(reply, dict) and want_field in reply \
            and "error" not in reply:
        return
    if isinstance(reply, dict) and reply.get("code") == "busy":
        # Admission refusal (the server is at max_conns): transport
        # class, so retry/backoff machinery handles it — never a
        # protocol rejection, never a mode downgrade.
        raise SyncTransportError(f"{what}: peer busy ({reply!r})")
    if isinstance(reply, dict) and reply.get("code") == "moved":
        # Federation redirect: the slot lives on another tier. Typed
        # and retryable (replay at reply["owner"] after refetching the
        # routing table) — like busy, never a protocol rejection,
        # never a mode downgrade (docs/FEDERATION.md).
        raise SyncRedirectError(
            f"{what}: moved to {reply.get('owner')!r} "
            f"(epoch {reply.get('epoch')})",
            owner=reply.get("owner"), epoch=reply.get("epoch"))
    if isinstance(reply, dict) and ("error" in reply
                                    or reply.get("ok") is False):
        raise SyncProtocolError.from_reply(what, reply)
    raise SyncTransportError(f"{what}: {reply!r}")


def _trace_ctx(conn: "PeerConnection", node: str,
               since: Optional[Hlc], watermark: Hlc
               ) -> Optional[dict]:
    """Initiator-side trace context for one sync round — the compact
    payload the "trace" hello cap lets ride on sync frames: origin
    node, the round's HLC stamp range, and a fleet-unique round id.
    Returns None unless the session negotiated "trace" AND the
    process tracer is enabled, so with tracing off (or against a
    pre-trace peer) every frame stays byte-identical to the un-traced
    protocol and the hot path pays one attribute read."""
    from .obs.trace import round_id, tracer
    if "trace" not in conn.caps or not tracer().enabled:
        return None
    return {"rid": round_id(node), "origin": node,
            "hlc_lo": None if since is None else str(since),
            "hlc_hi": str(watermark)}


def _recv_span(op: str, tctx: Optional[dict]):
    """Responder-side merge span named ``<op>_recv`` carrying the
    initiator's round id/origin/stamp range, so both ends of a round
    correlate in one JSONL sink. A no-op context when the frame bore
    no trace context or tracing is off."""
    from .obs.trace import span, tracer
    if not isinstance(tctx, dict) or not tracer().enabled:
        import contextlib
        return contextlib.nullcontext()
    fields = {k: tctx[k] for k in ("rid", "origin", "hlc_lo",
                                   "hlc_hi")
              if tctx.get(k) is not None}
    return span(f"{op}_recv", kind="sync_recv", **fields)


class PeerConnection:
    """One keep-alive framed session to a :class:`SyncServer`.

    Connect + hello happen at most once per session (``ensure``); the
    `*_over_conn` round functions then reuse the socket round after
    round — the fresh-TCP-setup cost the pooled gossip path removes.
    Failure handling is by RESET, not repair: any round error closes
    the socket, and the next ``ensure`` reconnects (and renegotiates),
    which is exactly the shape `GossipNode`'s retry/breaker machinery
    expects — a replayed round is an idempotent lattice join.

    Negotiation: ``ensure`` sends ``hello`` with ``want_caps`` and
    intersects with the server's reply (:attr:`caps`); a pre-hello
    server answers ``unknown_op`` and hangs up, so the session marks
    itself ``legacy`` (sticky) and reconnects speaking the untagged
    pre-hello framing. ``negotiate=False`` skips hello entirely — the
    one-shot `sync_over_tcp` wrappers use it to keep their legacy
    wire bytes byte-identical.

    ``idle_timeout`` must stay BELOW the server's ``io_timeout``
    (default 20 s vs 30 s): a session parked longer than that may
    already be half-closed server-side, so ``ensure`` proactively
    reconnects instead of racing a dead socket. Passing
    ``idle_timeout=None`` disables the bound and is flagged by the
    crdtlint socket-timeout rule."""

    def __init__(self, host: str, port: int, timeout: float = 30.0,
                 idle_timeout: Optional[float] = 20.0,
                 negotiate: bool = True,
                 want_caps: Iterable[str] = ("zlib", "packed",
                                             "semantics", "merkle",
                                             "trace", "sketch")):
        self.host = host
        self.port = port
        self.timeout = timeout
        self.idle_timeout = idle_timeout
        self.negotiate = negotiate
        self.want_caps = tuple(want_caps)
        self.legacy = False
        # Cleared (sticky per session) the first time a peer answers a
        # multi-level digest probe with only the first group — a
        # pre-prefetch server that advertises "merkle" but ignores
        # "more". Later walks on the session go single-level directly.
        self.digest_prefetch = True
        self.caps: frozenset = frozenset()
        self.codec: Optional[FrameCodec] = None
        self.connects = 0      # raw TCP connects (tests/bench hook)
        self._sock: Optional[socket.socket] = None
        self._last_used = 0.0

    @property
    def connected(self) -> bool:
        return self._sock is not None

    def ensure(self, tally: Optional[WireTally] = None
               ) -> socket.socket:
        """The live socket — connecting (and negotiating) if needed.
        Raises :class:`SyncTransportError` when the peer is
        unreachable or the hello exchange dies mid-flight."""
        import time as _time
        if self._sock is not None:
            if self.idle_timeout is not None and (
                    _time.monotonic() - self._last_used
                    > self.idle_timeout):
                self.reset()
            else:
                self._last_used = _time.monotonic()
                return self._sock
        try:
            sock = socket.create_connection((self.host, self.port),
                                            timeout=self.timeout)
            sock.settimeout(self.timeout)
        except OSError as e:
            raise SyncTransportError(
                f"connect to {self.host}:{self.port} failed: {e!r}"
            ) from e
        self.connects += 1
        self.caps = frozenset()
        self.codec = None
        self.digest_prefetch = True   # re-probe: the peer may differ
        if self.negotiate and not self.legacy:
            try:
                send_frame(sock, {"op": "hello", "proto": 1,
                                  "caps": list(self.want_caps)}, tally)
                reply = recv_frame(
                    sock, deadline=_time.monotonic() + self.timeout,
                    tally=tally)
            except (OSError, ValueError) as e:
                sock.close()
                raise SyncTransportError(f"hello failed: {e!r}") from e
            if isinstance(reply, dict) and reply.get("ok") \
                    and isinstance(reply.get("caps"), list):
                self.caps = frozenset(reply["caps"])
                self.codec = FrameCodec(compress="zlib" in self.caps)
            elif isinstance(reply, dict) \
                    and reply.get("code") == "busy":
                # Admission refusal at accept (max_conns): the server
                # understood us perfectly well, it just has no slot.
                # Retryable — and emphatically NOT the legacy signal:
                # a busy modern server must not demote the session to
                # the pre-hello framing forever.
                sock.close()
                raise SyncTransportError(
                    f"peer {self.host}:{self.port} at capacity "
                    f"(busy): {reply.get('error')!r}")
            elif isinstance(reply, dict) \
                    and reply.get("code") == "moved":
                # Federation redirect at hello: a modern server naming
                # the owning tier. Typed and retryable — like busy,
                # NOT the legacy signal (docs/FEDERATION.md).
                sock.close()
                raise SyncRedirectError(
                    f"peer {self.host}:{self.port} redirected to "
                    f"{reply.get('owner')!r} "
                    f"(epoch {reply.get('epoch')})",
                    owner=reply.get("owner"),
                    epoch=reply.get("epoch"))
            elif isinstance(reply, dict) and ("error" in reply
                                              or reply.get("ok")
                                              is False):
                # Pre-hello server: it reported unknown_op and hung
                # up. Sticky — reconnect once, without hello, and
                # speak the legacy framing from here on.
                sock.close()
                self.legacy = True
                return self.ensure(tally)
            else:
                # None / garbage: the link died mid-handshake.
                sock.close()
                raise SyncTransportError(f"hello failed: {reply!r}")
        self._sock = sock
        self._last_used = _time.monotonic()
        return sock

    def reset(self) -> None:
        """Drop the session (error path); the next ``ensure``
        reconnects. The ``legacy`` mark survives — a pre-hello peer
        does not grow a hello by reconnecting."""
        sock, self._sock = self._sock, None
        self.codec = None
        self.caps = frozenset()
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def close(self, tally: Optional[WireTally] = None) -> None:
        """Polite teardown: best-effort ``bye`` (ends the server's
        handler loop promptly instead of waiting out its io_timeout),
        then close."""
        sock = self._sock
        if sock is not None:
            try:
                send_frame(sock, {"op": "bye"}, tally, self.codec)
            except (OSError, ValueError):
                pass
        self.reset()

    def __enter__(self) -> "PeerConnection":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def sync_over_conn(crdt: Crdt, conn: PeerConnection,
                   since: Optional[Hlc] = None,
                   key_encoder=None, value_encoder=None,
                   key_decoder=None, value_decoder=None,
                   lock: Optional[threading.Lock] = None,
                   tally: Optional[WireTally] = None) -> Hlc:
    """One JSON anti-entropy round over a pooled session — the
    semantics of :func:`sync_over_tcp` (watermark captured before the
    push, inclusive delta bound, lock held only around local replica
    calls) minus the per-round connect, and with the session's
    negotiated codec applied to every frame. No ``bye`` is sent: the
    session stays parked for the next round. ANY failure resets the
    session (the error taxonomy is unchanged), so a retry reconnects
    cleanly."""
    if lock is None:
        lock = threading.Lock()   # uncontended no-op
    with lock:
        watermark = crdt.canonical_time
        payload = crdt.to_json(key_encoder=key_encoder,
                               value_encoder=value_encoder)
    import time as _time
    from .obs.trace import span
    sock = conn.ensure(tally)
    node = str(getattr(crdt, "node_id", "?"))
    tctx = _trace_ctx(conn, node, since, watermark)
    rid = {"rid": tctx["rid"]} if tctx else {}
    try:
        codec = conn.codec
        with span("sync_json", kind="sync", hlc=lambda: watermark,
                  node=node, **rid):
            msg = {"op": "push", "payload": payload}
            if tctx:
                msg["trace"] = tctx
            send_frame(sock, msg, tally, codec)
            reply = recv_frame(
                sock, deadline=_time.monotonic() + conn.timeout,
                tally=tally, codec=codec)
            _check_reply("push rejected", reply, "ok")
            msg = {"op": "delta", "since": None if since is None
                   else str(since)}
            if tctx:
                msg["trace"] = tctx
            send_frame(sock, msg, tally, codec)
            reply = recv_frame(
                sock, deadline=_time.monotonic() + conn.timeout,
                tally=tally, codec=codec)
            _check_reply("delta failed", reply, "payload")
            pulled = reply["payload"]
            with lock:
                crdt.merge_json(pulled, key_decoder=key_decoder,
                                value_decoder=value_decoder)
    except SyncError:
        conn.reset()
        raise
    except (OSError, ValueError) as e:
        conn.reset()
        raise SyncTransportError(f"sync round failed: {e!r}") from e
    return watermark


def sync_dense_over_conn(crdt, conn: PeerConnection,
                         since: Optional[Hlc] = None,
                         lock: Optional[threading.Lock] = None,
                         tally: Optional[WireTally] = None) -> Hlc:
    """One DENSE (kernel wire form) round over a pooled session —
    :func:`sync_dense_over_tcp` semantics minus the per-round
    connect. See :func:`sync_over_conn` for the session contract."""
    if lock is None:
        lock = threading.Lock()   # uncontended no-op
    with lock:
        watermark = crdt.canonical_time
        scs, ids = crdt.export_split_delta()
        meta, bufs = _pack_split(scs)
    import time as _time
    from .obs.trace import span
    sock = conn.ensure(tally)
    node = str(getattr(crdt, "node_id", "?"))
    tctx = _trace_ctx(conn, node, since, watermark)
    rid = {"rid": tctx["rid"]} if tctx else {}
    try:
        codec = conn.codec
        with span("sync_dense", kind="sync", hlc=lambda: watermark,
                  node=node, **rid):
            msg = {"op": "push_dense", "meta": meta,
                   "node_ids": list(ids)}
            if tctx:
                msg["trace"] = tctx
            send_frame(sock, msg, tally, codec)
            send_bytes_frame(sock, bufs, tally, codec)
            reply = recv_frame(
                sock, deadline=_time.monotonic() + conn.timeout,
                tally=tally, codec=codec)
            _check_reply("push rejected", reply, "ok")
            msg = {"op": "delta_dense", "since": None if since is None
                   else str(since)}
            if tctx:
                msg["trace"] = tctx
            send_frame(sock, msg, tally, codec)
            reply = recv_frame(
                sock, deadline=_time.monotonic() + conn.timeout,
                tally=tally, codec=codec)
            _check_reply("delta failed", reply, "meta")
            blob = recv_bytes_frame(sock,
                                    deadline=_time.monotonic()
                                    + conn.timeout,
                                    tally=tally, codec=codec)
            if blob is None:
                raise SyncTransportError("delta binary frame missing")
            peer_scs = _unpack_split(reply["meta"], blob)
            ids_in = reply.get("node_ids")
            if not isinstance(ids_in, list) or not ids_in:
                raise SyncTransportError(
                    "delta reply without node_ids")
            with lock:
                crdt.merge_split(peer_scs, ids_in)
    except SyncError:
        conn.reset()
        raise
    except (OSError, ValueError) as e:
        conn.reset()
        raise SyncTransportError(f"sync round failed: {e!r}") from e
    return watermark


def _pack_for_peer(crdt, since: Optional[Hlc],
                   sem_include: bool, ranges=None) -> Tuple:
    """`pack_since` with the semantics tag lane included only when the
    session negotiated the "semantics" capability. Crdts predating the
    ``sem_mode`` kwarg (no typed surface) get the plain call — their
    packs are 5-lane regardless. An un-negotiated session against a
    typed store gets ``sem_mode="auto"``, i.e. typed rows WITHHELD
    (never silently stripped of their tags — docs/TYPES.md).
    ``ranges`` is the anti-entropy slot-span mask; a crdt advertising
    the "merkle" cap always supports it, and passing it to one that
    doesn't raises TypeError, which the wire surfaces as a
    rejection."""
    if hasattr(crdt, "set_semantics"):
        sem_mode = "include" if sem_include else "auto"
        if ranges is not None:
            return crdt.pack_since(since, sem_mode=sem_mode,
                                   ranges=ranges)
        return crdt.pack_since(since, sem_mode=sem_mode)
    if ranges is not None:
        return crdt.pack_since(since, ranges=ranges)
    return crdt.pack_since(since)


def sync_packed_over_conn(crdt, conn: PeerConnection,
                          since: Optional[Hlc] = None,
                          lock: Optional[threading.Lock] = None,
                          tally: Optional[WireTally] = None,
                          _prepacked: Optional[Tuple] = None,
                          fused_repack: bool = False) -> Hlc:
    """One INCREMENTAL round over a pooled session: both directions
    ship the O(k) packed columnar form (`DenseCrdt.pack_since` /
    `merge_packed`), so bytes are proportional to the rows modified
    since ``since`` — not to store capacity (the dense form) or to
    full-state JSON. The same single watermark bounds BOTH halves:
    after a successful round the peer holds everything stamped before
    it, so the next round's ``pack_since(watermark)`` (inclusive)
    misses nothing; the first round (``since=None``) pushes and pulls
    full state. An empty half (k == 0) is skipped entirely — no op on
    the wire for the push, no merge for the pull — which keeps both
    clocks (and so both pack caches) untouched on a no-change round.

    Requires the peer to have advertised the "packed" cap
    (:class:`SyncProtocolError` code ``packed_rejected`` otherwise —
    the sticky-downgrade signal, raised before any bytes move).
    ``_prepacked`` is the pipelined gossip hook: a
    ``(watermark, packed, ids)`` triple packed earlier (overlapped
    with another peer's network phase) to use instead of packing
    here.

    ``fused_repack=True`` merges the pulled delta through
    `DenseCrdt.merge_and_repack`: the join and the NEXT round's pack
    mask run as one device dispatch, and the post-merge pack is seeded
    into the cache under this round's outgoing watermark — which is
    exactly the ``since`` the next round asks for, so a
    steady-state relay alternates merge+pack, merge+pack with zero
    standalone pack dispatches (docs/FASTPATH.md)."""
    if lock is None:
        lock = threading.Lock()   # uncontended no-op
    from .ops.packing import pack_rows, unpack_rows
    import time as _time
    # Negotiate BEFORE packing: whether the sem tag lane rides (and so
    # whether typed rows ship at all) depends on the session's caps.
    sock = conn.ensure(tally)
    if "packed" not in conn.caps:
        # Raised before any bytes move: the session is still in sync,
        # so no reset — the caller can immediately retry dense/JSON
        # over the same connection.
        raise SyncProtocolError(
            "peer did not advertise the 'packed' capability",
            code="packed_rejected")
    if _prepacked is not None:
        watermark, packed, ids = _prepacked
    else:
        with lock:
            # Commit any staged ingest-window writes BEFORE reading
            # the watermark: pack_since drains too, but its flush
            # advances the canonical after a watermark read here,
            # and a stale watermark re-sends every flushed row on
            # the next round.
            drain = getattr(crdt, "drain_ingest", None)
            if drain is not None:
                drain()
            watermark = crdt.canonical_time
            packed, ids = _pack_for_peer(crdt, since,
                                         "semantics" in conn.caps)
    from .obs.trace import span
    node = str(getattr(crdt, "node_id", "?"))
    tctx = _trace_ctx(conn, node, since, watermark)
    rid = {"rid": tctx["rid"]} if tctx else {}
    try:
        codec = conn.codec
        with span("sync_packed", kind="sync", hlc=lambda: watermark,
                  node=node, rows=packed.k, **rid):
            if packed.k:
                meta, bufs = pack_rows(packed)
                msg = {"op": "push_packed", "meta": meta,
                       "node_ids": list(ids)}
                if tctx:
                    msg["trace"] = tctx
                send_frame(sock, msg, tally, codec)
                send_bytes_frame(sock, bufs, tally, codec)
                reply = recv_frame(
                    sock, deadline=_time.monotonic() + conn.timeout,
                    tally=tally, codec=codec)
                _check_reply("push rejected", reply, "ok")
            msg = {"op": "delta_packed",
                   "since": None if since is None else str(since)}
            if tctx:
                msg["trace"] = tctx
            send_frame(sock, msg, tally, codec)
            reply = recv_frame(
                sock, deadline=_time.monotonic() + conn.timeout,
                tally=tally, codec=codec)
            _check_reply("delta failed", reply, "meta")
            blob = recv_bytes_frame(sock,
                                    deadline=_time.monotonic()
                                    + conn.timeout,
                                    tally=tally, codec=codec)
            if blob is None:
                raise SyncTransportError("delta binary frame missing")
            peer_packed = unpack_rows(reply["meta"], blob)
            ids_in = reply.get("node_ids")
            if not isinstance(ids_in, list):
                raise SyncTransportError(
                    "delta reply without node_ids")
            if peer_packed.k:
                if not ids_in:
                    raise SyncTransportError(
                        "delta reply without node_ids")
                with lock:
                    if fused_repack and hasattr(crdt,
                                                "merge_and_repack"):
                        # Seed the next round's pack while the join is
                        # on device anyway; `watermark` (this round's
                        # pre-push canonical) is the `since` the next
                        # round's pack_for_peer will present.
                        crdt.merge_and_repack(
                            peer_packed, ids_in, since=watermark,
                            sem_mode=("include"
                                      if "semantics" in conn.caps
                                      else "auto"))
                    else:
                        crdt.merge_packed(peer_packed, ids_in)
    except SyncError:
        conn.reset()
        raise
    except (OSError, ValueError) as e:
        conn.reset()
        raise SyncTransportError(f"sync round failed: {e!r}") from e
    return watermark


class _DigestPrefetchUnsupported(Exception):
    """Internal walk signal: the peer advertises "merkle" but ignored
    a multi-level probe's "more" groups (pre-prefetch release). Both
    reply frames were consumed, so the session is still framed-in-sync
    — the walk restarts single-level instead of aborting."""


def sync_merkle_over_conn(crdt, conn: PeerConnection,
                          lock: Optional[threading.Lock] = None,
                          tally: Optional[WireTally] = None,
                          fused_repack: bool = False,
                          _stats: Optional[dict] = None) -> Hlc:
    """One Merkle ANTI-ENTROPY round over a pooled session
    (docs/ANTIENTROPY.md) — the cold/partitioned-peer complement to
    `sync_packed_over_conn`: instead of a watermark (which a fresh
    peer doesn't have) the two replicas compare digest trees, walking
    only differing subtrees via the ``digest`` op — one round trip per
    level, <= log2(n_leaves)+1 total — and then re-ship JUST the
    divergent leaf ranges through ``pack_since(ranges=...)`` in both
    directions. Matching roots end the round after ONE probe with
    zero payload bytes; traffic scales with divergence, not store
    size.

    Requires the "merkle" cap (:class:`SyncProtocolError` code
    ``merkle_rejected`` before any payload bytes otherwise — the
    sticky-downgrade signal), and aborts the same way on tree
    geometry (n_slots/leaf_width) mismatch, where a full packed round
    is the correct fallback. The walk probes a live peer: if the peer
    mutates mid-walk the ranges are computed against mixed snapshots,
    which is safe (the range pack + lattice join are idempotent; the
    next round converges the residue). Returns the local pre-walk
    canonical time — the watermark incremental rounds resume from.
    ``_stats`` (bench/test hook) receives rounds / digests / ranges /
    row counts."""
    if lock is None:
        lock = threading.Lock()   # uncontended no-op
    from .obs.registry import default_registry
    from .obs.trace import span
    from .ops.digest import coalesce_leaf_ranges, walk_divergent_leaves
    from .ops.packing import pack_rows, unpack_rows
    import time as _time
    sock = conn.ensure(tally)
    if "merkle" not in conn.caps:
        raise SyncProtocolError(
            "peer did not advertise the 'merkle' capability",
            code="merkle_rejected")
    with lock:
        drain = getattr(crdt, "drain_ingest", None)
        if drain is not None:
            drain()
        watermark = crdt.canonical_time
        tree = crdt.digest_tree()
    codec = conn.codec
    node = str(getattr(crdt, "node_id", "?"))
    # One round id spans the whole walk: every digest probe and both
    # re-ship halves carry it, so the responder's merge span and each
    # wire_frame correlate back to this initiator span.
    tctx = _trace_ctx(conn, node, None, watermark)
    rid = {"rid": tctx["rid"]} if tctx else {}

    def fetch_levels(groups):
        # One round trip for the whole multi-level probe: the first
        # group rides the original level/idx fields (so the request
        # degrades to the single-level op when there is only one) and
        # the rest ride "more" — the frontier-prefetch extension
        # (docs/ANTIENTROPY.md).
        import numpy as _np
        (level0, idxs0) = groups[0]
        msg = {"op": "digest", "level": level0, "idx": list(idxs0)}
        if len(groups) > 1:
            msg["more"] = [[lvl, list(ix)] for lvl, ix in groups[1:]]
        if tctx:
            msg["trace"] = tctx
        send_frame(sock, msg, tally, codec)
        reply = recv_frame(
            sock, deadline=_time.monotonic() + conn.timeout,
            tally=tally, codec=codec)
        _check_reply("digest failed", reply, "k")
        if level0 == 0 and not tree.same_geometry(
                reply.get("n_slots"), reply.get("leaf_width"),
                reply.get("depth")):
            # The probe exchange completed, so the session is still
            # framed-in-sync; the reset in the outer handler is the
            # conservative price of the shared error path.
            raise SyncProtocolError(
                f"merkle geometry mismatch: local "
                f"({tree.n_slots}, {tree.leaf_width}, {tree.depth}) "
                f"vs peer ({reply.get('n_slots')}, "
                f"{reply.get('leaf_width')}, {reply.get('depth')})",
                code="merkle_rejected")
        blob = recv_bytes_frame(
            sock, deadline=_time.monotonic() + conn.timeout,
            tally=tally, codec=codec)
        ks = reply.get("ks")
        if ks is None:
            if len(groups) > 1 and blob is not None \
                    and reply["k"] == len(groups[0][1]) \
                    and len(blob) == 8 * reply["k"]:
                # A pre-prefetch server (previous release, same
                # "merkle" cap) ignores "more" and answers ONLY the
                # first group, without "ks". The exchange is complete,
                # so degrade the walk to single-level rather than
                # treating the shorter reply as a framing error.
                raise _DigestPrefetchUnsupported
            ks = [reply["k"]]
        if blob is None or not isinstance(ks, list) \
                or len(ks) != len(groups) \
                or ks != [len(ix) for _, ix in groups] \
                or reply["k"] != sum(ks) \
                or len(blob) != 8 * reply["k"]:
            raise SyncTransportError("digest binary frame mismatch")
        flat = _np.frombuffer(blob, ">u8").tolist()
        out, off = [], 0
        for k in ks:
            out.append(flat[off:off + k])
            off += k
        return out

    def fetch_one(level, idxs):
        # Single-group probes never carry "more", so every "merkle"
        # server generation answers them identically.
        return fetch_levels([(level, idxs)])[0]

    try:
        with span("sync_merkle", kind="sync",
                  hlc=lambda: watermark, node=node, **rid):
            if conn.digest_prefetch:
                try:
                    leaves, rounds, fetched = walk_divergent_leaves(
                        tree, None, fetch_levels=fetch_levels)
                except _DigestPrefetchUnsupported:
                    # Sticky for the session: later walks skip the
                    # futile multi-level probe entirely.
                    conn.digest_prefetch = False
                    leaves, rounds, fetched = walk_divergent_leaves(
                        tree, fetch_one)
                    rounds += 1   # the aborted prefetch probe
            else:
                leaves, rounds, fetched = walk_divergent_leaves(
                    tree, fetch_one)
            reg = default_registry()
            reg.counter(
                "crdt_tpu_merkle_digest_rounds_total",
                "digest round trips spent walking peer trees"
            ).inc(rounds, node=node)
            reg.counter(
                "crdt_tpu_merkle_sync_total",
                "merkle anti-entropy rounds by outcome"
            ).inc(outcome="diverged" if leaves else "clean", node=node)
            if _stats is not None:
                _stats.update(rounds=rounds, digests=fetched,
                              ranges=(), pushed_rows=0, pulled_rows=0)
            if not leaves:
                return watermark
            ranges = coalesce_leaf_ranges(leaves, tree.leaf_width,
                                          tree.n_slots)
            reg.counter(
                "crdt_tpu_merkle_ranges_shipped_total",
                "divergent slot ranges re-shipped after walks"
            ).inc(len(ranges), node=node)
            # Both halves are clock-unbounded WITHIN the ranges: the
            # divergence may predate any watermark either side holds.
            with lock:
                packed, ids = _pack_for_peer(
                    crdt, None, "semantics" in conn.caps,
                    ranges=ranges)
            if packed.k:
                meta, bufs = pack_rows(packed)
                msg = {"op": "push_packed", "meta": meta,
                       "node_ids": list(ids)}
                if tctx:
                    msg["trace"] = tctx
                send_frame(sock, msg, tally, codec)
                send_bytes_frame(sock, bufs, tally, codec)
                reply = recv_frame(
                    sock, deadline=_time.monotonic() + conn.timeout,
                    tally=tally, codec=codec)
                _check_reply("push rejected", reply, "ok")
            msg = {"op": "delta_packed", "since": None,
                   "ranges": [list(r) for r in ranges]}
            if tctx:
                msg["trace"] = tctx
            send_frame(sock, msg, tally, codec)
            reply = recv_frame(
                sock, deadline=_time.monotonic() + conn.timeout,
                tally=tally, codec=codec)
            _check_reply("delta failed", reply, "meta")
            blob = recv_bytes_frame(
                sock, deadline=_time.monotonic() + conn.timeout,
                tally=tally, codec=codec)
            if blob is None:
                raise SyncTransportError("delta binary frame missing")
            peer_packed = unpack_rows(reply["meta"], blob)
            ids_in = reply.get("node_ids")
            if not isinstance(ids_in, list):
                raise SyncTransportError("delta reply without node_ids")
            if peer_packed.k:
                if not ids_in:
                    raise SyncTransportError(
                        "delta reply without node_ids")
                with lock:
                    if fused_repack and hasattr(crdt,
                                                "merge_and_repack"):
                        # Seed the FOLLOW-UP incremental round's pack
                        # (same contract as the packed path).
                        crdt.merge_and_repack(
                            peer_packed, ids_in, since=watermark,
                            sem_mode=("include"
                                      if "semantics" in conn.caps
                                      else "auto"))
                    else:
                        crdt.merge_packed(peer_packed, ids_in)
            if _stats is not None:
                _stats.update(ranges=ranges, pushed_rows=packed.k,
                              pulled_rows=peer_packed.k)
    except SyncError:
        conn.reset()
        raise
    except (OSError, ValueError) as e:
        conn.reset()
        raise SyncTransportError(f"sync round failed: {e!r}") from e
    return watermark


def sync_over_tcp(crdt: Crdt, host: str, port: int,
                  since: Optional[Hlc] = None,
                  timeout: float = 30.0,
                  key_encoder=None, value_encoder=None,
                  key_decoder=None, value_decoder=None,
                  lock: Optional[threading.Lock] = None,
                  tally: Optional[WireTally] = None) -> Hlc:
    """One anti-entropy round against a :class:`SyncServer`.

    ``since`` is this replica's delta watermark: pass None on first
    contact with a peer (cold start — a fresh replica has seen
    nothing, so the pull must be full) and the returned watermark on
    later rounds. The watermark is captured BEFORE pushing, exactly
    like the reference's `_sync` (test/map_crdt_test.dart:273-279);
    the inclusive `modified >= since` bound (map_crdt.dart:44-45)
    then guarantees nothing stamped after it is missed.

    ``lock`` serializes access to the LOCAL replica: when ``crdt`` is
    also served by its own `SyncServer` (the natural bidirectional
    mesh), pass that server's :attr:`SyncServer.lock` here — without
    it this round's reads/merges race the server thread. The lock is
    held only around local replica calls, never across network waits,
    so a gossiping mesh of self-served replicas cannot deadlock on
    each other's rounds.

    Failures raise the :class:`SyncError` taxonomy: link faults as
    retryable :class:`SyncTransportError`, peer rejections as fatal
    :class:`SyncProtocolError` — both still `ConnectionError`.
    ``tally``, when given, accumulates wire bytes for the round.

    This is the one-shot wrapper around :func:`sync_over_conn`: a
    non-negotiating session (no hello — the wire bytes are exactly
    the pre-hello protocol, so any server vintage interoperates) that
    lives for one round and says ``bye``. Gossip pools a
    :class:`PeerConnection` instead.
    """
    conn = PeerConnection(host, port, timeout=timeout,
                          negotiate=False)
    try:
        watermark = sync_over_conn(crdt, conn, since=since,
                                   key_encoder=key_encoder,
                                   value_encoder=value_encoder,
                                   key_decoder=key_decoder,
                                   value_decoder=value_decoder,
                                   lock=lock, tally=tally)
        conn.close(tally)
    except BaseException:
        conn.reset()
        raise
    return watermark


def sync_dense_over_tcp(crdt, host: str, port: int,
                        since: Optional[Hlc] = None,
                        timeout: float = 30.0,
                        lock: Optional[threading.Lock] = None,
                        tally: Optional[WireTally] = None) -> Hlc:
    """One anti-entropy round between DENSE replicas in the kernel
    wire form: split 32-bit lanes as raw binary frames
    (`DenseCrdt.export_split_delta` / `merge_split`) — ~19 B per slot
    on the wire instead of ~90 B of JSON text, and no text codec on
    either side. Watermark/``since``/``lock`` semantics are exactly
    :func:`sync_over_tcp`'s; both peers must be dense models at the
    same capacity (the server reports a rejection otherwise — fall
    back to :func:`sync_over_tcp`, the universal interop path).

    Cold-start caveat: a card replica builds its kernels with ``nvcc``
    at first use, which can take seconds on its FIRST round — warm the
    replica with one local merge, or pass a larger timeout for first
    contact.

    One-shot wrapper around :func:`sync_dense_over_conn` (no hello —
    exactly the pre-hello wire bytes); gossip pools a
    :class:`PeerConnection` instead."""
    conn = PeerConnection(host, port, timeout=timeout,
                          negotiate=False)
    try:
        watermark = sync_dense_over_conn(crdt, conn, since=since,
                                         lock=lock, tally=tally)
        conn.close(tally)
    except BaseException:
        conn.reset()
        raise
    return watermark


def _poll_op(host: str, port: int, msg: dict, want_field: str,
             what: str, timeout: float,
             tally: Optional[WireTally], negotiate: bool) -> Any:
    """One-shot request/reply poll shared by `fetch_metrics` and
    `fetch_debug_dump`. With ``negotiate`` the poll opens with a
    hello asking for the ``sketch`` cap (so sketch-capable servers
    include quantile payloads); a pre-hello server answers
    ``unknown_op`` and hangs up, and the poll retries on a fresh
    socket WITHOUT hello — byte-identical to what an old poller
    sends, so mixed-version fleets scrape cleanly both ways."""
    import time as _time
    try:
        with socket.create_connection((host, port),
                                      timeout=timeout) as sock:
            sock.settimeout(timeout)
            codec: Optional[FrameCodec] = None
            if negotiate:
                send_frame(sock, {"op": "hello", "proto": 1,
                                  "caps": ["zlib", "sketch"]}, tally)
                hello = recv_frame(
                    sock, deadline=_time.monotonic() + timeout,
                    tally=tally)
                if isinstance(hello, dict) and hello.get("ok") \
                        and isinstance(hello.get("caps"), list):
                    codec = FrameCodec(
                        compress="zlib" in hello["caps"])
                else:
                    # Pre-hello server: it reported unknown_op and
                    # hung up. Fall back to the bare legacy poll.
                    return _poll_op(host, port, msg, want_field,
                                    what, timeout, tally,
                                    negotiate=False)
            send_frame(sock, msg, tally, codec)
            reply = recv_frame(sock,
                               deadline=_time.monotonic() + timeout,
                               tally=tally, codec=codec)
            _check_reply(what, reply, want_field)
            send_frame(sock, {"op": "bye"}, tally, codec)
            return reply[want_field]
    except SyncError:
        raise
    except (OSError, ValueError) as e:
        raise SyncTransportError(f"{what}: {e!r}") from e


def fetch_metrics(host: str, port: int, timeout: float = 10.0,
                  tally: Optional[WireTally] = None,
                  sketches: bool = True) -> dict:
    """Poll a :class:`SyncServer`'s ``metrics`` op: one registry
    snapshot (merge/peer/wire counters, and — when the server belongs
    to a `GossipNode` — per-peer HLC lag under ``"lag"``). Raises the
    usual :class:`SyncError` taxonomy; a pre-metrics server replies
    ``unknown_op``, surfaced as :class:`SyncProtocolError`.

    With ``sketches`` (the default) the poll negotiates the
    ``sketch`` hello cap first, so the snapshot includes the
    ``"sketches"`` quantile section from sketch-capable servers;
    pre-hello servers are re-polled with the legacy bare frame.
    ``sketches=False`` skips hello entirely — the legacy wire bytes,
    unchanged."""
    return _poll_op(host, port, {"op": "metrics"}, "metrics",
                    "metrics poll failed", timeout, tally,
                    negotiate=sketches)


def fetch_debug_dump(host: str, port: int, timeout: float = 10.0,
                     tally: Optional[WireTally] = None) -> list:
    """Fetch a server's flight-recorder bundles (``debug_dump`` op;
    obs/recorder.py) — the post-incident forensics pull. Pre-recorder
    servers answer ``unknown_op``, surfaced as
    :class:`SyncProtocolError`."""
    return _poll_op(host, port, {"op": "debug_dump"}, "bundles",
                    "debug dump failed", timeout, tally,
                    negotiate=True)
