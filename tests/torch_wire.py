"""Wire helpers shared by the port's socket tests and ``chip_smoke.py``
(no jax here, so the card run can import it too).

- `RecordingProxy`: a TCP relay that forwards bytes verbatim both ways
  and records each connection's client-to-server and server-to-client
  streams, so two runs of one script can be compared byte for byte.
- `frames`: split a recorded stream into its frame bodies (tag byte
  stripped and zlib inflated on a negotiated session), and
  `untraced`: the same with each JSON frame's trace context dropped,
  which is how frames are compared with the tracer on (the trace
  context carries a per-process round id).
- `counter_deltas`: what the metrics registry's counters gained
  between two snapshots, by (name, labels).
"""

from __future__ import annotations

import json
import socket
import struct
import threading
import zlib
from typing import Dict, List, Tuple


class RecordingProxy:
    """Forward ``127.0.0.1:port`` to ``(host, port)`` verbatim and keep
    ``[c2s bytes, s2c bytes]`` per accepted connection, in accept
    order."""

    def __init__(self, host: str, port: int):
        self.target = (host, port)
        self.conns: List[List[bytearray]] = []
        self._lsock = socket.create_server(("127.0.0.1", 0))
        self._lsock.settimeout(0.02)    # how often accept polls stop
        self.host, self.port = self._lsock.getsockname()[:2]
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._socks: List[socket.socket] = []
        self._lock = threading.Lock()
        self._accept = threading.Thread(target=self._serve, daemon=True)

    def __enter__(self) -> "RecordingProxy":
        self._accept.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._accept.join(timeout=10)
        with self._lock:
            socks = list(self._socks)
        for s in socks:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        for t in list(self._threads):
            t.join(timeout=10)
        for s in socks:
            s.close()
        self._lsock.close()

    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                client, _ = self._lsock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            upstream = socket.create_connection(self.target)
            rec = [bytearray(), bytearray()]
            with self._lock:
                self.conns.append(rec)
                self._socks += [client, upstream]
            for src, dst, buf in ((client, upstream, rec[0]),
                                  (upstream, client, rec[1])):
                t = threading.Thread(target=self._pump,
                                     args=(src, dst, buf), daemon=True)
                self._threads.append(t)
                t.start()

    @staticmethod
    def _pump(src: socket.socket, dst: socket.socket,
              buf: bytearray) -> None:
        try:
            while True:
                chunk = src.recv(1 << 20)
                if not chunk:
                    break
                buf += chunk
                dst.sendall(chunk)
        except OSError:
            pass
        try:
            dst.shutdown(socket.SHUT_WR)
        except OSError:
            pass

    def streams(self, wait: float = 30.0) -> List[Tuple[bytes, bytes]]:
        """Every connection's ``(c2s, s2c)`` bytes, after waiting up to
        ``wait`` seconds for the relays of closed connections to drain
        (a connection still open returns what it carried so far)."""
        for t in list(self._threads):
            t.join(timeout=wait)
        with self._lock:
            return [(bytes(a), bytes(b)) for a, b in self.conns]


def frames(stream: bytes) -> List[bytes]:
    """The frame bodies of one direction of a recorded connection. A
    session whose first frame is a hello speaks the tagged framing
    after it (the hello and its reply cross untagged): the tag byte is
    stripped and zlib bodies inflated."""
    out, off, tagged = [], 0, False
    while off + 4 <= len(stream):
        (n,) = struct.unpack(">I", stream[off:off + 4])
        body = stream[off + 4:off + 4 + n]
        off += 4 + n
        if tagged:
            tag, body = body[:1], body[1:]
            if tag == b"\x01":
                body = zlib.decompress(body)
        elif not out and body.startswith(b'{"op": "hello"') \
                or not out and body.startswith(b'{"ok": true, "proto"'):
            tagged = True
        out.append(body)
    return out


def untraced(stream: bytes) -> List[bytes]:
    """`frames` with every JSON frame's ``trace`` member dropped."""
    out = []
    for body in frames(stream):
        if body[:1] == b"{":
            obj = json.loads(body)
            obj.pop("trace", None)
            body = json.dumps(obj).encode()
        out.append(body)
    return out


def counter_deltas(before: dict, after: dict
                   ) -> Dict[Tuple[str, Tuple], float]:
    """Counter growth between two registry snapshots, keyed on
    ``(name, sorted label items)``; unchanged series are left out."""
    def flat(snap):
        return {(name, tuple(sorted(s["labels"].items()))): s["value"]
                for name, samples in snap["counters"].items()
                for s in samples}
    a, b = flat(before), flat(after)
    return {k: v - a.get(k, 0) for k, v in b.items()
            if v != a.get(k, 0)}
