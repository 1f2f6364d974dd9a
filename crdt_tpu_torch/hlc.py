"""Hybrid Logical Clock — the causality primitive (L0).

Scalar/host implementation of the HLC per Kulkarni et al.
(https://cse.buffalo.edu/tech-reports/2014-04.pdf), semantically matching
the reference `lib/src/hlc.dart:1-189`:

- ``Hlc`` immutable value type ``(millis, counter, node_id)`` with
  ``logical_time = (millis << 16) | counter`` (hlc.dart:16).
- ``Hlc.send`` / ``Hlc.recv`` clock-update algorithms (hlc.dart:51-97).
- Total order: logical_time, then node_id (hlc.dart:158-161).
- String codecs: ISO8601 human codec (hlc.dart:39-46,102-104), fixed-width
  sortable base36 ``pack``/``unpack`` (hlc.dart:110-127), secure
  ``random_node_id`` (hlc.dart:129-141).
- Three exception types (hlc.dart:164-189).

The device path never manipulates this object per-record: clocks are
packed into (int64 logical_time, int32 node ordinal) lanes — see
``crdt_tpu_torch.ops.packing``. This module is the semantic oracle and
the host-side boundary (wall-clock reads and exception raising live
here, outside any kernel). It is a copy of ``crdt_tpu/hlc.py``: the
port imports nothing of the JAX package.
"""

from __future__ import annotations

import re
import secrets
import time
from datetime import datetime, timezone
from typing import (Any, Callable, Generic, List, Optional, Tuple,
                    TypeVar)

T = TypeVar("T")

SHIFT = 16
MAX_COUNTER = 0xFFFF
MAX_DRIFT = 60_000  # 1 minute in ms (hlc.dart:5)

# millis >= this threshold are auto-detected as microseconds (hlc.dart:23)
MICROS_THRESHOLD = 0x0001_0000_0000_0000

_BASE36_DIGITS = "0123456789abcdefghijklmnopqrstuvwxyz"


def wall_clock_millis() -> int:
    """Host wall clock in milliseconds (the DateTime.now() boundary)."""
    return time.time_ns() // 1_000_000


def to_base36(n: int) -> str:
    """Integer to lowercase base36, matching Dart's toRadixString(36)."""
    if n == 0:
        return "0"
    neg = n < 0
    n = abs(n)
    out = []
    while n:
        n, r = divmod(n, 36)
        out.append(_BASE36_DIGITS[r])
    return ("-" if neg else "") + "".join(reversed(out))


def _civil_from_days(z: int):
    """Epoch day -> (year, month, day), proleptic Gregorian (Howard
    Hinnant's civil_from_days — branchless integer math, no datetime)."""
    z += 719468
    era = (z if z >= 0 else z - 146096) // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = mp + (3 if mp < 10 else -9)
    return y + (m <= 2), m, d


_CANONICAL_ISO = re.compile(
    r"\A(\d{4})-(\d{2})-(\d{2})T(\d{2}):(\d{2}):(\d{2})\.(\d{3})Z\Z",
    re.ASCII)

_DAYS_IN_MONTH = (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)


def _days_in_month(y: int, m: int) -> int:
    if m == 2 and (y % 4 == 0 and (y % 100 != 0 or y % 400 == 0)):
        return 29
    return _DAYS_IN_MONTH[m - 1]


def _days_from_civil(y: int, m: int, d: int) -> int:
    """(year, month, day) -> epoch day (inverse of `_civil_from_days`)."""
    y -= m <= 2
    era = (y if y >= 0 else y - 399) // 400
    yoe = y - era * 400
    doy = (153 * (m + (-3 if m > 2 else 9)) + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def _iso8601(millis: int) -> str:
    """UTC ISO-8601 with exactly 3 fractional digits and 'Z' suffix,
    matching Dart's DateTime.toIso8601String() for millisecond-precision
    UTC times (hlc.dart:102). Years outside 1-9999 raise (the datetime
    range every parser in the system accepts) — emitting them would
    poison the wire for all peers."""
    secs, ms = divmod(millis, 1000)
    days, sod = divmod(secs, 86400)
    y, mo, d = _civil_from_days(days)
    if not 1 <= y <= 9999:
        raise ValueError(f"year {y} out of range for the wire codec")
    h, rem = divmod(sod, 3600)
    mi, s = divmod(rem, 60)
    return (f"{y:04d}-{mo:02d}-{d:02d}T{h:02d}:{mi:02d}:{s:02d}"
            f".{ms:03d}Z")


_EPOCH = datetime(1970, 1, 1, tzinfo=timezone.utc)


def _parse_iso_millis(s: str) -> int:
    """Parse an ISO-8601 timestamp to epoch millis, accepting the formats
    Dart's DateTime.parse accepts in practice for this codec ('T' or space
    separator, optional fractional seconds, 'Z' or a UTC offset).

    The canonical 24-char wire shape `YYYY-MM-DDTHH:MM:SS.mmmZ` (exactly
    what `_iso8601` emits) takes a no-datetime fast path — it dominates
    every wire ingest. The fast path validates shape AND calendar
    ranges (ASCII digits only, real month/day, 24h clock); anything
    else falls through to the strict general parser."""
    m = _CANONICAL_ISO.match(s)
    if m is not None:
        y, mo, d, h, mi, sec, ms = map(int, m.groups())
        if (1 <= mo <= 12 and 1 <= d <= _days_in_month(y, mo)
                and h < 24 and mi < 60 and sec < 60):
            days = _days_from_civil(y, mo, d)
            return ((days * 86400 + h * 3600 + mi * 60 + sec) * 1000
                    + ms)
    iso = s.strip().replace(" ", "T")
    if iso.endswith(("Z", "z")):   # fromisoformat grew 'Z' in py3.11
        iso = iso[:-1] + "+00:00"
    dt = datetime.fromisoformat(iso)
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=timezone.utc)
    delta = dt - _EPOCH
    micros = (delta.days * 86_400_000_000 + delta.seconds * 1_000_000
              + delta.microseconds)
    return micros // 1000


class ClockDriftException(Exception):
    """Clock drift beyond MAX_DRIFT (hlc.dart:164-171)."""

    def __init__(self, millis_ts: int, millis_wall: int):
        self.drift = millis_ts - millis_wall
        super().__init__(
            f"Clock drift of {self.drift} ms exceeds maximum ({MAX_DRIFT})")


class OverflowException(Exception):
    """HLC counter overflow past 16 bits (hlc.dart:173-180)."""

    def __init__(self, counter: int):
        self.counter = counter
        super().__init__(f"Timestamp counter overflow: {counter}")


class DuplicateNodeException(Exception):
    """Two replicas share a node id (hlc.dart:182-189)."""

    def __init__(self, node_id: str):
        self.node_id = node_id
        super().__init__(f"Duplicate node: {node_id}")


class Hlc(Generic[T]):
    """Immutable hybrid logical timestamp (hlc.dart:11-161).

    Total order is ``(logical_time, node_id)``; node ids must be mutually
    comparable (strings in the common case).
    """

    __slots__ = ("millis", "counter", "node_id")

    def __init__(self, millis: int, counter: int, node_id: T):
        assert counter <= MAX_COUNTER
        assert node_id is not None
        # Detect microseconds and convert to millis (hlc.dart:23)
        object.__setattr__(
            self, "millis",
            millis if millis < MICROS_THRESHOLD else millis // 1000)
        object.__setattr__(self, "counter", counter)
        object.__setattr__(self, "node_id", node_id)

    def __setattr__(self, name: str, value: Any) -> None:
        raise AttributeError("Hlc is immutable")

    def __copy__(self) -> "Hlc[T]":
        return self

    def __deepcopy__(self, memo: Any) -> "Hlc[T]":
        return self

    def __reduce__(self):
        return (Hlc, (self.millis, self.counter, self.node_id))

    # --- constructors (hlc.dart:25-46) ---

    @classmethod
    def zero(cls, node_id: T) -> "Hlc[T]":
        return cls(0, 0, node_id)

    @classmethod
    def from_date(cls, dt: datetime, node_id: T) -> "Hlc[T]":
        if dt.tzinfo is None:
            dt = dt.replace(tzinfo=timezone.utc)
        delta = dt - _EPOCH
        micros = (delta.days * 86_400_000_000 + delta.seconds * 1_000_000
                  + delta.microseconds)
        return cls(micros // 1000, 0, node_id)

    @classmethod
    def now(cls, node_id: T, millis: Optional[int] = None) -> "Hlc[T]":
        return cls(wall_clock_millis() if millis is None else millis, 0,
                   node_id)

    @classmethod
    def from_logical_time(cls, logical_time: int, node_id: T) -> "Hlc[T]":
        return cls(logical_time >> SHIFT, logical_time & MAX_COUNTER, node_id)

    @classmethod
    def _raw(cls, millis: int, counter: int, node_id: T) -> "Hlc[T]":
        """Unchecked fast construction for batch decode loops (values
        already validated lane-side: counter fits 16 bits, millis is
        genuine millis). ~3x cheaper than ``__init__`` at the 1M-record
        export scales where Hlc construction dominates."""
        h = cls.__new__(cls)
        s = object.__setattr__
        s(h, "millis", millis)
        s(h, "counter", counter)
        s(h, "node_id", node_id)
        return h

    @classmethod
    def parse(cls, timestamp: str,
              id_decoder: Optional[Callable[[str], T]] = None) -> "Hlc[T]":
        """Parse '<iso8601>-<4-hex-counter>-<nodeId>' (hlc.dart:39-46).

        Mirrors the reference scan: first dash after the last ':' ends the
        ISO time; the next dash ends the counter; the rest is the node id
        (which may itself contain dashes).
        """
        counter_dash = timestamp.index("-", timestamp.rfind(":"))
        node_id_dash = timestamp.index("-", counter_dash + 1)
        millis = _parse_iso_millis(timestamp[:counter_dash])
        counter = int(timestamp[counter_dash + 1:node_id_dash], 16)
        node_id = timestamp[node_id_dash + 1:]
        return cls(millis, counter,
                   id_decoder(node_id) if id_decoder is not None else node_id)

    # --- derived views ---

    @property
    def logical_time(self) -> int:
        return (self.millis << SHIFT) + self.counter

    def copy_with(self, millis: Optional[int] = None,
                  counter: Optional[int] = None,
                  node_id: Optional[T] = None) -> "Hlc[T]":
        return Hlc(self.millis if millis is None else millis,
                   self.counter if counter is None else counter,
                   self.node_id if node_id is None else node_id)

    apply = copy_with

    # --- clock algorithms (hlc.dart:51-97) ---

    @classmethod
    def send(cls, canonical: "Hlc[T]",
             millis: Optional[int] = None) -> "Hlc[T]":
        """Monotonic local-event stamping (hlc.dart:51-74)."""
        if millis is None:
            millis = wall_clock_millis()

        millis_old = canonical.millis
        counter_old = canonical.counter

        millis_new = max(millis_old, millis)
        counter_new = counter_old + 1 if millis_old == millis_new else 0

        if millis_new - millis > MAX_DRIFT:
            raise ClockDriftException(millis_new, millis)
        if counter_new > MAX_COUNTER:
            raise OverflowException(counter_new)

        return cls(millis_new, counter_new, canonical.node_id)

    @classmethod
    def send_batch(cls, canonical: "Hlc[T]", count: int,
                   millis: Optional[int] = None
                   ) -> Tuple["Hlc[T]", List[int]]:
        """``count`` successive ``send`` stamps from ONE wall read —
        the write-combiner flush stamp (docs/INGEST.md).

        Equivalent to ``count`` sequential :meth:`send` calls under a
        frozen wall clock: every stamp shares
        ``max(canonical.millis, millis)`` and the counters run
        consecutively, so the stamps are strictly monotonic in batch
        order and each later stamp dominates every earlier one.
        Raises the same exceptions ``send`` would — drift before the
        first stamp, overflow when the counter run would pass 16 bits
        (nothing is stamped on either raise).

        Returns ``(new_canonical, logical_times)`` with
        ``new_canonical == from_logical_time(logical_times[-1], ...)``.
        """
        if count <= 0:
            raise ValueError(f"send_batch needs count >= 1; got {count}")
        if millis is None:
            millis = wall_clock_millis()
        millis_new = max(canonical.millis, millis)
        start = canonical.counter + 1 if canonical.millis == millis_new \
            else 0
        if millis_new - millis > MAX_DRIFT:
            raise ClockDriftException(millis_new, millis)
        if start + count - 1 > MAX_COUNTER:
            raise OverflowException(start + count - 1)
        base = millis_new << SHIFT
        lts = [base + c for c in range(start, start + count)]
        return (cls(millis_new, start + count - 1, canonical.node_id),
                lts)

    @classmethod
    def recv(cls, canonical: "Hlc[T]", remote: "Hlc",
             millis: Optional[int] = None) -> "Hlc[T]":
        """Remote-timestamp ingestion (hlc.dart:80-97).

        Fast path (canonical >= remote) returns canonical unchanged and
        SKIPS the duplicate-node check — reference parity (hlc.dart:85).
        """
        if millis is None:
            millis = wall_clock_millis()

        if canonical.logical_time >= remote.logical_time:
            return canonical

        if canonical.node_id == remote.node_id:
            raise DuplicateNodeException(str(canonical.node_id))
        if remote.millis - millis > MAX_DRIFT:
            raise ClockDriftException(remote.millis, millis)

        return cls.from_logical_time(remote.logical_time, canonical.node_id)

    # --- codecs (hlc.dart:99-141) ---

    def to_json(self) -> str:
        return str(self)

    def __str__(self) -> str:
        return (f"{_iso8601(self.millis)}"
                f"-{self.counter:04X}"
                f"-{self.node_id}")

    def __repr__(self) -> str:
        return f"Hlc({self})"

    def pack(self) -> str:
        """Fixed-width sortable codec: 10-char base36 millis + 4-char
        base36 counter + nodeId (hlc.dart:110-121)."""
        return (to_base36(self.millis).rjust(10, "0")[:10] +
                to_base36(self.counter).rjust(4, "0")[:4] +
                str(self.node_id))

    @staticmethod
    def unpack(packed: str) -> "Hlc[str]":
        return Hlc(int(packed[0:10], 36), int(packed[10:14], 36), packed[14:])

    @staticmethod
    def random_node_id() -> str:
        """10-char base36 secure random node id (hlc.dart:129-141)."""
        seed_a = to_base36(secrets.randbelow(4294967296))
        seed_b = to_base36(secrets.randbelow(4294967296))
        return (seed_a + seed_b).rjust(10, "0")[:10]

    # --- total order (hlc.dart:143-161) ---

    def compare_to(self, other: "Hlc") -> int:
        lt, ot = self.logical_time, other.logical_time
        if lt != ot:
            return -1 if lt < ot else 1
        a, b = self.node_id, other.node_id
        if a == b:
            return 0
        return -1 if a < b else 1

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Hlc) and self.compare_to(other) == 0

    def __lt__(self, other: "Hlc") -> bool:
        return isinstance(other, Hlc) and self.compare_to(other) < 0

    def __le__(self, other: "Hlc") -> bool:
        return self < other or self == other

    def __gt__(self, other: "Hlc") -> bool:
        return isinstance(other, Hlc) and self.compare_to(other) > 0

    def __ge__(self, other: "Hlc") -> bool:
        return self > other or self == other

    def __hash__(self) -> int:
        # Field tuple, not hash(str(self)): equality is (logical_time,
        # node_id) order, which the fields determine exactly, and the
        # ISO-8601 render is ~6x the cost of a tuple hash — it shows
        # up on any path that caches by stamp (trace emit, dedupe).
        return hash((self.millis, self.counter, self.node_id))
