"""The per-lane semantics registry and its five shipped entries.

Port of ``crdt_tpu/semantics/types.py``. Each :class:`SemanticsSpec`
bundles what one lane type needs end to end: its wire ``tag`` (the
packed frame's optional ``sem`` lane and the store's per-slot semantics
column hold these; LWW is tag 0, so an untyped store is all-zeros and
the wire can omit the lane), a value codec (``encode`` / ``decode``)
between user values and the int64 lane form that
`crdt_tpu_torch.semantics.kernels` joins, and ``law_val``, the
type-canonical lane value of an event ``(lt, node)`` that seeded law
tests draw from.

The JAX package's specs also build an analysis law target and a jaxpr
audit target for its CI gate; this package has no analysis layer yet,
so ``law_target`` and ``audit_target`` are None here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from .kernels import (MVREG_MAX, ORSET_UNIVERSE, SEM_GCOUNTER, SEM_LWW,
                      SEM_MVREG, SEM_ORSET, SEM_PNCOUNTER, _PN_HALF)


@dataclass(frozen=True)
class SemanticsSpec:
    """One registered lane semantics. ``law_val(lt, node)`` maps HLC
    stamps to type-canonical lane values (vectorized numpy)."""

    name: str
    tag: int
    doc: str
    encode: Callable[[object], int]
    decode: Callable[[int], object]
    law_val: Callable[[object, object], object]
    law_target: Optional[Callable[[], object]] = None
    audit_target: Optional[Callable[[], object]] = None


_REGISTRY: Dict[str, SemanticsSpec] = {}
_BY_TAG: Dict[int, SemanticsSpec] = {}


def register(spec: SemanticsSpec) -> SemanticsSpec:
    """Add a semantics to the registry. Names and tags are unique;
    re-registering either is a programming error, not a merge."""
    if spec.name in _REGISTRY:
        raise ValueError(f"semantics {spec.name!r} already registered")
    if spec.tag in _BY_TAG:
        raise ValueError(
            f"semantics tag {spec.tag} already registered "
            f"({_BY_TAG[spec.tag].name!r})")
    if not 0 <= spec.tag <= 127:
        raise ValueError(f"semantics tag must fit int8/uint8 wire "
                         f"lanes; got {spec.tag}")
    _REGISTRY[spec.name] = spec
    _BY_TAG[spec.tag] = spec
    return spec


def get_semantics(name: str) -> SemanticsSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown semantics {name!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


def by_tag(tag: int) -> SemanticsSpec:
    try:
        return _BY_TAG[tag]
    except KeyError:
        raise KeyError(f"unknown semantics tag {tag}; registered: "
                       f"{sorted(_BY_TAG)}") from None


def all_semantics() -> List[SemanticsSpec]:
    return sorted(_REGISTRY.values(), key=lambda s: s.tag)


def names() -> List[str]:
    return [s.name for s in all_semantics()]


# --- codecs ---


def _lww_encode(v) -> int:
    return int(v)


def _gc_encode(v) -> int:
    v = int(v)
    if v < 0:
        raise ValueError(f"gcounter values are non-negative; got {v}")
    return v


def _pn_encode(v) -> int:
    """Absolute user value -> lane form: positive counts into the pos
    half, negative into the neg half."""
    v = int(v)
    mag = abs(v)
    if mag > _PN_HALF:
        raise ValueError(f"pncounter magnitude exceeds 31 bits: {v}")
    return (mag << 32) if v >= 0 else mag


def _pn_decode(lane: int) -> int:
    return ((int(lane) >> 32) & _PN_HALF) - (int(lane) & _PN_HALF)


def _orset_encode(elements) -> int:
    """A set of element indices -> lane with causal length 1 (present)
    for each member."""
    lane = 0
    for e in elements:
        e = int(e)
        if not 0 <= e < ORSET_UNIVERSE:
            raise ValueError(
                f"orset element out of universe "
                f"[0, {ORSET_UNIVERSE}): {e}")
        lane |= 1 << (4 * e)
    return lane


def _orset_decode(lane: int) -> frozenset:
    lane = int(lane)
    return frozenset(e for e in range(ORSET_UNIVERSE)
                     if ((lane >> (4 * e)) & 0xF) % 2 == 1)


def _mvreg_encode(v) -> int:
    v = int(v)
    if not 1 <= v <= MVREG_MAX:
        raise ValueError(
            f"mvreg values are 16-bit nonzero (1..{MVREG_MAX}); "
            f"got {v}")
    return v << 48


def _mvreg_decode(lane: int) -> Tuple[int, ...]:
    lane = int(lane)
    vals = [(lane >> s) & MVREG_MAX for s in (48, 32, 16, 0)]
    return tuple(v for v in vals if v)


def _spec(name: str, tag: int, doc: str, encode, decode,
          law_val) -> SemanticsSpec:
    return register(SemanticsSpec(name=name, tag=tag, doc=doc,
                                  encode=encode, decode=decode,
                                  law_val=law_val))


# --- the five shipped semantics ---

LWW = _spec(
    "lww", SEM_LWW,
    "last-writer-wins register: strict (lt, node) lex compare, the "
    "clock winner takes every lane (the seed semantics; tag 0 so an "
    "untyped store is all-zeros)",
    _lww_encode, _lww_encode,
    law_val=lambda lt, node: (lt * 31 + node * 7) & 0x7FFF)

GCOUNTER = _spec(
    "gcounter", SEM_GCOUNTER,
    "grow-only counter: non-negative int64, join = max; one lane per "
    "(counter, replica) realizes the classic dense G-counter",
    _gc_encode, _lww_encode,
    law_val=lambda lt, node: (lt * 13 + node * 5) & 0xFFFF)

PNCOUNTER = _spec(
    "pncounter", SEM_PNCOUNTER,
    "PN counter: pos half bits 32..62, neg half bits 0..30, join = "
    "per-half max, user value = pos - neg",
    _pn_encode, _pn_decode,
    law_val=lambda lt, node: (((lt * 11 + node * 3) & 0x3FFF) << 32)
                             | ((lt * 17 + node * 7) & 0x3FFF))

ORSET = _spec(
    "orset", SEM_ORSET,
    "observed-remove set via causal lengths: 16 elements x 4-bit "
    "length, join = per-nibble max, present iff length is odd; "
    "lengths saturate at 15",
    _orset_encode, _orset_decode,
    law_val=lambda lt, node: (lt * 2654435761 + node * 97)
                             & 0x7FFFFFFFFFFFFFFF)

MVREG = _spec(
    "mvreg", SEM_MVREG,
    "multi-value register: top-4 concurrent (equal-lt) 16-bit values "
    "packed descending; strictly newer lt replaces, equal lt unions",
    _mvreg_encode, _mvreg_decode,
    law_val=lambda lt, node: (((lt * 7 + node) & 0xFFFF) | 1) << 48)
