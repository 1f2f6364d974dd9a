"""Reduce a `torch.profiler` trace of one traced slice to what the
result line and the per-layer readers take.

The slice's bounds are read from the wall clock, on which the
profiler's events are stamped; the benchmark's own spans around calls
into the program are annotations named ``crdtbench.<layer>`` (the
profiler records them on the thread that started it). Device events are
grouped by card, and each is tied to the host time of the call that
launched it, so that device work is attributed to the benchmark span
that issued it, whenever the device runs it. The reduction is plain
arithmetic on ``(card, name, start, end, launch)`` tuples so that the
CPU tests can hold it to hand-worked cases.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

SPAN_PREFIX = "crdtbench."
OUTSIDE = "host outside the benchmark's spans"

#: card, name, start us, end us, host launch us (None: not known)
DeviceEvent = Tuple[int, str, float, float, Optional[float]]
Annotation = Tuple[str, float, float]          # name, start us, end us


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of ``[start, end)`` intervals, as disjoint sorted ones."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(busy: Sequence[Tuple[float, float]], w0: float, w1: float
         ) -> List[Tuple[float, float]]:
    """The parts of ``[w0, w1)`` that no busy interval covers."""
    out, t = [], w0
    for s, e in busy:
        if s > t:
            out.append((t, min(s, w1)))
        t = max(t, e)
        if t >= w1:
            break
    if t < w1:
        out.append((t, w1))
    return [(s, e) for s, e in out if e > s]


def _namer(spans: Sequence[Annotation]):
    """A function from a time to the innermost benchmark span holding
    it, or `OUTSIDE`."""
    spans = sorted(spans, key=lambda a: a[1])
    starts = [a[1] for a in spans]

    def name_at(t: float) -> str:
        best: Optional[Annotation] = None
        i = bisect.bisect_right(starts, t)
        # Spans nest or follow each other, so a holder starts at or
        # before t; scan back while one could still hold it.
        for a in reversed(spans[max(0, i - 64):i]):
            if a[1] <= t < a[2] and (best is None
                                     or a[2] - a[1] < best[2] - best[1]):
                best = a
        return best[0] if best is not None else OUTSIDE

    return name_at


def reduce(device_events: Sequence[DeviceEvent],
           annotations: Sequence[Annotation], cards: int, w0: float,
           w1: float) -> dict:
    """The numbers of the slice ``[w0, w1)`` (us). Times in seconds;
    lists are indexed by card. ``launched_s[span][card]`` is the device
    time of the ops launched inside a span of that name (the innermost
    holding the launch); ``unlinked`` counts each card's ops whose
    launch is not known."""
    spans = [a for a in annotations if w0 <= a[1] < w1]
    name_at = _namer(spans)
    per_card: Dict[int, List[Tuple[float, float]]] = defaultdict(list)
    by_span: Dict[str, Dict[int, List[Tuple[float, float]]]] = \
        defaultdict(lambda: defaultdict(list))
    ops = [0] * cards
    unlinked = [0] * cards
    nccl = [0.0] * cards
    by_name: Dict[str, float] = defaultdict(float)
    for card, name, s, e, launch in device_events:
        if not 0 <= card < cards:
            continue
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        per_card[card].append((s, e))
        ops[card] += 1
        by_name[name] += (e - s) / 1e6
        if "nccl" in name.lower():
            nccl[card] += (e - s) / 1e6
        if launch is None:
            unlinked[card] += 1
        else:
            by_span[name_at(launch)][card].append((s, e))
    busy_iv = [union(per_card[c]) for c in range(cards)]
    busy = [sum(e - s for s, e in iv) / 1e6 for iv in busy_iv]
    launched = {span: [sum(e - s for s, e in union(iv[c])) / 1e6
                       for c in range(cards)]
                for span, iv in by_span.items()}
    idle: Dict[str, float] = defaultdict(float)
    for s, e in gaps(busy_iv[0], w0, w1):
        idle[name_at((s + e) / 2)] += (e - s) / 1e6

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:10]]

    return dict(window_s=(w1 - w0) / 1e6, busy_s=busy, device_ops=ops,
                nccl_s=nccl, top_device_ops=top(by_name),
                idle_gaps=top(idle), launched_s=launched, unlinked=unlinked)


def _annotation(e) -> bool:
    """Whether a kineto event is a named range (on the host, or the
    profiler's mirror of it on the device timeline), where this torch
    build says so."""
    f = getattr(e, "activity_type", None)
    if f is not None:
        return "annotation" in f()
    f = getattr(e, "is_user_annotation", None)
    return bool(f()) if f is not None else False


def _launch_call(e) -> bool:
    """Whether a host-side kineto event is a CUDA runtime or driver call
    (the launch a device event's correlation id names), by its type
    where the build says it (torch 2.11's events do not), else by its
    name."""
    f = getattr(e, "activity_type", None)
    if f is not None:
        kind = f()
        return "runtime" in kind or "driver" in kind
    return e.name().startswith(("cuda", "cu"))


def from_profiler(prof, cards: int, w0: float, w1: float) -> dict:
    """`reduce` over a finished `torch.profiler.profile`, read from its
    raw kineto events (building the profiler's event tree would take
    seconds per hundred thousand events). Device events are the card's
    kernels, copies and fills: the profiler's mirror of a host range on
    the device timeline (``gpu_user_annotation``, named as the range) is
    no work. It is left out by its type where the build says it, and by
    its name, which is a host event's and never a kernel's. A device
    event's launch is the runtime or driver call with its correlation
    id, or else the host op it is linked to."""
    from torch.autograd import DeviceType
    dev, ann, host_names = [], [], set()
    calls, ops = {}, {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        s = e.start_ns() / 1e3
        t = s + e.duration_ns() / 1e3
        if e.device_type() == DeviceType.CUDA:
            if not _annotation(e):
                dev.append((e.device_index(), name, s, t,
                            e.correlation_id(), e.linked_correlation_id()))
            continue
        host_names.add(name)
        if _launch_call(e):
            calls[e.correlation_id()] = s
        else:
            ops[e.correlation_id()] = s
        if name.startswith(SPAN_PREFIX):
            ann.append((name, s, t))
    dev = [(card, name, s, t, calls.get(corr, ops.get(linked)))
           for card, name, s, t, corr, linked in dev
           if name not in host_names]
    return reduce(dev, ann, cards, w0, w1)
