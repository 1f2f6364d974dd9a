"""Mesh collectives: ``pmax``, ``pmin``, ``psum`` and ``all_gather``
over the positions of a mesh, each position holding one tensor on its
own device.

The JAX package writes its group join and its sharded combine with
XLA's collectives under ``shard_map`` (``jax.lax.pmax`` and the rest),
one program per device. The port is one controller, so it reduces in
two levels:

1. **Within a group**, the positions that share a device: their blocks
   are stacked ``[g, ...]`` on that device and reduced over dim 0, one
   torch op. On one card (and on the CPU) every position is in one
   group and this is the whole collective.
2. **Across groups**, one partial per group: ``torch.cuda.nccl``'s
   single-process collectives over the distinct CUDA cards (route
   ``"nccl"``), or the funnel (route ``"funnel"``): every partial copied
   to the first group's device with ``.to()``, reduced there, and the
   result copied back. The funnel is the plain twin the card is held
   against, the route of a build without NCCL, and the route of
   groups declared on one device (the CPU tests).

The route follows from the layout, never from a caught error:
``"local"`` for one group, ``"nccl"`` where every group sits on its own
CUDA card and torch was built with NCCL, else ``"funnel"``;
``funnel=True`` asks for the funnel on cards too.

NCCL notes. `torch.cuda.nccl` exports only ``SUM``; ``MAX`` and
``MIN`` are ``ncclRedOp_t``'s values. NCCL has no bool type: bool blocks
travel as ``uint8`` views (a max of 0 / 1 is an OR). Each card's input
is contiguous, and all have one shape and dtype. Torch builds and
caches one communicator per list of devices on its first call, so a
timed loop warms it first. Each op is enqueued on every card's current
stream, after the work already queued there.

`lex_winner` is the one collective step both callers share: the
lexicographic ``(lt, node)`` max and the lowest rank holding it.

``TALLY`` counts calls and payload bytes by route (``nccl_calls``,
``nccl_bytes_a_card``, ``funnel_calls``, ``funnel_bytes``: the bytes the
funnel's copies move between groups).
"""

from __future__ import annotations

import collections
import functools
from typing import Dict, List, Optional, Sequence

import torch

from ..ops.dense import _I32_NEG

#: ``ncclRedOp_t`` values: `torch.cuda.nccl` names only SUM.
SUM, MAX, MIN = 0, 2, 3

#: The rank a position that does not hold the lex max offers to the
#: stable min-rank tie (parallel/fanin.py:89 of the JAX package).
_BIG_RANK = 2 ** 30

#: Calls and bytes by route; `reset_tally` clears it.
TALLY: Dict[str, int] = collections.Counter()


def reset_tally() -> None:
    TALLY.clear()


def nccl_built() -> bool:
    """Was this torch built with NCCL (the single-process collectives)?"""
    return hasattr(torch._C, "_nccl_all_reduce")


def _concrete(device) -> torch.device:
    """``cuda`` without an index is the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class Layout:
    """Positions ``0 .. P-1`` (the collective's ranks, in order) grouped
    for the two-level reduction. ``devices[p]`` is position ``p``'s
    device; ``labels[p]`` its group key (default: its device), so
    positions with equal labels form one group, which must share one
    device. Groups are numbered in order of their first position, so
    group 0 holds rank 0. ``funnel=True`` takes the funnel across
    groups even where NCCL could run."""

    def __init__(self, devices: Sequence, labels: Optional[Sequence] = None,
                 funnel: bool = False):
        devices = [_concrete(d) for d in devices]
        labels = devices if labels is None else list(labels)
        if len(labels) != len(devices):
            raise ValueError(f"{len(labels)} group labels for "
                             f"{len(devices)} positions")
        index: dict = {}
        self.groups: List[List[int]] = []
        self.devices: List[torch.device] = []
        for p, (dev, label) in enumerate(zip(devices, labels)):
            if label not in index:
                index[label] = len(self.groups)
                self.groups.append([])
                self.devices.append(dev)
            g = index[label]
            if self.devices[g] != dev:
                raise ValueError(
                    f"group {label!r} spans {self.devices[g]} and {dev}: "
                    "a group's positions share one device")
            self.groups[g].append(p)
        self.size = len(devices)
        distinct_cards = (all(d.type == "cuda" for d in self.devices)
                          and len(set(self.devices)) == len(self.devices))
        if len(self.groups) == 1:
            self.route = "local"
        elif distinct_cards and nccl_built() and not funnel:
            self.route = "nccl"
        else:
            self.route = "funnel"

    @functools.cached_property
    def ranks(self) -> List[torch.Tensor]:
        """Each group's ranks, ``int32[g, 1]`` on its device (broadcast
        against a ``[g, N]`` block)."""
        return [torch.tensor(ps, dtype=torch.int32, device=d)[:, None]
                for ps, d in zip(self.groups, self.devices)]

    @functools.cached_property
    def _gather_order(self) -> List[int]:
        """Row of rank ``p`` in the groups' blocks laid end to end, each
        padded to the largest group (NCCL's all_gather takes equal
        shapes; the funnel lays them out alike)."""
        width = max(len(g) for g in self.groups)
        row = {}
        for j, ps in enumerate(self.groups):
            for s, p in enumerate(ps):
                row[p] = j * width + s
        return [row[p] for p in range(self.size)]

    def stack(self, per_position: Sequence[torch.Tensor]
              ) -> List[torch.Tensor]:
        """Each group's block ``[g, ...]``: its positions' tensors stacked
        on its device (a view, not a copy, for a group of one)."""
        out = []
        for ps, dev in zip(self.groups, self.devices):
            if len(ps) == 1:
                out.append(per_position[ps[0]].to(dev).unsqueeze(0))
            else:
                out.append(torch.stack([per_position[p].to(dev)
                                        for p in ps]))
        return out


# --- the two levels ----------------------------------------------------------


def _local(block: torch.Tensor, op: int) -> torch.Tensor:
    """The group's partial: ``block`` reduced over dim 0."""
    if block.shape[0] == 1:
        return block[0]
    if block.dtype == torch.bool:
        return block.any(0) if op != MIN else block.all(0)
    if op == MAX:
        return block.amax(0)
    if op == MIN:
        return block.amin(0)
    return block.sum(0, dtype=block.dtype)


def _wire(t: torch.Tensor) -> torch.Tensor:
    """A contiguous NCCL operand: bool as its uint8 view."""
    t = t.contiguous()
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def _all_reduce(layout: Layout, blocks: Sequence[torch.Tensor],
                op: int) -> List[torch.Tensor]:
    parts = [_local(b, op) for b in blocks]
    if layout.route == "local":
        return parts
    if layout.route == "nccl":
        ins = [_wire(p) for p in parts]
        outs = [torch.empty_like(x) for x in ins]
        torch.cuda.nccl.all_reduce(ins, outs, op=op)
        TALLY["nccl_calls"] += 1
        TALLY["nccl_bytes_a_card"] += ins[0].numel() * ins[0].element_size()
        return [o.view(p.dtype) for o, p in zip(outs, parts)]
    return _funnel(layout, parts, lambda x: _local(x, op))


def _funnel(layout: Layout, parts: Sequence[torch.Tensor], fold
            ) -> List[torch.Tensor]:
    """The plain cross-group step: every partial to the first group's
    device, ``fold`` over the stack there, the result back to each
    group's device."""
    home = layout.devices[0]
    out = fold(torch.stack([p.to(home) for p in parts]))
    away = [p for p, d in zip(parts, layout.devices) if d != home]
    TALLY["funnel_calls"] += 1
    TALLY["funnel_bytes"] += sum(p.nbytes + out.nbytes for p in away)
    return [out.to(d) for d in layout.devices]


def pmax(layout: Layout, blocks: Sequence[torch.Tensor]
         ) -> List[torch.Tensor]:
    """The elementwise max over every position, given each group's block
    ``[g, ...]``: the result ``[...]`` on each group's device."""
    return _all_reduce(layout, blocks, MAX)


def pmin(layout: Layout, blocks: Sequence[torch.Tensor]
         ) -> List[torch.Tensor]:
    """The elementwise min over every position (see `pmax`)."""
    return _all_reduce(layout, blocks, MIN)


def psum(layout: Layout, blocks: Sequence[torch.Tensor]
         ) -> List[torch.Tensor]:
    """The elementwise sum over every position, in the blocks' dtype
    (see `pmax`). Bool blocks sum as uint8."""
    if blocks[0].dtype == torch.bool:
        blocks = [b.to(torch.uint8) for b in blocks]
    return _all_reduce(layout, blocks, SUM)


def all_gather(layout: Layout, blocks: Sequence[torch.Tensor]
               ) -> List[torch.Tensor]:
    """Every position's tensor in rank order, ``[P, ...]``, on each
    group's device."""
    width = max(b.shape[0] for b in blocks)
    if layout.route == "local":
        return [blocks[0]]
    padded = [b if b.shape[0] == width else torch.cat(
        [b, b.new_zeros((width - b.shape[0],) + b.shape[1:])])
        for b in blocks]
    order = layout._gather_order
    in_order = order == list(range(layout.size))
    if layout.route == "nccl":
        ins = [_wire(b) for b in padded]
        outs = [x.new_empty((len(ins) * width,) + x.shape[1:])
                for x in ins]
        torch.cuda.nccl.all_gather(ins, outs)
        TALLY["nccl_calls"] += 1
        TALLY["nccl_bytes_a_card"] += ins[0].numel() * ins[0].element_size()
        outs = [o.view(blocks[0].dtype) for o in outs]
        if in_order:
            return outs
        return [o[torch.tensor(order, device=o.device)] for o in outs]
    return _funnel(layout, padded, lambda x: x.flatten(0, 1)[
        torch.tensor(order, device=x.device)])


def lex_winner(layout: Layout, lt: Sequence[torch.Tensor],
               node: Sequence[torch.Tensor]):
    """The lexicographic ``(lt, node)`` max over every position and the
    lowest rank holding it: a ``pmax`` of lt, a ``pmax`` of node where
    lt is the max, then a ``pmin`` of the ranks holding both. ``lt`` and
    ``node`` are each group's ``[g, N]`` blocks, absent entries already
    masked below every real record. Returns ``(m1, m2, mine)``: the
    max's lt and node (``[N]`` on each group's device) and each group's
    ``[g, N]`` one-hot mask of the winning position."""
    m1 = pmax(layout, lt)
    m2 = pmax(layout, [torch.where(x == m, n, _I32_NEG)
                       for x, m, n in zip(lt, m1, node)])
    has = [(x == a) & (n == b) for x, a, n, b in zip(lt, m1, node, m2)]
    winner = pmin(layout, [torch.where(h, r, _BIG_RANK)
                           for h, r in zip(has, layout.ranks)])
    mine = [h & (r == w) for h, r, w in zip(has, layout.ranks, winner)]
    return m1, m2, mine
