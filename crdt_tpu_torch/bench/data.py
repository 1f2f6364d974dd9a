"""Seeded benchmark data and the result line, on the port's devices.

The port's own copy of ``bench.py``'s generators (the root module
imports jax): `_MILLIS` and `CONFIGS` (``bench.py:52``, ``:153``),
`make_changeset` with its knobs (``:55``), `make_changeset_fast`
(``:85``) and `result_dict` (``:2986``, the metric names kept,
``platform`` the device's name). Data comes from an explicit
``torch.Generator`` on the given device: the same distributions as
``jax.random`` gives there, not the same bits, so tests feed both
packages lanes made with numpy instead.
"""

from __future__ import annotations

import torch

from ..hlc import SHIFT
from ..utils.devices import resolve_device
from ..ops.dense import DenseChangeset

TARGET = 100e6  # merges/s north star (BASELINE.json)
_MILLIS = 1_700_000_000_000

# BASELINE.json stress configs as changeset knobs (see make_changeset).
CONFIGS = {
    "fanin": dict(),
    "tombstone": dict(tomb_ratio=0.5),
    "tiebreak": dict(millis_spread=1, counter_spread=2),
}


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def make_changeset(rc: int, n: int, seed: int, tomb_ratio: float = 0.3,
                   millis_spread: int = 1000, counter_spread: int = 4,
                   fill: float = 0.8, device=None) -> DenseChangeset:
    """A random ``[rc, n]`` changeset on ``device`` (``None``: the card).
    Defaults model the realistic sparse-delta shape (writers 1..8, 30%
    tombstones, 80% fill); the knobs give the stress configs:
    ``tomb_ratio=0.5`` is tombstone-heavy, ``millis_spread=1,
    counter_spread=2`` makes most records collide on logicalTime and
    resolve by node ordinal. The payload is the lt, as in ``bench.py``
    (its content does not change the join's cost)."""
    dev = resolve_device(device)
    g = _generator(seed, dev)
    shape = (rc, n)
    lt = (((_MILLIS + torch.randint(0, millis_spread, shape, generator=g,
                                    device=dev)) << SHIFT)
          + torch.randint(0, counter_spread, shape, generator=g,
                          device=dev))
    node = torch.randint(1, 9, shape, generator=g, device=dev,
                         dtype=torch.int32)
    tomb = torch.rand(shape, generator=g, device=dev) < tomb_ratio
    valid = torch.rand(shape, generator=g, device=dev) < fill
    return DenseChangeset(lt=lt, node=node, val=lt.clone(), tomb=tomb,
                          valid=valid)


def make_changeset_fast(rc: int, n: int, seed: int, device=None
                        ) -> DenseChangeset:
    """`make_changeset`'s defaults from ONE draw of 32-bit words per lane
    pair: ~1000-ms millis spread, 4 counter values, 8 writers, ~30%
    tombstones (77/256), ~80% fill (205/256)."""
    dev = resolve_device(device)
    b1, b2 = torch.randint(0, 1 << 32, (2, rc, n),
                           generator=_generator(seed, dev), device=dev)
    lt = ((_MILLIS + b1 % 1000) << SHIFT) + (b2 & 3)
    return DenseChangeset(
        lt=lt, node=(1 + ((b2 >> 2) & 7)).to(torch.int32), val=lt.clone(),
        tomb=((b2 >> 5) & 0xFF) < 77, valid=((b2 >> 13) & 0xFF) < 205)


def device_name(device: torch.device) -> str:
    """The name a result line carries: the card's, or ``"cpu"``."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def result_dict(metric: str, merges: int, secs: float,
                path: str = None, platform: str = None) -> dict:
    """The one-line JSON result of ``bench.py``: ``value`` merges/s and
    the ratio to the 100M merges/s target; ``path`` and ``platform``
    say what produced it."""
    out = {"metric": metric, "value": round(merges / secs, 1),
           "unit": "merges/s",
           "vs_baseline": round(merges / secs / TARGET, 3)}
    if path is not None:
        out["path"] = path
    if platform is not None:
        out["platform"] = platform
    return out
