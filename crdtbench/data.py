"""Seeded peer changesets, frozen here so that the yardstick does not
move with the program.

A copy of ``crdt_tpu_torch/bench/data.py``'s `make_changeset_fast`
(itself ``bench.py``'s generator): 1000 ms of millis spread, 4 counter
values, writers 1..8, about 30% tombstones (77/256) and 80% fill
(205/256), the payload equal to the logical time. It returns the five
lanes as a plain dict of tensors; the driver wraps them in the
program's changeset type.
"""

from __future__ import annotations

from typing import Dict

import torch

SHIFT = 16                      # HLC counter bits (hlc.dart)
MILLIS = 1_700_000_000_000      # bench.py's _MILLIS
LANES = ("lt", "node", "val", "tomb", "valid")


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def changeset(rows: int, n: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """A ``[rows, n]`` changeset from one draw of 32-bit words per lane
    pair, on ``device``."""
    b1, b2 = torch.randint(0, 1 << 32, (2, rows, n),
                           generator=generator(seed, device), device=device)
    lt = ((MILLIS + b1 % 1000) << SHIFT) + (b2 & 3)
    return dict(lt=lt, node=(1 + ((b2 >> 2) & 7)).to(torch.int32),
                val=lt.clone(), tomb=((b2 >> 5) & 0xFF) < 77,
                valid=((b2 >> 13) & 0xFF) < 205)


def sub_seed(seed: int, k: int) -> int:
    """The ``k``-th derived seed of a run's seed, inside 63 bits."""
    return (seed * 1_000_003 + k * 7_919 + 12_345) % (1 << 62)
