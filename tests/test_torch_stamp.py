"""The fan-in merge step's stamp (`ops.fanin_kernel._stamp`) and the
host syncs of a coarse pipelined step, on the CPU.

- `_stamp` writes the winners' ``modified`` lanes with a select on the
  device; its lanes and its `BatchResult` equal the fill it replaced
  (``masked_fill`` with the new canonical as a host int) bit for bit.
- The fused coarse steps (`pipelined_model_step`,
  `pipelined_model_step_split`) dispatch no op that reads a device
  value back to the host: no ``masked_fill`` whose value is a tensor
  (torch's CUDA kernel reads that value back), no ``item`` and no
  ``_local_scalar_dense``. The card counts the syncs themselves
  (``tests/test_torch_spans.py``, ``-m cuda``).

This file imports neither jax nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_stamp.py
"""

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from crdt_tpu_torch.hlc import MAX_COUNTER, MAX_DRIFT, SHIFT
from crdt_tpu_torch.ops import fanin_kernel as tk
from crdt_tpu_torch.ops.dense import (_NEG, DenseChangeset, DenseStore,
                                      empty_dense_store)
from crdt_tpu_torch.ops.split import split_changeset

from torch_threads import cap_torch_threads

cap_torch_threads()

N = 1024
R = 4
LOCAL = 2
WALL = 1_700_000_000_100
BASE = 1_700_000_000_000 << SHIFT
THRESH = ((WALL + MAX_DRIFT) << SHIFT) | MAX_COUNTER


def lanes(seed, n=N):
    """A half-occupied store and the kernel's outputs for it: a merged
    store's lanes, a win mask and the guard inputs."""
    g = torch.Generator().manual_seed(seed)

    def i64(lo, hi):
        return torch.randint(lo, hi, (n,), generator=g)

    occ = torch.rand(n, generator=g) < 0.5
    store = DenseStore(
        lt=BASE + i64(0, 1 << 20), node=i64(0, 4).int(),
        val=i64(-100, 100), mod_lt=BASE + i64(0, 1 << 20),
        mod_node=i64(0, 4).int(), occupied=occ,
        tomb=torch.rand(n, generator=g) < 0.2)
    merged = (BASE + i64(0, 1 << 20), i64(0, 4).int(), i64(-100, 100),
              torch.rand(n, generator=g) < 0.2, occ | (i64(0, 2) == 1))
    win = torch.rand(n, generator=g) < 0.4
    return store, merged, win


# (win, canonical, basemax) of each case; the lanes come from `lanes`.
STAMP_CASES = {
    "empty-win": (lambda w: torch.zeros_like(w), BASE + 7, BASE + 5),
    "full-win": (lambda w: torch.ones_like(w), BASE + 7, BASE + 5),
    "canonical-above-basemax": (lambda w: w, BASE + (9 << SHIFT), BASE + 3),
    # basemax past the drift threshold: any_drift is set.
    "canonical-below-basemax": (lambda w: w, BASE + 3, THRESH + 1),
    "no-slots": (lambda w: w, BASE + 7, _NEG),
}


@pytest.mark.parametrize("case", list(STAMP_CASES))
def test_the_stamp_keeps_the_fills_bits(case):
    make_win, canonical, basemax = STAMP_CASES[case]
    store, merged, win = lanes(1, n=0 if case == "no-slots" else N)
    win = make_win(win)
    any_dup = torch.tensor(case == "full-win")
    outs = (*merged, win, torch.tensor(basemax), any_dup)
    new_store, res = tk._stamp(store, outs, torch.tensor(canonical), LOCAL,
                               WALL)

    final = max(canonical, basemax)
    want_mod_lt = store.mod_lt.masked_fill(win, final)
    want_mod_node = store.mod_node.masked_fill(win, LOCAL)
    for got, want in ((new_store.mod_lt, want_mod_lt),
                      (new_store.mod_node, want_mod_node)):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want)
    for name, lane in zip(("lt", "node", "val", "tomb", "occupied"),
                          merged):
        assert getattr(new_store, name) is lane
    # A fresh copy: the caller's lanes are left as they were.
    assert new_store.mod_lt is not store.mod_lt
    assert new_store.mod_node is not store.mod_node
    assert res.new_canonical.dtype == torch.int64
    assert res.new_canonical.dim() == 0 and int(res.new_canonical) == final
    assert res.win is win and int(res.basemax) == basemax
    assert bool(res.any_dup) == (case == "full-win")
    assert bool(res.any_drift) == (basemax > THRESH)
    assert bool(res.any_drift) == (case == "canonical-below-basemax")


# --- no readback in a coarse pipelined step ------------------------------------

READBACKS = {"aten.masked_fill.Tensor", "aten.masked_fill_.Tensor",
             "aten._local_scalar_dense.default", "aten.item.default"}


class OpRecorder(TorchDispatchMode):
    """The name of every aten op dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def changeset(seed, n=N, rows=R):
    g = torch.Generator().manual_seed(seed)
    return DenseChangeset(
        lt=BASE + torch.randint(0, 1 << 20, (rows, n), generator=g),
        node=torch.randint(0, 4, (rows, n), generator=g).int(),
        val=torch.randint(-(2 ** 40), 2 ** 40, (rows, n), generator=g),
        tomb=torch.rand(rows, n, generator=g) < 0.2,
        valid=torch.rand(rows, n, generator=g) < 0.7)


def window_state():
    """A coarse window's device state at its opening."""
    false = torch.tensor(False)
    return (torch.tensor(BASE), false, false, false, false,
            torch.tensor(-1, dtype=torch.int32))


def fused_step(split, value_width):
    """One fused coarse step's call, inputs made ahead of it."""
    cs = changeset(3)
    store = empty_dense_store(N, "cpu")
    if not split:
        return lambda: tk.pipelined_model_step(
            store, cs, *window_state(), LOCAL, WALL, WALL, 0,
            value_width=value_width)
    # Wide split lanes: a value_width=32 replica masks the values past
    # int32 as it reads them.
    scs = split_changeset(cs)
    node_map = torch.arange(4, dtype=torch.int32)
    return lambda: tk.pipelined_model_step_split(
        store, scs, node_map, *window_state(), LOCAL, WALL, WALL, 0,
        value_width=value_width)


@pytest.mark.parametrize("value_width", [32, 64])
@pytest.mark.parametrize("split", [False, True], ids=["wide", "split"])
def test_a_coarse_pipelined_step_reads_nothing_back(split, value_width):
    step = fused_step(split, value_width)
    with OpRecorder() as rec:
        out = step()
    assert rec.ops, "the recorder saw no op"
    assert "aten.where.self" in rec.ops
    assert sorted(set(rec.ops) & READBACKS) == []
    # The step did merge: some slot won and carries the stamp.
    new_store, new_lt, win = out[0], out[1], out[8]
    assert bool(win.any())
    assert torch.equal(new_store.mod_lt[win],
                       torch.full_like(new_store.mod_lt[win],
                                       int(new_store.lt[win].max())))
    assert int(new_lt) > int(new_store.lt[win].max())
