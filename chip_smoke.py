#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`crdt_tpu_torch`) on one NVIDIA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. The card (``nvidia-smi`` name and power limit), torch and nvcc
   versions, and the build of every kernel from ``crdt_tpu_torch/csrc``.
2. Each kernel against its plain torch version on the card, bit for bit
   (integer lanes: tolerance 0), at the main path's shapes: the fan-in
   merge at 2^20 slots x 128 rows, the ingest commit of a 65,536-row
   flush into a 2^20-slot store. Timed with CUDA events beside the
   plain version and the byte bound.
3. The main path at full size through the public API: a
   ``DenseCrdt("n0", 2^20)`` on the card takes 16 ingest flushes of
   65,536 rows, 8 passes x 128 distinct replica rows (1024 rows) of
   merges in a coarse ``pipelined()`` window, one plain ``merge_many``,
   then ``export_delta``/``pack_since``/``to_json`` of a 4,096-row
   delta. The kernels' launch counters are zeroed just before and read
   just after. The final lanes and clock are held bit for bit against
   the same inputs folded by the plain ``ops.dense`` functions on the
   card, and the deltas against that reference store.
4. A JSON line per measurement, the ``kernels`` line, the card line,
   and last ``{"ok": true, "device": {...}}``.

Without a CUDA device it exits non-zero and prints no result. Results
also go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from crdt_tpu_torch import DenseCrdt, Hlc, _build
from crdt_tpu_torch.hlc import MAX_DRIFT, SHIFT
from crdt_tpu_torch.obs import device as obs_device
from crdt_tpu_torch.ops import fanin_kernel, ingest_kernel
from crdt_tpu_torch.ops.dense import (_I32_NEG, _NEG, DenseChangeset,
                                      DenseStore, dense_delta_mask,
                                      empty_dense_store, fanin_step,
                                      ingest_scatter)

N_SLOTS = 1 << 20
ROWS_PER_PASS = 128
PASSES = 8
FLUSH_ROWS = 1 << 16
FLUSHES = 16
DELTA_ROWS = 4096
MILLIS = 1_700_000_000_000
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
INT32_OPS_PER_S = 132 * 64 * 1.98e9   # H100 SXM: SMs x INT32 lanes x boost
SECTOR = 32                      # bytes per device-memory sector
IDS = [f"n{i}" for i in range(9)]   # changeset ordinals 1..8; local n0


class Failure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise Failure(what)


class StepClock:
    """Deterministic wall clock: +1 ms per read, so the reference
    replay can read the same sequence."""

    def __init__(self, start: int):
        self.t = start

    def __call__(self) -> int:
        self.t += 1
        return self.t


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def nvcc_version() -> str:
    out = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[-1]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean time of ``fn`` over ``iters`` back-to-back calls, from CUDA
    events around the whole run."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int, repeats: int = 3) -> list:
    """Device time per call of ``fn``: ``iters`` calls captured in one
    CUDA graph, the graph replayed and timed ``repeats`` times — the
    wrappers' host-side checks and ``ctypes`` calls stay out of it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                        # warm up off the capturing stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return [cuda_ms(graph.replay, 1, warmup=1) / iters
            for _ in range(repeats)]


def max_abs_err(a, b) -> int:
    """Largest |a - b| over paired tensors, exact in int64."""
    err = 0
    for x, y in zip(a, b):
        check(x.shape == y.shape and x.dtype == y.dtype,
              f"shape/dtype mismatch {x.shape} {x.dtype} vs {y.shape} "
              f"{y.dtype}")
        d = (x.long() - y.long()).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def make_changeset(rows: int, n: int, seed: int) -> DenseChangeset:
    """Device-generated replica rows in the shape of the JAX package's
    ``bench.make_changeset_fast``: ~1000-ms millis spread, 4 counter
    values, 8 writers, ~30% tombstones, ~80% fill."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    b1, b2 = torch.randint(0, 1 << 32, (2, rows, n), generator=g,
                           device="cuda", dtype=torch.int64)
    lt = ((MILLIS + b1 % 1000) << SHIFT) + (b2 & 3)
    return DenseChangeset(
        lt=lt, node=(1 + ((b2 >> 2) & 7)).to(torch.int32),
        val=(b1 << 16) ^ b2,
        tomb=((b2 >> 5) & 0xFF) < 77, valid=((b2 >> 13) & 0xFF) < 205)


def make_store(n: int, seed: int) -> DenseStore:
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    b1, b2 = torch.randint(0, 1 << 32, (2, n), generator=g, device="cuda",
                           dtype=torch.int64)
    occ = (b2 & 1) == 0
    lt = torch.where(occ, ((MILLIS + b1 % 1000) << SHIFT) + ((b2 >> 1) & 3),
                     0)
    node = torch.where(occ, 1 + ((b2 >> 3) & 7), 0).to(torch.int32)
    return DenseStore(lt=lt, node=node, val=b1 ^ (b2 << 7),
                      mod_lt=torch.where(occ, lt + (7 << SHIFT), 0),
                      mod_node=node.clone(), occupied=occ,
                      tomb=occ & (((b2 >> 6) & 0xFF) < 77))


# --- phase 2: kernels against their plain versions ------------------


def sector_bytes(mask: torch.Tensor, per_sector: int) -> int:
    """Bytes of the 32-B sectors of a lane (``per_sector`` entries each)
    that hold at least one entry where ``mask`` is set."""
    return SECTOR * int(mask.reshape(-1, per_sector).any(-1).sum())


def fanin_traffic(store: DenseStore, cs: DenseChangeset,
                  win: torch.Tensor) -> tuple:
    """``(needed, fetched)`` bytes of one merge on these inputs, counted
    in sectors. ``needed`` is what the function must move: valid of
    every entry, lt/node where some entry of the sector is valid,
    val/tomb only of the entry that wins its slot, the store's
    lt/node/occupied, its val/tomb where it keeps the slot, and the six
    outputs once. ``fetched`` is what ``csrc/fanin_batch.cu`` loads:
    lt/node/valid of every entry, val/tomb of each new running best,
    and the whole store."""
    r, n = cs.lt.shape
    check(n % SECTOR == 0, "fanin_traffic needs whole sectors per row")
    rows = torch.arange(r, device=cs.lt.device)[:, None]
    masked = torch.where(cs.valid, cs.lt, _NEG)
    cand = cs.valid & (cs.lt == masked.amax(0))
    cand &= cs.node == torch.where(cand, cs.node, _I32_NEG).amax(0)
    final = (rows == torch.where(cand, rows, r).amin(0)) & win
    best = torch.zeros_like(cs.valid)
    b_lt, b_node = masked[0].clone(), torch.where(cs.valid[0], cs.node[0],
                                                  _I32_NEG)
    best[0] = cs.valid[0]
    for row in range(1, r):
        lt, node = cs.lt[row], cs.node[row]
        better = cs.valid[row] & ((lt > b_lt) | ((lt == b_lt)
                                                 & (node > b_node)))
        best[row] = better
        b_lt = torch.where(better, lt, b_lt)
        b_node = torch.where(better, node, b_node)
    out = n * (8 + 4 + 8 + 1 + 1 + 1)
    needed = (r * n + sector_bytes(cs.valid, 4) + sector_bytes(cs.valid, 8)
              + sector_bytes(final, 4) + sector_bytes(final, 32)
              + n * (8 + 4 + 1) + sector_bytes(~win, 4)
              + sector_bytes(~win, 32) + out)
    fetched = (r * n * (8 + 4 + 1) + sector_bytes(best, 4)
               + sector_bytes(best, 32) + n * (8 + 4 + 8 + 1 + 1) + out)
    return needed, fetched


def kernel_fanin(results: dict) -> None:
    store = make_store(N_SLOTS, 1)
    cs = make_changeset(ROWS_PER_PASS, N_SLOTS, 2)
    # Forced ties: row 1 repeats row 0's (lt, node) on every 7th slot
    # with another payload (the lower row must win), and row 5 repeats
    # the store's record on occupied slots (the local record must win).
    cs.lt[1, ::7] = cs.lt[0, ::7]
    cs.node[1, ::7] = cs.node[0, ::7]
    cs.valid[:2, ::7] = True
    tie = torch.nonzero(store.occupied[::10]).reshape(-1) * 10
    cs.lt[5, tie] = store.lt[tie]
    cs.node[5, tie] = store.node[tie]
    cs.valid[5, tie] = True
    wall = MILLIS + 10_000
    local = 3                                  # writer n3: dup flag
    canonical = torch.tensor((MILLIS + 500) << SHIFT, device="cuda")
    cs.lt[9, 12345] = (wall + MAX_DRIFT + 5) << SHIFT   # drift flag
    cs.valid[9, 12345] = True

    k_store, k_res = fanin_kernel.fanin_batch(store, cs, canonical, local,
                                              wall)
    p_store, p_res = fanin_kernel.fanin_batch_reference(
        store, cs, canonical, local, wall)
    torch.cuda.synchronize()
    err = max_abs_err(list(k_store) + list(k_res),
                      list(p_store) + list(p_res))
    check(err == 0, f"fanin_batch kernel != plain version (max |err| "
                    f"{err})")
    check(bool(k_res.any_dup) and bool(k_res.any_drift),
          "fanin_batch: expected both superset flags set")
    check(bool(k_res.win.any()) and not bool(k_res.win.all()),
          "fanin_batch: degenerate win mask")

    launch = lambda: fanin_kernel._fanin_cuda(store, cs, canonical, local)
    runs = graph_ms(launch, iters=20)
    call_ms = cuda_ms(launch, iters=20)
    plain_ms = cuda_ms(lambda: fanin_kernel.fanin_join_reference(
        store, cs, canonical, local), iters=3, warmup=1)
    r, n = cs.lt.shape
    moved, fetched = fanin_traffic(store, cs, k_res.win)
    # Per valid entry, as int32 instructions: two int64 compares and a
    # max select for basemax and the canonical test, the lex compare
    # (int64 >, int64 ==, int32 >) and the node test, with their ands.
    ops = int(cs.valid.sum()) * 16
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    results["fanin_batch"] = dict(
        name="fanin_batch", route="cuda",
        source="crdt_tpu_torch/csrc/fanin_batch.cu",
        replaces="crdt_tpu/ops/pallas_merge.py:206",
        max_abs_err=err, ms=float(np.median(runs)), plain_ms=plain_ms,
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        library_ms=None, shape=[r, n], bytes_moved=moved,
        bytes_fetched=fetched, ops=ops, ops_ms=ops_ms, ms_runs=runs,
        call_ms=call_ms)
    del cs, store, k_store, p_store


def kernel_ingest(results: dict) -> None:
    rng = np.random.default_rng(3)
    base = make_store(N_SLOTS, 4)
    for rows, live in ((FLUSH_ROWS, 65_000), (FLUSH_ROWS, FLUSH_ROWS)):
        slots = np.full(rows, N_SLOTS, np.int64)     # sentinel padding
        slots[:live] = rng.choice(N_SLOTS, live, replace=False)
        lanes = [torch.tensor(a, device="cuda") for a in (
            slots, (MILLIS << SHIFT) + rng.integers(0, 1 << 30, rows),
            rng.integers(-2 ** 62, 2 ** 62, rows), rng.random(rows) < 0.3)]
        k_store = ingest_kernel.ingest_scatter(
            DenseStore(*(x.clone() for x in base)), *lanes, 4)
        p_store = ingest_scatter(DenseStore(*(x.clone() for x in base)),
                                 *lanes, 4)
        torch.cuda.synchronize()
        err = max_abs_err(k_store, p_store)
        check(err == 0, f"ingest_scatter kernel != plain version at "
                        f"{live} live rows (max |err| {err})")
    work = DenseStore(*(x.clone() for x in base))
    launch = lambda: ingest_kernel._ingest_cuda(work, *lanes, 4)
    runs = graph_ms(launch, iters=200)
    call_ms = cuda_ms(launch, iters=200)
    plain_ms = cuda_ms(lambda: ingest_scatter(work, *lanes, 4), iters=20)
    moved = live * (8 + 8 + 8 + 1) + live * (8 + 4 + 8 + 8 + 4 + 1 + 1)
    moved += (rows - live) * 8                  # sentinel slots read
    results["ingest_scatter"] = dict(
        name="ingest_scatter", route="cuda",
        source="crdt_tpu_torch/csrc/ingest_scatter.cu",
        replaces="crdt_tpu/ops/pallas_scatter.py:90",
        max_abs_err=err, ms=float(np.median(runs)), plain_ms=plain_ms,
        bound_ms=moved / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=None, shape=[rows, N_SLOTS], bytes_moved=moved,
        ms_runs=runs, call_ms=call_ms)


# --- phase 3: the main path ------------------------------------------


def flush_inputs(f: int):
    rng = np.random.default_rng(100 + f)
    slots = rng.choice(N_SLOTS, FLUSH_ROWS, replace=False)
    return slots, rng.integers(-2 ** 62, 2 ** 62, FLUSH_ROWS), \
        rng.random(FLUSH_ROWS) < 0.2


def main_path(card: str) -> dict:
    start = MILLIS + 500     # local stamps land inside the remote spread
    crdt = DenseCrdt("n0", N_SLOTS, node_ids=IDS, wall_clock=StepClock(start))
    delta_rng = np.random.default_rng(7)
    delta_slots = delta_rng.choice(N_SLOTS, DELTA_ROWS, replace=False)
    delta_vals = delta_rng.integers(0, 1 << 40, DELTA_ROWS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    obs_device.reset()
    t0 = time.perf_counter()
    with crdt.ingest(auto_flush_rows=FLUSH_ROWS) as wc:
        for f in range(FLUSHES):
            crdt.put_batch(*flush_inputs(f))  # reaches the auto flush
    torch.cuda.synchronize()
    t_ingest = time.perf_counter() - t0
    check(wc.flushes == FLUSHES, f"expected {FLUSHES} flushes, got "
                                 f"{wc.flushes}")

    seen0 = crdt.stats.records_seen
    t0 = time.perf_counter()
    with crdt.pipelined():               # exit = ONE readback
        for p in range(PASSES):
            crdt.merge(make_changeset(ROWS_PER_PASS, N_SLOTS, 1000 + p), IDS)
    t_window = time.perf_counter() - t0
    merged = crdt.stats.records_seen - seen0

    crdt.merge_many([(make_changeset(4, N_SLOTS, 2000 + i), IDS)
                     for i in range(2)])
    since = crdt.canonical_time
    with crdt.ingest():
        crdt.put_batch(delta_slots, delta_vals)
    t0 = time.perf_counter()
    cs, _ = crdt.export_delta(since)
    packed, pids = crdt.pack_since(since)
    wire = crdt.to_json(since)
    t_deltas = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = obs_device.launches()

    check(launches["fanin_batch"] >= PASSES + 1,
          f"main path launched fanin_batch {launches['fanin_batch']} times")
    check(launches["ingest_scatter"] >= FLUSHES + 1,
          f"main path launched ingest_scatter "
          f"{launches['ingest_scatter']} times")

    # The same inputs folded by the plain functions on the card.
    ref = empty_dense_store(N_SLOTS, "cuda")
    canon = Hlc(0, 0, "n0")
    clock = StepClock(start)

    def ref_flush(slots, vals, tombs):
        nonlocal canon
        canon, (lt,) = Hlc.send_batch(canon, 1, millis=clock())
        ingest_scatter(ref, *(torch.tensor(a, device="cuda") for a in (
            slots, np.full(len(slots), lt, np.int64), vals, tombs)), 0)

    def ref_merge(cs):
        nonlocal canon, ref
        wall = clock()
        ref, res = fanin_step(ref, cs, canon.logical_time, 0, wall)
        check(not bool(res.any_bad), "reference merge tripped a guard")
        canon = Hlc.send(Hlc.from_logical_time(int(res.new_canonical),
                                               "n0"), millis=clock())

    for f in range(FLUSHES):
        ref_flush(*flush_inputs(f))
    for p in range(PASSES):
        ref_merge(make_changeset(ROWS_PER_PASS, N_SLOTS, 1000 + p))
    ref_merge(DenseChangeset(*(torch.cat(lanes) for lanes in zip(
        *(make_changeset(4, N_SLOTS, 2000 + i) for i in range(2))))))
    check(canon == since, "clock before the delta differs from reference")
    ref_flush(delta_slots, delta_vals, np.zeros(DELTA_ROWS, bool))

    err = max_abs_err(crdt.store, ref)
    check(err == 0, f"main-path lanes differ from the plain fold "
                    f"(max |err| {err})")
    check(crdt.canonical_time.logical_time == canon.logical_time,
          "main-path canonical clock differs from the plain fold")
    idx = torch.nonzero(dense_delta_mask(ref, since.logical_time)
                        ).reshape(-1)
    check(len(idx) == DELTA_ROWS == packed.k == int(cs.valid.sum()),
          f"delta sizes: ref {len(idx)} pack {packed.k} export "
          f"{int(cs.valid.sum())}")
    for f in ("lt", "node", "val", "tomb"):
        check(np.array_equal(getattr(packed, f),
                             getattr(ref, f)[idx].cpu().numpy()),
              f"pack_since lane {f} differs from reference")
    check(np.array_equal(packed.slots, idx.cpu().numpy()),
          "pack_since slots differ from reference")
    doc = json.loads(wire)
    check(len(doc) == DELTA_ROWS and list(doc) == [
        str(s) for s in packed.slots.tolist()], "to_json keys")
    first = int(packed.slots[0])
    check(doc[str(first)] == {
        "hlc": str(Hlc.from_logical_time(int(packed.lt[0]),
                                         pids[int(packed.node[0])])),
        "value": None if packed.tomb[0] else int(packed.val[0])},
        "to_json record differs from the packed row")
    return dict(
        card=card, n_slots=N_SLOTS, flushes=FLUSHES, flush_rows=FLUSH_ROWS,
        ingest_s=t_ingest, ingest_rows_per_s=FLUSHES * FLUSH_ROWS / t_ingest,
        merge_passes=PASSES, rows_per_pass=ROWS_PER_PASS,
        records_merged=merged, window_s=t_window,
        merges_per_s=merged / t_window,
        window_includes_generation=True, deltas_s=t_deltas,
        delta_rows=DELTA_ROWS, json_bytes=len(wire), launches=launches,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)


def breakdown() -> dict:
    """Where the main path's host-clock time goes, measured apart from
    the counted run: the window's data generation alone (same seeds),
    and an ingest flush split into staging (``put_batch``) and commit
    (stamp, dedup, padding, host-to-device copies, kernel)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p in range(PASSES):
        make_changeset(ROWS_PER_PASS, N_SLOTS, 1000 + p)
    torch.cuda.synchronize()
    generation_s = time.perf_counter() - t0
    crdt = DenseCrdt("n0", N_SLOTS, node_ids=IDS,
                     wall_clock=StepClock(MILLIS))
    stage_s = commit_s = 0.0
    with crdt.ingest(auto_flush_rows=FLUSH_ROWS + 1) as wc:
        for f in range(4):
            inputs = flush_inputs(f)
            t0 = time.perf_counter()
            crdt.put_batch(*inputs)
            t1 = time.perf_counter()
            wc.flush()
            torch.cuda.synchronize()
            stage_s += t1 - t0
            commit_s += time.perf_counter() - t1
    return dict(window_generation_s=generation_s,
                flush_stage_s=stage_s / 4, flush_commit_s=commit_s / 4)


def guard_path() -> None:
    """The exact-guard recompute on the card (torch.cummax on int64):
    a duplicate-node record is refused and the store left untouched."""
    from crdt_tpu_torch import DuplicateNodeException
    crdt = DenseCrdt("n0", 4096, node_ids=IDS,
                     wall_clock=StepClock(MILLIS + 10_000))
    crdt.put_batch(np.arange(10), np.arange(10))
    before = [x.clone() for x in crdt.store]
    cs = make_changeset(3, 4096, 5)
    cs.node[2, 17] = 0                      # "n0": this replica's own id
    cs.valid[2, 17] = True
    cs.lt[2, 17] = (MILLIS + 20_000) << SHIFT
    try:
        crdt.merge(cs, IDS)
    except DuplicateNodeException:
        pass
    else:
        raise Failure("duplicate-node merge was not refused on the card")
    check(max_abs_err(crdt.store, before) == 0,
          "refused merge changed the store")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{nvcc_version()}")
    t0 = time.perf_counter()
    logs = _build.build()
    build_s = time.perf_counter() - t0
    print(f"kernel build: {build_s:.2f} s "
          f"({', '.join(_build.SOURCES)})")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    results: dict = {}
    kernel_fanin(results)
    kernel_ingest(results)
    print("phase 2: both kernels equal their plain versions on the card")
    guard_path()
    path = main_path(card)
    print("phase 3: main path equals the plain fold; deltas match")
    for name, n in path["launches"].items():
        results[name]["launches"] = n
    path["breakdown"] = breakdown()

    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    kernels = {"kernels": [{k: results[n][k] for k in keys}
                           for n in obs_device.KERNELS]}
    record = dict(card=card, build_s=build_s, main_path=path,
                  kernel_detail=results, torch=torch.__version__)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps({"main_path": path}))
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
