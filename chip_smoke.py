#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`crdt_tpu_torch`) on one NVIDIA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. The card (``nvidia-smi`` name and power limit), torch and nvcc
   versions, and the build of every kernel from ``crdt_tpu_torch/csrc``.
2. Each kernel against its plain torch version on the card, bit for bit
   (integer lanes: tolerance 0), at the paths' shapes: the fan-in merge
   at 2^20 slots x 128 rows; the ingest commit of a 65,536-row flush
   into a 2^20-slot store; the pre-split merge at 2^20 x 128 in the
   wide, the value_width=32 wide and the narrow wire form, with a
   remapping node map; the stream replay at 2^20 x 8 rows x 128
   chunks in both guard modes, with planted dup and drift records and
   one that only the fast flags raise, and at the planted inputs of
   ``tests/torch_stream_cases.py`` (4,097 slots x 13 rows x 128
   chunks); the sharded step (K1p) on a (replica=2, key=2) mesh at
   2^20 x 128, against its plain version and the unsharded merge, with
   ties across the replica-shard boundary;
   the kernel probes of ``benchmarks/probe_kernel.py`` at its CLI
   shapes, with ties, malformed sentinels, stale store records and
   sums that wrap int32 and int16: the join (P1a), the copy (P1b) and
   the guardless stream replay (P1c, in closed form over the chunks)
   at 2^20 x 8 rows (128 chunks), P1c also at the planted inputs of
   ``tests/torch_probe_cases.py`` (4,097 slots x 13 rows x 1 to 128
   chunks), the batch copy (P2) at 2^20 x 128 rows, wide and
   value-ref. Timed from replayed CUDA graphs beside the plain version
   and the bound (K1: the whole merge, and one K1p block alone; K2: the
   phase's rows and the main path's first flush as committed (in slot
   order) and in staging order, each warm and with the L2 emptied
   first, beside its bound in 32-B sectors and its count of sector
   store requests; K3: the launch alone and
   the whole call; K1p: its one launch over the four blocks beside four
   one-block launches, and the combine apart); then K3 in fast mode and
   P1c in turns on the same replay, and their difference (the cost of
   K3's guards, basemax and wide lanes).
3. The paths at full size through the public API, each with the launch
   counters zeroed just before it and read just after, each held bit
   for bit against the same inputs folded by the plain ``ops.dense``
   functions on the card:
   - the main path: a ``DenseCrdt("n0", 2^20)`` takes 16 ingest flushes
     of 65,536 rows, 8 passes x 128 distinct replica rows of merges in a
     coarse ``pipelined()`` window, one plain ``merge_many``, then
     ``export_delta``/``pack_since``/``to_json`` of a 4,096-row delta;
   - path A, the JAX-peer interchange: a peer replica's ingest flushes
     and ``export_split_delta``; a receiver's coarse window of 8 x
     ``merge_split`` of 128 split rows in the JAX wire dtypes and peer
     ordinals, an unpipelined ``merge_split`` of the peer's export, an
     ``exact_guards`` window that raises ``DuplicateNodeException``;
     the narrow form on a value_width=32 pair for two passes;
   - path B, the stream replay of ``bench.py``'s default mode: 64
     chained ``fanin_stream`` calls at 2^20 x 8 x 128 chunks with the
     canonical threaded;
   - path C, the sharded replication loop: a ``ShardedDenseCrdt("n0",
     2^20, make_fanin_mesh(2, 2))`` on the one card takes the main
     path's flushes and window, a ``merge_many``, an exact window that
     raises ``DuplicateNodeException`` and a 4,096-row delta out, held
     against the unsharded ``DenseCrdt`` given the same ops (lanes,
     clock, delta bytes, exception) with every replica copy equal, and
     one K1p launch per device and merge, then its digest tree and
     ``compact()`` (each key shard to its own prefix) against the
     unsharded model's tree and its compaction over the key shards'
     spans; then the (1, 1) and multislice (2, 1, 2) meshes at 2^16
     slots;
   - path E, gossip through the wire forms at 2^20 slots: a peer's
     ``pack_since`` deltas of 262,144 (the wide join), 65,536 and 4,096
     rows (the sparse join) go through ``pack_rows`` and
     ``unpack_rows`` into ``merge_packed`` on a receiver whose own
     flushes overlap them, the 65,536-row delta through
     ``merge_and_repack`` on a relay, and a 4,096-row ``to_json`` into
     ``merge_json``; each replica held bit for bit against a twin on
     the CPU given the same operations (lanes, clock, frame bytes),
     each merge timed on the host clock and split into decode and
     validation and the join, with the card's busy time under the
     profiler;
   - path F, anti-entropy and storage at 2^20 slots: two replicas
     seeded by the main path's 16 flushes diverge (8 slots written on
     each side, the anti-entropy bench's shape; then 10,486 scattered
     slots, 1% of the store) and converge through
     ``crdt_tpu_torch.sync.sync_merkle``, each replica held bit for bit
     against a twin on the CPU given the same operations (lanes, clock,
     digest levels, ranged pack bytes, the walk's report) and the root
     against a numpy-uint64 fold; one cold ``digest_tree`` split into
     host time and device time; then half of one replica's live rows
     tombstoned, ``gc_purge`` at its own head, a ``merge_many``
     replaying the pre-purge rows (the GC fence folded into K1's
     ``valid``), ``compact()`` (its seeded tree equal to a fresh one),
     and ``save`` / ``load`` (the loaded replica's first
     ``digest_tree`` builds nothing); each step timed on the host
     clock, the syncs' device time under the profiler, the plain ops
     counted (`obs.device.OPS`);
   - path G, typed slots at 2^20 slots: LWW on the first half of the
     slots, then ``gcounter``, ``pncounter``, ``orset`` and ``mvreg`` on
     four spans of an eighth each, every lane value its tag's
     ``law_val`` of the row's (lt, node). Two replicas take the main
     path's 16 flushes (encoded lanes, K2) and 1,000 typed ops each,
     400 of them inside an ``ingest()`` window; one ``merge_many`` of 16
     peer rows (``bench.data.make_changeset``, fill 0.8) through the
     typed fold, and a 128-row coarse window on the card alone against
     the same rows merged unpipelined; tagged ``pack_since(sem_mode=
     "include")`` deltas of 65,536 (the sparse typed join) and 262,144
     rows (the wide one) through ``pack_rows`` / ``unpack_rows`` into
     ``merge_packed``, a ``"withhold"`` pack into an LWW-only replica,
     a tagged pack it refuses with its store unchanged;
     ``sync_merkle`` between two typed replicas diverged on 1% of the
     slots, then a ``sync_packed`` round; half the live typed rows
     tombstoned, ``gc_purge``, ``compact``, ``grow``, ``save`` /
     ``load``; a typed ``ShardedDenseCrdt`` on (2, 2) against the
     unsharded replica (the fan-in, digest tree and compaction); a
     ``KeyedDenseCrdt`` with 10,000 string keys, typed ops and a
     ``sync_json`` round with a ``MapCrdt``. Every replica is held bit
     for bit against a host twin given the same calls (lanes, clock,
     tag column, frames, reports, JSON); no typed merge launches K1,
     K1s, K1p or K3; each step's host time, the card's busy time and
     its idle share come from ``torch.profiler``;
   - path H, the wire and gossip at 2^20 slots: two replicas seeded by
     the main path's 16 flushes (K2), each behind a ``GossipNode``'s
     ``SyncServer`` on 127.0.0.1, each with a host twin given the same
     calls; over hello-negotiated ``PeerConnection``s through a
     recording relay: ``sync_dense_over_conn`` (the split form's one
     raw frame a way, K1s on both ends) with zlib agreed and refused,
     ``sync_packed_over_conn`` at path E's delta sizes (262,144, 65,536
     and 4,096 rows) and once with a typed span under the
     ``semantics`` cap, ``sync_merkle_over_conn`` on path F's 1%
     scattered divergence with the digest prefetch, ``sync_over_conn``
     (JSON) of a 4,096-row replica through the C codec beside
     ``decode_columns`` in the pure-Python branch; then a three-node
     gossip sweep (the two replicas and a 10,000-key
     ``KeyedDenseCrdt`` that speaks only JSON, one link through the
     port's ``testing_faults`` proxy on a seeded schedule) until every
     pair converges, and ``fetch_metrics`` / ``fetch_debug_dump`` from
     each server, whose counters must be what the run did. After every
     round each replica equals its twin (lanes, clock, tags) and the
     card's frames equal the twin's, byte for byte; each round's host
     time, wire bytes, device time and idle share (``torch.profiler``)
     and K1s / K2 launches are recorded;
   - path I, the general-key backends and the group join at 2^20: a
     ``TpuMapCrdt`` on the card and its host twin take ``put_all`` of
     2^20 integer keys, push the mirror, ``merge`` 65,536 remote
     ``Record`` s (half win), whose shadow must equal ``merge_step`` of
     the same changeset on the mirror taken before it; the mirror's
     ``max_logical_time`` and ``delta_mask``; a card ``DenseCrdt``'s
     65,536-row ``to_json`` into ``merge_json``. A ``SqliteCrdt`` file
     of 65,536 records (cut from 2^20 for time) and a card
     ``TpuMapCrdt`` holding step one's records of the same keys
     converge through a full ``sync_json`` round (equal record maps and
     JSON bytes), and the reopened file's clock is ``MAX(lt)``. Four
     card ``DenseCrdt`` s seeded by 4 main-path flushes each (K2), in a
     ``CollectiveGroup`` on a member mesh that repeats the card,
     against a host twin group: 32 rounds of ``bench.py --mode
     collective``'s shape (256 rows a member, one join), a 65,536-row
     round also held against card clones converged pairwise by
     ``sync_packed``, a no-change join, and a typed round on path G's
     tags; each round one ``parallel.collective_join`` call with 0
     bytes to the wire, every member's lanes, clock, digest root and
     seeded pack equal to its twin's. Three ``GossipNode`` s over card
     replicas: the co-located pair through one join, the remote peer
     over the socket, a forced join failure counted in
     ``crdt_tpu_collective_fallback_total``, then loopback packed rounds
     beside the join's time;
   - path J, the serving plane over card ``DenseCrdt`` s at 2^20 slots,
     each step held against the host: one ``ServeTier`` under
     ``bench.py``'s ``bench_serve`` load (10,000 sessions at 1 op/s
     each, seated to the descriptor limit, framed JSON ``put`` s from a
     client fleet in its own process, ``tests/torch_serve_fleet.py``;
     then the binop lane on 1,000 sessions; warmup 2 s and window 5 s,
     cut from 3 and 10), every slot against the host fold of the acked
     writes and a sample read back with ``get``, one K2 launch and one
     ``pallas.ingest_scatter_tiles`` ledger record per flush; the
     scripted conversation of ``tests/torch_serve_script.py`` (JSON
     and binop ops, a refused write, packed, dense (K1s) and merkle
     rounds, ``gc_pass``, the metrics op) against a card tier and a
     host twin through a recording relay, frame for frame; a
     four-partition ``FederatedTier`` under ``bench_federate``'s
     federation-aware sessions (0.25 op/s each) through a live
     ``split_hot`` and then a ``merge_cold`` at 40% of 5-s windows, with
     two watch sessions kept open; a three-member ``ReplicaGroup``
     under ``bench_failover``'s storm (8 writers x 8 slots at 100 Hz)
     through three kills of the primary and rejoins, no acked write
     lost and one digest root on all members; one ``Autoscaler``
     swing, a split and a merge each fenced by its epoch;
   - path K, the analysis layer on the card: ``python -m
     crdt_tpu_torch.analysis --json`` in a subprocess (the host lint,
     the lock-order analysis, the law search over the plain ops and
     the five merge kernels, the op audit) must come back clean with
     K1, K1s, K2, K3 and K1p launched; the kernel law targets at the
     main path's shapes, one seed each, compared on the card (K1, K1s
     wide and K1p at 2^20 x 128, K3 at 2^20 x 8 x 128 chunks in both
     guard modes, K2 on a 65,536-row flush); the planted broken join
     (``tests/torch_broken_merge.py``) must fail the gate; an op script
     (the main path's 16 flushes, an unpipelined ``merge_many`` of 8 x
     128 rows, a 65,536-row ``merge_packed``, ``gc_purge`` and the
     fenced replay, one gossip round between two card nodes) runs on
     fresh replicas once with ``CRDT_TPU_SANITIZE`` off, then three
     times each way in the order off, on, on, off, off, on (every run's
     lanes equal the first's, no ``LatticeViolation``, no lock-order
     violation, the sanitized nodes' locks ``OrderedLock`` s; each
     step's on-minus-off host time per pair and its median), a planted
     lost update must raise; then ``python -m crdt_tpu_torch.obs`` in
     subprocesses: ``--once`` and ``--once --prom`` against a card
     node, ``fleet --once`` over both (exit 1: its SLO verdict fails on
     the ack p99 of path J's acks in this process's registry, and on
     that check alone), ``--trace`` over the last run's trace JSONL and
     ``bench --compare`` on the trajectory fixtures, each with the exit
     code of the CPU tests;
   - path L, the group join and the sharded model across cards, run
     when two or more cards are visible, on up to four (one card prints
     ``path L: not run: 1 card visible, it needs 2``; paths main to K
     run on the first card whatever the count): three groups of four
     ``DenseCrdt`` s at 2^20 seeded by path I's flushes, member i on
     card i (the default mesh: NCCL across the cards), the same members
     on the same cards through the funnel twin, and four members on
     the first card (the stacked route); 32 rounds of 256 rows a
     member, four rounds of 65,536 rows, ``sync_collective`` and four
     typed rounds (path I's, then three of typed ops), each join of the
     cards' group held bit for bit against the other two (report,
     lanes, clocks, seeded packs), its members' lanes on their own cards
     and nothing through the funnel; each join's host time, the
     profiler off, every NCCL collective's first call made before the
     timed rounds; one more round of each kind under the profiler for
     the busy and NCCL time a card; three ``GossipNode`` s with the collective
     lane across two cards and loopback packed rounds of 256 rows; then
     path C's script on ``ShardedDenseCrdt`` at 2^20 on (2, 2), (4, 1)
     and (1, 4) over the cards, four replicas over two cards and (2, 2)
     on one card, each against one unsharded run (lanes, clock, the
     exception, the delta, the digest root, every replica copy; K1p
     one launch a card and merge);
   - path D, the probe entry point (``crdt_tpu_torch.bench``) at the JAX
     CLI's defaults: its seven variants (``full``, ``stream``,
     ``stream-noguard``, ``nojoin``, ``copy``, ``copy-batch``,
     ``copy-batch-valref``), the distinct row (wide and value-ref, 2^20
     x 128, 48 loops) and the stream row (2^20 x 8 x 128 chunks, 64
     calls); then P2 and K1 timed in turns and ``copy_`` of P2's lanes:
     P2's achieved rate is the measured copy rate, and each fan-in
     kernel's counted bytes over it give its time at that rate.
   Beside the main path, its ingest flush split apart (`flush_split`):
   staging, dedup and slot order, padding and copies, the kernel.
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

from crdt_tpu_torch import (DenseCrdt, DuplicateNodeException, Hlc,
                            ShardedDenseCrdt, _build, parallel, semantics)
from crdt_tpu_torch.hlc import MAX_DRIFT, SHIFT
from crdt_tpu_torch.obs import device as obs_device
from crdt_tpu_torch.bench import fanin as bench_fanin
from crdt_tpu_torch.bench import probe_kernel as bench_probe
from crdt_tpu_torch.ops import (fanin_kernel, ingest_kernel, probe,
                                stream_kernel)
from crdt_tpu_torch.ops.split import (NEG_HI, NarrowSplitChangeset, join64,
                                      split_changeset,
                                      split_changeset_narrow, split_store,
                                      split_to_wide)
from crdt_tpu_torch.ops.dense import (_I32_NEG, _NEG, CHANGESET_DTYPES,
                                      DenseChangeset, DenseStore,
                                      dense_delta_mask, empty_dense_store,
                                      fanin_step, ingest_scatter)

N_SLOTS = 1 << 20
ROWS_PER_PASS = 128
PASSES = 8
FLUSH_ROWS = 1 << 16
FLUSHES = 16
DELTA_ROWS = 4096
MILLIS = 1_700_000_000_000
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
# The most scalar instructions the H100 SXM's SMs can start per second:
# 132 SMs x 128 lanes x 1.98 GHz boost, one instruction per lane per
# clock (the rate behind its 67 TFLOP/s float32 figure, an FMA counted
# once). No mix of int32 instructions runs faster: the compiler spreads
# integer adds and moves over the INT32 and the FMA pipes (IMAD).
OPS_PER_S = 132 * 128 * 1.98e9
SECTOR = 32                      # bytes per device-memory sector
IDS = [f"n{i}" for i in range(9)]   # changeset ordinals 1..8; local n0
STREAM_ROWS = 8                  # bench.py's default stream shape:
STREAM_CHUNKS = 128              # 2^20 keys x 8 rows x 128 chunks
STREAM_LAUNCHES = 64
PEER_FLUSHES = 4
# Path A: the peer's table (generated rows carry ordinals 1..8 = w1..w8)
# and the receiver's, seeded with the union so no ordinal ever shifts.
PEER_IDS = ["p0"] + [f"w{i}" for i in range(1, 9)]
RCV_IDS = sorted(PEER_IDS + ["a0", "r0"])


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


def one_card(n: int) -> list:
    """``n`` mesh positions on the first card: paths main to K run on
    one card however many are visible (path L spreads over them)."""
    return ["cuda:0"] * n


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


def device_ms(fn) -> dict:
    """Device time of everything ``fn`` puts on the card, by kernel or
    copy name, from ``torch.profiler``'s CUDA activity. CUDA events
    around host-driven work would bracket the host's enqueueing too (the
    card idles while the host prepares the next op). Empty if the
    profiler saw no device activity."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0)
        if us:
            out[e.key] = out.get(e.key, 0.0) + us / 1e3
    return out


def max_abs_err(a, b) -> int:
    """Largest |a - b| over paired tensors, exact in int64 (``b``'s on
    ``a``'s device)."""
    err = 0
    for x, y in zip(a, b):
        y = y.to(x.device)
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


def winner_rows(lt: torch.Tensor, node: torch.Tensor, valid: torch.Tensor,
                win: torch.Tensor) -> torch.Tensor:
    """The entry whose payload lands in each slot the merge wins: the
    lowest row holding its column's valid (lt, node) max."""
    r = lt.shape[0]
    rows = torch.arange(r, device=lt.device)[:, None]
    cand = valid & (lt == torch.where(valid, lt, _NEG).amax(0))
    cand &= node == torch.where(cand, node, _I32_NEG).amax(0)
    return (rows == torch.where(cand, rows, r).amin(0)) & win


def fanin_traffic(store: DenseStore, cs: DenseChangeset,
                  win: torch.Tensor) -> tuple:
    """``(needed, fetched)`` bytes of one merge on these inputs, counted
    in sectors. ``needed`` is what the function must move: valid of
    every entry, lt/node where some entry of the sector is valid,
    val/tomb only of the entry that wins its slot, the store's
    lt/node/occupied, its val/tomb where it keeps the slot, and the six
    outputs once. ``fetched`` is what ``csrc/fanin_batch.cu`` loads:
    lt/node/valid of every entry, the winner's val/tomb, and the store
    as the function needs it."""
    r, n = cs.lt.shape
    check(n % SECTOR == 0, "fanin_traffic needs whole sectors per row")
    final = winner_rows(cs.lt, cs.node, cs.valid, win)
    out = n * (8 + 4 + 8 + 1 + 1 + 1)
    payload = (sector_bytes(final, 4) + sector_bytes(final, 32) + n * 13
               + sector_bytes(~win, 4) + sector_bytes(~win, 32) + out)
    needed = (r * n + sector_bytes(cs.valid, 4) + sector_bytes(cs.valid, 8)
              + payload)
    return needed, r * n * (8 + 4 + 1) + payload


def plant_ties(store: DenseStore, cs: DenseChangeset, node_of=None) -> None:
    """Row 1 repeats row 0's (lt, node) on every 7th slot with another
    payload (the lower row must win); row 5 repeats the store's record
    on every 10th occupied slot (the local record must win).
    ``node_of`` maps a store ordinal to the changeset's own."""
    cs.lt[1, ::7] = cs.lt[0, ::7]
    cs.node[1, ::7] = cs.node[0, ::7]
    cs.valid[:2, ::7] = True
    tie = torch.nonzero(store.occupied[::10]).reshape(-1) * 10
    cs.lt[5, tie] = store.lt[tie]
    node = store.node[tie]
    cs.node[5, tie] = node if node_of is None else node_of[node.long()]
    cs.valid[5, tie] = True


def kernel_fanin(results: dict) -> None:
    store = make_store(N_SLOTS, 1)
    cs = make_changeset(ROWS_PER_PASS, N_SLOTS, 2)
    plant_ties(store, cs)
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

    launch = lambda: fanin_kernel.fanin_cuda_many([store], [cs], canonical,
                                                  local)
    runs = graph_ms(launch, iters=20)
    call_ms = cuda_ms(launch, iters=20)
    plain_ms = cuda_ms(lambda: fanin_kernel.fanin_join_reference(
        store, cs, canonical, local), iters=3, warmup=1)
    r, n = cs.lt.shape
    moved, fetched = fanin_traffic(store, cs, k_res.win)
    # K1 on one K1p block of a (2, 2) mesh: the first 64 rows x 2^19
    # slots, read in place at the row stride 2^20, one launch alone.
    half = N_SLOTS // 2
    blk = DenseStore(*(x[:half] for x in store))
    cblk = DenseChangeset(*(x[:ROWS_PER_PASS // 2, :half] for x in cs))
    check(cblk.lt.stride(0) == N_SLOTS, "K1 block: not read in place")
    block_runs = graph_ms(lambda: fanin_kernel.fanin_cuda_many(
        [blk], [cblk], canonical, local), iters=20)
    # Per valid entry, as int32 instructions: two int64 compares and a
    # max select for basemax and the canonical test, the lex compare
    # (int64 >, int64 ==, int32 >) and the node test, with their ands.
    ops = int(cs.valid.sum()) * 16
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / OPS_PER_S * 1e3
    results["fanin_batch"] = dict(
        name="fanin_batch", route="cuda",
        source="crdt_tpu_torch/csrc/fanin_batch.cu",
        replaces="crdt_tpu/ops/pallas_merge.py:206",
        max_abs_err=err, ms=float(np.median(runs)), plain_ms=plain_ms,
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        library_ms=None, shape=[r, n], bytes_moved=moved,
        bytes_fetched=fetched, ops=ops, ops_ms=ops_ms, ms_runs=runs,
        call_ms=call_ms,
        one_block=dict(shape=[ROWS_PER_PASS // 2, half], ld=N_SLOTS,
                       ms=float(np.median(block_runs)), ms_runs=block_runs))
    del cs, store, k_store, p_store, blk, cblk


def cold_graph_ms(fn, iters: int = 20, repeats: int = 3) -> list:
    """Device time per call of ``fn`` with the L2 cache emptied of its
    lanes before each call: a graph of ``iters`` x (read a buffer twice
    the L2, then ``fn``) less a graph of the reads alone. The read leaves
    clean lines, so ``fn`` pays no write-back of the flush's."""
    flush = torch.ones(L2_FLUSH_BYTES // 8, dtype=torch.int64,
                       device="cuda")
    out = torch.empty((), dtype=torch.int64, device="cuda")
    evict = lambda: torch.amax(flush, dim=0, out=out)

    def both():
        evict()
        fn()

    evict_ms = graph_ms(evict, iters=iters, repeats=repeats)
    both_ms = graph_ms(both, iters=iters, repeats=repeats)
    return [b - e for b, e in zip(both_ms, evict_ms)]


L2_FLUSH_BYTES = 128 << 20           # more than twice the H100's 50 MB L2


def store_requests(slots: torch.Tensor, n: int) -> int:
    """The 32-B sectors one K2 launch's store instructions address: for
    each warp (32 consecutive rows) and each of the seven store lanes,
    the distinct sectors its live rows' slots fall in, summed. A
    diagnostic of how the row order spreads the stores (the bound
    counts each touched sector once per flush)."""
    warp = torch.arange(len(slots), device=slots.device) // 32
    live = slots < n
    w, s = warp[live], slots[live]
    total = 0
    for e in STORE_LANE_BYTES:
        sector = s * e // SECTOR
        total += len(torch.unique(w * (n * 8 // SECTOR + 1) + sector))
    return total


def kernel_ingest(results: dict) -> None:
    """K2 against its plain version on the phase's rows (65,000 live
    rows in random order, sentinels at the end), then on the main path's
    first flush as the combiner commits it (slot order, from
    `DenseCrdt._last_wins_order`) and the same rows in staging order (a
    random order: how flushes were committed before slot order). Each
    timed warm (a graph replay: the flush's lines stay in L2) and cold
    (L2 emptied first), beside its sector bound and its store requests."""
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
    main_slots, main_vals, main_tombs = flush_inputs(0)
    row_lt = (MILLIS << SHIFT) + rng.integers(0, 1 << 30, FLUSH_ROWS)
    orders = {"main_path_as_committed":
              DenseCrdt._last_wins_order(main_slots)[1],
              "main_path_staging_order": np.arange(FLUSH_ROWS)}
    inputs = {"phase2": lanes}
    for order, at in orders.items():
        inputs[order] = [torch.tensor(a[at], device="cuda") for a in (
            main_slots, row_lt, main_vals, main_tombs)]
        check(max_abs_err(
            ingest_kernel.ingest_scatter(
                DenseStore(*(x.clone() for x in base)), *inputs[order], 4),
            ingest_scatter(DenseStore(*(x.clone() for x in base)),
                           *inputs[order], 4)) == 0,
              f"ingest_scatter kernel != plain version ({order})")
    check(bool((inputs["main_path_as_committed"][0].diff() > 0).all()),
          "the combiner's commit order is not slot order")
    launches = {k: (lambda x=x: ingest_kernel._ingest_cuda(work, *x, 4))
                for k, x in inputs.items()}
    warm = {k: [] for k in inputs}
    cold = {k: [] for k in inputs}
    for _ in range(2):                       # the three inputs in turns
        for name, fn in launches.items():
            warm[name] += graph_ms(fn, iters=200)
            cold[name] += cold_graph_ms(fn)
    by_input = {}
    for name, x in inputs.items():
        moved = scatter_traffic(x[0], N_SLOTS)
        bound = moved / HBM_BYTES_PER_S * 1e3
        ms, ms_cold = float(np.median(warm[name])), float(
            np.median(cold[name]))
        by_input[name] = dict(
            ms=ms, ms_runs=warm[name], cold_ms=ms_cold,
            cold_ms_runs=cold[name], bytes_moved=moved, bound_ms=bound,
            share_of_bound=bound / ms, cold_share_of_bound=bound / ms_cold,
            store_requests_32b=store_requests(x[0], N_SLOTS))
    main = inputs["main_path_as_committed"]
    call_ms = cuda_ms(launches["main_path_as_committed"], iters=200)
    plain_ms = cuda_ms(lambda: ingest_scatter(work, *main, 4), iters=20)
    row = by_input["main_path_as_committed"]
    results["ingest_scatter"] = dict(
        name="ingest_scatter", route="cuda",
        source="crdt_tpu_torch/csrc/ingest_scatter.cu",
        replaces="crdt_tpu/ops/pallas_scatter.py:90",
        max_abs_err=err, ms=row["ms"], plain_ms=plain_ms,
        bound_ms=row["bound_ms"], bound_by="bytes", library_ms=None,
        shape=[FLUSH_ROWS, N_SLOTS], bytes_moved=row["bytes_moved"],
        ms_runs=row["ms_runs"], call_ms=call_ms, inputs=by_input)
    print(f"  ingest_scatter [{FLUSH_ROWS} rows -> {N_SLOTS}]: bit-exact; "
          + "; ".join(f"{k} {v['ms']:.4f} ms warm, {v['cold_ms']:.4f} cold, "
                      f"bound {v['bound_ms']:.5f}, {v['store_requests_32b']} "
                      f"sector requests" for k, v in by_input.items()))


# Bytes per slot of the seven store lanes an ingest flush writes: lt,
# node, val, mod_lt, mod_node, occupied, tomb.
STORE_LANE_BYTES = (8, 4, 8, 8, 4, 1, 1)


def scatter_traffic(slots: torch.Tensor, n: int) -> int:
    """Bytes one ingest flush must move, in 32-B sectors: each row's slot
    (8 B, the padding rows' too), the live rows' lt, val and tomb (17 B,
    the live rows first), and in each of the seven store lanes the
    sectors that the live rows' slots touch."""
    live = slots[slots < n]
    k = len(live)
    rows = len(slots) * 8 + 2 * SECTOR * -(-k * 8 // SECTOR) \
        + SECTOR * -(-k // SECTOR)
    return rows + sum(SECTOR * len(torch.unique(live * e // SECTOR))
                      for e in STORE_LANE_BYTES)


def split_traffic(store: DenseStore, scs, node_map: torch.Tensor,
                  win: torch.Tensor, check_fit: bool) -> int:
    """Bytes one pre-split merge must move on these inputs, in 32-B
    sectors: hi/lo/node of every entry (10 B — there is no valid lane to
    skip by), the payload (val_hi/val_lo or the narrow val, and tomb)
    only of the entry that wins its slot, or every entry's val_hi/val_lo
    when a value_width=32 replica must check wide payloads; the store's
    lt/node/occupied, its val/tomb where it keeps the slot, the six
    outputs and the node map once."""
    r, n = scs.hi.shape
    check(n % SECTOR == 0, "split_traffic needs whole sectors per row")
    wide = split_to_wide(scs)
    valid = wide.valid
    if check_fit:
        valid = valid & (wide.val == wide.val.to(torch.int32).long())
    node = node_map.long()[wide.node.long().clamp(0, len(node_map) - 1)]
    final = winner_rows(wide.lt, node, valid, win)
    if check_fit:
        payload = r * n * 8
    else:
        payload = sector_bytes(final, 8) * (
            1 if isinstance(scs, NarrowSplitChangeset) else 2)
    return (r * n * 10 + payload + sector_bytes(final, 32) + n * 13
            + sector_bytes(~win, 4) + sector_bytes(~win, 32) + n * 23
            + 4 * len(node_map))


def kernel_split(results: dict) -> None:
    """K1s in its three wire forms against the plain version: wide
    lanes, wide lanes on a value_width=32 replica (with entries whose
    payload does not fit, masked and flagged) and narrow lanes; each
    with the ties of `kernel_fanin`, a remapping node map, a dup and a
    drift record and malformed sentinels (hi = NEG_HI, lo != 0)."""
    store = make_store(N_SLOTS, 5)
    wall = MILLIS + 10_000
    local = 3
    canonical = torch.tensor((MILLIS + 500) << SHIFT, device="cuda")
    # Peer ordinal p -> local ordinal; peer 2 is the local node (dup).
    node_map = torch.tensor([0, 6, 3, 8, 1, 7, 2, 5, 4], dtype=torch.int32,
                            device="cuda")
    peer_of = torch.argsort(node_map).to(torch.int32)
    cs = make_changeset(ROWS_PER_PASS, N_SLOTS, 6)
    plant_ties(store, cs, peer_of)
    cs.lt[9, 12345] = (wall + MAX_DRIFT + 5) << SHIFT   # drift flag
    cs.valid[9, 12345] = True
    small = cs._replace(val=cs.val & 0xFFFFF)
    small.val[3, ::1000] = 1 << 40               # past int32
    small.valid[3, ::1000] = True
    forms = {"wide": (split_changeset(cs), 64),
             "wide_vw32": (split_changeset(small), 32),
             "narrow": (split_changeset_narrow(small)[0], 32)}
    del cs, small
    detail = {}
    for form, (scs, vw) in forms.items():
        bad = torch.zeros_like(scs.hi, dtype=torch.bool)
        bad[7, ::4099] = True                    # malformed sentinels
        scs = scs._replace(
            hi=torch.where(bad, NEG_HI, scs.hi),
            lo=torch.where(bad, 9, scs.lo.long()).to(torch.uint32))
        k = fanin_kernel.fanin_split(store, scs, node_map, canonical, local,
                                     wall, value_width=vw)
        p = fanin_kernel.fanin_split_reference(store, scs, node_map,
                                               canonical, local, wall,
                                               value_width=vw)
        torch.cuda.synchronize()
        err = max_abs_err(list(k[0]) + list(k[1]) + list(k[2:]),
                          list(p[0]) + list(p[1]) + list(p[2:]))
        check(err == 0, f"fanin_split ({form}) kernel != plain version "
                        f"(max |err| {err})")
        check(bool(k[1].any_dup) and bool(k[1].any_drift),
              f"fanin_split ({form}): expected both superset flags set")
        check(bool(k[3]) == (form == "wide_vw32"),
              f"fanin_split ({form}): val_overflow {bool(k[3])}")
        check(bool(k[1].win.any()) and not bool(k[1].win.all()),
              f"fanin_split ({form}): degenerate win mask")
        check_fit = form == "wide_vw32"
        launch = lambda: fanin_kernel._fanin_split_cuda(
            store, scs, node_map, canonical, local, check_fit)
        runs = graph_ms(launch, iters=20)
        call_ms = cuda_ms(launch, iters=20)
        plain_ms = cuda_ms(lambda: fanin_kernel.fanin_split_join_reference(
            store, scs, node_map, canonical, local, check_fit), iters=2,
            warmup=1)
        r, n = scs.hi.shape
        moved = split_traffic(store, scs, node_map, k[1].win, check_fit)
        # Per entry, as int32 instructions: the sentinel test and seen
        # count, the remap (sentinel test, clamp, shared-memory load,
        # select), the int64 key, basemax, the dup test, the lex compare
        # and the running-best selects.
        ops = r * n * 24
        bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / OPS_PER_S * 1e3
        detail[form] = dict(
            max_abs_err=err, ms=float(np.median(runs)), ms_runs=runs,
            call_ms=call_ms, plain_ms=plain_ms, bytes_moved=moved,
            bytes_ms=bytes_ms, ops=ops, ops_ms=ops_ms,
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            value_width=vw, shape=[r, n])
    wide = detail["wide"]
    results["fanin_split"] = dict(
        name="fanin_split", route="cuda",
        source="crdt_tpu_torch/csrc/fanin_split.cu",
        replaces="crdt_tpu/ops/pallas_merge.py:803",
        max_abs_err=max(d["max_abs_err"] for d in detail.values()),
        ms=wide["ms"], plain_ms=wide["plain_ms"],
        bound_ms=wide["bound_ms"], bound_by=wide["bound_by"],
        library_ms=None, forms=detail)


def stream_inputs(seed: int, shielded_only: bool):
    """Store and 8-row changeset at the bench shape; the canonical sits
    2 s above every generated record, so only planted records reach the
    guards' slow path: a column whose local-node record is shielded by
    an earlier, larger one (fast flags raise it, exact guards do not);
    unless ``shielded_only``, a real dup and a real drift record."""
    store = make_store(N_SLOTS, seed)
    cs = make_changeset(STREAM_ROWS, N_SLOTS, seed + 1)
    plant_ties(store, cs)
    canon = (MILLIS + 2000) << SHIFT
    local = 3
    cs.valid[:, 100] = False
    cs.valid[:2, 100] = True
    cs.node[:2, 100] = torch.tensor([5, local], dtype=torch.int32,
                                    device="cuda")
    cs.lt[:2, 100] = torch.tensor([canon + (9 << SHIFT),
                                   canon + (3 << SHIFT)], device="cuda")
    if not shielded_only:
        cs.valid[2, 200], cs.node[2, 200] = True, local
        cs.lt[2, 200] = canon + (20 << SHIFT)
        cs.valid[4, 300], cs.node[4, 300] = True, 5
        cs.lt[4, 300] = (MILLIS + 10_000 + MAX_DRIFT + 5) << SHIFT
    return store, cs, torch.tensor(canon, device="cuda"), local


def kernel_stream(results: dict) -> None:
    wall = MILLIS + 10_000
    detail = {}
    for shielded_only in (True, False):
        store, cs, canon, local = stream_inputs(30, shielded_only)
        for guards in ("fast", "exact"):
            k_store, k_res = stream_kernel.fanin_stream(
                store, cs, canon, local, wall, n_chunks=STREAM_CHUNKS,
                guards=guards)
            p_store, p_res = stream_kernel.fanin_stream_reference(
                store, cs, canon, local, wall, n_chunks=STREAM_CHUNKS,
                guards=guards)
            torch.cuda.synchronize()
            err = max_abs_err(list(k_store) + list(k_res),
                              list(p_store) + list(p_res))
            check(err == 0, f"fanin_stream ({guards}) kernel != plain "
                            f"version (max |err| {err})")
            want = ((guards == "fast", False) if shielded_only
                    else (True, True))
            got = (bool(k_res.any_dup), bool(k_res.any_drift))
            check(got == want, f"fanin_stream ({guards}, shielded_only="
                               f"{shielded_only}): flags {got}, want {want}")
            check(bool(k_res.win.any()) and not bool(k_res.win.all()),
                  "fanin_stream: degenerate win mask")
            if shielded_only:
                continue
            out = DenseStore(*(torch.empty_like(x) for x in store))
            res = stream_kernel.StreamResult(
                torch.empty((), dtype=torch.int64, device="cuda"),
                torch.empty_like(store.occupied),
                *(torch.empty((), dtype=torch.bool, device="cuda")
                  for _ in range(2)))
            scratch = torch.empty(3, dtype=torch.int64, device="cuda")
            thresh = ((wall + MAX_DRIFT) << SHIFT) | 0xFFFF
            launch = lambda: stream_kernel.launch_stream(
                store, cs, out, res, scratch, canon, local, thresh,
                STREAM_CHUNKS, guards == "exact")
            launch()
            torch.cuda.synchronize()
            check(max_abs_err(list(out) + list(res),
                              list(k_store) + list(k_res)) == 0,
                  f"fanin_stream ({guards}): the launch alone differs from "
                  f"the call")
            call = lambda: stream_kernel.fanin_stream(
                store, cs, canon, local, wall, n_chunks=STREAM_CHUNKS,
                guards=guards)
            runs, call_runs = [], []
            for _ in range(2):               # launch, call, in turns
                runs += graph_ms(launch, iters=100)
                call_runs += graph_ms(call, iters=100)
            plain_ms = cuda_ms(lambda: stream_kernel.fanin_stream_reference(
                store, cs, canon, local, wall, n_chunks=STREAM_CHUNKS,
                guards=guards), iters=1, warmup=0)
            moved = stream_traffic(store, cs, k_res.win)
            # The fewest int32 instructions the function takes. Chunk c
            # shifts every valid lt alike, so a column's row order never
            # changes and the chunks have a closed form: one pass over
            # the rows finds the column's winner, per valid entry the
            # lex compare against the running best (int64 >, int64 ==
            # and int32 >: 5) and the selects of its lt, node and row
            # (4); the exact guards' slow-path tests are monotone in the
            # chunk and add, once per valid entry, the compare with the
            # running max (2), the node test (1), the drift compare (2),
            # their combination (2), the run select (2) and the flags
            # (1). Per slot: the winner at the last chunk against the
            # store (the int64 offset add, 2, and the lex compare, 5),
            # the win flag (1) and the stamp selects (2), as a winner
            # wins every chunk after its first.
            per = 19 if guards == "exact" else 9
            valid_entries = int(cs.valid.sum())
            ops = valid_entries * per + N_SLOTS * 10
            bytes_ms = moved / HBM_BYTES_PER_S * 1e3
            ops_ms = ops / OPS_PER_S * 1e3
            detail[guards] = dict(
                max_abs_err=err, ms=float(np.median(runs)), ms_runs=runs,
                call_ms=float(np.median(call_runs)), call_ms_runs=call_runs,
                chunk_walk_ms_quoted=CHUNK_WALK_MS_QUOTED[guards],
                plain_ms=plain_ms, bytes_moved=moved, bytes_ms=bytes_ms,
                valid_entries=valid_entries, ops=ops, ops_ms=ops_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                shape=[STREAM_ROWS, N_SLOTS, STREAM_CHUNKS])
        del store, cs
    planted = kernel_stream_planted()
    fast = detail["fast"]                 # bench.py's stream mode
    results["fanin_stream"] = dict(
        name="fanin_stream", route="cuda",
        source="crdt_tpu_torch/csrc/fanin_stream.cu",
        replaces="crdt_tpu/ops/pallas_merge.py:572",
        max_abs_err=max(*(d["max_abs_err"] for d in detail.values()),
                        *planted.values()),
        ms=fast["ms"], plain_ms=fast["plain_ms"], bound_ms=fast["bound_ms"],
        bound_by=fast["bound_by"], library_ms=None, guards=detail,
        planted=planted)


# Quoted, not measured here: the chunk-walk design of
# csrc/fanin_stream.cu that the closed form replaced, as an earlier
# version of this phase timed it (PERF.md) on an NVIDIA H100 80GB HBM3 at
# 700 W (2^20 slots x 8 rows x 128 chunks, the launch in a replayed
# graph). The chunk walk is no longer built, so no run can time it again.
CHUNK_WALK_MS_QUOTED = {"fast": 0.7338, "exact": 1.5766}


def kernel_stream_planted() -> dict:
    """K3 against the chunk walk on the card at the planted inputs of
    ``tests/torch_stream_cases.py`` (store slots ahead of and tied with
    their column, row ties, shielded entries, each guard boundary, an
    empty column and an empty changeset), 13 rows x 128 chunks at an odd
    slot count, in both guard modes. Returns max |err| per case."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    from torch_stream_cases import (CLOSED_CASES, LOCAL, WALL,
                                    closed_inputs, exact_flags)
    errs = {}
    for case in CLOSED_CASES:
        store, cs, canonical = closed_inputs(case, 13, STREAM_CHUNKS,
                                             n=4097)
        store = DenseStore(*(torch.tensor(store[f], device="cuda")
                             for f in DenseStore._fields))
        cs = DenseChangeset(*(torch.tensor(cs[f], device="cuda")
                              for f in DenseChangeset._fields))
        for guards in ("fast", "exact"):
            args = (store, cs, canonical, LOCAL, WALL)
            k_store, k_res = stream_kernel.fanin_stream(
                *args, n_chunks=STREAM_CHUNKS, guards=guards)
            p_store, p_res = stream_kernel.fanin_stream_reference(
                *args, n_chunks=STREAM_CHUNKS, guards=guards)
            torch.cuda.synchronize()
            err = max_abs_err(list(k_store) + list(k_res),
                              list(p_store) + list(p_res))
            check(err == 0, f"fanin_stream ({guards}, {case}) kernel != "
                            f"plain version (max |err| {err})")
            if guards == "exact":
                check((bool(k_res.any_dup), bool(k_res.any_drift))
                      == exact_flags(case, STREAM_CHUNKS),
                      f"fanin_stream ({case}): exact flags")
            errs[f"{case}/{guards}"] = err
    return errs


def kernel_fanin_sharded(results: dict) -> None:
    """K1p: the sharded step on a (replica=2, key=2) mesh on the card,
    its one K1 launch over the four blocks (each 64 rows x 2^19 slots
    read in place, row stride 2^20) and the combine, against the step
    with the plain per-block join and against the unsharded K1 merge of
    the same inputs, with ties planted across the replica-shard
    boundary; timed beside the same blocks as four one-block launches."""
    mesh = parallel.make_fanin_mesh(2, 2, one_card(4))
    store = make_store(N_SLOTS, 11)
    cs = make_changeset(ROWS_PER_PASS, N_SLOTS, 12)
    plant_ties(store, cs)
    half = ROWS_PER_PASS // 2               # rank 1's first row
    cs.lt[half, ::3] = cs.lt[0, ::3]
    cs.node[half, ::3] = cs.node[0, ::3]
    cs.valid[0, ::3] = cs.valid[half, ::3] = True
    wall = MILLIS + 10_000
    local = 3                                  # writer n3: dup flag
    canonical = torch.tensor((MILLIS + 500) << SHIFT, device="cuda")
    cs.lt[9, 12345] = (wall + MAX_DRIFT + 5) << SHIFT   # drift flag
    cs.valid[9, 12345] = True
    sstore = parallel.shard_store(store, mesh)
    scs = parallel.shard_changeset(cs, mesh)
    check(scs.blocks[1][1].lt.data_ptr()
          == cs.lt[half:, N_SLOTS // 2:].data_ptr(),
          "K1p: changeset blocks are not read in place")
    args = (canonical, local, wall)
    k_store, k_res = parallel.make_sharded_fanin(mesh)(sstore, scs, *args)
    p_store, p_res = parallel.make_sharded_fanin(mesh, reference=True)(
        sstore, scs, *args)
    u_store, u_res = fanin_kernel.fanin_batch(store, cs, *args)
    torch.cuda.synchronize()
    err = max(max_abs_err(a, b) for ka, pa in zip(k_store.blocks,
                                                    p_store.blocks)
              for a, b in zip(ka, pa))
    err = max(err, max_abs_err(k_res, p_res))
    check(err == 0, f"K1p != its plain version (max |err| {err})")
    err_u = max_abs_err(
        list(parallel.gather_store(k_store)) + [k_res.win,
                                                k_res.new_canonical,
                                                k_res.any_dup,
                                                k_res.any_drift],
        list(u_store) + [u_res.win, u_res.new_canonical, u_res.any_dup,
                         u_res.any_drift])
    check(err_u == 0, f"K1p != the unsharded K1 merge (max |err| {err_u})")
    check(bool(k_res.any_dup) and bool(k_res.any_drift),
          "K1p: expected both superset flags set")
    check(bool(k_res.win.any()) and not bool(k_res.win.all()),
          "K1p: degenerate win mask")
    check_copies(k_store, "K1p")

    joins = lambda: parallel.fanin.block_joins(sstore, scs, canonical,
                                               local)
    obs_device.reset()
    parts = joins()
    launches = obs_device.launches()["fanin_batch_sharded"]
    check(launches == 1, f"K1p: {launches} launches for one merge on one "
                         f"card")
    pairs = [(b, c) for s_row, c_row in zip(sstore.blocks, scs.blocks)
             for b, c in zip(s_row, c_row)]
    separate = lambda: [fanin_kernel.fanin_cuda_many([b], [c], canonical,
                                                     local)
                        for b, c in pairs]
    runs, sep_runs = [], []
    for _ in range(2):                       # one launch, four, in turns
        runs += graph_ms(joins, iters=10)
        sep_runs += graph_ms(separate, iters=10)
    call_ms = cuda_ms(joins, iters=10)
    comb_runs = graph_ms(lambda: parallel.fanin.combine_blocks(
        sstore, parts, canonical, local, wall, mesh), iters=5)
    step = parallel.make_sharded_fanin(mesh)
    step_ms = cuda_ms(lambda: step(sstore, scs, *args), iters=5)
    k1_runs = graph_ms(lambda: fanin_kernel.fanin_cuda_many(
        [store], [cs], canonical, local), iters=5)
    plain_ms = cuda_ms(lambda: parallel.fanin.block_joins(
        sstore, scs, canonical, local,
        join=fanin_kernel.fanin_join_reference), iters=2, warmup=1)
    moved = fetched = 0
    for s_row, c_row, p_row in zip(sstore.blocks, scs.blocks, parts):
        for blk, cblk, part in zip(s_row, c_row, p_row):
            m, f = fanin_traffic(blk, cblk, part[5])
            moved, fetched = moved + m, fetched + f
    # As K1's count: 16 int32 instructions per valid entry.
    ops = int(cs.valid.sum()) * 16
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / OPS_PER_S * 1e3
    ms = float(np.median(runs))
    results["fanin_batch_sharded"] = dict(
        name="fanin_batch_sharded", route="cuda",
        source="crdt_tpu_torch/csrc/fanin_batch.cu",
        replaces="crdt_tpu/parallel/fanin.py:263",
        max_abs_err=max(err, err_u), ms=ms, plain_ms=plain_ms,
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        library_ms=None, mesh=dict(mesh.shape), shape=list(cs.lt.shape),
        ms_is="the one launch over the four blocks of one merge",
        launches_per_merge=launches, ms_runs=runs,
        four_launches_ms=float(np.median(sep_runs)),
        four_launches_ms_runs=sep_runs, call_ms=call_ms,
        combine_ms=float(np.median(comb_runs)), combine_ms_runs=comb_runs,
        step_ms=step_ms, unsharded_k1_ms=float(np.median(k1_runs)),
        bytes_moved=moved, bytes_fetched=fetched, ops=ops, ops_ms=ops_ms)
    del cs, store, sstore, scs, parts, k_store, p_store, u_store


def check_copies(store, what: str) -> None:
    """Every replica copy of every key shard equals the rank-0 copy."""
    for k, first in enumerate(store.blocks[0]):
        for blk in store.column(k):
            check(max_abs_err(blk, first) == 0,
                  f"{what}: replica copies of key shard {k} differ")


def stream_traffic(store: DenseStore, cs: DenseChangeset,
                   win: torch.Tensor) -> int:
    """Bytes one stream replay must move, in 32-B sectors: valid of
    every entry, lt/node where a sector holds a valid entry, val/tomb of
    the entry that wins its slot, the store's lt/node/occupied, its
    val/tomb/mod lanes where it keeps the slot, and the eight outputs
    once. The chunks re-read nothing the function needs from memory."""
    r, n = cs.lt.shape
    final = winner_rows(cs.lt, cs.node, cs.valid, win)
    return (r * n + sector_bytes(cs.valid, 4) + sector_bytes(cs.valid, 8)
            + sector_bytes(final, 4) + sector_bytes(final, 32) + n * 13
            + 2 * sector_bytes(~win, 4) + sector_bytes(~win, 8)
            + sector_bytes(~win, 32) + n * (8 + 4 + 8 + 1 + 8 + 4 + 1 + 1))


# --- phase 2: the kernel probes (P1, P2) ------------------------------

PROBE_ROWS = 8                   # the probe CLI's --chunk
PROBE_CHUNKS = 128               # --replicas 1024 // --chunk 8
BATCH_ROWS = 128                 # the probe CLI's --rows
OUT_BYTES = 40                   # the ten int32 output words of a slot


def probe_inputs(rows: int, seed: int, narrow: bool = False):
    """A split store and ``[rows, 2^20]`` split lanes at a probe's CLI
    shape, from the wide generators above, with the ties of
    `plant_ties`, malformed sentinels (hi = NEG_HI, lo != 0) in the last
    row, whole-range ``hi`` words every 97th slot and node words near
    int16's top every 89th (so the sums wrap), and stale store records
    (node 0, every 10th slot from 2) just over 1 ms above their column's
    max key, which chunks 0-1 of a replay lose to and chunk 2 beats."""
    wide = make_store(N_SLOTS, seed)
    cs = make_changeset(rows, N_SLOTS, seed + 1)
    plant_ties(wide, cs)
    store = split_store(wide)
    scs = (split_changeset_narrow(cs._replace(val=cs.val >> 33))[0]
           if narrow else split_changeset(cs))
    del cs
    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 2)
    scs.hi[:, ::97] = torch.randint(-2 ** 31, 2 ** 31, scs.hi[:, ::97].shape,
                                    generator=g, device="cuda",
                                    dtype=torch.int32)
    scs.node[:, ::89] = 30_000 + (scs.node[:, ::89] & 0xFF)
    bad = torch.zeros_like(scs.hi, dtype=torch.bool)
    bad[rows - 1, ::4099] = True
    scs = scs._replace(hi=torch.where(bad, NEG_HI, scs.hi),
                       lo=torch.where(bad, 9, scs.lo.long()
                                      ).to(torch.uint32))
    key = join64(scs.hi, scs.lo)
    top = key.amax(0)
    stale = torch.zeros_like(wide.occupied)
    stale[2::10] = True
    stale &= (scs.hi != NEG_HI).all(0) & (top < 2 ** 62)
    top += (1 << SHIFT) + 5
    store = store._replace(
        hi=torch.where(stale, (top >> 32).to(torch.int32), store.hi),
        lo=torch.where(stale, top & 0xFFFFFFFF, store.lo.long()
                       ).to(torch.uint32),
        node=torch.where(stale, 0, store.node))
    return store, scs, stale


def probe_traffic(scs, win: torch.Tensor, n_chunks: int = 1) -> int:
    """Bytes a probe join must move on these inputs, in 32-B sectors, as
    `split_traffic` counts them with no node map: hi/lo/node of every
    entry (10 B), val_hi/val_lo/tomb only of the entry that wins its
    slot, the store's hi/lo/node, its other six words where it keeps
    the slot, and the ten outputs once. With ``n_chunks`` the winner is
    read at each entry's last visit: a moving entry's key advanced by
    the last chunk's offset (ties between a static and a moving entry
    are counted at the lower row)."""
    r, n = scs.hi.shape
    key = join64(scs.hi, scs.lo)
    if n_chunks > 1:
        key = key + torch.where(scs.hi != NEG_HI,
                                (n_chunks - 1) << SHIFT, 0)
    final = winner_rows(key, scs.node.to(torch.int32),
                        torch.ones_like(win).expand(r, n), win)
    return (r * n * 10 + 2 * sector_bytes(final, 8) + sector_bytes(final, 32)
            + n * 12 + 6 * sector_bytes(~win, 8) + n * OUT_BYTES)


def entry_bytes(scs) -> int:
    return sum(lane.element_size() for lane in scs)


def bound_fields(moved: int, ops: int) -> dict:
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / OPS_PER_S * 1e3
    return dict(bytes_moved=moved, bytes_ms=bytes_ms, ops=ops, ops_ms=ops_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def wraps(total: torch.Tensor, bits: int) -> bool:
    """Whether some exact sum leaves the signed ``bits``-bit range."""
    return bool(((total < -2 ** (bits - 1)) | (total >= 2 ** (bits - 1)))
                .any())


PROBE_SITES = {"probe_join": "benchmarks/probe_kernel.py:42",
               "probe_copy": "benchmarks/probe_kernel.py:82",
               "probe_stream_noguard": "benchmarks/probe_kernel.py:107",
               "probe_copy_batch": "benchmarks/probe_kernel.py:278"}


def time_probe(name: str, launch, plain, err: int, moved: int, ops: int,
               **extra) -> dict:
    """A probe's record: device time from a replayed graph of 20
    launches, the plain version's time and the bound."""
    runs = graph_ms(launch, iters=20)
    return dict(
        name=name, route="cuda", source=f"crdt_tpu_torch/csrc/{name}.cu",
        replaces=PROBE_SITES[name], max_abs_err=err,
        ms=float(np.median(runs)), plain_ms=cuda_ms(plain, iters=2,
                                                    warmup=1),
        library_ms=None, ms_runs=runs, **bound_fields(moved, ops), **extra)


def check_probe(name: str, k, p) -> int:
    torch.cuda.synchronize()
    err = max_abs_err(list(k[0]) + [k[1]], list(p[0]) + [p[1]])
    check(err == 0, f"{name} kernel != plain version (max |err| {err})")
    return err


def kernel_probes(results: dict) -> None:
    """P1a, P1b and P1c at the probe CLI's shape (2^20 x 8 rows, 128
    chunks) and P2 at its batch shape (2^20 x 128 rows in groups of 16,
    wide and value-ref), each against its plain version bit for bit."""
    canonical = (MILLIS + 500) << SHIFT
    scalars = probe.probe_scalars(canonical, 3,
                                  canonical + (0x7ABC << SHIFT) + 0xFFFF)
    store, scs, stale = probe_inputs(PROBE_ROWS, 50)
    r, n = scs.hi.shape
    # Per entry, as int32 instructions: the lex compare (hi >, hi ==,
    # lo >, lo ==, node > and their combination: 8) and the selects of
    # hi, lo, node and row (4); the stream probe adds the sentinel test
    # and the choice between S and M (3) and needs one pass over the
    # rows, not one per chunk (its closed form). Per slot: loads, the
    # stamp selects and stores (12). The copy: two adds per entry, ten
    # per slot.
    per_entry = dict(probe_join=12, probe_copy=2, probe_stream_noguard=15)
    for name, args in (("probe_join", (scalars,)),
                       ("probe_copy", (scalars,)),
                       ("probe_stream_noguard", (scalars, PROBE_CHUNKS))):
        fn = getattr(probe, name)
        plain = getattr(probe, f"{name}_reference")
        k = fn(store, scs, *args)
        err = check_probe(name, k, plain(store, scs, *args))
        win = k[1] != 0
        extra = dict(shape=[r, n])
        if name == "probe_copy":
            check(wraps(scs.hi.long().sum(0) + store.hi, 32),
                  "probe_copy: no int32 hi sum wrapped")
            moved = n * (r * 8 + 11 + 36 + OUT_BYTES)
        else:
            check(bool(win.any()) and not bool(win.all()),
                  f"{name}: degenerate win mask")
            moved = probe_traffic(scs, win, args[-1] if len(args) > 1
                                  else 1)
        if name == "probe_join":
            check(not bool(win[stale].any()),
                  "probe_join: a stale store record lost")
        if name == "probe_stream_noguard":
            check(bool(stale.any()) and bool(win[stale].all()) and bool(
                (k[0].mod_hi[stale] == scalars[5]).all()),
                  "probe_stream_noguard: stale store records were not "
                  "beaten by a later chunk")
            extra.update(n_chunks=PROBE_CHUNKS, planted=probe_planted())
        results[name] = time_probe(
            name, lambda: fn(store, scs, *args),
            lambda: plain(store, scs, *args), err, moved,
            r * n * per_entry[name] + n * 12, **extra)
        print(f"  {name} [{r}, {n}]: bit-exact, {results[name]['ms']:.4f} ms")
    del store, scs
    forms = {}
    for form in ("wide", "valref"):
        store, scs, _ = probe_inputs(BATCH_ROWS, 60, narrow=form == "valref")
        r, n = scs.hi.shape
        err = check_probe(f"probe_copy_batch ({form})",
                          probe.probe_copy_batch(store, scs),
                          probe.probe_copy_batch_reference(store, scs))
        check(wraps(scs.node.long().reshape(
            r // probe.CHUNK_ROWS, probe.CHUNK_ROWS, n).sum(1), 16),
              "probe_copy_batch: no int16 node sum wrapped")
        moved = n * (r * entry_bytes(scs) + 36 + OUT_BYTES)
        # Per entry one add per lane (5 or 6) and the tomb widening.
        forms[form] = time_probe(
            "probe_copy_batch", lambda: probe.probe_copy_batch(store, scs),
            lambda: probe.probe_copy_batch_reference(store, scs), err,
            moved, r * n * (len(scs) + 1) + n * 12, shape=[r, n],
            chunk_rows=probe.CHUNK_ROWS)
        forms[form]["bytes_per_s"] = moved / forms[form]["ms"] * 1e3
        print(f"  probe_copy_batch {form} [{r}, {n}]: bit-exact, "
              f"{forms[form]['ms']:.4f} ms")
        del store, scs
    results["probe_copy_batch"] = dict(
        forms["wide"], max_abs_err=max(d["max_abs_err"]
                                       for d in forms.values()),
        forms=forms)


def probe_planted() -> dict:
    """P1c against the chunk walk on the card at the planted inputs of
    ``tests/torch_probe_cases.py`` (a static entry beating the store, M
    tying S and the store, a wrapping and a non-carrying INT32_MAX
    entry, row ties, a malformed sentinel, no chunk winning, a stale
    store slot), 13 rows at an odd slot count, 1 to 128 chunks. Returns
    max |err| per chunk count."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    from torch_probe_cases import CHUNKS, SCALARS, probe_case_lanes
    errs = {}
    for n_chunks in CHUNKS:
        st, cs = probe_case_lanes(13, n_chunks, n=4097)
        st = type(st)(*(torch.tensor(x, device="cuda") for x in st))
        cs = type(cs)(*(torch.tensor(x, device="cuda") for x in cs))
        errs[str(n_chunks)] = check_probe(
            f"probe_stream_noguard (planted, {n_chunks} chunks)",
            probe.probe_stream_noguard(st, cs, SCALARS, n_chunks),
            probe.probe_stream_noguard_reference(st, cs, SCALARS, n_chunks))
    return errs


def guard_cost(results: dict) -> None:
    """K3 in fast mode (the launch alone) and P1c timed in turns from
    replayed graphs, on the same replay (2^20 x 8 rows x 128 chunks:
    `stream_inputs`, P1c on its split lanes): both in closed form over
    the chunks, so K3 minus P1c is what the guards, the basemax and the
    wide lanes cost."""
    store, cs, canon, local = stream_inputs(30, False)
    wall = MILLIS + 10_000
    thresh = ((wall + MAX_DRIFT) << SHIFT) | 0xFFFF
    out = DenseStore(*(torch.empty_like(x) for x in store))
    res = stream_kernel.StreamResult(
        torch.empty((), dtype=torch.int64, device="cuda"),
        torch.empty_like(store.occupied),
        *(torch.empty((), dtype=torch.bool, device="cuda")
          for _ in range(2)))
    scratch = torch.empty(3, dtype=torch.int64, device="cuda")
    k3 = lambda: stream_kernel.launch_stream(
        store, cs, out, res, scratch, canon, local, thresh, STREAM_CHUNKS,
        False)
    sstore, scs = split_store(store), split_changeset(cs)
    scalars = probe.probe_scalars(int(canon), local, int(canon))
    p1c = lambda: probe.probe_stream_noguard(sstore, scs, scalars,
                                             STREAM_CHUNKS)
    check_probe("probe_stream_noguard (the stream replay's lanes)", p1c(),
                probe.probe_stream_noguard_reference(sstore, scs, scalars,
                                                     STREAM_CHUNKS))
    k3_runs, p1c_runs = [], []
    for _ in range(3):                       # K3, P1c, in turns
        k3_runs += graph_ms(k3, iters=100)
        p1c_runs += graph_ms(p1c, iters=100)
    k3_ms, p1c_ms = float(np.median(k3_runs)), float(np.median(p1c_runs))
    win = p1c()[1] != 0
    results["guard_cost"] = dict(
        shape=[STREAM_ROWS, N_SLOTS, STREAM_CHUNKS], k3_fast_ms=k3_ms,
        k3_fast_ms_runs=k3_runs, p1c_ms=p1c_ms, p1c_ms_runs=p1c_runs,
        k3_minus_p1c_ms=k3_ms - p1c_ms,
        k3_bytes_moved=stream_traffic(store, cs, res.win),
        p1c_bytes_moved=probe_traffic(scs, win, STREAM_CHUNKS))
    print(f"  K3 fast {k3_ms:.4f} ms, P1c {p1c_ms:.4f} ms on the same replay: "
          f"K3 - P1c = {k3_ms - p1c_ms:.4f} ms")
    del store, cs, sstore, scs, out


# --- phase 3: the main path ------------------------------------------


def flush_inputs(f: int, n: int = N_SLOTS, rows: int = FLUSH_ROWS):
    rng = np.random.default_rng(100 + f)
    slots = rng.choice(n, rows, replace=False)
    return slots, rng.integers(-2 ** 62, 2 ** 62, rows), \
        rng.random(rows) < 0.2


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


def flush_split(flushes: int = 4) -> dict:
    """An ingest flush of the main path split apart on the host clock:
    staging (``put_batch``), dedup and slot order (the flush less its
    commit: the stamp, the one sort and the staged lanes' gather),
    padding and host-to-device copies (`_flush_lanes`), and the kernel's
    wrapper (checks and launch). Each part is timed on the replica's own
    methods, synchronized, so the same function splits any tree whose
    model has these methods. Then the same flushes on a second replica
    under the profiler: the kernel's device time as the main path sees
    it (its L2 state left by the flushes before) and the copies'. Last,
    the plain ingest window over the same inputs, made beforehand, on
    three fresh replicas: a flush end to end, without the wrappers'
    synchronizations or the main path's input generation."""
    from crdt_tpu_torch.models import dense_crdt as model
    spent = dict(stage=0.0, flush=0.0, commit=0.0, lanes=0.0, kernel=0.0)

    def timed(part, fn):
        def run(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            spent[part] += time.perf_counter() - t0
            return out
        return run

    def replica(timing: bool):
        crdt = DenseCrdt("n0", N_SLOTS, node_ids=IDS,
                         wall_clock=StepClock(MILLIS))
        if timing:
            crdt._commit_scatter = timed("commit", crdt._commit_scatter)
            crdt._flush_lanes = timed("lanes", crdt._flush_lanes)
        return crdt

    def run(crdt, timing: bool):
        with crdt.ingest(auto_flush_rows=FLUSH_ROWS + 1) as wc:
            for f in range(flushes):
                inputs = flush_inputs(f)
                t0 = time.perf_counter()
                crdt.put_batch(*inputs)
                if timing:
                    spent["stage"] += time.perf_counter() - t0
                (timed("flush", wc.flush) if timing else wc.flush)()

    kernel = model.ingest_scatter
    model.ingest_scatter = timed("kernel", kernel)
    try:
        run(replica(True), True)
    finally:
        model.ingest_scatter = kernel
    profiled = replica(False)
    dev = device_ms(lambda: run(profiled, False))
    inputs = [flush_inputs(f) for f in range(flushes)]
    window_s = []
    for _ in range(3):
        crdt = replica(False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with crdt.ingest(auto_flush_rows=FLUSH_ROWS):
            for x in inputs:
                crdt.put_batch(*x)
        torch.cuda.synchronize()
        window_s.append(time.perf_counter() - t0)
    per = {k: v / flushes for k, v in spent.items()}
    kern = sum(v for k, v in dev.items() if "ingest_scatter" in k)
    copies = sum(v for k, v in dev.items() if "Memcpy HtoD" in k)
    return dict(flushes=flushes, stage_s=per["stage"],
                commit_s=per["flush"],
                dedup_and_order_s=per["flush"] - per["commit"],
                pad_and_copy_s=per["lanes"], kernel_call_s=per["kernel"],
                kernel_device_ms=kern / flushes if dev else None,
                copies_device_ms=copies / flushes if dev else None,
                flush_s=[w / flushes for w in window_s])


def breakdown() -> dict:
    """Where the main path's host-clock time goes, measured apart from
    the counted run: the window's data generation alone (same seeds),
    and the ingest flush split (`flush_split`)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p in range(PASSES):
        make_changeset(ROWS_PER_PASS, N_SLOTS, 1000 + p)
    torch.cuda.synchronize()
    generation_s = time.perf_counter() - t0
    split = flush_split()
    return dict(window_generation_s=generation_s,
                flush_stage_s=split["stage_s"],
                flush_commit_s=split["commit_s"], flush_split=split)


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


class RefReplica:
    """The plain fold of a receiver's merges on the card: the merged
    lanes and clock path A is held against."""

    def __init__(self, ids: list, node_id: str, start: int):
        self.store = empty_dense_store(N_SLOTS, "cuda")
        self.canon = Hlc(0, 0, node_id)
        self.clock = StepClock(start)
        self.ids = ids
        self.node_id = node_id

    def merge_split(self, scs, peer_ids: list, expect_bad=False) -> None:
        wide = split_to_wide(scs)
        remap = torch.tensor([self.ids.index(i) for i in peer_ids],
                             dtype=torch.int32, device="cuda")
        wide = wide._replace(node=torch.where(
            wide.valid, remap[wide.node.long().clamp(0, len(peer_ids) - 1)],
            0))
        wall = self.clock()
        self.store, res = fanin_step(self.store, wide,
                                     self.canon.logical_time,
                                     self.ids.index(self.node_id), wall)
        check(bool(res.any_bad) == expect_bad,
              "reference merge: unexpected guard result")
        self.canon = Hlc.send(Hlc.from_logical_time(
            int(res.new_canonical), self.node_id), millis=self.clock())

    def check_against(self, crdt: DenseCrdt, what: str) -> None:
        err = max_abs_err(crdt.store, self.store)
        check(err == 0, f"{what}: lanes differ from the plain fold "
                        f"(max |err| {err})")
        check(crdt.canonical_time.logical_time == self.canon.logical_time,
              f"{what}: canonical clock differs from the plain fold")


def peer_replica(value_width: int, flushes: int, start: int):
    """A JAX-style peer: ingest flushes, then its split wire delta."""
    peer = DenseCrdt("p0", N_SLOTS, node_ids=PEER_IDS,
                     value_width=value_width, wall_clock=StepClock(start))
    with peer.ingest(auto_flush_rows=FLUSH_ROWS):
        for f in range(flushes):
            slots, vals, tombs = flush_inputs(f)
            if value_width == 32:
                vals = vals >> 33
            peer.put_batch(slots, vals, tombs)
    scs, ids = peer.export_split_delta()
    wide = split_to_wide(scs)
    occ = peer.store.occupied
    check(bool(torch.equal(wide.valid[0], occ)) and all(
        torch.equal(getattr(wide, f)[0][occ], getattr(peer.store, f)[occ])
        for f in ("lt", "node", "val", "tomb")),
          "export_split_delta lanes differ from the peer's store")
    check(scs.hi.dim() == 3, "export_split_delta: expected tiled lanes")
    return scs, ids


def generated_split(rows: int, seed: int, narrow: bool):
    """Replica rows generated on the card in the JAX wire dtypes, with
    the peer's ordinals (1..8)."""
    cs = make_changeset(rows, N_SLOTS, seed)
    if narrow:
        return split_changeset_narrow(cs._replace(val=cs.val >> 33))[0]
    return split_changeset(cs)


def path_a(card: str) -> dict:
    """The JAX-peer interchange at 2^20 slots (see the module doc)."""
    start = MILLIS + 500
    peer_scs, peer_ids = peer_replica(64, PEER_FLUSHES, MILLIS + 400)
    peer32_scs, _ = peer_replica(32, 2, MILLIS + 450)
    rcv = DenseCrdt("r0", N_SLOTS, node_ids=RCV_IDS,
                    wall_clock=StepClock(start))
    rcv32 = DenseCrdt("r0", N_SLOTS, node_ids=RCV_IDS, value_width=32,
                      wall_clock=StepClock(start))
    dup = DenseChangeset(*(torch.zeros((1, N_SLOTS), dtype=dt, device="cuda")
                           for dt in CHANGESET_DTYPES.values()))
    dup.valid[0, 77] = True
    dup.node[0, 77] = RCV_IDS.index("r0")
    dup.lt[0, 77] = (MILLIS + 5000) << SHIFT
    dup_scs = split_changeset(dup)
    torch.cuda.synchronize()

    obs_device.reset()
    seen0 = rcv.stats.records_seen
    t0 = time.perf_counter()
    with rcv.pipelined():                   # exit = ONE readback
        for p in range(PASSES):
            rcv.merge_split(generated_split(ROWS_PER_PASS, 3000 + p, False),
                            PEER_IDS)
    t_window = time.perf_counter() - t0
    merged = rcv.stats.records_seen - seen0
    t0 = time.perf_counter()
    rcv.merge_split(peer_scs, peer_ids)
    torch.cuda.synchronize()
    t_export_merge = time.perf_counter() - t0
    try:
        with rcv.pipelined(exact_guards=True):
            rcv.merge_split(dup_scs, RCV_IDS)
    except DuplicateNodeException:
        pass
    else:
        raise Failure("exact window did not raise DuplicateNodeException")
    with rcv32.pipelined():
        for p in range(2):
            rcv32.merge_split(generated_split(ROWS_PER_PASS, 4000 + p, True),
                              PEER_IDS)
    rcv32.merge_split(peer32_scs, peer_ids)
    torch.cuda.synchronize()
    launches = obs_device.launches()
    want = PASSES + 2 + 2 + 1
    check(launches["fanin_split"] == want,
          f"path A launched fanin_split {launches['fanin_split']} times, "
          f"expected {want}")

    ref = RefReplica(RCV_IDS, "r0", start)
    for p in range(PASSES):
        ref.merge_split(generated_split(ROWS_PER_PASS, 3000 + p, False),
                        PEER_IDS)
    ref.merge_split(peer_scs, peer_ids)
    ref.merge_split(dup_scs, RCV_IDS, expect_bad=True)
    ref.check_against(rcv, "path A (wide)")
    ref32 = RefReplica(RCV_IDS, "r0", start)
    for p in range(2):
        ref32.merge_split(generated_split(ROWS_PER_PASS, 4000 + p, True),
                          PEER_IDS)
    ref32.merge_split(peer32_scs, peer_ids)
    ref32.check_against(rcv32, "path A (narrow)")
    # The window's row generation and split alone, apart from the run.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p in range(PASSES):
        generated_split(ROWS_PER_PASS, 3000 + p, False)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    return dict(card=card, n_slots=N_SLOTS, passes=PASSES,
                rows_per_pass=ROWS_PER_PASS, records_merged=merged,
                window_s=t_window, merges_per_s=merged / t_window,
                window_includes_generation=True,
                window_generation_s=t_gen,
                export_rows=int((peer_scs.hi != NEG_HI).sum()),
                export_merge_s=t_export_merge, narrow_passes=2,
                launches=launches)


def path_b(card: str) -> dict:
    """bench.py's default stream mode on the card: 64 chained replays of
    one 8-row changeset x 128 chunks, the canonical threaded from call
    to call (bench.py:237-245), one readback at the end."""
    store = make_store(N_SLOTS, 40)
    cs = make_changeset(STREAM_ROWS, N_SLOTS, 41)
    canon0 = torch.tensor((MILLIS + 500) << SHIFT, device="cuda")
    wall = MILLIS + 10_000
    stream_kernel.fanin_stream(store, cs, canon0, 0, wall,
                               n_chunks=STREAM_CHUNKS, guards="fast")
    torch.cuda.synchronize()
    obs_device.reset()
    canon = canon0
    t0 = time.perf_counter()
    for _ in range(STREAM_LAUNCHES):
        _, res = stream_kernel.fanin_stream(store, cs, canon, 0, wall,
                                            n_chunks=STREAM_CHUNKS,
                                            guards="fast")
        canon = res.new_canonical
    final = int(canon)
    seconds = time.perf_counter() - t0
    launches = obs_device.launches()
    check(launches["fanin_stream"] == STREAM_LAUNCHES,
          f"path B launched fanin_stream {launches['fanin_stream']} times")
    basemax = int(torch.where(cs.valid, cs.lt, _NEG).amax())
    check(final == max(int(canon0),
                       basemax + ((STREAM_CHUNKS - 1) << SHIFT)),
          "path B: threaded canonical differs from the closed form")
    check(not bool(res.any_dup | res.any_drift), "path B: a guard flagged")
    valid = int(cs.valid.sum())
    return dict(card=card, n_slots=N_SLOTS, rows=STREAM_ROWS,
                n_chunks=STREAM_CHUNKS, launches_chained=STREAM_LAUNCHES,
                valid_entries=valid, seconds=seconds,
                ms_per_call=seconds / STREAM_LAUNCHES * 1e3,
                record_merges_per_s=valid * STREAM_CHUNKS * STREAM_LAUNCHES
                / seconds, launches=launches)


# Path C: the sharded replication loop. The (2, 2) mesh runs at the main
# path's full size; the (1, 1) and multislice (2, 1, 2) meshes once each
# at a smaller depth, so the whole script stays well inside its limit.
SHARDED_RUNS = (((2, 2), N_SLOTS, FLUSHES, FLUSH_ROWS, PASSES),
                ((1, 1), 1 << 16, 2, 4096, 2),
                ((2, 1, 2), 1 << 16, 2, 4096, 2))


def sharded_ops(crdt, n: int, flushes: int, flush_rows: int,
                passes: int) -> dict:
    """Path C's protocol on one replica, sharded or not: ingest flushes,
    a coarse window of ``passes`` x 128 generated rows, one unpipelined
    merge_many, an exact window that must raise DuplicateNodeException,
    and a 4,096-row delta out. Returns the timings, the exception and
    the delta's three forms."""
    out = {}
    t0 = time.perf_counter()
    with crdt.ingest(auto_flush_rows=flush_rows) as wc:
        for f in range(flushes):
            crdt.put_batch(*flush_inputs(f, n, flush_rows))
    sync_all()
    out["ingest_s"] = time.perf_counter() - t0
    check(wc.flushes == flushes, f"expected {flushes} flushes, got "
                                 f"{wc.flushes}")
    seen0 = crdt.stats.records_seen
    t0 = time.perf_counter()
    with crdt.pipelined():                   # exit = ONE readback
        for p in range(passes):
            crdt.merge(make_changeset(ROWS_PER_PASS, n, 5000 + p), IDS)
    out["window_s"] = time.perf_counter() - t0
    out["records_merged"] = crdt.stats.records_seen - seen0
    crdt.merge_many([(make_changeset(4, n, 6000 + i), IDS)
                     for i in range(2)])
    dup = DenseChangeset(*(torch.zeros((1, n), dtype=dt, device="cuda")
                           for dt in CHANGESET_DTYPES.values()))
    dup.valid[0, 77] = True                  # "n0": this replica's own id
    dup.lt[0, 77] = crdt.canonical_time.logical_time + (5000 << SHIFT)
    try:
        with crdt.pipelined(exact_guards=True):
            crdt.merge(make_changeset(4, n, 7000), IDS)
            crdt.merge(dup, IDS)
    except DuplicateNodeException as e:
        out["error"] = e
    else:
        raise Failure("exact window did not raise DuplicateNodeException")
    since = crdt.canonical_time
    rng = np.random.default_rng(8)
    with crdt.ingest():
        crdt.put_batch(rng.choice(n, DELTA_ROWS, replace=False),
                       rng.integers(0, 1 << 40, DELTA_ROWS))
    t0 = time.perf_counter()
    cs, _ = crdt.export_delta(since)
    packed, _ = crdt.pack_since(since)
    wire = crdt.to_json(since)
    out["deltas_s"] = time.perf_counter() - t0
    out["delta"] = (cs, packed, wire)
    return out


def sharded_storage(crdt, twin, what: str) -> dict:
    """The sharded digest tree and compaction against the unsharded
    model: the tree equals the twin's; each key shard compacts to its
    own prefix, so the translation equals the twin's compaction over
    the key shards' spans; the lanes, the seeded trees and every
    replica copy stay equal."""
    torch.cuda.synchronize()
    obs_device.reset()
    t0 = time.perf_counter()
    tree = crdt.digest_tree()
    digest_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    translation = crdt.compact()
    torch.cuda.synchronize()
    compact_s = time.perf_counter() - t0
    ops = obs_device.op_launches()
    twin_tree = twin.digest_tree()
    check(trees_equal(tree, twin_tree),
          f"{what}: the sharded digest tree differs from the unsharded one")
    w = crdt._store.width
    spans = tuple((lo, lo + w) for lo in range(0, crdt.n_slots, w))
    check(np.array_equal(translation, twin.compact(ranges=spans)),
          f"{what}: the sharded compaction's translation differs")
    check(max_abs_err(crdt.store, twin.store) == 0,
          f"{what}: lanes after compact differ from the unsharded model")
    check(trees_equal(crdt.digest_tree(), twin.digest_tree()),
          f"{what}: the seeded trees differ after compact")
    check_copies(crdt._store, f"{what} after compact")
    return dict(digest_s=digest_s, compact_s=compact_s, ops=ops,
                live_rows=len(crdt))


def path_c(card: str) -> dict:
    """ShardedDenseCrdt on meshes that repeat the card, each run held
    against the unsharded DenseCrdt given the same ops: equal lanes,
    clock, delta (changeset, packed bytes, JSON) and exception; every
    replica copy equal."""
    runs = []
    for shape, n, flushes, flush_rows, passes in SHARDED_RUNS:
        devices = one_card(int(np.prod(shape)))
        mesh = (parallel.make_multislice_fanin_mesh(*shape, devices)
                if len(shape) == 3 else
                parallel.make_fanin_mesh(*shape, devices))
        start = MILLIS + 500
        crdt = ShardedDenseCrdt("n0", n, mesh, node_ids=IDS,
                                wall_clock=StepClock(start))
        torch.cuda.synchronize()
        obs_device.reset()
        got = sharded_ops(crdt, n, flushes, flush_rows, passes)
        torch.cuda.synchronize()
        launches = obs_device.launches()
        positions = len(mesh.devices.flat)
        devices = len(set(mesh.devices.flat))
        k_shards = mesh.shape[parallel.KEY_AXIS]
        # K1p: one launch per device and merge; K2: one per copy and flush.
        want = dict(fanin_batch_sharded=devices * (passes + 3),
                    ingest_scatter=positions * (flushes + 1))
        check(all(launches[k] == v for k, v in want.items())
              and launches["fanin_batch"] == 0,
              f"path C {shape}: launches {launches}, expected {want}")
        twin = DenseCrdt("n0", n, node_ids=IDS, wall_clock=StepClock(start))
        ref = sharded_ops(twin, n, flushes, flush_rows, passes)
        what = f"path C {shape}"
        err = max_abs_err(crdt.store, twin.store)
        check(err == 0, f"{what}: lanes differ from the unsharded model "
                        f"(max |err| {err})")
        check(crdt.canonical_time == twin.canonical_time,
              f"{what}: canonical clock differs from the unsharded model")
        e1, e2 = got.pop("error"), ref.pop("error")
        check(type(e1) is type(e2) and e1.args == e2.args,
              f"{what}: exception {e1!r} != {e2!r}")
        (c1, p1, w1), (c2, p2, w2) = got.pop("delta"), ref.pop("delta")
        check(max_abs_err(c1, c2) == 0 and w1 == w2 and all(
            getattr(p1, f).tobytes() == getattr(p2, f).tobytes()
            for f in ("slots", "lt", "node", "val", "tomb"))
            and p1.k == DELTA_ROWS, f"{what}: deltas differ")
        if n < N_SLOTS:
            check(crdt.to_json() == twin.to_json(),
                  f"{what}: to_json differs")
        check_copies(crdt._store, what)
        storage = sharded_storage(crdt, twin, what)
        runs.append(dict(
            mesh=dict(mesh.shape), n_slots=n, flushes=flushes,
            flush_rows=flush_rows, merge_passes=passes,
            rows_per_pass=ROWS_PER_PASS, key_shards=k_shards,
            ingest_rows_per_s=flushes * flush_rows / got["ingest_s"],
            merges_per_s=got["records_merged"] / got["window_s"],
            twin_merges_per_s=ref["records_merged"] / ref["window_s"],
            window_includes_generation=True, launches=launches,
            storage=storage, **got, twin=ref))
        del crdt, twin
    head = runs[0]
    return dict(card=card, launches=head["launches"], runs=runs)


# Path D: the probe entry point and the fan-in rows at the JAX CLI's
# defaults, then the copy rate they are read against.
# Path E: packed and JSON deltas between torch replicas at 2^20 slots.
# The peer's deltas: 262,144 rows (the wide join: 262,144 x 4 = 2^20),
# then 65,536 and 4,096 (the sparse join), then 4,096 rows as JSON.
E_DELTAS = (("wide", 4 * FLUSH_ROWS), ("sparse_65536", FLUSH_ROWS),
            ("sparse_4096", DELTA_ROWS), ("json_4096", DELTA_ROWS))
TWINS = {"card": "cuda", "host": "cpu"}    # each replica and its twin


class MethodClock:
    """Host seconds spent in some of a replica's methods (path E: the
    store join; path F: the digest, the packs, the merges), each call
    synchronized; a call made inside another timed call is not counted
    again. Ranged packs' lanes are kept as bytes, for a twin's to be
    held against."""

    def __init__(self, crdt, names):
        self.s = dict.fromkeys(names, 0.0)
        self.packs = []
        self.depth = 0
        for name in names:
            setattr(crdt, name, self._timed(name, getattr(crdt, name)))

    def _timed(self, name, fn):
        def run(*args, **kw):
            self.depth += 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kw)
                torch.cuda.synchronize()
            finally:
                self.depth -= 1
            if not self.depth:
                self.s[name] += time.perf_counter() - t0
            if name == "pack_since" and kw.get("ranges") is not None:
                self.packs.append([None if lane is None else lane.tobytes()
                                   for lane in out[0]])
            return out
        return run


def gossip_warmup() -> None:
    """Each merge route once on a small card replica, so the timed
    merges do not pay the first launch of torch's kernels."""
    from crdt_tpu_torch.ops.packing import pack_rows, unpack_rows
    n = 4096
    src = DenseCrdt("w0", n, wall_clock=StepClock(MILLIS))
    dst = DenseCrdt("w1", n, wall_clock=StepClock(MILLIS))
    rng = np.random.default_rng(9)
    for rows in (1500, 100):          # the wide join, then the sparse
        since = Hlc.from_logical_time(
            src.canonical_time.logical_time + 1, "w0")
        src.put_batch(rng.choice(n, rows, replace=False),
                      rng.integers(0, 99, rows))
        meta, bufs = pack_rows(src.pack_since(since)[0])
        dst.merge_packed(unpack_rows(meta, b"".join(map(bytes, bufs))),
                         src.pack_since()[1])
    dst.merge_and_repack(*src.pack_since(since), since)
    dst.merge_json(src.to_json(since))
    torch.cuda.synchronize()


def path_e(card: str) -> dict:
    """Gossip between torch replicas through the wire forms (see the
    module doc): a peer's ``pack_since`` deltas framed by ``pack_rows``
    and read back by ``unpack_rows`` into ``merge_packed`` on a
    receiver, one relay through ``merge_and_repack`` on a second
    receiver, one ``to_json`` into ``merge_json``. Every replica has a
    twin on the CPU given the same operations; lanes, clocks and every
    frame's bytes must be equal."""
    from crdt_tpu_torch.ops.packing import pack_rows, unpack_rows
    perm = np.random.default_rng(500).permutation(N_SLOTS)
    cuts = np.cumsum([0] + [rows for _, rows in E_DELTAS])

    def replicas(node_id, start):
        return {role: DenseCrdt(node_id, N_SLOTS, device=dev,
                                wall_clock=StepClock(start))
                for role, dev in TWINS.items()}

    def flush(crdts, slots, seed):
        rng = np.random.default_rng(seed)
        vals = rng.integers(-2 ** 62, 2 ** 62, len(slots))
        tombs = rng.random(len(slots)) < 0.2
        for c in crdts.values():
            with c.ingest(auto_flush_rows=FLUSH_ROWS):
                c.put_batch(slots, vals, tombs)

    def frame(delta):
        meta, bufs = pack_rows(delta)
        return meta, b"".join(bytes(b) for b in bufs)

    # Receivers first: their flushes sit between the peer's early and
    # late ones (StepClock: one millisecond a flush), so on shared slots
    # some of the peer's rows win and some lose, ties included.
    rcv, relay = replicas("r0", MILLIS + 500), replicas("q0", MILLIS + 500)
    # A third receiver on the card takes the same merges under the
    # profiler: each merge's device time, apart from the timed run.
    rcv["profiled"] = DenseCrdt("r0", N_SLOTS, device=TWINS["card"],
                                wall_clock=StepClock(MILLIS + 500))
    for f in range(2):
        slots = flush_inputs(600 + f)[0]
        flush(rcv, slots, 610 + f)
        flush(relay, slots, 620 + f)
    peer = replicas("p0", MILLIS + 499)
    deltas = {}
    obs_device.reset()
    for (name, rows), lo, hi in zip(E_DELTAS, cuts[:-1], cuts[1:]):
        # One past the clock: the bound is inclusive, and the last
        # flush's rows carry the clock itself.
        since = Hlc.from_logical_time(
            peer["card"].canonical_time.logical_time + 1, "p0")
        flush(peer, perm[lo:hi], 700 + lo)
        if name.startswith("json"):
            wires = [c.to_json(since) for c in peer.values()]
        else:
            wires = [frame(c.pack_since(since)[0]) for c in peer.values()]
        check(wires[0] == wires[1], f"path E: the peer's {name} delta "
                                    "differs between card and host")
        deltas[name] = wires[0]
    ids = peer["card"].pack_since()[1]
    check(len(json.loads(deltas["json_4096"])) == DELTA_ROWS,
          "path E: the JSON delta's size")

    def merge(c, name, rows):
        if name.startswith("json"):
            c.merge_json(deltas[name])
            return 0.0
        w0 = time.perf_counter()
        delta = unpack_rows(*deltas[name])
        wire_s = time.perf_counter() - w0
        check(delta.k == rows, f"path E: {name} holds {delta.k} rows")
        c.merge_packed(delta, ids)
        return wire_s

    gossip_warmup()
    merges = {}
    # Each merge's store join (`DenseCrdt._dispatch_columns`) timed
    # apart from the host's decode and validation.
    clocks = {role: MethodClock(rcv[role], ("_dispatch_columns",))
              for role in TWINS}
    for name, rows in E_DELTAS:
        out = {}
        for role in TWINS:
            before = clocks[role].s["_dispatch_columns"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wire_s = merge(rcv[role], name, rows)
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
            join_s = clocks[role].s["_dispatch_columns"] - before
            out[role] = dict(seconds=total, rows_per_s=rows / total,
                             unpack_s=wire_s, join_s=join_s,
                             decode_and_validate_s=total - join_s - wire_s)
        dev = device_ms(lambda: merge(rcv["profiled"], name, rows))
        busy = sum(dev.values()) if dev else None
        out["card"].update(device_ms=busy, device_ms_by_op=dev,
                           idle_share=None if busy is None
                           else 1 - busy / 1e3 / out["card"]["seconds"])
        merges[name] = dict(rows=rows, route="wide" if rows * 4 >= N_SLOTS
                            else "sparse", card=out["card"],
                            host_twin_s=out["host"]["seconds"])
        print(f"  path E {name}: {rows} rows in "
              f"{out['card']['seconds']:.4f} s on the card "
              f"({out['card']['rows_per_s']:.0f} rows/s; decode and "
              f"validation {out['card']['decode_and_validate_s']:.4f} s, "
              f"join {out['card']['join_s']:.4f} s, device busy "
              f"{busy if busy is None else round(busy, 4)} ms)")
    for c in rcv.values():
        check(c.stats.records_adopted > 0, "path E: nothing won")

    # The relay: the 65,536-row delta through merge_and_repack.
    since = relay["card"].canonical_time
    relayed, times = [], []
    for c in relay.values():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_delta, out_ids = c.merge_and_repack(
            unpack_rows(*deltas["sparse_65536"]), ids, since)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        relayed.append(frame(out_delta))
        check(c.pack_since(since)[0] is out_delta,
              "path E: the relay did not seed the pack cache")
    check(relayed[0] == relayed[1], "path E: relayed bytes differ between "
                                    "card and host")
    adopted = relay["card"].stats.records_adopted
    launches = obs_device.launches()

    check(max_abs_err(rcv["card"].store, rcv["profiled"].store) == 0,
          "path E: the profiled receiver differs from the timed one")
    for group, what in ((rcv, "receiver"), (relay, "relay"),
                        (peer, "peer")):
        err = max_abs_err(group["card"].store, [
            x.to(TWINS["card"]) for x in group["host"].store])
        check(err == 0, f"path E: the {what}'s lanes differ from its host "
                        f"twin (max |err| {err})")
        check(group["card"].canonical_time == group["host"].canonical_time,
              f"path E: the {what}'s clock differs from its host twin")
    k_out = relayed[0][0]["lanes"][0][2][0]
    check(0 < k_out and adopted > 0, "path E: the relay adopted nothing")
    return dict(card=card, n_slots=N_SLOTS, merges=merges,
                relay=dict(rows=FLUSH_ROWS, seconds=times[0],
                           rows_per_s=FLUSH_ROWS / times[0],
                           host_twin_s=times[1], repacked_rows=k_out,
                           adopted=adopted),
                launches=launches)


# Path F: anti-entropy and storage at the main path's width. Two
# replicas seeded by the main path's flushes diverge two ways and
# converge through `sync_merkle`; then GC, a fenced replay and a
# compaction on one of them, and a snapshot round trip.
F_CASES = (("antientropy_8", 8), ("scatter_1pct", 10_486))
F_SNAPSHOT = os.path.join("chiprun_out", "path_f_snapshot.npz")
U64 = np.uint64


def mix64_u64(x: np.ndarray) -> np.ndarray:
    """splitmix64's finalizer in numpy uint64."""
    x = (x ^ (x >> U64(30))) * U64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> U64(27))) * U64(0x94D049BB133111EB)
    return x ^ (x >> U64(31))


def numpy_root(store: DenseStore, leaf_width: int = 8) -> int:
    """The digest root of a store folded on the host in numpy uint64,
    apart from the port's int64 emulation: the slot mix, the leaf sums,
    the pairwise combines."""
    lt, val, tomb, occ = (getattr(store, f).cpu().numpy()
                          for f in ("lt", "val", "tomb", "occupied"))
    n = len(lt)
    with np.errstate(over="ignore"):
        idx = np.arange(n, dtype=U64)
        h = mix64_u64(lt.view(U64) + U64(0x9E3779B97F4A7C15) * (idx + U64(1)))
        h ^= mix64_u64(val.view(U64) ^ U64(0x94D049BB133111EB))
        h ^= np.where(tomb, U64(0xD6E8FEB86659FD93), U64(0))
        h = np.where(occ, mix64_u64(h), U64(0))
        leaves = np.add.reduceat(h, np.arange(0, n, leaf_width))
        width = 1 << max(len(leaves) - 1, 0).bit_length()
        leaves = np.concatenate([leaves, np.zeros(width - len(leaves), U64)])
        while len(leaves) > 1:
            leaves = mix64_u64(leaves[0::2] + U64(0x9E3779B97F4A7C15)
                               * leaves[1::2] + U64(0xBF58476D1CE4E5B9))
    return int(leaves[0])


def f_replica(node_id: str, device: str):
    """A 2^20-slot replica seeded by the main path's 16 flushes; two
    replicas seeded alike hold the same replicated lanes."""
    crdt = DenseCrdt(node_id, N_SLOTS, device=device,
                     wall_clock=StepClock(MILLIS))
    with crdt.ingest(auto_flush_rows=FLUSH_ROWS):
        for f in range(FLUSHES):
            crdt.put_batch(*flush_inputs(f))
    return crdt


def f_diverge(a, b, name: str, rows: int) -> None:
    """The divergence of case ``name``: the anti-entropy bench's shape
    (each side writes 8 slots of its own window, bench.py:1049-1075),
    or ``rows`` scattered slots, half written on each side, a fifth of
    them tombstones."""
    if rows == 8:
        a.put_batch(np.arange(0, 8), np.arange(8) + 1000)
        b.put_batch(np.arange(8, 16), np.arange(8) + 2000)
        return
    rng = np.random.default_rng(800)
    slots = rng.choice(N_SLOTS, rows, replace=False)
    vals = rng.integers(-2 ** 62, 2 ** 62, rows)
    tombs = rng.random(rows) < 0.2
    half = rows // 2
    a.put_batch(slots[:half], vals[:half], tombs[:half])
    b.put_batch(slots[half:], vals[half:], tombs[half:])


def trees_equal(x, y) -> bool:
    return x.depth == y.depth and all(
        np.array_equal(p, q) for p, q in zip(x.levels, y.levels))


def f_twins_equal(card, host, what: str) -> None:
    err = max_abs_err(card.store, [x.to("cuda") for x in host.store])
    check(err == 0, f"path F: {what}'s lanes differ from its host twin "
                    f"(max |err| {err})")
    check(card.canonical_time == host.canonical_time,
          f"path F: {what}'s clock differs from its host twin")


F_TIMED = ("digest_tree", "pack_since", "merge_packed", "merge_and_repack")


def f_sync_case(pair, twins, clocks, name: str, rows: int) -> dict:
    """One divergence converged by `sync_merkle` on the card pair and on
    the host twins, timed by method (``clocks``, one `MethodClock` a
    replica); the walk is the rest."""
    from crdt_tpu_torch.sync import sync_merkle
    for clock in clocks:
        clock.s = dict.fromkeys(F_TIMED, 0.0)
        clock.packs = []
    f_diverge(*pair, name, rows)
    f_diverge(*twins, name, rows)
    # A profiled pair: clones of the card pair, for the device time.
    clones = []
    for c in pair:
        clone = DenseCrdt(c.node_id, N_SLOTS, store=c.store,
                          node_ids=c._table.ids(),
                          wall_clock=StepClock(c._wall_clock.t))
        clones.append(clone)
    torch.cuda.synchronize()
    obs_device.reset()
    t0 = time.perf_counter()
    report = sync_merkle(*pair)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    ops = obs_device.op_launches()
    card = [dict(clock.s) for clock in clocks[:2]]
    twin_report = sync_merkle(*twins)
    fields = ("rounds", "digests", "ranges", "pushed_rows", "pulled_rows",
              "payload_bytes")
    check(all(getattr(report, f) == getattr(twin_report, f)
              for f in fields), f"path F {name}: the report differs from "
                                "the host twins'")
    check(report.ranges and report.pushed_rows + report.pulled_rows > 0,
          f"path F {name}: nothing diverged")
    for k in (0, 1):
        check(clocks[k].packs == clocks[k + 2].packs,
              f"path F {name}: ranged pack bytes differ from the host's")
    dev = device_ms(lambda: sync_merkle(*clones))
    busy = sum(dev.values()) if dev else None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trees = [c.digest_tree() for c in pair]       # cold: both merged
    torch.cuda.synchronize()
    cold_s = (time.perf_counter() - t0) / 2
    obs_device.reset()
    t0 = time.perf_counter()
    again = pair[0].digest_tree()
    cached_s = time.perf_counter() - t0
    check(again is trees[0] and obs_device.op_launches()["digest_tree"] == 0,
          f"path F {name}: a cached digest_tree built a tree")
    check(trees[0].root == trees[1].root,
          f"path F {name}: roots differ after sync_merkle")
    for c, t, what in zip(pair + twins, trees + trees, ("a", "b") * 2):
        check(trees_equal(c.digest_tree(), t),
              f"path F {name}: replica {what}'s tree differs")
    for c, h, what in zip(pair, twins, ("a", "b")):
        f_twins_equal(c, h, f"{name} replica {what}")
    check(numpy_root(pair[0].store) == trees[0].root,
          f"path F {name}: the root differs from the numpy-uint64 fold")
    timed = sum(card[0].values()) + sum(card[1].values())
    out = dict(rounds=report.rounds, digests=report.digests,
               spans=len(report.ranges), pushed_rows=report.pushed_rows,
               pulled_rows=report.pulled_rows,
               payload_bytes=report.payload_bytes,
               digest_bytes=report.digest_bytes, sync_s=seconds,
               digest_cold_s=cold_s, digest_cached_s=cached_s,
               sync_digest_s=card[0]["digest_tree"] + card[1]["digest_tree"],
               ranged_packs_s=card[0]["pack_since"] + card[1]["pack_since"],
               merges_s=sum(card[k][m] for k in (0, 1)
                            for m in ("merge_packed", "merge_and_repack")),
               walk_s=seconds - timed, device_ms=busy, device_ms_by_op=dev,
               idle_share=None if busy is None
               else 1 - busy / 1e3 / seconds, ops=ops)
    print(f"  path F {name}: {report.rounds} rounds, {report.digests} "
          f"digests, {len(report.ranges)} spans, {report.payload_bytes} "
          f"payload bytes; sync {seconds:.4f} s (digest cold "
          f"{cold_s * 1e3:.3f} ms, cached {cached_s * 1e3:.4f} ms, walk "
          f"{out['walk_s']:.4f} s, ranged packs {out['ranged_packs_s']:.4f}"
          f" s, merges {out['merges_s']:.4f} s); device busy "
          f"{busy if busy is None else round(busy, 4)} ms, idle "
          f"{out['idle_share']}; ops {ops}")
    return out


def f_digest_split(crdt) -> dict:
    """One cold `digest_tree` of a 2^20 store split apart: its host time
    (the cache dropped before each of 5 builds; the build ends in one
    device-to-host copy, so the clock stops after the card), against the
    device time of one build under the profiler and the count of device
    operations (kernels and copies) it ran."""
    from torch.profiler import ProfilerActivity, profile
    host = []
    for _ in range(5):
        crdt._digest_cache = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        crdt.digest_tree()
        host.append((time.perf_counter() - t0) * 1e3)
    crdt._digest_cache = None
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        crdt.digest_tree()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(e, "self_device_time_total", 0)]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    host_ms = float(np.median(host))
    return dict(host_ms=host_ms, host_ms_runs=host,
                device_ms=busy if events else None,
                device_ops=sum(e.count for e in events),
                idle_share=1 - busy / host_ms if events else None)


def f_storage(crdt, twin) -> dict:
    """Half of one replica's live rows tombstoned; at its own head,
    ``drift_slack_ms=0``: `gc_purge`, a `merge_many` replaying the
    pre-purge rows (the fence folds into K1's ``valid``), `compact`.
    Each step on the card is timed and held against the host twin."""
    times = {}
    ops = dict.fromkeys(obs_device.OPS, 0)      # the card replica's

    def step(name, fn):
        out = []
        for c in (crdt, twin):
            before = obs_device.op_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out.append(fn(c))
            torch.cuda.synchronize()
            if c is crdt:
                times[name] = time.perf_counter() - t0
                for k, v in obs_device.op_launches().items():
                    ops[k] += v - before[k]
        return out

    live = torch.nonzero(crdt.live_mask).reshape(-1).cpu().numpy()
    stale = {}

    def export(c):
        cs, ids = c.export_delta()
        stale[c.device.type] = (DenseChangeset(*(x.clone() for x in cs)),
                                ids)

    step("export_s", export)
    step("tombstone_half_s", lambda c: c.delete_batch(live[::2]))
    purged = step("gc_purge_s", lambda c: c.gc_purge(
        c.canonical_time, drift_slack_ms=0))
    check(purged[0] == purged[1] >= len(live[::2]),
          f"path F: purged {purged}, tombstoned {len(live[::2])}")
    obs_device.reset()
    step("fenced_merge_s", lambda c: c.merge_many([stale[c.device.type]]))
    k1 = obs_device.launches()["fanin_batch"]
    check(k1 == 1, f"path F: the fenced replay launched K1 {k1} times")
    check(not bool(crdt.store.occupied[torch.from_numpy(live[::2])].any()),
          "path F: the replay resurrected purged slots")
    translation = step("compact_s", lambda c: c.compact())
    check(np.array_equal(*translation),
          "path F: the compaction's translation differs from the host's")
    before = obs_device.op_launches()["digest_tree"]
    t0 = time.perf_counter()
    seeded = crdt.digest_tree()
    seeded_s = time.perf_counter() - t0
    check(obs_device.op_launches()["digest_tree"] == before,
          "path F: the compacted replica rebuilt its tree")
    check(trees_equal(seeded, twin.digest_tree()),
          "path F: the seeded tree differs from the host twin's")
    crdt._digest_cache = None
    check(trees_equal(seeded, crdt.digest_tree()),
          "path F: the seeded tree differs from a fresh digest_tree()")
    f_twins_equal(crdt, twin, "the compacted replica")
    return dict(live_rows=len(live), tombstoned=len(live[::2]),
                purged=purged[0], live_after=len(crdt),
                seeded_digest_s=seeded_s, ops=ops, k1_launches=k1, **times)


def f_snapshot(crdt) -> dict:
    """`save` then `load` on the card: the loaded replica's first
    `digest_tree` builds nothing (no ``digest_tree`` op). A local write
    first: the saved tree is seeded only under the clock head the load
    rebuilds from the lanes, and a merge's send bump leaves the head
    above every stored stamp."""
    crdt.put_batch([0], [1])
    tree = crdt.digest_tree()
    os.makedirs("chiprun_out", exist_ok=True)
    t0 = time.perf_counter()
    crdt.save(F_SNAPSHOT)
    save_s = time.perf_counter() - t0
    try:
        t0 = time.perf_counter()
        loaded = DenseCrdt.load(crdt.node_id, F_SNAPSHOT,
                                wall_clock=StepClock(MILLIS))
        load_s = time.perf_counter() - t0
    finally:
        os.remove(F_SNAPSHOT)
    obs_device.reset()
    got = loaded.digest_tree()
    ops = obs_device.op_launches()["digest_tree"]
    check(ops == 0 and trees_equal(got, tree),
          f"path F: the loaded replica's first digest_tree built {ops} trees")
    check(max_abs_err(loaded.store, crdt.store) == 0,
          "path F: the loaded lanes differ")
    return dict(save_s=save_s, load_s=load_s, first_digest_ops=ops)


def path_f(card: str) -> dict:
    """Anti-entropy and storage at 2^20 slots (see the module doc)."""
    pair = [f_replica(n, "cuda") for n in ("a0", "b0")]
    twins = [f_replica(n, "cpu") for n in ("a0", "b0")]
    check(pair[0].digest_tree().root == pair[1].digest_tree().root,
          "path F: replicas seeded alike have different roots")
    clocks = [MethodClock(c, F_TIMED) for c in pair + twins]
    cases = {name: f_sync_case(pair, twins, clocks, name, rows)
             for name, rows in F_CASES}
    digest = f_digest_split(pair[1])
    print(f"  path F digest_tree at 2^20, cold: host {digest['host_ms']:.3f}"
          f" ms, device {digest['device_ms']} ms in "
          f"{digest['device_ops']} device ops")
    storage = f_storage(pair[0], twins[0])
    print(f"  path F storage: {storage['purged']} slots purged in "
          f"{storage['gc_purge_s']:.4f} s, fenced merge "
          f"{storage['fenced_merge_s']:.4f} s, compact "
          f"{storage['compact_s']:.4f} s; ops {storage['ops']}")
    snapshot = f_snapshot(pair[0])
    return dict(card=card, n_slots=N_SLOTS, leaf_width=8, cases=cases,
                digest=digest, storage=storage, snapshot=snapshot)


# Path G: typed slots and the keyed surface at the main path's width.
# The tag column: LWW on the first half of the slots, then gcounter,
# pncounter, orset and mvreg on four spans of an eighth each. Every
# lane value is type-canonical: its spec's law_val of the row's (lt,
# node). Each replica has a twin on the host given the same calls.
G_TYPES = ("gcounter", "pncounter", "orset", "mvreg")
G_OPS = 1000                     # typed ops per replica in the seed
G_OP_SLOTS = 25                  # slots per type each replica's ops use
G_FANIN_ROWS = 16                # the typed fan-in, held against a twin
G_WINDOW_ROWS = 128              # the card-only window
G_DELTAS = (("sparse_65536", FLUSH_ROWS), ("wide_262144", 4 * FLUSH_ROWS))
G_SCATTER = 10_486               # 1% of the slots, as path F
G_KEYS = 10_000
G_SNAPSHOT = os.path.join("chiprun_out", "path_g_snapshot.npz")


def g_span(i: int) -> tuple:
    """The slot span of typed semantics ``G_TYPES[i]``."""
    lo = N_SLOTS // 2 + i * (N_SLOTS // 8)
    return lo, lo + N_SLOTS // 8


def g_tags() -> np.ndarray:
    sem = np.zeros(N_SLOTS, np.int8)
    for i, name in enumerate(G_TYPES):
        sem[slice(*g_span(i))] = semantics.get_semantics(name).tag
    return sem


def g_type(crdt) -> None:
    """The path's tag column on a replica, through `set_semantics`."""
    for i, name in enumerate(G_TYPES):
        crdt.set_semantics(np.arange(*g_span(i)), name)


def g_values(sem, lt, node):
    """Type-canonical lane values: each row's spec's ``law_val(lt,
    node)``, on numpy arrays or tensors alike."""
    out = lt * 0
    for spec in semantics.all_semantics():
        law = spec.law_val(lt, node)
        if isinstance(out, np.ndarray):
            out = np.where(sem == spec.tag, law, out)
        else:
            out = torch.where(sem == spec.tag, law, out)
    return out


def g_flush_rows(seed: int, slots: np.ndarray):
    """Encoded rows for ``slots``: values from a drawn (lt, node) per
    row, a fifth of them tombstones."""
    rng = np.random.default_rng(seed)
    k = len(slots)
    lt = ((MILLIS + rng.integers(0, 1000, k)) << SHIFT) + rng.integers(0, 4, k)
    node = rng.integers(1, 9, k)
    return slots, g_values(g_tags()[slots], lt, node), rng.random(k) < 0.2


def g_replica(node_id: str, device, typed: bool = True):
    crdt = DenseCrdt(node_id, N_SLOTS, device=device,
                     wall_clock=StepClock(MILLIS))
    if typed:
        g_type(crdt)
    return crdt


def g_seed(crdt) -> None:
    """The main path's 16 flushes of 65,536 rows, lanes encoded by tag."""
    with crdt.ingest(auto_flush_rows=FLUSH_ROWS):
        for f in range(FLUSHES):
            crdt.put_batch(*g_flush_rows(900 + f, flush_inputs(f)[0]))


def g_equal(card, host, what: str) -> None:
    """A card replica against its host twin: lanes, clock, tags."""
    err = max_abs_err(card.store, [x.to("cuda") for x in host.store])
    check(err == 0, f"path G: {what}'s lanes differ from its host twin "
                    f"(max |err| {err})")
    check(card.canonical_time == host.canonical_time,
          f"path G: {what}'s clock differs from its host twin")
    check(np.array_equal(card._sem_host(), host._sem_host())
          and card._sem_version == host._sem_version,
          f"path G: {what}'s tag column differs from its host twin")


def g_profiled(fn) -> tuple:
    """``fn()`` under ``torch.profiler`` (CUDA activity), timed on the
    host clock: ``(result, row)`` with the host seconds, the card's busy
    time and its count of device operations (kernels and copies), and
    the idle share of the card over the host time. The profiler costs
    the host a little per launch, so launch-bound steps read slower
    here than unprofiled."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    events = sorted((e for e in prof.key_averages()
                     if getattr(e, "self_device_time_total", 0)),
                    key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in events) / 1e3
    return out, dict(host_s=host_s, device_ms=busy if events else None,
                     device_ops=sum(e.count for e in events),
                     idle_share=1 - busy / 1e3 / host_s if events else None,
                     top_device_ops=[(e.key[:80], e.count,
                                      e.self_device_time_total / 1e3)
                                     for e in events[:6]])


def g_report(name: str, row: dict, path: str = "G") -> None:
    busy, idle = row.get("device_ms"), row.get("idle_share")
    twin = row.get("twin_s")
    print(f"  path {path} {name}: host {row['host_s']:.4f} s, device "
          f"{'not measured' if busy is None else f'{busy:.4f} ms'} in "
          f"{row.get('device_ops')} device ops, idle "
          f"{'not measured' if idle is None else f'{idle:.4f}'}"
          + ("" if twin is None else f"; host twin {twin:.4f} s"))


def g_twin_step(name: str, pair, fn, steps: dict):
    """``fn`` on the card replica under the profiler, then on its twin;
    the step's row goes to ``steps``. Returns both results."""
    out, row = g_profiled(lambda: fn(pair[0]))
    t0 = time.perf_counter()
    twin_out = fn(pair[1])
    row["twin_s"] = time.perf_counter() - t0
    steps[name] = row
    g_report(name, row)
    return out, twin_out


def g_op_slots() -> list:
    """Each replica's op slots per typed span: slots no seed flush wrote
    (an OR-set lane there starts empty, so no element saturates), the
    two replicas' disjoint."""
    seeded = np.unique(np.concatenate(
        [flush_inputs(f)[0] for f in range(FLUSHES)]))
    free = [np.setdiff1d(np.arange(*g_span(i)), seeded)
            for i in range(len(G_TYPES))]
    return [[f[r * G_OP_SLOTS:(r + 1) * G_OP_SLOTS] for f in free]
            for r in (0, 1)]


def g_typed_ops(crdt, op_slots) -> list:
    """``G_OPS`` typed ops on one replica at its ``op_slots`` (one array
    per typed span), the last 40% inside an ``ingest()`` window (staged
    adds accumulate in the overlay): counter adds, OR-set adds and
    removes, mvreg writes. Returns every op's result."""
    gs, ps, os_, ms = op_slots

    def op(i):
        j = i // 4
        s = j % G_OP_SLOTS
        if i % 4 == 0:
            return crdt.counter_add(int(gs[s]), 1 + j % 9)
        if i % 4 == 1:
            return crdt.counter_add(int(ps[s]), j % 19 - 9)
        if i % 4 == 2:
            e = (j // (2 * G_OP_SLOTS)) % 16
            if (j // G_OP_SLOTS) % 2 == 0:
                return crdt.orset_add(int(os_[s]), e)
            return crdt.orset_remove(int(os_[s]), e)
        return crdt.mvreg_put(int(ms[s]), 1 + (j * 37 + int(ms[0])) % 0x7FFF)

    cut = G_OPS * 6 // 10
    out = [op(i) for i in range(cut)]
    with crdt.ingest():
        out += [op(i) for i in range(cut, G_OPS)]
    out.append([crdt.counter_value(int(s)) for s in gs[:4]]
               + [crdt.counter_value(int(s)) for s in ps[:4]]
               + [crdt.orset_members(int(s)) for s in os_[:4]]
               + [crdt.mvreg_get(int(s)) for s in ms[:4]])
    return out


def g_changeset(rows: int, seed: int) -> DenseChangeset:
    """``rows`` peer rows at fill 0.8 from `bench.data.make_changeset` on
    the card, values re-encoded by the tag of their slot."""
    from crdt_tpu_torch.bench.data import make_changeset as bench_changeset
    cs = bench_changeset(rows, N_SLOTS, seed, device="cuda")
    sem = torch.from_numpy(g_tags()).to("cuda")
    return cs._replace(val=g_values(sem, cs.lt, cs.node.long()))


def g_clone(crdt, node_id: str):
    """A card replica holding ``crdt``'s lanes, node table, tags and
    clock position: the same call on it gives the same result."""
    clone = DenseCrdt(node_id, crdt.n_slots, store=crdt.store,
                      node_ids=crdt._table.ids(),
                      wall_clock=StepClock(crdt._wall_clock.t))
    sem = crdt._sem_host()
    for tag in np.unique(sem[sem != 0]).tolist():
        clone.set_semantics(np.nonzero(sem == tag)[0], tag)
    return clone


def g_fanin(a, steps: dict) -> dict:
    """One `merge_many` of ``G_FANIN_ROWS`` peer rows on replica a and its
    twin, timed unprofiled; the same merge on a clone under the
    profiler; then a ``G_WINDOW_ROWS``-row coarse window on a clone,
    card only, held against the same rows merged unpipelined."""
    cs = g_changeset(G_FANIN_ROWS, 3000)
    host_cs = DenseChangeset(*(x.cpu() for x in cs))
    clone = g_clone(a[0], a[0].node_id)
    before = (obs_device.launches(), obs_device.op_launches())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a[0].merge_many([(cs, IDS)])
    torch.cuda.synchronize()
    merge_s = time.perf_counter() - t0
    after = (obs_device.launches(), obs_device.op_launches())
    kernels = {k: after[0][k] - before[0][k] for k in after[0]}
    ops = {k: after[1][k] - before[1][k] for k in after[1]}
    check(sum(kernels.values()) == 0 and ops["typed_fanin_step"] == 1,
          f"path G: the typed fan-in launched {kernels}, ops {ops}")
    t0 = time.perf_counter()
    a[1].merge_many([(host_cs, IDS)])
    twin_s = time.perf_counter() - t0
    g_equal(*a, "the fan-in replica")
    _, row = g_profiled(lambda: clone.merge_many([(cs, IDS)]))
    check(max_abs_err(clone.store, a[0].store) == 0,
          "path G: the profiled fan-in differs from the timed one")
    row.update(unprofiled_s=merge_s, twin_s=twin_s, rows=G_FANIN_ROWS,
               valid_records=int(cs.valid.sum()),
               ops_per_row=row["device_ops"] / G_FANIN_ROWS)
    steps["fanin_16"] = row
    g_report("fanin_16", row)
    for name, count, ms in row["top_device_ops"]:
        print(f"    {count} x {name}: {ms:.4f} ms")
    del cs, host_cs, clone

    wide = g_changeset(G_WINDOW_ROWS, 3100)
    win, ref = g_clone(a[0], "w0"), g_clone(a[0], "w0")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with win.pipelined():
        win.merge(wide, IDS)
    torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    _, row = g_profiled(lambda: ref.merge_many([(wide, IDS)]))
    check(max_abs_err(win.store, ref.store) == 0
          and win.canonical_time == ref.canonical_time,
          "path G: the typed window differs from the same rows merged "
          "unpipelined")
    row.update(unprofiled_window_s=window_s, rows=G_WINDOW_ROWS,
               ops_per_row=row["device_ops"] / G_WINDOW_ROWS)
    steps["window_128"] = row
    g_report("window_128 (unpipelined, profiled)", row)
    print(f"  path G window_128: coarse window {window_s:.4f} s unprofiled")
    return dict(rows=G_FANIN_ROWS, window_rows=G_WINDOW_ROWS)


def g_gossip(a, b, steps: dict) -> dict:
    """Typed deltas from a to b: ``pack_since(sem_mode="include")`` ->
    ``pack_rows`` -> ``unpack_rows`` -> ``merge_packed`` at 65,536 rows
    (the sparse typed join) and 262,144 (the wide one); a
    ``"withhold"`` pack into an LWW-only receiver; a tagged pack the
    LWW-only receiver refuses, its store unchanged."""
    from crdt_tpu_torch.ops.packing import pack_rows, unpack_rows
    perm = np.random.default_rng(950).permutation(N_SLOTS)
    cuts = np.cumsum([0] + [rows for _, rows in G_DELTAS])
    first = Hlc.from_logical_time(a[0].canonical_time.logical_time + 1,
                                  "a0")
    out = {}
    for (name, rows), lo, hi in zip(G_DELTAS, cuts[:-1], cuts[1:]):
        since = Hlc.from_logical_time(a[0].canonical_time.logical_time + 1,
                                      "a0")
        rows_in = g_flush_rows(960 + lo, perm[lo:hi])
        for c in a:
            with c.ingest(auto_flush_rows=FLUSH_ROWS):
                c.put_batch(*rows_in)
        frames = []
        for c in a:
            packed, ids = c.pack_since(since, sem_mode="include")
            meta, bufs = pack_rows(packed)
            frames.append((meta, b"".join(bytes(x) for x in bufs)))
        check(frames[0] == frames[1], f"path G: the {name} frame differs "
                                      "between card and host")
        check([f[0] for f in frames[0][0]["lanes"]][-1] == "sem"
              and frames[0][0]["lanes"][0][2][0] == rows,
              f"path G: the {name} pack is not {rows} tagged rows")
        g_twin_step(f"gossip_{name}", b, lambda c: c.merge_packed(
            unpack_rows(*frames[0]), ids), steps)
        g_equal(*b, f"the receiver after {name}")
        out[name] = dict(rows=rows, route="wide" if rows * 4 >= N_SLOTS
                         else "sparse", frame_bytes=len(frames[0][1]))
    lww = [g_replica("c0", dev, typed=False) for dev in TWINS.values()]
    withheld = [c.pack_since(first, sem_mode="withhold") for c in a]
    tagged = a[0].pack_since(first, sem_mode="include")
    typed_rows = int((tagged[0].sem != 0).sum())
    check(withheld[0][0].sem is None and withheld[0][0].k
          == tagged[0].k - typed_rows and typed_rows > 0
          and int(withheld[0][0].slots.max()) < N_SLOTS // 2,
          "path G: the withheld pack kept typed rows")
    g_twin_step("withheld_to_lww", lww, lambda c: c.merge_packed(
        *withheld[0]), steps)
    g_equal(*lww, "the LWW-only receiver")
    before = [x.clone() for x in lww[0].store]
    clock = lww[0].canonical_time
    try:
        lww[0].merge_packed(*tagged)
    except ValueError as e:
        refused = str(e)
    else:
        raise Failure("path G: a tag mismatch was merged")
    check(refused.startswith("semantics tag mismatch at slot")
          and max_abs_err(before, lww[0].store) == 0
          and lww[0].canonical_time == clock,
          "path G: the refused pack touched the receiver")
    out.update(withheld_rows=typed_rows, kept_rows=int(withheld[0][0].k),
               refusal=refused)
    return out


def g_antientropy(b, op_slots, steps: dict) -> dict:
    """Two typed replicas cloned from b (and their twins from b's twin)
    diverge on 1% of the slots, scattered, a fifth tombstones, values
    encoded by tag, half written on each side; `sync_merkle` converges
    them, the sem lane riding both ways; then a few typed ops on each
    and one `sync_packed` round."""
    from crdt_tpu_torch.sync import sync_merkle, sync_packed
    pair = [g_clone(b[0], "c0"), g_clone(b[0], "d0")]
    twins = []
    for nid in ("c0", "d0"):
        twin = DenseCrdt(nid, N_SLOTS, device="cpu", store=b[1].store,
                         node_ids=b[1]._table.ids(),
                         wall_clock=StepClock(b[1]._wall_clock.t))
        g_type(twin)
        twins.append(twin)
    rng = np.random.default_rng(970)
    slots = rng.choice(N_SLOTS, G_SCATTER, replace=False)
    slots, vals, tombs = g_flush_rows(971, slots)
    half = G_SCATTER // 2
    for group in (pair, twins):
        group[0].put_batch(slots[:half], vals[:half], tombs[:half])
        group[1].put_batch(slots[half:], vals[half:], tombs[half:])
    report, row = g_profiled(lambda: sync_merkle(*pair))
    t0 = time.perf_counter()
    twin_report = sync_merkle(*twins)
    row["twin_s"] = time.perf_counter() - t0
    fields = ("rounds", "digests", "ranges", "pushed_rows", "pulled_rows",
              "payload_bytes")
    check(all(getattr(report, f) == getattr(twin_report, f)
              for f in fields) and report.ranges,
          "path G: the merkle report differs from the host twins' (or "
          "nothing diverged)")
    row.update({f: getattr(report, f) for f in fields if f != "ranges"},
               spans=len(report.ranges))
    steps["sync_merkle_1pct"] = row
    g_report("sync_merkle_1pct", row)
    for c, h, what in zip(pair, twins, ("c", "d")):
        g_equal(c, h, f"anti-entropy replica {what}")
    check(pair[0].digest_tree().root == pair[1].digest_tree().root,
          "path G: the typed replicas' roots differ after sync_merkle")
    for group in (pair, twins):
        for i, c in enumerate(group):
            c.counter_add(int(op_slots[i][0][1]), 5 + i)
            c.orset_add(int(op_slots[i][2][1]), 9)
    g_twin_step("sync_packed", (pair, twins),
                lambda group: sync_packed(*group), steps)
    for c, h, what in zip(pair, twins, ("c", "d")):
        g_equal(c, h, f"anti-entropy replica {what} after sync_packed")
    return dict(scatter_rows=G_SCATTER, spans=len(report.ranges),
                payload_bytes=report.payload_bytes)


def g_storage(a, steps: dict) -> dict:
    """On replica a and its twin: half the live typed rows tombstoned,
    `gc_purge` at its own head (purged typed slots return to LWW),
    `compact` (the tags move with the rows), `grow`; then `save` /
    `load` (a snapshot holds no tag column)."""
    sem = a[0]._sem_host()
    live = torch.nonzero(a[0].live_mask).reshape(-1).cpu().numpy()
    typed = live[sem[live] != 0][::2]
    g_twin_step("tombstone_half_typed", a,
                lambda c: c.delete_batch(typed), steps)
    purged = g_twin_step("gc_purge", a, lambda c: c.gc_purge(
        c.canonical_time, drift_slack_ms=0), steps)
    check(purged[0] == purged[1] >= len(typed)
          and not a[0]._sem_host()[typed].any(),
          "path G: purged typed slots kept their tags")
    g_equal(*a, "the purged replica")
    translation = g_twin_step("compact", a, lambda c: c.compact(), steps)
    check(np.array_equal(*translation), "path G: the typed compaction's "
                                        "translation differs")
    g_equal(*a, "the compacted replica")
    check(a[0].digest_tree().root == a[1].digest_tree().root,
          "path G: the compacted trees differ")
    grown = N_SLOTS + FLUSH_ROWS
    g_twin_step("grow", a, lambda c: c.grow(grown), steps)
    g_equal(*a, "the grown replica")
    os.makedirs("chiprun_out", exist_ok=True)
    try:
        _, row = g_profiled(lambda: a[0].save(G_SNAPSHOT))
        steps["save"] = row
        loaded, row = g_profiled(lambda: DenseCrdt.load(
            "a0", G_SNAPSHOT, wall_clock=StepClock(MILLIS)))
        steps["load"] = row
    finally:
        os.remove(G_SNAPSHOT)
    check(max_abs_err(loaded.store, a[0].store) == 0
          and loaded._sem is None and loaded.device.type == "cuda",
          "path G: the loaded replica differs (or kept a tag column)")
    return dict(tombstoned=len(typed), purged=purged[0],
                live_after=len(a[0]), grown_to=grown)


def g_sharded(steps: dict) -> tuple:
    """`ShardedDenseCrdt` on a (2, 2) mesh on the one card against the
    unsharded replica, both typed and seeded alike: the same typed
    fan-in (each copy of each key shard folds its columns; no K1p).
    Returns the pair, for `sharded_storage` (the digest tree and the
    compaction) at the path's end: it resets the launch counters."""
    mesh = parallel.make_fanin_mesh(2, 2, one_card(4))
    s = ShardedDenseCrdt("s0", N_SLOTS, mesh, wall_clock=StepClock(MILLIS))
    u = g_replica("s0", "cuda")
    g_type(s)
    for c in (s, u):
        g_seed(c)
    cs = g_changeset(G_FANIN_ROWS, 3000)
    before = (obs_device.launches(), obs_device.op_launches())
    _, row = g_profiled(lambda: s.merge_many([(cs, IDS)]))
    after = (obs_device.launches(), obs_device.op_launches())
    check(after[0]["fanin_batch_sharded"] == before[0]["fanin_batch_sharded"]
          and after[1]["typed_fanin_step"]
          == before[1]["typed_fanin_step"] + 1,
          "path G: the sharded typed fan-in took another route")
    u.merge_many([(cs, IDS)])
    steps["sharded_fanin_16"] = row
    g_report("sharded_fanin_16", row)
    check(max_abs_err(s.store, u.store) == 0
          and s.canonical_time == u.canonical_time,
          "path G: the sharded typed fan-in differs from the unsharded")
    check_copies(s._store, "path G sharded")
    return s, u


def g_keyed(steps: dict) -> dict:
    """A `KeyedDenseCrdt` on the card (grown from 4,096 slots by
    interning) and its host twin: 10,000 string keys, a fifth of them
    typed, with typed ops; then a `sync_json` round with a `MapCrdt`
    that rewrote some keys (its typed-key rows come back withheld)."""
    from crdt_tpu_torch import KeyedDenseCrdt, MapCrdt
    from crdt_tpu_torch.sync import sync_json
    keys = [f"key{i:05d}" for i in range(G_KEYS)]
    plain, typed = keys[:G_KEYS * 4 // 5], keys[G_KEYS * 4 // 5:]
    quarter = len(typed) // 4
    pairs = [(KeyedDenseCrdt(DenseCrdt("k0", 4096, device=dev,
                                       wall_clock=StepClock(MILLIS))),
              MapCrdt("m0", wall_clock=StepClock(MILLIS + 7)))
             for dev in TWINS.values()]

    def ops(kc):
        kc.put_all({k: i for i, k in enumerate(plain)})
        for i, name in enumerate(G_TYPES):
            kc.set_semantics(typed[i * quarter:(i + 1) * quarter], name)
        for j, k in enumerate(typed):
            kind = j // quarter
            if kind == 0:
                kc.counter_add(k, 1 + j % 7)
            elif kind == 1:
                kc.counter_add(k, j % 11 - 5)
            elif kind == 2:
                kc.orset_add(k, j % 16)
            else:
                kc.mvreg_put(k, 1 + j)
        return kc.dense.n_slots

    slots = g_twin_step("keyed_ops", [p[0] for p in pairs], ops, steps)
    for _, m in pairs:
        m.put_all({k: -i for i, k in enumerate(keys[::7])})
    g_twin_step("keyed_sync_json", pairs, lambda p: sync_json(*p), steps)
    (k, m), (kt, mt) = pairs
    check(k.to_json() == kt.to_json() and m.to_json() == mt.to_json(),
          "path G: the keyed replicas' JSON differs from their twins'")
    g_equal(k.dense, kt.dense, "the keyed replica")
    check(k.counter_value(typed[0]) == 1 and len(k) == G_KEYS,
          "path G: the keyed typed reads")
    return dict(keys=G_KEYS, typed_keys=len(typed), slots=slots[0],
                json_bytes=len(k.to_json()))


def path_g(card: str) -> dict:
    """Typed slots and the keyed surface at 2^20 slots (see the module
    doc): seed, typed fan-in, gossip, anti-entropy, storage, sharded,
    keyed; every replica held bit for bit against a host twin given the
    same calls (the sharded one against the unsharded), and no typed
    merge through K1, K1s, K1p or K3."""
    steps: dict = {}
    torch.cuda.synchronize()
    obs_device.reset()
    a = [g_replica("a0", dev) for dev in TWINS.values()]
    b = [g_replica("b0", dev) for dev in TWINS.values()]
    g_twin_step("seed_flushes", a, g_seed, steps)
    for c in b:
        g_seed(c)
    check(a[0].digest_tree().root == b[0].digest_tree().root,
          "path G: replicas seeded alike have different roots")
    op_slots = g_op_slots()
    for i, pair in enumerate((a, b)):
        got = g_twin_step(f"typed_ops_{'ab'[i]}", pair,
                          lambda c: g_typed_ops(c, op_slots[i]), steps)
        check(got[0] == got[1],
              "path G: typed op results differ from the host twin's")
        g_equal(*pair, f"replica {'ab'[i]} after its typed ops")
    fanin = g_fanin(a, steps)
    gossip = g_gossip(a, b, steps)
    antientropy = g_antientropy(b, op_slots, steps)
    storage = g_storage(a, steps)
    s, u = g_sharded(steps)
    keyed = g_keyed(steps)
    torch.cuda.synchronize()
    launches, ops = obs_device.launches(), obs_device.op_launches()
    check(all(launches[k] == 0 for k in ("fanin_batch", "fanin_split",
                                         "fanin_batch_sharded",
                                         "fanin_stream"))
          and launches["ingest_scatter"] >= 4 * FLUSHES,
          f"path G: launches {launches}")
    sharded = dict(mesh=dict(s._mesh.shape),
                   storage=sharded_storage(s, u, "path G (2, 2)"))
    check(np.array_equal(s._sem_host(), u._sem_host()),
          "path G: the sharded compaction's tags differ")
    return dict(card=card, n_slots=N_SLOTS, typed_ops=G_OPS, steps=steps,
                fanin=fanin, gossip=gossip, antientropy=antientropy,
                storage=storage, sharded=sharded, keyed=keyed,
                launches=launches, ops=ops)


# Path H: the wire and gossip at the main path's width. Two replicas
# seeded by the main path's flushes sit behind gossip nodes' servers on
# 127.0.0.1; every round runs over a hello-negotiated `PeerConnection`
# through a recording relay, and on a host twin of each replica with
# the same calls. Lanes, clocks, tags and the frames must be equal.
H_PACKED = (("packed_262144", 4 * FLUSH_ROWS), ("packed_65536", FLUSH_ROWS),
            ("packed_4096", DELTA_ROWS))
H_TYPED_SLOTS = 4096             # the typed span's width (gcounter)
H_SCATTER = 10_486               # 1% of the slots, as path F
H_KEYS = 10_000
H_WANT = ("zlib", "packed", "semantics", "merkle", "trace", "sketch")
H_IDLE_S = 50.0                  # a parked gossip session's bound


def h_wire():
    """`tests/torch_wire.py` (the recording relay, the frame reader)."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    import torch_wire
    return torch_wire


class HSide:
    """One side of path H: the card's replicas, or their host twins."""

    def __init__(self, role: str):
        import random

        from crdt_tpu_torch import GossipNode, RetryPolicy, BreakerPolicy
        self.role, self.device = role, TWINS[role]
        device = self.device
        self.h0, self.h1 = f_replica("h0", device), f_replica("h1", device)
        # Sessions stay parked between a node's rounds while the other
        # nodes and the twins run theirs (the keyed rounds take about
        # 10 s a side): the servers' idle bound is raised past that, so
        # no session closes on a timer and each side reconnects exactly
        # when its twin does.
        kw = dict(rng=random.Random(7), sleep=lambda _s: None,
                  round_timeout=120.0, io_timeout=H_IDLE_S * 2,
                  retry=RetryPolicy(max_attempts=6, base_delay=0.001,
                                    max_delay=0.01),
                  breaker=BreakerPolicy(failure_threshold=50))
        self.n0 = GossipNode(self.h0, **kw).start()
        self.n1 = GossipNode(self.h1, **kw).start()
        self.kw = kw
        self.flushes = 2 * FLUSHES       # each replica's seed flushes

    def ingest(self, crdt, slots, seed: int, lock=None) -> None:
        """One flush of ``slots`` (random values, a fifth tombstones)."""
        rng = np.random.default_rng(seed)
        vals = rng.integers(-2 ** 62, 2 ** 62, len(slots))
        tombs = rng.random(len(slots)) < 0.2
        import contextlib
        with lock if lock is not None else contextlib.nullcontext():
            with crdt.ingest(auto_flush_rows=len(slots) + 1) as wc:
                crdt.put_batch(slots, vals, tombs)
            if crdt.node_id in ("h0", "h1"):
                self.flushes += wc.flushes

    def conn(self, target, zlib: bool = True):
        from crdt_tpu_torch import PeerConnection
        caps = H_WANT if zlib else tuple(c for c in H_WANT if c != "zlib")
        return PeerConnection(target.host, target.port, timeout=120.0,
                              want_caps=caps)

    def stop(self) -> None:
        for n in (self.n0, self.n1, getattr(self, "nk", None)):
            if n is not None:
                n.stop()


def h_equal(card, host, what: str) -> None:
    err = max_abs_err(card.store, [x.to("cuda") for x in host.store])
    check(err == 0, f"path H: {what}'s lanes differ from its host twin "
                    f"(max |err| {err})")
    check(card.canonical_time == host.canonical_time,
          f"path H: {what}'s clock differs from its host twin")
    check(np.array_equal(card._sem_host(), host._sem_host()),
          f"path H: {what}'s tag column differs from its host twin")
    check(all(lane.device.type == "cuda" for lane in card.store),
          f"path H: {what} left the card")


def h_round(name: str, sides, fn, rounds: dict, wire) -> dict:
    """Round ``name``: ``fn(side, relay)`` on the card side under the
    profiler, then on the host side; each through its own recording
    relay to the side's ``n1`` server. The card's and the host's frames
    must be equal, byte for byte."""
    out = {}
    streams = []
    for side in sides:
        with wire.RecordingProxy(side.n1.host, side.n1.port) as relay:
            before = obs_device.launches()
            if side.role == "card":
                got, row = g_profiled(lambda: fn(side, relay))
            else:
                t0 = time.perf_counter()
                got = fn(side, relay)
                row = dict(host_s=time.perf_counter() - t0)
            after = obs_device.launches()
            streams.append(relay.streams())
        row["launches"] = {k: after[k] - before[k]
                           for k in ("fanin_split", "ingest_scatter",
                                     "fanin_batch")}
        out[side.role] = (got, row)
    check(streams[0] == streams[1], f"path H {name}: the card's frames "
                                    "differ from the host twin's")
    card, host = sides
    h_equal(card.h0, host.h0, f"h0 after {name}")
    h_equal(card.h1, host.h1, f"h1 after {name}")
    got, row = out["card"]
    check(got == out["host"][0],
          f"path H {name}: the round's report differs from the host's")
    row.update(host_twin_s=out["host"][1]["host_s"],
               frames=sum(len(wire.frames(c)) + len(wire.frames(s))
                          for c, s in streams[0]),
               wire_bytes=sum(len(c) + len(s) for c, s in streams[0]))
    if isinstance(got, dict):
        row.update(got)
    rounds[name] = row
    busy, idle = row.get("device_ms"), row.get("idle_share")
    print(f"  path H {name}: host {row['host_s']:.4f} s (twin "
          f"{row['host_twin_s']:.4f} s), wire {row['wire_bytes']} B in "
          f"{row['frames']} frames, device "
          f"{'not measured' if busy is None else f'{busy:.4f} ms'}, idle "
          f"{'not measured' if idle is None else f'{idle:.4f}'}, "
          f"launches {row['launches']}")
    return row


def h_tally(tally) -> dict:
    """A `WireTally` as raw (before zlib) and wire bytes each way."""
    return dict(sent_wire=tally.sent, received_wire=tally.received,
                z_raw=tally.z_raw, z_wire=tally.z_wire,
                sent_raw=tally.sent - tally.z_wire + tally.z_raw)


def h_dense(side, relay, zlib: bool) -> dict:
    from crdt_tpu_torch import WireTally, sync_dense_over_conn
    rng = np.random.default_rng(1000 + zlib)
    slots = rng.choice(N_SLOTS, 2 * DELTA_ROWS, replace=False)
    side.ingest(side.h0, slots[:DELTA_ROWS], 1010 + zlib, side.n0.lock)
    side.ingest(side.h1, slots[DELTA_ROWS:], 1020 + zlib, side.n1.lock)
    tally = WireTally()
    with side.conn(relay, zlib) as conn:
        conn.ensure(tally)
        caps = sorted(conn.caps)
        side.mark = sync_dense_over_conn(side.h0, conn, lock=side.n0.lock,
                                         tally=tally)
    check(("zlib" in caps) == zlib, f"path H: zlib agreed {caps}")
    return dict(caps=caps, **h_tally(tally))


def h_packed(side, relay, rows: int, seed: int) -> dict:
    from crdt_tpu_torch import WireTally, sync_packed_over_conn
    perm = np.random.default_rng(500).permutation(N_SLOTS)
    side.ingest(side.h0, perm[seed:seed + rows], 1100 + seed, side.n0.lock)
    tally = WireTally()
    with side.conn(relay) as conn:
        side.mark = sync_packed_over_conn(side.h0, conn, since=side.mark,
                                          lock=side.n0.lock, tally=tally,
                                          fused_repack=True)
    return dict(rows=rows, **h_tally(tally))


def h_typed_span(side) -> np.ndarray:
    """The first H_TYPED_SLOTS slots empty on both replicas: the typed
    span (gcounter) both replicas migrate before any write lands there."""
    free = ~(side.h0.store.occupied | side.h1.store.occupied)
    return torch.nonzero(free).flatten()[:H_TYPED_SLOTS].cpu().numpy()


def h_typed(side, relay) -> dict:
    from crdt_tpu_torch import WireTally, sync_packed_over_conn
    span = h_typed_span(side)
    side.span = span
    for c, node in ((side.h0, side.n0), (side.h1, side.n1)):
        with node.lock:
            c.set_semantics(span, "gcounter")
    with side.n0.lock:
        for i, slot in enumerate(span[:64]):
            side.h0.counter_add(int(slot), 1 + i % 5)
    with side.n1.lock:
        for i, slot in enumerate(span[32:96]):
            side.h1.counter_add(int(slot), 2 + i % 3)
    tally = WireTally()
    with side.conn(relay) as conn:
        side.mark = sync_packed_over_conn(side.h0, conn, since=side.mark,
                                          lock=side.n0.lock, tally=tally)
        sem = "semantics" in conn.caps
    values = [side.h1.counter_value(int(s)) for s in span[:96]]
    check(sem and values == [side.h0.counter_value(int(s))
                             for s in span[:96]],
          "path H: the typed span did not converge under the cap")
    return dict(typed_slots=len(span), counters=sum(values),
                **h_tally(tally))


def h_untyped_slots(side, rows: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    ok = np.ones(N_SLOTS, bool)
    ok[side.span] = False
    return rng.permutation(np.nonzero(ok)[0])[:rows]


def h_merkle(side, relay) -> dict:
    from crdt_tpu_torch import WireTally, sync_merkle_over_conn
    slots = h_untyped_slots(side, H_SCATTER, 1200)
    half = H_SCATTER // 2
    side.ingest(side.h0, slots[:half], 1210, side.n0.lock)
    side.ingest(side.h1, slots[half:], 1220, side.n1.lock)
    tally, stats = WireTally(), {}
    with side.conn(relay) as conn:
        side.mark = sync_merkle_over_conn(side.h0, conn, lock=side.n0.lock,
                                          tally=tally, _stats=stats)
        prefetch = conn.digest_prefetch
    check(prefetch and stats["pushed_rows"] >= half
          and stats["pulled_rows"] >= half,
          f"path H: the merkle walk {stats}")
    return dict(walk_rounds=stats["rounds"], digests=stats["digests"],
                ranges=len(stats["ranges"]),
                pushed_rows=stats["pushed_rows"],
                pulled_rows=stats["pulled_rows"], **h_tally(tally))


def h_json(side, relay) -> dict:
    from crdt_tpu_torch import WireTally, native, sync_over_conn
    from crdt_tpu_torch import crdt_json
    side.j0 = DenseCrdt("j0", N_SLOTS, device=side.device,
                        wall_clock=StepClock(MILLIS + 20_000))
    side.j0.put_batch(h_untyped_slots(side, DELTA_ROWS, 1300),
                      np.arange(DELTA_ROWS) - 2000)
    tally = WireTally()
    with side.conn(relay) as conn:
        sync_over_conn(side.j0, conn, since=side.j0.canonical_time,
                       tally=tally)
    # The payload's decode in C and in the pure-Python branch, the
    # median of five each.
    payload = side.j0.to_json()
    cols, side.decode_s = {}, {}
    for branch, load in (("c", native.load), ("python", lambda: None)):
        native_load, native.load = native.load, load
        try:
            reps = []
            for _ in range(5):
                t0 = time.perf_counter()
                cols[branch] = crdt_json.decode_columns(payload)
                reps.append(time.perf_counter() - t0)
        finally:
            native.load = native_load
        side.decode_s[branch] = sorted(reps)[2]
    check(cols["c"][0] == cols["python"][0]
          and np.array_equal(cols["c"][1], cols["python"][1]),
          "path H: the C codec's columns differ from the Python branch")
    return dict(rows=DELTA_ROWS, payload_bytes=len(payload),
                **h_tally(tally))


def h_keyed(side):
    from crdt_tpu_torch import GossipNode, KeyedDenseCrdt
    keyed = KeyedDenseCrdt(DenseCrdt("k0", 4096, device=side.device,
                                     wall_clock=StepClock(MILLIS + 30_000)))
    keys = h_untyped_slots(side, H_KEYS, 1400)
    keyed.put_all({int(k): i for i, k in enumerate(keys)})
    side.keyed = keyed
    side.nk = GossipNode(keyed, key_decoder=int, **side.kw).start()


def h_replicated(crdt, slots=None) -> tuple:
    """The replicated lanes of ``crdt`` at ``slots`` (all by default):
    occupancy, lt, the node ids, the value (0 on tombstones) and the
    tombstone flag; the `modified` lanes are each replica's own."""
    s = crdt.store
    idx = slice(None) if slots is None else slots
    ids = np.asarray(crdt._table.ids(), object)
    occ = s.occupied[idx]
    return (occ, s.lt[idx], np.where(occ.cpu().numpy(),
                                     ids[s.node[idx].cpu().numpy()], None),
            torch.where(s.tomb[idx], 0, s.val[idx]), s.tomb[idx])


def h_same(x: tuple, y: tuple) -> bool:
    return all(np.array_equal(a, b) if isinstance(a, np.ndarray)
               else torch.equal(a, b) for a, b in zip(x, y))


def h_converged(side) -> bool:
    """h0 and h1 hold the same records, and the keyed replica every
    record of h0, each under its slot as key."""
    a = h_replicated(side.h0)
    if not h_same(a, h_replicated(side.h1)):
        return False
    keys = list(side.keyed._key_to_slot)
    ks = torch.tensor(keys, device=side.device)
    ss = torch.tensor([side.keyed._key_to_slot[k] for k in keys],
                      device=side.device)
    if len(keys) != int(a[0].sum()) or not bool(a[0][ks].all()):
        return False
    return h_same(h_replicated(side.h0, ks),
                  h_replicated(side.keyed.dense, ss))


def h_sweep(sides, wire) -> dict:
    """Three gossip nodes until every pair converges: the keyed node's
    only peer is h0 (JSON, through a recording relay); h0's peer h1
    through the port's fault proxy on a seeded schedule; h1's peer h0.
    Each node's round runs on the card side under the profiler, then on
    the host side; the twins must stay equal after every round."""
    from crdt_tpu_torch.obs import default_recorder
    from crdt_tpu_torch.testing_faults import FaultProxy, FaultSchedule
    # A flight-recorder bundle, fetched by `h_metrics`: captured before
    # the keyed nodes exist, whose lag section counts every record.
    default_recorder().trigger("path_h", {"what": "chip_smoke"})
    relays, proxies = [], []
    for side in sides:
        h_keyed(side)
        relay = wire.RecordingProxy(side.n0.host, side.n0.port).__enter__()
        proxy = FaultProxy(side.n1.host, side.n1.port, FaultSchedule(
            seed=11, rate=0.5, max_delay=0.005)).start()
        relays.append(relay)
        proxies.append(proxy)
        peers = (side.nk.add_peer("h0", relay.host, relay.port),
                 side.n0.add_peer("h1", proxy.host, proxy.port),
                 side.n1.add_peer("h0", side.n0.host, side.n0.port))
        for peer in peers:
            peer.conn.idle_timeout = H_IDLE_S
    order = ("n0", "n1", "nk")
    steps, done = [], False
    try:
        for sweep in range(6):
            for proxy in proxies:
                proxy.passthrough = sweep >= 3
            for name in order:
                outs = []
                for side in sides:
                    node = getattr(side, name)
                    if side.role == "card":
                        got, row = g_profiled(node.run_round)
                    else:
                        t0 = time.perf_counter()
                        got = node.run_round()
                        row = dict(host_s=time.perf_counter() - t0)
                    outs.append((got, row))
                check(outs[0][0] == outs[1][0],
                      f"path H sweep {sweep} {name}: outcomes differ from "
                      f"the host twin's: {outs[0][0]} vs {outs[1][0]}")
                card, host = sides
                h_equal(card.h0, host.h0, f"h0 after sweep {sweep} {name}")
                h_equal(card.h1, host.h1, f"h1 after sweep {sweep} {name}")
                h_equal(card.keyed.dense, host.keyed.dense,
                        f"the keyed replica after sweep {sweep} {name}")
                row = outs[0][1]
                row.update(sweep=sweep, node=name, outcomes=outs[0][0],
                           host_twin_s=outs[1][1]["host_s"])
                steps.append(row)
                print(f"  path H sweep {sweep} {name}: {outs[0][0]} host "
                      f"{row['host_s']:.4f} s (twin "
                      f"{row['host_twin_s']:.4f} s), device "
                      f"{row.get('device_ms')} ms, idle "
                      f"{row.get('idle_share')}")
                done = all(h_converged(side) for side in sides)
                if done:
                    break
            if done:
                break
        check(done, "path H: the gossip sweeps did not converge")
        streams = [relay.streams(wait=0.0) for relay in relays]
        check(streams[0] == streams[1], "path H: the keyed link's frames "
                                        "differ from the host twin's")
        fired = [{k: v for k, v in p.counters.items()} for p in proxies]
        check(fired[0] == fired[1], f"path H: faults {fired}")
        stats = [{n: s.__getattribute__(n).stats_snapshot()
                  for n in order} for s in sides]
        check(stats[0] == stats[1],
              "path H: the peers' counters differ from the host twin's")
    finally:
        for relay, proxy in zip(relays, proxies):
            proxy.stop()
            relay.__exit__(None, None, None)
    return dict(steps=steps, faults=fired[0], peers=stats[0],
                keyed_keys=len(sides[0].keyed._key_to_slot),
                json_link_bytes=sum(len(c) + len(s)
                                    for c, s in streams[0]))


def h_metrics(sides, before: dict, wire) -> dict:
    """``fetch_metrics`` and ``fetch_debug_dump`` from each card-side
    server: the counters they serve must be what the run did."""
    from crdt_tpu_torch import fetch_metrics, metrics_snapshot
    from crdt_tpu_torch.net import fetch_debug_dump
    card, host = sides
    out = {}
    for name in ("n0", "n1", "nk"):
        node = getattr(card, name)
        m = fetch_metrics(node.host, node.port)
        bundles = fetch_debug_dump(node.host, node.port)
        check(any(b["kind"] == "path_h" for b in bundles),
              f"path H: {name}'s debug dump lacks the bundle")
        check(set(m["lag"]) == set(node.peers)
              and m["node"]["node_id"] == str(node.crdt.node_id),
              f"path H: {name}'s lag section {m.get('lag')}")
        rows = {r["labels"]["peer"]: r["values"]
                for r in m["stats"].get("peer_sync", [])
                if r["labels"]["node"] == str(node.crdt.node_id)}
        snap = node.stats_snapshot()
        for peer, row in rows.items():
            check(all(snap[peer][k] == v for k, v in row.items()),
                  f"path H: {name}'s served peer counters for {peer}")
        out[name] = dict(counters=len(m["counters"]), bundles=len(bundles),
                         peers=sorted(rows))
    deltas = wire.counter_deltas(before, metrics_snapshot())
    flushes = sum(v for (name, labels), v in deltas.items()
                  if name == "crdt_tpu_ingest_flush_total"
                  and dict(labels).get("node") in ("h0", "h1"))
    want = card.flushes + host.flushes
    check(flushes == want, f"path H: {flushes} flushes counted, {want} run")
    out["ingest_flushes"] = flushes
    out["counters_grown"] = len(deltas)
    return out


def path_h(card: str) -> dict:
    """The wire and gossip at 2^20 slots (see the module doc)."""
    from crdt_tpu_torch import metrics_snapshot, native
    wire = h_wire()
    check(native.load() is not None, "path H: the C codec did not load")
    t0 = time.perf_counter()
    before = metrics_snapshot()
    torch.cuda.synchronize()
    obs_device.reset()
    sides = [HSide(role) for role in TWINS]
    seeded = obs_device.launches()["ingest_scatter"]
    rounds: dict = {}
    try:
        for zlib in (True, False):
            h_round(f"dense_{'zlib' if zlib else 'raw'}", sides,
                    lambda s, r: h_dense(s, r, zlib), rounds, wire)
        off = 0
        for name, rows in H_PACKED:
            h_round(name, sides, lambda s, r: h_packed(s, r, rows, off),
                    rounds, wire)
            off += rows
        h_round("packed_typed", sides, h_typed, rounds, wire)
        h_round("merkle_1pct", sides, h_merkle, rounds, wire)
        h_round("json_4096", sides, h_json, rounds, wire)
        decode = dict(sides[0].decode_s)
        print(f"  path H decode_columns of the 4,096-row JSON: C "
              f"{decode['c'] * 1e3:.3f} ms, Python "
              f"{decode['python'] * 1e3:.3f} ms")
        sweep = h_sweep(sides, wire)
        metrics = h_metrics(sides, before, wire)
    finally:
        for side in sides:
            side.stop()
    torch.cuda.synchronize()
    launches = obs_device.launches()
    dense = sum(rounds[f"dense_{z}"]["launches"]["fanin_split"]
                for z in ("zlib", "raw"))
    check(dense == 4 and seeded == 2 * FLUSHES
          and launches["fanin_split"] >= 4,
          f"path H: launches {launches} (dense rounds' K1s {dense}, "
          f"seed K2 {seeded})")
    held_s = time.perf_counter() - t0
    print(f"  path H held {held_s:.2f} s (seeding, rounds, sweep, polls; "
          f"card and host twins)")
    return dict(card=card, n_slots=N_SLOTS, rounds=rounds, sweep=sweep,
                metrics=metrics, decode_columns_s=decode,
                launches=launches, held_s=held_s)


I_KEYS = N_SLOTS                 # TpuMapCrdt keys, put_all'd at once
I_MERGE = FLUSH_ROWS             # remote Records merged, half of them win
I_JSON_ROWS = FLUSH_ROWS         # a card DenseCrdt's to_json rows
I_SQLITE = FLUSH_ROWS            # SqliteCrdt records: cut from 2^20 for time
I_MEMBERS = 4                    # bench.py --mode collective's members
I_ROUNDS = 32                    # ... its rounds
I_ROUND_ROWS = 256               # ... and rows a member a round
I_LOOPBACK = 8                   # loopback-packed rounds beside the joins


def i_step(name: str, steps: dict, fn):
    """``fn()`` on the card under the profiler; its row goes to
    ``steps`` and is printed as path G prints its steps."""
    out, row = g_profiled(fn)
    steps[name] = row
    g_report(name, row, "I")
    return out


def i_lanes_equal(card, host) -> bool:
    """Every lane of a card store equals its twin's (on the host or
    another card)."""
    return max_abs_err(card, host) == 0


def i_shadow_equal(a, b) -> bool:
    """Two TpuMapCrdts' host shadows, keys, payloads and clocks."""
    return (all(np.array_equal(getattr(a._lanes, f), getattr(b._lanes, f))
                for f in a._lanes.__slots__)
            and a._slot_keys == b._slot_keys and a._payload == b._payload
            and a.canonical_time == b.canonical_time)


def i_tpu_map(steps: dict) -> tuple:
    """TpuMapCrdt at 2^20 integer keys on the card and its host twin:
    put_all, the mirror, a 65,536-record merge held against
    `ops.merge.merge_step` on the mirror taken before it, the mirror's
    reductions, and a card DenseCrdt's 65,536-row to_json into
    merge_json."""
    from crdt_tpu_torch import Hlc, Record, TpuMapCrdt
    from crdt_tpu_torch.ops import merge as tm
    pair = [TpuMapCrdt("i0", wall_clock=StepClock(MILLIS)),
            TpuMapCrdt("i0", wall_clock=StepClock(MILLIS), device="cpu")]
    check(pair[0].device.type == "cuda", "path I: TpuMapCrdt() is not on "
                                         "the card")
    values = {k: 3 * k for k in range(I_KEYS)}
    i_step("tpu_map_put_all", steps, lambda: pair[0].put_all(values))
    pair[1].put_all(values)
    mirror = i_step("tpu_map_store", steps, lambda: pair[0].store)
    check(all(lane.device.type == "cuda" for lane in mirror)
          and i_lanes_equal(mirror, pair[1].store)
          and i_shadow_equal(*pair),
          "path I: the put_all mirror differs from its host twin")
    # Every 16th key gets a remote record 5 ms after or before the
    # put_all stamp: half of them win.
    stamp = pair[0].canonical_time.millis
    keys = list(range(0, I_KEYS, I_KEYS // I_MERGE))
    records = {}
    for j, k in enumerate(keys):
        h = Hlc(stamp + (5 if j % 2 else -5), j % 3, "peer")
        records[k] = Record(h, None if j % 10 == 0 else -k, h)
    for c in pair:
        c._intern_nodes(["peer"])       # ordinals as the merge sees them
    before = pair[0].store
    canonical = pair[0].canonical_time.logical_time
    wall = pair[0]._wall_clock.t + 1    # the merge's own first wall read
    my_ord = pair[0]._table.ordinal("i0")
    dev = "cuda"
    cs = tm.Changeset(
        slot=torch.tensor([pair[0]._key_to_slot[k] for k in keys],
                          dtype=torch.int32, device=dev),
        lt=torch.tensor([r.hlc.logical_time for r in records.values()],
                        device=dev),
        node=torch.full((len(keys),), pair[0]._table.ordinal("peer"),
                        dtype=torch.int32, device=dev),
        tomb=torch.tensor([r.value is None for r in records.values()],
                          device=dev),
        valid=torch.ones(len(keys), dtype=torch.bool, device=dev))
    i_step("tpu_map_merge", steps, lambda: pair[0].merge(records))
    pair[1].merge(records)
    out, res = i_step("merge_step", steps, lambda: tm.merge_step(
        before, cs, canonical, my_ord, wall))
    shadow = pair[0]._lanes
    check(not bool(res.any_bad) and int(res.win.sum()) == I_MERGE // 2,
          f"path I: merge_step won {int(res.win.sum())} of {I_MERGE}")
    check(all(np.array_equal(getattr(out, f).cpu().numpy(),
                             getattr(shadow, f)) for f in tm.Store._fields),
          "path I: the shadow after the record merge differs from "
          "merge_step on the mirror taken before it")
    check(i_shadow_equal(*pair), "path I: the record merge differs from "
                                 "its host twin")
    since = canonical
    lt_max, mask = i_step("mirror_reductions", steps, lambda: (
        tm.max_logical_time(pair[0].store),
        tm.delta_mask(pair[0].store, since)))
    twin = pair[1].store
    check(int(lt_max) == int(np.max(np.where(shadow.occupied, shadow.lt, 0)))
          == int(tm.max_logical_time(twin))
          and np.array_equal(mask.cpu().numpy(),
                             shadow.occupied & (shadow.mod_lt >= since))
          and torch.equal(mask.cpu(), tm.delta_mask(twin, since)),
          "path I: the mirror's reductions differ from the shadow's")
    # A card DenseCrdt's to_json into merge_json (string keys).
    dense = [DenseCrdt("j0", N_SLOTS, device=d, wall_clock=StepClock(MILLIS))
             for d in TWINS.values()]
    slots, vals, tombs = flush_inputs(0, rows=I_JSON_ROWS)
    for d in dense:
        d.put_batch(slots, vals, tombs)
    wire = i_step("dense_to_json", steps, dense[0].to_json)
    check(wire == dense[1].to_json(), "path I: the card DenseCrdt's JSON "
                                      "differs from its host twin's")
    mark = pair[0].canonical_time
    i_step("tpu_map_merge_json", steps, lambda: pair[0].merge_json(wire))
    pair[1].merge_json(wire)
    delta = [c.to_json(modified_since=mark) for c in pair]
    check(i_shadow_equal(*pair) and delta[0] == delta[1]
          and len(pair[0]._slot_keys) == I_KEYS + I_JSON_ROWS
          and pair[0]._device is None,
          "path I: merge_json differs from its host twin")
    return pair[0], dict(keys=len(pair[0]._slot_keys),
                         merge_wins=int(res.win.sum()),
                         json_bytes=len(wire), delta_json_bytes=len(delta[0]))


def i_sqlite(tpu, steps: dict) -> dict:
    """A SqliteCrdt file seeded with I_SQLITE records and a card
    TpuMapCrdt holding step 1's records of the same keys (put_records,
    the state converter): one full sync_json round, then the file
    reopened with its clock restored from MAX(lt)."""
    import tempfile

    from crdt_tpu_torch import SqliteCrdt, TpuMapCrdt, sync_json
    keys = range(I_SQLITE)
    part = TpuMapCrdt("i1", wall_clock=StepClock(MILLIS + 9))
    part.put_records({k: tpu.get_record(k) for k in keys})
    os.makedirs("chiprun_out", exist_ok=True)
    with tempfile.TemporaryDirectory(dir="chiprun_out") as tmp:
        path = os.path.join(tmp, "path_i.db")
        db = SqliteCrdt("s0", path, wall_clock=StepClock(MILLIS),
                        key_decoder=int)
        i_step("sqlite_seed", steps,
               lambda: db.put_all({k: -k for k in keys}))
        i_step("sqlite_sync_json", steps, lambda: sync_json(
            db, part, key_decoder=int, since=None))
        got = [db.record_map(), part.record_map()]
        same = [{k: (str(r.hlc), r.value) for k, r in m.items()}
                for m in got]
        wire = db.to_json()
        check(same[0] == same[1] and len(same[0]) == I_SQLITE
              and wire == part.to_json() and part._device is None,
              "path I: the SqliteCrdt and the TpuMapCrdt differ after "
              "sync_json")
        max_lt = int(part._lanes.lt[:len(part._slot_keys)].max())
        db.close()
        again = SqliteCrdt("s0", path, wall_clock=StepClock(MILLIS),
                           key_decoder=int)
        check(again.canonical_time.logical_time == max_lt
              and again.count_modified_since() == I_SQLITE,
              "path I: the reopened file's clock is not MAX(lt)")
        again.close()
    return dict(records=I_SQLITE, json_bytes=len(wire),
                wins_kept=sum(r.hlc.node_id == "s0" for r in got[0].values()))


def i_member(node_id: str, device, flushes) -> DenseCrdt:
    """A 2^20-slot replica seeded by the given main-path flushes (K2)."""
    crdt = DenseCrdt(node_id, N_SLOTS, device=device,
                     wall_clock=StepClock(MILLIS))
    with crdt.ingest(auto_flush_rows=FLUSH_ROWS):
        for f in flushes:
            crdt.put_batch(*flush_inputs(f))
    return crdt


def i_groups_equal(card, host, rc, rh, what: str, path: str = "I") -> None:
    """A card group against its twin group (on the host, or another
    route): the report, and each member's lanes, clock and seeded
    pack."""
    check((rc.new_canonical, rc.win_counts, rc.digest_root, rc.members)
          == (rh.new_canonical, rh.win_counts, rh.digest_root, rh.members)
          and rc.bytes_to_wire == 0,
          f"path {path}: {what}: the report differs from the twin group's")
    for c, h in zip(card.members, host.members):
        check(i_lanes_equal(c._store, h._store)
              and c.canonical_time == h.canonical_time,
              f"path {path}: {what}: member {c.node_id} differs from its "
              "twin")
        packs = [[None if a is None else a.tobytes() for a in m._pack_cache[
            next(iter(m._pack_cache))][0]] for m in (c, h)]
        check(len(c._pack_cache) == len(h._pack_cache) == 1
              and packs[0] == packs[1],
              f"path {path}: {what}: member {c.node_id}'s seeded pack "
              "differs")


def i_join(group) -> tuple:
    """One group join: its report, host seconds and join calls."""
    before = obs_device.op_launches()["parallel.collective_join"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = group.join()
    torch.cuda.synchronize()
    return (report, time.perf_counter() - t0,
            obs_device.op_launches()["parallel.collective_join"] - before)


def i_write(sets, rng, rows: int) -> None:
    """Member i of each replica set writes the same ``rows`` slots."""
    for i in range(I_MEMBERS):
        slots = rng.choice(N_SLOTS, rows, replace=False)
        for members in sets:
            members[i].put_batch(slots, slots % 1000)


def i_collective(steps: dict) -> dict:
    """Four card members on a member mesh that repeats the card, each
    seeded by 4 of the main path's flushes, against a host twin group:
    32 rounds of bench.py --mode collective's shape, one 65,536-row
    round (also held against four card clones converged pairwise by
    sync_packed), a no-change join, and a typed round on path G's
    tags."""
    from crdt_tpu_torch import CollectiveGroup
    from crdt_tpu_torch.parallel import make_collective_mesh
    from crdt_tpu_torch.sync import sync_packed
    flushes = [range(4 * i, 4 * i + 4) for i in range(I_MEMBERS)]
    card = CollectiveGroup(
        [i_member(f"m{i}", "cuda", flushes[i]) for i in range(I_MEMBERS)],
        mesh=make_collective_mesh(I_MEMBERS, one_card(I_MEMBERS)))
    host = CollectiveGroup(
        [i_member(f"m{i}", "cpu", flushes[i]) for i in range(I_MEMBERS)])
    check(list(card.mesh.devices) == [torch.device("cuda:0")] * I_MEMBERS,
          f"path I: the member mesh {card.mesh.devices}")
    rc, first_s, calls = i_join(card)
    i_groups_equal(card, host, rc, host.join(), "the first join")
    rng = np.random.default_rng(1000)
    times = []
    for r in range(I_ROUNDS):
        i_write((card.members, host.members), rng, I_ROUND_ROWS)
        if r == I_ROUNDS - 1:
            (rc, s, calls) = i_step("collective_join_256", steps,
                                    lambda: i_join(card))
        else:
            rc, s, calls = i_join(card)
        check(calls == 1, f"path I: round {r} made {calls} join calls")
        times.append(s)
        i_groups_equal(card, host, rc, host.join(), f"round {r}")
    # The 65,536-row round, also on card clones converged pairwise.
    clones = [g_clone(m, m.node_id) for m in card.members]
    for c, m in zip(clones, card.members):
        c._canonical_time = Hlc.from_logical_time(
            m.canonical_time.logical_time, m.node_id)
    mark = card.members[0].canonical_time
    i_write((card.members, host.members, clones), rng, FLUSH_ROWS)
    rc, big_s, calls = i_step("collective_join_65536", steps,
                              lambda: i_join(card))
    check(calls == 1, "path I: the 65,536-row round's join calls")
    i_groups_equal(card, host, rc, host.join(), "the 65,536-row round")

    def converge():
        for _ in range(2):
            for i in range(I_MEMBERS):
                for k in range(i + 1, I_MEMBERS):
                    sync_packed(clones[i], clones[k], since=mark)
    i_step("pairwise_sync_packed", steps, converge)
    for c, m in zip(clones, card.members):
        check(all(torch.equal(getattr(c._store, f), getattr(m._store, f))
                  for f in ("lt", "node", "val", "tomb", "occupied"))
              and c.digest_tree().root == rc.digest_root,
              f"path I: member {m.node_id} differs from the pairwise "
              "sync_packed replicas")
    rc, nochange_s, calls = i_step("collective_join_nochange", steps,
                                   lambda: i_join(card))
    rh = host.join()
    check(calls == 1 and rc.adopted == 0,
          "path I: the no-change join adopted rows")
    i_groups_equal(card, host, rc, rh, "the no-change join")
    typed = i_typed_round(steps)
    times.sort()
    return dict(members=I_MEMBERS, rounds=I_ROUNDS, rows=I_ROUND_ROWS,
                first_join_s=first_s, join_s_median=times[len(times) // 2],
                join_s_min=times[0], join_s_max=times[-1],
                join_65536_s=big_s, nochange_s=nochange_s,
                digest_root=rc.digest_root, typed=typed)


def i_typed_slots() -> list:
    """Path G's four typed spans' first op slots no seed flush wrote, so
    an OR-set lane starts empty."""
    seeded = set()
    for i in range(I_MEMBERS):
        seeded.update(flush_inputs(i)[0].tolist())
    return [[s for s in range(*g_span(t)) if s not in seeded][:I_MEMBERS]
            for t in range(4)]


def i_typed_member(i: int, device, free: list):
    """Typed member ``i``: path G's tags, one encoded flush, then typed
    ops on shared and own slots (the mvreg slot at an equal lt
    everywhere)."""
    g, p, o, v = free
    crdt = g_replica(f"t{i}", device)
    with crdt.ingest(auto_flush_rows=FLUSH_ROWS):
        crdt.put_batch(*g_flush_rows(900 + i, flush_inputs(i)[0]))
    crdt.counter_add(g[i], 5 + i)
    crdt.counter_add(p[i], 3 - 2 * i)
    crdt.orset_add(o[0], i)
    crdt.orset_add(o[1], 2 * i)
    crdt.mvreg_put(v[0], 100 + i)
    return crdt


def i_typed_reads(members, free: list, what: str) -> None:
    g, _, o, v = free
    check(members[0].mvreg_get(v[0]) == tuple(sorted(
        (100 + i for i in range(I_MEMBERS)), reverse=True))
          and members[1].orset_members(o[0]) == frozenset(range(I_MEMBERS))
          and all(c.counter_value(g[i]) == 5 + i
                  for c in members for i in range(I_MEMBERS)),
          f"{what}: typed reads after the join: "
          f"{members[0].mvreg_get(v[0])}")


def i_typed_round(steps: dict) -> dict:
    """Four typed members on path G's tags, each seeded by one encoded
    flush, with typed ops on shared and own slots (the mvreg slot at an
    equal lt everywhere), joined once: `_typed_group_val` runs."""
    from crdt_tpu_torch import CollectiveGroup
    from crdt_tpu_torch.parallel import make_collective_mesh
    free = i_typed_slots()
    groups = [CollectiveGroup([i_typed_member(i, "cuda", free)
                               for i in range(I_MEMBERS)],
                              mesh=make_collective_mesh(
                                  I_MEMBERS, one_card(I_MEMBERS))),
              CollectiveGroup([i_typed_member(i, "cpu", free)
                               for i in range(I_MEMBERS)])]
    rc, s, calls = i_step("collective_join_typed", steps,
                          lambda: i_join(groups[0]))
    check(calls == 1, "path I: the typed round's join calls")
    i_groups_equal(groups[0], groups[1], rc, groups[1].join(),
                   "the typed round")
    i_typed_reads(groups[0].members, free, "path I")
    return dict(join_s=s, adopted=rc.adopted)


def i_gossip(steps: dict, join_s: float) -> dict:
    """Three GossipNodes on 127.0.0.1 over card replicas at 2^20: g0 and
    g1 in a group with declared addresses, r0 remote (packed). One sweep
    (the pair through one join, r0 over the socket), a second to
    converge, a forced join failure counted as a socket fallback, then
    loopback-packed rounds beside the joins."""
    import random

    from crdt_tpu_torch import CollectiveGroup, GossipNode, default_registry
    from crdt_tpu_torch.parallel import make_collective_mesh
    reps = [i_member(n, "cuda", [f]) for n, f in (("g0", 4), ("g1", 5),
                                                  ("r0", 6))]
    nodes = [GossipNode(c, rng=random.Random(7)).start() for c in reps]
    try:
        n0, n1, nr = nodes
        group = CollectiveGroup(reps[:2],
                                mesh=make_collective_mesh(2, one_card(2)),
                                addresses={"g0": f"{n0.host}:{n0.port}",
                                           "g1": f"{n1.host}:{n1.port}"})
        n0.attach_group(group)
        p1 = n0.add_peer("g1", n1.host, n1.port)
        far = n0.add_peer("r0", nr.host, nr.port, mode="packed")
        check(p1.collective and not far.collective,
              "path I: co-location detection")
        calls = obs_device.op_launches()["parallel.collective_join"]
        first = i_step("gossip_sweep", steps, n0.run_round)
        calls = obs_device.op_launches()["parallel.collective_join"] - calls
        check(first == {"g1": "ok", "r0": "ok"} and calls == 1
              and p1.last_attempt == "collective"
              and far.last_attempt == "packed"
              and p1.stats.bytes_sent == p1.stats.bytes_received == 0
              and far.stats.bytes_sent > 0,
              f"path I: the sweep {first}, {calls} joins, "
              f"{p1.last_attempt} / {far.last_attempt}")
        n0.run_round()
        roots = {c.digest_tree().root for c in reps}
        check(len(roots) == 1 and all(
            torch.equal(reps[0]._store.lt, c._store.lt) for c in reps),
              "path I: the three nodes did not converge")
        fb = default_registry().counter("crdt_tpu_collective_fallback_total")
        before = fb.value(reason="RuntimeError", node="g0", peer="g1")

        def boom(*args, **kwargs):
            raise RuntimeError("the member mesh is gone")

        group.join = boom
        with n0.lock:
            reps[0].put_batch([3, 5], [33, 55])
        failed = n0.run_round()
        fallbacks = fb.value(reason="RuntimeError", node="g0",
                             peer="g1") - before
        check(failed == {"g1": "ok", "r0": "ok"} and fallbacks >= 1
              and p1.last_attempt != "collective" and reps[1].get(5) == 55,
              f"path I: the forced failure: {failed}, {fallbacks} counted, "
              f"{p1.last_attempt}")
        rng = np.random.default_rng(77)
        loop = []
        wire0 = far.stats.bytes_sent + far.stats.bytes_received
        for _ in range(I_LOOPBACK):
            slots = rng.choice(N_SLOTS, I_ROUND_ROWS, replace=False)
            with n0.lock:
                reps[0].put_batch(slots, slots % 1000)
            t0 = time.perf_counter()
            check(n0.sync_peer("r0") == "ok", "path I: a loopback round")
            loop.append(time.perf_counter() - t0)
        loop.sort()
        loop_s = loop[len(loop) // 2]
    finally:
        for n in nodes:
            n.stop()
    print(f"  path I loopback packed round {loop_s:.6f} s vs the "
          f"collective join {join_s:.6f} s (median, 4 members)")
    return dict(fallbacks=fallbacks, loopback_round_s=loop_s,
                loopback_bytes_a_round=(far.stats.bytes_sent
                                        + far.stats.bytes_received
                                        - wire0) / I_LOOPBACK,
                collective_speedup_vs_loopback=loop_s / join_s)


def path_i(card: str) -> dict:
    """The general-key backend, SQLite and the group join (module doc)."""
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    obs_device.reset()
    steps: dict = {}
    tpu, tpu_row = i_tpu_map(steps)
    lite = i_sqlite(tpu, steps)
    del tpu
    group = i_collective(steps)
    gossip = i_gossip(steps, group["join_s_median"])
    torch.cuda.synchronize()
    launches = obs_device.launches()
    check(launches["ingest_scatter"] > 0 and all(
        v == 0 for k, v in launches.items() if k != "ingest_scatter"),
          f"path I: launches {launches}")
    held_s = time.perf_counter() - t0
    print(f"  path I held {held_s:.2f} s (card and host twins)")
    return dict(card=card, n_slots=N_SLOTS, tpu_map=tpu_row, sqlite=lite,
                collective=group, gossip=gossip, steps=steps,
                launches=launches, ops=obs_device.op_launches(),
                held_s=held_s)


# --- path J: the serving plane on card replicas ---

J_SESSIONS = 10_000              # bench_serve's sessions, 1 op/s each
J_RATE = 1.0
J_WARMUP = 2.0                   # cut from bench_serve's 3 s for time
J_DURATION = 5.0                 # cut from its 10 s for time
J_LANE_SESSIONS = 1000           # min(sessions, 1000), as bench_serve
J_LANE_BATCH = 16                # its lane_batch ops a binop frame
J_LANE_RATE = 2.0                # its lane_rate frames a second
J_LANE_WARMUP = 1.0
J_LANE_BASE = N_SLOTS // 2       # the lane's slots, clear of the JSON ones
J_READBACK = 256                 # acked slots read back over the wire
J_FED_SESSIONS = 4000            # bench_federate's 100,000, capped at its
J_FED_RATE = 0.25                # offered 1,000 ops/s (0.25 op/s each)
J_FED_WARMUP = 1.0
J_FED_DURATION = 5.0
J_FED_FLIP_AT = 0.4              # the flip at 40% of the window
J_FAILOVER = dict(replicas=3, ack_replicas=1, flush_interval=0.002,
                  heartbeat_interval=0.03, heartbeat_timeout=0.15,
                  lease_misses=3)            # bench_failover's defaults
J_WRITERS, J_WRITER_SLOTS, J_WRITE_HZ, J_KILLS = 8, 8, 100.0, 3


def j_modules():
    """The jax-free test helpers path J drives: the open-loop client
    fleet (its own process) and the scripted conversation."""
    h_wire()          # puts tests/ on the path
    import torch_serve_fleet
    import torch_serve_script
    return torch_serve_fleet, torch_serve_script


def j_flushes(node: str) -> float:
    """Write-combiner flushes of replica ``node`` so far, any trigger
    (each is one commit of staged rows)."""
    from crdt_tpu_torch import default_registry
    snap = default_registry().snapshot()
    return sum(s["value"] for s in snap["counters"].get(
        "crdt_tpu_ingest_flush_total", [])
        if s["labels"].get("node") == node)


def j_phases(node: str) -> dict:
    """p50 / p99 ms of each ack phase of ``node`` from the registry's
    ``crdt_tpu_serve_ack_phase_seconds_sketch``."""
    from crdt_tpu_torch import default_registry
    from crdt_tpu_torch.obs.sketch import sketch_from_sample
    snap = default_registry().snapshot()
    out = {}
    for s in snap["sketches"].get(
            "crdt_tpu_serve_ack_phase_seconds_sketch", []):
        if s["labels"].get("node") != node:
            continue
        sk = sketch_from_sample(s)
        if sk is not None and sk.count:
            out[s["labels"]["phase"]] = dict(
                count=sk.count, p50_ms=sk.quantile(0.5) * 1e3,
                p99_ms=sk.quantile(0.99) * 1e3)
    return out


def j_fold_equal(crdt, last: dict, what: str) -> None:
    """Every slot of a card replica against the host fold of the acked
    writes ``last`` (slot -> value): exactly those slots occupied, live,
    holding their last acked value."""
    n = crdt.n_slots
    occ = np.zeros(n, bool)
    val = np.zeros(n, np.int64)
    if last:
        slots = np.fromiter(last.keys(), np.int64, len(last))
        occ[slots] = True
        val[slots] = np.fromiter(last.values(), np.int64, len(last))
    st = crdt.store
    got_occ = st.occupied.cpu().numpy()
    check(np.array_equal(got_occ, occ), f"{what}: occupied slots differ "
          f"({int(got_occ.sum())} against {int(occ.sum())} acked)")
    check(not st.tomb.cpu().numpy()[occ].any(), f"{what}: tombstones")
    check(np.array_equal(st.val.cpu().numpy()[occ], val[occ]),
          f"{what}: values differ from the acked writes")


def j_get(host: str, port: int, slots) -> list:
    """``get`` of each slot over one framed JSON session."""
    import socket

    from crdt_tpu_torch import net
    out = []
    with socket.create_connection((host, port), timeout=60.0) as sock:
        for s in slots:
            net.send_frame(sock, {"op": "get", "slot": int(s)})
            out.append(net.recv_frame(sock, deadline=time.monotonic()
                                      + 60.0)["value"])
        net.send_frame(sock, {"op": "bye"})
    return out


def j_serve(steps: dict) -> dict:
    """Step 1: one tier under bench_serve's open-loop load."""
    from crdt_tpu_torch import ServeTier
    from crdt_tpu_torch.obs.device import default_ledger
    fleet, _ = j_modules()
    soft = fleet.raise_fd_limit(J_SESSIONS + 1024)
    seated = max(1, min(J_SESSIONS, soft - 1024))
    lane_seated = min(seated, J_LANE_SESSIONS)
    print(f"  path J serve: {J_SESSIONS} sessions requested, {seated} "
          f"seated (fd soft limit {soft})")
    node = "j-serve"
    crdt = DenseCrdt(node, N_SLOTS, device="cuda")
    led = default_ledger()
    with ServeTier(crdt, max_sessions=seated + 64,
                   flush_interval=0.002) as tier:
        args = dict(host=tier.host, port=tier.port)
        check(j_get(tier.host, tier.port, [0]) == [None], "path J warm")
        torch.cuda.synchronize()
        k0 = obs_device.launches()
        led0, f0 = led.as_dict(), j_flushes(node)
        shed0, drop0 = tier.shed_count, tier.dropped_sessions
        out, prof = g_profiled(lambda: fleet.run(dict(
            args, mode="serve", sessions=seated, rate=J_RATE,
            warmup=J_WARMUP, duration=J_DURATION, base=0)))
        f1 = j_flushes(node)
        phases = j_phases(node)
        lane, lane_prof = g_profiled(lambda: fleet.run(dict(
            args, mode="lane", sessions=lane_seated, rate=J_LANE_RATE,
            batch=J_LANE_BATCH, warmup=J_LANE_WARMUP,
            duration=J_DURATION, base=J_LANE_BASE)))
        last = dict(map(tuple, out["last"]))
        last.update(map(tuple, lane["last"]))
        rng = np.random.default_rng(5)
        sample = rng.choice(np.fromiter(last, np.int64, len(last)),
                            min(J_READBACK, len(last)), replace=False)
        got = j_get(tier.host, tier.port, sample)
        check(got == [last[int(s)] for s in sample],
              "path J serve: a sampled acked write reads back wrong")
        shed = tier.shed_count - shed0
        dropped = tier.dropped_sessions - drop0
    torch.cuda.synchronize()
    launches = j_launches_since(k0)
    flushes = j_flushes(node) - f0
    ledger = {k: v - led0.get(k, 0) for k, v in led.as_dict().items()
              if v != led0.get(k, 0)}
    for o, what in ((out, "JSON"), (lane, "binop")):
        c = o["counters"]
        check(c["errors"] == 0 and c["connect_failures"] == 0,
              f"path J serve {what}: {c}")
    check(launches["ingest_scatter"] == flushes > 0 and all(
        v == 0 for k, v in launches.items() if k != "ingest_scatter"),
          f"path J serve: launches {launches} for {flushes} flushes")
    check(ledger.get("pallas.ingest_scatter_tiles") == flushes
          and "dense.ingest_scatter" not in ledger,
          f"path J serve: ledger {ledger} for {flushes} flushes")
    j_fold_equal(crdt, last, "path J serve")
    check(shed == 0 and dropped == 0,
          f"path J serve: shed {shed}, dropped {dropped}")
    serve_ops = out["counters"]["acked"]
    row = dict(requested=J_SESSIONS, seated=seated,
               connected=out["connected"], rate_hz=J_RATE,
               warmup_s=J_WARMUP, duration_s=J_DURATION,
               p50_ms=out["p50_ms"], p99_ms=out["p99_ms"],
               **j_rates(out, out["connected"] * J_RATE),
               acked=serve_ops, ticks=f1 - f0,
               writes_per_tick=serve_ops / max(1.0, f1 - f0),
               phases=phases, shed=shed, dropped=dropped,
               lane=dict(sessions=lane_seated, batch=J_LANE_BATCH,
                         rate_hz=J_LANE_RATE, p50_ms=lane["p50_ms"],
                         p99_ms=lane["p99_ms"],
                         **j_rates(lane, lane["connected"] * J_LANE_RATE
                                   * J_LANE_BATCH),
                         acked=lane["counters"]["acked"]),
               launches=launches["ingest_scatter"], flushes=flushes,
               ledger=ledger, readback=len(sample), acked_slots=len(last),
               reduced=["warmup 3 -> 2 s, duration 10 -> 5 s (time)",
                        f"sessions {J_SESSIONS} -> {seated} (fd limit)"
                        if seated < J_SESSIONS else "sessions not cut"])
    steps["serve"] = prof
    steps["serve_lane"] = lane_prof
    g_report("serve (open-loop JSON)", prof, "J")
    g_report("serve (binop lane)", lane_prof, "J")
    print(f"  path J serve: p50 {row['p50_ms']:.3f} ms, p99 "
          f"{row['p99_ms']:.3f} ms, {j_rates_text(row)}, "
          f"{row['writes_per_tick']:.2f} writes a tick, phases "
          + ", ".join(f"{k} p99 {v['p99_ms']:.4f} ms"
                      for k, v in sorted(phases.items()))
          + f"; lane {j_rates_text(row['lane'])}, p99 "
          f"{row['lane']['p99_ms']:.3f} ms")
    return row


def j_rates(out: dict, offered: float) -> dict:
    """A fleet run's throughput: the offered puts a second; the puts
    whose acks landed inside the window, over the window; and the
    window's scheduled puts over the time until the last of their acks
    (a tier that keeps up drains its window just after it closes)."""
    drain = out["last_window_ack_s"]
    return dict(offered_ops_s=offered,
                acked_ops_s=out["acked_in_window"] / out["window_s"],
                drained_ops_s=(out["window_ops"] / drain
                               if drain else None),
                window_drain_s=drain)


def j_rates_text(row: dict) -> str:
    drained = row["drained_ops_s"]
    return (f"offered {row['offered_ops_s']:.1f} ops/s, acked in the "
            f"window {row['acked_ops_s']:.1f} ops/s, window drained in "
            f"{row['window_drain_s']:.3f} s "
            f"({'n/a' if drained is None else f'{drained:.1f}'} ops/s)")


def j_launches_since(before: dict) -> dict:
    """Kernel launches since the counts ``before``."""
    return {k: v - before[k] for k, v in obs_device.launches().items()}


def j_normalize(body: bytes, card: str, host: str) -> bytes:
    """A card-side frame with the card tier's node id written as its
    twin's (the two tiers need distinct ids: the registry keys series by
    node id)."""
    import re
    return re.sub(rb'(["-])' + card.encode() + rb'"',
                  rb"\1" + host.encode() + rb'"', body)


def j_conversation(steps: dict) -> dict:
    """Step 2: the scripted conversation on a card tier and its host
    twin, frame for frame."""
    from crdt_tpu_torch import ServeTier, net
    from crdt_tpu_torch.testing import FakeClock
    _, script = j_modules()
    wire = h_wire()
    sides = {}
    # Distinct ids (the registry keys series by node id) that sort alike
    # against the client's, so both tables give the same ordinals.
    nodes = {"card": "ja", "host": "jb"}
    for role in ("card", "host"):
        crdt = DenseCrdt(nodes[role], N_SLOTS, device=TWINS[role],
                         wall_clock=FakeClock())
        rng = np.random.default_rng(31)
        with crdt.ingest(auto_flush_rows=FLUSH_ROWS + 1):
            crdt.put_batch(rng.choice(N_SLOTS, FLUSH_ROWS, replace=False),
                           rng.integers(-2 ** 62, 2 ** 62, FLUSH_ROWS))
        client = DenseCrdt("jz", N_SLOTS, device="cpu",
                           wall_clock=FakeClock())
        script.seed_client(client, N_SLOTS)
        if role == "card":
            torch.cuda.synchronize()
            k0 = obs_device.launches()

        def run(crdt=crdt, client=client):
            with ServeTier(crdt) as tier, \
                    wire.RecordingProxy(tier.host, tier.port) as proxy:
                out = script.converse(net, proxy.host, proxy.port,
                                      client, tier, N_SLOTS)
                return out, proxy.streams()
        if role == "card":
            (out, streams), prof = g_profiled(run)
            launches = j_launches_since(k0)
        else:
            t0 = time.perf_counter()
            out, streams = run()
            prof["twin_s"] = time.perf_counter() - t0
        sides[role] = (out, streams, crdt, client)
    c_out, c_streams, c_crdt, c_cli = sides["card"]
    h_out, h_streams, h_crdt, h_cli = sides["host"]
    norm = lambda b: j_normalize(b, nodes["card"], nodes["host"])
    check(json.loads(norm(json.dumps(c_out).encode()))
          == json.loads(json.dumps(h_out)),
          "path J conversation: replies differ from the host twin's")
    check(len(c_streams) == len(h_streams) == 3,
          "path J conversation: sessions")
    frames = 0
    for i, ((cc, cs), (hc, hs)) in enumerate(zip(c_streams, h_streams)):
        cf = [norm(f) for f in wire.untraced(cc)]
        sf = [norm(f) for f in wire.untraced(cs)]
        hcf, hsf = wire.untraced(hc), wire.untraced(hs)
        if i == 2:
            sf, hsf = (sf[:-script.METRICS_FRAMES],
                       hsf[:-script.METRICS_FRAMES])
        check(cf == hcf and sf == hsf,
              f"path J conversation: session {i}'s frames differ")
        frames += len(cf) + len(sf)
    check(max_abs_err(c_crdt.store, [x.to("cuda") for x in h_crdt.store])
          == 0, "path J conversation: card tier's lanes differ")
    check(str(c_crdt.canonical_time).replace(nodes["card"], nodes["host"])
          == str(h_crdt.canonical_time), "path J conversation: clock")
    check(max_abs_err([x.to("cuda") for x in c_cli.store],
                      [x.to("cuda") for x in h_cli.store]) == 0,
          "path J conversation: clients differ")
    check(launches["fanin_split"] >= 1 and launches["ingest_scatter"] >= 1,
          f"path J conversation: launches {launches}")
    steps["conversation"] = prof
    g_report("conversation", prof, "J")
    return dict(frames=frames, gc_purged=c_out["gc_purged"],
                launches={k: v for k, v in launches.items() if v})


def j_wait_event(watch, slot: int, value: int, what: str) -> None:
    deadline = time.monotonic() + 60.0
    while True:
        check(time.monotonic() < deadline, f"{what}: no event")
        if (slot, value) in watch.next_event(timeout=60.0):
            return


def j_fed_run(fed, fleet, seated: int, flip) -> tuple:
    """One federation-aware open-loop run with ``flip`` called at
    `J_FED_FLIP_AT` of its measured window; (fleet result, flip stats)."""
    import threading
    done: dict = {}

    def act(start):
        at = start + J_FED_WARMUP + J_FED_FLIP_AT * J_FED_DURATION
        time.sleep(max(0.0, at - time.monotonic()))
        try:
            done["stats"] = flip()
        except BaseException as e:     # surfaced below
            done["error"] = e

    seed = fed.tiers[0]
    holder = {}

    def on_start(start):
        holder["t"] = threading.Thread(target=act, args=(start,))
        holder["t"].start()

    routing_py = os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "crdt_tpu_torch", "routing.py")
    out = fleet.run(dict(mode="fed", sessions=seated, rate=J_FED_RATE,
                         warmup=J_FED_WARMUP, duration=J_FED_DURATION,
                         host=seed.host, port=seed.port, n_slots=N_SLOTS,
                         routing_py=routing_py), on_start=on_start)
    holder["t"].join()
    if "error" in done:
        raise done["error"]
    c = out["counters"]
    check(c["attempts"] == c["acked"] > 0 and c["errors"] == 0
          and c["connect_failures"] == 0,
          f"path J federation: fleet counters {c}")
    return out, done["stats"]


def j_federation(steps: dict) -> dict:
    """Step 3: a four-partition federation under bench_federate's
    federation-aware sessions, a live split and a live merge."""
    from crdt_tpu_torch import FederatedClient, FederatedTier
    fleet, _ = j_modules()
    soft = fleet.raise_fd_limit(J_FED_SESSIONS + 2048)
    seated = max(1, min(J_FED_SESSIONS, soft - 2048))
    fed = FederatedTier(N_SLOTS, partitions=4, flush_interval=0.002,
                        max_sessions=seated + 256, device="cuda")
    rows = {}
    watches = []
    with fed:
        cli = FederatedClient(fed.addrs(), timeout=60.0)
        fleet_slots = {(k * N_SLOTS) // seated for k in range(seated)}
        t0 = fed.tiers[0]
        slot_a = next(s for s in range(t0.router.table.ranges_of(
            t0.router.addr)[0][0], N_SLOTS) if s not in fleet_slots)
        watch_a = cli.watch(t0.router.addr, slots=[slot_a])
        watches.append(watch_a)
        try:
            cli.put(slot_a, 1000)
            j_wait_event(watch_a, slot_a, 1000, "path J watch (before)")
            e0 = fed.table.epoch
            cli.close()
            (run1, split), prof1 = g_profiled(
                lambda: j_fed_run(fed, fleet, seated, fed.split_hot))
            check(fed.table.epoch == e0 + 1 and split["epoch"] == e0 + 1,
                  "path J federation: the split did not advance the epoch")
            check(run1["counters"]["moved"] > 0,
                  "path J federation: no session saw the split")
            # The migrated range: every donor row of [mid, hi) is on the
            # recipient, the same row or a later write.
            donor = fed.tier_at(split["src_addr"])
            recip = fed.tier_at(split["dst_addr"])
            mid, hi = split["split_at"], split["range"][1]
            with donor.lock, recip.lock:
                d, r = donor.crdt.store, recip.crdt.store
                span = slice(mid, hi)
                moved = d.occupied[span]
                check(bool(r.occupied[span][moved].all())
                      and bool((r.lt[span][moved]
                                >= d.lt[span][moved]).all())
                      and not bool(r.occupied[:mid].any())
                      and not bool(r.occupied[hi:].any()),
                      "path J federation: the migrated range is not the "
                      "donor's rows")
                migrated = int(moved.sum())
            cli = FederatedClient(fed.addrs(), timeout=60.0)
            cli.put(slot_a, 1001)
            j_wait_event(watch_a, slot_a, 1001, "path J watch (split)")
            slot_b = next(s for s in range(mid, hi)
                          if s not in fleet_slots)
            watch_b = cli.watch(recip.router.addr, slots=[slot_b])
            watches.append(watch_b)
            cli.put(slot_b, 2001)
            j_wait_event(watch_b, slot_b, 2001, "path J watch B (split)")
            cli.close()
            src = [t.router.addr for t in fed.tiers].index(
                split["dst_addr"])
            (run2, merge), prof2 = g_profiled(
                lambda: j_fed_run(fed, fleet, seated,
                                  lambda: fed.merge_cold(src=src)))
            check(fed.table.epoch == e0 + 2 and len(fed.tiers) == 4,
                  "path J federation: the merge did not advance the epoch")
            check(merge["rehomed_watchers"] >= 1,
                  "path J federation: no watcher re-homed")
            cli = FederatedClient(fed.addrs(), timeout=60.0)
            cli.put(slot_a, 1002)
            j_wait_event(watch_a, slot_a, 1002, "path J watch (merge)")
            cli.put(slot_b, 2002)
            j_wait_event(watch_b, slot_b, 2002, "path J watch B (merge)")
            check(watch_b.moved_rehomes == 1
                  and watch_b.addr == merge["dst_addr"],
                  "path J federation: watch B did not re-home")
            # Every acked write of the second run, on its owner's card
            # store.
            last = dict(map(tuple, run2["last"]))
            table = fed.table
            for t in fed.tiers:
                mine = {s: v for s, v in last.items()
                        if table.owner_of(s) == t.router.addr}
                if not mine:
                    continue
                idx = torch.tensor(list(mine), device="cuda")
                with t.lock:
                    st = t.crdt.store
                    ok = (bool(st.occupied[idx].all())
                          and not bool(st.tomb[idx].any())
                          and st.val[idx].cpu().tolist()
                          == list(mine.values()))
                check(ok, f"path J federation: acked writes lost on "
                      f"{t.crdt.node_id}")
                rows[str(t.crdt.node_id)] = len(mine)
        finally:
            for w in watches:
                w.close()
            cli.close()
    steps["federation_split"] = prof1
    steps["federation_merge"] = prof2
    g_report("federation split run", prof1, "J")
    g_report("federation merge run", prof2, "J")

    def run_row(run, stats):
        return dict(p50_ms=run["p50_ms"], p99_ms=run["p99_ms"],
                    **j_rates(run, run["connected"] * J_FED_RATE),
                    acked=run["counters"]["acked"],
                    moved=run["counters"]["moved"],
                    reconnects=run["counters"]["reconnects"],
                    busy=run["counters"]["busy"],
                    migrated_rows=stats["migrated_rows"],
                    rounds=stats["rounds"], epoch=stats["epoch"],
                    seconds=stats["seconds"],
                    flip_to_drain_seconds=stats["flip_to_drain_seconds"])
    out = dict(requested=100_000, seated=seated, rate_hz=J_FED_RATE,
               split=run_row(run1, split), merge=run_row(run2, merge),
               split_migrated_checked=migrated, readback=rows,
               reduced=["sessions 100,000 -> "
                        f"{seated} (bench_federate's 1,000 ops/s offered "
                        "cap; fd limit)", "warmup 3 -> 1 s, duration "
                        "10 -> 5 s a run (time)"])
    print(f"  path J federation: {seated} sessions; split run p99 "
          f"{out['split']['p99_ms']:.3f} ms, {out['split']['moved']} "
          f"moved, {out['split']['migrated_rows']} rows migrated in "
          f"{out['split']['seconds']:.3f} s; merge run p99 "
          f"{out['merge']['p99_ms']:.3f} ms, "
          f"{out['merge']['migrated_rows']} rows in "
          f"{out['merge']['seconds']:.3f} s")
    return out


def j_failover(steps: dict) -> dict:
    """Step 4: bench_failover's storm against a three-member group on
    the card, three kills of the primary, each followed by a rejoin."""
    import threading

    from crdt_tpu_torch import FederatedClient
    from crdt_tpu_torch.replication import ReplicaGroup
    t_start = time.perf_counter()
    acked: dict = {}
    lock = threading.Lock()
    stop = threading.Event()
    errors: list = []
    retried = [0] * J_WRITERS

    def writer(w, seeds):
        cli = FederatedClient(seeds, timeout=60.0)
        my = [w * J_WRITER_SLOTS + j for j in range(J_WRITER_SLOTS)]
        i = 0
        try:
            while not stop.is_set():
                slot, val = my[i % len(my)], i + 1
                try:
                    cli.put(slot, val)
                except ConnectionError:
                    # The client's retry budget ran out inside a
                    # failover window: the write was never acked, so it
                    # is re-offered, and counted. A rejection (the
                    # client's ValueError, e.g. a failed flush tick)
                    # ends the writer and fails the step.
                    retried[w] += 1
                    time.sleep(0.02)
                    continue
                with lock:
                    acked[slot] = val
                i += 1
                time.sleep(1.0 / J_WRITE_HZ)
        except Exception as e:
            errors.append(f"writer {w}: {e!r}")
        finally:
            cli.close()

    def lost_on(tier) -> dict:
        with lock:
            want = dict(acked)
        with tier.lock:
            got = {s: tier.crdt.get(s) for s in want}
        return {s: (v, got[s]) for s, v in want.items()
                if got[s] is None or got[s] < v}

    mttrs, epochs = [], []
    with ReplicaGroup(N_SLOTS, device="cuda", **J_FAILOVER) as group:
        seeds = group.member_addrs()
        threads = [threading.Thread(target=writer, args=(w, seeds))
                   for w in range(J_WRITERS)]
        for t in threads:
            t.start()
        probe = FederatedClient(seeds, timeout=60.0)
        try:
            deadline = time.monotonic() + 60.0
            while len(acked) < J_WRITERS:
                check(not errors and time.monotonic() < deadline,
                      f"path J failover: {len(acked)} of {J_WRITERS} "
                      f"writers acked before the storm; errors {errors}")
                time.sleep(0.01)
            for cycle in range(J_KILLS):
                epoch = group.table.epoch
                with lock:
                    checkpoint = dict(acked)
                dead = group.kill_primary()
                t_kill = time.monotonic()
                probe.put(N_SLOTS - 1 - cycle, 9000 + cycle)
                mttrs.append(time.monotonic() - t_kill)
                probe.refresh()
                check(probe.table.epoch > epoch,
                      f"path J failover {cycle}: epoch did not advance")
                epochs.append(probe.table.epoch)
                primary = group.primary
                with primary.tier.lock:
                    got = {s: primary.tier.crdt.get(s) for s in checkpoint}
                check(all(got[s] is not None and got[s] >= v
                          for s, v in checkpoint.items()),
                      f"path J failover {cycle}: acked writes lost")
                group.rejoin(dead.index)
                deadline = time.monotonic() + 60.0
                while any(m.role == "down" for m in group.members):
                    check(time.monotonic() < deadline, "path J rejoin")
                    time.sleep(0.01)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=60.0)
        check(not errors, f"path J failover: writer errors {errors}")
        # Converge: nudge writes re-arm the tick until every member
        # holds one digest root, then every acked write on every member.
        deadline = time.monotonic() + 60.0
        bump = 0
        try:
            while True:
                bump += 1
                probe.put(N_SLOTS - 8, bump)
                roots = []
                for m in group.members:
                    with m.tier.lock:
                        roots.append(int(m.tier.crdt.digest_tree().root))
                if len(set(roots)) == 1:
                    break
                check(time.monotonic() < deadline,
                      "path J failover: replicas never converged")
                time.sleep(0.05)
        finally:
            probe.close()
        for m in group.members:
            lost = lost_on(m.tier)
            check(not lost, f"path J failover: {m.name} lost {lost}")
        failovers = group.failovers
    check(failovers == J_KILLS and epochs == sorted(set(epochs)),
          f"path J failover: {failovers} failovers, epochs {epochs}")
    held = time.perf_counter() - t_start
    print(f"  path J failover: MTTR " + ", ".join(f"{m:.4f}"
                                                  for m in mttrs)
          + f" s; {len(acked)} slots acked, none lost; "
          f"{sum(retried)} writes re-offered after a failover window; "
          f"root {roots[0]:#x} on all 3")
    steps["failover"] = dict(host_s=held)
    return dict(mttr_s=mttrs, epochs=epochs, failovers=failovers,
                acked_slots=len(acked), retried=sum(retried),
                root=roots[0], held_s=held)


def j_autoscale(steps: dict) -> dict:
    """Step 5: the autoscaler over a card federation through one load
    swing: a burst, then quiet."""
    from crdt_tpu_torch import (Autoscaler, FederatedClient, FederatedTier,
                                default_registry)

    def decisions_total() -> float:
        snap = default_registry().snapshot()
        return sum(s["value"] for s in snap["counters"].get(
            "crdt_tpu_autoscale_decisions_total", []))

    def slo():
        return {"checks": {"ack_p99_s": {"ok": True}}}

    before = decisions_total()
    t0 = time.perf_counter()
    with FederatedTier(N_SLOTS, partitions=1, flush_interval=0.002,
                       device="cuda") as fed:
        a = Autoscaler(fed, min_partitions=1, max_partitions=2,
                       split_rows_per_s=50.0, merge_rows_per_s=1.0,
                       hysteresis_ticks=1, cooldown_s=0.0,
                       slo_probe=slo)
        decs = [a.tick()]
        cli = FederatedClient(fed.addrs(), timeout=60.0)
        try:
            for s in range(0, 4096, 8):
                cli.put(s * 256, s)
        finally:
            cli.close()
        epochs = [fed.table.epoch]
        decs.append(a.tick())
        epochs.append(fed.table.epoch)
        decs.append(a.tick())
        time.sleep(0.1)
        decs.append(a.tick())
        epochs.append(fed.table.epoch)
        parts = len(fed.tiers)
        cli = FederatedClient(fed.addrs(), timeout=60.0)
        try:
            reads = [cli.get(s * 256) for s in range(0, 4096, 8)]
        finally:
            cli.close()
        taken = len(a.decisions)
    counted = decisions_total() - before
    acts = [(d["action"], d["reason"], d.get("applied"), d["epoch"])
            for d in decs]
    check(acts == [("hold", "degraded:unmeasured-rate", None, 0),
                   ("split", "hot-rate", True, 0),
                   ("hold", "degraded:unmeasured-rate", None, 1),
                   ("merge", "all-cold", True, 1)],
          f"path J autoscale: decisions {acts}")
    check(epochs == [0, 1, 2] and parts == 1,
          f"path J autoscale: epochs {epochs}, {parts} partitions")
    check(reads == list(range(0, 4096, 8)), "path J autoscale: reads")
    check(counted == taken == 4,
          f"path J autoscale: {counted} counted, {taken} taken")
    held = time.perf_counter() - t0
    steps["autoscale"] = dict(host_s=held)
    print(f"  path J autoscale: {acts}")
    return dict(decisions=acts, epochs=epochs, counted=counted,
                held_s=held)


def path_j(card: str) -> dict:
    """The serving plane on card replicas (module doc)."""
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    obs_device.reset()
    steps: dict = {}
    serve = j_serve(steps)
    conversation = j_conversation(steps)
    federation = j_federation(steps)
    failover = j_failover(steps)
    autoscale = j_autoscale(steps)
    torch.cuda.synchronize()
    launches = obs_device.launches()
    check(launches["ingest_scatter"] > 0 and launches["fanin_split"] > 0
          and all(v == 0 for k, v in launches.items()
                  if k not in ("ingest_scatter", "fanin_split")),
          f"path J: launches {launches}")
    held_s = time.perf_counter() - t0
    print(f"  path J held {held_s:.2f} s")
    return dict(card=card, n_slots=N_SLOTS, serve=serve,
                conversation=conversation, federation=federation,
                failover=failover, autoscale=autoscale, steps=steps,
                launches=launches, held_s=held_s)


K_LAW_ROWS = ROWS_PER_PASS       # K1, K1s and K1p: the main path's merges
K_SAN_MERGES = 8                 # the unpipelined merge_many: 8 x 128 rows
K_PACKED = FLUSH_ROWS            # the merge_packed delta
K_TRACE = os.path.join("chiprun_out", "path_k_trace.jsonl")
K_KERNELS = ("fanin_batch", "fanin_split", "ingest_scatter",
             "fanin_stream", "fanin_batch_sharded")
# The sanitizer's cost: three on/off pairs, each side at the same mean
# place in the order (the last run sanitized, for steps 4 and 5).
K_SAN_ORDER = (False, True, True, False, False, True)


def k_cmd(module: str, *argv: str) -> list:
    """The command line of ``python -m <module> <argv>``."""
    return [sys.executable, "-m", module, *argv]


def k_run(cmd: list, timeout: float = 300.0):
    """``cmd`` from the checkout's root: (rc, stdout, stderr, seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    return proc.returncode, proc.stdout, proc.stderr, \
        time.perf_counter() - t0


def k_gate(card: str) -> dict:
    """Step 1: the analysis gate in a subprocess, its law and audit
    targets on the card."""
    rc, out, err, secs = k_run(k_cmd("crdt_tpu_torch.analysis", "--json"),
                               timeout=600)
    check(rc == 0, f"path K: the gate exited {rc}: {out[-2000:]} "
                   f"{err[-2000:]}")
    doc = json.loads(out)
    gate = doc["gate"]
    check(doc["ok"] and doc["findings"] == [],
          f"path K: the gate found {doc['findings'][:3]}")
    launches = {k: gate["law_launches"].get(k, 0)
                + gate["audit_launches"].get(k, 0) for k in K_KERNELS}
    check(all(launches[k] > 0 for k in K_KERNELS),
          f"path K: the gate's kernel launches {launches}")
    print(f"path K gate: clean; {gate['law_targets']} law targets x "
          f"{len(gate['seeds'])} seeds, {gate['audit_targets']} audit "
          f"targets; lint {gate['lint_s']:.3f} s, laws {gate['laws_s']:.3f} "
          f"s, audit {gate['audit_s']:.3f} s, subprocess {secs:.3f} s; "
          f"launches {launches} [{card}]")
    return dict(gate, launches=launches, subprocess_s=secs)


def k_laws(card: str) -> dict:
    """Step 2: the kernel law targets at the main path's shapes, one
    seed each, compared on the card."""
    from crdt_tpu_torch.analysis import lattice_laws as laws
    wide = laws.kernel_targets("cuda", n=N_SLOTS, rows=K_LAW_ROWS,
                               flush_rows=FLUSH_ROWS, dense=True)
    stream = laws.kernel_targets("cuda", n=N_SLOTS, rows=STREAM_ROWS,
                                 chunks=STREAM_CHUNKS, dense=True)
    pick = ["pallas.model_fanin_batch", "pallas.model_fanin_split[wide]",
            "pallas.ingest_scatter_tiles", "parallel.pallas_fanin_block"]
    targets = [t for t in wide if t.name in pick] + [
        t for t in stream if t.name.startswith("pallas.pallas_fanin_step")]
    out = {}
    for t in targets:
        before = obs_device.launches()
        t0 = time.perf_counter()
        found = laws.run_laws([t], seeds=(0,))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        check(found == [], f"path K: {t.name} broke a law: "
                           f"{found[0].format()[:2000] if found else ''}")
        fired = {k: v - before[k] for k, v in obs_device.launches().items()
                 if v != before[k]}
        check(fired, f"path K: {t.name} launched no kernel")
        out[t.name] = dict(s=secs, launches=fired,
                           laws=2 if t.combine is None else 3)
        print(f"path K laws {t.name}: {out[t.name]['laws']} laws hold, "
              f"{secs:.3f} s, launches {fired} [{card}]")
    return out


def k_fixture(card: str) -> dict:
    """Step 3: the planted broken join must fail the gate."""
    rc, out, err, secs = k_run(k_cmd("crdt_tpu_torch.analysis",
                                     "--law-fixture",
                                     "tests/torch_broken_merge.py"))
    check(rc == 1 and "violated by broken-mean-join" in out
          and "violating input" in out,
          f"path K: the planted fixture exited {rc}: {out[-800:]} "
          f"{err[-800:]}")
    head = out.splitlines()[:3]
    print(f"path K planted fixture: exit {rc} in {secs:.3f} s [{card}]")
    for line in head:
        print(f"  {line}")
    return dict(rc=rc, s=secs, head=head)


def k_step(name: str, steps: dict, fn):
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    steps[name] = time.perf_counter() - t0
    return out


def k_sanitized(sanitize: bool):
    """Step 4's op script on fresh replicas, with the sanitizer on or
    off from before any model is built: the main path's 16 flushes, an
    unpipelined merge_many of 8 x 128 rows, a 65,536-row merge_packed,
    gc_purge and the fenced replay of both deltas, one gossip round
    between two nodes. The tracer writes every run's spans to
    ``K_TRACE`` (the file holds the last run's), so both sides carry
    its cost. Returns ``(lanes, steps, (node a, node b))``; the caller
    stops the nodes."""
    import random

    from crdt_tpu_torch import GossipNode
    from crdt_tpu_torch.obs.trace import tracer
    if sanitize:
        os.environ["CRDT_TPU_SANITIZE"] = "1"
    else:
        os.environ.pop("CRDT_TPU_SANITIZE", None)
    steps: dict = {}
    start = MILLIS + 500
    a = DenseCrdt("k0", N_SLOTS, node_ids=IDS, wall_clock=StepClock(start),
                  device="cuda")
    b = DenseCrdt("k1", N_SLOTS, node_ids=IDS,
                  wall_clock=StepClock(start + 7), device="cuda")
    ring = tracer()
    os.makedirs("chiprun_out", exist_ok=True)
    if os.path.exists(K_TRACE):
        os.remove(K_TRACE)
    ring.enable(jsonl_path=K_TRACE)
    try:
        def flushes():
            with a.ingest(auto_flush_rows=FLUSH_ROWS):
                for f in range(FLUSHES):
                    a.put_batch(*flush_inputs(f))

        k_step("ingest_16_flushes", steps, flushes)
        batches = [(make_changeset(ROWS_PER_PASS, N_SLOTS, 4000 + i), IDS)
                   for i in range(K_SAN_MERGES)]
        k_step("merge_many_8x128", steps, lambda: a.merge_many(batches))
        slots, vals, tombs = flush_inputs(99, rows=K_PACKED)
        b.put_batch(slots, vals, tombs)
        packed = b.pack_since()
        k_step("merge_packed_65536", steps,
               lambda: a.merge_packed(*packed))
        n_purged = k_step("gc_purge", steps, lambda: a.gc_purge(
            a.canonical_time, drift_slack_ms=0))
        check(n_purged > 0, "path K: gc_purge purged nothing")

        def replay():
            a.merge_many(batches)
            a.merge_packed(*packed)

        k_step("fenced_replay", steps, replay)
        na = GossipNode(a, rng=random.Random(7)).start()
        nb = GossipNode(b, rng=random.Random(7)).start()
        try:
            na.add_peer("k1", nb.host, nb.port)
            nb.add_peer("k0", na.host, na.port)
            if sanitize:
                from crdt_tpu_torch.analysis.concurrency import OrderedLock
                check(isinstance(na.lock, OrderedLock),
                      "path K: the sanitized node's lock is not an "
                      "OrderedLock")
            result = k_step("gossip_round", steps, na.run_round)
            check(result == {"k1": "ok"}, f"path K: the gossip round {result}")
        except BaseException:
            na.stop()
            nb.stop()
            raise
    finally:
        ring.disable()
    lanes = {f: torch.cat([getattr(a.store, f).reshape(-1).long(),
                           getattr(b.store, f).reshape(-1).long()])
             for f in ("lt", "node", "val", "mod_lt", "mod_node",
                       "occupied", "tomb")}
    return lanes, steps, (na, nb)


def k_sanitizer_runs(card: str):
    """The op script once off (a warm-up, whose lanes every later run
    must equal), then once for each entry of ``K_SAN_ORDER`` (off, on,
    on, off, off, on): each side holds about the same mean place in the
    order, so a warm-up or a drift largely cancels out of the paired
    on-minus-off times. The last run is sanitized, and its nodes stay
    up for step 5.
    Returns ``(cost, nodes)``."""
    ref, _, nodes = k_sanitized(False)
    for node in nodes:
        node.stop()
    order = K_SAN_ORDER
    runs = {False: [], True: []}
    nodes = None
    try:
        for i, sanitize in enumerate(order):
            lanes, steps, nodes = k_sanitized(sanitize)
            if i < len(order) - 1:
                for node in nodes:
                    node.stop()
                nodes = None
            check(all(torch.equal(lanes[f], ref[f]) for f in lanes),
                  f"path K: run {i} (sanitizer {'on' if sanitize else 'off'})"
                  " ended with other lanes than the plain run's")
            runs[sanitize].append(steps)
            del lanes
    except BaseException:
        if nodes is not None:
            for node in nodes:
                node.stop()
        raise
    cost = {}
    for name in runs[True][0]:
        on = [r[name] for r in runs[True]]
        off = [r[name] for r in runs[False]]
        deltas = [x - y for x, y in zip(on, off)]
        cost[name] = dict(on_s=on, off_s=off, delta_s=deltas,
                          median_delta_s=float(np.median(deltas)),
                          median_off_s=float(np.median(off)))
        print(f"path K sanitizer {name}: on - off median "
              f"{cost[name]['median_delta_s'] * 1e3:.3f} ms (pairs "
              f"{', '.join(f'{d * 1e3:.3f}' for d in deltas)} ms), off "
              f"median {cost[name]['median_off_s']:.4f} s [{card}]")
    return cost, nodes


def k_lock_violations() -> float:
    from crdt_tpu_torch.obs.registry import default_registry
    return sum(s["value"] for s in default_registry().counter(
        "crdt_tpu_lock_order_violations_total").samples())


def k_planted() -> str:
    """A merge whose join keeps the old lanes must raise under the
    sanitizer on the card."""
    from crdt_tpu_torch.analysis.sanitizer import LatticeViolation
    c = DenseCrdt("kc", N_SLOTS, node_ids=IDS, wall_clock=StepClock(MILLIS),
                  device="cuda")
    real = c._dispatch_fanin

    def keep_old(cs, wall):
        _, res, seen, vo, g = real(cs, wall)
        return c._store, res, seen, vo, g

    c._dispatch_fanin = keep_old
    cs = make_changeset(ROWS_PER_PASS, N_SLOTS, 4100)
    try:
        c.merge(cs, IDS)
    except LatticeViolation as e:
        return str(e)
    raise Failure("path K: a planted lost update did not raise")


def k_obs(card: str, nodes) -> dict:
    """Step 5: the observability command line against the step's card
    nodes, in subprocesses started together."""
    na, nb = nodes
    na.enable_canary(0, 2)
    nb.enable_canary(1, 2)
    for _ in range(2):
        check(na.run_round() == {"k1": "ok"} and nb.run_round() == {
            "k0": "ok"}, "path K: canary rounds")
    target = f"{na.host}:{na.port}"
    spec = f"k0={na.host}:{na.port},k1={nb.host}:{nb.port}"
    fix = os.path.join("tests", "fixtures")
    runs = {
        "once": (["--once", target], 0),
        "once_prom": (["--once", "--prom", target], 0),
        # The nodes serve this process's registry, whose ack sketch
        # holds path J's acks, far over the 4.25-ms budget: the verdict
        # fails on that check alone (held below).
        "fleet": (["fleet", "--peers", spec, "--once", "--json"], 1),
        "trace": (["--trace", K_TRACE], 0),
        "bench_regressed": (["bench", "--compare",
                             os.path.join(fix, "trajectory_baseline.jsonl"),
                             "--candidate",
                             os.path.join(fix, "trajectory_regressed.jsonl")],
                            1),
        "bench_clean": (["bench", "--compare",
                         os.path.join(fix, "trajectory_baseline.jsonl"),
                         "--candidate",
                         os.path.join(fix, "trajectory_clean.jsonl")], 0),
    }
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        k_cmd("crdt_tpu_torch.obs", *argv), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=root)
        for name, (argv, _) in runs.items()}
    out = {}
    try:
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=300)
            want = runs[name][1]
            check(proc.returncode == want,
                  f"path K: obs {name} exited {proc.returncode}, want "
                  f"{want}: {stdout[-800:]} {stderr[-800:]}")
            out[name] = dict(rc=proc.returncode, bytes=len(stdout))
            if name == "fleet":
                fleet = json.loads(stdout)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    secs = time.perf_counter() - t0
    checks = fleet["slo"]["checks"]
    failing = sorted(k for k, c in checks.items() if c["ok"] is False)
    ack = checks["ack_p99_s"]
    check(fleet["matrix"]["complete"] and not fleet["slo"]["scrape_errors"]
          and failing == ["ack_p99_s"] and ack["source"] == "sketch"
          and ack["value"] > ack["budget"]
          and checks["convergence_lag_s"]["ok"] is True,
          f"path K: the fleet verdict {fleet['slo']}")
    print(f"path K obs fleet: matrix complete, max lag "
          f"{fleet['matrix']['max_lag_s']} s; fails only ack_p99_s "
          f"(sketch {ack['value']:.4f} s > {ack['budget']} s, path J's acks)")
    exits = ", ".join(f"{k} exit {v['rc']}" for k, v in out.items())
    print(f"path K obs CLI: {exits}; {secs:.3f} s together [{card}]")
    return dict(runs=out, s=secs)


def path_k(card: str) -> dict:
    """The analysis gate and the sanitizer on the card (module doc)."""
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    obs_device.reset()
    gate = k_gate(card)
    laws = k_laws(card)
    fixture = k_fixture(card)
    violations = k_lock_violations()
    try:
        cost, nodes = k_sanitizer_runs(card)
        try:
            planted = k_planted()
            obs = k_obs(card, nodes)
        finally:
            for node in nodes:
                node.stop()
    finally:
        os.environ.pop("CRDT_TPU_SANITIZE", None)
    check(k_lock_violations() == violations,
          "path K: the sanitized runs counted lock-order violations")
    print(f"path K planted lost update: {planted[:160]}")
    torch.cuda.synchronize()
    launches = obs_device.launches()
    for k in K_KERNELS:
        launches[k] += gate["launches"][k]
    check(all(launches[k] > 0 for k in K_KERNELS),
          f"path K: launches {launches}")
    held_s = time.perf_counter() - t0
    print(f"  path K held {held_s:.2f} s [{card}]")
    return dict(card=card, n_slots=N_SLOTS, gate=gate, laws=laws,
                fixture=fixture, sanitizer_cost=cost, planted=planted,
                obs=obs, launches=launches, held_s=held_s)


# --- path L: the group join and the sharded model across the cards ---

L_MAX_CARDS = 4                  # the cards path L spreads over, at most
L_MIN_CARDS = 2
L_LOOPBACK = 8                   # loopback-packed rounds beside the joins
L_AGAIN = 4                      # timed 65,536-row rounds, and typed rounds
# (name, mesh shape, each position's card or None for round robin).
L_SHARDED = (("2x2", (2, 2), None), ("4x1", (4, 1), None),
             ("1x4", (1, 4), None),
             ("4x1_on_2_cards", (4, 1), (0, 1, 0, 1)),
             ("2x2_one_card", (2, 2), (0, 0, 0, 0)))


def l_card(i: int) -> str:
    return f"cuda:{i}"


def sync_all() -> None:
    """Wait for every visible card (``torch.cuda.synchronize()`` waits
    for the current one only)."""
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def l_join(group) -> tuple:
    """One group join: its report, host seconds (every card synced on
    both sides), join calls and `parallel.comm` tally."""
    from crdt_tpu_torch.parallel import comm
    before = obs_device.op_launches()["parallel.collective_join"]
    tally = dict(comm.TALLY)
    sync_all()
    t0 = time.perf_counter()
    report = group.join()
    sync_all()
    s = time.perf_counter() - t0
    return (report, s,
            obs_device.op_launches()["parallel.collective_join"] - before,
            {k: v - tally.get(k, 0) for k, v in comm.TALLY.items()})


def l_profiled(fn, cards: int) -> tuple:
    """``fn()`` under ``torch.profiler``: host seconds, and per card its
    busy time, device operations and NCCL kernels' time (each device
    event counted on its ``device_index``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sync_all()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync_all()
        host_s = time.perf_counter() - t0
    busy, nccl, ops = [0.0] * cards, [0.0] * cards, [0] * cards
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or not 0 <= e.device_index < cards:
            continue
        ms = e.time_range.elapsed_us() / 1e3
        busy[e.device_index] += ms
        ops[e.device_index] += 1
        if "nccl" in e.name.lower():
            nccl[e.device_index] += ms
    seen = any(ops)
    return out, dict(host_s=host_s, device_ms=busy if seen else None,
                     device_ops=ops, nccl_ms=nccl if seen else None,
                     idle_share=[1 - b / 1e3 / host_s for b in busy]
                     if seen else None)


def l_group_sets(cards: int, make) -> dict:
    """Three groups of four members, member ``i`` built by ``make(i,
    device)``: ``cards`` (member i on card i mod ``cards``, the default
    mesh: NCCL across the cards), ``funnel`` (the same cards, the funnel
    twin) and ``one_card`` (every member on the first card, the stacked
    route)."""
    from crdt_tpu_torch import CollectiveGroup
    from crdt_tpu_torch.parallel import make_collective_mesh
    spread = [l_card(i % cards) for i in range(I_MEMBERS)]
    return dict(
        cards=CollectiveGroup([make(i, d) for i, d in enumerate(spread)]),
        funnel=CollectiveGroup(
            [make(i, d) for i, d in enumerate(spread)],
            mesh=make_collective_mesh(I_MEMBERS, spread, funnel=True)),
        one_card=CollectiveGroup(
            [make(i, l_card(0)) for i in range(I_MEMBERS)],
            mesh=make_collective_mesh(I_MEMBERS, [l_card(0)] * I_MEMBERS)))


def l_joins(sets: dict, what: str, steps: dict = None) -> dict:
    """One join of each group, each held against the cards' group bit
    for bit: report, every member's lanes, clock and seeded pack. The
    cards' group must keep each member on its own card and move nothing
    through the funnel. Returns each group's seconds, the profiler off;
    given ``steps``, the cards' join runs under the profiler instead,
    into ``steps[what]`` (an extra round, its seconds not returned)."""
    cards = len({m.device for m in sets["cards"].members})
    out, reports = {}, {}
    for name, group in sets.items():
        if name == "cards" and steps is not None:
            (rep, s, calls, moved), row = l_profiled(
                lambda: l_join(group), cards)
            row["comm"] = moved
            steps[what] = row
            g_report(what, row if row["device_ms"] is None else dict(
                row, device_ms=sum(row["device_ms"]),
                device_ops=sum(row["device_ops"]),
                idle_share=min(row["idle_share"])), "L")
            print(f"  path L {what} per card: busy {row['device_ms']} ms, "
                  f"NCCL {row['nccl_ms']} ms, {moved.get('nccl_calls', 0)} "
                  f"NCCL calls, {moved.get('nccl_bytes_a_card', 0)} B a "
                  "card")
        else:
            rep, s, calls, moved = l_join(group)
            out[name] = s
        check(calls == 1, f"path L: {what}: {name} made {calls} join calls")
        if name == "cards":
            check(moved.get("funnel_bytes", 0) == 0
                  and (moved.get("nccl_calls", 0) > 0)
                  == (group.mesh.layout.route == "nccl"),
                  f"path L: {what}: the cards' join moved {moved}")
            for i, m in enumerate(group.members):
                check(all(lane.device == torch.device(l_card(i % cards))
                          for lane in m._store),
                      f"path L: {what}: member {m.node_id} left its card")
        reports[name] = rep
    for name in ("one_card", "funnel"):
        i_groups_equal(sets["cards"], sets[name], reports["cards"],
                       reports[name], f"{what} against {name}", path="L")
    return dict(out, digest_root=reports["cards"].digest_root,
                adopted=reports["cards"].adopted)


def l_rounds(sets: dict, what: str, rounds: int, write, steps: dict
             ) -> dict:
    """``rounds`` timed rounds of ``write(sets, r)`` then a join of each
    group, the profiler off, then one more under the profiler into
    ``steps[what]``: each group's seconds a round, in order."""
    times = {k: [] for k in sets}
    for r in range(rounds):
        write(sets, r)
        for k, s in l_joins(sets, f"{what} {r}").items():
            if k in times:
                times[k].append(s)
    write(sets, rounds)
    l_joins(sets, what, steps)
    return times


def l_warm(layout, n: int) -> None:
    """Every NCCL collective the joins issue, once on ``layout``'s cards
    at ``n`` int64 slots: torch builds a communicator per card list, and
    NCCL sets up each kind of collective, at its first call."""
    from crdt_tpu_torch.parallel import comm
    blocks = [torch.zeros((len(g), n), dtype=torch.int64, device=d)
              for g, d in zip(layout.groups, layout.devices)]
    for op in (comm.pmax, comm.pmin, comm.psum, comm.all_gather):
        op(layout, blocks)
    sync_all()


def l_collective(cards: int, steps: dict) -> dict:
    """The group join across the cards (module doc): 32 rounds of 256
    rows a member, `L_AGAIN` rounds of 65,536 rows, `sync_collective`
    and `L_AGAIN` typed rounds, each on the three `l_group_sets` groups,
    the profiler off; one more profiled round of each kind."""
    from crdt_tpu_torch.parallel import comm
    from crdt_tpu_torch.sync import sync_collective
    flushes = [range(4 * i, 4 * i + 4) for i in range(I_MEMBERS)]
    sets = l_group_sets(
        cards, lambda i, d: i_member(f"m{i}", d, flushes[i]))
    routes = {k: g.mesh.layout.route for k, g in sets.items()}
    check(routes == dict(cards="nccl" if comm.nccl_built() else "funnel",
                         funnel="funnel", one_card="local"),
          f"path L: routes {routes}")
    first = l_joins(sets, "the first join")     # communicators built here
    l_warm(sets["cards"].mesh.layout, N_SLOTS)
    rng = np.random.default_rng(1000)
    lww = lambda rows: lambda groups, r: i_write(
        [g.members for g in groups.values()], rng, rows)
    times = l_rounds(sets, "collective_join_256", I_ROUNDS,
                     lww(I_ROUND_ROWS), steps)
    big = l_rounds(sets, "collective_join_65536", L_AGAIN, lww(FLUSH_ROWS),
                   steps)
    i_write([g.members for g in sets.values()], rng, I_ROUND_ROWS)
    calls = obs_device.op_launches()["parallel.collective_join"]
    synced = {k: sync_collective(g) for k, g in sets.items()}
    check(obs_device.op_launches()["parallel.collective_join"] - calls == 3,
          "path L: sync_collective made more than one join a group")
    for k in ("one_card", "funnel"):
        i_groups_equal(sets["cards"], sets[k], synced["cards"], synced[k],
                       f"sync_collective against {k}", path="L")
    del sets
    free = i_typed_slots()
    typed_sets = l_group_sets(cards, lambda i, d: i_typed_member(i, d, free))

    def typed_write(groups: dict, r: int) -> None:
        """Round 0 joins the seeded members (path I's typed round; their
        reads checked after); later rounds add typed ops a member."""
        if r == 1:
            i_typed_reads(groups["cards"].members, free, "path L")
        if r == 0:
            return
        g, p, _, v = free
        for group in groups.values():
            for i, m in enumerate(group.members):
                m.counter_add(g[i], r)
                m.counter_add(p[i], -r)
                m.mvreg_put(v[0], 1000 * r + i)

    typed = l_rounds(typed_sets, "collective_join_typed", L_AGAIN,
                     typed_write, steps)
    del typed_sets
    med = lambda runs: {k: float(np.median(v)) for k, v in runs.items()}
    medians = med(times)
    print(f"  path L group join, 4 x 2^20, {I_ROUND_ROWS} rows a member, "
          f"median of {I_ROUNDS}: {cards} cards "
          f"{medians['cards'] * 1e3:.3f} ms ({routes['cards']}), funnel "
          f"{medians['funnel'] * 1e3:.3f} ms, one card "
          f"{medians['one_card'] * 1e3:.3f} ms")
    for what, runs in (("65,536-row", big), ("typed", typed)):
        print(f"  path L {what} join, median of {L_AGAIN}: " + ", ".join(
            f"{k} {v * 1e3:.3f} ms" for k, v in med(runs).items()))
    return dict(members=I_MEMBERS, rounds=I_ROUNDS, rows=I_ROUND_ROWS,
                routes=routes, join_s_median=medians,
                join_s_min={k: min(v) for k, v in times.items()},
                join_s_max={k: max(v) for k, v in times.items()},
                first_join_s={k: first[k] for k in times},
                join_65536_s_median=med(big), join_65536_s_runs=big,
                typed_join_s_median=med(typed), typed_join_s_runs=typed,
                digest_root=synced["cards"].digest_root)


def l_gossip(cards: int, steps: dict, join_s: float) -> dict:
    """Three GossipNodes over card replicas at 2^20: g0 on the first
    card and g1 on the second in a group with declared addresses (the
    collective lane across two cards), r0 remote (packed). A sweep, a
    second to converge, then loopback packed rounds of 256 rows."""
    import random

    from crdt_tpu_torch import CollectiveGroup, GossipNode
    reps = [i_member(n, d, [f]) for n, d, f in (
        ("g0", l_card(0), 4), ("g1", l_card(1), 5), ("r0", l_card(0), 6))]
    nodes = [GossipNode(c, rng=random.Random(7)).start() for c in reps]
    try:
        n0, n1, nr = nodes
        group = CollectiveGroup(reps[:2],
                                addresses={"g0": f"{n0.host}:{n0.port}",
                                           "g1": f"{n1.host}:{n1.port}"})
        n0.attach_group(group)
        p1 = n0.add_peer("g1", n1.host, n1.port)
        far = n0.add_peer("r0", nr.host, nr.port, mode="packed")
        calls = obs_device.op_launches()["parallel.collective_join"]
        first, row = l_profiled(n0.run_round, cards)
        steps["gossip_sweep"] = row
        calls = obs_device.op_launches()["parallel.collective_join"] - calls
        check(first == {"g1": "ok", "r0": "ok"} and calls == 1
              and p1.last_attempt == "collective"
              and far.last_attempt == "packed"
              and group.mesh.layout.route != "local",
              f"path L: the sweep {first}, {calls} joins, "
              f"{p1.last_attempt} / {far.last_attempt}")
        n0.run_round()
        roots = {c.digest_tree().root for c in reps}
        # Node ordinals are each replica's own: compare the other lanes.
        replicated = lambda c: [getattr(c._store, f) for f in (
            "lt", "val", "tomb", "occupied")]
        check(len(roots) == 1 and all(
            max_abs_err(replicated(reps[0]), replicated(c)) == 0
            for c in reps)
              and reps[1]._store.lt.device == torch.device(l_card(1)),
              "path L: the three nodes did not converge")
        rng = np.random.default_rng(77)
        loop = []
        for _ in range(L_LOOPBACK):
            slots = rng.choice(N_SLOTS, I_ROUND_ROWS, replace=False)
            with n0.lock:
                reps[0].put_batch(slots, slots % 1000)
            sync_all()
            t0 = time.perf_counter()
            check(n0.sync_peer("r0") == "ok", "path L: a loopback round")
            loop.append(time.perf_counter() - t0)
        loop_s = float(np.median(loop))
    finally:
        for n in nodes:
            n.stop()
    print(f"  path L loopback packed round {loop_s * 1e3:.3f} ms vs the "
          f"{cards}-card join {join_s * 1e3:.3f} ms (medians)")
    return dict(route=group.mesh.layout.route, loopback_round_s=loop_s,
                loopback_round_s_runs=loop)


def l_sharded(cards: int) -> dict:
    """Path C's script (`sharded_ops`) on `ShardedDenseCrdt` at 2^20 over
    the meshes of ``L_SHARDED``, each held against one unsharded run on
    the first card: lanes, clock, exception, delta, digest root, every
    replica copy; K1p one launch per card and merge."""
    from crdt_tpu_torch.parallel import comm
    start = MILLIS + 500
    twin = DenseCrdt("n0", N_SLOTS, node_ids=IDS, wall_clock=StepClock(start))
    ref = sharded_ops(twin, N_SLOTS, FLUSHES, FLUSH_ROWS, PASSES)
    e2, (c2, p2, w2) = ref.pop("error"), ref.pop("delta")
    root = twin.digest_tree().root
    runs, total = [], {}
    for name, shape, on in L_SHARDED:
        positions = int(np.prod(shape))
        devices = [l_card((i if on is None else on[i]) % cards)
                   for i in range(positions)]
        mesh = parallel.make_fanin_mesh(*shape, devices)
        crdt = ShardedDenseCrdt("n0", N_SLOTS, mesh, node_ids=IDS,
                                wall_clock=StepClock(start))
        # NCCL builds a communicator per list of cards at its first call:
        # build the mesh's and each key column's before the timed window.
        for lay in [mesh.layout] + mesh.columns:
            comm.pmax(lay, [torch.zeros((len(g), 1), dtype=torch.int64,
                                        device=d)
                            for g, d in zip(lay.groups, lay.devices)])
        sync_all()
        obs_device.reset()
        tally = dict(comm.TALLY)
        got = sharded_ops(crdt, N_SLOTS, FLUSHES, FLUSH_ROWS, PASSES)
        sync_all()
        launches = obs_device.launches()
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        n_dev = len(set(mesh.devices.flat))
        want = dict(fanin_batch_sharded=n_dev * (PASSES + 3),
                    ingest_scatter=positions * (FLUSHES + 1))
        what = f"path L sharded {name}"
        check(all(launches[k] == v for k, v in want.items())
              and launches["fanin_batch"] == 0,
              f"{what}: launches {launches}, expected {want}")
        err = max_abs_err(crdt.store, twin.store)
        check(err == 0, f"{what}: lanes differ from the unsharded model "
                        f"(max |err| {err})")
        check(crdt.canonical_time == twin.canonical_time,
              f"{what}: canonical clock differs from the unsharded model")
        e1 = got.pop("error")
        check(type(e1) is type(e2) and e1.args == e2.args,
              f"{what}: exception {e1!r} != {e2!r}")
        c1, p1, w1 = got.pop("delta")
        check(max_abs_err(c1, c2) == 0 and w1 == w2 and all(
            getattr(p1, f).tobytes() == getattr(p2, f).tobytes()
            for f in ("slots", "lt", "node", "val", "tomb"))
            and p1.k == DELTA_ROWS, f"{what}: deltas differ")
        check_copies(crdt._store, what)
        check(crdt.digest_tree().root == root,
              f"{what}: the digest root differs from the unsharded one")
        routes = sorted({c.route for c in mesh.columns})
        runs.append(dict(
            name=name, mesh=dict(mesh.shape), devices=devices, cards=n_dev,
            column_routes=routes, mesh_route=mesh.layout.route,
            merges_per_s=got["records_merged"] / got["window_s"],
            ingest_rows_per_s=FLUSHES * FLUSH_ROWS / got["ingest_s"],
            launches=launches,
            comm={k: v - tally.get(k, 0) for k, v in comm.TALLY.items()},
            **got))
        print(f"  path L sharded {name} on {n_dev} card(s) "
              f"({'/'.join(routes)}): {runs[-1]['merges_per_s']:.4g} "
              f"merged records/s, window {got['window_s']:.4f} s, "
              f"ingest {got['ingest_s']:.4f} s")
        del crdt
    return dict(twin_merges_per_s=ref["records_merged"] / ref["window_s"],
                twin_window_s=ref["window_s"], runs=runs, launches=total)


def path_l(card: str) -> dict:
    """The group join and the sharded model across the cards (module
    doc); on fewer than two cards, a line saying so."""
    from crdt_tpu_torch.parallel import comm
    count = torch.cuda.device_count()
    if count < L_MIN_CARDS:
        print(f"path L: not run: {count} card visible, it needs "
              f"{L_MIN_CARDS}")
        return dict(ran=False, cards=count, needs=L_MIN_CARDS)
    cards = min(L_MAX_CARDS, count)
    t0 = time.perf_counter()
    sync_all()
    obs_device.reset()
    comm.reset_tally()
    nccl = (".".join(str(x) for x in torch.cuda.nccl.version())
            if comm.nccl_built() else None)
    print(f"path L: {cards} cards, "
          + (f"NCCL {nccl}" if nccl else "torch built without NCCL: "
             "the funnel's peer copies carry the cross-card steps")
          + f" [{card}]")
    steps: dict = {}
    join = l_collective(cards, steps)
    gossip = l_gossip(cards, steps, join["join_s_median"]["cards"])
    sync_all()
    launches = obs_device.launches()
    sharded = l_sharded(cards)
    for k, v in sharded["launches"].items():
        launches[k] += v
    check(launches["fanin_batch_sharded"] > 0 and all(
        v == 0 for k, v in launches.items()
        if k not in ("fanin_batch_sharded", "ingest_scatter")),
          f"path L: launches {launches}")
    held_s = time.perf_counter() - t0
    print(f"  path L held {held_s:.2f} s [{card}]")
    return dict(ran=True, card=card, cards=cards,
                card_names=[torch.cuda.get_device_name(i)
                            for i in range(cards)],
                nccl_version=nccl, n_slots=N_SLOTS, join=join,
                gossip=gossip, sharded=sharded, steps=steps,
                launches=launches, tally=dict(comm.TALLY), held_s=held_s)


LOOPS = 48                       # the probe CLI's --loops
STREAM_REPEATS = 64              # bench.py's --repeats


def path_d(card: str, results: dict) -> dict:
    """Every variant of ``python -m crdt_tpu_torch.bench.probe_kernel``
    at its defaults (2^20 keys, 1024 replicas in chunks of 8; 128 rows,
    48 loops), the distinct row wide and value-ref and the stream row
    (`bench.fanin`), counted; then P2 and K1 timed in turns from replayed
    graphs and ``copy_`` of P2's lanes: P2's achieved rate is the
    measured copy rate, and each fan-in kernel's counted bytes over it
    its time at that rate."""
    replicas = PROBE_ROWS * PROBE_CHUNKS
    torch.cuda.synchronize()
    obs_device.reset()
    variants = [bench_probe.run_variant(v, N_SLOTS, replicas, PROBE_ROWS)
                for v in bench_probe.VARIANTS]
    batch = [bench_probe.run_batch_copy(N_SLOTS, BATCH_ROWS, loops=LOOPS,
                                        value_width=w) for w in (64, 32)]
    distinct = [bench_fanin.bench_distinct(N_SLOTS, BATCH_ROWS, loops=LOOPS,
                                           value_width=w) for w in (64, 32)]
    stream = bench_fanin.bench(N_SLOTS, replicas, PROBE_ROWS,
                               repeats=STREAM_REPEATS)
    torch.cuda.synchronize()
    launches = obs_device.launches()
    runs = 1 + 3                 # each probe variant: warm-up + repeats
    want = dict(probe_join=runs * PROBE_CHUNKS, probe_copy=runs * PROBE_CHUNKS,
                probe_stream_noguard=runs,
                probe_copy_batch=2 * runs * LOOPS,
                fanin_split=2 * (1 + LOOPS),
                fanin_stream=runs * (PROBE_CHUNKS + 1) + 1 + STREAM_REPEATS)
    check(all(launches[k] == v for k, v in want.items()),
          f"path D: launches {launches}, expected {want}")
    check(all(d["merges"] > 0 for d in distinct) and stream["merges"] > 0,
          "path D: a row counted no merges")

    store, scs, _ = probe_inputs(BATCH_ROWS, 60)
    wstore = make_store(N_SLOTS, 1)
    wcs = make_changeset(ROWS_PER_PASS, N_SLOTS, 2)
    plant_ties(wstore, wcs)
    canonical = torch.tensor((MILLIS + 500) << SHIFT, device="cuda")
    p2_runs, k1_runs = [], []
    for _ in range(2):                       # P2, K1, P2, K1
        p2_runs += graph_ms(lambda: probe.probe_copy_batch(store, scs),
                            iters=20)
        k1_runs += graph_ms(lambda: fanin_kernel.fanin_cuda_many(
            [wstore], [wcs], canonical, 3), iters=20)
    del wstore, wcs
    dst = type(scs)(*(torch.empty_like(x) for x in scs))
    copy_runs = graph_ms(lambda: [d.copy_(s) for d, s in zip(dst, scs)],
                         iters=20)
    r, n = scs.hi.shape
    copy_bytes = 2 * entry_bytes(scs) * r * n
    p2_bytes = results["probe_copy_batch"]["bytes_moved"]
    p2_ms = float(np.median(p2_runs))
    rate = p2_bytes / p2_ms * 1e3
    copy_ms = float(np.median(copy_runs))
    counted = (("fanin_batch", results["fanin_batch"]),
               ("fanin_split", results["fanin_split"]["forms"]["wide"]),
               ("fanin_split_narrow",
                results["fanin_split"]["forms"]["narrow"]),
               ("fanin_stream", results["fanin_stream"]["guards"]["fast"]),
               ("fanin_stream_exact",
                results["fanin_stream"]["guards"]["exact"]),
               ("fanin_batch_sharded", results["fanin_batch_sharded"]),
               ("ingest_scatter", results["ingest_scatter"]),
               ("probe_join", results["probe_join"]),
               ("probe_copy", results["probe_copy"]),
               ("probe_stream_noguard", results["probe_stream_noguard"]),
               ("probe_copy_batch_valref",
                results["probe_copy_batch"]["forms"]["valref"]))
    at_rate = {}
    for name, row in counted:
        ms_at = row["bytes_moved"] / rate * 1e3
        at_rate[name] = dict(bytes_moved=row["bytes_moved"], ms=row["ms"],
                             bound_ms=row["bound_ms"],
                             ms_at_measured_rate=ms_at,
                             share_of_measured=ms_at / row["ms"])
    del store, scs, dst
    return dict(
        card=card, variants=variants, batch_copy=batch, distinct=distinct,
        stream=stream, launches=launches,
        p2=dict(bytes_moved=p2_bytes, ms=p2_ms, ms_runs=p2_runs,
                bytes_per_s=rate, tb_per_s=rate / 1e12,
                share_of_data_sheet=rate / HBM_BYTES_PER_S),
        k1_again=dict(ms=float(np.median(k1_runs)), ms_runs=k1_runs,
                      phase2_ms=results["fanin_batch"]["ms"]),
        copy_rate=dict(bytes_moved=copy_bytes, ms=copy_ms,
                       ms_runs=copy_runs,
                       bytes_per_s=copy_bytes / copy_ms * 1e3,
                       tb_per_s=copy_bytes / copy_ms / 1e9,
                       lanes="the P2 wide lanes, dst.copy_(src) each"),
        at_measured_rate=at_rate)


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
    kernel_split(results)
    kernel_stream(results)
    kernel_fanin_sharded(results)
    kernel_probes(results)
    guard_cost(results)
    print(f"phase 2: all {len(obs_device.KERNELS)} kernels equal their "
          f"plain versions on the card")
    guard_path()
    path = main_path(card)
    print("phase 3: main path equals the plain fold; deltas match")
    path["breakdown"] = breakdown()
    interchange = path_a(card)
    print("phase 3: path A (export_split_delta -> merge_split, coarse, "
          "unpipelined and exact windows, wide and narrow) equals the "
          "plain fold")
    stream = path_b(card)
    print("phase 3: path B (64 chained stream replays) threads the clock "
          "as the closed form says")
    sharded = path_c(card)
    print("phase 3: path C (ShardedDenseCrdt on (2, 2), (1, 1) and "
          "(2, 1, 2) meshes) equals the unsharded model; replica copies "
          "equal")
    gossip = path_e(card)
    print("phase 3: path E (pack_since -> pack_rows -> unpack_rows -> "
          "merge_packed on both routes, merge_and_repack, merge_json) "
          "equals the host replicas")
    storage = path_f(card)
    print("phase 3: path F (sync_merkle over two divergences, gc_purge, "
          "the fenced replay, compact, save and load) equals the host "
          "replicas and the numpy-uint64 root")
    typed = path_g(card)
    print("phase 3: path G (typed slots: seed, typed fan-in and window, "
          "tagged gossip, withheld and refused packs, sync_merkle and "
          "sync_packed, gc_purge, compact, grow, save and load; the "
          "sharded typed model; the keyed surface and sync_json) equals "
          "the host replicas, with no typed merge through K1, K1s, K1p or "
          "K3")
    wire = path_h(card)
    print("phase 3: path H (dense with and without zlib, packed at three "
          "delta sizes and under the semantics cap, the merkle walk, JSON "
          "through the C codec, a three-node gossip sweep through a fault "
          "proxy, the metrics and debug-dump ops) equals the host twins, "
          "frame for frame")
    general = path_i(card)
    print("phase 3: path I (TpuMapCrdt at 2^20 keys against merge_step on "
          "its mirror, SqliteCrdt through sync_json and a reopen, the "
          "four-member group join over 32 rounds, a 65,536-row round "
          "against pairwise sync_packed and a typed round, the gossip "
          "collective lane and its counted fallback) equals the host "
          "twins, one join call a round")
    serving = path_j(card)
    print("phase 3: path J (a ServeTier under open-loop load, the "
          "scripted conversation frame for frame against its host twin, "
          "a four-partition federation through a live split and merge, "
          "three failovers of a replica group, one autoscaler swing) "
          "read back every acknowledged write; K2 one launch a flush")
    analysis = path_k(card)
    print("phase 3: path K (the analysis gate on the card, K1, K1s, K2, K3 "
          "and K1p under the lattice laws at the main path's shapes, the "
          "planted broken join refused, the sanitizer on the full-size "
          "op script with the plain runs' lanes, the obs command line "
          "against card nodes) held")
    multi = path_l(card)
    if multi["ran"]:
        print(f"phase 3: path L (four members at 2^20 on {multi['cards']} "
              "cards: 32 rounds, the 65,536-row round, a typed round and "
              "sync_collective, each equal to the one-card stacked join and "
              "to the funnel twin; the gossip collective lane across two "
              "cards; ShardedDenseCrdt on (2, 2), (4, 1), (1, 4), four "
              "replicas over two cards and (2, 2) on one card, each equal "
              "to the unsharded model) held")
    probes = path_d(card, results)
    print(f"phase 3: path D (the probe entry point's seven variants, the "
          f"distinct and stream rows) ran; P2 "
          f"{probes['p2']['tb_per_s']:.4f} TB/s, copy_ "
          f"{probes['copy_rate']['tb_per_s']:.4f} TB/s")
    # Each kernel's launches on the path it serves.
    for name, counts in (("fanin_batch", path), ("ingest_scatter", path),
                         ("fanin_split", interchange),
                         ("fanin_stream", stream),
                         ("fanin_batch_sharded", sharded),
                         ("probe_join", probes), ("probe_copy", probes),
                         ("probe_stream_noguard", probes),
                         ("probe_copy_batch", probes)):
        results[name]["launches"] = counts["launches"][name]
    # Path H's rounds run K2 (the seed flushes) and K1s (the dense
    # rounds' merge_split on both ends).
    for name in ("fanin_split", "ingest_scatter"):
        results[name]["launches"] += wire["launches"][name]
    # Path I's members and replicas are seeded by K2 flushes.
    results["ingest_scatter"]["launches"] += \
        general["launches"]["ingest_scatter"]
    # Path J's tiers commit every flush tick through K2; its dense push
    # merges through K1s.
    for name in ("fanin_split", "ingest_scatter"):
        results[name]["launches"] += serving["launches"][name]
    # Path K's gate and law targets launch the five merge kernels.
    for name in K_KERNELS:
        results[name]["launches"] += analysis["launches"][name]
    # Path L's sharded merges launch K1p once a card; K2 seeds its
    # members and commits its sharded flushes.
    if multi["ran"]:
        for name in ("fanin_batch_sharded", "ingest_scatter"):
            results[name]["launches"] += multi["launches"][name]

    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    kernels = {"kernels": [{k: results[n][k] for k in keys}
                           for n in obs_device.KERNELS]}
    record = dict(card=card, build_s=build_s, main_path=path,
                  path_a=interchange, path_b=stream, path_c=sharded,
                  path_d=probes, path_e=gossip, path_f=storage,
                  path_g=typed, path_h=wire, path_i=general,
                  path_j=serving, path_k=analysis, path_l=multi,
                  kernel_detail=results,
                  torch=torch.__version__,
                  held_s=time.perf_counter() - t0)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps({"main_path": path}))
    print(json.dumps({"path_a": interchange}))
    print(json.dumps({"path_b": stream}))
    print(json.dumps({"path_c": sharded}))
    print(json.dumps({"path_d": probes}))
    print(json.dumps({"path_e": gossip}))
    print(json.dumps({"path_f": storage}))
    print(json.dumps({"path_g": typed}, default=str))
    print(json.dumps({"path_h": wire}, default=str))
    print(json.dumps({"path_i": general}, default=str))
    print(json.dumps({"path_j": serving}, default=str))
    print(json.dumps({"path_k": analysis}, default=str))
    print(json.dumps({"path_l": multi}, default=str))
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
