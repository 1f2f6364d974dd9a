// Fan-in lattice join of [R, N] changesets into N-slot stores: one
// logical merge per table entry, the batch mode of the dense replication
// loop. The unsharded merge (K1) is a table of one entry; the sharded
// step (K1p) puts every mesh position of one device in one table and so
// makes one launch per device.
//
// Replaces: crdt_tpu/ops/pallas_merge.py:206 `_fanin_stream_kernel` in
// batch mode (advance_clock=False, no in-kernel guards), launched at
// pallas_merge.py:739 by `pallas_fanin_batch`; and, per key shard, the
// same body inside the sharded step (K1p, crdt_tpu/parallel/fanin.py:263
// `_pallas_fanin_block`), which reads a shard's column block of the
// changeset in place through the row stride `ld`.
//
// What it computes, per entry and slot i:
//   - the strict lexicographic (lt, node) max over the valid rows
//     r = 0..R-1, the LOWEST row keeping exact ties;
//   - that winner against the local slot, strictly: an empty slot is
//     the NEG sentinel and the local record wins exact ties;
//   - lt/node/val/tomb of the result, occupied |= win, and win;
//   - basemax, the max lt over every valid entry (int64 atomicMax), and
//     any_dup, whether a valid entry carries the local node with an lt
//     above the pre-merge canonical (64-bit atomicOr) — the closed-form
//     superset guard flags of `pallas_fanin_batch`;
//   - seen, the number of valid entries (64-bit atomicAdd): the model
//     layer's `records_seen`, counted from the valid bytes the row loop
//     loads anyway, so no pass of its own reads the [R, N] lane again.
// The winners' modified stamp needs the final canonical, which needs
// this kernel's basemax, so the wrapper stamps mod_lt/mod_node after.
//
// Bound on the H100: bytes. The merge must read lt, node and valid of
// every entry (13 B), but val and tomb only of the entry that wins its
// slot; at R = 128 the store lanes are under 2% of the traffic. The
// measured copy rate of this layout (probe P2, one thread per slot) is
// the ceiling the kernel is read against.
// Design: one thread per slot walks its column down the rows, so a warp
// reads neighbouring slots of each row (coalesced) and the running best
// stays in registers. The row loop is a pure streaming reduction over
// lt/node/valid: the loads of kBatch = 4 rows are issued together, ahead
// of their compares, and the running best keeps its row index instead
// of its payload. The winner's val/tomb are gathered once after the
// loop (one 8-B and one 1-B load per winning slot). Nothing crosses
// thread blocks but the three scalars per entry, reduced per block (warp
// shuffles, then one atomic each). blockIdx.y picks the table entry;
// the table is a __grid_constant__ parameter.
// Of the design steps timed on the H100 (PERF.md) — 4, 8 and 16
// rows a batch, and two adjacent slots a thread with 16-B lt loads —
// 4 rows a batch with one slot a thread came out fastest.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr long long kNeg = -(1LL << 62);      // ops/dense.py:55 _NEG
constexpr int kI32Neg = -2147483647 - 1;      // ops/dense.py:56 _I32_NEG
constexpr int kBlock = 256;
constexpr int kBatch = 4;                     // rows loaded together
constexpr int kWarps = kBlock / 32;
constexpr int kMaxEntries = 16;               // ops/fanin_kernel.py
constexpr int kLanes = 19;

struct Entry {
  const long long* st_lt; const int* st_node; const long long* st_val;
  const uint8_t* st_tomb; const uint8_t* st_occ;
  const long long* cs_lt; const int* cs_node; const long long* cs_val;
  const uint8_t* cs_tomb; const uint8_t* cs_valid;
  long long* o_lt; int* o_node; long long* o_val; uint8_t* o_tomb;
  uint8_t* o_occ; uint8_t* o_win;
  long long* basemax; unsigned long long* any_dup;
  unsigned long long* seen;
  long long n, r, ld;
};

struct Table {
  Entry e[kMaxEntries];
};

__device__ __forceinline__ long long warp_max(long long v) {
  for (int off = 16; off > 0; off >>= 1) {
    long long o = __shfl_down_sync(0xffffffffu, v, off);
    v = o > v ? o : v;
  }
  return v;
}

__device__ __forceinline__ unsigned long long warp_sum(
    unsigned long long v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kBlock) fanin_batch_kernel(
    const __grid_constant__ Table t, const long long* __restrict__ canonical,
    int local_node) {
  const Entry& e = t.e[blockIdx.y];
  const long long first = (long long)blockIdx.x * kBlock;
  if (first >= e.n) return;   // the whole thread block: no barrier skipped
  const long long i = first + threadIdx.x;
  long long bmax = kNeg;
  int dup = 0;
  unsigned count = 0;
  if (i < e.n) {
    const long long canon = *canonical;
    long long b_lt = kNeg;
    int b_node = kI32Neg, b_row = -1;
    for (long long row0 = 0; row0 < e.r; row0 += kBatch) {
      long long lt[kBatch];
      int node[kBatch];
      uint8_t valid[kBatch];
      // Every load of the batch first; none waits on a compare.
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const long long k = (row0 + j) * e.ld + i;
        if (row0 + j < e.r) {
          lt[j] = e.cs_lt[k];
          node[j] = e.cs_node[k];
          valid[j] = e.cs_valid[k];
        } else {
          valid[j] = 0;
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        count += valid[j] != 0;
        if (!valid[j]) continue;
        const long long x = lt[j];
        const int nd = node[j];
        bmax = x > bmax ? x : bmax;
        dup |= (nd == local_node) & (x > canon);
        // Strict compare: an equal (lt, node) from a later row loses.
        if (x > b_lt || (x == b_lt && nd > b_node)) {
          b_lt = x;
          b_node = nd;
          b_row = (int)(row0 + j);
        }
      }
    }
    const bool occ = e.st_occ[i] != 0;
    const long long lt0 = e.st_lt[i];
    const int node0 = e.st_node[i];
    const long long s_lt = occ ? lt0 : kNeg;
    const bool win = b_lt > s_lt || (b_lt == s_lt && b_node > node0);
    long long val = 0;
    uint8_t tomb = 0;
    if (!win) {
      val = e.st_val[i];
      tomb = e.st_tomb[i];
    } else if (b_row >= 0) {   // the payload of the winning row only
      const long long k = b_row * e.ld + i;
      val = e.cs_val[k];
      tomb = e.cs_tomb[k];
    }
    e.o_lt[i] = win ? b_lt : lt0;
    e.o_node[i] = win ? b_node : node0;
    e.o_val[i] = val;
    e.o_tomb[i] = tomb;
    e.o_occ[i] = (occ || win) ? 1 : 0;
    e.o_win[i] = win ? 1 : 0;
  }
  // Block reduction of the three scalars; every thread of the block
  // gets here, as the barrier requires.
  __shared__ long long warp_best[kWarps];
  __shared__ unsigned long long warp_count[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  bmax = warp_max(bmax);
  const unsigned long long wcount = warp_sum(count);
  if (lane == 0) {
    warp_best[warp] = bmax;
    warp_count[warp] = wcount;
  }
  const int block_dup = __syncthreads_or(dup);
  if (warp == 0) {
    long long v = lane < kWarps ? warp_best[lane] : kNeg;
    unsigned long long c = lane < kWarps ? warp_count[lane] : 0ull;
    v = warp_max(v);
    c = warp_sum(c);
    if (lane == 0) {
      if (v > kNeg) atomicMax(e.basemax, v);
      if (block_dup) atomicOr(e.any_dup, 1ull);
      if (c) atomicAdd(e.seen, c);
    }
  }
}

}  // namespace

// Launches one kernel over `n_entries` (1..16) merges on `stream`;
// returns a CUDA error code (0 on success). `lanes` holds 19 device
// pointers per entry, in order: the store's lt, node, val, tomb,
// occupied; the changeset's lt, node, val, tomb, valid; the outputs lt,
// node, val, tomb, occupied, win; the entry's basemax (int64, set to
// NEG by the caller), any_dup and seen (int64 each, zeroed by the
// caller). `dims` holds n, r and ld per entry: ld is the changeset
// lanes' row stride in entries, n for whole lanes, the full width for a
// key shard's column block taken in place (K1p). `canonical` is a
// device int64 scalar, so a pipelined merge never brings the clock back
// to the host.
extern "C" int crdt_fanin_batch(const void* const* lanes,
                                const long long* dims, int n_entries,
                                const void* canonical, int local_node,
                                void* stream) {
  if (n_entries < 1 || n_entries > kMaxEntries)
    return (int)cudaErrorInvalidValue;
  Table t = {};
  long long max_n = 0;
  for (int j = 0; j < n_entries; ++j) {
    const void* const* q = lanes + (long long)j * kLanes;
    Entry& e = t.e[j];
    e.st_lt = (const long long*)q[0]; e.st_node = (const int*)q[1];
    e.st_val = (const long long*)q[2]; e.st_tomb = (const uint8_t*)q[3];
    e.st_occ = (const uint8_t*)q[4];
    e.cs_lt = (const long long*)q[5]; e.cs_node = (const int*)q[6];
    e.cs_val = (const long long*)q[7]; e.cs_tomb = (const uint8_t*)q[8];
    e.cs_valid = (const uint8_t*)q[9];
    e.o_lt = (long long*)q[10]; e.o_node = (int*)q[11];
    e.o_val = (long long*)q[12]; e.o_tomb = (uint8_t*)q[13];
    e.o_occ = (uint8_t*)q[14]; e.o_win = (uint8_t*)q[15];
    e.basemax = (long long*)q[16];
    e.any_dup = (unsigned long long*)q[17];
    e.seen = (unsigned long long*)q[18];
    e.n = dims[3 * j];
    e.r = dims[3 * j + 1];
    e.ld = dims[3 * j + 2];
    max_n = e.n > max_n ? e.n : max_n;
  }
  if (max_n <= 0) return 0;
  const dim3 grid((unsigned)((max_n + kBlock - 1) / kBlock),
                  (unsigned)n_entries);
  fanin_batch_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      t, (const long long*)canonical, local_node);
  return (int)cudaGetLastError();
}
