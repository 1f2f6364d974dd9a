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
//
// The launcher sets the scalars before the join, in a one-block kernel
// of its own (a byte-wise memset cannot write NEG), so the caller
// enqueues nothing but the launcher's call.
//
// The fan-in tail (K1t, `fanin_tail_kernel`, launched by
// `crdt_fanin_tail` on the join's stream right after it) is the merge's
// step after one K1 entry, in one launch: the stamp of the winners'
// modified lanes with the final canonical, the count of adopted slots
// (a block reduction, one atomic a block), and in the last block to
// finish (an atomic ticket after a fence) the merge's scalars: the
// drift flag, the recv flags, and, inside a pipelined() window, the
// window's step of ops/fanin_tail.py (`PipeState.absorb`, then the
// send bump of ops/merge.py `send_step`, then the flag ORs), and the
// running seen and adopted counts. It writes every scalar into a fresh
// buffer: nothing K1 or another block of the launch reads is rewritten.

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
constexpr int kShift = 16;                    // hlc.py SHIFT
constexpr long long kMaxCounter = 0xFFFF;     // hlc.py MAX_COUNTER
constexpr long long kMaxDrift = 60000;        // hlc.py MAX_DRIFT

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

__global__ void fanin_scalars_init(const __grid_constant__ Table t,
                                   int n_entries) {
  const int j = threadIdx.x;
  if (j < n_entries) {
    *t.e[j].basemax = kNeg;
    *t.e[j].any_dup = 0;
    *t.e[j].seen = 0;
  }
}

// K1t. The words of `out`, int64 each (ops/fanin_tail.py names them):
// the merge's own, written in every mode, then the window's, written
// inside a pipelined() window; the last two are the launch's scratch,
// zeroed by the launcher.
enum Word {
  kRecv, kAdopted, kNewCanonical, kValOverflow, kSeenSum, kAdoptedSum,
  kCanonical, kAnyBad, kOverflow, kDrift, kValOverflowAll, kFirstFlag,
  kAdoptedAcc, kTicket, kWords
};

struct Tail {
  // Per slot: the pre-merge modified lanes, K1's win lane, the fresh
  // stamped lanes.
  const long long* st_mod_lt; const int* st_mod_node; const uint8_t* win;
  long long* o_mod_lt; int* o_mod_node;
  // The join's scalars: the pre-merge canonical K1 read, its basemax,
  // its any_dup (a bool), its seen; the merge's value-ref overflow (a
  // bool; null where no value was masked).
  const long long* canonical; const long long* basemax;
  const uint8_t* any_dup; const long long* seen;
  const uint8_t* val_overflow;
  // The running counts before this merge (null: 0).
  const long long* seen_sum; const long long* adopted_sum;
  // The window's state before this merge (bools and an int32; null
  // outside a window).
  const uint8_t* any_bad; const uint8_t* overflow; const uint8_t* drift;
  const uint8_t* val_overflow_all; const int* first_flag_idx;
  long long* out;
  long long n, thresh, send_wall, merge_idx;
  int local_node, window;
};

// ops/merge.py `send_step` on one packed clock: the new clock, and its
// overflow and drift flags.
__device__ __forceinline__ long long send_bump(long long lt, long long wall,
                                               bool* overflow, bool* drift) {
  const long long ms = lt >> kShift;
  const bool stay = ms >= wall;
  *overflow = stay && (lt & kMaxCounter) == kMaxCounter;
  *drift = ms - wall > kMaxDrift;
  return *overflow ? lt : (stay ? lt + 1 : (wall << kShift));
}

// The merge's scalars, once every block has counted: `adopted` is the
// whole count, `new_c` the final canonical.
__device__ void tail_scalars(const Tail& a, long long new_c,
                             long long bmax, unsigned long long adopted) {
  long long* o = a.out;
  const bool recv = *a.any_dup != 0 || bmax > a.thresh;
  const bool vo = a.val_overflow != nullptr && *a.val_overflow != 0;
  o[kRecv] = recv;
  o[kAdopted] = (long long)adopted;
  o[kNewCanonical] = new_c;
  o[kValOverflow] = vo;
  o[kSeenSum] = (a.seen_sum ? *a.seen_sum : 0) + *a.seen;
  o[kAdoptedSum] = (a.adopted_sum ? *a.adopted_sum : 0) + (long long)adopted;
  if (!a.window) return;
  // PipeState.absorb: the superset recv flags and, where values were
  // masked, the value-ref overflow, then the first flagged merge.
  int first = *a.first_flag_idx;
  if (first < 0 && (recv || vo)) first = (int)a.merge_idx;
  // PipeState.send_bump, with the merge's second wall read.
  bool overflow, drift;
  const long long c = send_bump(new_c, a.send_wall, &overflow, &drift);
  if (first < 0 && (overflow || drift)) first = (int)a.merge_idx;
  o[kCanonical] = c;
  o[kAnyBad] = *a.any_bad != 0 || recv;
  o[kOverflow] = *a.overflow != 0 || overflow;
  o[kDrift] = *a.drift != 0 || drift;
  o[kValOverflowAll] = *a.val_overflow_all != 0 || vo;
  o[kFirstFlag] = first;
}

// One thread a slot; every block reads the two clock scalars itself.
__global__ void __launch_bounds__(kBlock) fanin_tail_kernel(
    const __grid_constant__ Tail a) {
  const long long canon = *a.canonical;
  const long long bmax = *a.basemax;
  const long long new_c = bmax > canon ? bmax : canon;
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  unsigned long long won = 0;
  if (i < a.n) {
    const bool w = a.win[i] != 0;
    a.o_mod_lt[i] = w ? new_c : a.st_mod_lt[i];
    a.o_mod_node[i] = w ? a.local_node : a.st_mod_node[i];
    won = w;
  }
  __shared__ unsigned long long warp_count[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  won = warp_sum(won);
  if (lane == 0) warp_count[warp] = won;
  __syncthreads();
  if (threadIdx.x != 0) return;
  unsigned long long c = 0;
  for (int w = 0; w < kWarps; ++w) c += warp_count[w];
  unsigned long long* acc = (unsigned long long*)(a.out + kAdoptedAcc);
  if (c) atomicAdd(acc, c);
  // The count lands before the ticket is taken, so the block that takes
  // the last ticket sees every block's count.
  __threadfence();
  const unsigned long long ticket =
      atomicAdd((unsigned long long*)(a.out + kTicket), 1ull);
  if (ticket != gridDim.x - 1) return;
  __threadfence();
  tail_scalars(a, new_c, bmax, atomicAdd(acc, 0ull));
}

}  // namespace

// Launches one kernel over `n_entries` (1..16) merges on `stream`;
// returns a CUDA error code (0 on success). `lanes` holds 19 device
// pointers per entry, in order: the store's lt, node, val, tomb,
// occupied; the changeset's lt, node, val, tomb, valid; the outputs lt,
// node, val, tomb, occupied, win; the entry's basemax, any_dup and seen
// (int64 each; the launcher sets them to NEG, 0 and 0 first, and
// any_dup ends 0 or 1). `dims` holds n, r and ld per entry: ld is the changeset
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
  fanin_scalars_init<<<1, kMaxEntries, 0, (cudaStream_t)stream>>>(
      t, n_entries);
  if (max_n <= 0) return (int)cudaGetLastError();
  const dim3 grid((unsigned)((max_n + kBlock - 1) / kBlock),
                  (unsigned)n_entries);
  fanin_batch_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      t, (const long long*)canonical, local_node);
  return (int)cudaGetLastError();
}

// Launches K1t for one merge on `stream`, after its join; returns a
// CUDA error code (0 on success). `ptrs` holds the 18 pointers of
// `Tail` in its order, st_mod_lt to out; `dims` holds n, thresh (the
// drift threshold of the merge's wall read), send_wall (the window's
// second wall read), merge_idx (the merge's index in its window),
// local_node and window (1 inside a pipelined() window). `out` holds
// kWords int64 words; the launcher zeroes its scratch first.
extern "C" int crdt_fanin_tail(const void* const* ptrs,
                               const long long* dims, void* stream) {
  Tail a = {};
  a.st_mod_lt = (const long long*)ptrs[0];
  a.st_mod_node = (const int*)ptrs[1];
  a.win = (const uint8_t*)ptrs[2];
  a.o_mod_lt = (long long*)ptrs[3];
  a.o_mod_node = (int*)ptrs[4];
  a.canonical = (const long long*)ptrs[5];
  a.basemax = (const long long*)ptrs[6];
  a.any_dup = (const uint8_t*)ptrs[7];
  a.seen = (const long long*)ptrs[8];
  a.val_overflow = (const uint8_t*)ptrs[9];
  a.seen_sum = (const long long*)ptrs[10];
  a.adopted_sum = (const long long*)ptrs[11];
  a.any_bad = (const uint8_t*)ptrs[12];
  a.overflow = (const uint8_t*)ptrs[13];
  a.drift = (const uint8_t*)ptrs[14];
  a.val_overflow_all = (const uint8_t*)ptrs[15];
  a.first_flag_idx = (const int*)ptrs[16];
  a.out = (long long*)ptrs[17];
  a.n = dims[0];
  a.thresh = dims[1];
  a.send_wall = dims[2];
  a.merge_idx = dims[3];
  a.local_node = (int)dims[4];
  a.window = (int)dims[5];
  if (a.n < 0 || !a.out || (a.window && !(a.any_bad && a.overflow &&
                                          a.drift && a.val_overflow_all &&
                                          a.first_flag_idx)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t rc = cudaMemsetAsync(a.out + kAdoptedAcc, 0,
                                         2 * sizeof(long long), s);
  if (rc != cudaSuccess) return (int)rc;
  // One block at least: the last block to finish writes the scalars.
  const long long blocks = a.n > 0 ? (a.n + kBlock - 1) / kBlock : 1;
  fanin_tail_kernel<<<(unsigned)blocks, kBlock, 0, s>>>(a);
  return (int)cudaGetLastError();
}
