// Stream replay of one [R, N] changeset into an N-slot store, n_chunks
// times with the clock advancing 1 ms per chunk: the steady-state write
// stream of bench.py's default mode, computed in closed form over the
// chunks.
//
// Replaces: crdt_tpu/ops/pallas_merge.py:206 `_fanin_stream_kernel` in
// stream mode (advance_clock=True), launched at pallas_merge.py:739 by
// `pallas_fanin_stream` (:572) and `pallas_fanin_step` (:556).
//
// What the chunk walk computes (ops/stream_kernel.py
// `fanin_stream_reference`), per slot i, for chunk c = 0 .. n_chunks-1:
// every valid lt is advanced by off_c = c << 16; the canonical after
// chunk c is nc_c = max(canon0, basemax + off_c), basemax the max valid
// lt (NEG when none); the rows fold strictly into a running best that
// carries over from chunk to chunk and starts as the store slot b0 =
// (lt0 if occupied else NEG, node0): the lowest row keeps row ties, the
// store exact ties; a slot some row wins in chunk c is stamped mod_lt =
// nc_c, mod_node = local; win is the OR over chunks. Exact guards: per
// column a running max seeded with canon0 in chunk 0 and nc_{c-1} after;
// a valid entry above it is on the slow path, a dup if its node is
// local, else a drift if it is past thresh.
//
// The closed form. Chunk c adds the same off_c to every valid lt of a
// column, so the order of its rows never changes. Let (L, Nd) be the
// column's strict lex max over its valid rows and w the first row that
// reaches it, off = (n_chunks - 1) << 16 and nc_last = max(canon0,
// basemax + off).
//   - If chunk c wins, the running best becomes (L + off_c, Nd), which
//     chunk c+1's (L + off_{c+1}, Nd) beats: every later chunk wins too.
//     So some chunk wins iff the last one does: win = (L + off, Nd) >lex
//     b0, and then lt = L + off, node = Nd, val/tomb of row w, mod_lt =
//     nc_last, mod_node = local, occupied = 1. Otherwise the store's
//     lanes are kept as they are, lt0 included.
//   - Exact guards. With P_r the max lt of the column's earlier valid
//     rows, the entry of row r in chunk c is slow iff lt_r > P_r (a
//     prefix record; the same test in every chunk) and lt_r + off_c >
//     seed_c. For c = 0 that is lt_r > canon0; for c >= 1, seed_c =
//     max(canon0, basemax + off_{c-1}), so it is lt_r > basemax - 2^16
//     and lt_r + off_c > canon0, which grows with c: chunk n_chunks-1
//     decides. Drift adds lt_r + off_c > thresh on the same chunk, also
//     growing with c. Every test is monotone in lt_r, so any_dup follows
//     from D, the max lt over the prefix records whose node is local, and
//     any_drift from F, the max over the other prefix records.
//   - Fast guards keep the closed-form superset flags of
//     pallas_merge.py:649-666 on m_loc, the max lt over the valid
//     local-node entries, and basemax.
//
// Bound on the H100: bytes. The function reads valid of every entry,
// lt/node where a sector holds a valid entry and the winner's val/tomb,
// the store once and writes the eight outputs once: ~0.2 GB at 2^20
// slots x 8 rows, whatever n_chunks. Design: one pass, two kernels, one
// host call.
//   1. The pass: one thread per slot walks its column once, any R, the
//      loads of kBatch = 4 rows issued before their compares, as in
//      fanin_batch.cu. It keeps the best (lt, node, row) and the prefix
//      max (which is the best lt: the column max of the valid rows),
//      loads row w's val/tomb once, writes the slot, and reduces basemax
//      and m_loc (fast) or D and F (exact) per block with warp shuffles,
//      then one atomicMax per block each. The scalars are kept biased
//      (x ^ 2^63, unsigned), so a cudaMemsetAsync to zero initializes
//      them to "none".
//   2. The finish: one thread per slot stamps mod_lt = nc_last where
//      win holds (the stamp needs the whole changeset's basemax), and
//      thread 0 writes new_canonical and the two flags.
// There is no loop over the chunks and no per-chunk state.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr long long kNeg = -(1LL << 62);      // ops/dense.py _NEG
constexpr long long kNone = -9223372036854775807LL - 1;
constexpr unsigned long long kBias = 1ULL << 63;
constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr int kBatch = 4;
constexpr int kShift = 16;                    // hlc.py SHIFT

// Scalar accumulators, biased so that unsigned order is signed order and
// 0 is kNone.
enum { kBaseMax = 0, kLocal = 1, kOther = 2, kScalars = 3 };

__device__ __forceinline__ unsigned long long enc(long long x) {
  return (unsigned long long)x ^ kBias;
}
__device__ __forceinline__ long long dec(unsigned long long u) {
  return (long long)(u ^ kBias);
}
__device__ __forceinline__ long long max64(long long a, long long b) {
  return a > b ? a : b;
}

__device__ __forceinline__ long long warp_max(long long v) {
  for (int off = 16; off > 0; off >>= 1)
    v = max64(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

// Max of `v` over the block into acc[slot]; every thread calls it.
template <int kN>
__device__ __forceinline__ void block_max(const long long (&v)[kN],
                                          unsigned long long* acc) {
  __shared__ long long part[kN][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 0; s < kN; ++s) {
    const long long m = warp_max(v[s]);
    if (lane == 0) part[s][warp] = m;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int s = 0; s < kN; ++s) {
      const long long m = warp_max(lane < kWarps ? part[s][lane] : kNone);
      if (lane == 0 && m != kNone) atomicMax(acc + s, enc(m));
    }
  }
}

struct Lanes {
  const long long* st_lt; const int* st_node; const long long* st_val;
  const uint8_t* st_tomb; const long long* st_mod_lt;
  const int* st_mod_node; const uint8_t* st_occ;
  const long long* cs_lt; const int* cs_node; const long long* cs_val;
  const uint8_t* cs_tomb; const uint8_t* cs_valid;
  long long* o_lt; int* o_node; long long* o_val; uint8_t* o_tomb;
  long long* o_mod_lt; int* o_mod_node; uint8_t* o_occ; uint8_t* o_win;
};

template <bool kExact>
__global__ void __launch_bounds__(kBlock) stream_pass_kernel(
    const Lanes p, unsigned long long* __restrict__ acc, int local_node,
    long long off, long long n, int r) {
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  long long top = kNone;                 // the column's max valid lt
  long long loc = kNone, other = kNone;  // D, F (exact) or m_loc (fast)
  if (i < n) {
    int b_node = 0, b_row = -1;
    for (int row0 = 0; row0 < r; row0 += kBatch) {
      bool valid[kBatch];
      long long lt[kBatch];
      int node[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const long long k = (long long)(row0 + j) * n + i;
        valid[j] = row0 + j < r && p.cs_valid[k] != 0;
        lt[j] = row0 + j < r ? p.cs_lt[k] : 0;
        node[j] = row0 + j < r ? p.cs_node[k] : 0;
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (!valid[j]) continue;
        const bool is_local = node[j] == local_node;
        // A new prefix record (exact); the best so far beaten strictly
        // (an equal (lt, node) from a later row loses).
        const bool above = b_row < 0 || lt[j] > top;
        if (kExact && above) {
          if (is_local) loc = max64(loc, lt[j]);
          else other = max64(other, lt[j]);
        }
        if (!kExact && is_local) loc = max64(loc, lt[j]);
        if (above || (lt[j] == top && node[j] > b_node)) {
          top = lt[j];
          b_node = node[j];
          b_row = row0 + j;
        }
      }
    }
    const bool occ = p.st_occ[i] != 0;
    const long long lt0 = p.st_lt[i];
    const int node0 = p.st_node[i];
    const long long s_lt = occ ? lt0 : kNeg;
    const long long last = top + off;
    const bool win = b_row >= 0 &&
                     (last > s_lt || (last == s_lt && b_node > node0));
    if (win) {
      const long long k = (long long)b_row * n + i;
      p.o_lt[i] = last;
      p.o_node[i] = b_node;
      p.o_val[i] = p.cs_val[k];
      p.o_tomb[i] = p.cs_tomb[k];
      p.o_mod_node[i] = local_node;   // mod_lt: stamped by the finish
    } else {
      p.o_lt[i] = lt0;
      p.o_node[i] = node0;
      p.o_val[i] = p.st_val[i];
      p.o_tomb[i] = p.st_tomb[i];
      p.o_mod_lt[i] = p.st_mod_lt[i];
      p.o_mod_node[i] = p.st_mod_node[i];
    }
    p.o_occ[i] = occ || win;
    p.o_win[i] = win;
  }
  // No early return above: every thread reaches the barrier.
  if (kExact) {
    const long long v[3] = {top, loc, other};
    block_max(v, acc);
  } else {
    const long long v[2] = {top, loc};
    block_max(v, acc);
  }
}

__global__ void __launch_bounds__(kBlock) stream_finish_kernel(
    const uint8_t* __restrict__ win, long long* __restrict__ o_mod_lt,
    const unsigned long long* __restrict__ acc,
    const long long* __restrict__ canonical, long long* __restrict__ o_canon,
    uint8_t* __restrict__ o_dup, uint8_t* __restrict__ o_drift, int exact,
    long long thresh, long long off, int n_chunks, long long n) {
  const long long canon0 = *canonical;
  const long long basemax = max64(kNeg, dec(acc[kBaseMax]));
  const long long nc = max64(canon0, basemax + off);
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (i < n && win[i]) o_mod_lt[i] = nc;
  if (i != 0) return;
  bool dup, drift;
  const long long near = basemax - (1LL << kShift);
  if (exact) {
    // Column-local exact flags from the prefix-record maxima D and F.
    const long long d = dec(acc[kLocal]), f = dec(acc[kOther]);
    dup = d != kNone && (d > canon0 || (n_chunks > 1 && d > near &&
                                        d + off > canon0));
    drift = f != kNone &&
            ((f > canon0 && f > thresh) ||
             (n_chunks > 1 && f > near && f + off > canon0 &&
              f + off > thresh));
  } else {
    // The superset flags of pallas_merge.py:649-666.
    const long long m_loc = max64(kNeg, dec(acc[kLocal]));
    dup = m_loc > canon0 ||
          (n_chunks > 1 && m_loc > near && m_loc + off > canon0);
    drift = basemax + off > thresh;
  }
  *o_canon = nc;
  *o_dup = dup;
  *o_drift = drift;
}

}  // namespace

// Launches on `stream`; returns a CUDA error code (0 on success).
// `lanes` holds 20 device pointers, in order: the store's lt, node, val,
// tomb, mod_lt, mod_node, occupied; the changeset's lt, node, val, tomb,
// valid; the outputs lt, node, val, tomb, mod_lt, mod_node, occupied,
// win. `scratch` is three int64 words of device scratch (zeroed here);
// `result` three device pointers: new_canonical (int64), any_dup and
// any_drift (one byte each). `canonical` is a device int64 scalar;
// `thresh` the drift threshold ((wall + MAX_DRIFT) << 16) | 0xFFFF.
extern "C" int crdt_fanin_stream(const void* const* lanes, void* scratch,
                                 void* const* result, const void* canonical,
                                 int local_node, long long thresh,
                                 long long n, int r, int n_chunks,
                                 int exact, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  auto* acc = (unsigned long long*)scratch;
  cudaError_t rc = cudaMemsetAsync(acc, 0, kScalars * sizeof(*acc), s);
  if (rc != cudaSuccess) return (int)rc;
  const long long off = (long long)(n_chunks - 1) << kShift;
  const long long blocks = (n + kBlock - 1) / kBlock;
  if (n > 0) {
    Lanes p;
    const void* const* q = lanes;
    p.st_lt = (const long long*)q[0]; p.st_node = (const int*)q[1];
    p.st_val = (const long long*)q[2]; p.st_tomb = (const uint8_t*)q[3];
    p.st_mod_lt = (const long long*)q[4];
    p.st_mod_node = (const int*)q[5]; p.st_occ = (const uint8_t*)q[6];
    p.cs_lt = (const long long*)q[7]; p.cs_node = (const int*)q[8];
    p.cs_val = (const long long*)q[9]; p.cs_tomb = (const uint8_t*)q[10];
    p.cs_valid = (const uint8_t*)q[11];
    p.o_lt = (long long*)q[12]; p.o_node = (int*)q[13];
    p.o_val = (long long*)q[14]; p.o_tomb = (uint8_t*)q[15];
    p.o_mod_lt = (long long*)q[16]; p.o_mod_node = (int*)q[17];
    p.o_occ = (uint8_t*)q[18]; p.o_win = (uint8_t*)q[19];
    if (exact)
      stream_pass_kernel<true><<<(unsigned)blocks, kBlock, 0, s>>>(
          p, acc, local_node, off, n, r);
    else
      stream_pass_kernel<false><<<(unsigned)blocks, kBlock, 0, s>>>(
          p, acc, local_node, off, n, r);
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return (int)rc;
  }
  stream_finish_kernel<<<(unsigned)(blocks > 0 ? blocks : 1), kBlock, 0,
                         s>>>(
      (const uint8_t*)lanes[19], (long long*)lanes[16], acc,
      (const long long*)canonical, (long long*)result[0],
      (uint8_t*)result[1], (uint8_t*)result[2], exact, thresh, off,
      n_chunks, n);
  return (int)cudaGetLastError();
}
