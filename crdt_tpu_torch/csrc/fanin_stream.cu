// Stream replay of one [R, N] changeset into an N-slot store, n_chunks
// times with the clock advancing 1 ms per chunk: the steady-state write
// stream of bench.py's default mode.
//
// Replaces: crdt_tpu/ops/pallas_merge.py:206 `_fanin_stream_kernel` in
// stream mode (advance_clock=True), launched at pallas_merge.py:739 by
// `pallas_fanin_stream` (:572) and `pallas_fanin_step` (:556).
//
// What it computes, per slot i, for chunk c = 0 .. n_chunks-1 in order:
//   - every valid entry's lt is advanced by c << 16 (invalid entries
//     take no part);
//   - the canonical after chunk c is nc_c = max(canon0, basemax +
//     (c << 16)), basemax being the max valid lt, reduced before the
//     launch (NEG when there is none);
//   - the rows fold strictly into the running best, which carries over
//     from chunk to chunk and starts as the store slot (NEG when
//     unoccupied): the lowest row keeps row ties, the store exact ties;
//   - a slot that some row wins in chunk c has mod_lt stamped nc_c and
//     mod_node the local node; win is the OR over chunks;
//   - exact guards (kExact): a running max over this column's rows,
//     reset every chunk to the seed (canon0 for c = 0, nc_{c-1} after);
//     an entry above it is on the slow path: dup if its node is local,
//     else drift if its lt is past the drift threshold. The flags are
//     column-local, a superset of the r-major flags of a plain fold.
// The fast guard mode skips that work; the wrapper derives closed-form
// flags instead.
//
// Bound on the H100: bytes. Each entry is read once and the store slot
// written once (~0.2 GB at 2^20 slots x 8 rows). Chunk c shifts every
// valid lt by the same offset, so the row order in a column never
// changes: the function needs one pass over the rows per slot, while
// this kernel compares every valid entry n_chunks times (1.07 x 10^9
// entry-chunks at the bench shape, 128 chunks) and so runs well above
// its bound. Design: one thread per slot loads its
// column's lt/node/valid into registers once (up to kRegRows rows;
// longer columns are re-read from global memory, cached, each chunk),
// keeps the running best and its row index in registers across all
// chunks, loads the winner's val/tomb once at the end and writes the
// slot once. Only the two exact flags cross blocks (one atomicOr each).
// The closed form over the chunks (the column's winner found once, its
// first winning chunk and stamp computed, the monotone slow-path tests
// made once per entry) is left for later.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr long long kNeg = -(1LL << 62);      // ops/dense.py _NEG
constexpr int kBlock = 256;
constexpr int kRegRows = 8;
constexpr int kShift = 16;                    // hlc.py SHIFT

template <int kRows, bool kExact>
__global__ void __launch_bounds__(kBlock) fanin_stream_kernel(
    const long long* __restrict__ st_lt, const int* __restrict__ st_node,
    const long long* __restrict__ st_val,
    const uint8_t* __restrict__ st_tomb,
    const long long* __restrict__ st_mod_lt,
    const int* __restrict__ st_mod_node,
    const uint8_t* __restrict__ st_occ,
    const long long* __restrict__ cs_lt, const int* __restrict__ cs_node,
    const long long* __restrict__ cs_val,
    const uint8_t* __restrict__ cs_tomb,
    const uint8_t* __restrict__ cs_valid,
    long long* __restrict__ o_lt, int* __restrict__ o_node,
    long long* __restrict__ o_val, uint8_t* __restrict__ o_tomb,
    long long* __restrict__ o_mod_lt, int* __restrict__ o_mod_node,
    uint8_t* __restrict__ o_occ, uint8_t* __restrict__ o_win,
    int* __restrict__ flags, const long long* __restrict__ canonical,
    const long long* __restrict__ basemax_p, int local_node,
    long long thresh, long long n, int r, int n_chunks) {
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  int dup = 0, drift = 0;
  if (i < n) {
    const long long canon0 = *canonical;
    const long long basemax = *basemax_p;
    long long c_lt[kRows > 0 ? kRows : 1];
    int c_node[kRows > 0 ? kRows : 1];
    unsigned vmask = 0;
    if (kRows > 0) {
#pragma unroll
      for (int row = 0; row < kRows; ++row) {
        if (row < r) {
          const long long k = (long long)row * n + i;
          c_lt[row] = cs_lt[k];
          c_node[row] = cs_node[k];
          vmask |= (cs_valid[k] != 0 ? 1u : 0u) << row;
        }
      }
    }
    const bool occ = st_occ[i] != 0;
    const long long lt0 = st_lt[i];
    const int node0 = st_node[i];
    long long b_lt = occ ? lt0 : kNeg;
    int b_node = node0;
    int b_row = -1;
    long long stamp = st_mod_lt[i];
    long long seed = canon0;
    for (int c = 0; c < n_chunks; ++c) {
      const long long off = (long long)c << kShift;
      const long long nc = canon0 > basemax + off ? canon0 : basemax + off;
      long long run = seed;
      bool won = false;
      auto visit = [&](long long lt, int node, int row) {
        lt += off;
        if (kExact) {
          const bool slow = lt > run;
          const bool d = slow && node == local_node;
          dup |= d;
          drift |= slow && !d && lt > thresh;
          run = slow ? lt : run;
        }
        // Strict compare: an equal (lt, node) from a later row loses.
        if (lt > b_lt || (lt == b_lt && node > b_node)) {
          b_lt = lt;
          b_node = node;
          b_row = row;
          won = true;
        }
      };
      if (kRows > 0) {
#pragma unroll
        for (int row = 0; row < kRows; ++row)
          if ((vmask >> row) & 1u) visit(c_lt[row], c_node[row], row);
      } else {
        for (int row = 0; row < r; ++row) {
          const long long k = (long long)row * n + i;
          if (cs_valid[k]) visit(cs_lt[k], cs_node[k], row);
        }
      }
      if (won) stamp = nc;
      seed = nc;
    }
    const bool win = b_row >= 0;
    long long val = st_val[i];
    uint8_t tomb = st_tomb[i];
    if (win) {
      const long long k = (long long)b_row * n + i;
      val = cs_val[k];
      tomb = cs_tomb[k];
    }
    o_lt[i] = win ? b_lt : lt0;
    o_node[i] = win ? b_node : node0;
    o_val[i] = val;
    o_tomb[i] = tomb;
    o_mod_lt[i] = stamp;
    o_mod_node[i] = win ? local_node : st_mod_node[i];
    o_occ[i] = occ || win;
    o_win[i] = win;
  }
  if (kExact) {
    // Every thread of the block gets here (no early return above).
    const int block_dup = __syncthreads_or(dup);
    const int block_drift = __syncthreads_or(drift);
    if (threadIdx.x == 0) {
      if (block_dup) atomicOr(flags, 1);
      if (block_drift) atomicOr(flags + 1, 1);
    }
  }
}

template <int kRows, bool kExact>
int launch(const void* const* p, const void* canonical,
           const void* basemax, int local_node, long long thresh,
           long long n, int r, int n_chunks, cudaStream_t stream) {
  const long long blocks = (n + kBlock - 1) / kBlock;
  fanin_stream_kernel<kRows, kExact><<<(unsigned)blocks, kBlock, 0,
                                       stream>>>(
      (const long long*)p[0], (const int*)p[1], (const long long*)p[2],
      (const uint8_t*)p[3], (const long long*)p[4], (const int*)p[5],
      (const uint8_t*)p[6], (const long long*)p[7], (const int*)p[8],
      (const long long*)p[9], (const uint8_t*)p[10], (const uint8_t*)p[11],
      (long long*)p[12], (int*)p[13], (long long*)p[14], (uint8_t*)p[15],
      (long long*)p[16], (int*)p[17], (uint8_t*)p[18], (uint8_t*)p[19],
      (int*)p[20], (const long long*)canonical, (const long long*)basemax,
      local_node, thresh, n, r, n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns a CUDA error code (0 on success).
// `lanes` holds 21 device pointers, in order: the store's lt, node, val,
// tomb, mod_lt, mod_node, occupied; the changeset's lt, node, val, tomb,
// valid; the outputs lt, node, val, tomb, mod_lt, mod_node, occupied,
// win; and flags (two int32: any_dup, any_drift; caller zeroes, written
// only when `exact`). `canonical` and `basemax` are device int64
// scalars; `thresh` is the drift threshold ((wall + MAX_DRIFT) << 16) |
// 0xFFFF.
extern "C" int crdt_fanin_stream(const void* const* lanes,
                                 const void* canonical, const void* basemax,
                                 int local_node, long long thresh,
                                 long long n, int r, int n_chunks,
                                 int exact, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (r <= kRegRows)
    return exact ? launch<kRegRows, true>(lanes, canonical, basemax,
                                          local_node, thresh, n, r,
                                          n_chunks, s)
                 : launch<kRegRows, false>(lanes, canonical, basemax,
                                           local_node, thresh, n, r,
                                           n_chunks, s);
  return exact ? launch<0, true>(lanes, canonical, basemax, local_node,
                                 thresh, n, r, n_chunks, s)
               : launch<0, false>(lanes, canonical, basemax, local_node,
                                  thresh, n, r, n_chunks, s);
}
