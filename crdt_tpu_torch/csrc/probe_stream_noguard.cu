// Kernel probe P1c: the stream replay's join with every guard removed,
// on split wire lanes, computed in closed form over the chunks — the
// guardless twin of the stream replay (csrc/fanin_stream.cu), which
// runs the same closed form with its guards and basemax: the difference
// of their times is what the guards cost.
//
// Replaces: benchmarks/probe_kernel.py:107 `_stream_noguard_kernel`
// (variant "stream-noguard", launched through `_stream_call` at :169).
//
// What it computes, per slot i, for chunk c = 0 .. n_chunks-1 in order:
//   - every entry's key is advanced by off = c << 16 in lo, unless its
//     hi is NEG_HI (a sentinel stays put), with the carry into hi:
//     lo = lo0 + off, hi = hi0 + (lo < lo0), both wrapping;
//   - the rows fold as in P1a (csrc/probe_join.cu) into the running
//     best, which starts as the split store slot and carries over from
//     chunk to chunk;
//   - win is the OR over chunks; the mod lanes are win_of_the_last_chunk
//     ? (newc_hi, newc_lo, local_node) : the store's.
//
// The closed form. An entry whose hi0 is not NEG_HI "moves": its 64-bit
// key hi:lo rises by off_c in chunk c. An entry whose hi0 is NEG_HI is
// static. Unless a moving key wraps (hi0 == INT32_MAX and lo0 carries,
// so hi becomes INT32_MIN), the moving entries keep their order and rise
// every chunk, so of all visits only three can hold the final best: the
// store slot b0, S (the static entries' strict lex max, the lowest row
// keeping ties, reached in chunk 0) and M (the moving entries' max at
// chunk 0, advanced by off_last = (n_chunks - 1) << 16, reached in the
// last chunk). The best is their max, an exact (hi, lo, node) tie going
// to the earlier visit: b0, then S, then M. win is "the best is an
// entry", since the store is never visited again once beaten. The last
// chunk won iff M > max(b0, S): static entries cannot win after chunk 0,
// and M beats every earlier moving visit. With one chunk the function
// is P1a's join: every entry counts with M (off_last = 0, S empty). A
// column holding a moving entry that wraps walks its chunks, the
// function's own definition; a random key reaches it with a chance of
// about 2^-32 per entry.
//
// Bound on the H100: bytes, 0.0581 ms at the probe CLI's shape (2^20 x 8
// rows, 128 chunks; chip_smoke.py counts it): the function reads
// hi/lo/node of every entry (10 B), the payload of the winning entry
// only, the store and writes the ten outputs once; the TPU body
// compares every entry once per chunk, 128 times the compares the
// closed form needs. Design, as csrc/fanin_batch.cu: one thread per
// slot makes one pass over its column, the loads of 4 rows issued
// together ahead of their compares, keeping S and M with their rows;
// after the pass it gathers the winner's val_hi/val_lo/tomb once and
// writes the ten outputs once. No atomics, no shared memory, no second
// kernel (newc is a scalar input: there is no basemax to reduce).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kBatch = 4;
constexpr int kNegHi = (int)((-(1LL << 62)) >> 32);   // ops/split.py NEG_HI
constexpr int kShift = 16;                             // hlc.py SHIFT

// The 64-bit key hi:lo (hi signed, lo unsigned); its order is the lex
// order of (hi, lo).
__device__ __forceinline__ long long key64(int hi, unsigned lo) {
  return (long long)(((unsigned long long)(unsigned)hi << 32) | lo);
}

__device__ __forceinline__ bool key_gt(long long a, int a_node, long long b,
                                       int b_node) {
  return a > b || (a == b && a_node > b_node);
}

__device__ __forceinline__ bool lex_gt(int a_hi, unsigned a_lo, int a_node,
                                       int b_hi, unsigned b_lo,
                                       int b_node) {
  return a_hi > b_hi ||
         (a_hi == b_hi && (a_lo > b_lo || (a_lo == b_lo && a_node > b_node)));
}

struct Walk {
  int hi;
  unsigned lo;
  int node, row;
  bool any, won;
};

// The chunk loop itself, for a column whose moving key wraps.
__device__ __noinline__ Walk walk_chunks(const int* __restrict__ cs_hi,
                                         const unsigned* __restrict__ cs_lo,
                                         const short* __restrict__ cs_node,
                                         long long n, long long i, int r,
                                         int hi, unsigned lo, int node,
                                         int n_chunks) {
  Walk w{hi, lo, node, -1, false, false};
  for (int c = 0; c < n_chunks; ++c) {
    const unsigned off = (unsigned)c << kShift;
    w.won = false;
    for (int row = 0; row < r; ++row) {
      const long long k = (long long)row * n + i;
      const int hi0 = cs_hi[k];
      const unsigned lo0 = cs_lo[k];
      const unsigned l = lo0 + (hi0 == kNegHi ? 0u : off);
      const int h = (int)((unsigned)hi0 + (l < lo0 ? 1u : 0u));
      const int nd = cs_node[k];
      if (lex_gt(h, l, nd, w.hi, w.lo, w.node)) {
        w.hi = h;
        w.lo = l;
        w.node = nd;
        w.row = row;
        w.won = true;
      }
    }
    w.any |= w.won;
  }
  return w;
}

__global__ void __launch_bounds__(kBlock) probe_stream_noguard_kernel(
    const int* __restrict__ st_hi, const unsigned* __restrict__ st_lo,
    const int* __restrict__ st_node, const int* __restrict__ st_vhi,
    const unsigned* __restrict__ st_vlo, const int* __restrict__ st_tomb,
    const int* __restrict__ st_mhi, const unsigned* __restrict__ st_mlo,
    const int* __restrict__ st_mnode, const int* __restrict__ cs_hi,
    const unsigned* __restrict__ cs_lo, const short* __restrict__ cs_node,
    const int* __restrict__ cs_vhi, const unsigned* __restrict__ cs_vlo,
    const int8_t* __restrict__ cs_tomb, int* __restrict__ o_hi,
    unsigned* __restrict__ o_lo, int* __restrict__ o_node,
    int* __restrict__ o_vhi, unsigned* __restrict__ o_vlo,
    int* __restrict__ o_tomb, int* __restrict__ o_mhi,
    unsigned* __restrict__ o_mlo, int* __restrict__ o_mnode,
    int* __restrict__ o_win, long long n, int r, int local_node,
    int newc_hi, unsigned newc_lo, int n_chunks) {
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  const bool multi = n_chunks > 1;
  const unsigned off_last = (unsigned)(n_chunks - 1) << kShift;
  // S and M0 start below every key: any entry's node (int16) beats
  // INT_MIN on an equal key.
  long long s_key = LLONG_MIN, m_key = LLONG_MIN;
  int s_node = INT_MIN, m_node = INT_MIN, s_row = -1, m_row = -1;
  bool wrap = false;
  for (int row0 = 0; row0 < r; row0 += kBatch) {
    int hi[kBatch], node[kBatch];
    unsigned lo[kBatch];
    // Every load of the batch first; none waits on a compare.
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (row0 + j < r) {
        const long long k = (long long)(row0 + j) * n + i;
        hi[j] = cs_hi[k];
        lo[j] = cs_lo[k];
        node[j] = cs_node[k];
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (row0 + j >= r) continue;
      const long long x = key64(hi[j], lo[j]);
      const bool moving = !multi || hi[j] != kNegHi;
      wrap |= moving && hi[j] == INT_MAX && lo[j] > 0xFFFFFFFFu - off_last;
      if (moving) {
        if (key_gt(x, node[j], m_key, m_node)) {
          m_key = x;
          m_node = node[j];
          m_row = row0 + j;
        }
      } else if (key_gt(x, node[j], s_key, s_node)) {
        s_key = x;
        s_node = node[j];
        s_row = row0 + j;
      }
    }
  }
  const int hi0 = st_hi[i];
  const unsigned lo0 = st_lo[i];
  int b_node = st_node[i];
  long long b_key = key64(hi0, lo0);
  int b_row = -1;
  bool won;
  if (wrap) {
    const Walk w = walk_chunks(cs_hi, cs_lo, cs_node, n, i, r, hi0, lo0,
                               b_node, n_chunks);
    b_key = key64(w.hi, w.lo);
    b_node = w.node;
    b_row = w.row;
    won = w.won;
  } else {
    if (s_row >= 0 && key_gt(s_key, s_node, b_key, b_node)) {
      b_key = s_key;
      b_node = s_node;
      b_row = s_row;
    }
    m_key += off_last;
    won = m_row >= 0 && key_gt(m_key, m_node, b_key, b_node);
    if (won) {
      b_key = m_key;
      b_node = m_node;
      b_row = m_row;
    }
  }
  const bool win = b_row >= 0;
  if (win) {   // the payload of the winning entry only
    const long long k = (long long)b_row * n + i;
    o_vhi[i] = cs_vhi[k];
    o_vlo[i] = cs_vlo[k];
    o_tomb[i] = cs_tomb[k];
  } else {
    o_vhi[i] = st_vhi[i];
    o_vlo[i] = st_vlo[i];
    o_tomb[i] = st_tomb[i];
  }
  o_hi[i] = (int)(b_key >> 32);
  o_lo[i] = (unsigned)b_key;
  o_node[i] = b_node;
  o_mhi[i] = won ? newc_hi : st_mhi[i];
  o_mlo[i] = won ? newc_lo : st_mlo[i];
  o_mnode[i] = won ? local_node : st_mnode[i];
  o_win[i] = win;
}

}  // namespace

// Launches on `stream`; returns a CUDA error code (0 on success).
// `lanes` holds 25 device pointers in the order of crdt_probe_join;
// 1 <= n_chunks < 32768.
extern "C" int crdt_probe_stream_noguard(const void* const* p, long long n,
                                         int r, int local_node, int newc_hi,
                                         int newc_lo, int n_chunks,
                                         void* stream) {
  if (n <= 0) return 0;
  if (r < 1 || n_chunks < 1 || n_chunks >= 32768)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kBlock - 1) / kBlock;
  probe_stream_noguard_kernel<<<(unsigned)blocks, kBlock, 0,
                                (cudaStream_t)stream>>>(
      (const int*)p[0], (const unsigned*)p[1], (const int*)p[2],
      (const int*)p[3], (const unsigned*)p[4], (const int*)p[5],
      (const int*)p[6], (const unsigned*)p[7], (const int*)p[8],
      (const int*)p[9], (const unsigned*)p[10], (const short*)p[11],
      (const int*)p[12], (const unsigned*)p[13], (const int8_t*)p[14],
      (int*)p[15], (unsigned*)p[16], (int*)p[17], (int*)p[18],
      (unsigned*)p[19], (int*)p[20], (int*)p[21], (unsigned*)p[22],
      (int*)p[23], (int*)p[24], n, r, local_node, newc_hi,
      (unsigned)newc_lo, n_chunks);
  return (int)cudaGetLastError();
}
