// Kernel probe P1c: the stream replay's chunk loop with every guard
// removed, on split wire lanes — what the guards cost inside the fused
// chunk loop, read against the stream replay (csrc/fanin_stream.cu).
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
// Bound on the H100: bytes for the function — a chunk shifts every real
// key alike, so one pass over the rows finds each column's winner, and
// the function moves P1a's bytes. This kernel, like the stream replay,
// compares every entry once per chunk (1.07 x 10^9 entry-chunks at the
// bench shape, 2^20 x 8 x 128 chunks) and so runs well above that
// bound; it exists to be read beside the stream replay, which walks the
// same loop with its guards. Design, as csrc/fanin_stream.cu: one
// thread per slot holds its column's hi/lo/node in registers (up to
// kRegRows rows; longer columns are re-read, cached, each chunk), keeps
// the running best and its row across all chunks, loads the winner's
// payload once at the end and writes the slot once. No atomics.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kRegRows = 8;
constexpr int kNegHi = (int)((-(1LL << 62)) >> 32);   // ops/split.py NEG_HI
constexpr int kShift = 16;                             // hlc.py SHIFT

__device__ __forceinline__ bool lex_gt(int a_hi, unsigned a_lo, int a_node,
                                       int b_hi, unsigned b_lo,
                                       int b_node) {
  return a_hi > b_hi ||
         (a_hi == b_hi && (a_lo > b_lo || (a_lo == b_lo && a_node > b_node)));
}

template <int kRows>
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
  int c_hi[kRows > 0 ? kRows : 1];
  unsigned c_lo[kRows > 0 ? kRows : 1];
  int c_node[kRows > 0 ? kRows : 1];
  if (kRows > 0) {
#pragma unroll
    for (int row = 0; row < kRows; ++row) {
      if (row < r) {
        const long long k = (long long)row * n + i;
        c_hi[row] = cs_hi[k];
        c_lo[row] = cs_lo[k];
        c_node[row] = cs_node[k];
      }
    }
  }
  int b_hi = st_hi[i];
  unsigned b_lo = st_lo[i];
  int b_node = st_node[i];
  int b_row = -1;
  bool any = false, won = false;
  for (int c = 0; c < n_chunks; ++c) {
    const unsigned off = (unsigned)c << kShift;
    won = false;
    auto visit = [&](int hi0, unsigned lo0, int node, int row) {
      const unsigned lo = lo0 + (hi0 == kNegHi ? 0u : off);
      const int hi = (int)((unsigned)hi0 + (lo < lo0 ? 1u : 0u));
      if (lex_gt(hi, lo, node, b_hi, b_lo, b_node)) {
        b_hi = hi;
        b_lo = lo;
        b_node = node;
        b_row = row;
        won = true;
      }
    };
    if (kRows > 0) {
#pragma unroll
      for (int row = 0; row < kRows; ++row)
        if (row < r) visit(c_hi[row], c_lo[row], c_node[row], row);
    } else {
      for (int row = 0; row < r; ++row) {
        const long long k = (long long)row * n + i;
        visit(cs_hi[k], cs_lo[k], cs_node[k], row);
      }
    }
    any |= won;
  }
  if (b_row >= 0) {
    const long long k = (long long)b_row * n + i;
    o_vhi[i] = cs_vhi[k];
    o_vlo[i] = cs_vlo[k];
    o_tomb[i] = cs_tomb[k];
  } else {
    o_vhi[i] = st_vhi[i];
    o_vlo[i] = st_vlo[i];
    o_tomb[i] = st_tomb[i];
  }
  o_hi[i] = b_hi;
  o_lo[i] = b_lo;
  o_node[i] = b_node;
  o_mhi[i] = won ? newc_hi : st_mhi[i];
  o_mlo[i] = won ? newc_lo : st_mlo[i];
  o_mnode[i] = won ? local_node : st_mnode[i];
  o_win[i] = any;
}

template <int kRows>
int launch(const void* const* p, long long n, int r, int local_node,
           int newc_hi, int newc_lo, int n_chunks, cudaStream_t stream) {
  const long long blocks = (n + kBlock - 1) / kBlock;
  probe_stream_noguard_kernel<kRows><<<(unsigned)blocks, kBlock, 0,
                                       stream>>>(
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
  cudaStream_t s = (cudaStream_t)stream;
  if (r <= kRegRows)
    return launch<kRegRows>(p, n, r, local_node, newc_hi, newc_lo, n_chunks,
                            s);
  return launch<0>(p, n, r, local_node, newc_hi, newc_lo, n_chunks, s);
}
