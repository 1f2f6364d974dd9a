// Kernel probe P1a: the fan-in join alone, with no guards, no basemax
// and no flags, on split wire lanes.
//
// Replaces: benchmarks/probe_kernel.py:42 `_join_only_kernel` (variant
// "nojoin", launched through `_variant_call` at :196).
//
// What it computes, per slot i: the running best (hi, lo, node, val_hi,
// val_lo, tomb) starts as the split store slot; for every row r in
// order, if the entry's key (hi signed, lo unsigned, node widened from
// int16) is strictly greater than the best's, the entry becomes the
// best, payload and all. It writes the six lanes, the mod lanes as
// win ? (newc_hi, newc_lo, local_node) : the store's, and win (some row
// won) as int32. There is no valid lane: an invalid entry carries the
// sentinel hi == NEG_HI, node == I16_NEG, and takes part as its key
// says.
//
// Bound on the H100: bytes. The join must read hi/lo/node of every
// entry (10 B) and the payload only of the entry that wins its slot;
// the store and the ten outputs are 76 B per slot. Design, as
// csrc/fanin_split.cu: one thread per slot walks its column with
// coalesced row-major loads, the key loads of a row do not depend on
// the previous compare, and only the running best's row is kept, so
// the payload (val_hi, val_lo, tomb) is loaded once, for the final
// winner. No slot depends on another: no atomics, no shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;

__device__ __forceinline__ bool lex_gt(int a_hi, unsigned a_lo, int a_node,
                                       int b_hi, unsigned b_lo,
                                       int b_node) {
  return a_hi > b_hi ||
         (a_hi == b_hi && (a_lo > b_lo || (a_lo == b_lo && a_node > b_node)));
}

__global__ void __launch_bounds__(kBlock) probe_join_kernel(
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
    int newc_hi, unsigned newc_lo) {
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  int b_hi = st_hi[i];
  unsigned b_lo = st_lo[i];
  int b_node = st_node[i];
  int b_row = -1;
#pragma unroll 4
  for (int row = 0; row < r; ++row) {
    const long long k = (long long)row * n + i;
    const int hi = cs_hi[k];
    const unsigned lo = cs_lo[k];
    const int node = cs_node[k];
    if (lex_gt(hi, lo, node, b_hi, b_lo, b_node)) {
      b_hi = hi;
      b_lo = lo;
      b_node = node;
      b_row = row;
    }
  }
  const bool win = b_row >= 0;
  if (win) {
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
  o_mhi[i] = win ? newc_hi : st_mhi[i];
  o_mlo[i] = win ? newc_lo : st_mlo[i];
  o_mnode[i] = win ? local_node : st_mnode[i];
  o_win[i] = win;
}

}  // namespace

// Launches on `stream`; returns a CUDA error code (0 on success).
// `lanes` holds 25 device pointers, in order: the split store's hi, lo,
// node, val_hi, val_lo, tomb, mod_hi, mod_lo, mod_node ([n] each); the
// changeset's hi, lo, node, val_hi, val_lo, tomb ([r, n] row-major);
// the outputs in the store's order, then win.
extern "C" int crdt_probe_join(const void* const* p, long long n, int r,
                               int local_node, int newc_hi, int newc_lo,
                               void* stream) {
  if (n <= 0) return 0;
  if (r < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kBlock - 1) / kBlock;
  probe_join_kernel<<<(unsigned)blocks, kBlock, 0, (cudaStream_t)stream>>>(
      (const int*)p[0], (const unsigned*)p[1], (const int*)p[2],
      (const int*)p[3], (const unsigned*)p[4], (const int*)p[5],
      (const int*)p[6], (const unsigned*)p[7], (const int*)p[8],
      (const int*)p[9], (const unsigned*)p[10], (const short*)p[11],
      (const int*)p[12], (const unsigned*)p[13], (const int8_t*)p[14],
      (int*)p[15], (unsigned*)p[16], (int*)p[17], (int*)p[18],
      (unsigned*)p[19], (int*)p[20], (int*)p[21], (unsigned*)p[22],
      (int*)p[23], (int*)p[24], n, r, local_node, newc_hi,
      (unsigned)newc_lo);
  return (int)cudaGetLastError();
}
