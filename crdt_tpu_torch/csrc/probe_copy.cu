// Kernel probe P1b: a pure copy with one add per lane, at the fan-in
// join's layout — what streaming the join's lanes costs with no compare.
//
// Replaces: benchmarks/probe_kernel.py:82 `_copy_kernel` (variant
// "copy", launched through `_variant_call` at :196).
//
// What it computes, per slot i, for an [r, n] split changeset (r >= 1):
//   o_hi = st_hi + sum_r cs_hi[r], o_lo = st_lo + sum_r cs_lo[r]
// as independent 32-bit wrapping sums (no carry from lo into hi);
// o_node, o_val_hi, o_val_lo and o_tomb are the store's plus the LAST
// row's word (node and tomb widened with their sign); the mod lanes are
// copied; win is the last row's node, sign-extended.
//
// Bound on the H100: bytes — hi/lo of every row (8 B per entry), the
// last row's node/val/tomb (11 B per slot), the store's nine words and
// the ten outputs (76 B per slot); a few adds per entry. Design: one
// thread per slot, rows walked with coalesced row-major loads, the sums
// in unsigned registers (wrapping, as the TPU's int32 adds).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock) probe_copy_kernel(
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
    int* __restrict__ o_win, long long n, int r) {
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  unsigned a_hi = 0u, a_lo = 0u;
#pragma unroll 8
  for (int row = 0; row < r; ++row) {
    const long long k = (long long)row * n + i;
    a_hi += (unsigned)cs_hi[k];
    a_lo += cs_lo[k];
  }
  const long long last = (long long)(r - 1) * n + i;
  const int node = cs_node[last];
  o_hi[i] = (int)((unsigned)st_hi[i] + a_hi);
  o_lo[i] = st_lo[i] + a_lo;
  o_node[i] = (int)((unsigned)st_node[i] + (unsigned)node);
  o_vhi[i] = (int)((unsigned)st_vhi[i] + (unsigned)cs_vhi[last]);
  o_vlo[i] = st_vlo[i] + cs_vlo[last];
  o_tomb[i] = (int)((unsigned)st_tomb[i] + (unsigned)(int)cs_tomb[last]);
  o_mhi[i] = st_mhi[i];
  o_mlo[i] = st_mlo[i];
  o_mnode[i] = st_mnode[i];
  o_win[i] = node;
}

}  // namespace

// Launches on `stream`; returns a CUDA error code (0 on success).
// `lanes` holds 25 device pointers in the order of crdt_probe_join.
extern "C" int crdt_probe_copy(const void* const* p, long long n, int r,
                               void* stream) {
  if (n <= 0) return 0;
  if (r < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kBlock - 1) / kBlock;
  probe_copy_kernel<<<(unsigned)blocks, kBlock, 0, (cudaStream_t)stream>>>(
      (const int*)p[0], (const unsigned*)p[1], (const int*)p[2],
      (const int*)p[3], (const unsigned*)p[4], (const int*)p[5],
      (const int*)p[6], (const unsigned*)p[7], (const int*)p[8],
      (const int*)p[9], (const unsigned*)p[10], (const short*)p[11],
      (const int*)p[12], (const unsigned*)p[13], (const int8_t*)p[14],
      (int*)p[15], (unsigned*)p[16], (int*)p[17], (int*)p[18],
      (unsigned*)p[19], (int*)p[20], (int*)p[21], (unsigned*)p[22],
      (int*)p[23], (int*)p[24], n, r);
  return (int)cudaGetLastError();
}
