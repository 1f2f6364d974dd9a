// Kernel probe P2: a pure copy at the distinct batch's geometry — the
// ceiling of streaming an HBM-resident [R, N] split changeset, read
// against the pre-split merge (csrc/fanin_split.cu).
//
// Replaces: benchmarks/probe_kernel.py:278 `_copy_batch_kernel`
// (variants "copy-batch" and "copy-batch-valref", launched by
// `run_batch_copy` at :375).
//
// What it computes, per slot i, for groups of chunk_rows rows (the TPU
// grid's chunk axis; r a multiple of chunk_rows):
//   - per group, each lane's sum in its own wire type: a_hi, a_lo, a_val
//     (or a_val_hi, a_val_lo) as 32-bit wrapping sums, a_node as an
//     int16 sum that wraps, a_tomb as an int32 sum of the int8 words;
//   - the outputs are the store's words plus every group's sum, a_node
//     sign-extended per group (so the result depends on the grouping,
//     not only on the total);
//   - narrow lanes (one int32 val): per group val_hi += a_val >> 31
//     (arithmetic) and val_lo += a_val's bits;
//   - the mod lanes are copied; win is the last group's a_node,
//     sign-extended.
//
// Bound on the H100: bytes — every entry's words once (19 B wide, 15 B
// narrow), the store's nine words and the ten outputs (76 B per slot);
// a few adds per entry. Design: one thread per slot, the group loop
// inside the thread in place of the TPU grid's sequential chunk axis,
// rows walked with coalesced row-major loads into unsigned registers
// (wrapping), nothing shared between slots.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;

template <bool kNarrow>
__global__ void __launch_bounds__(kBlock) probe_copy_batch_kernel(
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
    int* __restrict__ o_win, long long n, int r, int chunk_rows) {
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  unsigned acc_hi = (unsigned)st_hi[i], acc_lo = st_lo[i];
  unsigned acc_node = (unsigned)st_node[i], acc_vhi = (unsigned)st_vhi[i];
  unsigned acc_vlo = st_vlo[i], acc_tomb = (unsigned)st_tomb[i];
  unsigned a_node = 0u;
  for (int c0 = 0; c0 < r; c0 += chunk_rows) {
    unsigned a_hi = 0u, a_lo = 0u, a_vhi = 0u, a_vlo = 0u, a_tomb = 0u;
    a_node = 0u;
#pragma unroll 16
    for (int row = c0; row < c0 + chunk_rows; ++row) {
      const long long k = (long long)row * n + i;
      a_hi += (unsigned)cs_hi[k];
      a_lo += cs_lo[k];
      a_node += (unsigned)(int)cs_node[k];
      a_tomb += (unsigned)(int)cs_tomb[k];
      a_vhi += (unsigned)cs_vhi[k];
      if (!kNarrow) a_vlo += cs_vlo[k];
    }
    acc_hi += a_hi;
    acc_lo += a_lo;
    acc_node += (unsigned)(int)(short)a_node;
    acc_tomb += a_tomb;
    if (kNarrow) {
      acc_vhi += (unsigned)((int)a_vhi >> 31);
      acc_vlo += a_vhi;
    } else {
      acc_vhi += a_vhi;
      acc_vlo += a_vlo;
    }
  }
  o_hi[i] = (int)acc_hi;
  o_lo[i] = acc_lo;
  o_node[i] = (int)acc_node;
  o_vhi[i] = (int)acc_vhi;
  o_vlo[i] = acc_vlo;
  o_tomb[i] = (int)acc_tomb;
  o_mhi[i] = st_mhi[i];
  o_mlo[i] = st_mlo[i];
  o_mnode[i] = st_mnode[i];
  o_win[i] = (int)(short)a_node;
}

template <bool kNarrow>
int launch(const void* const* p, long long n, int r, int chunk_rows,
           cudaStream_t stream) {
  const long long blocks = (n + kBlock - 1) / kBlock;
  probe_copy_batch_kernel<kNarrow><<<(unsigned)blocks, kBlock, 0, stream>>>(
      (const int*)p[0], (const unsigned*)p[1], (const int*)p[2],
      (const int*)p[3], (const unsigned*)p[4], (const int*)p[5],
      (const int*)p[6], (const unsigned*)p[7], (const int*)p[8],
      (const int*)p[9], (const unsigned*)p[10], (const short*)p[11],
      (const int*)p[12], (const unsigned*)p[13], (const int8_t*)p[14],
      (int*)p[15], (unsigned*)p[16], (int*)p[17], (int*)p[18],
      (unsigned*)p[19], (int*)p[20], (int*)p[21], (unsigned*)p[22],
      (int*)p[23], (int*)p[24], n, r, chunk_rows);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns a CUDA error code (0 on success).
// `lanes` holds 25 device pointers in the order of crdt_probe_join; for
// narrow lanes the changeset's val_hi slot holds the int32 val lane and
// its val_lo slot is unused. r must be a positive multiple of
// chunk_rows.
extern "C" int crdt_probe_copy_batch(const void* const* p, long long n,
                                     int r, int chunk_rows, int narrow,
                                     void* stream) {
  if (n <= 0) return 0;
  if (chunk_rows < 1 || r < chunk_rows || r % chunk_rows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return narrow ? launch<true>(p, n, r, chunk_rows, s)
                : launch<false>(p, n, r, chunk_rows, s);
}
