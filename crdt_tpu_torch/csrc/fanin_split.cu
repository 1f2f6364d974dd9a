// Fan-in lattice join of a PRE-SPLIT [R, N] changeset (the JAX peers'
// dense wire form) into an N-slot wide store: one logical merge.
//
// Replaces: crdt_tpu/ops/pallas_merge.py:206 `_fanin_stream_kernel` in
// batch mode as reached through `_model_fanin_split_jit` (:803) and
// `_pipelined_model_step_split_jit` (:905): the K1 body fed split wire
// lanes, with the in-jit node_map remap and value-width masking.
//
// Inputs are the wire lanes as they arrive: hi int32, lo uint32, node
// int16, then either val_hi int32 + val_lo uint32 (wide) or val int32
// (narrow, sign-extended), and tomb int8. There is no valid lane: an
// invalid entry is the sentinel hi == NEG_HI, node == I16_NEG. Per
// slot i, for every row r in order:
//   - node: I16_NEG stays, anything else becomes
//     node_map[clip(node, 0, map_len - 1)];
//   - kCheckFit (a value_width=32 replica taking wide lanes): an entry
//     whose val_hi is not the sign fill of val_lo is masked on hi, lo
//     and node to the sentinel, and val_overflow is raised if its hi
//     was not NEG_HI;
//   - the key ((hi << 32) | lo, node) is compared strictly with the
//     running best, seeded with the store slot (NEG when unoccupied),
//     so the lowest row keeps row ties and local keeps exact ties;
//   - seen counts hi != NEG_HI, basemax is the max key lt over every
//     entry (floored at NEG), any_dup is node == local && lt > canonical.
// A winning key whose hi is NEG_HI (a malformed sentinel with lo != 0)
// lands as the Pallas kernel lands it: unoccupied, lt 0, its node and
// payload written, win set. The wrapper stamps mod_lt/mod_node after.
//
// Bound on the H100: bytes. The merge must read hi/lo/node of every
// entry (10 B: no valid lane tells it which entries to skip) and the
// payload only of the entry that wins its slot; the store and outputs
// are under 2% of the traffic at R = 128. Design as csrc/fanin_batch.cu:
// one thread per slot walks its column, the key loads of a row do not
// depend on the previous compare, the row loop is unrolled, and only
// the running best's row index is kept, so the payload (val, tomb) is
// loaded once per slot, for the final winner. The map goes in shared
// memory (at most 32,768 int32 entries, 128 KB, under the 227 KB a
// block may use). The four scalars are reduced per block and land with
// one atomic each. The lanes are never widened to int64 in memory: that
// conversion would move about twice the merge's own bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr long long kNeg = -(1LL << 62);      // ops/dense.py _NEG
constexpr int kNegHi = (int)(kNeg >> 32);     // ops/split.py NEG_HI
constexpr int kI16Neg = -32768;               // ops/split.py I16_NEG
constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;

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

// kNarrow: val is one int32 lane (`val_hi` points at it, `val_lo` is
// unused). kCheckFit: wide lanes on a value_width=32 replica.
template <bool kNarrow, bool kCheckFit>
__global__ void __launch_bounds__(kBlock) fanin_split_kernel(
    const long long* __restrict__ st_lt, const int* __restrict__ st_node,
    const long long* __restrict__ st_val,
    const uint8_t* __restrict__ st_tomb, const uint8_t* __restrict__ st_occ,
    const int* __restrict__ cs_hi, const unsigned* __restrict__ cs_lo,
    const short* __restrict__ cs_node, const int* __restrict__ cs_val_hi,
    const unsigned* __restrict__ cs_val_lo,
    const int8_t* __restrict__ cs_tomb,
    const int* __restrict__ node_map, int map_len,
    long long* __restrict__ o_lt, int* __restrict__ o_node,
    long long* __restrict__ o_val, uint8_t* __restrict__ o_tomb,
    uint8_t* __restrict__ o_occ, uint8_t* __restrict__ o_win,
    long long* __restrict__ basemax, int* __restrict__ flags,
    unsigned long long* __restrict__ seen,
    const long long* __restrict__ canonical, int local_node, long long n,
    long long r) {
  extern __shared__ int smap[];
  for (int j = threadIdx.x; j < map_len; j += kBlock) smap[j] = node_map[j];
  __syncthreads();

  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  long long bmax = kNeg;
  unsigned long long count = 0;
  int dup = 0, ovf = 0;
  if (i < n) {
    const long long canon = *canonical;
    const bool occ = st_occ[i] != 0;
    const long long lt0 = st_lt[i];
    const int node0 = st_node[i];
    long long b_lt = occ ? lt0 : kNeg;
    int b_node = node0;
    long long b_row = -1;
#pragma unroll 4
    for (long long row = 0; row < r; ++row) {
      const long long k = row * n + i;
      int hi = cs_hi[k];
      unsigned lo = cs_lo[k];
      const int nd = cs_node[k];
      int node = nd == kI16Neg
                     ? kI16Neg
                     : smap[nd < 0 ? 0 : (nd >= map_len ? map_len - 1 : nd)];
      if (kCheckFit) {
        const bool fits = cs_val_hi[k] == ((int)cs_val_lo[k] >> 31);
        ovf |= (hi != kNegHi) & !fits;
        if (!fits) {
          hi = kNegHi;
          lo = 0u;
          node = kI16Neg;
        }
      }
      const long long lt = (long long)(((unsigned long long)(unsigned)hi
                                        << 32) | lo);
      count += hi != kNegHi;
      bmax = lt > bmax ? lt : bmax;
      dup |= (node == local_node) & (lt > canon);
      // Strict compare: an equal key from a later row loses.
      if (lt > b_lt || (lt == b_lt && node > b_node)) {
        b_lt = lt;
        b_node = node;
        b_row = row;
      }
    }
    const bool win = b_row >= 0;
    long long val = st_val[i];
    uint8_t tomb = st_tomb[i];
    if (win) {
      const long long k = b_row * n + i;
      val = kNarrow ? (long long)cs_val_hi[k]
                    : (long long)(((unsigned long long)(unsigned)cs_val_hi[k]
                                   << 32) | cs_val_lo[k]);
      tomb = cs_tomb[k] != 0;
    }
    const bool real = (int)(b_lt >> 32) != kNegHi;
    o_lt[i] = win ? (real ? b_lt : 0) : lt0;
    o_node[i] = win ? b_node : node0;
    o_val[i] = val;
    o_tomb[i] = tomb;
    o_occ[i] = win ? real : occ;
    o_win[i] = win;
  }
  // Block reduction of the four scalars; every thread gets here.
  __shared__ long long warp_best[kWarps];
  __shared__ unsigned long long warp_count[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  bmax = warp_max(bmax);
  count = warp_sum(count);
  if (lane == 0) {
    warp_best[warp] = bmax;
    warp_count[warp] = count;
  }
  const int block_dup = __syncthreads_or(dup);
  const int block_ovf = __syncthreads_or(ovf);
  if (warp == 0) {
    long long v = lane < kWarps ? warp_best[lane] : kNeg;
    unsigned long long c = lane < kWarps ? warp_count[lane] : 0ull;
    v = warp_max(v);
    c = warp_sum(c);
    if (lane == 0) {
      if (v > kNeg) atomicMax(basemax, v);
      if (c) atomicAdd(seen, c);
      if (block_dup) atomicOr(flags, 1);
      if (block_ovf) atomicOr(flags + 1, 1);
    }
  }
}

template <bool kNarrow, bool kCheckFit>
int launch(const void* const* p, const void* node_map, int map_len,
           const void* canonical, int local_node, long long n, long long r,
           cudaStream_t stream) {
  const size_t smem = (size_t)map_len * sizeof(int);
  auto kernel = fanin_split_kernel<kNarrow, kCheckFit>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (n + kBlock - 1) / kBlock;
  kernel<<<(unsigned)blocks, kBlock, smem, stream>>>(
      (const long long*)p[0], (const int*)p[1], (const long long*)p[2],
      (const uint8_t*)p[3], (const uint8_t*)p[4], (const int*)p[5],
      (const unsigned*)p[6], (const short*)p[7], (const int*)p[8],
      (const unsigned*)p[9], (const int8_t*)p[10], (const int*)node_map,
      map_len, (long long*)p[11], (int*)p[12], (long long*)p[13],
      (uint8_t*)p[14], (uint8_t*)p[15], (uint8_t*)p[16], (long long*)p[17],
      (int*)p[18], (unsigned long long*)p[19], (const long long*)canonical,
      local_node, n, r);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns a CUDA error code (0 on success).
// `lanes` holds 20 device pointers, in order: the store's lt, node, val,
// tomb, occupied; the changeset's hi, lo, node, val_hi (the narrow val
// lane when narrow), val_lo (unused when narrow), tomb; the outputs lt,
// node, val, tomb, occupied, win; basemax (int64, caller sets kNeg),
// flags (two int32: any_dup, val_overflow; caller zeroes) and seen
// (uint64, caller zeroes). `node_map` is int32[map_len], 1 <= map_len <=
// 32768; `canonical` a device int64 scalar.
extern "C" int crdt_fanin_split(const void* const* lanes,
                                const void* node_map, int map_len,
                                const void* canonical, int local_node,
                                long long n, long long r, int narrow,
                                int check_fit, void* stream) {
  if (n <= 0) return 0;
  if (map_len < 1 || map_len > 32768) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (narrow)
    return launch<true, false>(lanes, node_map, map_len, canonical,
                               local_node, n, r, s);
  if (check_fit)
    return launch<false, true>(lanes, node_map, map_len, canonical,
                               local_node, n, r, s);
  return launch<false, false>(lanes, node_map, map_len, canonical,
                              local_node, n, r, s);
}
