// Fan-in lattice join of an [R, N] changeset into an N-slot store: one
// logical merge, the batch mode of the dense replication loop.
//
// Replaces: crdt_tpu/ops/pallas_merge.py:206 `_fanin_stream_kernel` in
// batch mode (advance_clock=False, no in-kernel guards), launched at
// pallas_merge.py:739 by `pallas_fanin_batch`; and, per key shard, the
// same body inside the sharded step (K1p, crdt_tpu/parallel/fanin.py:263
// `_pallas_fanin_block`), which reads a shard's column block of the
// changeset in place through the row stride `ld`.
//
// What it computes, per slot i:
//   - the strict lexicographic (lt, node) max over the valid rows
//     r = 0..R-1, the LOWEST row keeping exact ties;
//   - that winner against the local slot, strictly: an empty slot is
//     the NEG sentinel and the local record wins exact ties;
//   - lt/node/val/tomb of the result, occupied |= win, and win;
//   - basemax, the max lt over every valid entry (int64 atomicMax), and
//     any_dup, whether a valid entry carries the local node with an lt
//     above the pre-merge canonical (int32 atomicOr) — the closed-form
//     superset guard flags of `pallas_fanin_batch`.
// The winners' modified stamp needs the final canonical, which needs
// this kernel's basemax, so the wrapper stamps mod_lt/mod_node after.
//
// Bound on the H100: bytes. The merge must read lt, node and valid of
// every entry (13 B), but val and tomb only of the entry that wins its
// slot; on random rows that is a small share of the changeset's 22 B
// per entry. At R = 128 the store lanes are under 2% of the traffic.
// Design: one thread per slot walks its column down the rows, so for
// every row a warp reads 32 neighbouring slots (coalesced) and the
// running best stays in registers. The lt/node/valid loads of a row
// do not depend on the previous row's compare, and the row loop is
// unrolled, so several rows' loads are in flight per thread; val and
// tomb are loaded only when an entry becomes the running best (a later
// row does so with odds of about 1/row), so most of their sectors are
// never fetched. Nothing is carried between blocks except the two
// scalars, reduced per block (warp shuffles, then one atomic per
// block). TMA or cp.async staging and wider loads are left for later.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr long long kNeg = -(1LL << 62);      // ops/dense.py:55 _NEG
constexpr int kI32Neg = -2147483647 - 1;      // ops/dense.py:56 _I32_NEG
constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;

__device__ __forceinline__ long long warp_max(long long v) {
  for (int off = 16; off > 0; off >>= 1) {
    long long o = __shfl_down_sync(0xffffffffu, v, off);
    v = o > v ? o : v;
  }
  return v;
}

__global__ void __launch_bounds__(kBlock) fanin_batch_kernel(
    const long long* __restrict__ st_lt, const int* __restrict__ st_node,
    const long long* __restrict__ st_val,
    const uint8_t* __restrict__ st_tomb, const uint8_t* __restrict__ st_occ,
    const long long* __restrict__ cs_lt, const int* __restrict__ cs_node,
    const long long* __restrict__ cs_val,
    const uint8_t* __restrict__ cs_tomb,
    const uint8_t* __restrict__ cs_valid,
    long long* __restrict__ o_lt, int* __restrict__ o_node,
    long long* __restrict__ o_val, uint8_t* __restrict__ o_tomb,
    uint8_t* __restrict__ o_occ, uint8_t* __restrict__ o_win,
    long long* __restrict__ basemax, int* __restrict__ any_dup,
    const long long* __restrict__ canonical, int local_node,
    long long n, long long r, long long ld) {
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  long long bmax = kNeg;
  int dup = 0;
  if (i < n) {
    const long long canon = *canonical;
    long long b_lt = kNeg;
    int b_node = kI32Neg;
    long long b_val = 0;
    uint8_t b_tomb = 0;
#pragma unroll 4
    for (long long row = 0; row < r; ++row) {
      const long long k = row * ld + i;
      const bool valid = cs_valid[k] != 0;
      const long long lt = cs_lt[k];
      const int node = cs_node[k];
      if (valid) {
        bmax = lt > bmax ? lt : bmax;
        dup |= (node == local_node) & (lt > canon);
        // Strict compare: an equal (lt, node) from a later row loses.
        // The payload is read only for a new running best.
        if (lt > b_lt || (lt == b_lt && node > b_node)) {
          b_lt = lt;
          b_node = node;
          b_val = cs_val[k];
          b_tomb = cs_tomb[k];
        }
      }
    }
    const bool occ = st_occ[i] != 0;
    const long long lt0 = st_lt[i];
    const int node0 = st_node[i];
    const long long s_lt = occ ? lt0 : kNeg;
    const bool win = b_lt > s_lt || (b_lt == s_lt && b_node > node0);
    o_lt[i] = win ? b_lt : lt0;
    o_node[i] = win ? b_node : node0;
    o_val[i] = win ? b_val : st_val[i];
    o_tomb[i] = win ? b_tomb : st_tomb[i];
    o_occ[i] = (occ || win) ? 1 : 0;
    o_win[i] = win ? 1 : 0;
  }
  // Block reduction of the two scalars; every thread of the block gets
  // here (no early return above), as the barrier requires.
  __shared__ long long warp_best[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  bmax = warp_max(bmax);
  if (lane == 0) warp_best[warp] = bmax;
  const int block_dup = __syncthreads_or(dup);
  if (warp == 0) {
    long long v = lane < kWarps ? warp_best[lane] : kNeg;
    v = warp_max(v);
    if (lane == 0) {
      if (v > kNeg) atomicMax(basemax, v);
      if (block_dup) atomicOr(any_dup, 1);
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success). The
// caller allocates every output and initializes *basemax to kNeg and
// *any_dup to 0. `canonical` is a device scalar, so a pipelined merge
// never has to bring the clock back to the host. `ld` is the changeset
// lanes' row stride in entries: n for whole lanes, the full width for a
// key shard's column block taken in place (the sharded step, K1p).
extern "C" int crdt_fanin_batch(
    const void* st_lt, const void* st_node, const void* st_val,
    const void* st_tomb, const void* st_occ,
    const void* cs_lt, const void* cs_node, const void* cs_val,
    const void* cs_tomb, const void* cs_valid,
    void* o_lt, void* o_node, void* o_val, void* o_tomb, void* o_occ,
    void* o_win, void* basemax, void* any_dup, const void* canonical,
    int local_node, long long n, long long r, long long ld, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kBlock - 1) / kBlock;
  fanin_batch_kernel<<<(unsigned)blocks, kBlock, 0,
                       (cudaStream_t)stream>>>(
      (const long long*)st_lt, (const int*)st_node,
      (const long long*)st_val, (const uint8_t*)st_tomb,
      (const uint8_t*)st_occ, (const long long*)cs_lt,
      (const int*)cs_node, (const long long*)cs_val,
      (const uint8_t*)cs_tomb, (const uint8_t*)cs_valid,
      (long long*)o_lt, (int*)o_node, (long long*)o_val,
      (uint8_t*)o_tomb, (uint8_t*)o_occ, (uint8_t*)o_win,
      (long long*)basemax, (int*)any_dup, (const long long*)canonical,
      local_node, n, r, ld);
  return (int)cudaGetLastError();
}
