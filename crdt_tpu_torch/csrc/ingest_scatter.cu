// Write-combiner commit: every staged, deduped row overwrites its slot.
//
// Replaces: crdt_tpu/ops/pallas_scatter.py:90 `_ingest_kernel`, launched
// at pallas_scatter.py:134 by `ingest_scatter_tiles` for every ingest
// flush (`DenseCrdt._commit_scatter`).
//
// What it computes: for row j with slot s = slots[j] < n_slots,
//   lt[s] = row_lt[j], node[s] = me, val[s] = row_val[j],
//   tomb[s] = row_tomb[j], mod_lt[s] = row_lt[j], mod_node[s] = me,
//   occupied[s] = 1.
// Rows with s == n_slots are padding and write nothing; they may sit
// anywhere in the rows (the sharded commit turns out-of-shard rows into
// them). The store lanes are updated in place: a flush moves O(rows)
// bytes, never the O(n_slots) store. Slots must be unique (the
// combiner's last-wins dedup guarantees it); the result is then the
// same, bit for bit, whatever the order of the rows.
//
// What bounds it on the H100. The bytes it must move are each row's
// slot, lt, val and tomb, and in each of the seven store lanes the 32-B
// sectors the flush's slots touch: about 12.6 MB for 65,536 rows into
// 2^20 slots, 0.0038 ms at 3.35 TB/s. A scattered store costs one
// request per 128-B line that the warp's 32 lanes touch, whatever the
// bytes, so rows in staging order cost 32 requests per store
// instruction and lane (224 a warp). Rows in slot order (about 16
// slots apart on the main path) share lines: the 8-B lanes still take
// one line a row, the 4-B lanes two rows a line, the 1-B lanes eight,
// about 136 requests a warp. So the rows arrive in slot order: the
// combiner's dedup sorts by slot anyway (`DenseCrdt._last_wins_order`)
// and the Hopper counterpart of the TPU kernel's regrouping onto the
// 4096-slot tiles the flush touches is that order.
//
// Design. One thread a row, 256 a block: each store instruction covers
// 32 consecutive (slot-ordered) rows. All four row lanes are loaded
// before the slot test, so a thread waits on one round trip to memory,
// not two (the slot, then the payload behind its branch, as the first
// version of this kernel did). No shared memory, no atomics.
//
// Tried on the card and not kept (none beat this form by more than the
// spread between runs): several rows a thread (2, 4 and 8, warp-strided
// so that a store instruction still covers 32 consecutive rows), and
// the stores issued lane by lane over a thread's rows. Not tried, and
// why:
// - 16-byte row loads: a thread would hold two neighbouring rows, so a
//   store instruction would cover every other row and touch twice the
//   lines in the 1-B and 4-B lanes. The row loads are coalesced already.
// - Writing the 1-B lanes (occupied, tomb) a 32-bit word at a time:
//   the coalescer already merges one instruction's byte stores into one
//   request per line, so a word write saves requests only where two rows
//   share a 4-slot word, which at one row per 16 slots is rare, and it
//   needs an atomic OR (occupied) or a compare-and-swap (tomb) where
//   two warps share a word.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock) ingest_scatter_kernel(
    long long* __restrict__ lt, int* __restrict__ node,
    long long* __restrict__ val, long long* __restrict__ mod_lt,
    int* __restrict__ mod_node, uint8_t* __restrict__ occ,
    uint8_t* __restrict__ tomb, const long long* __restrict__ slots,
    const long long* __restrict__ row_lt,
    const long long* __restrict__ row_val,
    const uint8_t* __restrict__ row_tomb, int me, long long n_slots,
    long long rows) {
  const long long j = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (j >= rows) return;
  const long long s = slots[j];
  const long long t = row_lt[j];
  const long long v = row_val[j];
  const uint8_t b = row_tomb[j];
  if (s < 0 || s >= n_slots) return;
  lt[s] = t;
  node[s] = me;
  val[s] = v;
  tomb[s] = b;
  mod_lt[s] = t;
  mod_node[s] = me;
  occ[s] = 1;
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int crdt_ingest_scatter(
    void* lt, void* node, void* val, void* mod_lt, void* mod_node,
    void* occ, void* tomb, const void* slots, const void* row_lt,
    const void* row_val, const void* row_tomb, int me, long long n_slots,
    long long rows, void* stream) {
  if (rows <= 0) return 0;
  const long long blocks = (rows + kBlock - 1) / kBlock;
  ingest_scatter_kernel<<<(unsigned)blocks, kBlock, 0,
                          (cudaStream_t)stream>>>(
      (long long*)lt, (int*)node, (long long*)val, (long long*)mod_lt,
      (int*)mod_node, (uint8_t*)occ, (uint8_t*)tomb,
      (const long long*)slots, (const long long*)row_lt,
      (const long long*)row_val, (const uint8_t*)row_tomb, me, n_slots,
      rows);
  return (int)cudaGetLastError();
}
