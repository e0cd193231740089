// The multiplicity count of the log-derivative lookup on the card: `m_count`.
//
// m_i = the number of rows of l equal to row i of t, where i is the first
// row of t holding that value; every later duplicate in t gets 0, and a row
// of l that is in no row of t counts nowhere.  l and t are (n, 8) canonical
// words (the port's int64-held 32-bit words; equality of Montgomery words is
// equality of values).  It has no Pallas counterpart: the JAX package runs
// it as a jitted sort and binary search (`sirius_tpu/plonk/lookup.py:54-88`,
// `_device_m_count`), equal to its host hashmap (`:199-211`).
//
// Design: a hash table in global memory, in two launches.
// - lookup_insert: one thread a row of t hashes its 8 words into an
//   open-addressing table of `cap` int32 slots (a power of two, at least
//   2 n, so at most half full; linear probing).  A thread claims an empty
//   slot with atomicCAS of its row index; where the slot holds a row with
//   the same words it keeps the smaller index with atomicMin.  Every row of
//   one value walks the same slots and stops at the first that is empty or
//   holds its value, so all of them meet in one slot, which ends holding the
//   first occurrence.
// - lookup_probe: one thread a row of l finds its value's slot (or an empty
//   slot: a miss) and atomicAdds 1 into the count of the slot's row.
// The probe must see every insert finished, so the two are separate launches
// on one stream.
//
// What bounds it: bytes.  Each row of l and t is read once (32 canonical
// bytes a row; 64 at the int64 words), the table (4 cap bytes, in L2 at the
// path's sizes: 1 MiB at n = 2^17) and the counts written once; a probe
// rereads the t rows it compares against.  A simple kernel: no shared
// memory staging and no warp-cooperative probing.

#include <stdint.h>

constexpr int LOOKUP_EMPTY = -1;

__device__ __forceinline__ uint32_t lookup_hash(const long long* row) {
  uint64_t h = 0x9E3779B97F4A7C15ull;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    h = (h ^ (uint64_t)(uint32_t)row[k]) * 0xFF51AFD7ED558CCDull;
    h ^= h >> 29;
  }
  return (uint32_t)(h ^ (h >> 32));
}

__device__ __forceinline__ bool lookup_rows_equal(const long long* a, const long long* b) {
  bool eq = true;
#pragma unroll
  for (int k = 0; k < 8; ++k) eq &= (uint32_t)a[k] == (uint32_t)b[k];
  return eq;
}

// Inserts row i of t (n rows) into the table of mask + 1 slots.
__device__ __forceinline__ void lookup_insert_row(const long long* t, int* slots, uint32_t mask, int i) {
  const long long* row = t + 8 * (long long)i;
  uint32_t s = lookup_hash(row) & mask;
  while (true) {
    const int cur = atomicCAS(&slots[s], LOOKUP_EMPTY, i);
    if (cur == LOOKUP_EMPTY) return;
    if (lookup_rows_equal(t + 8 * (long long)cur, row)) {
      atomicMin(&slots[s], i);
      return;
    }
    s = (s + 1) & mask;
  }
}

// Counts row j of l into its value's first row of t, if t holds the value.
__device__ __forceinline__ void lookup_probe_row(const long long* l, const long long* t, const int* slots,
                                                 int* counts, uint32_t mask, int j) {
  const long long* row = l + 8 * (long long)j;
  uint32_t s = lookup_hash(row) & mask;
  while (true) {
    const int cur = slots[s];
    if (cur == LOOKUP_EMPTY) return;
    if (lookup_rows_equal(t + 8 * (long long)cur, row)) {
      atomicAdd(&counts[cur], 1);
      return;
    }
    s = (s + 1) & mask;
  }
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

__global__ void lookup_insert_kernel(const long long* t, int* slots, uint32_t mask, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) lookup_insert_row(t, slots, mask, i);
}

__global__ void lookup_probe_kernel(const long long* l, const long long* t, const int* slots, int* counts,
                                    uint32_t mask, int nl) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < nl) lookup_probe_row(l, t, slots, counts, mask, j);
}

// ---- host launchers ----
static bool lookup_shape_ok(long long n, long long cap) {
  return n >= 0 && n < (1LL << 30) && cap >= 2 * n && cap <= (1LL << 31) && (cap & (cap - 1)) == 0;
}

// slots: cap int32 set to LOOKUP_EMPTY by the caller; t: n rows.
extern "C" int sirius_lookup_insert(const void* t, void* slots, long long n, long long cap, void* stream) {
  if (!lookup_shape_ok(n, cap)) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  if (n > 0)
    lookup_insert_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0, (cudaStream_t)stream>>>(
        (const long long*)t, (int*)slots, (uint32_t)(cap - 1), (int)n);
  return (int)cudaGetLastError();
}

// counts: n int32 zeroed by the caller; l: nl rows; slots from the insert of t.
extern "C" int sirius_lookup_probe(const void* l, const void* t, const void* slots, void* counts, long long nl,
                                   long long n, long long cap, void* stream) {
  if (!lookup_shape_ok(n, cap) || nl < 0 || nl >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  if (nl > 0)
    lookup_probe_kernel<<<(unsigned)((nl + threads - 1) / threads), threads, 0, (cudaStream_t)stream>>>(
        (const long long*)l, (const long long*)t, (const int*)slots, (int*)counts, (uint32_t)(cap - 1), (int)nl);
  return (int)cudaGetLastError();
}
#endif
