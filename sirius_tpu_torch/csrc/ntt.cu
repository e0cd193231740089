// B4: the column NTT of the four-step (Bailey) transform.
//
// Replaces the TPU kernel `sirius_tpu/ops/pallas_ntt.py:col_ntt_pallas`
// (body `_ladder_body`): for every column r of a (size, R) block of field
// elements, the bit-reversal permutation along the size axis, then every
// radix-2 stage (stage m = 1 without a multiply, its twiddle is w^0 = 1).
// The four-step transform runs it twice (size n1 over R = n2 columns, then
// size n2 over R = n1); the flat transform of a small domain is one column
// (R = 1).  The inverse needs no last-stage scaling: 1/n rides on the
// four-step mid twiddle, or on one multiply after the flat transform.
//
// The TPU kernel keeps a block of columns resident in VMEM for all
// log2(size) stages so that no stage goes back to HBM.  On the H100 the
// column lives in shared memory instead: one thread block per column loads
// its size elements once (through the bit-reversed index) and the size/2
// twiddles of the (size/2, 8) table, runs every stage with a barrier
// between stages, and writes the column once.  A column of 1024 elements is
// 32 KB plus a 16 KB twiddle table; above 48 KB (size 2048 and 4096) the
// launch raises the dynamic shared-memory limit first.
//
// What bounds it: (log2(size) - 1) * size/2 Montgomery products per column
// (on the carry-chain field ops of csrc/field.cuh), ~136 wide integer
// multiply-adds each by the paper count, against 2 * 32 bytes per element in
// canonical form: integer-multiply bound by about 2x at size 1024.  Loads
// and stores are strided by R elements (uncoalesced across the warp, each
// thread moving a 64-byte int64 word row); coalescing through a transposed
// layout and register-resident early stages are later work.

#include "field.cuh"

// Butterfly j of the stage whose blocks are 2m long, on the resident column
// s with twiddles tw[k] = w^k: the stage's twiddle for position k is
// tw[k * size / 2m] (`_ladder_body`'s table[:, ::nb][:, :m]).
__device__ __forceinline__ void col_ntt_butterfly(Fe* s, const Fe* tw, int size, int m, int j,
                                                  const FieldConst& fc) {
  const int k = j & (m - 1);
  const int lo = ((j - k) << 1) + k;
  const int hi = lo + m;
  Fe t = s[hi];
  if (m > 1 || size == 2) t = fe_mul_cc(t, tw[k * (size / (2 * m))], fc);
  const Fe u = s[lo];
  s[lo] = fe_add_cc(u, t, fc);
  s[hi] = fe_sub_cc(u, t, fc);
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

extern __shared__ Fe col_ntt_smem[];

__global__ void col_ntt_kernel(FieldConst fc, const long long* a, const long long* rev, const long long* table,
                               long long* out, int size, long long R) {
  Fe* s = col_ntt_smem;         // the column, size elements
  Fe* tw = col_ntt_smem + size;  // the twiddles, size/2 elements
  const long long r = blockIdx.x;
  const int half = size >> 1;
  for (int j = threadIdx.x; j < half; j += blockDim.x) tw[j] = fe_load(table, j);
  for (int i = threadIdx.x; i < size; i += blockDim.x) s[i] = fe_load(a, rev[i] * R + r);
  __syncthreads();
  for (int m = 1; m < size; m <<= 1) {
    for (int j = threadIdx.x; j < half; j += blockDim.x) col_ntt_butterfly(s, tw, size, m, j, fc);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < size; i += blockDim.x) fe_store(out, (long long)i * R + r, s[i]);
}

extern "C" int sirius_col_ntt(const uint32_t* consts, const void* a, const void* rev, const void* table, void* out,
                              long long size, long long R, void* stream) {
  const int half = (int)(size / 2);
  const int threads = half < 1 ? 1 : (half < 256 ? half : 256);
  const size_t smem = (size_t)(size + half) * sizeof(Fe);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(col_ntt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  col_ntt_kernel<<<(unsigned)R, threads, smem, (cudaStream_t)stream>>>(
      make_field_const(consts), (const long long*)a, (const long long*)rev, (const long long*)table,
      (long long*)out, (int)size, R);
  return (int)cudaGetLastError();
}
#endif
