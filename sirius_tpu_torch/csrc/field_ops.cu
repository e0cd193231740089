// The port's elementwise field product on the card: `mul_rows`.
//
// out_i = a_i * b_(i mod nb)^K by K chained Montgomery products per element,
// one thread per element.  b holds nb rows broadcast over a's rows, so K = 1
// is the NTT's elementwise product (its mid twiddle, coset powers
// zeta^(i mod 3) and 1/n), and K = 8 over 2^17 elements is S2, the
// field-rate probe that replaces `scripts/tpu_microbench.py:mul_kernel`.
//
// What bounds it: K * ~136 wide integer multiply-adds per element against
// 96 bytes of canonical elements.  At K = 1 it is byte-bound (the NTT's mid
// multiply); at K = 8 integer-multiply bound, which is why S2 measures the
// card's Montgomery-multiply rate with it.  The K loop is not unrolled, so a
// chain of any length is one loop body.

#include "field.cuh"

__device__ __forceinline__ void mul_rows_row(const FieldConst& fc, const long long* a, const long long* b,
                                             long long* out, long long nb, int K, long long i) {
  Fe x = fe_load(a, i);
  const Fe y = fe_load(b, i % nb);
#pragma unroll 1
  for (int k = 0; k < K; ++k) x = fe_mul(x, y, fc);
  fe_store(out, i, x);
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

__global__ void mul_rows_kernel(FieldConst fc, const long long* a, const long long* b, long long* out, long long n,
                                long long nb, int K) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) mul_rows_row(fc, a, b, out, nb, K, i);
}

extern "C" int sirius_mul_rows(const uint32_t* consts, const void* a, const void* b, void* out, long long n,
                               long long nb, int K, void* stream) {
  const int threads = 128;
  long long blocks = (n + threads - 1) / threads;
  mul_rows_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      make_field_const(consts), (const long long*)a, (const long long*)b, (long long*)out, n, nb, K);
  return (int)cudaGetLastError();
}
#endif
