// The port's elementwise field product on the card: `mul_rows`.
//
// out_i = a_i * b_((i / rep) mod nb)^K by K chained Montgomery products per
// element, one thread per element.  b holds nb rows broadcast over a's rows,
// each repeated rep times, so K = 1 is the NTT's elementwise product (its
// mid twiddle, over R columns at once with rep = R in a nested four-step,
// coset powers zeta^(i mod 3) and 1/n), and K = 8 over 2^17 elements is S2,
// the field-rate probe that replaces `scripts/tpu_microbench.py:mul_kernel`.
//
// What bounds it: K * ~136 wide integer multiply-adds per element against
// 96 bytes of canonical elements.  At K = 1 it is byte-bound (the NTT's mid
// multiply); at K = 8 integer-multiply bound, which is why S2 measures the
// card's Montgomery-multiply rate with it.  The K loop is not unrolled, so a
// chain of any length is one loop body.

#include "field.cuh"

// REPEAT: rep > 1 (a separate instance, so the rep = 1 code has no division).
template <bool REPEAT, bool ROLLED>
__device__ __forceinline__ void mul_rows_row(const FieldConst& fc, const long long* a, const long long* b,
                                             long long* out, long long nb, long long rep, int K, long long i) {
  Fe x = fe_load(a, i);
  const Fe y = fe_load(b, (REPEAT ? i / rep : i) % nb);
#pragma unroll 1
  for (int k = 0; k < K; ++k) x = fe_mul_t<ROLLED>(x, y, fc);
  fe_store(out, i, x);
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

template <bool REPEAT, bool ROLLED>
__global__ void mul_rows_kernel(FieldConst fc, const long long* a, const long long* b, long long* out, long long n,
                                long long nb, long long rep, int K) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) mul_rows_row<REPEAT, ROLLED>(fc, a, b, out, nb, rep, K, i);
}

// rolled: S1's product (rep = 1 only).
extern "C" int sirius_mul_rows(const uint32_t* consts, const void* a, const void* b, void* out, long long n,
                               long long nb, long long rep, int K, int rolled, void* stream) {
  const int threads = 128;
  long long blocks = (n + threads - 1) / threads;
  const FieldConst fc = make_field_const(consts);
  cudaStream_t st = (cudaStream_t)stream;
  const long long* pa = (const long long*)a;
  const long long* pb = (const long long*)b;
  if (rolled && rep != 1) return (int)cudaErrorInvalidValue;
  if (rolled)
    mul_rows_kernel<false, true><<<(unsigned)blocks, threads, 0, st>>>(fc, pa, pb, (long long*)out, n, nb, rep, K);
  else if (rep == 1)
    mul_rows_kernel<false, false><<<(unsigned)blocks, threads, 0, st>>>(fc, pa, pb, (long long*)out, n, nb, rep, K);
  else
    mul_rows_kernel<true, false><<<(unsigned)blocks, threads, 0, st>>>(fc, pa, pb, (long long*)out, n, nb, rep, K);
  return (int)cudaGetLastError();
}
#endif
