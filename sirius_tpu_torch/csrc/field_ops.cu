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
// card's Montgomery-multiply rate with it, on each of the port's three
// products (fe_mul_k).  The K loop is not unrolled, so a chain of any length
// is one loop body.

#include "field.cuh"

// The product by kind: 0 the unrolled CIOS (fe_mul: this kernel's own),
// 1 the rolled one (S1's fe_mul_t<true>), 2 the carry-chain one (fe_mul_cc:
// B1's, B2's and B4's), 3 the rolled carry-chain one (fe_mul_n: B3's); the
// same words.
template <int PRODUCT>
__device__ __forceinline__ Fe fe_mul_k(const Fe& a, const Fe& b, const FieldConst& fc) {
  if (PRODUCT == 3) {
    Fe r;
    fe_mul_n<1>(&r, &a, &b, fc);
    return r;
  }
  if (PRODUCT == 2) return fe_mul_cc(a, b, fc);
  return fe_mul_t<PRODUCT == 1>(a, b, fc);
}

// REPEAT: rep > 1 (a separate instance, so the rep = 1 code has no division).
template <bool REPEAT, int PRODUCT>
__device__ __forceinline__ void mul_rows_row(const FieldConst& fc, const long long* a, const long long* b,
                                             long long* out, long long nb, long long rep, int K, long long i) {
  Fe x = fe_load(a, i);
  const Fe y = fe_load(b, (REPEAT ? i / rep : i) % nb);
#pragma unroll 1
  for (int k = 0; k < K; ++k) x = fe_mul_k<PRODUCT>(x, y, fc);
  fe_store(out, i, x);
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

template <bool REPEAT, int PRODUCT>
__global__ void mul_rows_kernel(FieldConst fc, const long long* a, const long long* b, long long* out, long long n,
                                long long nb, long long rep, int K) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) mul_rows_row<REPEAT, PRODUCT>(fc, a, b, out, nb, rep, K, i);
}

// product: fe_mul_k's kind (rep = 1 only for kinds 1 to 3).
extern "C" int sirius_mul_rows(const uint32_t* consts, const void* a, const void* b, void* out, long long n,
                               long long nb, long long rep, int K, int product, void* stream) {
  const int threads = 128;
  long long blocks = (n + threads - 1) / threads;
  const FieldConst fc = make_field_const(consts);
  cudaStream_t st = (cudaStream_t)stream;
  const long long* pa = (const long long*)a;
  const long long* pb = (const long long*)b;
  long long* po = (long long*)out;
  if (product < 0 || product > 3 || (product != 0 && rep != 1)) return (int)cudaErrorInvalidValue;
  if (product == 1)
    mul_rows_kernel<false, 1><<<(unsigned)blocks, threads, 0, st>>>(fc, pa, pb, po, n, nb, rep, K);
  else if (product == 2)
    mul_rows_kernel<false, 2><<<(unsigned)blocks, threads, 0, st>>>(fc, pa, pb, po, n, nb, rep, K);
  else if (product == 3)
    mul_rows_kernel<false, 3><<<(unsigned)blocks, threads, 0, st>>>(fc, pa, pb, po, n, nb, rep, K);
  else if (rep == 1)
    mul_rows_kernel<false, 0><<<(unsigned)blocks, threads, 0, st>>>(fc, pa, pb, po, n, nb, rep, K);
  else
    mul_rows_kernel<true, 0><<<(unsigned)blocks, threads, 0, st>>>(fc, pa, pb, po, n, nb, rep, K);
  return (int)cudaGetLastError();
}
#endif
