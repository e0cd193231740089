// The port's elementwise field product on the card: `mul_rows`.
//
// out_i = a_i * b_j^K with j = (i / rep) mod nb, by K chained Montgomery
// products per element: b holds nb rows broadcast over a's rows, each
// repeated rep times.  K = 1 is the NTT's elementwise product (coset powers
// zeta^(i mod 3), the flat route's 1/n, a nested four-step's mid twiddle
// over R columns at once with rep = R, the doubling build of the mid
// twiddle), and K = 8 over 2^17 elements is S2, the field-rate probe that
// replaces `scripts/tpu_microbench.py:mul_kernel`.
//
// What bounds it: K * ~136 wide integer multiply-adds per element against
// 96 bytes of canonical elements.  At K = 1 it is byte-bound, and at the
// port's int64 words it moves 192 bytes per element (2^20 elements: 0.060 ms
// at 3.35 TB/s), so at K = 1 it runs as a bandwidth kernel: each thread
// takes two elements (coalesced: the second sits a block width on), starts
// all their loads (16-byte read-only loads) before any product and stores in
// 16-byte stores.  At K > 1 it is integer-multiply bound, and each thread
// takes one element, so S2 (the card's Montgomery-multiply rate, on each of
// the port's five products: fe_mul_k, every rep) and the latency probe (one
// element, a long K) run one chain a thread.  The K > 1 instance is held to
// 64 registers (__launch_bounds__(128, 8)): 8 blocks of 128 a SM, so S2's
// 2^17 threads (1,024 blocks: 7 or 8 a SM) are all resident in one wave.
// Index arithmetic is 32-bit (the wrapper refuses n >= 2^31),
// with a division only in the REPEAT instance (rep > 1) and a modulo only in
// the WRAP instance (nb * rep != n).  The K loop is not unrolled, so a chain
// of any length is one loop body; a thread's chains run interleaved in it.

#include "field.cuh"

// The product by kind: 0 the unrolled CIOS (fe_mul), 1 the rolled one
// (S1's fe_mul_t<true>), 2 the carry-chain one (fe_mul_cc: B1's walk, B2's
// and B4's), 3 the rolled carry-chain one (fe_mul_n: B3's), 4 the wide one
// (fe_mul_wide: B1's batched madd); the same words.
constexpr int MUL_ROWS_PRODUCTS = 5;

template <int PRODUCT>
__device__ __forceinline__ Fe fe_mul_k(const Fe& a, const Fe& b, const FieldConst& fc) {
  if (PRODUCT == 4) return fe_mul_wide(a, b, fc);
  if (PRODUCT == 3) {
    Fe r;
    fe_mul_n<1>(&r, &a, &b, fc);
    return r;
  }
  if (PRODUCT == 2) return fe_mul_cc(a, b, fc);
  return fe_mul_t<PRODUCT == 1>(a, b, fc);
}

// Elements a thread: two at K = 1 (the bandwidth instance), one at K > 1.
__host__ __device__ constexpr int mul_rows_ept(int K) { return K == 1 ? 2 : 1; }

// Resident blocks of 128 a SM the instance is built for: the K > 1 one
// (one element a thread) at most 64 registers, so 8.
__host__ __device__ constexpr int mul_rows_min_blocks(int EPT) { return EPT == 1 ? 8 : 1; }

// The elements first, first + stride, ... (EPT of them, those below n) of
// one thread; a row past n is a zero that is never stored.
template <int EPT, bool REPEAT, bool WRAP, int PRODUCT>
__device__ __forceinline__ void mul_rows_thread(const FieldConst& fc, const long long* a, const long long* b,
                                                long long* out, unsigned n, unsigned nb, unsigned rep, int K,
                                                unsigned first, unsigned stride) {
  Fe x[EPT] = {}, y[EPT] = {};
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const unsigned i = first + e * stride;
    if (i < n) {
      const unsigned j = REPEAT ? i / rep : i;
      x[e] = fe_load_ro(a, i);
      y[e] = fe_load_ro(b, WRAP ? j % nb : j);
    }
  }
#pragma unroll 1
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int e = 0; e < EPT; ++e) x[e] = fe_mul_k<PRODUCT>(x[e], y[e], fc);
  }
#pragma unroll
  for (int e = 0; e < EPT; ++e)
    if (first + e * stride < n) fe_store_v(out, first + e * stride, x[e]);
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

template <int EPT, bool REPEAT, bool WRAP, int PRODUCT>
__global__ void __launch_bounds__(128, mul_rows_min_blocks(EPT))
    mul_rows_kernel(FieldConst fc, const long long* a, const long long* b, long long* out, unsigned n, unsigned nb,
                    unsigned rep, int K) {
  mul_rows_thread<EPT, REPEAT, WRAP, PRODUCT>(fc, a, b, out, n, nb, rep, K,
                                              blockIdx.x * (blockDim.x * EPT) + threadIdx.x, blockDim.x);
}

// ---- host launchers ----
template <int EPT, int PRODUCT>
static void mul_rows_launch(int threads, cudaStream_t st, const FieldConst& fc, const long long* a,
                            const long long* b, long long* out, unsigned n, unsigned nb, unsigned rep, int K) {
  const unsigned blocks = (unsigned)(((unsigned long long)n + threads * EPT - 1) / (threads * EPT));
  const bool wrap = (unsigned long long)nb * rep != n;
  if (rep > 1 && wrap)
    mul_rows_kernel<EPT, true, true, PRODUCT><<<blocks, threads, 0, st>>>(fc, a, b, out, n, nb, rep, K);
  else if (rep > 1)
    mul_rows_kernel<EPT, true, false, PRODUCT><<<blocks, threads, 0, st>>>(fc, a, b, out, n, nb, rep, K);
  else if (wrap)
    mul_rows_kernel<EPT, false, true, PRODUCT><<<blocks, threads, 0, st>>>(fc, a, b, out, n, nb, rep, K);
  else
    mul_rows_kernel<EPT, false, false, PRODUCT><<<blocks, threads, 0, st>>>(fc, a, b, out, n, nb, rep, K);
}

template <int PRODUCT>
static void mul_rows_launch_k(int threads, cudaStream_t st, const FieldConst& fc, const long long* a,
                              const long long* b, long long* out, unsigned n, unsigned nb, unsigned rep, int K) {
  if (mul_rows_ept(K) == 2)
    mul_rows_launch<2, PRODUCT>(threads, st, fc, a, b, out, n, nb, rep, K);
  else
    mul_rows_launch<1, PRODUCT>(threads, st, fc, a, b, out, n, nb, rep, K);
}

// product: fe_mul_k's kind; n, nb and rep below 2^31.
extern "C" int sirius_mul_rows(const uint32_t* consts, const void* a, const void* b, void* out, long long n,
                               long long nb, long long rep, int K, int product, void* stream) {
  const int threads = 128;
  if (product < 0 || product >= MUL_ROWS_PRODUCTS || n >= (1LL << 31) || nb >= (1LL << 31) || rep >= (1LL << 31) ||
      nb < 1 || rep < 1)
    return (int)cudaErrorInvalidValue;
  const FieldConst fc = make_field_const(consts);
  cudaStream_t st = (cudaStream_t)stream;
  const long long* pa = (const long long*)a;
  const long long* pb = (const long long*)b;
  long long* po = (long long*)out;
  const unsigned un = (unsigned)n, unb = (unsigned)nb, urep = (unsigned)rep;
  if (product == 0) mul_rows_launch_k<0>(threads, st, fc, pa, pb, po, un, unb, urep, K);
  if (product == 1) mul_rows_launch_k<1>(threads, st, fc, pa, pb, po, un, unb, urep, K);
  if (product == 2) mul_rows_launch_k<2>(threads, st, fc, pa, pb, po, un, unb, urep, K);
  if (product == 3) mul_rows_launch_k<3>(threads, st, fc, pa, pb, po, un, unb, urep, K);
  if (product == 4) mul_rows_launch_k<4>(threads, st, fc, pa, pb, po, un, unb, urep, K);
  return (int)cudaGetLastError();
}

// Registers, local (spill) bytes, static shared bytes of an instance:
// product < 0 the one the NTT path launches most (K = 1: rep = 1, the
// modulo, the unrolled product), else S2's on that product (K > 1, one
// element a thread, rep = 1, nb = n).
extern "C" int sirius_mul_rows_attrs(int product, void* out) {
  cudaFuncAttributes fa;
  cudaError_t e;
  switch (product) {
    case -1: e = cudaFuncGetAttributes(&fa, mul_rows_kernel<2, false, true, 0>); break;
    case 0: e = cudaFuncGetAttributes(&fa, mul_rows_kernel<1, false, false, 0>); break;
    case 1: e = cudaFuncGetAttributes(&fa, mul_rows_kernel<1, false, false, 1>); break;
    case 2: e = cudaFuncGetAttributes(&fa, mul_rows_kernel<1, false, false, 2>); break;
    case 3: e = cudaFuncGetAttributes(&fa, mul_rows_kernel<1, false, false, 3>); break;
    case 4: e = cudaFuncGetAttributes(&fa, mul_rows_kernel<1, false, false, 4>); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  long long* o = (long long*)out;
  o[0] = fa.numRegs;
  o[1] = (long long)fa.localSizeBytes;
  o[2] = (long long)fa.sharedSizeBytes;
  return 0;
}
#endif
