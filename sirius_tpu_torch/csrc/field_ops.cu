// The port's elementwise field kernels on the card: `mul_rows` and
// `addsub_rows`.
//
// mul_rows: out_i = a_i * b_j^K with j = (i / rep) mod nb, by K chained
// Montgomery products per element: b holds nb rows broadcast over a's rows,
// each repeated rep times.  K = 1 is every `Field.mul` and `square` on a
// CUDA tensor (b of n rows, or one row) and the NTT's
// elementwise product (coset powers zeta^(i mod 3), the flat route's 1/n, a
// nested four-step's mid twiddle over R columns at once with rep = R, the
// doubling build of the mid twiddle), and K = 8 over 2^17 elements is S2,
// the field-rate probe that replaces `scripts/tpu_microbench.py:mul_kernel`.
//
// addsub_rows: out_i = a_i + b_j, a_i - b_j or b_j - a_i (op 0, 1, 2) with
// j = i mod nb (b of n rows, or one row: a scalar b costs no copy): every
// `Field.add`, `sub`, `neg` and `double` on a CUDA tensor.  It replaces no
// TPU kernel: the JAX package's field ops are jitted, and XLA fuses their
// limb arithmetic into the program around them, which eager PyTorch cannot
// do (30 launches an op without this kernel).  What bounds it: three 32-byte
// canonical elements an element against ~40 integer adds, so bytes: 96 B an
// element (2^22 elements: 0.120 ms at 3.35 TB/s), which the port's int64
// words double to 192 B.  It runs mul_rows' K = 1 design: two elements a
// thread, 16-byte loads and stores, 32-bit index arithmetic.
//
// Both read a and b at a row stride (sa and sb rows) and write out dense: a
// strided view such as the pow tree's P[0::2] and P[1::2], or one column of
// a wider table, costs no copy (about a fifth of a trivial Cyclefold step's
// ring ops read one).  The wrappers refuse a row offset of 2^31 or more.
//
// What bounds mul_rows: K * ~136 wide integer multiply-adds per element
// against 96 bytes of canonical elements.  At K = 1 it is byte-bound, and at
// the port's int64 words it moves 192 bytes per element (2^20 elements:
// 0.060 ms at 3.35 TB/s), so at K = 1 it runs as a bandwidth kernel: each
// thread takes two elements (coalesced: the second sits a block width on),
// starts all their loads (16-byte read-only loads) before any product and
// stores in 16-byte stores.  At K > 1 it is integer-multiply bound, and each
// thread takes one element, so S2 (the card's Montgomery-multiply rate, on
// each of the port's five products: fe_mul_k, every rep) and the latency
// probe (one element, a long K) run one chain a thread.  The K > 1 instance
// is held to 64 registers (__launch_bounds__(128, 8)): 8 blocks of 128 a SM,
// so S2's 2^17 threads (1,024 blocks: 7 or 8 a SM) are all resident in one
// wave.  Index arithmetic is 32-bit (the wrapper refuses n >= 2^31), with a
// division only in the REPEAT instance (rep > 1) and a modulo only in the
// WRAP instance (nb * rep != n).  The K loop is not unrolled, so a chain of
// any length is one loop body; a thread's chains run interleaved in it.

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

// The rows of a and b of the elements first, first + stride, ... (EPT of
// them, those below n) of one thread, a at row stride sa and b at sb; a row
// past n is a zero that is never stored.
template <int EPT, bool REPEAT, bool WRAP>
__device__ __forceinline__ void rows_load(Fe (&x)[EPT], Fe (&y)[EPT], const long long* a, const long long* b,
                                          unsigned n, unsigned nb, unsigned rep, unsigned sa, unsigned sb,
                                          unsigned first, unsigned stride) {
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    x[e] = y[e] = Fe{};
    const unsigned i = first + e * stride;
    if (i < n) {
      const unsigned j = REPEAT ? i / rep : i;
      x[e] = fe_load_ro(a, i * sa);
      y[e] = fe_load_ro(b, (WRAP ? j % nb : j) * sb);
    }
  }
}

template <int EPT>
__device__ __forceinline__ void rows_store(long long* out, const Fe (&x)[EPT], unsigned n, unsigned first,
                                           unsigned stride) {
#pragma unroll
  for (int e = 0; e < EPT; ++e)
    if (first + e * stride < n) fe_store_v(out, first + e * stride, x[e]);
}

template <int EPT, bool REPEAT, bool WRAP, int PRODUCT>
__device__ __forceinline__ void mul_rows_thread(const FieldConst& fc, const long long* a, const long long* b,
                                                long long* out, unsigned n, unsigned nb, unsigned rep, unsigned sa,
                                                unsigned sb, int K, unsigned first, unsigned stride) {
  Fe x[EPT], y[EPT];
  rows_load<EPT, REPEAT, WRAP>(x, y, a, b, n, nb, rep, sa, sb, first, stride);
#pragma unroll 1
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int e = 0; e < EPT; ++e) x[e] = fe_mul_k<PRODUCT>(x[e], y[e], fc);
  }
  rows_store<EPT>(out, x, n, first, stride);
}

// addsub_rows' ops: 0 a + b, 1 a - b, 2 b - a.
constexpr int ADDSUB_OPS = 3;

template <int OP>
__device__ __forceinline__ Fe fe_addsub(const Fe& x, const Fe& y, const FieldConst& fc) {
  if (OP == 0) return fe_add(x, y, fc);
  if (OP == 1) return fe_sub(x, y, fc);
  return fe_sub(y, x, fc);
}

template <bool WRAP, int OP>
__device__ __forceinline__ void addsub_rows_thread(const FieldConst& fc, const long long* a, const long long* b,
                                                   long long* out, unsigned n, unsigned nb, unsigned sa, unsigned sb,
                                                   unsigned first, unsigned stride) {
  Fe x[2], y[2];
  rows_load<2, false, WRAP>(x, y, a, b, n, nb, 1u, sa, sb, first, stride);
#pragma unroll
  for (int e = 0; e < 2; ++e) x[e] = fe_addsub<OP>(x[e], y[e], fc);
  rows_store<2>(out, x, n, first, stride);
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

template <int EPT, bool REPEAT, bool WRAP, int PRODUCT>
__global__ void __launch_bounds__(128, mul_rows_min_blocks(EPT))
    mul_rows_kernel(FieldConst fc, const long long* a, const long long* b, long long* out, unsigned n, unsigned nb,
                    unsigned rep, unsigned sa, unsigned sb, int K) {
  mul_rows_thread<EPT, REPEAT, WRAP, PRODUCT>(fc, a, b, out, n, nb, rep, sa, sb, K,
                                              blockIdx.x * (blockDim.x * EPT) + threadIdx.x, blockDim.x);
}

template <bool WRAP, int OP>
__global__ void __launch_bounds__(128)
    addsub_rows_kernel(FieldConst fc, const long long* a, const long long* b, long long* out, unsigned n,
                       unsigned nb, unsigned sa, unsigned sb) {
  addsub_rows_thread<WRAP, OP>(fc, a, b, out, n, nb, sa, sb, blockIdx.x * (blockDim.x * 2) + threadIdx.x, blockDim.x);
}

// ---- host launchers ----
template <int EPT, int PRODUCT>
static void mul_rows_launch(int threads, cudaStream_t st, const FieldConst& fc, const long long* a,
                            const long long* b, long long* out, unsigned n, unsigned nb, unsigned rep, unsigned sa,
                            unsigned sb, int K) {
  const unsigned blocks = (unsigned)(((unsigned long long)n + threads * EPT - 1) / (threads * EPT));
  const bool wrap = (unsigned long long)nb * rep != n;
  if (rep > 1 && wrap)
    mul_rows_kernel<EPT, true, true, PRODUCT><<<blocks, threads, 0, st>>>(fc, a, b, out, n, nb, rep, sa, sb, K);
  else if (rep > 1)
    mul_rows_kernel<EPT, true, false, PRODUCT><<<blocks, threads, 0, st>>>(fc, a, b, out, n, nb, rep, sa, sb, K);
  else if (wrap)
    mul_rows_kernel<EPT, false, true, PRODUCT><<<blocks, threads, 0, st>>>(fc, a, b, out, n, nb, rep, sa, sb, K);
  else
    mul_rows_kernel<EPT, false, false, PRODUCT><<<blocks, threads, 0, st>>>(fc, a, b, out, n, nb, rep, sa, sb, K);
}

template <int PRODUCT>
static void mul_rows_launch_k(int threads, cudaStream_t st, const FieldConst& fc, const long long* a,
                              const long long* b, long long* out, unsigned n, unsigned nb, unsigned rep, unsigned sa,
                              unsigned sb, int K) {
  if (mul_rows_ept(K) == 2)
    mul_rows_launch<2, PRODUCT>(threads, st, fc, a, b, out, n, nb, rep, sa, sb, K);
  else
    mul_rows_launch<1, PRODUCT>(threads, st, fc, a, b, out, n, nb, rep, sa, sb, K);
}

// The sizes both entries take: n, nb and rep below 2^31, nb and rep at
// least 1, and each operand's last row offset below 2^31.
static bool rows_sizes_ok(long long n, long long nb, long long rep, long long sa, long long sb) {
  const long long lim = 1LL << 31;
  return n < lim && nb < lim && rep < lim && nb >= 1 && rep >= 1 && sa >= 0 && sb >= 0 &&
         (n ? n - 1 : 0) * sa < lim && (nb - 1) * sb < lim;
}

// product: fe_mul_k's kind.
extern "C" int sirius_mul_rows(const uint32_t* consts, const void* a, const void* b, void* out, long long n,
                               long long nb, long long rep, long long sa, long long sb, int K, int product,
                               void* stream) {
  const int threads = 128;
  if (product < 0 || product >= MUL_ROWS_PRODUCTS || !rows_sizes_ok(n, nb, rep, sa, sb))
    return (int)cudaErrorInvalidValue;
  const FieldConst fc = make_field_const(consts);
  cudaStream_t st = (cudaStream_t)stream;
  const long long* pa = (const long long*)a;
  const long long* pb = (const long long*)b;
  long long* po = (long long*)out;
  const unsigned un = (unsigned)n, unb = (unsigned)nb, urep = (unsigned)rep, usa = (unsigned)sa, usb = (unsigned)sb;
  if (product == 0) mul_rows_launch_k<0>(threads, st, fc, pa, pb, po, un, unb, urep, usa, usb, K);
  if (product == 1) mul_rows_launch_k<1>(threads, st, fc, pa, pb, po, un, unb, urep, usa, usb, K);
  if (product == 2) mul_rows_launch_k<2>(threads, st, fc, pa, pb, po, un, unb, urep, usa, usb, K);
  if (product == 3) mul_rows_launch_k<3>(threads, st, fc, pa, pb, po, un, unb, urep, usa, usb, K);
  if (product == 4) mul_rows_launch_k<4>(threads, st, fc, pa, pb, po, un, unb, urep, usa, usb, K);
  return (int)cudaGetLastError();
}

template <int OP>
static void addsub_rows_launch(cudaStream_t st, const FieldConst& fc, const long long* a, const long long* b,
                               long long* out, unsigned n, unsigned nb, unsigned sa, unsigned sb) {
  const int threads = 128;
  const unsigned blocks = (unsigned)(((unsigned long long)n + threads * 2 - 1) / (threads * 2));
  if (nb != n)
    addsub_rows_kernel<true, OP><<<blocks, threads, 0, st>>>(fc, a, b, out, n, nb, sa, sb);
  else
    addsub_rows_kernel<false, OP><<<blocks, threads, 0, st>>>(fc, a, b, out, n, nb, sa, sb);
}

// op: fe_addsub's.
extern "C" int sirius_addsub_rows(const uint32_t* consts, const void* a, const void* b, void* out, long long n,
                                  long long nb, long long sa, long long sb, int op, void* stream) {
  if (op < 0 || op >= ADDSUB_OPS || !rows_sizes_ok(n, nb, 1, sa, sb)) return (int)cudaErrorInvalidValue;
  const FieldConst fc = make_field_const(consts);
  cudaStream_t st = (cudaStream_t)stream;
  const long long* pa = (const long long*)a;
  const long long* pb = (const long long*)b;
  long long* po = (long long*)out;
  const unsigned un = (unsigned)n, unb = (unsigned)nb, usa = (unsigned)sa, usb = (unsigned)sb;
  if (op == 0) addsub_rows_launch<0>(st, fc, pa, pb, po, un, unb, usa, usb);
  if (op == 1) addsub_rows_launch<1>(st, fc, pa, pb, po, un, unb, usa, usb);
  if (op == 2) addsub_rows_launch<2>(st, fc, pa, pb, po, un, unb, usa, usb);
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
