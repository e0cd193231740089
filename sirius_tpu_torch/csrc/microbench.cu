// S3, S4: the integer-rate and build probes.  (S2, the Montgomery-multiply
// rate, is the field product `mul_rows` of `field_ops.cu` at K = 8.)
//
// S3 `raw_u32` replaces `scripts/tpu_microbench.py:raw_kernel`: reps chained
//    32-bit multiplies or adds b = op(b, a) mod 2^32 per value, the raw
//    integer rate.  Each op is an inline PTX instruction so that the
//    compiler cannot fold the chain (64 adds into one multiply, 64
//    multiplies into 6 squarings).
// S4 `add_one` replaces `scripts/lower_dump.py:tiny`: x + 1 mod 2^32 on one
//    (8, 128) tile.  The TPU probe asked whether a compiled kernel is cached
//    stably across processes; here the question goes to the library cache of
//    `ops/_build.py`, and the kernel only shows that the library loaded.

#include <stdint.h>

__device__ __forceinline__ uint32_t raw_op(int op, uint32_t b, uint32_t a) {
#ifdef __CUDA_ARCH__
  if (op == 0)
    asm volatile("mul.lo.u32 %0, %0, %1;" : "+r"(b) : "r"(a));
  else
    asm volatile("add.u32 %0, %0, %1;" : "+r"(b) : "r"(a));
  return b;
#else
  return op == 0 ? b * a : b + a;
#endif
}

__device__ __forceinline__ void raw_u32_row(const long long* a, long long* out, int op, int reps, long long i) {
  const uint32_t x = (uint32_t)a[i];
  uint32_t b = x;
#pragma unroll 16
  for (int k = 0; k < reps; ++k) b = raw_op(op, b, x);
  out[i] = (long long)b;
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

__global__ void raw_u32_kernel(const long long* a, long long* out, long long n, int op, int reps) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) raw_u32_row(a, out, op, reps, i);
}

__global__ void add_one_kernel(const long long* x, long long* out, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = (long long)((uint32_t)x[i] + 1u);
}

extern "C" int sirius_raw_u32(const void* a, void* out, long long n, int op, int reps, void* stream) {
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  raw_u32_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>((const long long*)a, (long long*)out, n,
                                                                          op, reps);
  return (int)cudaGetLastError();
}

extern "C" int sirius_add_one(const void* x, void* out, long long n, void* stream) {
  const int threads = 128;
  long long blocks = (n + threads - 1) / threads;
  add_one_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>((const long long*)x, (long long*)out, n);
  return (int)cudaGetLastError();
}
#endif
