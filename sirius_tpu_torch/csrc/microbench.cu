// S3, S4: the integer-rate and build probes.  (S2, the Montgomery-multiply
// rate, is the field product `mul_rows` of `field_ops.cu` at K = 8.)
//
// S3 `raw_u32` replaces `scripts/tpu_microbench.py:raw_kernel`: reps chained
//    32-bit multiplies or adds b = op(b, a) mod 2^32 per value, the raw
//    integer rate.  Each op is an inline PTX instruction so that the
//    compiler cannot fold the chain (64 adds into one multiply, 64
//    multiplies into 6 squarings).  It is bound by the integer rate (64
//    32-bit IMAD or IADD3 a clock an SM, 2^22 x 64 ops in 0.016 ms at
//    1980 MHz) against 8 bytes a value (0.010 ms at 3.35 TB/s), so the
//    design keeps the issue slots on the chain: values are the TPU probe's
//    4-byte words (an int32 tensor holding the u32 bits), a thread moves 4
//    of them in one 16-byte load and store and runs their 4 independent
//    chains interleaved; the chain is straight-line code at the timed 64
//    reps (RAW_UNROLL; other reps loop over that body, no loop counter per
//    few ops); and a grid of as many blocks as the SMs hold strides over
//    the values with the next load in flight during the chains.
// S4 `add_one` replaces `scripts/lower_dump.py:tiny`: x + 1 mod 2^32 on one
//    (8, 128) tile.  The TPU probe asked whether a compiled kernel is cached
//    stably across processes; here the question goes to the library cache of
//    `ops/_build.py`, and the kernel only shows that the library loaded.  One
//    block's work: its time is a launch's latency.

#include <stdint.h>

constexpr int RAW_UNROLL = 64;  // the timed chain: one straight-line body

template <int OP>
__device__ __forceinline__ void raw_step(uint32_t& b, uint32_t a) {
#ifdef __CUDA_ARCH__
  if (OP == 0)
    asm volatile("mul.lo.u32 %0, %0, %1;" : "+r"(b) : "r"(a));
  else
    asm volatile("add.u32 %0, %0, %1;" : "+r"(b) : "r"(a));
#else
  b = OP == 0 ? b * a : b + a;
#endif
}

// One step of the 4 chains of a thread, interleaved.
template <int OP>
__device__ __forceinline__ void raw_step4(uint32_t* b, const uint32_t* a) {
#pragma unroll
  for (int j = 0; j < 4; ++j) raw_step<OP>(b[j], a[j]);
}

// reps steps b = op(b, a) from b = a on 4 values; FIXED: reps == RAW_UNROLL,
// straight-line code.
template <int OP, bool FIXED>
__device__ __forceinline__ void raw_u32_quad(uint32_t* b, const uint32_t* a, int reps) {
#pragma unroll
  for (int j = 0; j < 4; ++j) b[j] = a[j];
  if constexpr (FIXED) {
#pragma unroll
    for (int k = 0; k < RAW_UNROLL; ++k) raw_step4<OP>(b, a);
  } else {
#pragma unroll 1
    for (int r = reps / RAW_UNROLL; r > 0; --r) {
#pragma unroll
      for (int k = 0; k < RAW_UNROLL; ++k) raw_step4<OP>(b, a);
    }
#pragma unroll 1
    for (int r = reps % RAW_UNROLL; r > 0; --r) raw_step4<OP>(b, a);
  }
}

// Value i of n (the ragged tail past the last full group of 4): its chain
// run as one of 4 copies.
template <int OP, bool FIXED>
__device__ __forceinline__ uint32_t raw_u32_one(uint32_t x, int reps) {
  const uint32_t a[4] = {x, x, x, x};
  uint32_t b[4];
  raw_u32_quad<OP, FIXED>(b, a, reps);
  return b[0];
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

// n4 groups of 4 values as uint4 (16-byte aligned), then the tail of n - 4 n4
// values, taken by the first threads of the grid.
template <int OP, bool FIXED>
__global__ void raw_u32_kernel(const uint4* a, uint4* out, long long n4, const uint32_t* tail_a,
                               uint32_t* tail_out, int tail, int reps) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < tail) tail_out[i] = raw_u32_one<OP, FIXED>(tail_a[i], reps);
  uint4 cur = i < n4 ? a[i] : make_uint4(0u, 0u, 0u, 0u);
  for (; i < n4; i += stride) {
    uint4 next = cur;
    if (i + stride < n4) next = a[i + stride];  // in flight during the chains
    const uint32_t x[4] = {cur.x, cur.y, cur.z, cur.w};
    uint32_t b[4];
    raw_u32_quad<OP, FIXED>(b, x, reps);
    out[i] = make_uint4(b[0], b[1], b[2], b[3]);
    cur = next;
  }
}

__global__ void add_one_kernel(const long long* x, long long* out, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = (long long)((uint32_t)x[i] + 1u);
}

constexpr int RAW_THREADS = 256;

// The blocks the card holds at once (SMs x resident blocks), found at the
// first launch of each instance: a call then costs the host one launch.
template <int OP, bool FIXED>
static int raw_u32_launch(const void* a, void* out, long long n, int reps, cudaStream_t st) {
  static long long resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, raw_u32_kernel<OP, FIXED>, RAW_THREADS, 0);
    if (e != cudaSuccess) return (int)e;
    resident = (long long)sms * per_sm;
  }
  const long long n4 = n / 4;
  const int tail = (int)(n - 4 * n4);
  long long blocks = (n4 + RAW_THREADS - 1) / RAW_THREADS;
  if (blocks > resident) blocks = resident;
  if (blocks < 1) blocks = 1;
  raw_u32_kernel<OP, FIXED><<<(unsigned)blocks, RAW_THREADS, 0, st>>>(
      (const uint4*)a, (uint4*)out, n4, (const uint32_t*)a + 4 * n4, (uint32_t*)out + 4 * n4, tail, reps);
  return (int)cudaGetLastError();
}

// a, out: n u32 words, 16-byte aligned.  op 0 mul, 1 add.
extern "C" int sirius_raw_u32(const void* a, void* out, long long n, int op, int reps, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (reps == RAW_UNROLL)
    return op == 0 ? raw_u32_launch<0, true>(a, out, n, reps, st) : raw_u32_launch<1, true>(a, out, n, reps, st);
  return op == 0 ? raw_u32_launch<0, false>(a, out, n, reps, st) : raw_u32_launch<1, false>(a, out, n, reps, st);
}

extern "C" int sirius_add_one(const void* x, void* out, long long n, void* stream) {
  const int threads = 128;
  long long blocks = (n + threads - 1) / threads;
  add_one_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>((const long long*)x, (long long*)out, n);
  return (int)cudaGetLastError();
}
#endif
