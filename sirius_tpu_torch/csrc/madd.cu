// B1: the incomplete mixed EC addition (madd-2007-bl), batched and as msm_many's bucket walk.
//
// Replaces the TPU kernel `sirius_tpu/ops/pallas_madd.py:_madd_kernel`
// (core `sirius_tpu/ops/limb_kernels.py:k_madd_incomplete`) and, in
// madd_buckets, the loop around it in
// `sirius_tpu/ops/msm.py:_bucket_totals_onehot_pallas` (one launch per step,
// a one-hot select of each lane's bucket and a masked write-back over the
// whole bucket table: the TPU has no cheap gather or scatter).
//
//   madd          P + Q per lane, Jacobian P (may be the identity) and
//                 affine Q, in the port's (n, 8) int64 layout: one lane a
//                 thread, its rows in 16-byte loads and stores, its 11
//                 products in madd-2007-bl's five dependency levels on the
//                 wide product (pt_madd_wide), built for 3 blocks of 128 a
//                 SM (160 registers, no spill: a lane's interleaved
//                 products need them).  On the H100 (PERF.md section 6, labs C
//                 and D) 4 blocks a SM spilled, a grid of the resident
//                 blocks striding over the lanes with the next lane's loads
//                 ahead was 11-16% slower, and blocks of 64 or 160 read
//                 within 1%.
//   madd_buckets  msm_many's bucket stage in one launch: lane (t, w, g)
//                 walks group g's points in step order; a nonzero c-bit
//                 digit d of scalar t at window w reads bucket d of the lane
//                 from the table, runs the same madd and stores it back; a
//                 dead digit touches nothing.  The first touch of a bucket
//                 is a madd onto the identity, which gives the point itself:
//                 the lane keeps a mask of touched buckets, skips that madd,
//                 and at the end writes the identity into the buckets it
//                 never touched (so the table needs no fill).  The table is
//                 laid out (t, W, B, G, 8): the G group partials of a bucket
//                 are one segment for B3's reduce, with no permute.
//
// What bounds them on the H100: a madd is 11 Montgomery products (madd on
// the wide product of csrc/field.cuh, madd_buckets on the carry-chain one)
// against at most 5 field elements of traffic (8 with the output: 512 bytes
// a lane at the int64 words, 0.0125 ms for 81,920 lanes at 3.35 TB/s),
// so both are integer-multiply bound; the
// bucket walk also moves its table through HBM (1.2e5 lanes x 15 buckets x
// 192 bytes at msm_many's (5, 2^14) shape: more than the 50 MB L2), which
// the madd's arithmetic hides.  One lane per thread in one launch replaces
// the loop's 64 launches and its ~1 GB per step of select and write-back.
// Outputs are bit-identical to the plain torch twins and to the JAX function.

#include "curve.cuh"

constexpr int MADD_THREADS = 128;
constexpr int MADD_MIN_BLOCKS = 3;       // resident madd blocks per SM: at most 168 registers a thread
constexpr int BUCKET_THREADS = 128;      // lanes per madd_buckets block
constexpr int BUCKET_MIN_BLOCKS = 3;     // resident blocks per SM: at most 168 registers a thread

// Lane i of madd: rows 16-byte aligned.
__device__ __forceinline__ void madd_row(const FieldConst& fc, const long long* x, const long long* y,
                                         const long long* z, const long long* qx, const long long* qy,
                                         long long* ox, long long* oy, long long* oz, long long i) {
  const Pt P = {fe_load_ro(x, i), fe_load_ro(y, i), fe_load_ro(z, i)};
  const Pt R = pt_madd_wide(P, fe_load_ro(qx, i), fe_load_ro(qy, i), fc);
  fe_store_v(ox, i, R.x);
  fe_store_v(oy, i, R.y);
  fe_store_v(oz, i, R.z);
}

// Lane (t, w, g) of madd_buckets: scalars (t, n, 8), points (n, 8), table
// (t, W, B, G, 8) with B = 2^c - 1 and group g holding points [g gs, g gs + gs).
__device__ __forceinline__ void bucket_lane(const FieldConst& fc, const long long* scalars, const long long* px,
                                            const long long* py, long long* bx, long long* by, long long* bz,
                                            long long n, int W, int G, int c, long long lane) {
  const int B = (1 << c) - 1;
  const long long g = lane % G;
  const long long tw = lane / G;  // t W + w
  const int w = (int)(tw % W);
  const long long t = tw / W;
  const long long gs = n / G;
  const long long p0 = g * gs;
  const long long* srow = scalars + (t * n + p0) * 8;
  uint32_t touched = 0u;
#pragma unroll 1
  for (long long k = 0; k < gs; ++k) {
    const uint32_t d = window_digit(srow + k * 8, w, c);
    if (d == 0u) continue;
    const long long slot = (tw * B + (d - 1)) * G + g;
    const Fe qx = fe_load_ro(px, p0 + k);
    const Fe qy = fe_load_ro(py, p0 + k);
    Pt acc;
    if ((touched >> (d - 1)) & 1u) {
      acc = pt_madd(pt_load(bx, by, bz, slot), qx, qy, fc);
    } else {
      acc.x = qx;
      acc.y = qy;
      acc.z = fe_one(fc);
      touched |= 1u << (d - 1);
    }
    pt_store(bx, by, bz, slot, acc);
  }
  for (int b = 0; b < B; ++b)
    if (!((touched >> b) & 1u)) pt_store(bx, by, bz, (tw * B + b) * G + g, pt_identity(fc));
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

__global__ void __launch_bounds__(MADD_THREADS, MADD_MIN_BLOCKS)
    madd_kernel(FieldConst fc, const long long* x, const long long* y, const long long* z, const long long* qx,
                const long long* qy, long long* ox, long long* oy, long long* oz, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) madd_row(fc, x, y, z, qx, qy, ox, oy, oz, i);
}

__global__ void __launch_bounds__(BUCKET_THREADS, BUCKET_MIN_BLOCKS)
    madd_buckets_kernel(FieldConst fc, const long long* scalars, const long long* px, const long long* py,
                        long long* bx, long long* by, long long* bz, long long n, int W, int G, int c,
                        long long lanes) {
  long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < lanes) bucket_lane(fc, scalars, px, py, bx, by, bz, n, W, G, c, lane);
}

// ---- host launchers ----
// Operands (n, 8) int64, rows 16-byte aligned.
extern "C" int sirius_madd(const uint32_t* consts, const void* x, const void* y, const void* z,
                           const void* qx, const void* qy, void* ox, void* oy, void* oz, long long n,
                           void* stream) {
  long long blocks = (n + MADD_THREADS - 1) / MADD_THREADS;
  madd_kernel<<<(unsigned)blocks, MADD_THREADS, 0, (cudaStream_t)stream>>>(
      make_field_const(consts), (const long long*)x, (const long long*)y, (const long long*)z,
      (const long long*)qx, (const long long*)qy, (long long*)ox, (long long*)oy, (long long*)oz, n);
  return (int)cudaGetLastError();
}

// t MSMs' bucket tables: scalars (t, n, 8), points (n, 8) in G groups of
// n / G, c-bit windows (B = 2^c - 1 <= 31 buckets), W = ceil(256 / c).
extern "C" int sirius_madd_buckets(const uint32_t* consts, const void* scalars, const void* px, const void* py,
                                   void* bx, void* by, void* bz, long long t, long long n, int W, int G, int c,
                                   void* stream) {
  if (c < 1 || c > 5 || G < 1 || n % G != 0) return (int)cudaErrorInvalidValue;
  const long long lanes = t * W * G;
  long long blocks = (lanes + BUCKET_THREADS - 1) / BUCKET_THREADS;
  madd_buckets_kernel<<<(unsigned)blocks, BUCKET_THREADS, 0, (cudaStream_t)stream>>>(
      make_field_const(consts), (const long long*)scalars, (const long long*)px, (const long long*)py,
      (long long*)bx, (long long*)by, (long long*)bz, n, W, G, c, lanes);
  return (int)cudaGetLastError();
}

// Registers, local (spill) bytes and static shared bytes of kernel `k`:
// 0 madd, 1 madd_buckets -> out[0], out[1], out[2].
extern "C" int sirius_madd_attrs(int k, long long* out) {
  cudaFuncAttributes attr;
  cudaError_t e;
  switch (k) {
    case 0: e = cudaFuncGetAttributes(&attr, madd_kernel); break;
    case 1: e = cudaFuncGetAttributes(&attr, madd_buckets_kernel); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  out[0] = attr.numRegs;
  out[1] = (long long)attr.localSizeBytes;
  out[2] = (long long)attr.sharedSizeBytes;
  return 0;
}
#endif
