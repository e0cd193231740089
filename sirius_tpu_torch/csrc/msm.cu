// B2 + B3: Pippenger MSM over distinct affine key points.
//
// Replaces the TPU kernels `sirius_tpu/ops/pallas_msm.py:_msm_table_kernel`
// (B2: bucket accumulation into a VMEM-resident one-hot bucket table) and
// `sirius_tpu/ops/pallas_msm.py:_merge_kernel` (B3: the 1024 -> 1 group
// merge, followed there by XLA suffix sums and a Horner window combine).
//
// The TPU design keeps a (W, 16, B, 8, 128) table in VMEM and selects a
// bucket row by one-hot masks because it has no cheap scatter.  A GPU has
// neither the VMEM nor the need: the wrapper sorts the live (window, point)
// digits by bucket with `torch.sort`, so every bucket is one contiguous
// segment, cut into fixed-length chunks.
//
//   msm_accumulate (B2)  one thread per chunk walks its points with the
//                        incomplete mixed add (y negated for a negative
//                        signed digit) and writes one Jacobian partial.
//   msm_reduce     (B3)  one thread per (window, bucket) segment sums its
//                        chunk partials with the complete add.
//   msm_combine    (B3)  one block per MSM, one thread per window: the
//                        running sum gives sum_v v*B_v; then thread 0 runs
//                        the Horner combine (c doublings per window) into one
//                        Jacobian point.
//   msm_reduce_rolled (S1) msm_reduce with the rolled CIOS product
//                        (`csrc/field.cuh` fe_mul_t<true>): replaces
//                        `scripts/msm_lab2.py:_merge_call_variant`, B3's merge
//                        kept for its smaller code (the TPU's
//                        `KF(roll_mul=True)`).  Same function and add order as
//                        msm_reduce, so the two agree word for word; on the
//                        H100 the rolled loop trades registers and
//                        instruction-cache footprint for loop overhead.
//
// What bounds it on the H100: accumulate is ~W*n mixed adds of ~1,400
// integer multiply-adds each (integer-multiply bound) plus a random 128-byte
// gather of each point per window (the key stays in the 50 MB L2 up to
// ~2^17 points); chunks make the work per thread uniform whatever the digit
// skew.  reduce and combine are latency bound on few threads and small next
// to accumulate at the commit sizes of the main path.  Dead (zero) digits
// never enter a chunk, so no padding reaches the incomplete add.

#include "curve.cuh"

__device__ __forceinline__ void accumulate_row(const FieldConst& fc, const long long* entries,
                                               const long long* chunk_start, const long long* chunk_len,
                                               const long long* px, const long long* py, long long* ox,
                                               long long* oy, long long* oz, long long i) {
  Pt acc = pt_identity(fc);
  const long long s = chunk_start[i];
  const long long len = chunk_len[i];
  for (long long k = 0; k < len; ++k) {
    const long long e = entries[s + k];  // point index * 2 + negated
    const long long idx = e >> 1;
    Fe qy = fe_load(py, idx);
    if (e & 1) qy = fe_neg(qy, fc);
    acc = pt_madd(acc, fe_load(px, idx), qy, fc);
  }
  pt_store(ox, oy, oz, i, acc);
}

template <bool ROLLED>
__device__ __forceinline__ void reduce_row_t(const FieldConst& fc, const long long* seg_off, const long long* px,
                                             const long long* py, const long long* pz, long long* ox,
                                             long long* oy, long long* oz, long long i) {
  Pt acc = pt_identity(fc);
  for (long long k = seg_off[i]; k < seg_off[i + 1]; ++k) acc = pt_add_t<ROLLED>(acc, pt_load(px, py, pz, k), fc);
  pt_store(ox, oy, oz, i, acc);
}

__device__ __forceinline__ void reduce_row(const FieldConst& fc, const long long* seg_off, const long long* px,
                                           const long long* py, const long long* pz, long long* ox,
                                           long long* oy, long long* oz, long long i) {
  reduce_row_t<false>(fc, seg_off, px, py, pz, ox, oy, oz, i);
}

// Window total sum_{v=1..B} v * B_v of window w of MSM m, via the running sum.
__device__ __forceinline__ void combine_window(const FieldConst& fc, const long long* bx, const long long* by,
                                               const long long* bz, long long* tx, long long* ty,
                                               long long* tz, int W, int B, int m, int w) {
  Pt run = pt_identity(fc);
  Pt tot = pt_identity(fc);
  const long long base = ((long long)m * W + w) * B;
  for (int v = B; v >= 1; --v) {
    run = pt_add(run, pt_load(bx, by, bz, base + v - 1), fc);
    tot = pt_add(tot, run, fc);
  }
  pt_store(tx, ty, tz, (long long)m * W + w, tot);
}

// Horner over the window totals of MSM m, most significant window first.
__device__ __forceinline__ void combine_horner(const FieldConst& fc, const long long* tx, const long long* ty,
                                               const long long* tz, long long* ox, long long* oy,
                                               long long* oz, int W, int c, int m) {
  const long long base = (long long)m * W;
  Pt acc = pt_load(tx, ty, tz, base + W - 1);
  for (int w = W - 2; w >= 0; --w) {
    for (int k = 0; k < c; ++k) acc = pt_dbl(acc, fc);
    acc = pt_add(acc, pt_load(tx, ty, tz, base + w), fc);
  }
  pt_store(ox, oy, oz, m, acc);
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

__global__ void msm_accumulate_kernel(FieldConst fc, const long long* entries, const long long* chunk_start,
                                      const long long* chunk_len, const long long* px, const long long* py,
                                      long long* ox, long long* oy, long long* oz, long long n_chunks) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_chunks) accumulate_row(fc, entries, chunk_start, chunk_len, px, py, ox, oy, oz, i);
}

template <bool ROLLED>
__global__ void msm_reduce_kernel(FieldConst fc, const long long* seg_off, const long long* px,
                                  const long long* py, const long long* pz, long long* ox, long long* oy,
                                  long long* oz, long long n_seg) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_seg) reduce_row_t<ROLLED>(fc, seg_off, px, py, pz, ox, oy, oz, i);
}

__global__ void msm_combine_kernel(FieldConst fc, const long long* bx, const long long* by, const long long* bz,
                                   long long* tx, long long* ty, long long* tz, long long* ox, long long* oy,
                                   long long* oz, int W, int B, int c) {
  const int m = blockIdx.x;
  const int w = threadIdx.x;
  if (w < W) combine_window(fc, bx, by, bz, tx, ty, tz, W, B, m, w);
  __syncthreads();  // window totals of this block visible to thread 0
  if (w == 0) combine_horner(fc, tx, ty, tz, ox, oy, oz, W, c, m);
}

extern "C" int sirius_msm_accumulate(const uint32_t* consts, const void* entries, const void* chunk_start,
                                     const void* chunk_len, const void* px, const void* py, void* ox, void* oy,
                                     void* oz, long long n_chunks, void* stream) {
  const int threads = 128;
  long long blocks = (n_chunks + threads - 1) / threads;
  msm_accumulate_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      make_field_const(consts), (const long long*)entries, (const long long*)chunk_start,
      (const long long*)chunk_len, (const long long*)px, (const long long*)py, (long long*)ox,
      (long long*)oy, (long long*)oz, n_chunks);
  return (int)cudaGetLastError();
}

template <bool ROLLED>
static int launch_reduce(const uint32_t* consts, const void* seg_off, const void* px, const void* py, const void* pz,
                         void* ox, void* oy, void* oz, long long n_seg, void* stream) {
  const int threads = 128;
  long long blocks = (n_seg + threads - 1) / threads;
  msm_reduce_kernel<ROLLED><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      make_field_const(consts), (const long long*)seg_off, (const long long*)px, (const long long*)py,
      (const long long*)pz, (long long*)ox, (long long*)oy, (long long*)oz, n_seg);
  return (int)cudaGetLastError();
}

extern "C" int sirius_msm_reduce(const uint32_t* consts, const void* seg_off, const void* px, const void* py,
                                 const void* pz, void* ox, void* oy, void* oz, long long n_seg, void* stream) {
  return launch_reduce<false>(consts, seg_off, px, py, pz, ox, oy, oz, n_seg, stream);
}

extern "C" int sirius_msm_reduce_rolled(const uint32_t* consts, const void* seg_off, const void* px, const void* py,
                                        const void* pz, void* ox, void* oy, void* oz, long long n_seg,
                                        void* stream) {
  return launch_reduce<true>(consts, seg_off, px, py, pz, ox, oy, oz, n_seg, stream);
}

// Registers per thread and local (spill) bytes per thread of msm_reduce
// (rolled = 0) or msm_reduce_rolled (rolled = 1): out[0], out[1].
extern "C" int sirius_msm_reduce_attrs(int rolled, long long* out) {
  cudaFuncAttributes attr;
  cudaError_t e = rolled ? cudaFuncGetAttributes(&attr, msm_reduce_kernel<true>)
                         : cudaFuncGetAttributes(&attr, msm_reduce_kernel<false>);
  if (e != cudaSuccess) return (int)e;
  out[0] = attr.numRegs;
  out[1] = (long long)attr.localSizeBytes;
  return 0;
}

extern "C" int sirius_msm_combine(const uint32_t* consts, const void* bx, const void* by, const void* bz,
                                  void* tx, void* ty, void* tz, void* ox, void* oy, void* oz, int n_msm, int W,
                                  int B, int c, void* stream) {
  const int threads = ((W + 31) / 32) * 32;
  msm_combine_kernel<<<n_msm, threads, 0, (cudaStream_t)stream>>>(
      make_field_const(consts), (const long long*)bx, (const long long*)by, (const long long*)bz,
      (long long*)tx, (long long*)ty, (long long*)tz, (long long*)ox, (long long*)oy, (long long*)oz, W, B, c);
  return (int)cudaGetLastError();
}
#endif
