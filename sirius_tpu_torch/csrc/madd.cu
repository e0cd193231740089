// B1: batched incomplete mixed EC addition (madd-2007-bl).
//
// Replaces the TPU kernel `sirius_tpu/ops/pallas_madd.py:_madd_kernel`
// (core `sirius_tpu/ops/limb_kernels.py:k_madd_incomplete`).
//
// On the H100 one madd is ~11 Montgomery products of 8x8 32-bit words: about
// 1,400 integer multiply-adds against 232 bytes of int64-word traffic per
// point, so it is bound by the SM's integer multiply rate, not by memory.
// Design: one thread per point with the whole formula in registers (no
// shared memory, no cross-thread traffic); words are read and written in the
// port's (n, 8) int64 layout so the wrapper passes tensors without a copy.
// Output is bit-identical to the plain torch twin and to the JAX function.

#include "curve.cuh"

__device__ __forceinline__ void madd_row(const FieldConst& fc, const long long* x, const long long* y,
                                         const long long* z, const long long* qx, const long long* qy,
                                         long long* ox, long long* oy, long long* oz, long long i) {
  Pt P = pt_load(x, y, z, i);
  Pt R = pt_madd(P, fe_load(qx, i), fe_load(qy, i), fc);
  pt_store(ox, oy, oz, i, R);
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

__global__ void madd_kernel(FieldConst fc, const long long* x, const long long* y, const long long* z,
                            const long long* qx, const long long* qy, long long* ox, long long* oy,
                            long long* oz, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) madd_row(fc, x, y, z, qx, qy, ox, oy, oz, i);
}

extern "C" int sirius_madd(const uint32_t* consts, const void* x, const void* y, const void* z,
                           const void* qx, const void* qy, void* ox, void* oy, void* oz, long long n,
                           void* stream) {
  const int threads = 128;
  long long blocks = (n + threads - 1) / threads;
  madd_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      make_field_const(consts), (const long long*)x, (const long long*)y, (const long long*)z,
      (const long long*)qx, (const long long*)qy, (long long*)ox, (long long*)oy, (long long*)oz, n);
  return (int)cudaGetLastError();
}
#endif
