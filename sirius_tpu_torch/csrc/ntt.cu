// B4: the column NTT of the four-step (Bailey) transform.
//
// Replaces the TPU kernel `sirius_tpu/ops/pallas_ntt.py:col_ntt_pallas`
// (body `_ladder_body`): for every column of a (size, R) block of field
// elements, the bit-reversal permutation along the size axis, then every
// radix-2 stage (stage s pairs positions i and i + 2^s, its twiddle for
// position k = i mod 2^s is table[k * size / 2^(s+1)]; stage 0 multiplies
// only when size == 2, its twiddle is w^0 = 1).  The four-step transform
// runs it twice (size n1 over R = n2 columns, then size n2 over R = n1); the
// flat transform of a small domain is one column (R = 1).
//
// The TPU kernel keeps a block of columns resident in VMEM for all
// log2(size) stages.  On the H100 a thread block holds C columns in shared
// memory (blocks of 256 threads where a column needs fewer; one column of
// 2048 or 4096) and the size/2 twiddles once for all C, and each thread
// keeps 2^W elements of its column in registers: the elements whose
// positions differ in the W bits of a window [s0, s0 + W).  A pass runs up
// to W stages (s0 .. s0 + W - 1) on them, 2^(W-1) independent butterflies
// per stage, then the threads exchange elements through shared memory so
// that the next pass holds the next window.  The first pass runs
// r0 = L - W (passes - 1) stages on the window [0, W), each later pass W.
// W = 2 up to columns of 1024 (4 elements, 64 registers, 4 blocks of 256 a
// SM: a column of 1024 runs 2 + 2 + 2 + 2 + 2 stages with 4 exchanges, 8
// barriers instead of 11) and W = 3 above (8 elements, the 512 threads of a
// column of 4096).  On the H100 a pass of 1024 x 1024 took 0.26 ms at W = 3
// (125 registers, 2 blocks a SM), 0.21 ms at W = 2 with 80 registers (3
// blocks) and 0.20 ms at 64 (4 blocks), ~1.2x its products at the rate S2
// measures for the carry-chain product.  The butterflies are the ladder's
// own, stage by stage, so the words equal the plain twin's.
//
// Layout, so that a warp's shared accesses fall on 32 distinct banks (for
// columns of 128 or more, a warp inside one column; 2-way on two twiddle
// passes at 4096):
// - elements word-major (word w of a column's slot x at w * size + x), the
//   slot of position i a permutation of its bits that puts the reader's
//   window on top and the rest in order (a reader's lanes then run over
//   consecutive slots), XORed with the window bits shifted onto the bank
//   bits that the writer's lanes leave fixed (ntt_slot);
// - twiddles word-major, slot x ^ ((x >> 5) & 31): a stage's lanes read
//   twiddles k * 2^e apart, and the XOR spreads e <= 5 onto distinct banks.
// Global loads and stores move whole 64-byte int64 rows in 16-byte loads
// (fe_load_ro); the first pass gathers its elements through `rev` straight
// from device memory, the last pass stores them straight to it.
//
// The epilogue variant (MID) multiplies each output (o1, column) by the
// four-step's mid twiddle T[o1 * n2 + i2] (i2 = column / rep, n2 = R / rep)
// and stores it transposed, at ((i2 * size + o1) * rep + column mod rep):
// the elementwise product and the transpose between the two passes ride in
// the first pass's store.
//
// What bounds it: (log2(size) - 1) * size/2 Montgomery products per column
// (on the carry-chain field ops of csrc/field.cuh), ~136 wide integer
// multiply-adds each by the paper count, against 2 * 32 bytes per element in
// canonical form: integer-multiply bound, by ~9x at size 1024.

#include "field.cuh"

// Butterfly of a stage on lo and hi with twiddle w (multiplied or not).
__device__ __forceinline__ void col_ntt_butterfly(Fe& lo, Fe& hi, const Fe& w, bool mul, const FieldConst& fc) {
  const Fe t = mul ? fe_mul_cc(hi, w, fc) : hi;
  const Fe u = lo;
  lo = fe_add_cc(u, t, fc);
  hi = fe_sub_cc(u, t, fc);
}

// Window bits W of a column of 2^L (each thread keeps 2^W elements and runs
// up to W stages between exchanges), threads of one column, and columns per
// block (blocks of COL_NTT_BLOCK threads where a column needs fewer).
#define COL_NTT_BLOCK 256
__host__ __device__ inline int col_ntt_window(int L) { return L <= 10 ? 2 : 3; }

__host__ __device__ inline int col_ntt_threads(int L) { return L < 3 ? 1 : 1 << (L - col_ntt_window(L)); }

__host__ __device__ inline long long col_ntt_columns(int L, long long R) {
  const long long t = col_ntt_threads(L), c = t >= COL_NTT_BLOCK ? 1 : COL_NTT_BLOCK / t;
  return c < R ? c : (R < 1 ? 1 : R);
}

// Position of thread g's element j in a pass whose window starts at s0.
template <int W>
__device__ __forceinline__ int col_ntt_index(int g, int j, int s0) {
  return (g & ((1 << s0) - 1)) | (j << s0) | ((g >> s0) << (s0 + W));
}

// Shared slot of position i in the buffer that a pass with window s0w and
// rw stages writes and the pass with window s0r reads.
template <int W>
__device__ __forceinline__ int ntt_slot(int i, int L, int s0r, int s0w, int rw) {
  const int top = (i >> s0r) & ((1 << W) - 1);
  const int phys = (i & ((1 << s0r) - 1)) | ((i >> (s0r + W)) << s0r) | (top << (L - W));
  return phys ^ ((top << s0w) >> (W - rw));
}

__device__ __forceinline__ int ntt_tw_slot(int x) { return x ^ ((x >> 5) & 31); }

__device__ __forceinline__ void col_ntt_tw_put(uint32_t* tw, int half, int x, const Fe& w) {
  const int sl = ntt_tw_slot(x);
#pragma unroll
  for (int k = 0; k < 8; ++k) tw[k * half + sl] = w.v[k];
}

__device__ __forceinline__ Fe col_ntt_tw_get(const uint32_t* tw, int half, int x) {
  const int sl = ntt_tw_slot(x);
  Fe w;
#pragma unroll
  for (int k = 0; k < 8; ++k) w.v[k] = tw[k * half + sl];
  return w;
}

// The first pass's elements of thread g in column col: positions
// 2^W g + j, rows rev[2^W g + j].
template <int W>
__device__ __forceinline__ void col_ntt_gather(Fe (&v)[1 << W], const long long* a, const long long* rev,
                                               long long R, long long col, int g) {
#pragma unroll
  for (int j = 0; j < (1 << W); ++j) {
#ifdef __CUDA_ARCH__
    const long long row = __ldg(rev + (g << W) + j);
#else
    const long long row = rev[(g << W) + j];
#endif
    v[j] = fe_load_ro(a, row * R + col);
  }
}

// The stages s0 .. s0 + nst - 1 (nst <= W) on thread g's window elements.
template <int W>
__device__ __forceinline__ void col_ntt_stages(Fe (&v)[1 << W], const uint32_t* tw, int L, int s0, int nst, int g,
                                               const FieldConst& fc) {
  const int half = 1 << (L - 1), glo = g & ((1 << s0) - 1);
#pragma unroll
  for (int q = 0; q < W; ++q) {
    if (q < nst) {
      const int s = s0 + q;
#pragma unroll
      for (int j = 0; j < (1 << W); ++j) {
        if ((j >> q) & 1) continue;
        const int k = glo + ((j & ((1 << q) - 1)) << s0);  // position mod 2^s
        const Fe w = col_ntt_tw_get(tw, half, k << (L - 1 - s));
        col_ntt_butterfly(v[j], v[j + (1 << q)], w, s > 0, fc);
      }
    }
  }
}

template <int W>
__device__ __forceinline__ void col_ntt_save(const Fe (&v)[1 << W], uint32_t* sm, int L, int s0w, int rw, int s0r,
                                             int g) {
  const int size = 1 << L;
#pragma unroll
  for (int j = 0; j < (1 << W); ++j) {
    const int sl = ntt_slot<W>(col_ntt_index<W>(g, j, s0w), L, s0r, s0w, rw);
#pragma unroll
    for (int k = 0; k < 8; ++k) sm[k * size + sl] = v[j].v[k];
  }
}

template <int W>
__device__ __forceinline__ void col_ntt_load(Fe (&v)[1 << W], const uint32_t* sm, int L, int s0w, int rw, int s0r,
                                             int g) {
  const int size = 1 << L;
#pragma unroll
  for (int j = 0; j < (1 << W); ++j) {
    const int sl = ntt_slot<W>(col_ntt_index<W>(g, j, s0r), L, s0r, s0w, rw);
#pragma unroll
    for (int k = 0; k < 8; ++k) v[j].v[k] = sm[k * size + sl];
  }
}

// Output position o of column col: as is, or (MID) times T and transposed.
template <bool MID>
__device__ __forceinline__ void col_ntt_put(long long* out, const long long* mid, Fe x, long long o, int L,
                                            long long R, long long col, long long rep, const FieldConst& fc) {
  if (MID) {
    const long long i2 = col / rep, ro = col - i2 * rep;
    x = fe_mul_cc(x, fe_load_ro(mid, o * (R / rep) + i2), fc);
    fe_store_v(out, ((i2 << L) + o) * rep + ro, x);
  } else {
    fe_store_v(out, o * R + col, x);
  }
}

// Columns of 1, 2 or 4 elements: one thread runs the ladder in registers.
template <bool MID>
__device__ __forceinline__ void col_ntt_small(const FieldConst& fc, const long long* a, const long long* rev,
                                              const long long* table, const long long* mid, long long* out, int L,
                                              long long R, long long col, long long rep) {
  const int size = 1 << L;
  Fe v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (i < size) v[i] = fe_load_ro(a, rev[i] * R + col);
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (s < L && !((i >> s) & 1) && i + (1 << s) < size)
        col_ntt_butterfly(v[i], v[i + (1 << s)], fe_load_ro(table, (i & ((1 << s) - 1)) << (L - 1 - s)),
                          s > 0 || size == 2, fc);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (i < size) col_ntt_put<MID>(out, mid, v[i], i, L, R, col, rep, fc);
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

extern __shared__ uint32_t col_ntt_smem[];

// Block: C columns x col_ntt_threads(L) threads; dynamic shared memory
// (size/2 + C size) * 32 bytes: the twiddles, then each column.
template <int W, bool MID>
__global__ void __launch_bounds__(W == 3 ? 512 : COL_NTT_BLOCK, W == 3 ? 1 : 4)
    col_ntt_kernel(FieldConst fc, const long long* a, const long long* rev, const long long* table,
                   const long long* mid, long long* out, int L, long long R, long long rep) {
  const int T = col_ntt_threads(L);
  const int c = threadIdx.x / T, g = threadIdx.x % T;
  const long long col = (long long)blockIdx.x * (blockDim.x / T) + c;
  const bool live = col < R;
  if (L < 3) {
    if (live) col_ntt_small<MID>(fc, a, rev, table, mid, out, L, R, col, rep);
    return;
  }
  const int half = 1 << (L - 1), passes = (L + W - 1) / W, r0 = L - W * (passes - 1);
  uint32_t* tw = col_ntt_smem;
  uint32_t* sm = col_ntt_smem + 8 * half + (c << (L + 3));
  for (int x = threadIdx.x; x < half; x += blockDim.x) col_ntt_tw_put(tw, half, x, fe_load_ro(table, x));
  Fe v[1 << W];
  if (live) col_ntt_gather<W>(v, a, rev, R, col, g);
  __syncthreads();
  int s0 = 0, nst = r0;
#pragma unroll 1
  for (int p = 0; p < passes; ++p) {
    if (live) col_ntt_stages<W>(v, tw, L, s0, nst, g, fc);
    if (p + 1 == passes) break;
    const int s0r = s0 + nst;
    if (p > 0) __syncthreads();  // every thread has read this pass's elements
    if (live) col_ntt_save<W>(v, sm, L, s0, nst, s0r, g);
    __syncthreads();
    if (live) col_ntt_load<W>(v, sm, L, s0, nst, s0r, g);
    s0 = s0r;
    nst = W;
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < (1 << W); ++j)
      col_ntt_put<MID>(out, mid, v[j], col_ntt_index<W>(g, j, s0), L, R, col, rep, fc);
  }
}

// ---- host launchers ----
// mid: the (size * R / rep, 8) mid twiddle for the epilogue variant, or null.
extern "C" int sirius_col_ntt(const uint32_t* consts, const void* a, const void* rev, const void* table,
                              const void* mid, void* out, long long size, long long R, long long rep, void* stream) {
  int L = 0;
  while ((1LL << L) < size) ++L;
  const long long C = col_ntt_columns(L, R);
  const int threads = (int)(C * col_ntt_threads(L));
  const size_t smem = L < 3 ? 0 : (size_t)(size / 2 + C * size) * sizeof(Fe);
  const unsigned blocks = (unsigned)((R + C - 1) / C);
  const FieldConst fc = make_field_const(consts);
  cudaStream_t st = (cudaStream_t)stream;
  const long long* pa = (const long long*)a;
  const long long* prev = (const long long*)rev;
  const long long* pt = (const long long*)table;
  const long long* pm = (const long long*)mid;
  long long* po = (long long*)out;
  const bool w3 = col_ntt_window(L) == 3;
  auto kernel = mid ? (w3 ? col_ntt_kernel<3, true> : col_ntt_kernel<2, true>)
                    : (w3 ? col_ntt_kernel<3, false> : col_ntt_kernel<2, false>);
  // set on every call, for the current device (the wrapper's): each device that launches gets it
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<blocks, threads, smem, st>>>(fc, pa, prev, pt, pm, po, L, R, rep);
  return (int)cudaGetLastError();
}

// Registers, local (spill) bytes, static shared bytes of the kernel that a
// column of 1024 runs (which = 0) or of its epilogue variant (which = 1).
extern "C" int sirius_col_ntt_attrs(int which, void* out) {
  cudaFuncAttributes fa;
  const bool w3 = col_ntt_window(10) == 3;
  cudaError_t e = cudaFuncGetAttributes(
      &fa, which ? (w3 ? col_ntt_kernel<3, true> : col_ntt_kernel<2, true>)
                 : (w3 ? col_ntt_kernel<3, false> : col_ntt_kernel<2, false>));
  if (e != cudaSuccess) return (int)e;
  long long* o = (long long*)out;
  o[0] = fa.numRegs;
  o[1] = (long long)fa.localSizeBytes;
  o[2] = (long long)fa.sharedSizeBytes;
  return 0;
}
#endif
