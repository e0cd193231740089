// B2 + B3: Pippenger MSM over distinct affine key points.
//
// Replaces the TPU kernels `sirius_tpu/ops/pallas_msm.py:_msm_table_kernel`
// (B2: bucket accumulation into a VMEM-resident one-hot bucket table) and
// `sirius_tpu/ops/pallas_msm.py:_merge_kernel` (B3: the 1024 -> 1 group
// merge, followed there by XLA suffix sums and a Horner window combine).
//
// The TPU design keeps a (W, 16, B, 8, 128) table in VMEM and selects a
// bucket row by one-hot masks because it has no cheap scatter.  A GPU has
// neither the VMEM nor the need: a counting sort puts the live (window,
// point) digits in bucket order, so every bucket is one contiguous segment,
// cut into fixed-length chunks.
//
//   bucket sort     (B2)  `ops/msm.py:bucket_plan` on the card: one thread
//                         per scalar writes its signed digits (16 bits
//                         each); one warp per (window, tile of 2048 points)
//                         counts its live digits per bucket in shared
//                         memory; torch scans the (bucket, tile) counts;
//                         the same warps scatter each entry to its place,
//                         32 points at a time in order, lanes of one bucket
//                         ranked by `__match_any_sync` (stable: the order of
//                         the torch sort it replaces); one thread per chunk
//                         finds its segment by binary search.
//   msm_accumulate  (B2)  one thread per chunk walks its points with the
//                         incomplete mixed add (y negated for a negative
//                         signed digit) and writes one Jacobian partial; the
//                         first point seeds the sum (no add onto the
//                         identity), the next point is loaded during a
//                         madd, the madd runs on the PTX carry-chain field
//                         ops, and 3 blocks a SM (at most 168 registers,
//                         no spill) beat 4 (128, spilling) and 5.
//   msm_reduce      (B3)  segments of at most FAN_IN = 32 partials, summed
//                         by a pairwise tree in shared memory: a block
//                         takes the segments that start in its span of 128
//                         partials (at most 159 partials, 160 threads), one
//                         thread per partial; level h adds element i + h of
//                         a segment onto element i < h, h = 16 .. 1, the
//                         halving order of the plain twin's `sum_reduce`
//                         over the segment padded to a power of two, so the
//                         two agree word for word.
//   msm_window_sums (B3)  one block per (MSM, window), one thread per
//                         segment of L buckets (L a power of two, S =
//                         ceil(B / L) <= 128 segments, the last ragged):
//                         thread s walks its buckets top-down for its run
//                         R_s and local weighted sum T_s = sum (v - sL) B_v;
//                         a log-depth suffix scan in shared memory gives
//                         P_s = sum_{s' >= s} R_s', each thread adds L * P_s
//                         (log2 L doublings) onto T_s, and a tree sums the
//                         S results: sum_v v B_v = sum_s T_s + L sum_s s R_s.
//   msm_horner      (B3)  one block per MSM: the window totals are staged
//                         in shared memory; thread j runs the Horner of its
//                         group of K ~ sqrt(W) windows (the lowest group
//                         ragged), then thread 0 the Horner over the groups
//                         (c K doublings per group).  The chain is c (W - 1)
//                         doublings, as before, but (K - 1) + (G - 1) adds
//                         instead of W - 1.
//   msm_reduce_rolled (S1) replaces `scripts/msm_lab2.py:_merge_call_variant`,
//                         B3's merge on the rolled product (the TPU's
//                         `KF(roll_mul=True)`): here the rolled carry-chain
//                         product `fe_mul_n` (`csrc/field.cuh`, B3's) under
//                         pt_add_ilp.  Segments of any length are cut into
//                         pieces of at most ROLLED_SPAN partials from their
//                         start; a block of ROLLED_THREADS takes the pieces
//                         that start in its span of ROLLED_SPAN partials (at
//                         most 2 ROLLED_SPAN - 1 of them) into shared memory
//                         and sums each by a pairwise tree, level h adding
//                         offset o + h onto o = 0 mod 2h.  Each level's live
//                         pairs are enumerated by warp ballots and a prefix
//                         count in shared memory and handed to the warps 32
//                         at a time, so a warp with no pair skips the level
//                         (msm_reduce's idle lanes issue every level).  A
//                         segment longer than ROLLED_SPAN leaves
//                         ceil(len / ROLLED_SPAN) pieces, which a further
//                         launch of the same kernel sums
//                         (`ops/msm_kernels.py:rolled_passes`).  Its add
//                         order differs from the plain twin's, so it equals
//                         msm_reduce in affine form only.
//
// What bounds them on the H100: accumulate is ~W*n mixed adds of 11
// products each (integer-multiply bound: each product issues 278 IMAD-class
// instructions on the carry chains, one 32x32 -> 64 product being an IMAD
// and an IMAD.HI) plus a random 128-byte gather of each point per window
// (the key stays in the 50 MB L2 up to ~2^17 points); chunks make the work
// per thread uniform whatever the digit skew.  The sort moves ~2 bytes a
// digit three times and a 8-byte entry once: memory bound, far below the
// accumulate.  reduce, window sums and Horner do little work (a few hundred to a
// few ten thousand complete adds) on dependent chains: the latency of one
// thread's chain of Montgomery products bounds them, not the card's rate
// (one dependent product takes ~1,600 SM cycles in C++ unrolled, ~2,000
// rolled, ~1,550 on the carry chains: chip_smoke's latency probe).  So they cut the chain (reduce: 5 adds
// instead of up to 31; window sums: 2L + 2 log2 S + 1 adds and log2 L
// doublings instead of 2B adds; Horner: (K - 1) + (G - 1) adds instead of
// W - 1), fill more SMs (reduce: ~900 blocks of 5 warps at the primary
// commit's first level), keep the values a chain reads in shared memory,
// and run the point ops with their independent products interleaved
// (`csrc/curve.cuh` pt_add_ilp, pt_dbl_ilp: 5 and 3 dependency levels
// instead of 16 and 7 products) on the rolled carry-chain product's loop
// body (`fe_mul_n`), which keeps the code small (the unrolled complete add
// inlines ~4,600 instructions at every call site; S1's rolled serial
// reduce ran in 0.60x the unrolled one's time; the carry chains cut the
// combine's time by a quarter against the rolled C++ product, the unrolled
// carry chains by a tenth).  The Horner's c (W - 1) doublings remain its
// floor.  Dead (zero) digits never enter a chunk, so no padding reaches the
// incomplete add.  S1 does the reduce's adds (~102,000 at the primary W
// commit's level 0) where its lab did: on the rolled product, whose
// throughput bounds it (~15 G products/s under pt_add_ilp on an H100 80GB
// HBM3 at 700 W, msm_turns.py's 747,410-partial level: half the unrolled
// carry chain's S2 rate); the compacted tree keeps the warps that issue
// busy, and at that shape a block's five levels of adds add their latency.

#include "curve.cuh"

constexpr long long CHUNK = 32;                       // entries per accumulate chunk (ops/msm.py CHUNK)
constexpr int SORT_TILE = 2048;                       // points of one window per bucket-sort warp
constexpr int SORT_WARPS = 8;                         // warps per bucket-sort block
constexpr int SORT_MAX_B = 512;                       // buckets per window: c <= 10
constexpr int ACCUMULATE_THREADS = 128;               // chunks per accumulate block
constexpr int ACCUMULATE_MIN_BLOCKS = 3;              // resident blocks per SM: at most 168 registers a thread
constexpr int REDUCE_SPAN = 128;                      // segment starts per reduce block
constexpr int REDUCE_MAX_SEG = 32;                    // longest segment the tree takes (FAN_IN)
constexpr int REDUCE_THREADS = REDUCE_SPAN + REDUCE_MAX_SEG;  // 127 + 32 partials at most
constexpr int WINDOW_THREADS = 128;                   // most segments per window
constexpr int HORNER_GROUPS = 32;                     // most window groups per MSM
constexpr int ROLLED_SPAN = 256;                      // S1: piece starts per block, the longest piece
constexpr int ROLLED_THREADS = 128;                   // S1: threads per block
constexpr int ROLLED_SLOTS = 2 * ROLLED_SPAN - 1;     // S1: partials a block holds at most
constexpr int ROLLED_ROUNDS = (ROLLED_SLOTS + ROLLED_THREADS - 1) / ROLLED_THREADS;  // slots a thread enumerates

// B2: chunk i's entries (point index * 2 + negated) summed in order.  The
// first entry seeds the accumulator (a madd onto the identity gives the
// point itself); the next entry's point is loaded while a madd runs.
__device__ __forceinline__ void accumulate_row(const FieldConst& fc, const long long* entries,
                                               const long long* chunk_start, const long long* chunk_len,
                                               const long long* px, const long long* py, long long* ox,
                                               long long* oy, long long* oz, long long i) {
  const long long s = chunk_start[i];
  const long long len = chunk_len[i];
  if (len <= 0) {
    pt_store(ox, oy, oz, i, pt_identity(fc));
    return;
  }
  long long e = entries[s];
  Pt acc;
  acc.x = fe_load_ro(px, e >> 1);
  acc.y = fe_load_ro(py, e >> 1);
  if (e & 1) acc.y = fe_sub_cc(fe_zero(), acc.y, fc);
  acc.z = fe_one(fc);
  Fe nx = acc.x, ny = acc.y;
  if (len > 1) {
    e = entries[s + 1];
    nx = fe_load_ro(px, e >> 1);
    ny = fe_load_ro(py, e >> 1);
  }
#pragma unroll 1
  for (long long k = 1; k < len; ++k) {
    const Fe qx = nx;
    Fe qy = ny;
    const bool neg = e & 1;
    if (k + 1 < len) {  // in flight during the madd below
      e = entries[s + k + 1];
      nx = fe_load_ro(px, e >> 1);
      ny = fe_load_ro(py, e >> 1);
    }
    if (neg) qy = fe_sub_cc(fe_zero(), qy, fc);
    acc = pt_madd(acc, qx, qy, fc);
  }
  pt_store(ox, oy, oz, i, acc);
}

// The bucket sort's first pass, scalar i: bucket_plan's signed c-bit digits
// (W0 = ceil(256 / c) windows; a window value v = digit + carry above
// 2^(c-1) becomes 2^c - v, negated, with a carry into the next window;
// window W0 holds the last carry), stored as magnitude * 2 + negated in
// digits[w n + i].
__device__ __forceinline__ void signed_digits_row(const long long* scalars, unsigned short* digits, long long n,
                                                  int c, long long i) {
  const long long* s = scalars + i * 8;
  const int W0 = (256 + c - 1) / c;
  const uint32_t half = 1u << (c - 1), full = 1u << c;
  uint32_t carry = 0u;
  for (int w = 0; w < W0; ++w) {
    const uint32_t v = window_digit(s, w, c) + carry;
    carry = v > half ? 1u : 0u;
    const uint32_t mag = carry ? full - v : v;
    digits[(long long)w * n + i] = (unsigned short)(mag << 1 | carry);
  }
  digits[(long long)W0 * n + i] = (unsigned short)(carry << 1);
}

// First index i in [0, n) with v[i] >= x (n when there is none).
__device__ __forceinline__ long long lower_bound(const long long* v, long long n, long long x) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (v[mid] < x) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// The bucket sort's last pass, chunk q: its segment s (the last with
// seg_off[s] <= q) and its place j in it.
__device__ __forceinline__ void chunk_row(const long long* seg_off, const long long* seg_start,
                                          const long long* seg_count, long long* chunk_start, long long* chunk_len,
                                          long long n_seg, long long q) {
  const long long s = lower_bound(seg_off, n_seg + 1, q + 1) - 1;
  const long long j = q - seg_off[s];
  chunk_start[q] = seg_start[s] + j * CHUNK;
  const long long left = seg_count[s] - j * CHUNK;
  chunk_len[q] = left < CHUNK ? left : CHUNK;
}

// S1: the first piece start at or after x in [seg_off[0], hi), hi =
// seg_off[n_seg]: pieces are cut every ROLLED_SPAN partials from the start
// of each segment (hi when there is none).
__device__ __forceinline__ long long rolled_piece_from(const long long* seg_off, long long n_seg, long long hi,
                                                       long long x) {
  if (x >= hi) return hi;
  const long long s = lower_bound(seg_off, n_seg + 1, x + 1) - 1;  // seg_off[s] <= x < seg_off[s + 1]
  const long long c = seg_off[s] + (x - seg_off[s] + ROLLED_SPAN - 1) / ROLLED_SPAN * ROLLED_SPAN;
  return c < seg_off[s + 1] ? c : seg_off[s + 1];
}

// n doublings (a rolled loop: one copy of the doubling's code).
__device__ __forceinline__ Pt pt_dbl_n(Pt P, int n, const FieldConst& fc) {
#pragma unroll 1
  for (int k = 0; k < n; ++k) P = pt_dbl_ilp(P, fc);
  return P;
}

// Segment s of a window's buckets b[base .. base + B): buckets v = sL + 1 ..
// min(sL + L, B) walked top-down; run = R_s = sum B_v, tot = T_s = sum (v - sL) B_v.
__device__ __forceinline__ void window_segment(const FieldConst& fc, const long long* bx, const long long* by,
                                               const long long* bz, long long base, int B, int L, int s, Pt& run,
                                               Pt& tot) {
  run = pt_identity(fc);
  tot = pt_identity(fc);
  const int lo = s * L;
  const int hi = lo + L < B ? lo + L : B;
#pragma unroll 1
  for (int v = hi; v > lo; --v) {
    run = pt_add_ilp(run, pt_load(bx, by, bz, base + v - 1), fc);
    tot = pt_add_ilp(tot, run, fc);
  }
}

// Horner over totals t[lo .. hi), most significant first: sum 2^(c (w - lo)) t[w].
__device__ __forceinline__ Pt horner_group(const FieldConst& fc, const Pt* t, int lo, int hi, int c) {
  Pt acc = t[hi - 1];
#pragma unroll 1
  for (int w = hi - 2; w >= lo; --w) acc = pt_add_ilp(pt_dbl_n(acc, c, fc), t[w], fc);
  return acc;
}

// Window range [lo, hi) of group j of W windows in groups of K, the lowest
// group holding the r = W - (G - 1) K windows left over.
__device__ __forceinline__ void horner_range(int W, int K, int j, int& lo, int& hi) {
  const int G = (W + K - 1) / K;
  const int r = W - (G - 1) * K;
  lo = j == 0 ? 0 : r + (j - 1) * K;
  hi = j == 0 ? r : lo + K;
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

__global__ void msm_signed_digits_kernel(const long long* scalars, unsigned short* digits, long long n, int c) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) signed_digits_row(scalars, digits, n, c, i);
}

// One warp per (window w, tile of SORT_TILE points): the live digits of
// each bucket in the tile, into counts[(w B + b) ntiles + tile].
__global__ void __launch_bounds__(SORT_WARPS * 32)
    msm_bucket_count_kernel(const unsigned short* digits, int* counts, long long n, int W, int B, long long ntiles) {
  __shared__ int hist[SORT_WARPS][SORT_MAX_B];
  const int wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long job = (long long)blockIdx.x * SORT_WARPS + wid;  // w ntiles + tile
  if (job >= (long long)W * ntiles) return;
  int* h = hist[wid];
  for (int b = lane; b < B; b += 32) h[b] = 0;
  __syncwarp();
  const long long w = job / ntiles, tile = job % ntiles;
  const long long lo = tile * SORT_TILE, hi = lo + SORT_TILE < n ? lo + SORT_TILE : n;
  const unsigned short* d = digits + w * n;
  for (long long i = lo + lane; i < hi; i += 32) {
    const int mag = d[i] >> 1;
    if (mag) atomicAdd(&h[mag - 1], 1);
  }
  __syncwarp();
  for (int b = lane; b < B; b += 32) counts[(w * B + b) * ntiles + tile] = h[b];
}

// The same warps again: each live digit's entry (point index * 2 + negated)
// written at its bucket's next place, offs[(w B + b) ntiles + tile] being
// where the tile's run of bucket b starts.  The warp walks its tile 32
// points at a time in order, and lanes of one bucket take their places in
// lane order, so each bucket keeps point order: the stable sort.
__global__ void __launch_bounds__(SORT_WARPS * 32)
    msm_bucket_scatter_kernel(const unsigned short* digits, const long long* offs, long long* entries, long long n,
                              int W, int B, long long ntiles) {
  __shared__ long long next[SORT_WARPS][SORT_MAX_B];
  const int wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long job = (long long)blockIdx.x * SORT_WARPS + wid;
  if (job >= (long long)W * ntiles) return;
  long long* h = next[wid];
  const long long w = job / ntiles, tile = job % ntiles;
  for (int b = lane; b < B; b += 32) h[b] = offs[(w * B + b) * ntiles + tile];
  __syncwarp();
  const long long lo = tile * SORT_TILE, hi = lo + SORT_TILE < n ? lo + SORT_TILE : n;
  const unsigned short* d = digits + w * n;
  const unsigned below = (1u << lane) - 1u;
  for (long long i0 = lo; i0 < hi; i0 += 32) {
    const long long i = i0 + lane;
    const unsigned dg = i < hi ? d[i] : 0u;
    const int mag = (int)(dg >> 1);
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, mag);
    const int rank = __popc(peers & below);
    if (mag) entries[h[mag - 1] + rank] = i * 2 + (dg & 1u);
    __syncwarp();
    if (mag && rank == 0) h[mag - 1] += __popc(peers);
    __syncwarp();
  }
}

__global__ void msm_bucket_chunks_kernel(const long long* seg_off, const long long* seg_start,
                                         const long long* seg_count, long long* chunk_start, long long* chunk_len,
                                         long long n_seg, long long n_chunks) {
  long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q < n_chunks) chunk_row(seg_off, seg_start, seg_count, chunk_start, chunk_len, n_seg, q);
}

__global__ void __launch_bounds__(ACCUMULATE_THREADS, ACCUMULATE_MIN_BLOCKS)
    msm_accumulate_kernel(FieldConst fc, const long long* entries, const long long* chunk_start,
                          const long long* chunk_len, const long long* px, const long long* py, long long* ox,
                          long long* oy, long long* oz, long long n_chunks) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_chunks) accumulate_row(fc, entries, chunk_start, chunk_len, px, py, ox, oy, oz, i);
}

__global__ void __launch_bounds__(REDUCE_THREADS) msm_reduce_kernel(FieldConst fc, const long long* seg_off,
                                                                    const long long* px, const long long* py,
                                                                    const long long* pz, long long* ox,
                                                                    long long* oy, long long* oz, long long n_seg) {
  __shared__ Pt sh[REDUCE_THREADS];
  const int tid = threadIdx.x;
  // empty segments give the identity (the tree below never sees them)
  for (long long q = (long long)blockIdx.x * blockDim.x + tid; q < n_seg; q += (long long)gridDim.x * blockDim.x)
    if (seg_off[q] == seg_off[q + 1]) pt_store(ox, oy, oz, q, pt_identity(fc));

  // the run of the segments that start in [span0, span0 + REDUCE_SPAN)
  const long long span0 = (long long)blockIdx.x * REDUCE_SPAN;
  const long long run_start = seg_off[lower_bound(seg_off, n_seg, span0)];
  const long long run_end = seg_off[lower_bound(seg_off, n_seg, span0 + REDUCE_SPAN)];
  const long long p = run_start + tid;
  const bool live = p < run_end;
  long long s = 0, start = 0, end = 0;
  Pt x = pt_identity(fc);
  if (live) {
    s = lower_bound(seg_off, n_seg, p + 1) - 1;  // the last segment starting at or before p
    start = seg_off[s];
    end = seg_off[s + 1];
    x = pt_load(px, py, pz, p);
  }
  sh[tid] = x;
  __syncthreads();
#pragma unroll 1
  for (int h = REDUCE_MAX_SEG / 2; h >= 1; h >>= 1) {
    // offset p - start < h takes offset + h when it lies in the segment; reads
    // at offsets [h, 2h), writes at [0, h): no hazard inside a level
    const bool take = live && p - start < h && p + h < end;
    if (take) {
      x = pt_add_ilp(x, sh[tid + h], fc);
      sh[tid] = x;
    }
    __syncthreads();
  }
  if (live && p == start) pt_store(ox, oy, oz, s, x);
}

// S1's shared memory: the partials, then per slot its piece's local start
// and end (its piece's output row at the piece's start), then a level's
// pair list.
struct RolledSmem {
  Pt pt[ROLLED_SLOTS];
  long long out_row[ROLLED_SLOTS];
  short first[ROLLED_SLOTS], last[ROLLED_SLOTS];
  short pairs[ROLLED_SLOTS];
  int counts[ROLLED_ROUNDS][ROLLED_THREADS / 32];
};

// piece_off: segment s's first output row (its pieces' rows follow), or
// null when every segment is one piece (row s).  Blocks past the last
// partial find no piece and only write empty segments' identities.
__global__ void __launch_bounds__(ROLLED_THREADS, 3)
    msm_reduce_rolled_kernel(FieldConst fc, const long long* seg_off, const long long* piece_off,
                             const long long* px, const long long* py, const long long* pz, long long* ox,
                             long long* oy, long long* oz, long long n_seg) {
  extern __shared__ __align__(16) unsigned char rolled_smem[];
  RolledSmem& sm = *reinterpret_cast<RolledSmem*>(rolled_smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // an empty segment is one piece: the identity
  for (long long q = (long long)blockIdx.x * blockDim.x + tid; q < n_seg; q += (long long)gridDim.x * blockDim.x)
    if (seg_off[q] == seg_off[q + 1]) pt_store(ox, oy, oz, piece_off ? piece_off[q] : q, pt_identity(fc));

  const long long hi = seg_off[n_seg];
  const long long span0 = seg_off[0] + (long long)blockIdx.x * ROLLED_SPAN;
  const long long run0 = rolled_piece_from(seg_off, n_seg, hi, span0);
  const int ns = (int)(rolled_piece_from(seg_off, n_seg, hi, span0 + ROLLED_SPAN) - run0);
  for (int q = tid; q < ns; q += ROLLED_THREADS) {
    const long long p = run0 + q;
    const long long s = lower_bound(seg_off, n_seg + 1, p + 1) - 1;
    const long long m = (p - seg_off[s]) / ROLLED_SPAN;  // the piece of segment s holding p
    const long long ps = seg_off[s] + m * ROLLED_SPAN;
    const long long pe = ps + ROLLED_SPAN < seg_off[s + 1] ? ps + ROLLED_SPAN : seg_off[s + 1];
    sm.first[q] = (short)(ps - run0);
    sm.last[q] = (short)(pe - run0);
    if (p == ps) sm.out_row[q] = (piece_off ? piece_off[s] : s) + m;
    sm.pt[q] = pt_load(px, py, pz, p);
  }
  __syncthreads();
#pragma unroll 1
  for (int h = 1;; h <<= 1) {
    // the live pairs (q, q + h): q at an offset 0 mod 2h of its piece, q + h inside it
    bool take[ROLLED_ROUNDS];
    unsigned ball[ROLLED_ROUNDS];
#pragma unroll
    for (int k = 0; k < ROLLED_ROUNDS; ++k) {
      const int q = k * ROLLED_THREADS + tid;
      take[k] = q < ns && ((q - sm.first[q]) & (2 * h - 1)) == 0 && q + h < sm.last[q];
      ball[k] = __ballot_sync(0xFFFFFFFFu, take[k]);
      if (lane == 0) sm.counts[k][warp] = __popc(ball[k]);
    }
    __syncthreads();
    int total = 0, pos[ROLLED_ROUNDS];
#pragma unroll
    for (int k = 0; k < ROLLED_ROUNDS; ++k)
      for (int w = 0; w < ROLLED_THREADS / 32; ++w) {
        if (w == warp) pos[k] = total + __popc(ball[k] & ((1u << lane) - 1u));
        total += sm.counts[k][w];
      }
    if (total == 0) break;  // every piece summed (the same for the whole block)
#pragma unroll
    for (int k = 0; k < ROLLED_ROUNDS; ++k)
      if (take[k]) sm.pairs[pos[k]] = (short)(k * ROLLED_THREADS + tid);
    __syncthreads();
    // reads at offsets h mod 2h, writes at 0 mod 2h: no hazard inside a level
#pragma unroll 1
    for (int j = warp * 32; j < total; j += ROLLED_THREADS) {  // warp-uniform: a warp past the list skips
      if (j + lane < total) {
        const int q = sm.pairs[j + lane];
        const Pt a = sm.pt[q], b = sm.pt[q + h];
        sm.pt[q] = pt_add_ilp(a, b, fc);
      }
    }
    __syncthreads();
  }
  for (int q = tid; q < ns; q += ROLLED_THREADS)
    if (sm.first[q] == q) pt_store(ox, oy, oz, sm.out_row[q], sm.pt[q]);
}

__global__ void __launch_bounds__(WINDOW_THREADS) msm_window_sums_kernel(FieldConst fc, const long long* bx,
                                                                         const long long* by, const long long* bz,
                                                                         long long* tx, long long* ty,
                                                                         long long* tz, int B, int L, int log2L) {
  __shared__ Pt sh[WINDOW_THREADS];
  const long long mw = blockIdx.x;  // MSM * W + window
  const int s = threadIdx.x;
  const int S = (B + L - 1) / L;
  Pt run = pt_identity(fc), tot = pt_identity(fc);
  if (s < S) window_segment(fc, bx, by, bz, mw * B, B, L, s, run, tot);

  // suffix scan: run <- P_s = sum_{s' >= s} R_s'
  sh[s] = run;
  __syncthreads();
#pragma unroll 1
  for (int h = 1; h < S; h <<= 1) {
    const bool take = s + h < S;
    Pt q = run;
    if (take) q = sh[s + h];
    __syncthreads();
    if (take) {
      run = pt_add_ilp(run, q, fc);
      sh[s] = run;
    }
    __syncthreads();
  }
  // X_s = T_s + L P_s for s >= 1, X_0 = T_0; then sum_s X_s by a tree
  if (s >= 1 && s < S) tot = pt_add_ilp(tot, pt_dbl_n(run, log2L, fc), fc);
  sh[s] = tot;
  __syncthreads();
#pragma unroll 1
  for (int h = 1; h < S; h <<= 1) {
    // reads at s + h with s = 0 mod 2h, writes at s = 0 mod 2h: no hazard inside a level
    if ((s & (2 * h - 1)) == 0 && s + h < S) {
      tot = pt_add_ilp(tot, sh[s + h], fc);
      sh[s] = tot;
    }
    __syncthreads();
  }
  if (s == 0) pt_store(tx, ty, tz, mw, tot);
}

__global__ void __launch_bounds__(HORNER_GROUPS) msm_horner_kernel(FieldConst fc, const long long* tx,
                                                                   const long long* ty, const long long* tz,
                                                                   long long* ox, long long* oy, long long* oz,
                                                                   int W, int c, int K) {
  extern __shared__ Pt totals[];  // the W window totals of this MSM
  __shared__ Pt groups[HORNER_GROUPS];
  const int m = blockIdx.x;
  const int j = threadIdx.x;
  for (int w = j; w < W; w += blockDim.x) totals[w] = pt_load(tx, ty, tz, (long long)m * W + w);
  __syncthreads();
  const int G = (W + K - 1) / K;
  if (j < G) {
    int lo, hi;
    horner_range(W, K, j, lo, hi);
    groups[j] = horner_group(fc, totals, lo, hi, c);
  }
  __syncthreads();
  if (j == 0) {
    int lo0, r;
    horner_range(W, K, 0, lo0, r);
    Pt acc = groups[G - 1];
#pragma unroll 1
    for (int g = G - 2; g >= 1; --g) acc = pt_add_ilp(pt_dbl_n(acc, c * K, fc), groups[g], fc);
    if (G > 1) acc = pt_add_ilp(pt_dbl_n(acc, c * r, fc), groups[0], fc);
    pt_store(ox, oy, oz, m, acc);
  }
}

// ---- host launchers ----
// The bucket sort's first passes: (n, 8) scalars -> (W, n) packed signed
// digits and the (W B, ntiles) live-digit counts per bucket and tile.
extern "C" int sirius_msm_bucket_count(const void* scalars, void* digits, void* counts, long long n, int c,
                                       long long ntiles, void* stream) {
  const int W = (256 + c - 1) / c + 1, B = 1 << (c - 1);
  if (c < 2 || B > SORT_MAX_B || ntiles != (n + SORT_TILE - 1) / SORT_TILE) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  msm_signed_digits_kernel<<<(unsigned)((n + 127) / 128), 128, 0, st>>>((const long long*)scalars,
                                                                       (unsigned short*)digits, n, c);
  const long long jobs = (long long)W * ntiles;
  msm_bucket_count_kernel<<<(unsigned)((jobs + SORT_WARPS - 1) / SORT_WARPS), SORT_WARPS * 32, 0, st>>>(
      (const unsigned short*)digits, (int*)counts, n, W, B, ntiles);
  return (int)cudaGetLastError();
}

// Its last passes: entries by bucket from the exclusive offsets of the
// counts, then the chunks of every segment (seg_off, seg_start and
// seg_count over the W B segments).
extern "C" int sirius_msm_bucket_scatter(const void* digits, const void* offs, void* entries, const void* seg_off,
                                         const void* seg_start, const void* seg_count, void* chunk_start,
                                         void* chunk_len, long long n, int c, long long ntiles, long long n_chunks,
                                         void* stream) {
  const int W = (256 + c - 1) / c + 1, B = 1 << (c - 1);
  if (c < 2 || B > SORT_MAX_B || ntiles != (n + SORT_TILE - 1) / SORT_TILE) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const long long jobs = (long long)W * ntiles;
  msm_bucket_scatter_kernel<<<(unsigned)((jobs + SORT_WARPS - 1) / SORT_WARPS), SORT_WARPS * 32, 0, st>>>(
      (const unsigned short*)digits, (const long long*)offs, (long long*)entries, n, W, B, ntiles);
  if (n_chunks > 0)
    msm_bucket_chunks_kernel<<<(unsigned)((n_chunks + 127) / 128), 128, 0, st>>>(
        (const long long*)seg_off, (const long long*)seg_start, (const long long*)seg_count, (long long*)chunk_start,
        (long long*)chunk_len, (long long)W * B, n_chunks);
  return (int)cudaGetLastError();
}

extern "C" int sirius_msm_accumulate(const uint32_t* consts, const void* entries, const void* chunk_start,
                                     const void* chunk_len, const void* px, const void* py, void* ox, void* oy,
                                     void* oz, long long n_chunks, void* stream) {
  long long blocks = (n_chunks + ACCUMULATE_THREADS - 1) / ACCUMULATE_THREADS;
  msm_accumulate_kernel<<<(unsigned)blocks, ACCUMULATE_THREADS, 0, (cudaStream_t)stream>>>(
      make_field_const(consts), (const long long*)entries, (const long long*)chunk_start,
      (const long long*)chunk_len, (const long long*)px, (const long long*)py, (long long*)ox,
      (long long*)oy, (long long*)oz, n_chunks);
  return (int)cudaGetLastError();
}

// n_parts: the partials' count, seg_off[n_seg]; every segment holds at most
// REDUCE_MAX_SEG of them (the wrapper checks).
extern "C" int sirius_msm_reduce(const uint32_t* consts, const void* seg_off, const void* px, const void* py,
                                 const void* pz, void* ox, void* oy, void* oz, long long n_seg, long long n_parts,
                                 void* stream) {
  long long blocks = (n_parts + REDUCE_SPAN - 1) / REDUCE_SPAN;
  if (blocks < 1) blocks = 1;  // all segments empty: one block writes their identities
  msm_reduce_kernel<<<(unsigned)blocks, REDUCE_THREADS, 0, (cudaStream_t)stream>>>(
      make_field_const(consts), (const long long*)seg_off, (const long long*)px, (const long long*)py,
      (const long long*)pz, (long long*)ox, (long long*)oy, (long long*)oz, n_seg);
  return (int)cudaGetLastError();
}

// One pass of S1 over n_parts partials (seg_off[n_seg] - seg_off[0] <=
// n_parts); piece_off as the kernel takes it.
extern "C" int sirius_msm_reduce_rolled(const uint32_t* consts, const void* seg_off, const void* piece_off,
                                        const void* px, const void* py, const void* pz, void* ox, void* oy,
                                        void* oz, long long n_seg, long long n_parts, void* stream) {
  long long blocks = (n_parts + ROLLED_SPAN - 1) / ROLLED_SPAN;
  if (blocks < 1) blocks = 1;  // all segments empty: one block writes their identities
  const int smem = (int)sizeof(RolledSmem);
  // set on every call, for the current device (the wrapper's): each device that launches gets it
  cudaError_t e = cudaFuncSetAttribute(msm_reduce_rolled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  msm_reduce_rolled_kernel<<<(unsigned)blocks, ROLLED_THREADS, smem, (cudaStream_t)stream>>>(
      make_field_const(consts), (const long long*)seg_off, (const long long*)piece_off, (const long long*)px,
      (const long long*)py, (const long long*)pz, (long long*)ox, (long long*)oy, (long long*)oz, n_seg);
  return (int)cudaGetLastError();
}

// (t * W) window totals of (t, W, B) buckets, segments of L = 2^log2L buckets.
extern "C" int sirius_msm_window_sums(const uint32_t* consts, const void* bx, const void* by, const void* bz,
                                      void* tx, void* ty, void* tz, long long n_windows, int B, int log2L,
                                      void* stream) {
  const int L = 1 << log2L;
  const int S = (B + L - 1) / L;
  if (S > WINDOW_THREADS) return (int)cudaErrorInvalidValue;
  const int threads = ((S + 31) / 32) * 32;
  msm_window_sums_kernel<<<(unsigned)n_windows, threads, 0, (cudaStream_t)stream>>>(
      make_field_const(consts), (const long long*)bx, (const long long*)by, (const long long*)bz, (long long*)tx,
      (long long*)ty, (long long*)tz, B, L, log2L);
  return (int)cudaGetLastError();
}

// t MSM results from (t, W) window totals, in groups of K windows.
extern "C" int sirius_msm_horner(const uint32_t* consts, const void* tx, const void* ty, const void* tz, void* ox,
                                 void* oy, void* oz, int n_msm, int W, int c, int K, void* stream) {
  if ((W + K - 1) / K > HORNER_GROUPS) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)W * sizeof(Pt);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  msm_horner_kernel<<<n_msm, HORNER_GROUPS, smem, (cudaStream_t)stream>>>(
      make_field_const(consts), (const long long*)tx, (const long long*)ty, (const long long*)tz, (long long*)ox,
      (long long*)oy, (long long*)oz, W, c, K);
  return (int)cudaGetLastError();
}

// Registers, local (spill) bytes and static shared bytes per thread/block
// of MSM kernel `k`: 0 accumulate, 1 reduce, 2 reduce_rolled (S1, its
// dynamic shared memory included), 3 window_sums, 4 horner, 5 the bucket
// sort's count, 6 its scatter -> out[0], out[1], out[2].
extern "C" int sirius_msm_attrs(int k, long long* out) {
  cudaFuncAttributes attr;
  cudaError_t e;
  switch (k) {
    case 0: e = cudaFuncGetAttributes(&attr, msm_accumulate_kernel); break;
    case 1: e = cudaFuncGetAttributes(&attr, msm_reduce_kernel); break;
    case 2: e = cudaFuncGetAttributes(&attr, msm_reduce_rolled_kernel); break;
    case 3: e = cudaFuncGetAttributes(&attr, msm_window_sums_kernel); break;
    case 4: e = cudaFuncGetAttributes(&attr, msm_horner_kernel); break;
    case 5: e = cudaFuncGetAttributes(&attr, msm_bucket_count_kernel); break;
    case 6: e = cudaFuncGetAttributes(&attr, msm_bucket_scatter_kernel); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  out[0] = attr.numRegs;
  out[1] = (long long)attr.localSizeBytes;
  out[2] = (long long)attr.sharedSizeBytes + (k == 2 ? (long long)sizeof(RolledSmem) : 0);
  return 0;
}
#endif
