// Fused squared-distance reductions for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel dask_ml_tpu/ops/fused_distance.py::_fused_pallas
// with all four of its epilogues:
//   EPI_MIN            per-row min d2 over valid targets (k-means|| rounds,
//                      "min")
//   EPI_ARGMIN_MIN     per-row (argmin, min d2) ("argmin_min"); with an
//                      external per-row |x|^2 it is the sketched
//                      assignment's kernel ("argmin_min" with x2d)
//   EPI_ARGMIN_WEIGHT  per-row argmin plus cw[j] = sum_i w_i [argmin_i == j]
//                      ("argmin_weight", k-means|| candidate weighting)
//   EPI_ARGMIN_MIN2    per-row (argmin, best d2, second-best d2)
//                      ("argmin_min2", the bounded Lloyd loop)
// EPI_MIN, EPI_ARGMIN_MIN and EPI_ARGMIN_MIN2 take an optional per-group
// need flag ("need2d"): a group of group_rows rows with no needed row is
// not evaluated and writes the reduction identity (+inf for EPI_MIN,
// zeros for the argmin epilogues).
//
// What it computes is the reference's: scores s_j = |y_j|^2 - 2 x.y_j with
// |y|^2 precomputed in f32 from the original Y by the caller, masked
// targets never win, ties go to the lowest index (the running minimum is
// replaced only on a strict <), an all-masked Y gives (0, +inf), and the
// min value is max(min_j s_j + |x|^2, 0) with |x|^2 summed here in f32
// unless the caller passes its own (x2ext). The second-best is the min
// over every valid target but the argmin: a later target tying the best
// becomes the second-best, and with one valid target it is +inf. All
// epilogues share one score loop, so they give bit-identical scores and
// argmins from the same inputs (the bounded Lloyd loop's exactness rests
// on that).
//
// Bound on the H100 (67 TFLOP/s f32 outside the tensor cores, 3.35 TB/s):
// with m = 8 targets (K2, K5; n = 1e6, d = 50, and the KDD cell n = 4.9e6,
// d = 41) the kernel must read all of X and does 2·n·m·d FLOPs, so HBM
// bandwidth bounds it; with m = 80 (K3) or 329 (K4) the f32 FMA work
// bounds it, counted over the valid targets. The k-means|| rounds pass a
// candidate buffer of 80 slots of which only a prefix (about 16) is valid:
// there the bytes of X bound it again. A skipped group (row need) is
// neither read nor computed, so the bound scales with evaluated groups.
// Design against those bounds:
//   * a block's rows of X are staged into shared memory transposed
//     (feature-major) with 4-byte cp.async copies: consecutive threads read
//     consecutive addresses, the (row, feature) position steps without a
//     division, and all of a block's loads are in flight at once; X is read
//     from HBM once when d <= 56 (one feature chunk);
//   * targets stream through shared memory in tiles, each with its |y|^2
//     (+inf for a masked target); a tile with no valid target is skipped by
//     the whole block before any of it is loaded (a uniform branch), and a
//     block whose every tile is skipped never reads X. Masked targets never
//     win, so outputs do not change. With one feature chunk the next valid
//     tile is loaded into a second buffer while this one is computed;
//   * register tiling, SGEMM-style, in full f32 on the FMA pipes, the shape
//     chosen from m alone (never from the epilogue, so K2 and K5 at one m
//     run the same code): m <= 8, a row x 8 targets a thread (128 rows a
//     block); m <= 128, 8 rows x 4 targets a thread and tiles of 16 targets
//     (m = 80 computes no padding, and a k-means|| round's usual 16 valid
//     slots are one tile); beyond, 8 rows x 8 targets and tiles of 32 (both
//     256 rows a block). Per feature a thread makes two 16-byte loads of x
//     (4 rows each, a warp's load is 32 consecutive rows) and one or two
//     of y for 32 or 64 FMAs;
//   * every (row, target) score is one fmaf chain over features 0..d-1 in
//     order and |x|^2 keeps its own chain, so the scores are the same bits
//     for every tiling and every epilogue; a thread visits its targets in
//     increasing index with strict <, and the 4 threads that share a row
//     merge (value, index) pairs by shuffles, the lower index winning ties;
//   * no tensor cores: TF32 would break parity with the f32 reference;
//   * the cross-block sum of the candidate weights is not done with float
//     atomics: each block writes its partial column (rows summed in order)
//     and a second kernel reduces the columns in a fixed order, so cw is
//     bit-reproducible from run to run.
// What is left between it and the bound (PERF.md): X's staging adds to
// the FMA time instead of hiding under it; the 4-byte copies and the score
// loop's shared loads go through one load/store pipe, the likely reason.
// K2-x (the sketched assignment: EPI_ARGMIN_MIN with the caller's |x|^2)
// at m <= 8 and d <= FC, the served and KDD sketched shapes (m 8, d 10),
// runs fused_span_kernel's f32 case instead: a block's 128 rows are one
// contiguous span of 128 d floats, brought by 16-byte cp.async, and each
// thread reads its row in place; the score loop, its order and the
// epilogue are the f32 kernel's, so are the bits.
//
// bf16 X (the JAX kernel's bf16 case: Y cast to X's dtype for -2 x.y, |y|^2
// in f32 from the original Y, f32 accumulation). The caller passes Y
// already rounded to bf16 and widened back to f32, and |y|^2 from the
// original Y. Two kernels take it:
//   * EPI_ARGMIN_MIN and EPI_ARGMIN_MIN2 (K2-bf16, the sketched K2, K5-bf16)
//     run the f32 kernel's tiles, score loop, folds and epilogue with only
//     X's staging changed. With one feature chunk (d <= FC) they run
//     fused_span_kernel below: a block's rows are one span, its
//     16-byte-aligned middle brought by 16-byte cp.async, all in flight at
//     once (plain loads of the head and tail: rows of 82 or 100 bytes are
//     never aligned); one row a thread reads its row in place (20.8 KB a
//     block, so many blocks and their copies in flight an SM), more rows a
//     thread repack the span into the transposed X tile. Beyond one chunk
//     fused_distance_kernel's bf16 case loads X with plain 2-byte loads
//     into the transposed tile, chunk by chunk. Bound on the H100 at m
//     <= 8: the bytes of X (2 a value). A product of two bf16 values is exact in
//     f32, so on any data they give the bits of the f32 kernel run on X
//     rounded to bf16 and widened back (the bounded Lloyd loop's exactness
//     rests on K2 and K5 sharing one score loop);
//   * EPI_MIN and EPI_ARGMIN_WEIGHT (K3-bf16, K4-bf16) run
//     fused_mma_kernel below, which scores on the tensor cores. On
//     integer-valued data every sum is exact and they give the bits of the
//     f32 kernel and of the plain version; on float data the tensor cores
//     sum the exact products in their own order (as the JAX kernel's MXU
//     product does), within ops/fused_distance.py::_score_bound of the
//     exact scores. No caller needs their scores to be K2's or K5's bits.
//
// fused_mma_kernel. Bound on the H100 at the k-means|| shapes (n = 1e6,
// d = 50; KDD n = 4.9e6, d = 41): K3 (m 80, or the rounds' 16 valid slots)
// does 80 operations a byte of X, far below the bf16 ridge of ~295, so
// reading X once bounds it; K4 (m 329) does 329 a byte, at the ridge, so
// the tensor cores' rate bounds it too. Design against that:
//   * persistent blocks of 4 warps walk tiles of 128 rows (a warp 32 rows,
//     two m16 tiles) in a fixed order. A tile's rows are one contiguous
//     span of 128 d bf16 elements: one 1-D cp.async.bulk brings its
//     16-byte-aligned middle into a ring of up to 4 stages (as many as
//     leave room for two blocks an SM), plain 2-byte loads its head and
//     tail (rows of 100 or 82 bytes are never aligned, and a view may start
//     at any element). Lane 0 of warp 0 issues each copy S - 1 tiles ahead
//     of its own; warp 0 loads the plain ends then and stores them at its
//     next production, the stage's full mbarrier (count 2) published by
//     both, so no warp waits on a load it issued. There is no block
//     barrier on the way: each warp waits for its tile's full barrier,
//     repacks its own rows, releases the stage (empty mbarrier, one
//     arrival a warp) and scores them;
//   * the span is repacked in shared memory into a row-major A tile of
//     16-byte groups (a 144-byte row stride: ldmatrix reads it free of bank
//     conflicts), zero past d, so K is d rounded up to 16;
//   * Y stays resident in shared memory as bf16 (converting the rounded
//     values back is exact) when it fits, compacted to its n8 target tiles
//     that hold a valid target (an odd count padded with an all-masked
//     tile): a masked tile is never scored (a round's 16 valid of 80 slots
//     are 2 tiles), and |y|^2 is staged +inf for a masked target. Beyond
//     that budget Y streams through a chunk of NC target tiles a pass, the
//     block meeting around each, a pass with no valid target skipped;
//   * the product is mma.sync m16n8k16 bf16 x bf16 -> f32, fed by
//     ldmatrix.x4 (the A fragments held in registers for the tile, two
//     target tiles a B load), NC target tiles a pass in straight-line code;
//   * the epilogue scores s = |y|^2 - 2 acc. EPI_MIN keeps the minimum
//     alone (fminf: the value a strict < keeps, NaN skipped); EPI_ARGMIN_
//     WEIGHT visits a thread's targets in increasing index with a strict <
//     and merges the 4 lanes of a quad with the lower index winning ties.
//     The min adds |x|^2 from the in-order fmaf chain over X widened (the
//     f32 kernel's bits);
//   * cw: a warp sums its 32 rows by label in row order by shuffles and
//     adds the sums to its running per-target sums in shared memory (m <=
//     RUN_MAX), over a fixed grid of CW_GRID blocks; each block writes its
//     partial column (its warps' sums in order) and cw_reduce_kernel adds
//     the columns in a fixed order: no float atomics, the same bits from
//     run to run and on any card. Beyond RUN_MAX each tile writes its own
//     column (the f32 kernel's scheme; dml_fused_rows_per_block() is the
//     tile's 128 rows, so the caller's cw_part sizing holds either way);
//   * d beyond 64 runs in feature chunks of 64, each staged row by row and
//     waited for (no ring), the sums carried across chunks in registers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;    // threads per block
constexpr int MIN_ROWS = 128;   // X rows of the smallest block tile
constexpr int FC = 56;          // features per shared-memory chunk
constexpr int RED = 256;        // threads of the cw reduction

enum {
  EPI_MIN = 0,
  EPI_ARGMIN_MIN = 1,
  EPI_ARGMIN_WEIGHT = 2,
  EPI_ARGMIN_MIN2 = 3
};

// the value a row of a skipped group gets
template <int EPI>
__device__ __forceinline__ void write_identity(long row, int* am_out,
                                               float* min_out,
                                               float* min2_out) {
  if (EPI == EPI_MIN) {
    min_out[row] = CUDART_INF_F;
  } else {
    am_out[row] = 0;
    min_out[row] = 0.f;
    if (EPI == EPI_ARGMIN_MIN2) min2_out[row] = 0.f;
  }
}

// an asynchronous 4-byte copy from global to shared memory; zero-filled
// when !full (src is then not read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// rows [0, nr) x features [f0, f0 + fc) of a row-major matrix with d
// columns (src points at its first row) into dst[f * stride + r] for r <
// R, zero-filled from row nr on, asynchronously; consecutive threads read
// consecutive addresses, and the (row, feature) position steps without a
// division per element
template <int R>
__device__ __forceinline__ void stage_transposed(float* dst, int stride,
                                                 const float* src, int nr,
                                                 int d, int f0, int fc) {
  const int dq = THREADS / fc, dr = THREADS - dq * fc;
  int rr = threadIdx.x / fc, ff = threadIdx.x - rr * fc;
  for (int e = threadIdx.x; e < R * fc; e += THREADS) {
    const bool in = rr < nr;
    cp_async4(dst + ff * stride + rr, in ? src + (long)rr * d + f0 + ff : src,
              in);
    rr += dq;
    ff += dr;
    if (ff >= fc) {
      ff -= fc;
      ++rr;
    }
  }
}

// the same walk over a bf16 matrix with plain 2-byte loads (cp.async
// copies 4 bytes at least), SU of them issued before any is stored, each
// widened to f32 as it is stored (a bf16 is the high half of its f32)
template <int R>
__device__ __forceinline__ void stage_transposed(float* dst, int stride,
                                                 const __nv_bfloat16* src,
                                                 int nr, int d, int f0,
                                                 int fc) {
  constexpr int SU = 8;
  const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
  const int total = R * fc;
  const int dq = THREADS / fc, dr = THREADS - dq * fc;
  int rr = threadIdx.x / fc, ff = threadIdx.x - rr * fc;
  for (int e0 = threadIdx.x; e0 < total; e0 += SU * THREADS) {
    unsigned short v[SU];
    int at[SU];
#pragma unroll
    for (int u = 0; u < SU; ++u) {
      const bool live = e0 + u * THREADS < total;
      at[u] = live ? ff * stride + rr : -1;
      v[u] = live && rr < nr ? __ldg(s + (long)rr * d + f0 + ff) : 0;
      rr += dq;
      ff += dr;
      if (ff >= fc) {
        ff -= fc;
        ++rr;
      }
    }
#pragma unroll
    for (int u = 0; u < SU; ++u)
      if (at[u] >= 0) dst[at[u]] = __uint_as_float((unsigned)v[u] << 16);
  }
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// one bf16 element of X loaded for a later store to shared memory (p null:
// none)
struct Plain {
  unsigned short* p;
  unsigned short v;
};

// the head and tail of a span of count bf16 elements at gs whose
// 16-byte-aligned middle [lo, hi) is copied otherwise: element e is plain
// when it lies outside it (head e < 8, tail e >= count - 8); lane j < 16
// loads one into pl, for raw's byte (gs & 15) + 2e
__device__ __forceinline__ void plain_load(unsigned char* raw, uintptr_t gs,
                                           long count, uintptr_t lo,
                                           uintptr_t hi, int j, Plain& pl) {
  pl.p = nullptr;
  if (j >= 16) return;
  const long e = j < 8 ? j : count - 16 + j;
  if (!(j < 8 ? e < count : e >= 8)) return;
  const uintptr_t a = gs + 2 * e;
  if (a < lo || a >= hi) {
    pl.v = __ldg(reinterpret_cast<const unsigned short*>(a));
    pl.p = reinterpret_cast<unsigned short*>(raw + (a - (gs & ~(uintptr_t)15)));
  }
}

// the same, stored at once
__device__ __forceinline__ void plain_ends(unsigned char* raw, uintptr_t gs,
                                           long count, uintptr_t lo,
                                           uintptr_t hi, int j) {
  Plain pl;
  plain_load(raw, gs, count, lo, hi, j, pl);
  if (pl.p != nullptr) *pl.p = pl.v;
}

// a block's rows of bf16 X when they are one span (d <= FC): count
// contiguous elements from src into raw, element e at byte (src & 15) + 2e.
// The 16-byte-aligned middle comes by 16-byte cp.async, all of a block's
// copies in flight at once; the head and tail (rows of 82 or 100 bytes are
// never aligned, and a view may start at any element) by plain loads of
// threads 0..15
__device__ __forceinline__ void stage_span(unsigned char* raw,
                                           const __nv_bfloat16* src,
                                           long count) {
  const uintptr_t gs = reinterpret_cast<uintptr_t>(src);
  const uintptr_t base = gs & ~(uintptr_t)15;
  const uintptr_t lo = (gs + 15) & ~(uintptr_t)15;
  uintptr_t hi = (gs + 2 * count) & ~(uintptr_t)15;
  if (hi < lo) hi = lo;
  for (uintptr_t a = lo + 16 * threadIdx.x; a < hi; a += 16 * THREADS)
    cp_async16(raw + (a - base), reinterpret_cast<const void*>(a));
  plain_ends(raw, gs, count, lo, hi, threadIdx.x);
}

// element f of a bf16 row in shared memory, widened (a bf16 is the high
// half of its f32)
__device__ __forceinline__ float bf16_at(const unsigned short* row, int f) {
  return __uint_as_float((unsigned)row[f] << 16);
}

// a block's rows of f32 X when they are one span (d <= FC): count
// contiguous elements from src into raw, element e at byte (src & 15) +
// 4e. The 16-byte-aligned middle comes by 16-byte cp.async, all of a
// block's copies in flight at once; the head and tail (at most 3 elements
// each: an f32 view starts on a 4-byte boundary) by plain loads of
// threads 0..7
__device__ __forceinline__ void stage_span(unsigned char* raw,
                                           const float* src, long count) {
  const uintptr_t gs = reinterpret_cast<uintptr_t>(src);
  const uintptr_t base = gs & ~(uintptr_t)15;
  const uintptr_t lo = (gs + 15) & ~(uintptr_t)15;
  uintptr_t hi = (gs + 4 * count) & ~(uintptr_t)15;
  if (hi < lo) hi = lo;
  for (uintptr_t a = lo + 16 * threadIdx.x; a < hi; a += 16 * THREADS)
    cp_async16(raw + (a - base), reinterpret_cast<const void*>(a));
  const int j = threadIdx.x;
  if (j >= 8) return;
  const long e = j < 4 ? j : count - 8 + j;
  if (!(j < 4 ? e < count : e >= 4)) return;
  const uintptr_t a = gs + 4 * e;
  if (a < lo || a >= hi)
    *reinterpret_cast<float*>(raw + (a - base)) =
        __ldg(reinterpret_cast<const float*>(a));
}

// element f of a row of the span in shared memory, as f32
__device__ __forceinline__ float span_at(const unsigned short* row, int f) {
  return bf16_at(row, f);
}
__device__ __forceinline__ float span_at(const float* row, int f) {
  return row[f];
}

// the span's element type in shared memory: bf16 bits, or f32
template <typename TX>
struct SpanOf {
  using T = float;
};
template <>
struct SpanOf<__nv_bfloat16> {
  using T = unsigned short;
};

// a span's rows [0, nr) (row r at element r * d of src, d <= THREADS) into
// dst[f * stride + r] for r < R, widened, zero from row nr on: the
// transposed tile of stage_transposed, from shared memory
template <int R>
__device__ __forceinline__ void repack_transposed(float* dst, int stride,
                                                  const unsigned short* src,
                                                  int nr, int d) {
  const int dq = THREADS / d, dr = THREADS - dq * d;
  int rr = threadIdx.x / d, ff = threadIdx.x - rr * d;
  for (int e = threadIdx.x; e < R * d; e += THREADS) {
    dst[ff * stride + rr] = rr < nr ? bf16_at(src, e) : 0.f;
    rr += dq;
    ff += dr;
    if (ff >= d) {
      ff -= d;
      ++rr;
    }
  }
}

// fold (ob, os, oi) into (b, s, i): the lower (value, index) pair wins and
// the second-best is the least value of both but the winner's
__device__ __forceinline__ void merge_pair(float& b, float& s, int& i,
                                           float ob, float os, int oi) {
  if (ob < b || (ob == b && oi < i)) {
    s = b < os ? b : os;
    b = ob;
    i = oi;
  } else if (ob < s) {
    s = ob;
  }
}

// the block tile of a (TR, TC, TG) thread tile: THREADS threads, TG of
// them sharing TR rows, cover BR rows x TT targets
template <int TR, int TC, int TG>
struct Tile {
  static constexpr int BR = THREADS / TG * TR;  // rows per block
  static constexpr int TT = TC * TG;            // targets per tile
  // stride of the transposed X tile: odd for one row a thread (its scalar
  // reads and the staging stores are free of bank conflicts), a multiple
  // of 4 for 4k rows a thread (16-byte reads of 4 rows)
  static constexpr int XS = TR == 1 ? BR + 1 : BR + 4;
  static constexpr int YS = TT + 4;  // stride of a target tile
  // shared memory: the X tile, two target tiles and their |y|^2, and the
  // labels and weights of EPI_ARGMIN_WEIGHT's partial sums
  static constexpr int SMEM =
      4 * (FC * XS + 2 * FC * YS + 2 * TT + 2 * BR);
  // fused_span_kernel (X of w-byte elements, d <= FC): the block's rows
  // arrive as one span of rawb(w, d) bytes at most (BR rows of d elements
  // and the span's misalignment, rounded to 16). One row a thread reads it
  // in place, in front of the target tiles (no X tile); more rows a thread
  // repack it into the X tile, the span past the target tiles. bf16 X
  // sizes the span for d = FC; f32 X (K2-x) for its own d, which leaves
  // the SM more of its shared memory for L1 (on an H100 at the KDD
  // sketched shape: 0.1053 ms, against 0.1298 sized for FC)
  __host__ __device__ static constexpr int rawb(int w, int d = FC) {
    return (BR * d * w + 32 + 15) & ~15;
  }
  __host__ __device__ static constexpr int smem_span(int w, int d = FC) {
    return (TR == 1 ? 0 : 4 * FC * XS) + 4 * (2 * FC * YS + 2 * TT) +
           rawb(w, d);
  }
};

// TR rows x TC targets of scores a thread; the TG threads of a row are
// neighbouring lanes; TX is X's element type (float or __nv_bfloat16)
template <int EPI, int TR, int TC, int TG, typename TX>
__global__ void __launch_bounds__(THREADS)
fused_distance_kernel(const TX* __restrict__ X, const float* __restrict__ Y,
                      const float* __restrict__ y2,
                      const float* __restrict__ maskf,
                      const unsigned char* __restrict__ gneed, int group_rows,
                      const float* __restrict__ x2ext,
                      const float* __restrict__ w, int n, int m, int d,
                      int* __restrict__ am_out, float* __restrict__ min_out,
                      float* __restrict__ min2_out,
                      float* __restrict__ cw_part) {
  using T = Tile<TR, TC, TG>;
  constexpr int BR = T::BR, TT = T::TT, XS = T::XS, YS = T::YS;
  constexpr int G = 32 / TG;  // row groups per warp
  // features a step of the score loop (measured best for each thread tile)
  constexpr int UNROLL = TC == 8 ? 4 : 8;
  static_assert(TC % 4 == 0 && 32 % TG == 0 && (TR == 1 || TR % 4 == 0),
                "tile shape");
  extern __shared__ __align__(16) float smem[];
  float* const xs = smem;
  // two target tiles (b = 0, 1) and their |y|^2 (+inf for a masked
  // target): with one feature chunk the next valid tile is loaded while
  // this one is computed
  float* const ys = xs + FC * XS;       // tile b at ys + b * FC * YS
  float* const y2s = ys + 2 * FC * YS;  // tile b at y2s + b * TT
  int* const lab = reinterpret_cast<int*>(y2s + 2 * TT);
  float* const wsm = y2s + 2 * TT + BR;

  const int tid = threadIdx.x;
  const int tg = tid % TG, rg = tid / TG;
  const long row0 = (long)blockIdx.x * BR;
  const int nrows = (int)min((long)BR, (long)n - row0);
  // this thread's rows in the block: runs of 4 consecutive rows, so that
  // each of a warp's 16-byte loads of x reads 32 consecutive rows
  auto row_of = [&](int i) {
    return TR == 1 ? rg
                   : (rg / G) * (G * TR) + (i / 4) * (4 * G) + (rg % G) * 4 +
                         i % 4;
  };
  int r[TR];
  bool ev[TR];
  bool any = false;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    r[i] = row_of(i);
    ev[i] = r[i] < nrows;
  }

  // row_need: a group of group_rows rows with no needed row is skipped; a
  // block whose rows all lie in skipped groups returns at once
  if (EPI != EPI_ARGMIN_WEIGHT && gneed != nullptr) {
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      ev[i] = ev[i] && gneed[(row0 + r[i]) / group_rows] != 0;
      any = any || ev[i];
    }
    if (!__syncthreads_or(any)) {
      if (tg == 0) {
#pragma unroll
        for (int i = 0; i < TR; ++i)
          if (r[i] < nrows)
            write_identity<EPI>(row0 + r[i], am_out, min_out, min2_out);
      }
      return;
    }
  }

  const int nfc = (d + FC - 1) / FC;
  // |x|^2 of this thread's share of its rows: the TG threads of a row
  // group sum XR rows each
  constexpr int XR = TR / TG;
  int xrow[XR];
#pragma unroll
  for (int k = 0; k < XR; ++k) xrow[k] = row_of(tg * XR + k);
  float x2[XR];
  float best[TR], second[TR];  // second: EPI_ARGMIN_MIN2 only
  int bi[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    best[i] = second[i] = CUDART_INF_F;
    bi[i] = 0;
  }
#pragma unroll
  for (int k = 0; k < XR; ++k) x2[k] = 0.f;
  bool first = true;  // no tile evaluated yet (uniform over the block)
  // the target tile at t0, features f0 .. f0 + fc - 1, into buffer b
  auto stage_y = [&](int b, int t0, int f0, int fc) {
    stage_transposed<TT>(ys + b * FC * YS, YS, Y + (long)t0 * d, min(TT, m - t0), d, f0,
                         fc);
  };
  // a tile's validity and |y|^2 are loaded while the tile before it is
  // computed
  bool ok = tid < TT && tid < m && maskf[tid] > 0.f;
  float y2t = tid < TT && tid < m ? y2[tid] : 0.f;
  int b = 0;            // the buffer of the tile at t0
  bool staged = false;  // the tile at t0 is loaded (or loading) into b
  for (int t0 = 0; t0 < m; t0 += TT) {
    const int tt = t0 + tid;
    const bool ok_here = ok;
    const float y2_here = y2t;
    const bool in_next = tid < TT && tt + TT < m;
    ok = in_next && maskf[tt + TT] > 0.f;
    y2t = in_next ? y2[tt + TT] : 0.f;
    // every thread is past the previous tile here, so its buffers are free
    if (!staged && !__syncthreads_or(ok_here)) continue;
    if (tid < TT) y2s[b * TT + tid] = ok_here ? y2_here : CUDART_INF_F;
    float acc[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) acc[i][j] = 0.f;
    for (int c = 0; c < nfc; ++c) {
      const int f0 = c * FC;
      const int fc = min(FC, d - f0);
      if (c > 0) __syncthreads();  // the previous chunk has been consumed
      if (first || nfc > 1) {
        stage_transposed<BR>(xs, XS, X + row0 * d, nrows, d, f0, fc);
      }
      if (!staged) stage_y(b, t0, f0, fc);
      cp_async_wait_all();
      // with one chunk, a block learns here whether the next tile is
      // evaluated, and starts loading it into the other buffer; that
      // buffer was last read by the tile before this one
      const bool next = __syncthreads_or(ok) && nfc == 1;
      staged = next;
      if (next) stage_y(b ^ 1, t0 + TT, 0, fc);
      if (first && x2ext == nullptr) {
        for (int f = 0; f < fc; ++f)
#pragma unroll
          for (int k = 0; k < XR; ++k) {
            const float xv = xs[f * XS + xrow[k]];
            x2[k] = fmaf(xv, xv, x2[k]);
          }
      }
      const float* xp = xs + r[0];
      const float* yp = ys + b * FC * YS + tg * TC;
#pragma unroll UNROLL
      for (int f = 0; f < fc; ++f, xp += XS, yp += YS) {
        float xv[TR];
        if constexpr (TR == 1) {
          xv[0] = *xp;
        } else {
#pragma unroll
          for (int k = 0; k < TR / 4; ++k) {
            const float4 x4 = *reinterpret_cast<const float4*>(xp + 4 * G * k);
            xv[4 * k + 0] = x4.x;
            xv[4 * k + 1] = x4.y;
            xv[4 * k + 2] = x4.z;
            xv[4 * k + 3] = x4.w;
          }
        }
        const float4* y4 = reinterpret_cast<const float4*>(yp);
#pragma unroll
        for (int q = 0; q < TC / 4; ++q) {
          const float4 yv = y4[q];
#pragma unroll
          for (int i = 0; i < TR; ++i) {
            acc[i][4 * q + 0] = fmaf(xv[i], yv.x, acc[i][4 * q + 0]);
            acc[i][4 * q + 1] = fmaf(xv[i], yv.y, acc[i][4 * q + 1]);
            acc[i][4 * q + 2] = fmaf(xv[i], yv.z, acc[i][4 * q + 2]);
            acc[i][4 * q + 3] = fmaf(xv[i], yv.w, acc[i][4 * q + 3]);
          }
        }
      }
    }
    first = false;
    // this thread's targets of the tile, in increasing index; a masked
    // target scores +inf and never passes the strict <
#pragma unroll
    for (int q = 0; q < TC / 4; ++q) {
      const float4 y4 =
          reinterpret_cast<const float4*>(y2s + b * TT + tg * TC)[q];
      const float yy[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * q + jj;
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          const float s = yy[jj] - 2.0f * acc[i][j];
          if (s < best[i]) {
            if (EPI == EPI_ARGMIN_MIN2) second[i] = best[i];
            best[i] = s;
            bi[i] = t0 + tg * TC + j;
          } else if (EPI == EPI_ARGMIN_MIN2 && s < second[i]) {
            // a later target that ties the best lands here too
            second[i] = s;
          }
        }
      }
    }
    if (staged) b ^= 1;
  }
  // the TG threads of a row are neighbouring lanes: merge their minima
#pragma unroll
  for (int o = 1; o < TG; o <<= 1) {
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const float ob = __shfl_xor_sync(0xffffffffu, best[i], o);
      const float os = __shfl_xor_sync(0xffffffffu, second[i], o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi[i], o);
      merge_pair(best[i], second[i], bi[i], ob, os, oi);
    }
  }

  // row i's |x|^2 is held by the thread tg = i / XR of its group
  float x2r[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i)
    x2r[i] = TG == 1 ? x2[0]
                     : __shfl_sync(0xffffffffu, x2[i % XR],
                                   (tid & 31) - tg + i / XR);

  if (EPI == EPI_ARGMIN_WEIGHT) {
    if (tg == 0) {
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const bool v = r[i] < nrows;
        if (v) am_out[row0 + r[i]] = bi[i];
        lab[r[i]] = v ? bi[i] : -1;
        wsm[r[i]] = v ? w[row0 + r[i]] : 0.f;
      }
    }
    __syncthreads();
    // each warp sums the weights of every label in its 32-row segments, in
    // row order, by shuffles; the segments' sums are then added in order.
    // The per-segment sums go through X's tile, which is no longer needed,
    // CH targets a pass
    constexpr int NSEG = BR / 32, SPW = BR / THREADS;  // segments, a warp's
    constexpr int CH = FC * XS / NSEG;
    const int lane = tid & 31, warp = tid >> 5;
    int sl[SPW];
    float sw[SPW];
    bool lead[SPW];
#pragma unroll
    for (int k = 0; k < SPW; ++k) {
      const int sg = warp + k * (THREADS / 32);
      const int l = lab[32 * sg + lane];
      const float wv = wsm[32 * sg + lane];
      float acc = 0.f;
      for (int src = 0; src < 32; ++src) {
        const int ls = __shfl_sync(0xffffffffu, l, src);
        const float ws = __shfl_sync(0xffffffffu, wv, src);
        if (ls == l) acc += ws;
      }
      sl[k] = l;
      sw[k] = acc;
      lead[k] = lane == __ffs(__match_any_sync(0xffffffffu, l)) - 1;
    }
    float* const part = xs;  // [segment][target of the pass]
    for (int j0 = 0; j0 < m; j0 += CH) {
      const int cn = min(CH, m - j0);
      __syncthreads();  // the previous pass's sums have been read
      for (int e = tid; e < NSEG * cn; e += THREADS) part[e] = 0.f;
      __syncthreads();
#pragma unroll
      for (int k = 0; k < SPW; ++k) {
        const int sg = warp + k * (THREADS / 32);
        if (lead[k] && sl[k] >= j0 && sl[k] < j0 + cn)
          part[sg * cn + sl[k] - j0] = sw[k];
      }
      __syncthreads();
      for (int jj = tid; jj < cn; jj += THREADS) {
        // a masked target's column is zeroed by the reduction
        float s = 0.f;
        if (maskf[j0 + jj] > 0.f)
          for (int sg = 0; sg < NSEG; ++sg) s += part[sg * cn + jj];
        cw_part[(long)(j0 + jj) * gridDim.x + blockIdx.x] = s;
      }
    }
  } else if (tg == 0) {
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      if (r[i] >= nrows) continue;
      const long row = row0 + r[i];
      if (!ev[i]) {
        write_identity<EPI>(row, am_out, min_out, min2_out);
      } else {
        const float xx = x2ext != nullptr ? x2ext[row] : x2r[i];
        min_out[row] = fmaxf(best[i] + xx, 0.f);
        if (EPI != EPI_MIN) am_out[row] = bi[i];
        if (EPI == EPI_ARGMIN_MIN2) min2_out[row] = fmaxf(second[i] + xx, 0.f);
      }
    }
  }
}

// K2-bf16 and K5-bf16 (EPI_ARGMIN_MIN, EPI_ARGMIN_MIN2) when a row is one
// feature chunk (d <= FC): fused_distance_kernel's tiles, score loop, folds
// and epilogue on bf16 X, with X's staging redesigned; and on f32 X with
// one row a thread for K2-x (the sketched assignment, its |x|^2 the
// caller's), whose bits are then the f32 kernel's on every input: each
// score is the same in-order fmaf chain over the same f32 features, each
// row's X one contiguous read instead of fused_distance_kernel's
// transposed staging. A block's rows are
// one span of nrows d elements: its 16-byte-aligned middle comes by
// 16-byte cp.async, all of a block's copies in flight at once (plain loads
// of its head and tail), at the first target tile that holds a valid
// target. With one row a thread the score loop reads its row of the span
// in place, widening each element (no X tile, 20.8 KB a block); with more
// rows a thread the span is repacked into the transposed X tile the f32
// loop reads. Every (row, target) score is the f32 kernel's fmaf chain
// over the widened features in order, so the outputs are the f32 kernel's
// bits on X widened, K2's and K5's alike. A block whose row groups are all
// skipped (row need) returns before it reads X.
template <int EPI, int TR, int TC, int TG, typename TX>
__global__ void __launch_bounds__(THREADS)
fused_span_kernel(const TX* __restrict__ X,
                  const float* __restrict__ Y, const float* __restrict__ y2,
                  const float* __restrict__ maskf,
                  const unsigned char* __restrict__ gneed, int group_rows,
                  const float* __restrict__ x2ext, int n, int m, int d,
                  int* __restrict__ am_out, float* __restrict__ min_out,
                  float* __restrict__ min2_out) {
  using T = Tile<TR, TC, TG>;
  constexpr int BR = T::BR, TT = T::TT, XS = T::XS, YS = T::YS;
  constexpr int G = 32 / TG;  // row groups per warp
  constexpr int UNROLL = TC == 8 ? 4 : 8;
  static_assert(EPI == EPI_ARGMIN_MIN || EPI == EPI_ARGMIN_MIN2, "epilogue");
  static_assert(sizeof(TX) == 2 || TR == 1, "f32 X: one row a thread");
  using XE = typename SpanOf<TX>::T;
  extern __shared__ __align__(16) float smem[];
  // one row a thread: [span][target tiles][|y|^2]; more: [X tile][target
  // tiles][|y|^2][span]
  float* const xs = smem;
  float* const ys =
      xs + (TR == 1 ? T::rawb(sizeof(TX), sizeof(TX) == 2 ? FC : d) / 4
                    : FC * XS);
  float* const y2s = ys + 2 * FC * YS;
  unsigned char* const raw =
      reinterpret_cast<unsigned char*>(TR == 1 ? smem : y2s + 2 * TT);

  const int tid = threadIdx.x;
  const int tg = tid % TG, rg = tid / TG;
  const long row0 = (long)blockIdx.x * BR;
  const int nrows = (int)min((long)BR, (long)n - row0);
  auto row_of = [&](int i) {
    return TR == 1 ? rg
                   : (rg / G) * (G * TR) + (i / 4) * (4 * G) + (rg % G) * 4 +
                         i % 4;
  };
  int r[TR];
  bool ev[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    r[i] = row_of(i);
    ev[i] = r[i] < nrows;
  }
  if (gneed != nullptr) {
    // the block's groups, read alike by every thread (n < 2^31: 32-bit
    // divisions): a block whose groups are all skipped returns at once
    const int g0 = (int)row0 / group_rows;
    const int g1 = ((int)row0 + nrows - 1) / group_rows;
    bool some = false;
    for (int gi = g0; gi <= g1 && !some; ++gi) some = gneed[gi] != 0;
    if (!some) {
      if (tg == 0) {
#pragma unroll
        for (int i = 0; i < TR; ++i)
          if (r[i] < nrows)
            write_identity<EPI>(row0 + r[i], am_out, min_out, min2_out);
      }
      return;
    }
#pragma unroll
    for (int i = 0; i < TR; ++i)
      ev[i] = ev[i] && gneed[(int)(row0 + r[i]) / group_rows] != 0;
  }
  // the span's element 0; this thread's row in it (one row a thread; a row
  // past the block's reads row 0 and is never written)
  const XE* const xsp = reinterpret_cast<const XE*>(
      raw + (reinterpret_cast<uintptr_t>(X + row0 * d) & 15));
  const XE* const xr = xsp + (r[0] < nrows ? r[0] : 0) * d;

  constexpr int XR = TR / TG;
  int xrow[XR];
#pragma unroll
  for (int k = 0; k < XR; ++k) xrow[k] = row_of(tg * XR + k);
  float x2[XR];
  float best[TR], second[TR];  // second: EPI_ARGMIN_MIN2 only
  int bi[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    best[i] = second[i] = CUDART_INF_F;
    bi[i] = 0;
  }
#pragma unroll
  for (int k = 0; k < XR; ++k) x2[k] = 0.f;
  bool first = true;  // no tile evaluated yet (uniform over the block)
  auto stage_y = [&](int b, int t0) {
    stage_transposed<TT>(ys + b * FC * YS, YS, Y + (long)t0 * d,
                         min(TT, m - t0), d, 0, d);
  };
  bool ok = tid < TT && tid < m && maskf[tid] > 0.f;
  float y2t = tid < TT && tid < m ? y2[tid] : 0.f;
  int b = 0;            // the buffer of the tile at t0
  bool staged = false;  // the tile at t0 is loaded (or loading) into b
  for (int t0 = 0; t0 < m; t0 += TT) {
    const int tt = t0 + tid;
    const bool ok_here = ok;
    const float y2_here = y2t;
    const bool in_next = tid < TT && tt + TT < m;
    ok = in_next && maskf[tt + TT] > 0.f;
    y2t = in_next ? y2[tt + TT] : 0.f;
    // every thread is past the previous tile here, so its buffers are free
    if (!staged && !__syncthreads_or(ok_here)) continue;
    if (tid < TT) y2s[b * TT + tid] = ok_here ? y2_here : CUDART_INF_F;
    float acc[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) acc[i][j] = 0.f;
    if (first) stage_span(raw, X + row0 * d, (long)nrows * d);
    if (!staged) stage_y(b, t0);
    cp_async_wait_all();
    // the next valid tile starts loading into the other buffer, which the
    // tile before this one last read
    const bool next = __syncthreads_or(ok);
    staged = next;
    if (next) stage_y(b ^ 1, t0 + TT);
    if constexpr (TR != 1) {
      if (first) {
        repack_transposed<BR>(xs, XS, xsp, nrows, d);
        __syncthreads();
      }
    }
    if (first && x2ext == nullptr) {
      if (TR == 1) {
        for (int f = 0; f < d; ++f) {
          const float xv = span_at(xr, f);
          x2[0] = fmaf(xv, xv, x2[0]);
        }
      } else {
        for (int f = 0; f < d; ++f)
#pragma unroll
          for (int k = 0; k < XR; ++k) {
            const float xv = xs[f * XS + xrow[k]];
            x2[k] = fmaf(xv, xv, x2[k]);
          }
      }
    }
    first = false;
    const float* xp = xs + r[0];
    const float* yp = ys + b * FC * YS + tg * TC;
#pragma unroll UNROLL
    for (int f = 0; f < d; ++f, xp += XS, yp += YS) {
      float xv[TR];
      if constexpr (TR == 1) {
        xv[0] = span_at(xr, f);
      } else {
#pragma unroll
        for (int k = 0; k < TR / 4; ++k) {
          const float4 x4 = *reinterpret_cast<const float4*>(xp + 4 * G * k);
          xv[4 * k + 0] = x4.x;
          xv[4 * k + 1] = x4.y;
          xv[4 * k + 2] = x4.z;
          xv[4 * k + 3] = x4.w;
        }
      }
      const float4* y4 = reinterpret_cast<const float4*>(yp);
#pragma unroll
      for (int q = 0; q < TC / 4; ++q) {
        const float4 yv = y4[q];
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          acc[i][4 * q + 0] = fmaf(xv[i], yv.x, acc[i][4 * q + 0]);
          acc[i][4 * q + 1] = fmaf(xv[i], yv.y, acc[i][4 * q + 1]);
          acc[i][4 * q + 2] = fmaf(xv[i], yv.z, acc[i][4 * q + 2]);
          acc[i][4 * q + 3] = fmaf(xv[i], yv.w, acc[i][4 * q + 3]);
        }
      }
    }
    // this thread's targets of the tile, in increasing index; a masked
    // target scores +inf and never passes the strict <
#pragma unroll
    for (int q = 0; q < TC / 4; ++q) {
      const float4 y4 =
          reinterpret_cast<const float4*>(y2s + b * TT + tg * TC)[q];
      const float yy[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * q + jj;
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          const float s = yy[jj] - 2.0f * acc[i][j];
          if (s < best[i]) {
            if (EPI == EPI_ARGMIN_MIN2) second[i] = best[i];
            best[i] = s;
            bi[i] = t0 + tg * TC + j;
          } else if (EPI == EPI_ARGMIN_MIN2 && s < second[i]) {
            // a later target that ties the best lands here too
            second[i] = s;
          }
        }
      }
    }
    if (staged) b ^= 1;
  }
  // the TG threads of a row are neighbouring lanes: merge their minima
#pragma unroll
  for (int o = 1; o < TG; o <<= 1) {
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const float ob = __shfl_xor_sync(0xffffffffu, best[i], o);
      const float os = __shfl_xor_sync(0xffffffffu, second[i], o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi[i], o);
      merge_pair(best[i], second[i], bi[i], ob, os, oi);
    }
  }
  // row i's |x|^2 is held by the thread tg = i / XR of its group
  float x2r[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i)
    x2r[i] = TG == 1 ? x2[0]
                     : __shfl_sync(0xffffffffu, x2[i % XR],
                                   (tid & 31) - tg + i / XR);
  if (tg == 0) {
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      if (r[i] >= nrows) continue;
      const long row = row0 + r[i];
      if (!ev[i]) {
        write_identity<EPI>(row, am_out, min_out, min2_out);
      } else {
        const float xx = x2ext != nullptr ? x2ext[row] : x2r[i];
        min_out[row] = fmaxf(best[i] + xx, 0.f);
        am_out[row] = bi[i];
        if (EPI == EPI_ARGMIN_MIN2) min2_out[row] = fmaxf(second[i] + xx, 0.f);
      }
    }
  }
}

// cw[j] = sum over blocks b, in a fixed order, of cw_part[j, b]; masked
// targets get 0 (in the all-masked case every row's argmin is 0 and its
// weight lands on masked slot 0, which is zeroed here, as in the reference)
__global__ void __launch_bounds__(RED)
cw_reduce_kernel(const float* __restrict__ cw_part,
                 const float* __restrict__ maskf, int nb,
                 float* __restrict__ cw) {
  __shared__ float red[RED];
  const int j = blockIdx.x, tid = threadIdx.x;
  float s = 0.f;
  for (int b = tid; b < nb; b += RED) s += cw_part[(long)j * nb + b];
  red[tid] = s;
  __syncthreads();
  for (int h = RED / 2; h > 0; h >>= 1) {
    if (tid < h) red[tid] += red[tid + h];
    __syncthreads();
  }
  if (tid == 0) cw[j] = maskf[j] > 0.f ? red[0] : 0.f;
}

// ---------------------------------------------------------------------------
// fused_mma_kernel: bf16 X, EPI_MIN and EPI_ARGMIN_WEIGHT on the tensor cores
// ---------------------------------------------------------------------------

constexpr int MMA_WARPS = THREADS / 32;
constexpr int MBR = MMA_WARPS * 32;  // rows a tile (= MIN_ROWS)
constexpr int KCH = 64;              // features an A tile holds (4 k-steps)
constexpr int AS = KCH + 8;          // A tile (and streamed Y chunk) stride
constexpr int NC = 4;                // n8 target tiles a pass
constexpr int MAX_STAGES = 4;        // X ring stages, at most
constexpr int SLOTB = 160;           // raw bytes a row of a feature chunk
constexpr int CHW = 1024;            // cw targets a pass of a warp's part
constexpr int RUN_MAX = 2048;        // cw targets summed in shared memory
constexpr int CW_GRID = 264;         // blocks of a run-summed cw (fixed)
constexpr size_t YRES_MAX = 96 * 1024;          // resident Y budget
constexpr size_t MMA_SMEM_MAX = 232448 - 1024;  // 227 KB less headroom
constexpr size_t SMEM_TWO_BLOCKS = 233472 / 2 - 1024;  // two blocks an SM
static_assert(MBR == MIN_ROWS, "cw_part is sized by MIN_ROWS rows a tile");
static_assert(CHW * 4 <= 32 * AS * 2, "a warp's part fits in its A rows");
static_assert(CHW % THREADS == 0 && CHW / THREADS <= 32, "column bits");

// the shared-memory layout of one launch (byte offsets)
struct MmaPlan {
  int nfc;       // feature chunks of KCH
  int dp;        // d rounded up to 16
  int mp;        // m rounded up to 8
  int resident;  // all of Y in shared memory
  int ys;        // stride of the Y rows in shared memory
  int run;       // cw summed a warp in shared memory over its tiles
  int nstage;    // X stages (the ring with one chunk)
  int rawb;      // bytes of an X stage
  int off_a, off_y, off_y2, off_vl, off_lab, off_run, off_bar, smem;
};

__host__ inline int round16(long b) { return (int)((b + 15) / 16 * 16); }

// the layout with ns X stages
void mma_layout(MmaPlan& p, int epi, int m, int ns) {
  p.nstage = ns;
  const int yrows = p.resident ? p.mp + 8 : NC * 8;
  p.off_a = p.nstage * p.rawb;
  p.off_y = p.off_a + MBR * AS * 2;
  p.off_y2 = p.off_y + yrows * p.ys * 2;
  p.off_vl = p.off_y2 + yrows * 4;
  p.off_lab = round16(p.off_vl + (p.resident ? (p.mp / 8 + 1) * 4 : 0));
  p.off_run = p.off_lab + (epi == EPI_ARGMIN_WEIGHT ? MBR * 8 : 0);
  p.off_bar = round16(p.off_run + (p.run ? MMA_WARPS * m * 4 : 0));
  p.smem = p.off_bar + 2 * p.nstage * 8;
}

MmaPlan mma_plan(int epi, int m, int d) {
  MmaPlan p;
  p.nfc = (d + KCH - 1) / KCH;
  p.dp = (d + 15) / 16 * 16;
  p.mp = (m + 7) / 8 * 8;
  // resident: the valid target tiles and one all-masked tile that pads
  // their count to even
  const size_t yres = (size_t)(p.mp + 8) * (p.dp + 8) * 2 +
                      (size_t)(p.mp + 8) * 4 + (size_t)(p.mp / 8 + 1) * 4;
  p.resident = yres <= YRES_MAX;
  p.ys = p.resident ? p.dp + 8 : AS;
  p.run = epi == EPI_ARGMIN_WEIGHT && m <= RUN_MAX;
  // one chunk: the tile's span, its misalignment (< 16 bytes) and the
  // repack's last 4-byte read past it; more: a slot of SLOTB bytes a row
  p.rawb = p.nfc == 1 ? round16(2L * MBR * d + 32) : MBR * SLOTB;
  if (p.nfc > 1) {
    mma_layout(p, epi, m, 1);
    return p;
  }
  // the deepest ring that leaves room for two blocks an SM
  for (int ns = MAX_STAGES; ns >= 2; --ns) {
    mma_layout(p, epi, m, ns);
    if ((size_t)p.smem <= SMEM_TWO_BLOCKS) return p;
  }
  return p;
}

__device__ __forceinline__ void mbar_init(unsigned long long* b,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(b)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned long long* b,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(b)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(b))
               : "memory");
}

// wait for the phase of parity `parity` to complete
__device__ __forceinline__ void mbar_wait(unsigned long long* b,
                                          unsigned parity) {
  const unsigned a = smem_u32(b);
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from device
// memory to dst, the barrier told of their arrival
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c += a (16 x 16, row-major) x b (16 x 8, column-major), bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// features [f0, f0 + fcw) of rows [0, nrows) of the tile at row0, row r
// into the slot of SLOTB bytes at raw + r * SLOTB (element e at byte
// (its address & 15) + 2e): 16-byte cp.async and the plain ends, by the
// block's threads
__device__ __forceinline__ void stage_rows(unsigned char* raw,
                                           const __nv_bfloat16* X, long row0,
                                           int nrows, int d, int f0, int fcw,
                                           int tid) {
  constexpr int PIECES = (2 * KCH) / 16;
  for (int it = tid; it < nrows * PIECES; it += THREADS) {
    const int r = it / PIECES, q = it - r * PIECES;
    const uintptr_t gs =
        reinterpret_cast<uintptr_t>(X + (row0 + r) * (long)d + f0);
    const uintptr_t lo = (gs + 15) & ~(uintptr_t)15;
    const uintptr_t hi = (gs + 2 * fcw) & ~(uintptr_t)15;
    if (lo + 16 * (q + 1) <= hi)
      cp_async16(raw + r * SLOTB + (lo - (gs & ~(uintptr_t)15)) + 16 * q,
                 reinterpret_cast<const void*>(lo + 16 * q));
  }
  for (int it = tid; it < nrows * 16; it += THREADS) {
    const int r = it >> 4;
    const uintptr_t gs =
        reinterpret_cast<uintptr_t>(X + (row0 + r) * (long)d + f0);
    const uintptr_t lo = (gs + 15) & ~(uintptr_t)15;
    uintptr_t hi = (gs + 2 * fcw) & ~(uintptr_t)15;
    if (hi < lo) hi = lo;
    plain_ends(raw + r * SLOTB, gs, fcw, lo, hi, it & 15);
  }
}

// one 16-byte group of the A tile: row r's columns [c0, c0 + 8) from raw
// (row r's element c at byte off + 2c), zero at c >= fcw
__device__ __forceinline__ uint4 repack_group(const unsigned char* raw,
                                              int off, int c0, int fcw) {
  unsigned o[4] = {0u, 0u, 0u, 0u};
  if (c0 < fcw) {
    const int b = off + 2 * c0;
    const unsigned* wp = reinterpret_cast<const unsigned*>(raw + (b & ~3));
    unsigned wv[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) wv[i] = wp[i];
    const bool odd = (b & 2) != 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[i] = odd ? __byte_perm(wv[i], wv[i + 1], 0x5432) : wv[i];
      const int c = c0 + 2 * i;
      if (c >= fcw)
        o[i] = 0u;
      else if (c + 1 >= fcw)
        o[i] &= 0xffffu;
    }
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// raw -> one warp's 32 rows of the A tile, by its lanes (8 a row): the
// first 16 ksc columns, zero at r >= nrows
template <typename Off>
__device__ __forceinline__ void repack_warp(const unsigned char* raw,
                                            __nv_bfloat16* As, int warp,
                                            int nrows, int fcw, int ksc,
                                            Off off, int lane) {
  const int c8 = lane & 7;
  if (c8 >= 2 * ksc) return;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int r = warp * 32 + (lane >> 3) + 4 * q;
    *reinterpret_cast<uint4*>(As + r * AS + 8 * c8) =
        r < nrows ? repack_group(raw, off(r), 8 * c8, fcw)
                  : make_uint4(0u, 0u, 0u, 0u);
  }
}

// |x|^2 of A tile row `row` continued over its first fcw columns, in order
// (the zero columns past them, up to a multiple of 8, leave it as it is)
__device__ __forceinline__ float x2_chain(const __nv_bfloat16* As, int row,
                                          int fcw, float x2) {
  const uint4* rp = reinterpret_cast<const uint4*>(As + row * AS);
  for (int c8 = 0; c8 < (fcw + 7) / 8; ++c8) {
    const uint4 v = rp[c8];
    const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float lo = __uint_as_float(u[i] << 16);
      const float hi = __uint_as_float(u[i] & 0xffff0000u);
      x2 = fmaf(lo, lo, x2);
      x2 = fmaf(hi, hi, x2);
    }
  }
  return x2;
}

// the pass's Y chunk when Y streams: targets [t0, t0 + NC * 8), features
// [f0, f0 + fcw) zero-padded to 16 ksc, into Yc (stride AS) and |y|^2 (+inf
// for a masked or absent target) into y2c, by the block's threads;
// whether this thread saw a valid target
__device__ __forceinline__ bool stage_ychunk(__nv_bfloat16* Yc, float* y2c,
                                             const float* Y, const float* y2,
                                             const float* maskf, int m, int d,
                                             int t0, int f0, int fcw, int ksc,
                                             int tid) {
  for (int it = tid; it < NC * 8 * (KCH / 2); it += THREADS) {
    const int s = it / (KCH / 2), k = 2 * (it % (KCH / 2));
    if (k >= 16 * ksc) continue;
    const int tg = t0 + s;
    const float* yr = Y + (long)tg * d + f0;
    const float v0 = tg < m && k < fcw ? yr[k] : 0.f;
    const float v1 = tg < m && k + 1 < fcw ? yr[k + 1] : 0.f;
    *reinterpret_cast<__nv_bfloat162*>(Yc + s * AS + k) =
        __floats2bfloat162_rn(v0, v1);
  }
  bool any = false;
  if (tid < NC * 8) {
    const int tg = t0 + tid;
    any = tg < m && maskf[tg] > 0.f;
    y2c[tid] = any ? y2[tg] : CUDART_INF_F;
  }
  return any;
}

// a warp's share of one pass: acc[mt][j] += A rows (two m16 tiles) x the
// pass's target tile j < NS over ksc k-steps, two target tiles a B load;
// yb points at the pass's first target row, feature f0
template <int NS>
__device__ __forceinline__ void mma_pass(float (&acc)[2][NC][4],
                                         const unsigned (&af)[2][4][4],
                                         const __nv_bfloat16* yb, int ys,
                                         int ksc, int lane) {
  static_assert(NS % 2 == 0 && NS <= NC, "pairs of target tiles");
  const int trow = (lane & 7) + ((lane >> 4) << 3);  // target row a lane
  const unsigned addr =
      smem_u32(yb + trow * ys + ((lane >> 3) & 1) * 8);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    if (ks < ksc) {
#pragma unroll
      for (int jp = 0; jp < NS; jp += 2) {
        unsigned b[4];
        ldsm_x4(b, addr + (jp * 8 * ys + ks * 16) * 2);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][jp], af[mt][ks], b[0], b[1]);
          mma_bf16(acc[mt][jp + 1], af[mt][ks], b[2], b[3]);
        }
      }
    }
  }
}

// the A fragments of a warp's two m16 tiles over ksc k-steps
__device__ __forceinline__ void load_a(unsigned (&af)[2][4][4],
                                       const __nv_bfloat16* As, int warp,
                                       int ksc, int lane) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const unsigned addr = smem_u32(
        As + (warp * 32 + mt * 16 + (lane & 15)) * AS + (lane >> 4) * 8);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      if (ks < ksc) ldsm_x4(af[mt][ks], addr + ks * 32);
  }
}

// fold a pass's scores into this thread's rows (mt, h: row g + 8 h of m16
// tile mt): y2b the pass's |y|^2, tgt(j) the first target of its tile j.
// IDX: the argmin too, targets in increasing index with a strict <; else
// the minimum alone (fminf: the value the strict < keeps, NaN skipped)
template <int NS, bool IDX, typename Tgt>
__device__ __forceinline__ void merge_pass(const float (&acc)[2][NC][4],
                                           const float* y2b, Tgt tgt, int t,
                                           float (&best)[2][2],
                                           int (&bi)[2][2]) {
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const float2 yy = *reinterpret_cast<const float2*>(y2b + 8 * j + 2 * t);
    const int c = IDX ? tgt(j) + 2 * t : 0;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float s0 = yy.x - 2.0f * acc[mt][j][2 * h];
        const float s1 = yy.y - 2.0f * acc[mt][j][2 * h + 1];
        if (!IDX) {
          best[mt][h] = fminf(best[mt][h], fminf(s0, s1));
          continue;
        }
        if (s0 < best[mt][h]) {
          best[mt][h] = s0;
          bi[mt][h] = c;
        }
        if (s1 < best[mt][h]) {
          best[mt][h] = s1;
          bi[mt][h] = c + 1;
        }
      }
  }
}

__device__ __forceinline__ void zero_acc(float (&acc)[2][NC][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][j][q] = 0.f;
}

// does the tile hold a row whose group is needed?
__device__ __forceinline__ bool tile_needed(const unsigned char* gneed,
                                            int group_rows, int tile, int n) {
  if (gneed == nullptr) return true;
  const long r0 = (long)tile * MBR;
  const long r1 = min((long)n, r0 + MBR) - 1;
  for (long gi = r0 / group_rows; gi <= r1 / group_rows; ++gi)
    if (gneed[gi]) return true;
  return false;
}

// the straight-line products (added to acc) and fold of a pass of an even
// count of target tiles ns (2 or NC)
__device__ __forceinline__ void mma_ns(int ns, float (&acc)[2][NC][4],
                                       const unsigned (&af)[2][4][4],
                                       const __nv_bfloat16* yb, int ys,
                                       int ksc, int lane) {
  if (ns == 2)
    mma_pass<2>(acc, af, yb, ys, ksc, lane);
  else
    mma_pass<NC>(acc, af, yb, ys, ksc, lane);
}

template <bool IDX, typename Tgt>
__device__ __forceinline__ void merge_ns(int ns, const float (&acc)[2][NC][4],
                                         const float* y2b, Tgt tgt, int t,
                                         float (&best)[2][2],
                                         int (&bi)[2][2]) {
  if (ns == 2)
    merge_pass<2, IDX>(acc, y2b, tgt, t, best, bi);
  else
    merge_pass<NC, IDX>(acc, y2b, tgt, t, best, bi);
}

// one pass over the A tile's features [f0, f0 + fcw) (ksc k-steps): the
// resident target tiles tc NC .. tc NC + NC - 1 of vl (their count padded
// to even), or, with Y streaming, the targets [tc NC 8, tc NC 8 + NC 8)
// staged now by the block (false when none of them is valid);
// merge folds the scores into best / bi (IDX: the argmin too)
template <bool IDX>
__device__ __forceinline__ bool run_pass(
    const MmaPlan& P, int tc, int f0, int fcw, int ksc, bool merge,
    float (&acc)[2][NC][4], const unsigned (&af)[2][4][4],
    float (&best)[2][2], int (&bi)[2][2], __nv_bfloat16* Ys, float* y2s,
    const int* vl, int nv, int nt8, const float* Y, const float* y2,
    const float* maskf, int m, int d, int tid) {
  const int lane = tid & 31, t = lane & 3;
  if (P.resident) {
    const int ns = min(NC, nv - tc * NC);
    mma_ns(ns, acc, af, Ys + tc * NC * 8 * P.ys + f0, P.ys, ksc, lane);
    if (merge)
      merge_ns<IDX>(ns, acc, y2s + tc * NC * 8,
               [&](int j) { return vl[tc * NC + j] * 8; }, t, best, bi);
    return true;
  }
  // the chunk's rows are staged whole (+inf past m): an odd count of tiles
  // rounds up
  const int ns = (min(NC, nt8 - tc * NC) + 1) & ~1;
  __syncthreads();  // the previous pass has read the chunk
  const bool any = stage_ychunk(Ys, y2s, Y, y2, maskf, m, d, tc * NC * 8, f0,
                                fcw, ksc, tid);
  if (!__syncthreads_or(any)) return false;
  mma_ns(ns, acc, af, Ys, AS, ksc, lane);
  if (merge)
    merge_ns<IDX>(ns, acc, y2s, [&](int j) { return (tc * NC + j) * 8; }, t,
                  best, bi);
  return true;
}

// a tile's results: the quads' minima merged (EPI_MIN: the minimum alone;
// else the lower index wins a tie), then min + |x|^2 (EPI_MIN; x2 is the
// |x|^2 of the warp's row `lane`) or the argmin and its weights
// (EPI_ARGMIN_WEIGHT): a warp's 32 rows are one segment, summed by label in
// row order by shuffles (the f32 kernel's rule), and added to the warp's
// running sums (run_w) or, without them, written as the tile's cw partial
// column (the warps meet before its parts are read and after;
// colbits bit q: target tid + q THREADS of the first CHW valid)
template <int EPI>
__device__ __forceinline__ void finish_tile(
    int tile, int nrows, float (&best)[2][2], int (&bi)[2][2], float x2,
    __nv_bfloat16* As, int* lab, float* wsm, float* run_w,
    const unsigned char* gneed, int group_rows, const float* x2ext,
    const float* w, const float* maskf, unsigned colbits, int m, int ntiles,
    int* am_out, float* min_out, float* cw_part, int tid) {
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const long row0 = (long)tile * MBR;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best[mt][h], o);
        if (EPI == EPI_MIN) {
          best[mt][h] = fminf(best[mt][h], ob);
          continue;
        }
        const int oi = __shfl_xor_sync(0xffffffffu, bi[mt][h], o);
        if (ob < best[mt][h] || (ob == best[mt][h] && oi < bi[mt][h])) {
          best[mt][h] = ob;
          bi[mt][h] = oi;
        }
      }
  if (EPI == EPI_MIN) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int lr = mt * 16 + h * 8 + g;  // the row in the warp
        const float xr = __shfl_sync(0xffffffffu, x2, lr);
        const int r = warp * 32 + lr;
        if (t == 0 && r < nrows) {
          const long row = row0 + r;
          if (gneed != nullptr && !gneed[row / group_rows])
            min_out[row] = CUDART_INF_F;
          else
            min_out[row] = fmaxf(
                best[mt][h] + (x2ext != nullptr ? x2ext[row] : xr), 0.f);
        }
      }
    return;
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 32 + mt * 16 + h * 8 + g;
      if (t == 0) {
        const bool v = r < nrows;
        if (v) am_out[row0 + r] = bi[mt][h];
        lab[r] = v ? bi[mt][h] : -1;
        wsm[r] = v ? w[row0 + r] : 0.f;
      }
    }
  __syncwarp();
  const int l = lab[warp * 32 + lane];
  const float wv = wsm[warp * 32 + lane];
  float sw = 0.f;
#pragma unroll
  for (int src = 0; src < 32; ++src) {
    const int ls = __shfl_sync(0xffffffffu, l, src);
    const float ws = __shfl_sync(0xffffffffu, wv, src);
    if (ls == l) sw += ws;
  }
  const bool lead = lane == __ffs(__match_any_sync(0xffffffffu, l)) - 1;
  if (run_w != nullptr) {
    if (lead && l >= 0) run_w[l] += sw;
    __syncwarp();  // lab and wsm are read before the next tile's
    return;
  }
  // the warp's part lies over its own rows of the A tile, which it has read
  float* const part_w = reinterpret_cast<float*>(As + warp * 32 * AS);
  for (int j0 = 0; j0 < m; j0 += CHW) {
    const int cn = min(CHW, m - j0);
    for (int e = lane; e < cn; e += 32) part_w[e] = 0.f;
    __syncwarp();
    if (lead && l >= j0 && l < j0 + cn) part_w[l - j0] = sw;
    __syncthreads();
#pragma unroll 1
    for (int q = 0; q * THREADS < cn; ++q) {
      const int jj = tid + q * THREADS;
      if (jj >= cn) break;
      const bool valid =
          j0 == 0 ? ((colbits >> q) & 1u) != 0 : maskf[j0 + jj] > 0.f;
      float s = 0.f;
      if (valid)
        for (int sg = 0; sg < MMA_WARPS; ++sg)
          s += reinterpret_cast<const float*>(As + sg * 32 * AS)[jj];
      cw_part[(long)(j0 + jj) * ntiles + tile] = s;
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void reset_best(float (&best)[2][2],
                                           int (&bi)[2][2]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      best[mt][h] = CUDART_INF_F;
      bi[mt][h] = 0;
    }
}

template <int EPI>
__global__ void __launch_bounds__(THREADS, 2)
fused_mma_kernel(const __nv_bfloat16* __restrict__ X,
                 const float* __restrict__ Y, const float* __restrict__ y2,
                 const float* __restrict__ maskf,
                 const unsigned char* __restrict__ gneed, int group_rows,
                 const float* __restrict__ x2ext,
                 const float* __restrict__ w, int n, int m, int d, MmaPlan P,
                 int* __restrict__ am_out, float* __restrict__ min_out,
                 float* __restrict__ cw_part) {
  static_assert(EPI == EPI_MIN || EPI == EPI_ARGMIN_WEIGHT, "epilogue");
  extern __shared__ __align__(16) unsigned char sm[];
  __shared__ int s_count;
  __nv_bfloat16* const As = reinterpret_cast<__nv_bfloat16*>(sm + P.off_a);
  __nv_bfloat16* const Ys = reinterpret_cast<__nv_bfloat16*>(sm + P.off_y);
  float* const y2s = reinterpret_cast<float*>(sm + P.off_y2);
  int* const vl = reinterpret_cast<int*>(sm + P.off_vl);
  int* const lab = reinterpret_cast<int*>(sm + P.off_lab);
  float* const wsm = reinterpret_cast<float*>(lab + MBR);
  float* const run = reinterpret_cast<float*>(sm + P.off_run);
  unsigned long long* const full =
      reinterpret_cast<unsigned long long*>(sm + P.off_bar);
  unsigned long long* const empty = full + P.nstage;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ntiles = (n + MBR - 1) / MBR;
  const int nt8 = P.mp / 8;
  const int ksall = P.dp / 16;
  const bool own_x2 = EPI == EPI_MIN && x2ext == nullptr;
  float* const run_w =
      EPI == EPI_ARGMIN_WEIGHT && P.run ? run + warp * m : nullptr;
  // a run-summed cw has one partial column a block (a fixed grid)
  const int ncol = P.run ? (int)gridDim.x : ntiles;

  if (tid == 0) {
    for (int s = 0; s < P.nstage; ++s) {
      // the bulk copy and the plain ends; every warp
      mbar_init(full + s, 2);
      mbar_init(empty + s, MMA_WARPS);
    }
    mbar_fence_init();
  }
  if (run_w != nullptr)
    for (int j = lane; j < m; j += 32) run_w[j] = 0.f;
  // the targets: resident, the valid n8 tiles compacted in order (vl; an
  // odd count padded with one all-masked tile past the last) and their
  // rows and |y|^2 staged; streaming, whether any target is valid
  int nv;
  if (P.resident) {
    if (warp == 0) {
      int cnt = 0;
      for (int b0 = 0; b0 < nt8; b0 += 32) {
        const int nt = b0 + lane;
        bool v = false;
        if (nt < nt8)
          for (int j = 0; j < 8; ++j) {
            const int tg = nt * 8 + j;
            v = v || (tg < m && maskf[tg] > 0.f);
          }
        const unsigned bal = __ballot_sync(0xffffffffu, v);
        if (v) vl[cnt + __popc(bal & ((1u << lane) - 1u))] = nt;
        cnt += __popc(bal);
      }
      if (lane == 0) {
        if (cnt & 1) vl[cnt++] = nt8;
        s_count = cnt;
      }
    }
    __syncthreads();
    nv = s_count;
    // YU pairs a thread loaded before any is stored: the loads overlap
    constexpr int YU = 4;
    const int hp = P.dp / 2;  // bf16 pairs a row
    const int total = nv * 8 * hp;
    for (int it0 = tid; it0 < total; it0 += YU * THREADS) {
      float v[YU][2];
      int at[YU];
#pragma unroll
      for (int u = 0; u < YU; ++u) {
        const int it = it0 + u * THREADS;
        const int row = it / hp, k = 2 * (it - row * hp);
        const int tg = it < total ? vl[row >> 3] * 8 + (row & 7) : m;
        const float* yr = Y + (long)tg * d;
        v[u][0] = tg < m && k < d ? yr[k] : 0.f;
        v[u][1] = tg < m && k + 1 < d ? yr[k + 1] : 0.f;
        at[u] = it < total ? row * P.ys + k : -1;
      }
#pragma unroll
      for (int u = 0; u < YU; ++u)
        if (at[u] >= 0)
          *reinterpret_cast<__nv_bfloat162*>(Ys + at[u]) =
              __floats2bfloat162_rn(v[u][0], v[u][1]);
    }
    for (int row = tid; row < nv * 8; row += THREADS) {
      const int tg = vl[row >> 3] * 8 + (row & 7);
      y2s[row] = tg < m && maskf[tg] > 0.f ? y2[tg] : CUDART_INF_F;
    }
    __syncthreads();
  } else {
    bool any = false;
    for (int j = tid; j < m; j += THREADS) any = any || maskf[j] > 0.f;
    nv = __syncthreads_or(any) ? 1 : 0;
  }

  // tiles skipped by their groups, and every tile when no target is valid
  // (X is then never read: min +inf, argmin 0, cw 0)
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    if (nv > 0 && tile_needed(gneed, group_rows, tile, n)) continue;
    const long r0 = (long)tile * MBR;
    const int nr = (int)min((long)MBR, (long)n - r0);
    if (tid < nr) {
      if (EPI == EPI_MIN)
        min_out[r0 + tid] = CUDART_INF_F;
      else
        am_out[r0 + tid] = 0;
    }
    if (EPI == EPI_ARGMIN_WEIGHT && !P.run)
      for (int j = tid; j < m; j += THREADS)
        cw_part[(long)j * ntiles + tile] = 0.f;
  }
  if (nv == 0) {
    if (EPI == EPI_ARGMIN_WEIGHT && P.run)
      for (int j = tid; j < m; j += THREADS)
        cw_part[(long)j * ncol + blockIdx.x] = 0.f;
    return;
  }

  auto next_tile = [&](int tile) {
    for (; tile < ntiles; tile += gridDim.x)
      if (tile_needed(gneed, group_rows, tile, n)) return tile;
    return ntiles;
  };
  const int npass = P.resident ? (nv + NC - 1) / NC : (nt8 + NC - 1) / NC;
  unsigned colbits = 0;  // the first CHW targets' validity, a thread's
  if (EPI == EPI_ARGMIN_WEIGHT && !P.run)
    for (int q = 0; q * THREADS < min(m, CHW); ++q) {
      const int j = tid + q * THREADS;
      if (j < m && maskf[j] > 0.f) colbits |= 1u << q;
    }
  float acc[2][NC][4];
  unsigned af[2][4][4];
  float best[2][2];
  int bi[2][2];

  if (P.nfc == 1) {
    // the ring: warp 0 also produces, S - 1 tiles ahead of its own. A
    // tile's stage is refilled once every warp has repacked its
    // rows; its 16-byte-aligned middle comes in one bulk copy (the full
    // barrier's first arrival, with the bytes), its plain ends are loaded
    // then and stored at warp 0's next production (the second arrival), so
    // that no warp waits on them
    const int S = P.nstage;
    int ptile = next_tile(blockIdx.x), pk = 0, pstage = -1;
    Plain pend;
    pend.p = nullptr;
    auto produce = [&]() {
      if (pstage >= 0) {
        if (pend.p != nullptr) *pend.p = pend.v;
        __syncwarp();
        if (lane == 0) mbar_arrive(full + pstage);
        pstage = -1;
      }
      if (ptile >= ntiles) return;
      const int s = pk % S, u = pk / S;
      if (u > 0) mbar_wait(empty + s, (u - 1) & 1);
      unsigned char* const raw = sm + s * P.rawb;
      const long r0 = (long)ptile * MBR;
      const long count = min((long)MBR, (long)n - r0) * d;
      const uintptr_t gs = reinterpret_cast<uintptr_t>(X + r0 * d);
      const uintptr_t lo = (gs + 15) & ~(uintptr_t)15;
      uintptr_t hi = (gs + 2 * count) & ~(uintptr_t)15;
      if (hi < lo) hi = lo;
      if (lane == 0) {
        mbar_expect_tx(full + s, (unsigned)(hi - lo));
        if (hi > lo)
          bulk_copy(raw + (lo - (gs & ~(uintptr_t)15)),
                    reinterpret_cast<const void*>(lo), (unsigned)(hi - lo),
                    full + s);
      }
      plain_load(raw, gs, count, lo, hi, lane, pend);
      pstage = s;
      ptile = next_tile(ptile + gridDim.x);
      ++pk;
    };
    if (warp == 0)
      for (int i = 0; i < S - 1; ++i) produce();
    int k = 0;
    for (int tile = next_tile(blockIdx.x); tile < ntiles;
         tile = next_tile(tile + gridDim.x), ++k) {
      if (warp == 0) produce();
      const int s = k % S, u = k / S;
      mbar_wait(full + s, u & 1);
      const long row0 = (long)tile * MBR;
      const int nrows = (int)min((long)MBR, (long)n - row0);
      const int h0 = (int)(reinterpret_cast<uintptr_t>(X + row0 * d) & 15);
      repack_warp(sm + s * P.rawb, As, warp, nrows, d, ksall,
                  [&](int r) { return h0 + 2 * r * d; }, lane);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);
      const float x2 =
          own_x2 ? x2_chain(As, warp * 32 + lane, d, 0.f) : 0.f;
      load_a(af, As, warp, ksall, lane);
      reset_best(best, bi);
      for (int tc = 0; tc < npass; ++tc) {
        zero_acc(acc);
        run_pass<EPI == EPI_ARGMIN_WEIGHT>(P, tc, 0, d, ksall, true, acc, af,
                                           best, bi, Ys, y2s, vl, nv, nt8, Y,
                                           y2, maskf, m, d, tid);
      }
      finish_tile<EPI>(tile, nrows, best, bi, x2, As, lab, wsm, run_w, gneed,
                       group_rows, x2ext, w, maskf, colbits, m, ntiles,
                       am_out, min_out, cw_part, tid);
      __syncwarp();  // this warp's A rows are read before the next repack
    }
  } else {
    // d beyond KCH: chunks of KCH features, each staged row by row by the
    // block and waited for; a pass's sums carried over the chunks in
    // registers, |x|^2 summed over the chunks in order in the first pass
    // that scores
    unsigned char* const raw = sm;
    for (int tile = next_tile(blockIdx.x); tile < ntiles;
         tile = next_tile(tile + gridDim.x)) {
      const long row0 = (long)tile * MBR;
      const int nrows = (int)min((long)MBR, (long)n - row0);
      reset_best(best, bi);
      float x2 = 0.f;
      bool x2_open = own_x2;
      for (int tc = 0; tc < npass; ++tc) {
        zero_acc(acc);
        float x2p = 0.f;
        bool live = true;
        for (int fc = 0; fc < P.nfc && live; ++fc) {
          const int f0 = fc * KCH, fcw = min(KCH, d - f0);
          const int ksc = (fcw + 15) / 16;
          __syncthreads();  // the last chunk's readers are done
          stage_rows(raw, X, row0, nrows, d, f0, fcw, tid);
          cp_async_commit();
          cp_async_wait<0>();
          __syncthreads();
          repack_warp(raw, As, warp, nrows, fcw, ksc,
                      [&](int r) {
                        return r * SLOTB +
                               (int)(reinterpret_cast<uintptr_t>(
                                         X + (row0 + r) * (long)d + f0) &
                                     15);
                      },
                      lane);
          __syncwarp();  // a warp reads only its own rows of the A tile
          if (x2_open) x2p = x2_chain(As, warp * 32 + lane, fcw, x2p);
          load_a(af, As, warp, ksc, lane);
          live = run_pass<EPI == EPI_ARGMIN_WEIGHT>(
              P, tc, f0, fcw, ksc, fc == P.nfc - 1, acc, af, best, bi, Ys,
              y2s, vl, nv, nt8, Y, y2, maskf, m, d, tid);
        }
        if (live && x2_open) {
          x2 = x2p;
          x2_open = false;
        }
      }
      finish_tile<EPI>(tile, nrows, best, bi, x2, As, lab, wsm, run_w, gneed,
                       group_rows, x2ext, w, maskf, colbits, m, ntiles,
                       am_out, min_out, cw_part, tid);
    }
  }
  if (EPI == EPI_ARGMIN_WEIGHT && P.run) {
    // the block's partial column: the warps' running sums in warp order
    __syncthreads();
    for (int j = tid; j < m; j += THREADS) {
      float s = 0.f;
      if (maskf[j] > 0.f)
        for (int wg = 0; wg < MMA_WARPS; ++wg) s += run[wg * m + j];
      cw_part[(long)j * ncol + blockIdx.x] = s;
    }
  }
}

template <int EPI>
int launch_mma(cudaStream_t s, const __nv_bfloat16* X, const float* Y,
               const float* y2, const float* maskf,
               const unsigned char* gneed, int group_rows, const float* x2ext,
               const float* w, int n, int m, int d, int* am, float* mn,
               float* cw_part, int* nb) {
  const MmaPlan P = mma_plan(EPI, m, d);
  auto kernel = fused_mma_kernel<EPI>;
  static bool granted = false;
  if (!granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)MMA_SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    granted = true;
  }
  const int ntiles = (n + MBR - 1) / MBR;
  int grid;
  if (P.run) {
    // a fixed grid: the partial columns, so cw's bits, do not depend on
    // the card
    grid = ntiles < CW_GRID ? ntiles : CW_GRID;
  } else {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                         THREADS, P.smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    grid = ntiles < per_sm * sms ? ntiles : per_sm * sms;
  }
  *nb = P.run ? grid : ntiles;
  kernel<<<grid, THREADS, P.smem, s>>>(X, Y, y2, maskf, gneed, group_rows,
                                       x2ext, w, n, m, d, P, am, mn, cw_part);
  return 0;
}

template <int EPI, int TR, int TC, int TG, typename TX>
int launch_tile(cudaStream_t s, const TX* X, const float* Y,
                const float* y2, const float* maskf, const unsigned char* gneed,
                int group_rows, const float* x2ext, const float* w, int n,
                int m, int d, int* am, float* mn, float* mn2, float* cw_part,
                int* nb) {
  using T = Tile<TR, TC, TG>;
  // the span route: bf16 X for K2 and K5, and f32 X for K2-x with one row
  // a thread (every f32 K2 and K5 keeps fused_distance_kernel)
  constexpr bool SPAN_F32 =
      sizeof(TX) == 4 && EPI == EPI_ARGMIN_MIN && TR == 1;
  if constexpr ((sizeof(TX) == 2 &&
                 (EPI == EPI_ARGMIN_MIN || EPI == EPI_ARGMIN_MIN2)) ||
                SPAN_F32) {
    if (d <= FC && (!SPAN_F32 || x2ext != nullptr)) {
      auto span = fused_span_kernel<EPI, TR, TC, TG, TX>;
      // the grant covers the largest d (FC)
      constexpr int SMEM_SPAN = T::smem_span(sizeof(TX));
      static bool span_granted = SMEM_SPAN <= 48 * 1024;
      if (!span_granted) {
        const cudaError_t e = cudaFuncSetAttribute(
            span, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_SPAN);
        if (e != cudaSuccess) return (int)e;
        span_granted = true;
      }
      const int smem = sizeof(TX) == 2 ? SMEM_SPAN : T::smem_span(4, d);
      *nb = (n + T::BR - 1) / T::BR;
      span<<<*nb, THREADS, smem, s>>>(X, Y, y2, maskf, gneed, group_rows,
                                      x2ext, n, m, d, am, mn, mn2);
      return 0;
    }
  }
  auto kernel = fused_distance_kernel<EPI, TR, TC, TG, TX>;
  // above 48 KB a block's shared memory must be granted, once per kernel
  static bool granted = T::SMEM <= 48 * 1024;
  if (!granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (e != cudaSuccess) return (int)e;
    granted = true;
  }
  *nb = (n + T::BR - 1) / T::BR;
  kernel<<<*nb, THREADS, T::SMEM, s>>>(X, Y, y2, maskf, gneed, group_rows,
                                       x2ext, w, n, m, d, am, mn, mn2,
                                       cw_part);
  return 0;
}

// the tile shape depends on m alone, so every epilogue at one m runs the
// same score loop: m <= 8, a row a thread and 8 targets a tile, 128 rows a
// block; m <= 128, 8 rows x 4 targets a thread and 16 targets a tile (a
// k-means|| round's usual 16 valid candidates are one tile), 256 rows a
// block; beyond, 8 rows x 8 targets a thread and 32 targets a tile
template <int EPI, typename TX>
int launch(cudaStream_t s, const TX* X, const float* Y, const float* y2,
           const float* maskf, const unsigned char* gneed, int group_rows,
           const float* x2ext, const float* w, int n, int m, int d, int* am,
           float* mn, float* mn2, float* cw_part, int* nb) {
  if (m <= 8)
    return launch_tile<EPI, 1, 8, 1, TX>(s, X, Y, y2, maskf, gneed, group_rows,
                                     x2ext, w, n, m, d, am, mn, mn2, cw_part,
                                     nb);
  if (m <= 128)
    return launch_tile<EPI, 8, 4, 4, TX>(s, X, Y, y2, maskf, gneed, group_rows,
                                     x2ext, w, n, m, d, am, mn, mn2, cw_part,
                                     nb);
  return launch_tile<EPI, 8, 8, 4, TX>(s, X, Y, y2, maskf, gneed, group_rows,
                                   x2ext, w, n, m, d, am, mn, mn2, cw_part,
                                   nb);
}

}  // namespace

// the fewest rows a block takes: cw_part sized with it fits every tile
extern "C" int dml_fused_rows_per_block() { return MIN_ROWS; }

// the launch of one epilogue for X's element type: bf16 EPI_MIN and
// EPI_ARGMIN_WEIGHT on the tensor cores, every other case the score loop
template <int EPI>
int launch_x(int xbf16, cudaStream_t s, const void* X, const float* Y,
             const float* y2, const float* maskf, const unsigned char* gneed,
             int group_rows, const float* x2ext, const float* w, int n, int m,
             int d, int* am, float* mn, float* mn2, float* cw_part, int* nb) {
  if (xbf16) {
    const __nv_bfloat16* Xb = static_cast<const __nv_bfloat16*>(X);
    if constexpr (EPI == EPI_MIN || EPI == EPI_ARGMIN_WEIGHT)
      return launch_mma<EPI>(s, Xb, Y, y2, maskf, gneed, group_rows, x2ext, w,
                             n, m, d, am, mn, cw_part, nb);
    else
      return launch<EPI>(s, Xb, Y, y2, maskf, gneed, group_rows, x2ext, w, n,
                         m, d, am, mn, mn2, cw_part, nb);
  }
  return launch<EPI>(s, static_cast<const float*>(X), Y, y2, maskf, gneed,
                     group_rows, x2ext, w, n, m, d, am, mn, mn2, cw_part, nb);
}

// All pointers are device pointers; X (n, d) row-major, f32 or (xbf16 != 0)
// bf16, and Y (m, d) row-major f32 (for bf16 X: Y rounded to bf16).
// Outputs: am (n,) int32 for the argmin epilogues, mn (n,) f32 for all but
// EPI_ARGMIN_WEIGHT, mn2 (n,) f32 for EPI_ARGMIN_MIN2, cw_part
// (m, ceil(n / dml_fused_rows_per_block())) scratch and cw (m,) for
// EPI_ARGMIN_WEIGHT. gneed (ceil(n / group_rows),) uint8 or null and x2ext
// (n,) f32 or null, both refused by EPI_ARGMIN_WEIGHT. Returns
// cudaGetLastError() after the launches.
extern "C" int dml_fused_distance(int epilogue, const void* X, int xbf16,
                                  const float* Y, const float* y2,
                                  const float* maskf,
                                  const unsigned char* gneed, int group_rows,
                                  const float* x2ext, const float* w, int n,
                                  int m, int d, int* am, float* mn, float* mn2,
                                  float* cw_part, float* cw, void* stream) {
  if (n <= 0 || m <= 0 || d <= 0 || (gneed != nullptr && group_rows <= 0))
    return (int)cudaErrorInvalidValue;
  if (epilogue == EPI_ARGMIN_WEIGHT && (gneed != nullptr || x2ext != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int nb = 0, err = 0;
#define DML_EPI(E)                                                      \
  launch_x<E>(xbf16, s, X, Y, y2, maskf, gneed, group_rows, x2ext, w, n, m, \
              d, am, mn, mn2, cw_part, &nb)
  switch (epilogue) {
    case EPI_MIN:
      err = DML_EPI(EPI_MIN);
      break;
    case EPI_ARGMIN_MIN:
      err = DML_EPI(EPI_ARGMIN_MIN);
      break;
    case EPI_ARGMIN_WEIGHT:
      err = DML_EPI(EPI_ARGMIN_WEIGHT);
      if (err == 0) cw_reduce_kernel<<<m, RED, 0, s>>>(cw_part, maskf, nb, cw);
      break;
    case EPI_ARGMIN_MIN2:
      err = DML_EPI(EPI_ARGMIN_MIN2);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DML_EPI
  return err != 0 ? err : (int)cudaGetLastError();
}
