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
//
// bf16 X (the JAX kernel's bf16 case: Y cast to X's dtype for -2 x.y, |y|^2
// in f32 from the original Y, f32 accumulation). Only the staging of X
// changes: a 2-byte element cannot be copied alone by cp.async, so a bf16
// X tile is loaded with plain 2-byte loads and widened to f32 as it is
// written to shared memory, and everything after it is the f32 kernel. The
// caller passes Y already rounded to bf16 and widened back to f32, and
// |y|^2 from the original Y. A product of two bf16 values is exact in f32,
// so on any data the bf16 kernel gives the bits of the f32 kernel run on
// X rounded to bf16 and widened back.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

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

template <int EPI, int TR, int TC, int TG, typename TX>
int launch_tile(cudaStream_t s, const TX* X, const float* Y,
                const float* y2, const float* maskf, const unsigned char* gneed,
                int group_rows, const float* x2ext, const float* w, int n,
                int m, int d, int* am, float* mn, float* mn2, float* cw_part,
                int* nb) {
  using T = Tile<TR, TC, TG>;
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

// the launch of one epilogue for X's element type
template <int EPI>
int launch_x(int xbf16, cudaStream_t s, const void* X, const float* Y,
             const float* y2, const float* maskf, const unsigned char* gneed,
             int group_rows, const float* x2ext, const float* w, int n, int m,
             int d, int* am, float* mn, float* mn2, float* cw_part, int* nb) {
  if (xbf16)
    return launch<EPI>(s, static_cast<const __nv_bfloat16*>(X), Y, y2, maskf,
                       gneed, group_rows, x2ext, w, n, m, d, am, mn, mn2,
                       cw_part, nb);
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
