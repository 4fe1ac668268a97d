// Fused squared-distance reductions for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel dask_ml_tpu/ops/fused_distance.py::_fused_pallas
// with three of its epilogues:
//   EPI_MIN            per-row min d2 over valid targets, with an optional
//                      per-group need flag (k-means|| rounds, "min")
//   EPI_ARGMIN_MIN     per-row (argmin, min d2) ("argmin_min")
//   EPI_ARGMIN_WEIGHT  per-row argmin plus cw[j] = sum_i w_i [argmin_i == j]
//                      ("argmin_weight", k-means|| candidate weighting)
//
// What it computes is the reference's: scores s_j = |y_j|^2 - 2 x.y_j with
// |y|^2 precomputed in f32 from the original Y by the caller, masked
// targets never win, ties go to the lowest index (the running minimum is
// replaced only on a strict <), an all-masked Y gives (0, +inf), and the
// min value is max(min_j s_j + |x|^2, 0) with |x|^2 summed here in f32.
//
// Bound on the H100 (slice shapes n = 1e6, d = 50): with m = 8 targets the
// kernel must read 200 MB of X and does 0.8 GFLOP, so HBM bandwidth bounds
// it; with m = 80 or 329 the f32 FMA work (8 and 33 GFLOP) bounds it.
// Design against those bounds, first version (simple and right):
//   * a block owns 128 rows of X, one per thread; the tile is read with
//     coalesced loads into shared memory, transposed with a padded stride
//     so both the stores and the per-thread column reads are free of bank
//     conflicts; X is read from HBM once when d <= 64 (one feature chunk);
//   * Y streams through shared memory in tiles of TM targets (8 or 32), so
//     there is no bound on m or d from shared memory (the TPU version held
//     all of Y in VMEM and was limited to m <= 1024, d <= 512);
//   * each thread keeps TM dot products in registers and reads the target
//     tile with 16-byte broadcast loads: one shared load of x feeds TM FMAs;
//   * no tensor cores: TF32 would break parity with the f32 reference;
//   * the cross-block sum of the candidate weights is not done with float
//     atomics: each block writes its partial column (rows summed in order)
//     and a second kernel reduces the columns in a fixed order, so cw is
//     bit-reproducible from run to run.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int ROWS = 128;       // X rows per block, one per thread
constexpr int FC = 64;          // features per shared-memory chunk
constexpr int XS = ROWS + 1;    // padded stride of the transposed X tile
constexpr int RED = 256;        // threads of the cw reduction

enum { EPI_MIN = 0, EPI_ARGMIN_MIN = 1, EPI_ARGMIN_WEIGHT = 2 };

template <int EPI, int TM>
__global__ void __launch_bounds__(ROWS)
fused_distance_kernel(const float* __restrict__ X, const float* __restrict__ Y,
                      const float* __restrict__ y2,
                      const float* __restrict__ maskf,
                      const unsigned char* __restrict__ gneed, int group_rows,
                      const float* __restrict__ w, int n, int m, int d,
                      int* __restrict__ am_out, float* __restrict__ min_out,
                      float* __restrict__ cw_part) {
  __shared__ float xs[FC * XS];
  __shared__ __align__(16) float ys[FC * TM];
  __shared__ int lab[ROWS];
  __shared__ float wsm[ROWS];

  const int tid = threadIdx.x;
  const long row0 = (long)blockIdx.x * ROWS;
  const long row = row0 + tid;
  const bool valid = row < n;
  const int nrows = (int)min((long)ROWS, (long)n - row0);

  // row_need: a group of group_rows rows with no needed row is skipped and
  // writes +inf (the identity of the caller's running minimum)
  bool ev = valid;
  if (EPI == EPI_MIN && gneed != nullptr) {
    ev = valid && gneed[row / group_rows] != 0;
    if (!__syncthreads_or(ev)) {
      if (valid) min_out[row] = CUDART_INF_F;
      return;
    }
  }

  const int nfc = (d + FC - 1) / FC;
  float best = CUDART_INF_F;
  int bi = 0;
  float x2 = 0.f;
  for (int t0 = 0; t0 < m; t0 += TM) {
    float acc[TM];
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[j] = 0.f;
    for (int c = 0; c < nfc; ++c) {
      const int f0 = c * FC;
      const int fc = min(FC, d - f0);
      __syncthreads();  // the previous chunk has been consumed
      if (t0 == 0 || nfc > 1) {
        for (int e = tid; e < ROWS * fc; e += ROWS) {
          const int r = e / fc, f = e - r * fc;
          xs[f * XS + r] = r < nrows ? X[(row0 + r) * d + f0 + f] : 0.f;
        }
      }
      for (int e = tid; e < TM * fc; e += ROWS) {
        const int j = e % TM, f = e / TM;
        ys[f * TM + j] = t0 + j < m ? Y[(long)(t0 + j) * d + f0 + f] : 0.f;
      }
      __syncthreads();
      for (int f = 0; f < fc; ++f) {
        const float xv = xs[f * XS + tid];
        if (t0 == 0) x2 = fmaf(xv, xv, x2);
        const float4* y4 = reinterpret_cast<const float4*>(ys + f * TM);
#pragma unroll
        for (int q = 0; q < TM / 4; ++q) {
          const float4 yv = y4[q];
          acc[4 * q + 0] = fmaf(xv, yv.x, acc[4 * q + 0]);
          acc[4 * q + 1] = fmaf(xv, yv.y, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(xv, yv.z, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(xv, yv.w, acc[4 * q + 3]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const int t = t0 + j;
      if (t < m && maskf[t] > 0.f) {
        const float s = y2[t] - 2.0f * acc[j];
        if (s < best) {
          best = s;
          bi = t;
        }
      }
    }
  }

  if (EPI == EPI_MIN) {
    if (valid) min_out[row] = ev ? fmaxf(best + x2, 0.f) : CUDART_INF_F;
  } else if (EPI == EPI_ARGMIN_MIN) {
    if (valid) {
      am_out[row] = bi;
      min_out[row] = fmaxf(best + x2, 0.f);
    }
  } else {
    if (valid) am_out[row] = bi;
    lab[tid] = bi;
    wsm[tid] = valid ? w[row] : 0.f;
    __syncthreads();
    for (int j = tid; j < m; j += ROWS) {
      float s = 0.f;
      for (int r = 0; r < nrows; ++r)
        if (lab[r] == j) s += wsm[r];
      cw_part[(long)j * gridDim.x + blockIdx.x] = s;
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

template <int EPI>
void launch(int nb, cudaStream_t s, const float* X, const float* Y,
            const float* y2, const float* maskf, const unsigned char* gneed,
            int group_rows, const float* w, int n, int m, int d, int* am,
            float* mn, float* cw_part) {
  if (m <= 8)
    fused_distance_kernel<EPI, 8><<<nb, ROWS, 0, s>>>(
        X, Y, y2, maskf, gneed, group_rows, w, n, m, d, am, mn, cw_part);
  else
    fused_distance_kernel<EPI, 32><<<nb, ROWS, 0, s>>>(
        X, Y, y2, maskf, gneed, group_rows, w, n, m, d, am, mn, cw_part);
}

}  // namespace

extern "C" int dml_fused_rows_per_block() { return ROWS; }

// All pointers are device pointers; X (n, d) and Y (m, d) row-major f32.
// Outputs: am (n,) int32 for the argmin epilogues, mn (n,) f32 for the min
// epilogues, cw_part (m, ceil(n / ROWS)) scratch and cw (m,) for
// EPI_ARGMIN_WEIGHT. gneed (ceil(n / group_rows),) uint8 or null, EPI_MIN
// only. Returns cudaGetLastError() after the launches.
extern "C" int dml_fused_distance(int epilogue, const float* X, const float* Y,
                                  const float* y2, const float* maskf,
                                  const unsigned char* gneed, int group_rows,
                                  const float* w, int n, int m, int d, int* am,
                                  float* mn, float* cw_part, float* cw,
                                  void* stream) {
  if (n <= 0 || m <= 0 || d <= 0 || (gneed != nullptr && group_rows <= 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = (n + ROWS - 1) / ROWS;
  switch (epilogue) {
    case EPI_MIN:
      launch<EPI_MIN>(nb, s, X, Y, y2, maskf, gneed, group_rows, w, n, m, d,
                      am, mn, cw_part);
      break;
    case EPI_ARGMIN_MIN:
      launch<EPI_ARGMIN_MIN>(nb, s, X, Y, y2, maskf, nullptr, 1, w, n, m, d,
                             am, mn, cw_part);
      break;
    case EPI_ARGMIN_WEIGHT:
      launch<EPI_ARGMIN_WEIGHT>(nb, s, X, Y, y2, maskf, nullptr, 1, w, n, m,
                                d, am, mn, cw_part);
      cw_reduce_kernel<<<m, RED, 0, s>>>(cw_part, maskf, nb, cw);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
