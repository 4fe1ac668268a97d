// One whole Lloyd iteration in one pass over X, for Hopper (sm_90a), plain
// C interface.
//
// Replaces the TPU kernel dask_ml_tpu/models/kmeans.py::_lloyd_iter_pallas.
// Per row: scores |c|^2 - 2 c.x against every center (|c|^2 in f32 from the
// centers), argmin with ties to the lowest index, then the weighted
// accumulation of the (k, d) sums, the (k,) counts and the inertia
// sum_i w_i max(min_j s_ij + |x_i|^2, 0). The new centers and the shift are
// left to the caller, whose _new_centers holds the empty-cluster rule.
//
// Bound on the H100 (slice shape n = 1e6, k = 8, d = 50): the kernel must
// read X and w once, 204 MB, against 0.9 GFLOP, so HBM bandwidth bounds it
// (about 61 us at 3.35 TB/s). Design:
//   * X stays row-major: the TPU version's feature-major transpose was a
//     lane-padding device for (8, 128) tiles and has no use here;
//   * a fixed grid of at most LGRID blocks walks 128-row tiles in a fixed
//     order; each tile is read with coalesced loads into shared memory,
//     transposed with a padded stride (no bank conflicts), so X crosses HBM
//     once per iteration;
//   * the centers (feature-major, for 16-byte broadcast loads) and a
//     block-local (k, d + 1) accumulator of sums and counts live in shared
//     memory; that budget is the port's bound on k and d
//     (dml_lloyd_supported), beyond which the caller takes the two-pass form;
//   * ownership of the accumulator is deterministic: thread f owns column f
//     (the count is column d) and walks the tile's rows in order; no shared
//     or global atomics. Each block writes its partial (sums, counts,
//     inertia) and a second kernel reduces the partials in block order, so
//     the result is bit-reproducible from run to run and from card to card
//     (LGRID does not depend on the card);
//   * no tensor cores: TF32 would break parity with the f32 reference.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stddef.h>

namespace {

constexpr int LR = 128;       // rows per tile, one per thread
constexpr int LXS = LR + 1;   // padded stride of the transposed X tile
constexpr int LKC = 8;        // centers per register chunk
constexpr int LGRID = 528;    // partial count: 4 blocks on each of 132 SMs
constexpr size_t MAX_DYN_SMEM = 232448 - 1024;  // 227 KB less static use

__host__ __device__ inline int padded_k(int k) { return (k + LKC - 1) / LKC * LKC; }

size_t smem_bytes(int k, int d) {
  const size_t kp = padded_k(k);
  return sizeof(float) * ((size_t)d * kp        // centers, feature-major
                          + kp                  // |c|^2
                          + (size_t)k * (d + 1) // sums | counts
                          + (size_t)d * LXS     // transposed X tile
                          + 2 * LR);            // labels, weights
}

__global__ void __launch_bounds__(LR)
lloyd_partial_kernel(const float* __restrict__ X, const float* __restrict__ w,
                     const float* __restrict__ C, int n, int k, int d,
                     float* __restrict__ partial) {
  extern __shared__ __align__(16) float sm[];
  __shared__ float red[LR];
  const int kp = padded_k(k);
  float* ct = sm;                       // [d][kp]
  float* c2 = ct + (size_t)d * kp;      // [kp]
  float* acc = c2 + kp;                 // [k][d + 1]
  float* xs = acc + (size_t)k * (d + 1);  // [d][LXS]
  int* lab = reinterpret_cast<int*>(xs + (size_t)d * LXS);  // [LR]
  float* wsm = reinterpret_cast<float*>(lab + LR);          // [LR]
  const int tid = threadIdx.x;
  const int A = k * (d + 1);

  for (int e = tid; e < d * kp; e += LR) {
    const int f = e / kp, c = e - f * kp;
    ct[e] = c < k ? C[(size_t)c * d + f] : 0.f;
  }
  for (int e = tid; e < A; e += LR) acc[e] = 0.f;
  __syncthreads();
  for (int c = tid; c < kp; c += LR) {
    float s = 0.f;
    for (int f = 0; f < d; ++f) s = fmaf(ct[f * kp + c], ct[f * kp + c], s);
    c2[c] = s;
  }

  float inert = 0.f;
  const long ntiles = ((long)n + LR - 1) / LR;
  for (long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const long row0 = t * LR;
    const int nrows = (int)min((long)LR, (long)n - row0);
    __syncthreads();  // previous tile consumed; c2 written
    for (int e = tid; e < nrows * d; e += LR) {
      const int r = e / d, f = e - r * d;
      xs[f * LXS + r] = X[row0 * d + e];
    }
    __syncthreads();
    if (tid < nrows) {
      float best = CUDART_INF_F, x2 = 0.f;
      int bi = 0;
      for (int c0 = 0; c0 < kp; c0 += LKC) {
        float a[LKC];
#pragma unroll
        for (int q = 0; q < LKC; ++q) a[q] = 0.f;
        for (int f = 0; f < d; ++f) {
          const float xv = xs[f * LXS + tid];
          if (c0 == 0) x2 = fmaf(xv, xv, x2);
          const float4* c4 = reinterpret_cast<const float4*>(ct + f * kp + c0);
          const float4 u = c4[0], v = c4[1];
          a[0] = fmaf(xv, u.x, a[0]);
          a[1] = fmaf(xv, u.y, a[1]);
          a[2] = fmaf(xv, u.z, a[2]);
          a[3] = fmaf(xv, u.w, a[3]);
          a[4] = fmaf(xv, v.x, a[4]);
          a[5] = fmaf(xv, v.y, a[5]);
          a[6] = fmaf(xv, v.z, a[6]);
          a[7] = fmaf(xv, v.w, a[7]);
        }
#pragma unroll
        for (int q = 0; q < LKC; ++q) {
          const int c = c0 + q;
          if (c < k) {
            const float s = c2[c] - 2.0f * a[q];
            if (s < best) {
              best = s;
              bi = c;
            }
          }
        }
      }
      const float wv = w[row0 + tid];
      inert = fmaf(wv, fmaxf(best + x2, 0.f), inert);
      lab[tid] = bi;
      wsm[tid] = wv;
    }
    __syncthreads();
    for (int f = tid; f <= d; f += LR) {
      for (int r = 0; r < nrows; ++r) {
        const float v = f < d ? xs[f * LXS + r] : 1.f;
        float* p = acc + (size_t)lab[r] * (d + 1) + f;
        *p = fmaf(wsm[r], v, *p);
      }
    }
  }
  __syncthreads();

  const size_t P = (size_t)A + 1;
  for (int e = tid; e < A; e += LR) partial[blockIdx.x * P + e] = acc[e];
  red[tid] = inert;
  __syncthreads();
  for (int h = LR / 2; h > 0; h >>= 1) {
    if (tid < h) red[tid] += red[tid + h];
    __syncthreads();
  }
  if (tid == 0) partial[blockIdx.x * P + A] = red[0];
}

// out[e] = sum over blocks b = 0 .. G-1, in order, of partial[b, e]
__global__ void lloyd_reduce_kernel(const float* __restrict__ partial, int G,
                                    int P, float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= P) return;
  float s = 0.f;
  for (int b = 0; b < G; ++b) s += partial[(size_t)b * P + e];
  out[e] = s;
}

}  // namespace

extern "C" int dml_lloyd_max_partials() { return LGRID; }

extern "C" int dml_lloyd_supported(int k, int d) {
  return k >= 1 && d >= 1 && smem_bytes(k, d) <= MAX_DYN_SMEM;
}

// X (n, d) row-major f32, w (n,) f32, C (k, d) f32, all device pointers.
// partial: scratch of at least dml_lloyd_max_partials() * (k (d + 1) + 1)
// floats. out (k (d + 1) + 1,): row c holds the sums of cluster c in
// columns 0 .. d-1 and its count in column d; the last float is the
// inertia. Returns cudaGetLastError() after the launches.
extern "C" int dml_lloyd_iter(const float* X, const float* w, const float* C,
                              int n, int k, int d, float* partial, float* out,
                              void* stream) {
  if (n <= 0 || !dml_lloyd_supported(k, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = smem_bytes(k, d);
  cudaError_t err = cudaFuncSetAttribute(
      lloyd_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long ntiles = ((long)n + LR - 1) / LR;
  const int G = (int)(ntiles < LGRID ? ntiles : LGRID);
  lloyd_partial_kernel<<<G, LR, smem, s>>>(X, w, C, n, k, d, partial);
  const int P = k * (d + 1) + 1;
  lloyd_reduce_kernel<<<(P + 127) / 128, 128, 0, s>>>(partial, G, P, out);
  return (int)cudaGetLastError();
}
