// Blocked-ELL sparse matrix-vector product for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel dask_ml_tpu/ops/sparse.py::_spmv_impl (the
// forward pass of the public spmv). The matrix is a SparseRows container:
// values (n, k) f32 and cols (n, k) int32, row-major, row i holding its
// nonzeros in slots 0 .. k-1, unused slots padded as (col 0, value 0).
// It computes
//     out[i] = sum_j values[i, j] * v[cols[i, j]]      (f32)
// for any n >= 1 and k >= 1; duplicate columns in a row sum, padded slots
// add 0. Column indices are trusted: the port's check_array has already
// held them to [0, d).
//
// Bound on the H100 (the GLM cell: n = 1e7, k = 101 with the intercept
// slot, d = 100,001): the kernel must read values and cols once (8.08 GB),
// write out (40 MB) and read v (0.4 MB), against 2 n k = 2.0e9 FLOPs.
// Bytes bound it: (8.08e9 + 4.0e7 + 4.0e5) / 3.35e12 B/s = 2.42 ms, while
// the FLOPs take 0.03 ms at 67 TFLOP/s. Design, first version (simple and
// right):
//   * a group of L lanes owns one row, L the smallest power of two >= k,
//     at most 32 (one warp per row for the cell's k = 101); the lanes
//     stride over the row's slots, so neighbouring lanes load neighbouring
//     values and cols (coalesced), and for small k one warp serves 32 / L
//     rows, so no lane reads a cache line for nothing;
//   * values and cols are read once with streaming loads (__ldcs) so they
//     do not evict v; v is gathered through the read-only path (__ldg):
//     at d = 100,001 it is 400 KB, beyond the 227 KB of shared memory the
//     TPU version's VMEM-resident (d, 1) block would suggest, but it stays
//     in the 50 MB L2 cache;
//   * each lane sums its slots in order, then the group sums its lanes
//     with a fixed xor butterfly of warp shuffles: no atomics, so the
//     result is bit-reproducible from run to run;
//   * the ragged edge is masked inside the kernel (rows >= n load nothing
//     and store nothing but still take part in the shuffles), so there is
//     no padding copy, where the TPU version padded n to its 256-row tile
//     and sliced back.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <int L>
__global__ void __launch_bounds__(THREADS)
spmv_kernel(const float* __restrict__ values, const int* __restrict__ cols,
            const float* __restrict__ v, long long n, int k,
            float* __restrict__ out) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long row = t / L;
  const int lane = (int)(t & (L - 1));
  float s = 0.f;
  if (row < n) {
    const float* vr = values + row * k;
    const int* cr = cols + row * k;
#pragma unroll 4
    for (int j = lane; j < k; j += L)
      s = fmaf(__ldcs(vr + j), __ldg(v + __ldcs(cr + j)), s);
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off, L);
  if (row < n && lane == 0) out[row] = s;
}

template <int L>
int launch(const float* values, const int* cols, const float* v, long long n,
           int k, float* out, cudaStream_t s) {
  const long long blocks = (n * L + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  spmv_kernel<L><<<(unsigned)blocks, THREADS, 0, s>>>(values, cols, v, n, k,
                                                       out);
  return (int)cudaGetLastError();
}

}  // namespace

// Lanes that share one row for a row of k slots.
extern "C" int dml_spmv_lanes(int k) {
  int L = 1;
  while (L < k && L < 32) L <<= 1;
  return L;
}

// values (n, k) f32, cols (n, k) int32 in [0, len(v)), v f32, out (n,) f32,
// all device pointers, rows contiguous. Returns cudaGetLastError() after
// the launch.
extern "C" int dml_spmv(const float* values, const int* cols, const float* v,
                        long long n, int k, float* out, void* stream) {
  if (n <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dml_spmv_lanes(k)) {
    case 1: return launch<1>(values, cols, v, n, k, out, s);
    case 2: return launch<2>(values, cols, v, n, k, out, s);
    case 4: return launch<4>(values, cols, v, n, k, out, s);
    case 8: return launch<8>(values, cols, v, n, k, out, s);
    case 16: return launch<16>(values, cols, v, n, k, out, s);
    default: return launch<32>(values, cols, v, n, k, out, s);
  }
}
