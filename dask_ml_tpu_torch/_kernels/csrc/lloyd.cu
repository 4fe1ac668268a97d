// One whole Lloyd iteration in one pass over X, for Hopper (sm_90a), plain
// C interface.
//
// Replaces the TPU kernel dask_ml_tpu/models/kmeans.py::_lloyd_iter_pallas.
// Per row: scores |c|^2 - 2 c.x against every center (|c|^2 in f32 from the
// caller, the same _row_sumsq the fused distance kernels take), argmin with
// ties to the lowest index, then the weighted accumulation of the (k, d)
// sums, the (k,) counts and the inertia sum_i w_i max(min_j s_ij + |x_i|^2,
// 0). The new centers and the shift are left to the caller, whose
// _new_centers holds the empty-cluster rule.
//
// Bound on the H100 (3.35 TB/s, 67 TFLOP/s f32 outside the tensor cores):
// the kernel must read X and w once against 2·n·k·d FLOPs of scores and
// 2·n·d of sums, so at k = 8 HBM bandwidth bounds it: 0.0609 ms at the blobs
// shape (n = 1e6, d = 50), 0.2456 ms at the KDD shape (n = 4,898,431,
// d = 41). Design against that bound:
//   * a fixed grid of LGRID persistent blocks (two an SM) walks tiles of T
//     rows, one row a thread, in a fixed order. X crosses HBM once, staged
//     into a ring of two tile buffers with cp.async, so the next tile's
//     copies are in flight while this one is scored and summed. A tile is
//     T * d contiguous floats of X: it is copied as such with 16-byte
//     copies (a 4-byte tail), which keeps four times the bytes in flight of
//     4-byte copies; 4-byte copies only when X is not 16-byte aligned. A
//     staged row keeps X's stride d, and the score loop reads it 16, 8 or
//     4 bytes at a time as d allows;
//   * the score loop is the m <= 8 thread tile of fused_distance.cu: a row x
//     8 centers a thread, each score one in-order fmaf chain over features
//     0..d-1, |x|^2 on its own chain, the centers visited in increasing
//     index with a strict <. So from the same centers K1's argmin and
//     minimum are the same bits as K2's and K5's. The loop is copied, not
//     shared through a header: K2 reads X transposed and one float at a
//     time, K1 row-major and up to 16 bytes at a time, build.py hashes one
//     source a library, and K2-K5 keep their object code. Beyond 8 centers
//     the loop runs over chunks of 8;
//   * the M-step is summed in registers (k <= 8, two tile buffers in shared
//     memory: d <= 110): the threads are split into row groups x columns,
//     a thread CPT columns q, q + ncol, ... of which column d is the count;
//     it keeps the k running sums of each in registers, updated through a
//     select of the row's weight per center (no register array indexed at
//     run time), and walks its group's rows in order. A warp reads
//     neighbouring columns of a row. Elsewhere every (group, column) owns
//     private shared-memory accumulators, updated in the same order. The
//     row groups are merged in a fixed order once, when the block ends;
//   * each block writes its partial (sums, counts, inertia) and a second
//     kernel adds the partials in a fixed order, so the result repeats its
//     bits from run to run and from card to card (LGRID does not depend on
//     the card). No float atomics, and no tensor cores: TF32 would break
//     parity with the f32 reference.
// What is left (PERF.md): the copies alone take most of the time, and the
// score loop and the M-step add to them instead of hiding under them (each
// phase waits at a block barrier). With d % 8 == 0 a warp's 16-byte row
// reads in the score loop conflict in shared memory; no timed shape has
// such a d yet.
//
// bf16 X (the JAX kernel's bf16 case: C cast to X's dtype in the product,
// |c|^2 from the f32 C, sums of X widened to f32). The ring holds the
// tile's bf16 elements as they lie in X (half the bytes; the layout is the
// f32 kernel's wherever that fits, and dml_lloyd_supported counts 2 bytes
// an element beyond it), copied in 16-byte
// pieces with a tail of plain 2-byte copies (a bf16 row of d = 50 is 100
// bytes: only the whole tile is 16-byte aligned, never its rows); every
// element is widened to f32 where it is read, in the score loop (one
// element at a time) and in the M-step. The caller passes C already
// rounded to bf16 and widened back, and c2 from the f32 C. A product of two
// bf16 values is exact in f32, so on any data the bf16 kernel gives the
// bits of the f32 kernel run on X rounded to bf16 and widened back.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int LGRID = 264;   // partial count: 2 blocks on each of 132 SMs
constexpr int KC = 8;        // centers a thread scores at once
constexpr int CPT = 4;       // columns a thread sums with register sums
constexpr int T_REG = 256;   // threads (= rows a tile) with register sums
constexpr int T_SMEM = 128;  // threads (= rows a tile) with shared sums
constexpr size_t MAX_DYN_SMEM = 232448 - 1024;  // 227 KB less headroom

__host__ __device__ inline int padded_k(int k) { return (k + KC - 1) / KC * KC; }

// the launch: which variant, and the shared-memory layout it needs
struct Plan {
  bool reg;     // k <= 8: the M-step's sums in registers, T_REG threads
  int threads;  // = rows a tile
  int groups;   // row groups of the M-step
  int nbuf;     // X tile buffers
  bool vec16;   // 16-byte copies of the tile (X 16-byte aligned)
  size_t smem;  // bytes
};

// does the register variant merge its row groups in the (idle) ring?
__host__ __device__ inline bool acc_in_ring(bool reg, size_t acc_f,
                                            size_t ring_f) {
  return reg && acc_f <= ring_f;
}

// bytes of the ring of nbuf tiles of T rows of X, xb bytes an element (a
// multiple of 16: T is 128 or 256)
__host__ __device__ inline size_t ring_bytes(int nbuf, int T, int d, int xb) {
  return (size_t)nbuf * T * d * xb;
}

size_t smem_bytes(bool reg, int T, int groups, int nbuf, int k, int d,
                  int xb) {
  const size_t kp = reg ? KC : padded_k(k);
  const size_t ring = ring_bytes(nbuf, T, d, xb);
  const size_t acc = (size_t)groups * k * (d + 1);
  return ring + sizeof(float) * ((size_t)d * kp + kp + 2 * (size_t)T +
                                 (acc_in_ring(reg, acc, ring / 4) ? 0 : acc));
}

// register sums: a thread's CPT columns are q, q + ncq, q + 2 ncq, ...
__host__ __device__ inline int column_quads(int d) {
  return (d + 1 + CPT - 1) / CPT;
}

// the first layout that fits, from the fastest to the smallest; the last
// (one group, one buffer) needs less than this kernel's first design (one
// 128-row tile, a shared (k, d + 1) accumulator), so every (k, d) that
// design took still runs here. X's alignment picks only the copies, so
// whether (k, d) runs at all does not depend on it
bool make_plan(int k, int d, bool aligned, int xb, Plan* p) {
  if (k < 1 || d < 1) return false;
  // bf16 X takes the f32 kernel's layout (threads, row groups, buffers)
  // wherever that fits, so that it sums in the f32 kernel's order and
  // gives its bits on X widened; only beyond, the 2-byte budget's own
  if (xb != 4 && make_plan(k, d, aligned, 4, p)) {
    p->smem = smem_bytes(p->reg, p->threads, p->groups, p->nbuf, k, d, xb);
    return true;
  }
  if (k <= KC && column_quads(d) <= T_REG) {
    const int g = T_REG / column_quads(d);
    const size_t b = smem_bytes(true, T_REG, g, 2, k, d, xb);
    if (b <= MAX_DYN_SMEM) {
      *p = Plan{true, T_REG, g, 2, aligned, b};
      return true;
    }
  }
  const int ncol = d + 1 < T_SMEM ? d + 1 : T_SMEM;
  const int tries[3][2] = {{T_SMEM / ncol, 2}, {1, 2}, {1, 1}};
  for (const auto& t : tries) {
    const size_t b = smem_bytes(false, T_SMEM, t[0], t[1], k, d, xb);
    if (b <= MAX_DYN_SMEM) {
      *p = Plan{false, T_SMEM, t[0], t[1], aligned, b};
      return true;
    }
  }
  return false;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
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

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// total contiguous elements of X from src into buf, asynchronously where
// the copy engine allows: 16-byte pieces over the aligned head (vec16),
// then 4-byte copies of f32 elements or plain copies of bf16 ones (which
// the barrier before the tile is read makes visible, as it does the
// asynchronous ones once waited for); one commit group
template <typename TX>
__device__ __forceinline__ void stage_tile(TX* buf, const TX* src, int total,
                                           bool vec16, int tid, int T) {
  constexpr int V = 16 / sizeof(TX);  // elements a 16-byte copy moves
  const int head = vec16 ? total & ~(V - 1) : 0;
  for (int e = V * tid; e < head; e += V * T) cp_async16(buf + e, src + e);
  if constexpr (sizeof(TX) == 4) {
    for (int e = head + tid; e < total; e += T) cp_async4(buf + e, src + e);
  } else {
    for (int e = head + tid; e < total; e += T) buf[e] = src[e];
  }
  cp_async_commit();
}

// acc[q] = fmaf(xv, ct[q], acc[q]) for the 8 centers of a chunk (two
// 16-byte broadcast reads)
__device__ __forceinline__ void fma8(float (&a)[KC], float xv,
                                     const float* cf) {
  const float4 u = reinterpret_cast<const float4*>(cf)[0];
  const float4 v = reinterpret_cast<const float4*>(cf)[1];
  a[0] = fmaf(xv, u.x, a[0]);
  a[1] = fmaf(xv, u.y, a[1]);
  a[2] = fmaf(xv, u.z, a[2]);
  a[3] = fmaf(xv, u.w, a[3]);
  a[4] = fmaf(xv, v.x, a[4]);
  a[5] = fmaf(xv, v.y, a[5]);
  a[6] = fmaf(xv, v.z, a[6]);
  a[7] = fmaf(xv, v.w, a[7]);
}

// T threads, a tile of T rows; REG: k <= 8 and the M-step's sums in
// registers, else in shared memory; TX: X's element type (float or
// __nv_bfloat16)
template <int T, bool REG, typename TX>
__global__ void __launch_bounds__(T, REG ? 2 : 1)
lloyd_partial_kernel(const TX* __restrict__ X, const float* __restrict__ w,
                     const float* __restrict__ C,
                     const float* __restrict__ c2, int n, int k, int d,
                     int groups, int nbuf, bool vec16,
                     float* __restrict__ partial) {
  extern __shared__ __align__(16) float sm[];
  const int kp = REG ? KC : padded_k(k);
  const int A = k * (d + 1);
  const size_t tile_f = (size_t)T * d;
  const size_t ring_b = ring_bytes(nbuf, T, d, sizeof(TX));
  TX* const ring = reinterpret_cast<TX*>(sm);  // [nbuf][T][d]
  // [d][kp], centers feature-major
  float* const ct = reinterpret_cast<float*>(reinterpret_cast<char*>(sm) +
                                             ring_b);
  float* const c2s = ct + (size_t)d * kp;   // [kp], +inf past k
  int* const lab = reinterpret_cast<int*>(c2s + kp);  // [T]
  float* const wsm = c2s + kp + T;                     // [T]
  float* const acc = acc_in_ring(REG, (size_t)groups * A, ring_b / 4)
                         ? sm
                         : wsm + T;  // [groups][k][d + 1]
  const int tid = threadIdx.x;

  for (int e = tid; e < d * kp; e += T) {
    const int f = e / kp, c = e - f * kp;
    ct[e] = c < k ? C[(size_t)c * d + f] : 0.f;
  }
  for (int c = tid; c < kp; c += T) c2s[c] = c < k ? c2[c] : CUDART_INF_F;
  if (!REG)
    for (int e = tid; e < groups * A; e += T) acc[e] = 0.f;
  // the M-step's owner: row group g and columns q, q + ncol, ... (with
  // register sums, CPT of them)
  const int ncol = REG ? column_quads(d) : (d + 1 < T ? d + 1 : T);
  const int g = tid / ncol, q = tid - g * ncol;
  const bool owner = g < groups;
  const long ntiles = ((long)n + T - 1) / T;
  // the tile is nrows * d contiguous elements of X, and of the buffer
  auto stage = [&](long t, TX* buf) {
    stage_tile(buf, X + t * T * (long)d,
               (int)min((long)T, (long)n - t * T) * d, vec16, tid, T);
  };

  float s[CPT][KC];  // REG: this thread's columns, summed per center
#pragma unroll
  for (int cc = 0; cc < CPT; ++cc)
#pragma unroll
    for (int j = 0; j < KC; ++j) s[cc][j] = 0.f;
  float inert = 0.f;
  long t = blockIdx.x;
  if (t < ntiles) stage(t, ring);
  for (int i = 0; t < ntiles; ++i, t += gridDim.x) {
    const int b = nbuf == 2 ? (i & 1) : 0;
    const TX* xs = ring + b * tile_f;
    const long tn = t + gridDim.x;
    if (nbuf == 2 && tn < ntiles) {
      stage(tn, ring + (b ^ 1) * tile_f);
      cp_async_wait<1>();  // every group but the one just issued
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // the tile is in shared memory for every thread
    const long row0 = t * T;
    const int nrows = (int)min((long)T, (long)n - row0);

    // E-step: row tid against every center
    if (tid < nrows) {
      const float wv = w[row0 + tid];
      const TX* xr = xs + tid * d;
      float best = CUDART_INF_F, x2 = 0.f;
      int bi = 0;
      for (int q0 = 0; q0 < kp; q0 += KC) {
        float a[KC];
#pragma unroll
        for (int j = 0; j < KC; ++j) a[j] = 0.f;
        // f32 x 16 or 8 bytes at a time as d allows, then the rest (bf16
        // x one element at a time)
        int f = 0;
        if constexpr (sizeof(TX) == 4) {
          if (d % 4 == 0) {
            for (; f + 4 <= d; f += 4) {
              const float4 x4 = *reinterpret_cast<const float4*>(
                  reinterpret_cast<const float*>(xr) + f);
              const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                if (q0 == 0) x2 = fmaf(xv[u], xv[u], x2);
                fma8(a, xv[u], ct + (f + u) * kp + q0);
              }
            }
          } else if (d % 2 == 0) {
#pragma unroll 2
            for (; f + 2 <= d; f += 2) {
              const float2 x2v = *reinterpret_cast<const float2*>(
                  reinterpret_cast<const float*>(xr) + f);
              const float xv[2] = {x2v.x, x2v.y};
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                if (q0 == 0) x2 = fmaf(xv[u], xv[u], x2);
                fma8(a, xv[u], ct + (f + u) * kp + q0);
              }
            }
          }
        }
        for (; f < d; ++f) {
          const float xv = widen(xr[f]);
          if (q0 == 0) x2 = fmaf(xv, xv, x2);
          fma8(a, xv, ct + f * kp + q0);
        }
#pragma unroll
        for (int j = 0; j < KC; ++j) {
          const float sc = c2s[q0 + j] - 2.0f * a[j];
          if (sc < best) {
            best = sc;
            bi = q0 + j;
          }
        }
      }
      inert = fmaf(wv, fmaxf(best + x2, 0.f), inert);
      lab[tid] = bi;
      wsm[tid] = wv;
    }
    __syncthreads();  // labels and weights are in shared memory

    // M-step: group g's rows of the tile, in order
    if (owner) {
      if (REG) {
        // a warp's threads read neighbouring columns of a row (no bank
        // conflict in any stride); column d is the count's 1.0, columns
        // past it are never stored. The label picks the center by a
        // select per center, so no register is indexed at run time
        bool in[CPT];
        float cv[CPT];
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) {
          in[cc] = q + cc * ncol < d;
          cv[cc] = q + cc * ncol == d ? 1.f : 0.f;
        }
        const TX* xq = xs + q;
#pragma unroll 2
        for (int r = g; r < nrows; r += groups) {
          const int l = lab[r];
          const float wv = wsm[r];
          float v[CPT];
#pragma unroll
          for (int cc = 0; cc < CPT; ++cc)
            v[cc] = in[cc] ? widen(xq[r * d + cc * ncol]) : cv[cc];
#pragma unroll
          for (int j = 0; j < KC; ++j) {
            const float wj = l == j ? wv : 0.f;
#pragma unroll
            for (int cc = 0; cc < CPT; ++cc)
              s[cc][j] = fmaf(wj, v[cc], s[cc][j]);
          }
        }
      } else {
        float* const ag = acc + (size_t)g * A;
        for (int r = g; r < nrows; r += groups) {
          float* const al = ag + (size_t)lab[r] * (d + 1);
          const float wv = wsm[r];
          for (int c = q; c <= d; c += ncol) {
            const float v = c < d ? widen(xs[r * d + c]) : 1.f;
            al[c] = fmaf(wv, v, al[c]);
          }
        }
      }
    }
    __syncthreads();  // the buffer and the labels are free again
    if (nbuf == 1 && tn < ntiles) stage(tn, ring);
  }

  // merge the row groups in order, once
  if (REG) {
    if (owner)
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        const int c = q + cc * ncol;
#pragma unroll
        for (int j = 0; j < KC; ++j)
          if (j < k && c <= d)
            acc[((size_t)g * k + j) * (d + 1) + c] = s[cc][j];
      }
    __syncthreads();
  }
  const size_t P = (size_t)A + 1;
  for (int e = tid; e < A; e += T) {
    float v = 0.f;
    for (int gg = 0; gg < groups; ++gg) v += acc[(size_t)gg * A + e];
    partial[blockIdx.x * P + e] = v;
  }
  float* const red = wsm;
  red[tid] = inert;
  __syncthreads();
  for (int h = T / 2; h > 0; h >>= 1) {
    if (tid < h) red[tid] += red[tid + h];
    __syncthreads();
  }
  if (tid == 0) partial[blockIdx.x * P + A] = red[0];
}

// out[e] = sum over blocks b = 0 .. G-1 of partial[b, e] in a fixed order:
// RY slices of the blocks (b = y, y + RY, ...) each summed in order, then
// the slices in order; a block takes 32 neighbouring e (coalesced reads)
constexpr int RY = 8;
__global__ void __launch_bounds__(32 * RY)
lloyd_reduce_kernel(const float* __restrict__ partial, int G, int P,
                    float* __restrict__ out) {
  __shared__ float red[RY][32];
  const int e = blockIdx.x * 32 + threadIdx.x, y = threadIdx.y;
  float s = 0.f;
  if (e < P)
    for (int b = y; b < G; b += RY) s += partial[(size_t)b * P + e];
  red[y][threadIdx.x] = s;
  __syncthreads();
  if (y == 0 && e < P) {
    float t = red[0][threadIdx.x];
    for (int yy = 1; yy < RY; ++yy) t += red[yy][threadIdx.x];
    out[e] = t;
  }
}

template <int T, bool REG, typename TX>
int launch(const Plan& p, const TX* X, const float* w, const float* C,
           const float* c2, int n, int k, int d, int G, float* partial,
           cudaStream_t s) {
  auto kernel = lloyd_partial_kernel<T, REG, TX>;
  // above 48 KB a block's shared memory must be granted; the grant holds
  // for the current device only, so it is made on every launch
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<G, T, p.smem, s>>>(X, w, C, c2, n, k, d, p.groups, p.nbuf,
                              p.vec16, partial);
  return 0;
}

}  // namespace

extern "C" int dml_lloyd_max_partials() { return LGRID; }

// does the shared-memory budget hold (k, d) for X of f32 (xbf16 = 0) or
// bf16 elements?
extern "C" int dml_lloyd_supported(int k, int d, int xbf16) {
  Plan p;
  return make_plan(k, d, false, xbf16 ? 2 : 4, &p) ? 1 : 0;
}

template <typename TX>
int launch_x(const Plan& p, const void* X, const float* w, const float* C,
             const float* c2, int n, int k, int d, int G, float* partial,
             cudaStream_t s) {
  const TX* x = static_cast<const TX*>(X);
  return p.reg ? launch<T_REG, true>(p, x, w, C, c2, n, k, d, G, partial, s)
               : launch<T_SMEM, false>(p, x, w, C, c2, n, k, d, G, partial,
                                       s);
}

// X (n, d) row-major, f32 or (xbf16 != 0) bf16, w (n,) f32, C (k, d) f32
// (for bf16 X: rounded to bf16), c2 (k,) f32 = |c|^2 (the caller's
// _row_sumsq of the f32 C), all device pointers. partial: scratch of at
// least dml_lloyd_max_partials() * (k (d + 1) + 1) floats. out (k (d + 1) +
// 1,): row c holds the sums of cluster c in columns 0 .. d-1 and its count
// in column d; the last float is the inertia. Returns cudaGetLastError()
// after the launches.
extern "C" int dml_lloyd_iter(const void* X, int xbf16, const float* w,
                              const float* C, const float* c2, int n, int k,
                              int d, float* partial, float* out,
                              void* stream) {
  Plan p;
  const bool aligned = reinterpret_cast<uintptr_t>(X) % 16 == 0;
  if (n <= 0 || !make_plan(k, d, aligned, xbf16 ? 2 : 4, &p))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long ntiles = ((long)n + p.threads - 1) / p.threads;
  const int G = (int)(ntiles < LGRID ? ntiles : LGRID);
  const int err =
      xbf16 ? launch_x<__nv_bfloat16>(p, X, w, C, c2, n, k, d, G, partial, s)
            : launch_x<float>(p, X, w, C, c2, n, k, d, G, partial, s);
  if (err != 0) return err;
  const int P = k * (d + 1) + 1;
  lloyd_reduce_kernel<<<(P + 31) / 32, dim3(32, RY), 0, s>>>(partial, G, P,
                                                             out);
  return (int)cudaGetLastError();
}
