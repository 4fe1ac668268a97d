// Blocked-ELL sparse matrix-vector product and its pullback for Hopper
// (sm_90a), plain C interface.
//
// Replaces the TPU kernel dask_ml_tpu/ops/sparse.py::_spmv_impl (the
// forward pass of the public spmv) and, for the backward pass that the JAX
// package leaves to XLA's segment_sum (its custom VJP, _spmv_bwd), adds a
// kernel of its own. The matrix is a SparseRows container: values (n, k)
// f32 and cols (n, k) int32, row-major, row i holding its nonzeros in
// slots 0 .. k-1, unused slots padded as (col 0, value 0). The kernels
// compute
//     out[i] = sum_j values[i, j] * v[cols[i, j]]                (forward)
//     g[c]   = sum_{(i, j): cols[i, j] = c} values[i, j] * r[i]  (pullback)
// in f32 for any n >= 1 and k >= 1; duplicate columns sum, padded slots
// add 0. Column indices are trusted: the port's check_array has already
// held them to [0, d).
//
// Bound on the H100 (the GLM cell: n = 1e7, k = 101 with the intercept
// slot, d = 100,001), the same for both directions: values and cols are
// read once (8.08 GB), one n-vector (40 MB) and one d-vector (0.4 MB) are
// read or written, against 2 n k = 2.0e9 FLOPs. Bytes bound it:
// 8.12e9 / 3.35e12 B/s = 2.42 ms; the FLOPs take 0.03 ms at 67 TFLOP/s.
//
// What keeps a kernel from that bound is not the stream but the d-vector:
// 1e9 random 4-byte accesses to 400 KB. Gathered through L2 each pulls its
// own 32-byte sector (about 32 GB of L2 traffic that the bytes bound does
// not count); scattered with atomics to device memory each is an L2
// atomic, 1e7 of them on the intercept's one address. So both directions
// keep the d-vector in shared memory, where an access moves 4 bytes:
//
//   * a persistent grid, one block of 1,024 threads on each SM. d floats
//     fit one block's 227 KB up to 58,112 less the forward's staging;
//     beyond, a thread block cluster shares them, block `rank` holding the
//     columns c with c % cluster == rank at index c / cluster (an
//     interleaved split: owner and offset are a mask and a shift, and the
//     parts are equal whatever the data's skew). The Python wrapper picks
//     the cluster size from (n, k, d) alone;
//   * how a cluster's blocks share the work: every block of a cluster
//     walks every tile of its cluster and takes the slots whose column
//     lies in its own part, so every access to shared memory is local; the
//     later block's read of a tile hits L2 (the blocks meet at a cluster
//     barrier every 32 tiles a group), device memory is read once, and the
//     forward's blocks each write a partial output that a second kernel
//     adds in rank order. Its price: a block inspects every slot of its
//     cluster, so the time grows with the cluster's size, and the forward
//     is built for clusters of 1 and 2, the pullback for 1, 2 and 4: on an
//     H100 at the cell's n and k the next size of each is slower than its
//     L2 kernel. (The other way, every block walking its own tiles and
//     reaching the other blocks' parts through the cluster's network with
//     mapa + ld.shared::cluster / red.shared::cluster, was written and
//     measured first and lost to the L2 kernels at every size: 4-byte
//     accesses cross that network at about one in two clocks an SM, and a
//     float add across it is a compare-and-swap loop. PERF.md has the
//     numbers of both.);
//   * the container is walked as one flat array of n k slots in tiles of R
//     rows, R a multiple of 4 with R k <= 2,048, so that every thread of a
//     group of 512 reads 16 bytes of values and 16 of cols (float4 / int4,
//     aligned whatever k is; the loads of the next two tiles in flight
//     while this tile is worked on), where a warp a row read 4 bytes a
//     lane and left the last stride of a 101-slot row to 5 lanes of 32;
//   * a block's two groups walk tiles of their own, each at its own pace
//     behind its own named barrier, so that one group's row sums (a chain
//     of dependent loads and shuffles) overlap the other's gathers (four
//     groups of 256 would leave 54 threads of each idle at k = 101);
//   * forward: products go to the group's staging tile in shared memory,
//     then sets of L lanes (L a power of two, at most 32 and at most k)
//     sum each row in a fixed order: a lane's strided slots, then an xor
//     butterfly. No atomics: the result repeats bit for bit. Two staging
//     tiles alternate, so a tile costs one barrier;
//   * pullback: every product a * r (an f32 product, as the plain version
//     forms it) is rounded to a 64-bit fixed-point integer q = a r 2^e, and
//     the integers are added: integer adds commute exactly, so every order
//     of the adds, every route and every cluster size give the same bits
//     from one call to the next (the JAX package's segment_sum repeats its
//     bits; float atomics in an order that changes from run to run did
//     not). e is one power of two for the whole call, from the largest
//     |values| (computed once per container and kept by the Python
//     wrapper), the largest |r| and the slot count n k: the largest
//     product takes cap = min(39, 61 - ceil(log2(n k))) bits (31 at the
//     GLM cell), so that no sum leaves 62 bits, and a column's sum is
//     within count_c 2^-cap max|a r| of the sum of its f32 products, then
//     rounded once to f32; on integer-valued data (max|a r| < 2^cap) every
//     q and every sum is exact. A non-finite bound gives NaN in every
//     column.
//     Every cluster zeroes a private copy of the low 32 bits of g in its
//     shared memory (4 bytes a column, as a float would take, so the plan
//     is the float kernel's) and adds each q's low word with the card's
//     native 32-bit shared-memory atomic add; the add returns the old
//     word, from which the carry out is exact, and the high word plus that
//     carry, where it is not 0, goes to the cluster's row of a (clusters,
//     d) high-word scratch with a device-memory atomic (a few in a hundred
//     adds at the GLM cell). A slot whose value is 0 adds nothing and is
//     skipped, which also keeps the padded slots off column 0. A second
//     kernel adds the clusters' (low, high) pairs as 64-bit integers and
//     turns each column's sum into f32;
//   * rows >= n are masked inside the kernels: no padding copy.
//
// Where a container has too few rows for the persistent grid, it leaves
// most SMs idle: the served request (n = 2,048, k = 10, d = 100) is 11
// tiles of 204 rows, 6 blocks of 1,024 threads on 132 SMs. There the plan
// takes the L2 kernel (below), whose grid gives every L lanes a row. At
// such a shape the host's work is a large share of a call, so the plans'
// attribute sets and occupancy queries are made once a process for each
// (device, kernel, cluster, shared memory) and kept (held_clusters), for
// the pullback too, and the L2 forward sets no attribute at all.
//
// Where d is beyond the cluster's reach, k beyond a tile (512), or n k too
// small against d to pay for filling shared memory, the d-vector stays in
// L2: spmv_kernel (a set of L lanes a row, the first version of this
// port; for bf16 values it rounds each v[col] it reads to bf16) and
// pullback_atomic_kernel (the same walk, fused, the same fixed-point q
// added with 64-bit integer atomics on device memory: the bits of every
// other route).
//
// bf16 values (the JAX package's bf16 container). Every kernel is a template
// on the values' element type TV; a bf16 value is widened to f32 where it is
// loaded (four slots are 8 bytes then, one uint2 load). The forward multiplies
// by the dense vector rounded to bf16: the caller of the shared-memory kernels
// rounds it once and passes it widened back to f32, the L2 kernel rounds each
// entry it reads. Forward: a product of two bf16 values is exact in f32, as
// the Pallas kernel forms it. Pullback: r stays f32 and each product a r is
// formed in f32, as the f32 pullback forms it; the fixed point is the f32
// pullback's. (The JAX package's bf16 pullback rounds r and each product to
// bf16; a logistic loss's cotangent sigma(eta) - y is then +-1/2 to bf16's 8
// bits and loses what eta adds, and an L-BFGS fit on bf16 values lands far
// from the f32 fit: PERF.md.) Two things differ from the f32 kernels, where
// the bf16 case was slower than the f32 one on the float kernels' plans (the
// bound is 25 % lower: 2-byte values):
//   * the forward keeps v in shared memory as bf16, 2 bytes a column (the
//     high half of each rounded f32, widened where it is read: exact), so
//     at the GLM cell (d = 100,001) v and the staging tiles fit one block
//     (232,322 of 232,448 bytes): every slot is inspected once, and no
//     partial outputs nor second launch are needed;
//   * the pullback in a cluster (2 or 4 blocks) is fed by a ring
//     (pullback_ring_kernel): one thread of the cluster copies each tile
//     of R rows (values, cols, r) once, as TMA bulk copies multicast to
//     every block of the cluster, into a ring of stages behind a full and
//     an empty mbarrier a stage; 31 consumer warps a block take the slots
//     whose column is their block's. The container crosses L2 -> SM once
//     a cluster, no register holds a load in flight, and the blocks need
//     no drift barrier. Where the container is not 16-byte aligned, or the
//     ring does not fit beside the part, pullback_smem_kernel's tiles
//     stay. At the GLM cell on an H100 the forward takes 2.72-2.81 ms
//     (5.63-5.79 on the float plan) and the ring 5.12-5.39 (the tiles
//     5.98-6.24 in the same calls); in a cluster of 4 (d = 150,001,
//     uniform columns) the ring 10.48-10.64, the tiles 11.84-11.86. What
//     still bounds the ring at the cell is the 29 KB a cluster has in
//     flight (3 stages of 16 rows beside a 200 KB part). Warming the
//     tiles into L2 ahead of the ring and an f32 fixed point were
//     measured and did not pay (PERF.md).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;  // the L2 kernels' block
constexpr int TB = 1024;      // a persistent block: GROUPS groups of GT
constexpr int GROUPS = 2;
constexpr int GT = TB / GROUPS;
constexpr int TILE_SLOTS = 4 * GT;  // slots a group's tile holds at most
constexpr int MAX_K = TILE_SLOTS / 4;
constexpr int SMEM_BLOCK_BYTES = 232448;
// tiles a group walks between two cluster barriers
constexpr int DRIFT_TILES = 32;

// a value as f32: streamed (evict-first) or through the read-only path
__device__ __forceinline__ float ldv(const float* p, bool stream) {
  return stream ? __ldcs(p) : __ldg(p);
}
__device__ __forceinline__ float ldv(const __nv_bfloat16* p, bool stream) {
  const unsigned short* u = reinterpret_cast<const unsigned short*>(p);
  return __bfloat162float(__ushort_as_bfloat16(stream ? __ldcs(u)
                                                      : __ldg(u)));
}


// ---------------------------------------------------------------------------
// the d-vector in L2
// ---------------------------------------------------------------------------

// v[c] as the forward multiplies it: f32, or for bf16 values rounded to
// bf16 (round-to-nearest-even, as the plain version rounds v to the
// values' dtype) and widened back, exact
__device__ __forceinline__ float gather(const float* v, int c, const float*) {
  return __ldg(v + c);
}
__device__ __forceinline__ float gather(const float* v, int c,
                                        const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(__ldg(v + c)));
}

template <int L, typename TV>
__global__ void __launch_bounds__(THREADS)
spmv_kernel(const TV* __restrict__ values, const int* __restrict__ cols,
            const float* __restrict__ v, long long n, int k,
            float* __restrict__ out) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long row = t / L;
  const int lane = (int)(t & (L - 1));
  float s = 0.f;
  if (row < n) {
    const TV* vr = values + row * k;
    const int* cr = cols + row * k;
#pragma unroll 4
    for (int j = lane; j < k; j += L)
      s = fmaf(ldv(vr + j, true), gather(v, __ldcs(cr + j), vr), s);
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off, L);
  if (row < n && lane == 0) out[row] = s;
}

int lanes_of(int k) {
  int L = 1;
  while (L < k && L < 32) L <<= 1;
  return L;
}

// ---------------------------------------------------------------------------
// the pullback's fixed point
// ---------------------------------------------------------------------------

// The f32 bits of |x|: a bf16's bits are the high half of its f32's.
__device__ __forceinline__ unsigned abs_bits(const float* p) {
  return __float_as_uint(__ldcs(p)) & 0x7fffffffu;
}
__device__ __forceinline__ unsigned abs_bits(const __nv_bfloat16* p) {
  return ((unsigned)__ldcs(reinterpret_cast<const unsigned short*>(p)) &
          0x7fffu)
         << 16;
}

// The bits of max |x| over x (as f32): non-negative floats order as their
// bits (NaN above inf above every finite value), so an integer max
// repeats.
template <typename TV>
__global__ void __launch_bounds__(THREADS)
absmax_kernel(const TV* __restrict__ x, long long len,
              unsigned* __restrict__ out) {
  unsigned m = 0;
  const long long stride = (long long)gridDim.x * THREADS;
#pragma unroll 4
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < len;
       i += stride)
    m = max(m, abs_bits(x + i));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0 && m != 0) atomicMax(out, m);
}

template <typename TV>
int launch_absmax(const TV* x, long long len, unsigned* out,
                  cudaStream_t s) {
  cudaError_t e = cudaMemsetAsync(out, 0, sizeof(unsigned), s);
  if (e != cudaSuccess) return (int)e;
  long long blocks = (len + THREADS - 1) / THREADS;
  if (blocks > 8 * 132) blocks = 8 * 132;
  if (blocks < 1) blocks = 1;
  absmax_kernel<TV><<<(unsigned)blocks, THREADS, 0, s>>>(x, len, out);
  return (int)cudaGetLastError();
}

// One call's fixed point: q = rint(p 2^e) for an f32 product p. The
// largest |p| is at most max|values| max|r| rounded up to a power of two,
// so |q| <= 2^cap with cap = min(39, 61 - ceil(log2(n k))): a sum of n k
// of them stays inside 62 bits. (31 at the GLM cell, n k = 1.01e9: the
// larger q, the more adds carry into the high word.)
struct Fixed {
  double scale, unscale;
  bool finite;
};

__device__ __forceinline__ Fixed fixed_point(const unsigned* a_bound,
                                             const unsigned* r_bound,
                                             long long nk) {
  const unsigned ab = *a_bound, rb = *r_bound;
  Fixed f;
  f.finite = ab < 0x7f800000u && rb < 0x7f800000u;
  const double m = (double)__uint_as_float(ab) * (double)__uint_as_float(rb);
  int e = 0;
  if (f.finite && m > 0.0) {
    int cap = 61 - (nk > 1 ? 64 - __clzll(nk - 1) : 0);
    if (cap > 39) cap = 39;
    e = cap - (ilogb(m) + 1);
  }
  f.scale = ldexp(1.0, e);
  f.unscale = ldexp(1.0, -e);
  return f;
}

__device__ __forceinline__ long long to_fixed(float p, const Fixed& f) {
  return __double2ll_rn((double)p * f.scale);
}

// *lo += the low word of q, *hi += its high word and the carry out of that
// add: the pairs gather the exact sum mod 2^64 in any order.
__device__ __forceinline__ void add_fixed(unsigned* lo, unsigned* hi,
                                          long long q) {
  const unsigned l = (unsigned)q;
  const unsigned old = atomicAdd(lo, l);
  const unsigned h = (unsigned)(q >> 32) + (old + l < old ? 1u : 0u);
  if (h != 0u) atomicAdd(hi, h);
}

// g[i] = the sum of `rows` (low, high) word pairs at lo[j * row + i *
// step] and hi[j * row + i * step], a 64-bit integer, in f32; NaN where a
// bound was not finite.
__global__ void __launch_bounds__(THREADS)
from_fixed_kernel(const unsigned* __restrict__ lo,
                  const unsigned* __restrict__ hi, int rows, long long row,
                  int step, long long len, const unsigned* a_bound,
                  const unsigned* r_bound, long long nk,
                  float* __restrict__ g) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= len) return;
  unsigned long long t = 0;
  for (int j = 0; j < rows; ++j) {
    const long long at = j * row + i * step;
    t += (unsigned long long)lo[at] + ((unsigned long long)hi[at] << 32);
  }
  const Fixed f = fixed_point(a_bound, r_bound, nk);
  g[i] = f.finite ? (float)((double)(long long)t * f.unscale)
                  : __int_as_float(0x7fffffff);
}

int launch_from_fixed(const unsigned* lo, const unsigned* hi, int rows,
                      long long row, int step, long long len,
                      const unsigned* a_bound, const unsigned* r_bound,
                      long long nk, float* g, cudaStream_t s) {
  const long long blocks = (len + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  from_fixed_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(
      lo, hi, rows, row, step, len, a_bound, r_bound, nk, g);
  return (int)cudaGetLastError();
}

// The pullback with g in L2: the walk of spmv_kernel, each q added to a
// (d,) 64-bit accumulator with a device-memory atomic.
template <int L, typename TV>
__global__ void __launch_bounds__(THREADS)
pullback_atomic_kernel(const TV* __restrict__ values,
                       const int* __restrict__ cols,
                       const float* __restrict__ r, long long n, int k,
                       const unsigned* a_bound, const unsigned* r_bound,
                       unsigned long long* __restrict__ acc) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long row = t / L;
  const int lane = (int)(t & (L - 1));
  if (row >= n) return;
  const Fixed f = fixed_point(a_bound, r_bound, n * k);
  const float rr = __ldg(r + row);
  const TV* vr = values + row * k;
  const int* cr = cols + row * k;
#pragma unroll 4
  for (int j = lane; j < k; j += L) {
    const float a = ldv(vr + j, true);
    const int c = __ldcs(cr + j);
    if (a != 0.f)
      atomicAdd(acc + c, (unsigned long long)to_fixed(a * rr, f));
  }
}

// Both L2 kernels for rows of k slots: L = lanes_of(k) lanes a row.
template <int L, typename TV>
int launch_l2_lanes(bool pull, const TV* values, const int* cols,
                    const float* x, long long n, int k, float* out,
                    const unsigned* a_bound, const unsigned* r_bound,
                    unsigned long long* acc, cudaStream_t s) {
  const long long blocks = (n * L + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (pull)
    pullback_atomic_kernel<L, TV><<<(unsigned)blocks, THREADS, 0, s>>>(
        values, cols, x, n, k, a_bound, r_bound, acc);
  else
    spmv_kernel<L, TV><<<(unsigned)blocks, THREADS, 0, s>>>(values, cols, x,
                                                             n, k, out);
  return (int)cudaGetLastError();
}

template <typename TV>
int dispatch_l2(bool pull, const TV* values, const int* cols,
                const float* x, long long n, int k, float* out,
                const unsigned* a_bound, const unsigned* r_bound,
                unsigned long long* acc, cudaStream_t s) {
#define DML_L2(L)                                                   \
  return launch_l2_lanes<L>(pull, values, cols, x, n, k, out, a_bound, \
                            r_bound, acc, s)
  switch (lanes_of(k)) {
    case 1: DML_L2(1);
    case 2: DML_L2(2);
    case 4: DML_L2(4);
    case 8: DML_L2(8);
    case 16: DML_L2(16);
    default: DML_L2(32);
  }
#undef DML_L2
}

// ---------------------------------------------------------------------------
// the d-vector in a block's or a cluster's shared memory
// ---------------------------------------------------------------------------

struct Frag {
  float4 a;
  int4 c;
};

// A fragment of the pullback: its slots, and r of its first two rows.
struct RFrag {
  Frag f;
  float r0, r1;
};

template <bool STREAM>
__device__ __forceinline__ float ld1(const float* p) {
  return ldv(p, STREAM);
}
template <bool STREAM>
__device__ __forceinline__ float ld1(const __nv_bfloat16* p) {
  return ldv(p, STREAM);
}
template <bool STREAM>
__device__ __forceinline__ int ld1(const int* p) {
  return STREAM ? __ldcs(p) : __ldg(p);
}

// four consecutive values from an aligned address, as f32
template <bool STREAM>
__device__ __forceinline__ float4 ld4(const float* p) {
  const float4* q = reinterpret_cast<const float4*>(p);
  return STREAM ? __ldcs(q) : __ldg(q);
}
template <bool STREAM>
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  // a bf16 is the high half of its f32: widen by shifts, in registers
  const uint2* q = reinterpret_cast<const uint2*>(p);
  const uint2 u = STREAM ? __ldcs(q) : __ldg(q);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// Four consecutive slots from flat index g0 (a multiple of 4): one load
// each of values (16 bytes of f32, 8 of bf16) and cols (16 bytes) where
// they are aligned and in range, else slot by slot, slots >= total as
// (col 0, value 0); values as f32. STREAM: nobody reads the tile again, so
// it is loaded evict-first.
template <bool STREAM, typename TV>
__device__ __forceinline__ Frag load_frag(const TV* __restrict__ values,
                                          const int* __restrict__ cols,
                                          long long g0, long long total,
                                          bool aligned) {
  Frag f;
  if (aligned && g0 + 4 <= total) {
    const int4* pc = reinterpret_cast<const int4*>(cols + g0);
    f.a = ld4<STREAM>(values + g0);
    f.c = STREAM ? __ldcs(pc) : __ldg(pc);
    return f;
  }
  f.a = make_float4(0.f, 0.f, 0.f, 0.f);
  f.c = make_int4(0, 0, 0, 0);
  if (g0 + 0 < total) { f.a.x = ld1<STREAM>(values + g0 + 0); f.c.x = ld1<STREAM>(cols + g0 + 0); }
  if (g0 + 1 < total) { f.a.y = ld1<STREAM>(values + g0 + 1); f.c.y = ld1<STREAM>(cols + g0 + 1); }
  if (g0 + 2 < total) { f.a.z = ld1<STREAM>(values + g0 + 2); f.c.z = ld1<STREAM>(cols + g0 + 2); }
  if (g0 + 3 < total) { f.a.w = ld1<STREAM>(values + g0 + 3); f.c.w = ld1<STREAM>(cols + g0 + 3); }
  return f;
}

// The forward's part of v: f32, or for bf16 values the bf16 bits of each
// entry (v was rounded to bf16 by the caller, so they are its f32's high
// half, and widening them back is exact).
template <typename TV>
struct PartOf {
  using T = float;
};
template <>
struct PartOf<__nv_bfloat16> {
  using T = unsigned short;
};
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(unsigned short* p, float x) {
  *p = (unsigned short)(__float_as_uint(x) >> 16);
}
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(unsigned short x) {
  return __uint_as_float((unsigned)x << 16);
}

// a * v[col], or 0 where the column is another block's.
template <int LOG2C, typename PT>
__device__ __forceinline__ float term(const PT* part, unsigned rank, float a,
                                      int col) {
  if (LOG2C == 0) return a * widen(part[col]);
  if (((unsigned)col & ((1u << LOG2C) - 1u)) != rank) return 0.f;
  return a * widen(part[(unsigned)col >> LOG2C]);
}

// q into this block's part of g (the low words in shared memory, the high
// words in the cluster's row of the scratch), unless the column is another
// block's.
template <int LOG2C>
__device__ __forceinline__ void scatter_add(unsigned* part, unsigned* hi,
                                            unsigned rank, int col,
                                            long long q) {
  if (LOG2C == 0)
    add_fixed(part + col, hi + col, q);
  else if (((unsigned)col & ((1u << LOG2C) - 1u)) == rank)
    add_fixed(part + ((unsigned)col >> LOG2C), hi + col, q);
}

template <int LOG2C>
__device__ __forceinline__ void sync_all() {
  if (LOG2C == 0)
    __syncthreads();
  else
    cg::this_cluster().sync();
}

template <int LOG2C>
__device__ __forceinline__ unsigned block_rank() {
  if (LOG2C == 0) return 0u;
  return cg::this_cluster().block_rank();
}

// The barrier of one group of a block (barrier 0 is __syncthreads').
__device__ __forceinline__ void sync_group(int group) {
  asm volatile("bar.sync %0, %1;" ::"r"(group + 1), "n"(GT) : "memory");
}

// The tiles of one group. Three fragments rotate, so that two tiles' loads
// are in flight while one is worked on (no register is copied from one
// still being loaded). Tiles are dealt to the groups of a cluster (every
// block of it has the same groups); every group makes the same number of
// rounds, and a cluster beyond one block meets at a barrier every
// DRIFT_TILES rounds: its blocks read the same tiles, and the later
// reader should find them in L2.
template <int LOG2C, typename Load, typename Work>
__device__ __forceinline__ void walk_tiles(long long tiles, Load load,
                                           Work work) {
  constexpr bool SPLIT = LOG2C > 0;
  const int group = threadIdx.x / GT;
  const long long unit = (long long)(blockIdx.x >> LOG2C) * GROUPS + group;
  const long long units = (long long)(gridDim.x >> LOG2C) * GROUPS;
  const long long rounds = (tiles + units - 1) / units;
  auto fa = load(unit), fb = load(unit + units), fc = load(unit + 2 * units);
  int since = 0;
  auto drift = [&]() {
    if (SPLIT && ++since == DRIFT_TILES) {
      since = 0;
      cg::this_cluster().sync();
    }
  };
  for (long long i = 0; i < rounds; i += 3) {
    const long long t = unit + i * units;
    if (t < tiles) work(fa, t);
    fa = load(t + 3 * units);
    drift();
    if (i + 1 < rounds) {
      if (t + units < tiles) work(fb, t + units);
      fb = load(t + 4 * units);
      drift();
    }
    if (i + 2 < rounds) {
      if (t + 2 * units < tiles) work(fc, t + 2 * units);
      fc = load(t + 5 * units);
      drift();
    }
  }
}

// Shared memory: [GROUPS x 2 staging tiles of R k floats | this block's
// part of v (f32, or bf16 bits for bf16 values)]. R k is a multiple of 4,
// so every tile and the part are 16-byte aligned. out: (n,), or in a
// cluster of C > 1 blocks (C, n): block `rank` writes row `rank`, its
// columns' share of every row's sum.
template <int LOG2C, typename TV>
__global__ void __launch_bounds__(TB, 1)
spmv_smem_kernel(const TV* __restrict__ values,
                 const int* __restrict__ cols, const float* __restrict__ v,
                 long long n, int k, int d, int R, int lshift, int aligned,
                 float* __restrict__ out) {
  using PT = typename PartOf<TV>::T;
  extern __shared__ float4 smem4[];
  constexpr int C = 1 << LOG2C;
  constexpr bool SPLIT = LOG2C > 0;
  const int S = R * k;
  const int group = threadIdx.x / GT;
  const int gt = threadIdx.x % GT;
  float* stage = reinterpret_cast<float*>(smem4) + 2 * S * group;
  PT* part = reinterpret_cast<PT*>(reinterpret_cast<float*>(smem4) +
                                   2 * S * GROUPS);
  const unsigned rank = block_rank<LOG2C>();
  for (long long c = rank + (long long)C * threadIdx.x; c < d;
       c += (long long)C * TB)
    put(part + (c >> LOG2C), __ldg(v + c));
  sync_all<LOG2C>();

  const long long total = n * k;
  const long long tiles = (n + R - 1) / R;
  const int f0 = 4 * gt;
  const bool active = f0 < S;
  const int L = 1 << lshift;
  const int lane = gt & (L - 1);
  const int sub = gt >> lshift;
  const int subs = GT >> lshift;
  float* dst = SPLIT ? out + (long long)rank * n : out;
  int buf = 0;

  auto load = [&](long long tile) {
    if (active && tile < tiles)
      return load_frag<!SPLIT>(values, cols, tile * S + f0, total, aligned);
    return Frag{make_float4(0.f, 0.f, 0.f, 0.f), make_int4(0, 0, 0, 0)};
  };
  auto work = [&](const Frag& f, long long tile) {
    float* st = stage + buf * S;
    if (active) {
      float4 p;
      p.x = term<LOG2C, PT>(part, rank, f.a.x, f.c.x);
      p.y = term<LOG2C, PT>(part, rank, f.a.y, f.c.y);
      p.z = term<LOG2C, PT>(part, rank, f.a.z, f.c.z);
      p.w = term<LOG2C, PT>(part, rank, f.a.w, f.c.w);
      *reinterpret_cast<float4*>(st + f0) = p;
    }
    sync_group(group);
    // the next tile writes the other staging tile, and the one after that
    // comes behind the next barrier: no second barrier is needed
    for (int first = 0; first < R; first += subs) {
      const int rl = first + sub;
      float s = 0.f;
      if (rl < R) {
        const float* sr = st + rl * k;
        int j = lane;
        for (; j + 3 * L < k; j += 4 * L)  // four loads in flight
          s += (sr[j] + sr[j + L]) + (sr[j + 2 * L] + sr[j + 3 * L]);
        for (; j < k; j += L) s += sr[j];
      }
      for (int off = L >> 1; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off, L);
      const long long row = tile * R + rl;
      if (rl < R && lane == 0 && row < n) dst[row] = s;
    }
    buf ^= 1;
  };
  walk_tiles<LOG2C>(tiles, load, work);
}

// Shared memory: this block's part of the low words of the cluster's copy
// of g. lo and hi: (clusters, d) scratch, hi zeroed by the caller.
template <int LOG2C, typename TV>
__global__ void __launch_bounds__(TB, 1)
pullback_smem_kernel(const TV* __restrict__ values,
                     const int* __restrict__ cols,
                     const float* __restrict__ r, long long n, int k, int d,
                     int R, int aligned, const unsigned* a_bound,
                     const unsigned* r_bound, unsigned* __restrict__ lo,
                     unsigned* __restrict__ hi) {
  extern __shared__ float4 smem4[];
  constexpr int C = 1 << LOG2C;
  constexpr bool SPLIT = LOG2C > 0;
  unsigned* part = reinterpret_cast<unsigned*>(smem4);
  const unsigned rank = block_rank<LOG2C>();
  const int mine = (d - (int)rank + C - 1) >> LOG2C;
  for (int j = threadIdx.x; j < mine; j += TB) part[j] = 0u;
  sync_all<LOG2C>();

  const int S = R * k;
  const long long total = n * k;
  const long long tiles = (n + R - 1) / R;
  const int f0 = 4 * (threadIdx.x % GT);
  const bool active = f0 < S;
  const int q0 = f0 / k;
  const int rem0 = f0 - q0 * k;
  const Fixed fx = fixed_point(a_bound, r_bound, total);
  unsigned* hi_mine = hi + (long long)(blockIdx.x >> LOG2C) * d;

  // a thread's 4 slots lie in one row or, for k >= 4, in two: their r
  // travels with the fragment
  auto load = [&](long long tile) {
    RFrag f = {{make_float4(0.f, 0.f, 0.f, 0.f), make_int4(0, 0, 0, 0)},
               0.f, 0.f};
    if (active && tile < tiles) {
      f.f = load_frag<!SPLIT>(values, cols, tile * S + f0, total, aligned);
      const long long row = tile * R + q0;
      if (row < n) f.r0 = __ldg(r + row);
      if (row + 1 < n) f.r1 = __ldg(r + row + 1);
    }
    return f;
  };
  auto work = [&](const RFrag& f, long long tile) {
    if (!active) return;
    const long long row0 = tile * R + q0;
    long long row = row0;
    int rem = rem0;
    const float a[4] = {f.f.a.x, f.f.a.y, f.f.a.z, f.f.a.w};
    const int c[4] = {f.f.c.x, f.f.c.y, f.f.c.z, f.f.c.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // a slot beyond n k lies in a row >= n
      if (row < n && a[e] != 0.f) {
        const float rr =
            row == row0 ? f.r0 : (row == row0 + 1 ? f.r1 : __ldg(r + row));
        scatter_add<LOG2C>(part, hi_mine, rank, c[e], to_fixed(a[e] * rr, fx));
      }
      if (++rem == k) {
        rem = 0;
        ++row;
      }
    }
  };
  walk_tiles<LOG2C>(tiles, load, work);
  // every add to this part has landed before it is read
  __syncthreads();
  unsigned* lo_mine = lo + (long long)(blockIdx.x >> LOG2C) * d;
  for (int j = threadIdx.x; j < mine; j += TB)
    lo_mine[rank + ((long long)j << LOG2C)] = part[j];
}

// ---------------------------------------------------------------------------
// the bf16 pullback in a cluster, fed by TMA multicast
// ---------------------------------------------------------------------------

constexpr int CONSUMERS = TB - 32;  // a ring block: 1 producer warp, 31 others
constexpr int RING_SLOTS = 2 * CONSUMERS;  // a stage: 2 slots a consumer
constexpr int MAX_STAGES = 8;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* b,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(b)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned long long* b,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(b)),
      "r"(bytes)
      : "memory");
}

// Wait for the phase of parity `parity` to complete.
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

// Arrive on the barrier at b's offset in block `rank` of the cluster, with
// the arrive's default semantics (release at the block's scope, as
// CUTLASS's pipelines release a stage). Released at the cluster's scope,
// the ring took 19.2 ms at the GLM cell on an H100, 5.85 ms so (PERF.md):
// that release appears to wait for the thread's earlier device-memory
// atomics (the carries to hi).
__device__ __forceinline__ void mbar_arrive_at(unsigned long long* b,
                                               unsigned rank) {
  asm volatile(
      "{\n.reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n" ::"r"(smem_u32(b)),
      "r"(rank)
      : "memory");
}

// bytes from device memory to dst, at dst's offset in every block of a
// cluster of C, each block's barrier at bar's offset told of their
// arrival. Sizes and addresses are multiples of 16.
template <int C>
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)),
      "h"((unsigned short)((1u << C) - 1u))
      : "memory");
}

// The pullback of bf16 values in a cluster of C = 2^LOG2C blocks, the
// container's full tiles of R rows (R a multiple of 8: every copy 16-byte
// sized and aligned) fed through a ring of `stages` stages. Shared memory:
// [this block's part of the low words, part_bytes | stages x (R k values,
// R k cols, R r) | full barriers | empty barriers]. Warp 0's first thread
// is the producer: it waits for a stage to be empty in every block of the
// cluster (each block's empty barrier counts every consumer warp of the
// cluster), re-arms its block's full barrier for the stage's bytes, and in
// block 0 issues the stage's three copies, multicast to every block.
// Warps 1.. are consumers: slots t and t + CONSUMERS of each tile, read
// into registers, the stage released (so that its next copy is in flight
// while they add: 5.85 -> 5.12 ms at the GLM cell, PERF.md), each then
// added to this block's part where its column is this block's. The rows
// beyond the last full tile are the first cluster's, read straight from
// device memory. lo, hi, a_bound and r_bound as pullback_smem_kernel's.
template <int LOG2C>
__global__ void __launch_bounds__(TB, 1)
pullback_ring_kernel(const __nv_bfloat16* __restrict__ values,
                     const int* __restrict__ cols,
                     const float* __restrict__ r, long long n, int k, int d,
                     int R, int stages, int part_bytes,
                     const unsigned* a_bound, const unsigned* r_bound,
                     unsigned* __restrict__ lo, unsigned* __restrict__ hi) {
  static_assert(LOG2C > 0, "the ring feeds a cluster");
  extern __shared__ float4 smem4[];
  constexpr int C = 1 << LOG2C;
  unsigned char* base = reinterpret_cast<unsigned char*>(smem4);
  unsigned* part = reinterpret_cast<unsigned*>(base);
  const int S = R * k;
  const unsigned vbytes = 2u * S, cbytes = 4u * S, rbytes = 4u * R;
  const unsigned stage_bytes = vbytes + cbytes + rbytes;
  unsigned char* ring = base + part_bytes;
  unsigned long long* full = reinterpret_cast<unsigned long long*>(
      ring + (size_t)stages * stage_bytes);
  unsigned long long* empty = full + stages;
  const unsigned rank = block_rank<LOG2C>();
  const int mine = (d - (int)rank + C - 1) >> LOG2C;
  for (int j = threadIdx.x; j < mine; j += TB) part[j] = 0u;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, C * (CONSUMERS / 32));
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  sync_all<LOG2C>();

  const long long total = n * k;
  const long long full_tiles = n / R;
  const long long cluster = blockIdx.x >> LOG2C;
  const long long clusters = gridDim.x >> LOG2C;
  const Fixed fx = fixed_point(a_bound, r_bound, total);
  unsigned* hi_mine = hi + cluster * d;
  auto add = [&](float a, int c, float rr) {
    if (a != 0.f && ((unsigned)c & (C - 1u)) == rank)
      add_fixed(part + ((unsigned)c >> LOG2C), hi_mine + c,
                to_fixed(a * rr, fx));
  };

  if (threadIdx.x < 32) {
    if (threadIdx.x == 0) {
      int s = 0;
      unsigned ph = 0;
      for (long long t = cluster; t < full_tiles; t += clusters) {
        mbar_wait(empty + s, ph ^ 1u);
        mbar_expect_tx(full + s, stage_bytes);
        if (rank == 0) {
          unsigned char* st = ring + (size_t)s * stage_bytes;
          bulk_copy<C>(st, values + t * S, vbytes, full + s);
          bulk_copy<C>(st + vbytes, cols + t * S, cbytes, full + s);
          bulk_copy<C>(st + vbytes + cbytes, r + t * R, rbytes, full + s);
        }
        if (++s == stages) {
          s = 0;
          ph ^= 1u;
        }
      }
    }
  } else {
    const int ct = threadIdx.x - 32;
    const int j0 = ct, j1 = ct + CONSUMERS;
    const int q0 = j0 / k, q1 = j1 / k;
    int s = 0;
    unsigned ph = 0;
    for (long long t = cluster; t < full_tiles; t += clusters) {
      mbar_wait(full + s, ph);
      const unsigned char* st = ring + (size_t)s * stage_bytes;
      const unsigned short* sv = reinterpret_cast<const unsigned short*>(st);
      const int* sc = reinterpret_cast<const int*>(st + vbytes);
      const float* sr = reinterpret_cast<const float*>(st + vbytes + cbytes);
      // the slots into registers, the stage released, then the adds
      float a0 = 0.f, a1 = 0.f, r0 = 0.f, r1 = 0.f;
      int c0 = 0, c1 = 0;
      if (j0 < S) {
        a0 = widen(sv[j0]);
        c0 = sc[j0];
        r0 = sr[q0];
      }
      if (j1 < S) {
        a1 = widen(sv[j1]);
        c1 = sc[j1];
        r1 = sr[q1];
      }
      __syncwarp();
      if ((threadIdx.x & 31) == 0)
        for (int q = 0; q < C; ++q) mbar_arrive_at(empty + s, (unsigned)q);
      add(a0, c0, r0);
      add(a1, c1, r1);
      if (++s == stages) {
        s = 0;
        ph ^= 1u;
      }
    }
    if (cluster == 0)
      for (long long g = full_tiles * S + ct; g < total; g += CONSUMERS)
        add(ldv(values + g, true), __ldcs(cols + g), __ldg(r + g / k));
  }
  // every add to this part has landed before it is read
  __syncthreads();
  unsigned* lo_mine = lo + cluster * d;
  for (int j = threadIdx.x; j < mine; j += TB)
    lo_mine[rank + ((long long)j << LOG2C)] = part[j];
  // no block leaves while another may still arrive on its barriers
  cg::this_cluster().sync();
}

// out[i] = partial[0][i] + partial[1][i] + ... in row order (the forward's
// cluster of 2).
__global__ void __launch_bounds__(THREADS)
sum_partials_kernel(const float* __restrict__ partial, int rows,
                    long long len, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= len) return;
  float s = 0.f;
  for (int j = 0; j < rows; ++j) s += partial[j * len + i];
  out[i] = s;
}

int launch_sum(const float* partial, int rows, long long len, float* out,
               cudaStream_t s) {
  const long long blocks = (len + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  sum_partials_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(partial, rows,
                                                           len, out);
  return (int)cudaGetLastError();
}

int tile_rows(int k) { return (TILE_SLOTS / k) & ~3; }

// A block's bytes of v (forward: 2 a column for bf16 values, else 4) or
// of g's low words (pullback: 4), plus the forward's staging tiles.
long long smem_bytes(bool pull, int k, int d, int cluster, bool bf16) {
  const long long width = (!pull && bf16) ? 2 : 4;
  const long long part = width * ((d + cluster - 1) / cluster);
  return pull ? part : part + 8LL * GROUPS * tile_rows(k) * k;
}

// One launch's shape: the kernel, its dynamic shared memory and the grid
// (whole clusters: as many as the card holds at once, or as the tiles
// need).
struct Plan {
  const void* kernel;
  int cluster;
  int smem;
  int grid;
};

// The cluster sizes each direction is built for: 1 and 2 forward; 1, 2
// and 4 pullback.
template <typename TV>
const void* pick_kernel_of(bool pull, int cluster) {
  switch (cluster) {
    case 1: return pull ? (const void*)pullback_smem_kernel<0, TV>
                        : (const void*)spmv_smem_kernel<0, TV>;
    case 2: return pull ? (const void*)pullback_smem_kernel<1, TV>
                        : (const void*)spmv_smem_kernel<1, TV>;
    case 4: return pull ? (const void*)pullback_smem_kernel<2, TV> : nullptr;
    default: return nullptr;
  }
}

const void* pick_kernel(bool pull, int cluster, bool bf16) {
  return bf16 ? pick_kernel_of<__nv_bfloat16>(pull, cluster)
              : pick_kernel_of<float>(pull, cluster);
}

// The bf16 pullback's ring in a cluster of `cluster` blocks.
const void* ring_kernel(int cluster) {
  switch (cluster) {
    case 2: return (const void*)pullback_ring_kernel<1>;
    case 4: return (const void*)pullback_ring_kernel<2>;
    default: return nullptr;
  }
}

void fill_config(const Plan& p, cudaStream_t s, cudaLaunchConfig_t* cfg,
                 cudaLaunchAttribute* attr) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)p.grid);
  cfg->blockDim = dim3(TB);
  cfg->dynamicSmemBytes = (size_t)p.smem;
  cfg->stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)p.cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// What the host asks the driver once for each (device, kernel, cluster,
// shared memory) and keeps: the kernel's grant of dynamic shared memory
// (only ever raised: a kernel's grant is the largest any of its plans
// asked for) and the clusters the card holds at once (-1 for a grant
// alone). A process's plans are few; beyond HELD_SLOTS the answers are
// asked for again at each call. The search launches from threads, so the
// table is locked.
struct Held {
  int device;
  const void* kernel;
  int cluster, smem, held;
};
constexpr int HELD_SLOTS = 128;
Held held_table[HELD_SLOTS];
int held_count = 0;
std::mutex held_lock;

// kernel's grant raised to at least smem on this device (the lock held)
cudaError_t grant_locked(int device, const void* kernel, int smem) {
  int granted = 0;
  for (int i = 0; i < held_count; ++i)
    if (held_table[i].device == device && held_table[i].kernel == kernel &&
        held_table[i].smem > granted)
      granted = held_table[i].smem;
  if (smem <= granted) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

void keep_locked(int device, const void* kernel, int cluster, int smem,
                 int held) {
  if (held_count < HELD_SLOTS)
    held_table[held_count++] = Held{device, kernel, cluster, smem, held};
}

// The grant alone (the bf16 pullback's ring)
int grant(const void* kernel, int smem) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  std::lock_guard<std::mutex> guard(held_lock);
  for (int i = 0; i < held_count; ++i) {
    const Held& h = held_table[i];
    if (h.device == device && h.kernel == kernel && h.cluster == -1 &&
        h.smem == smem)
      return 0;
  }
  e = grant_locked(device, kernel, smem);
  if (e != cudaSuccess) return (int)e;
  keep_locked(device, kernel, -1, smem, 0);
  return 0;
}

// p's kernel granted p->smem, and the clusters of p->cluster blocks the
// card holds at once in *held
int held_clusters(const Plan& p, int* held) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  std::lock_guard<std::mutex> guard(held_lock);
  for (int i = 0; i < held_count; ++i) {
    const Held& h = held_table[i];
    if (h.device == device && h.kernel == p.kernel &&
        h.cluster == p.cluster && h.smem == p.smem) {
      *held = h.held;
      return 0;
    }
  }
  e = grant_locked(device, p.kernel, p.smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  fill_config(p, nullptr, &cfg, &attr);
  e = cudaOccupancyMaxActiveClusters(held, p.kernel, &cfg);
  if (e != cudaSuccess) return (int)e;
  keep_locked(device, p.kernel, p.cluster, p.smem, *held);
  return 0;
}

int make_plan(bool pull, long long n, int k, int d, int cluster, bool bf16,
              Plan* p) {
  if (n <= 0 || k <= 0 || k > MAX_K || d <= 0)
    return (int)cudaErrorInvalidValue;
  p->kernel = pick_kernel(pull, cluster, bf16);
  if (p->kernel == nullptr) return (int)cudaErrorInvalidValue;
  const long long bytes = smem_bytes(pull, k, d, cluster, bf16);
  if (bytes > SMEM_BLOCK_BYTES) return (int)cudaErrorInvalidValue;
  p->cluster = cluster;
  p->smem = (int)bytes;
  p->grid = cluster;
  int held = 0;
  const int err = held_clusters(*p, &held);
  if (err) return err;
  if (held < 1) return (int)cudaErrorLaunchOutOfResources;
  const int R = tile_rows(k);
  const long long tiles = (n + R - 1) / R;
  // the groups of a cluster each take a tile (every block of it all of
  // the cluster's)
  const long long wanted = (tiles + GROUPS - 1) / GROUPS;
  p->grid = cluster * (int)(wanted < held ? wanted : held);
  return 0;
}

// log2 of the lanes that sum one row of a staging tile: as many as the
// row has slots (at most a warp), but no more than give every row of the
// tile its lanes in one pass over the group.
int lshift_of(int k) {
  const int R = tile_rows(k);
  int s = 0;
  while ((2 << s) <= lanes_of(k) && (2 << s) * R <= GT) ++s;
  return s;
}

bool aligned16(const void* a, const void* b) {
  return (((unsigned long long)a | (unsigned long long)b) & 15ULL) == 0;
}

// The ring's shape for rows of k slots in a cluster of `cluster` blocks:
// R rows a stage (as many as give every consumer
// thread two slots; a multiple of 8), and as many stages (2 to
// MAX_STAGES) as fit beside the part. False where none fits.
struct Ring {
  int R, stages, part_bytes, smem;
};

bool ring_shape(int k, int d, int cluster, Ring* g) {
  g->R = (RING_SLOTS / k) & ~7;
  if (g->R < 8) return false;
  g->part_bytes = (int)(((4LL * ((d + cluster - 1) / cluster)) + 15) & ~15LL);
  const long long stage = 6LL * g->R * k + 4LL * g->R;
  long long left = SMEM_BLOCK_BYTES - g->part_bytes - 16LL * MAX_STAGES;
  g->stages = (int)(left > 0 ? left / stage : 0);
  if (g->stages > MAX_STAGES) g->stages = MAX_STAGES;
  if (g->stages < 2) return false;
  g->smem = (int)(g->part_bytes + g->stages * stage + 16LL * g->stages);
  return true;
}

int launch_plan(const Plan& p, void** args, cudaStream_t s) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  fill_config(p, s, &cfg, &attr);
  cudaError_t e = cudaLaunchKernelExC(&cfg, p.kernel, args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// Lanes that share one row for a row of k slots.
extern "C" int dml_spmv_lanes(int k) { return lanes_of(k); }

// Rows of a tile of the shared-memory kernels; 0 where k is beyond a tile.
extern "C" int dml_spmv_tile_rows(int k) {
  return (k >= 1 && k <= MAX_K) ? tile_rows(k) : 0;
}

// values of f32 (vbf16 = 0) or bf16 elements
#define DML_VALUES(vbf16, values, CALL)                               \
  ((vbf16) ? CALL(static_cast<const __nv_bfloat16*>(values))          \
           : CALL(static_cast<const float*>(values)))

// The d-vector in L2. values (n, k) f32 or (vbf16) bf16, cols (n, k) int32
// in [0, len(v)), v f32 (for bf16 values the kernel rounds each entry it
// reads to bf16), out (n,) f32,
// all device pointers, rows contiguous. Returns cudaGetLastError() after
// the launch.
extern "C" int dml_spmv(const void* values, int vbf16, const int* cols,
                        const float* v, long long n, int k, float* out,
                        void* stream) {
  if (n <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DML_CALL(vals)                                                   \
  dispatch_l2(false, vals, cols, v, n, k, out, nullptr, nullptr, nullptr, s)
  return DML_VALUES(vbf16, values, DML_CALL);
#undef DML_CALL
}

// The d-vector (d floats) in the shared memory of clusters of `cluster`
// blocks (1 or 2). A cluster of 2 needs partial, a (cluster, n) f32
// scratch (two launches: the walk, then the sum of the partial outputs in
// rank order). Refuses (cudaErrorInvalidValue) another cluster size and a
// shape that does not fit: k > 512, or w ceil(d / cluster) + 16 R k bytes
// beyond a block (w = 4, or 2 for bf16 values).
extern "C" int dml_spmv_smem(const void* values, int vbf16, const int* cols,
                             const float* v, long long n, int k, int d,
                             int cluster, float* partial, float* out,
                             void* stream) {
  Plan p;
  int err = make_plan(false, n, k, d, cluster, vbf16 != 0, &p);
  if (err) return err;
  const bool split = cluster > 1;
  if (split && partial == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int R = tile_rows(k), lshift = lshift_of(k);
  int aligned = aligned16(values, cols) ? 1 : 0;
  float* dst = split ? partial : out;
  void* args[] = {&values, &cols, &v, &n, &k, &d, &R, &lshift, &aligned,
                  &dst};
  err = launch_plan(p, args, s);
  if (err || !split) return err;
  return launch_sum(partial, cluster, n, out, s);
}

// Clusters the shared-memory pullback launches for this shape on this
// card (cluster: 1, 2 or 4 blocks each): the rows of its (clusters, d)
// scratch. Negative: minus the CUDA error that refuses the shape.
extern "C" int dml_spmv_pullback_clusters(long long n, int k, int d,
                                          int cluster, int vbf16) {
  Plan p;
  int err = make_plan(true, n, k, d, cluster, vbf16 != 0, &p);
  return err ? -err : p.grid / cluster;
}

// The bits of max |x| over len values (f32 or, vbf16, bf16) into *out
// (device memory), as f32 bits, for the pullback's a_bound. Two launches
// (a memset, the reduction).
extern "C" int dml_spmv_absmax(const void* x, int vbf16, long long len,
                               unsigned* out, void* stream) {
  if (len <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DML_CALL(vals) launch_absmax(vals, len, out, s)
  return DML_VALUES(vbf16, x, DML_CALL);
#undef DML_CALL
}

// The walks the bf16 pullback in shared memory can take (dml_spmv_pullback
// _smem's `walk`): the plan's (the ring in a cluster, where it runs), the
// tiles of pullback_smem_kernel, and the ring. f32 values take the tiles
// whatever `walk` says.
enum Walk { WALK_AUTO = 0, WALK_TILES, WALK_RING };

// Whether the ring runs for this container (bf16 values in a cluster,
// every pointer 16-byte aligned, the ring beside the part), its shape in g.
bool ring_runs(const void* values, int vbf16, const int* cols,
               const float* r, int k, int d, int cluster, Ring* g) {
  return vbf16 && cluster > 1 && aligned16(values, cols) && aligned16(r, r) &&
         ring_shape(k, d, cluster, g);
}

// The pullback with g in shared memory: values as dml_spmv's; r (n,) f32;
// a_bound, the bits of max |values|
// (dml_spmv_absmax); r_bound, one word of scratch that takes max |r|; lo
// and hi, (clusters, d) 32-bit scratch with clusters =
// dml_spmv_pullback_clusters(...); g (d,) f32 out; walk (enum Walk) for
// bf16 values. Returns
// cudaGetLastError() after the last of its launches (|r|'s bound, the
// zeroing of hi, the walk, the sum of the clusters' words); refuses a ring
// that was asked for where it cannot run.
extern "C" int dml_spmv_pullback_smem(const void* values, int vbf16,
                                      const int* cols, const float* r,
                                      long long n, int k, int d, int cluster,
                                      const unsigned* a_bound,
                                      unsigned* r_bound, unsigned* lo,
                                      unsigned* hi, int clusters, float* g,
                                      int walk, void* stream) {
  Plan p;
  int err = make_plan(true, n, k, d, cluster, vbf16 != 0, &p);
  if (err) return err;
  if (p.grid / cluster != clusters) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Ring ring;
  const bool ring_ok = ring_runs(values, vbf16, cols, r, k, d, cluster, &ring);
  if (walk == WALK_RING && !ring_ok) return (int)cudaErrorInvalidValue;
  const bool use_ring = ring_ok && (walk == WALK_RING || walk == WALK_AUTO);
  err = launch_absmax(r, n, r_bound, s);
  if (err) return err;
  cudaError_t e = cudaMemsetAsync(hi, 0, 4 * (size_t)clusters * d, s);
  if (e != cudaSuccess) return (int)e;
  if (use_ring) {
    p.kernel = ring_kernel(cluster);
    p.smem = ring.smem;
    err = grant(p.kernel, p.smem);
    if (err) return err;
    void* args[] = {&values, &cols,    &r,      &n,
                    &k,      &d,       &ring.R, &ring.stages,
                    &ring.part_bytes, &a_bound, &r_bound, &lo, &hi};
    err = launch_plan(p, args, s);
  } else {
    int R = tile_rows(k);
    int aligned = aligned16(values, cols) ? 1 : 0;
    void* args[] = {&values, &cols, &r,       &n,       &k,  &d, &R,
                    &aligned, &a_bound, &r_bound, &lo, &hi};
    err = launch_plan(p, args, s);
  }
  if (err) return err;
  return launch_from_fixed(lo, hi, clusters, d, 1, d, a_bound, r_bound,
                           n * (long long)k, g, s);
}

// The walk the bf16 pullback in shared memory takes for this container:
// 1 the ring, 0 the tiles (for f32 values, always 0).
extern "C" int dml_spmv_pullback_rings(const void* values, int vbf16,
                                       const int* cols, const float* r, int k,
                                       int d, int cluster) {
  Ring ring;
  return ring_runs(values, vbf16, cols, r, k, d, cluster, &ring);
}

// The pullback with g in L2: values, r, a_bound and r_bound as above, acc
// (d,) 64-bit scratch; zeroes acc, adds every slot's q with a
// device-memory atomic, then turns acc into g (d,) f32.
extern "C" int dml_spmv_pullback_atomic(const void* values, int vbf16,
                                        const int* cols, const float* r,
                                        long long n, int k, int d,
                                        const unsigned* a_bound,
                                        unsigned* r_bound,
                                        unsigned long long* acc, float* g,
                                        void* stream) {
  if (n <= 0 || k <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = launch_absmax(r, n, r_bound, s);
  if (err) return err;
  cudaError_t e = cudaMemsetAsync(acc, 0, 8 * (size_t)d, s);
  if (e != cudaSuccess) return (int)e;
#define DML_CALL(vals) \
  dispatch_l2(true, vals, cols, r, n, k, nullptr, a_bound, r_bound, acc, s)
  err = DML_VALUES(vbf16, values, DML_CALL);
#undef DML_CALL
  if (err) return err;
  const unsigned* words = reinterpret_cast<const unsigned*>(acc);
  return launch_from_fixed(words, words + 1, 1, 0, 2, d, a_bound, r_bound,
                           n * (long long)k, g, s);
}
