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
// Where d is beyond the cluster's reach, k beyond a tile (512), or n k too
// small against d to pay for filling shared memory, the d-vector stays in
// L2: spmv_kernel (a set of L lanes a row, the first version of this
// port) and pullback_atomic_kernel (the same walk, fused, the same
// fixed-point q added with 64-bit integer atomics on device memory: the
// bits of every other route).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

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

// ---------------------------------------------------------------------------
// the d-vector in L2
// ---------------------------------------------------------------------------

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

int lanes_of(int k) {
  int L = 1;
  while (L < k && L < 32) L <<= 1;
  return L;
}

// ---------------------------------------------------------------------------
// the pullback's fixed point
// ---------------------------------------------------------------------------

// The bits of max |x| over x: non-negative floats order as their bits
// (NaN above inf above every finite value), so an integer max repeats.
__global__ void __launch_bounds__(THREADS)
absmax_kernel(const float* __restrict__ x, long long len,
              unsigned* __restrict__ out) {
  unsigned m = 0;
  const long long stride = (long long)gridDim.x * THREADS;
#pragma unroll 4
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < len;
       i += stride)
    m = max(m, __float_as_uint(__ldcs(x + i)) & 0x7fffffffu);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0 && m != 0) atomicMax(out, m);
}

int launch_absmax(const float* x, long long len, unsigned* out,
                  cudaStream_t s) {
  cudaError_t e = cudaMemsetAsync(out, 0, sizeof(unsigned), s);
  if (e != cudaSuccess) return (int)e;
  long long blocks = (len + THREADS - 1) / THREADS;
  if (blocks > 8 * 132) blocks = 8 * 132;
  if (blocks < 1) blocks = 1;
  absmax_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(x, len, out);
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
template <int L>
__global__ void __launch_bounds__(THREADS)
pullback_atomic_kernel(const float* __restrict__ values,
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
  const float* vr = values + row * k;
  const int* cr = cols + row * k;
#pragma unroll 4
  for (int j = lane; j < k; j += L) {
    const float a = __ldcs(vr + j);
    const int c = __ldcs(cr + j);
    if (a != 0.f)
      atomicAdd(acc + c, (unsigned long long)to_fixed(a * rr, f));
  }
}

// Both L2 kernels for rows of k slots: L = lanes_of(k) lanes a row.
template <int L>
int launch_l2_lanes(bool pull, const float* values, const int* cols,
                    const float* x, long long n, int k, float* out,
                    const unsigned* a_bound, const unsigned* r_bound,
                    unsigned long long* acc, cudaStream_t s) {
  const long long blocks = (n * L + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (pull)
    pullback_atomic_kernel<L><<<(unsigned)blocks, THREADS, 0, s>>>(
        values, cols, x, n, k, a_bound, r_bound, acc);
  else
    spmv_kernel<L><<<(unsigned)blocks, THREADS, 0, s>>>(values, cols, x, n,
                                                         k, out);
  return (int)cudaGetLastError();
}

int dispatch_l2(bool pull, const float* values, const int* cols,
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
  return STREAM ? __ldcs(p) : __ldg(p);
}
template <bool STREAM>
__device__ __forceinline__ int ld1(const int* p) {
  return STREAM ? __ldcs(p) : __ldg(p);
}

// Four consecutive slots from flat index g0 (a multiple of 4): one 16-byte
// load each of values and cols where they are aligned and in range, else
// slot by slot, slots >= total as (col 0, value 0). STREAM: nobody reads
// the tile again, so it is loaded evict-first.
template <bool STREAM>
__device__ __forceinline__ Frag load_frag(const float* __restrict__ values,
                                          const int* __restrict__ cols,
                                          long long g0, long long total,
                                          bool aligned) {
  Frag f;
  if (aligned && g0 + 4 <= total) {
    const float4* pa = reinterpret_cast<const float4*>(values + g0);
    const int4* pc = reinterpret_cast<const int4*>(cols + g0);
    f.a = STREAM ? __ldcs(pa) : __ldg(pa);
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

// a * v[col], or 0 where the column is another block's.
template <int LOG2C>
__device__ __forceinline__ float term(const float* part, unsigned rank,
                                      float a, int col) {
  if (LOG2C == 0) return a * part[col];
  if (((unsigned)col & ((1u << LOG2C) - 1u)) != rank) return 0.f;
  return a * part[(unsigned)col >> LOG2C];
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
// part of v]. R k is a multiple of 4, so every tile and the part are
// 16-byte aligned. out: (n,), or in a cluster of C > 1 blocks (C, n):
// block `rank` writes row `rank`, its columns' share of every row's sum.
template <int LOG2C>
__global__ void __launch_bounds__(TB, 1)
spmv_smem_kernel(const float* __restrict__ values,
                 const int* __restrict__ cols, const float* __restrict__ v,
                 long long n, int k, int d, int R, int lshift, int aligned,
                 float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  constexpr int C = 1 << LOG2C;
  constexpr bool SPLIT = LOG2C > 0;
  const int S = R * k;
  const int group = threadIdx.x / GT;
  const int gt = threadIdx.x % GT;
  float* stage = reinterpret_cast<float*>(smem4) + 2 * S * group;
  float* part = reinterpret_cast<float*>(smem4) + 2 * S * GROUPS;
  const unsigned rank = block_rank<LOG2C>();
  for (long long c = rank + (long long)C * threadIdx.x; c < d;
       c += (long long)C * TB)
    part[c >> LOG2C] = __ldg(v + c);
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
      p.x = term<LOG2C>(part, rank, f.a.x, f.c.x);
      p.y = term<LOG2C>(part, rank, f.a.y, f.c.y);
      p.z = term<LOG2C>(part, rank, f.a.z, f.c.z);
      p.w = term<LOG2C>(part, rank, f.a.w, f.c.w);
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
template <int LOG2C>
__global__ void __launch_bounds__(TB, 1)
pullback_smem_kernel(const float* __restrict__ values,
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

long long smem_bytes(bool pull, int k, int d, int cluster) {
  const long long part = 4LL * ((d + cluster - 1) / cluster);
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
const void* pick_kernel(bool pull, int cluster) {
  switch (cluster) {
    case 1: return pull ? (const void*)pullback_smem_kernel<0>
                        : (const void*)spmv_smem_kernel<0>;
    case 2: return pull ? (const void*)pullback_smem_kernel<1>
                        : (const void*)spmv_smem_kernel<1>;
    case 4: return pull ? (const void*)pullback_smem_kernel<2> : nullptr;
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

int make_plan(bool pull, long long n, int k, int d, int cluster, Plan* p) {
  if (n <= 0 || k <= 0 || k > MAX_K || d <= 0)
    return (int)cudaErrorInvalidValue;
  p->kernel = pick_kernel(pull, cluster);
  if (p->kernel == nullptr) return (int)cudaErrorInvalidValue;
  const long long bytes = smem_bytes(pull, k, d, cluster);
  if (bytes > SMEM_BLOCK_BYTES) return (int)cudaErrorInvalidValue;
  p->cluster = cluster;
  p->smem = (int)bytes;
  cudaError_t e = cudaFuncSetAttribute(
      p->kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p->smem);
  if (e != cudaSuccess) return (int)e;
  p->grid = cluster;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  fill_config(*p, nullptr, &cfg, &attr);
  int held = 0;
  e = cudaOccupancyMaxActiveClusters(&held, p->kernel, &cfg);
  if (e != cudaSuccess) return (int)e;
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

// The d-vector in L2. values (n, k) f32, cols (n, k) int32 in [0, len(v)),
// v f32, out (n,) f32, all device pointers, rows contiguous. Returns
// cudaGetLastError() after the launch.
extern "C" int dml_spmv(const float* values, const int* cols, const float* v,
                        long long n, int k, float* out, void* stream) {
  if (n <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  return dispatch_l2(false, values, cols, v, n, k, out, nullptr, nullptr,
                     nullptr, static_cast<cudaStream_t>(stream));
}

// The d-vector (d floats) in the shared memory of clusters of `cluster`
// blocks (1 or 2). A cluster of 2 needs partial, a (cluster, n) f32
// scratch (two launches: the walk, then the sum of the partial outputs in
// rank order). Refuses (cudaErrorInvalidValue) another cluster size and a
// shape that does not fit: k > 512, or 4 ceil(d / cluster) + 16 R k bytes
// beyond a block.
extern "C" int dml_spmv_smem(const float* values, const int* cols,
                             const float* v, long long n, int k, int d,
                             int cluster, float* partial, float* out,
                             void* stream) {
  Plan p;
  int err = make_plan(false, n, k, d, cluster, &p);
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
                                          int cluster) {
  Plan p;
  int err = make_plan(true, n, k, d, cluster, &p);
  return err ? -err : p.grid / cluster;
}

// The bits of max |x| over len floats into *out (device memory), for the
// pullback's a_bound. Two launches (a memset, the reduction).
extern "C" int dml_spmv_absmax(const float* x, long long len, unsigned* out,
                               void* stream) {
  if (len <= 0) return (int)cudaErrorInvalidValue;
  return launch_absmax(x, len, out, static_cast<cudaStream_t>(stream));
}

// The pullback with g in shared memory: r (n,) f32; a_bound, the bits of
// max |values| (dml_spmv_absmax); r_bound, one word of scratch that takes
// max |r|; lo and hi, (clusters, d) 32-bit scratch with clusters =
// dml_spmv_pullback_clusters(...); g (d,) f32 out. Returns
// cudaGetLastError() after the last of its launches (|r|'s bound, the
// zeroing of hi, the walk, the sum of the clusters' words).
extern "C" int dml_spmv_pullback_smem(const float* values, const int* cols,
                                      const float* r, long long n, int k,
                                      int d, int cluster,
                                      const unsigned* a_bound,
                                      unsigned* r_bound, unsigned* lo,
                                      unsigned* hi, int clusters, float* g,
                                      void* stream) {
  Plan p;
  int err = make_plan(true, n, k, d, cluster, &p);
  if (err) return err;
  if (p.grid / cluster != clusters) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = launch_absmax(r, n, r_bound, s);
  if (err) return err;
  cudaError_t e = cudaMemsetAsync(hi, 0, 4 * (size_t)clusters * d, s);
  if (e != cudaSuccess) return (int)e;
  int R = tile_rows(k);
  int aligned = aligned16(values, cols) ? 1 : 0;
  void* args[] = {&values, &cols, &r,       &n,       &k,  &d, &R,
                  &aligned, &a_bound, &r_bound, &lo, &hi};
  err = launch_plan(p, args, s);
  if (err) return err;
  return launch_from_fixed(lo, hi, clusters, d, 1, d, a_bound, r_bound,
                           n * (long long)k, g, s);
}

// The pullback with g in L2: a_bound and r_bound as above, acc (d,) 64-bit
// scratch; zeroes acc, adds every slot's q with a device-memory atomic,
// then turns acc into g (d,) f32.
extern "C" int dml_spmv_pullback_atomic(const float* values, const int* cols,
                                        const float* r, long long n, int k,
                                        int d, const unsigned* a_bound,
                                        unsigned* r_bound,
                                        unsigned long long* acc, float* g,
                                        void* stream) {
  if (n <= 0 || k <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = launch_absmax(r, n, r_bound, s);
  if (err) return err;
  cudaError_t e = cudaMemsetAsync(acc, 0, 8 * (size_t)d, s);
  if (e != cudaSuccess) return (int)e;
  err = dispatch_l2(true, values, cols, r, n, k, nullptr, a_bound, r_bound,
                    acc, s);
  if (err) return err;
  const unsigned* words = reinterpret_cast<const unsigned*>(acc);
  return launch_from_fixed(words, words + 1, 1, 0, 2, d, a_bound, r_bound,
                           n * (long long)k, g, s);
}
