// K6: pillar voxelization of a point cloud. Hand-written for sm_90a.
//
// Replaces graph_detr4d_tpu/ops/voxelize.py: `pillar_indices` (:26),
// `pillar_center_offsets` (:77) and `pillar_scatter` (:52), the dense
// PointPillars pillar scatter that stands in for mmdet3d's hard voxelizer.
// Points are (B, P, F) float32 with xyz first; the BEV grid is (H, W) cells
// with x along the first axis; a point that is masked out or outside the
// range in x, y or z goes to a trash cell H*W of its own sample.
//
// pillar_features: cell ids and augmented rows, one cooperative kernel
// (described at pillar_features_kernel). What bounds it on this card:
// bytes (each point read, its id and its 40-byte row written; about 0.006
// ms for 300,000 points) and, at these sizes, the host: a call launches
// one kernel and no memset, and its caller passes the grid's geometry as
// plain floats.
// pillar_scatter_max (kernel C, scatter_max_kernel): the per-cell max, one
// cooperative launch (no fill kernel, no memset, no fix-up kernel). What
// bounds it: bytes, the (P, C) features read once (77 MB at 300,000 points
// x 64 channels, ~0.023 ms), and the L2 atomics that fold them into the
// (H*W, C) grid (4.2 MB, kept in L2: the features are streamed past it
// evict-first). The grid holds an order-preserving uint32 key of each
// float (one unsigned atomicMax for either sign; 0 = no point; every NaN
// the largest key), zeroed, scattered and decoded in place (non-finite ->
// 0) between two grid-wide barriers. A warp takes 32 consecutive points:
// ids loaded once, coalesced, one division per point; lane t takes
// columns t, t + 32, ... of a point's row, so each atomic instruction
// covers 128 contiguous bytes of one cell
// (16-byte loads a lane would leave each atomic instruction spread over
// 16 sectors: measured slower); 8 points' loads are issued before their
// atomics; consecutive points of one cell fold into one atomic. Reading
// the cell's key first to skip atomics that cannot raise it was measured
// slower in every layout tried (PERF.md), so every run issues its atomic.
// pillar_scatter_max_backward (scatter_max_backward_kernel): the max's
// gradient, each cell's gradient split evenly between the points that hold
// its max. Bytes again: features read and their gradient written (154 MB,
// ~0.046 ms), ids and grad_out read; one cooperative launch (no memset):
// the (B, H*W, C) winner counts zeroed in the kernel and kept in L2, a
// pass that counts and marks each point's wins (a bit a point and
// column, 2.4 MB at 300,000 points, so that the gradient pass reads
// neither the features nor the max again), then the gradient pass; two
// columns a lane, so that a row is one 8-byte access a lane and a lane's
// two counts one 64-bit atomic.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One record of the cell table per (sample, cell), the real cells 0 ..
// H*W - 1 and the trash cell H*W: the sums of the x, y and z of the points
// in the cell, and their count. A real cell sums each coordinate times 2^k
// rounded to an integer, with integer atomics, k per axis as large as the
// sum of P such terms allows (2^(62 - e - bits of P) for coordinates below
// 2^e): the sums do not depend on the order the points arrive in, and
// where every coordinate is a multiple of 2^-k (all of |x| >= 2^(23 - k),
// at a 300,000-point cloud's x all of |x| >= 2^-14) they are the exact
// sums, as the plain version's float64 sums of float32 coordinates are, so
// the two round to the same float32 means. The trash cell, which takes
// points from anywhere, sums in float64 (its s[] holds double bits).
struct __align__(32) CellSums {
  unsigned long long s[3];
  unsigned count;
  unsigned pad;
};

struct Geometry {
  float x0, y0, z0, z1;  // the range's lower x, y and its z bounds
  float rx, ry;          // float32 reciprocals of the cell sizes
  float sx, sy;          // the cell sizes
  float fix[3];          // 2^k of each axis's cell sums
  float unfix[3];        // 2^-k
};

// The whole of pillar_features in one cooperative launch (no memset, one
// launch from the host), in three phases between grid-wide barriers:
//   0. zero the cell table;
//   1. one thread per point: its cell id, floor((x - x0) * (1 / sx)) with
//      the float32 reciprocal of the cell size (the JAX op divides by a
//      compile-time constant, which XLA turns into that multiplication, so
//      ids agree bit for bit at cell borders), the bound checks (z0 <= z <
//      z1, and mask > 0), and the point's sums into its cell's record (the
//      trash cell's reduced over the block first, see there);
//   2. the augmented rows [point..., x - cx, y - cy, xyz - sum / max(count,
//      1)] (the pillar centre taken from the id, each sum rounded to
//      float32 before the division, as the plain version), a block's
//      kThreads rows staged in shared memory and written out as one
//      contiguous run: a thread writing its own 40-byte row would leave
//      every store instruction of a warp spread over 40 partial sectors.
__global__ void __launch_bounds__(kThreads) pillar_features_kernel(
    const float* __restrict__ points,  // (B, P, F)
    const float* __restrict__ mask,    // (B, P), > 0 = valid
    int* __restrict__ ids,             // (B, P)
    float* __restrict__ aug,           // (B, P, F + 5)
    CellSums* __restrict__ table,      // (B, H*W + 1)
    int64_t n, int P, int F, int H, int W, Geometry g) {
  cg::grid_group grid = cg::this_grid();
  const int hw = H * W;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;

  uint4* words = reinterpret_cast<uint4*>(table);
  const int64_t n_words = (n / P) * (hw + 1) * (sizeof(CellSums) / sizeof(uint4));
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n_words; i += stride)
    words[i] = make_uint4(0u, 0u, 0u, 0u);
  grid.sync();

  // the trash cell's partial sums of each warp of an iteration
  __shared__ double s_trash[kThreads / 32][3];
  __shared__ unsigned s_trash_n[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // every thread of a block runs the same number of iterations, so the
  // reductions below see all of them
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads; base < n;
       base += stride) {
    const int64_t i = base + threadIdx.x;
    bool trash = false;
    double tx = 0.0, ty = 0.0, tz = 0.0;
    int64_t b = 0;
    if (i < n) {
      b = i / P;
      const float* p = points + i * F;
      const float x = p[0], y = p[1], z = p[2];
      const float fx = floorf((x - g.x0) * g.rx);
      const float fy = floorf((y - g.y0) * g.ry);
      // written with float comparisons so NaN and far-away points fail
      const bool inb = fx >= 0.f && fx < static_cast<float>(H) && fy >= 0.f &&
                       fy < static_cast<float>(W) && z >= g.z0 && z < g.z1 &&
                       mask[i] > 0.f;
      const int cell = inb ? static_cast<int>(fx) * W + static_cast<int>(fy)
                           : hw;
      ids[i] = cell;
      if (inb) {
        CellSums* r = table + b * (hw + 1) + cell;
        atomicAdd(&r->s[0], static_cast<unsigned long long>(
                                __float2ll_rn(x * g.fix[0])));
        atomicAdd(&r->s[1], static_cast<unsigned long long>(
                                __float2ll_rn(y * g.fix[1])));
        atomicAdd(&r->s[2], static_cast<unsigned long long>(
                                __float2ll_rn(z * g.fix[2])));
        atomicAdd(&r->count, 1u);
      } else {
        trash = true;
        tx = x;
        ty = y;
        tz = z;
      }
    }
    // The trash cell takes points from every warp (a fifth of a real
    // cloud: masked padding, points beyond the range): its sums are reduced
    // over the block, one atomic per block and iteration on its address
    // (one per warp would put ~10,000 of them on it for 300,000 points). A
    // block across two samples adds per point.
    const int64_t last = (base + kThreads < n ? base + kThreads : n) - 1;
    if (base / P == last / P) {  // block-uniform
      const double sx_ = warp_sum(tx), sy_ = warp_sum(ty), sz_ = warp_sum(tz);
      const unsigned k = __popc(__ballot_sync(0xffffffffu, trash));
      if (lane == 0) {
        s_trash[warp][0] = sx_;
        s_trash[warp][1] = sy_;
        s_trash[warp][2] = sz_;
        s_trash_n[warp] = k;
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        double a = 0.0, c = 0.0, d = 0.0;
        unsigned m = 0;
        for (int w = 0; w < kThreads / 32; ++w) {
          a += s_trash[w][0];
          c += s_trash[w][1];
          d += s_trash[w][2];
          m += s_trash_n[w];
        }
        if (m != 0) {
          CellSums* r = table + (base / P) * (hw + 1) + hw;
          double* s = reinterpret_cast<double*>(r->s);
          atomicAdd(s, a);
          atomicAdd(s + 1, c);
          atomicAdd(s + 2, d);
          atomicAdd(&r->count, m);
        }
      }
      __syncthreads();  // s_trash is read before the next iteration's writes
    } else if (trash) {
      CellSums* r = table + b * (hw + 1) + hw;
      double* s = reinterpret_cast<double*>(r->s);
      atomicAdd(s, tx);
      atomicAdd(s + 1, ty);
      atomicAdd(s + 2, tz);
      atomicAdd(&r->count, 1u);
    }
  }
  grid.sync();

  extern __shared__ float s_rows[];  // [kThreads][F + 5]
  const int row = F + 5;
  for (int64_t t0 = static_cast<int64_t>(blockIdx.x) * kThreads; t0 < n;
       t0 += stride) {  // the same trip count in every thread of a block
    const int64_t i = t0 + threadIdx.x;
    if (i < n) {
      const float* p = points + i * F;
      const int cell = ids[i];
      const CellSums r = table[(i / P) * (hw + 1) + cell];
      const float c = fmaxf(static_cast<float>(r.count), 1.f);
      float* o = s_rows + threadIdx.x * row;
      for (int f = 0; f < F; ++f) o[f] = p[f];
      // no fused multiply-add: the plain version rounds each step
      const float cx = __fadd_rn(
          g.x0, __fmul_rn(__fadd_rn(static_cast<float>(cell / W), 0.5f), g.sx));
      const float cy = __fadd_rn(
          g.y0, __fmul_rn(__fadd_rn(static_cast<float>(cell % W), 0.5f), g.sy));
      o[F] = p[0] - cx;
      o[F + 1] = p[1] - cy;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const double sum =
            cell < hw ? static_cast<double>(static_cast<long long>(r.s[k])) *
                            static_cast<double>(g.unfix[k])
                      : __longlong_as_double(static_cast<long long>(r.s[k]));
        o[F + 2 + k] = p[k] - static_cast<float>(sum) / c;
      }
    }
    __syncthreads();
    const int64_t m = min(static_cast<int64_t>(kThreads), n - t0) * row;
    float* dst = aug + t0 * row;
    for (int64_t e = threadIdx.x; e < m; e += kThreads) dst[e] = s_rows[e];
    __syncthreads();
  }
}

// The forward max-scatter keeps each (cell, channel)'s running max as an
// order-preserving uint32 key of the float, in the output buffer itself:
// one atomicMax on unsigned ints orders every float of either sign, and
// key 0 means "no point yet". Every NaN, of either sign, maps to the
// largest key, so a cell holding one ends NaN, as segment_max and
// scatter_reduce_'s amax propagate it.
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned b = __float_as_uint(v);
  return isnan(v) ? 0xffffffffu : b ^ ((b >> 31) ? 0xffffffffu : 0x80000000u);
}

// The float a key stands for, 0 where that is not finite: a NaN or +inf
// max, a cell whose points were all -inf, and key 0 (no point; it decodes
// to a NaN), as the JAX op's where(isfinite(out), out, 0).
__device__ __forceinline__ float key_value(unsigned k) {
  const float v = __uint_as_float(k ^ ((k >> 31) ? 0x80000000u : 0xffffffffu));
  return isfinite(v) ? v : 0.f;
}

// Points a warp loads at once, before any of their atomics.
constexpr int kBatch = 8;

// Columns a lane reads of a point's row at a time: lane t takes col0 + t
// and col0 + t + 32. Only C = 64 has been timed (the model's width); any C
// runs, in groups of 64 columns.
constexpr int NW = 2;

// Columns col0 + lane + 32 w (w < NW; those >= C take no part) of the
// warp's 32 points p0 .. p0 + 31. cell: point p0 + lane's flat cell b *
// hw + cell, -1 for the trash cell, -2 past the last point. A point's NW
// loads are issued together, so its row is read in one sweep. Consecutive
// points of one cell fold in registers into one run (a run is the same
// for every lane, so its atomics coalesce: 32 consecutive keys, 128
// bytes), and a run flushes with one atomicMax a column.
__device__ __forceinline__ void scatter_columns(const float* __restrict__ feats,
                                                unsigned* keys, int cell,
                                                int64_t p0, int C, int col0) {
  int col[NW];
  bool ok[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    col[w] = col0 + (threadIdx.x & 31) + 32 * w;
    ok[w] = col[w] < C;
  }
  int run_cell = -1;
  unsigned run[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) run[w] = 0u;
  auto flush = [&]() {
    if (run_cell < 0) return;
    unsigned* dst = keys + static_cast<int64_t>(run_cell) * C;
#pragma unroll
    for (int w = 0; w < NW; ++w)
      if (ok[w]) atomicMax(dst + col[w], run[w]);
  };
#pragma unroll
  for (int k0 = 0; k0 < 32; k0 += kBatch) {
    int cells[kBatch];
    float v[kBatch][NW];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      cells[u] = __shfl_sync(0xffffffffu, cell, k0 + u);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const float* row = feats + (p0 + k0 + u) * C;
#pragma unroll
      for (int w = 0; w < NW; ++w)  // streamed once: evict-first in L2
        v[u][w] = cells[u] >= 0 && ok[w] ? __ldcs(row + col[w]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (cells[u] != run_cell) {
        flush();
        run_cell = cells[u];
#pragma unroll
        for (int w = 0; w < NW; ++w) run[w] = 0u;
      }
      if (cells[u] >= 0) {
#pragma unroll
        for (int w = 0; w < NW; ++w) run[w] = max(run[w], order_key(v[u][w]));
      }
    }
  }
  flush();
}

// Phase 0 of the forward: every key 0, 16 bytes a thread (the keys are
// 16-byte aligned), the last n_cells % 4 one at a time.
__device__ __forceinline__ void zero_keys(unsigned* keys, int64_t n_cells,
                                          int64_t tid, int64_t stride) {
  uint4* k4 = reinterpret_cast<uint4*>(keys);
  for (int64_t i = tid; i < n_cells / 4; i += stride)
    k4[i] = make_uint4(0u, 0u, 0u, 0u);
  if (tid < n_cells % 4) keys[n_cells - n_cells % 4 + tid] = 0u;
}

// The last phase: every key decoded to its float in place, as zero_keys
// walks them.
__device__ __forceinline__ void decode_keys(unsigned* keys, int64_t n_cells,
                                            int64_t tid, int64_t stride) {
  const uint4* k4 = reinterpret_cast<const uint4*>(keys);
  float4* o4 = reinterpret_cast<float4*>(keys);
  for (int64_t i = tid; i < n_cells / 4; i += stride) {
    const uint4 k = __ldcg(k4 + i);
    o4[i] = make_float4(key_value(k.x), key_value(k.y), key_value(k.z),
                        key_value(k.w));
  }
  if (tid < n_cells % 4) {
    const int64_t i = n_cells - n_cells % 4 + tid;
    reinterpret_cast<float*>(keys)[i] = key_value(__ldcg(keys + i));
  }
}

// Point p0 + lane's flat cell b * hw + cell: -1 for the trash cell, -2
// past the last point (one division per point).
__device__ __forceinline__ int flat_cell(const int* __restrict__ ids,
                                         int64_t p0, int64_t n_pts, int P,
                                         int hw) {
  const int64_t pt = p0 + (threadIdx.x & 31);
  if (pt >= n_pts) return -2;
  const int id = ids[pt];
  return id < hw ? static_cast<int>(pt / P) * hw + id : -1;
}

// The forward max-scatter for any C, in one cooperative launch, three
// phases between grid-wide barriers: every key 0; the scatter, a warp per
// 32 consecutive points, NW columns a lane at a time (groups of 32 NW
// columns) read from device memory into registers; every key decoded.
__global__ void __launch_bounds__(kThreads) scatter_max_kernel(
    const float* __restrict__ feats,  // (B, P, C)
    const int* __restrict__ ids,      // (B, P)
    unsigned* keys,                   // (B, hw, C): the output, as keys
    int64_t n_pts, int64_t n_cells, int P, int C, int hw) {
  cg::grid_group grid = cg::this_grid();
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  zero_keys(keys, n_cells, tid, stride);
  grid.sync();
  const int lane = threadIdx.x & 31;
  for (int64_t p0 = tid - lane; p0 < n_pts; p0 += stride) {
    const int cell = flat_cell(ids, p0, n_pts, P, hw);
    for (int col0 = 0; col0 < C; col0 += 32 * NW)
      scatter_columns(feats, keys, cell, p0, C, col0);
  }
  grid.sync();
  decode_keys(keys, n_cells, tid, stride);
}

// The most blocks of a kernel that fit on the current device at once with
// smem bytes of dynamic shared memory (at most 48 KB), cached per call
// site in cache: {device, smem, blocks}. Returns 0 on an error.
template <typename Kernel>
int coresident_blocks(Kernel kernel, size_t smem, int cache[3]) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev != cache[0] || static_cast<int>(smem) != cache[1]) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                      smem) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 0;
    cache[0] = dev, cache[1] = static_cast<int>(smem), cache[2] = per_sm * sms;
  }
  return cache[2];
}

// Set in a cell's winner count when one of its values is NaN or +inf: its
// max then was not finite, the forward wrote 0 there, and the cell passes
// no gradient. A count stays below 2^31 (fewer points than that), so its
// adds never reach the flag.
constexpr unsigned kNonFinite = 0x80000000u;

// Points a warp loads before using any (its batch). The kernel caps its
// registers at 85 a thread so that an SM holds 3 blocks of 256 threads
// (PERF.md has the batches and caps timed).
constexpr int kBwdBatch = 8;
static_assert(32 % kBwdBatch == 0, "a warp's 32 points go in whole batches");

// The backward's layout: a warp takes 32 consecutive points, as the
// forward, and a point's row in groups of 64 columns, lane t taking the
// pair col0 + 2t, col0 + 2t + 1 (PAIR: C even, so a pair is one 8-byte
// load, one 8-byte store and one 64-bit atomic on its two counts; an odd
// C, the tail of a row, goes one column at a time). A point's win bits of
// a group are two words (bit t: lane t's first, resp. second column).
template <bool PAIR>
__device__ __forceinline__ float2 load_pair(const float* p, bool ok0, bool ok1) {
  if (PAIR) return ok0 ? __ldcs(reinterpret_cast<const float2*>(p)) : make_float2(0.f, 0.f);
  return make_float2(ok0 ? __ldcs(p) : 0.f, ok1 ? __ldcs(p + 1) : 0.f);
}

// Count and mark, one group of 64 columns (col0) of the warp's 32 points
// p0 .. p0 + 31 (cell: point p0 + lane's flat cell, -1 trash, -2 past the
// end): per (cell, column) the points whose value equals the forward's
// max (kNonFinite where one is NaN or +inf; a finite 0 in such a cell
// would otherwise count: the forward wrote 0 there), consecutive points
// of one cell folded into one atomic; per point its two mask words, which
// lane p of the warp stores for point p0 + p, once, coalesced. A -inf
// value raises no flag: it makes the max -inf only if every value is, and
// then no finite value can win.
template <bool PAIR>
__device__ __forceinline__ void count_columns(
    const float* __restrict__ feats, const float* __restrict__ out,
    unsigned* counts, uint2* __restrict__ masks, int cell, int64_t p0, int C,
    int col0, int groups, int group) {
  const int lane = threadIdx.x & 31;
  const int c0 = col0 + 2 * lane;
  const bool ok0 = c0 < C, ok1 = c0 + 1 < C;
  int run_cell = -1;
  unsigned run0 = 0u, run1 = 0u, nf0 = 0u, nf1 = 0u;
  uint2 mine = make_uint2(0u, 0u);
  auto flush = [&]() {
    if (run_cell < 0 || (run0 | run1 | nf0 | nf1) == 0u) return;
    unsigned* dst = counts + static_cast<int64_t>(run_cell) * C + c0;
    if (PAIR) {
      unsigned long long* d2 = reinterpret_cast<unsigned long long*>(dst);
      if (run0 | run1)
        atomicAdd(d2, run0 | (static_cast<unsigned long long>(run1) << 32));
      if (nf0 | nf1)
        atomicOr(d2, nf0 | (static_cast<unsigned long long>(nf1) << 32));
    } else {
      if (run0) atomicAdd(dst, run0);
      if (run1) atomicAdd(dst + 1, run1);
      if (nf0) atomicOr(dst, nf0);
      if (nf1) atomicOr(dst + 1, nf1);
    }
  };
#pragma unroll 1
  for (int k0 = 0; k0 < 32; k0 += kBwdBatch) {
    int cells[kBwdBatch];
    float2 v[kBwdBatch], o[kBwdBatch];
#pragma unroll
    for (int u = 0; u < kBwdBatch; ++u) cells[u] = __shfl_sync(0xffffffffu, cell, k0 + u);
#pragma unroll
    for (int u = 0; u < kBwdBatch; ++u) {  // every load of the batch first
      const bool live = cells[u] >= 0;
      v[u] = load_pair<PAIR>(feats + (p0 + k0 + u) * C + c0, live && ok0, live && ok1);
      const float* orow = out + static_cast<int64_t>(cells[u] < 0 ? 0 : cells[u]) * C + c0;
      o[u] = live && ok0 ? (PAIR ? __ldg(reinterpret_cast<const float2*>(orow))
                                 : make_float2(__ldg(orow), ok1 ? __ldg(orow + 1) : 0.f))
                         : make_float2(1.f, 1.f);
    }
#pragma unroll
    for (int u = 0; u < kBwdBatch; ++u) {
      if (cells[u] != run_cell) {
        flush();
        run_cell = cells[u];
        run0 = run1 = nf0 = nf1 = 0u;
      }
      bool win0 = false, win1 = false;
      if (cells[u] >= 0) {
        const float a = v[u].x, b = v[u].y;
        if (ok0 && (isnan(a) || (isinf(a) && a > 0.f))) nf0 = kNonFinite;
        if (ok1 && (isnan(b) || (isinf(b) && b > 0.f))) nf1 = kNonFinite;
        win0 = ok0 && a == o[u].x;
        win1 = ok1 && b == o[u].y;
        run0 += win0;
        run1 += win1;
      }
      const unsigned m0 = __ballot_sync(0xffffffffu, win0);
      const unsigned m1 = __ballot_sync(0xffffffffu, win1);
      if (lane == k0 + u) mine = make_uint2(m0, m1);
    }
  }
  flush();
  if (cell != -2) masks[(p0 + lane) * groups + group] = mine;
}

// The gradient of one group (as count_columns): grad_out[cell] / winners
// where the point won its cell's max, else 0 (losers, trash points, cells
// whose max was not finite), every element of the points' rows written.
template <bool PAIR>
__device__ __forceinline__ void grad_columns(
    const unsigned* counts, const uint2* masks, const float* __restrict__ grad_out,
    float* __restrict__ grad_feats, int cell, int64_t p0, int C, int col0,
    int groups, int group) {
  const int lane = threadIdx.x & 31;
  const int c0 = col0 + 2 * lane;
  const bool ok0 = c0 < C, ok1 = c0 + 1 < C;
  const uint2 mine = cell != -2 ? __ldcg(masks + (p0 + lane) * groups + group)
                                : make_uint2(0u, 0u);
#pragma unroll 1
  for (int k0 = 0; k0 < 32; k0 += kBwdBatch) {
    int cells[kBwdBatch];
    bool w0[kBwdBatch], w1[kBwdBatch];
    uint2 k[kBwdBatch];
    float2 g[kBwdBatch];
#pragma unroll
    for (int u = 0; u < kBwdBatch; ++u) {  // every gather of the batch first
      cells[u] = __shfl_sync(0xffffffffu, cell, k0 + u);
      w0[u] = (__shfl_sync(0xffffffffu, mine.x, k0 + u) >> lane) & 1u;
      w1[u] = (__shfl_sync(0xffffffffu, mine.y, k0 + u) >> lane) & 1u;
      k[u] = make_uint2(kNonFinite, kNonFinite);
      g[u] = make_float2(0.f, 0.f);
      if (w0[u] | w1[u]) {  // only a live point wins: its cell is >= 0
        const int64_t at = static_cast<int64_t>(cells[u]) * C + c0;
        if (PAIR) {
          k[u] = __ldcg(reinterpret_cast<const uint2*>(counts + at));
          g[u] = __ldg(reinterpret_cast<const float2*>(grad_out + at));
        } else {
          if (w0[u]) k[u].x = __ldcg(counts + at), g[u].x = __ldg(grad_out + at);
          if (w1[u]) k[u].y = __ldcg(counts + at + 1), g[u].y = __ldg(grad_out + at + 1);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kBwdBatch; ++u) {
      if (cells[u] == -2) continue;
      const float r0 = w0[u] && !(k[u].x & kNonFinite) ? g[u].x / static_cast<float>(k[u].x) : 0.f;
      const float r1 = w1[u] && !(k[u].y & kNonFinite) ? g[u].y / static_cast<float>(k[u].y) : 0.f;
      float* dst = grad_feats + (p0 + k0 + u) * C + c0;
      if (PAIR) {
        if (ok0) __stcs(reinterpret_cast<float2*>(dst), make_float2(r0, r1));
      } else {
        if (ok0) __stcs(dst, r0);
        if (ok1) __stcs(dst + 1, r1);
      }
    }
  }
}

// The max-scatter's gradient in one cooperative launch, three phases
// between grid-wide barriers: every winner count 0; count and mark (a
// warp per 32 consecutive points, groups of 64 columns); the gradient
// (the same warp, the same points). The vector-Jacobian product of
// segment_max: ties split evenly, as jax.vjp of the JAX op gives it.
template <bool PAIR>
__global__ void __launch_bounds__(kThreads, 3) scatter_max_backward_kernel(
    const float* __restrict__ feats,     // (B, P, C)
    const int* __restrict__ ids,         // (B, P)
    const float* __restrict__ out,       // (B, hw, C), the forward's result
    const float* __restrict__ grad_out,  // (B, hw, C)
    float* __restrict__ grad_feats,      // (B, P, C)
    unsigned* counts,                    // (B, hw, C) scratch
    uint2* masks,                        // (B * P, groups) scratch
    int64_t n_pts, int64_t n_cells, int P, int C, int hw) {
  cg::grid_group grid = cg::this_grid();
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int lane = threadIdx.x & 31, groups = (C + 63) / 64;
  zero_keys(counts, n_cells, tid, stride);
  grid.sync();
  for (int64_t p0 = tid - lane; p0 < n_pts; p0 += stride) {
    const int cell = flat_cell(ids, p0, n_pts, P, hw);
    for (int g = 0; g < groups; ++g)
      count_columns<PAIR>(feats, out, counts, masks, cell, p0, C, 64 * g, groups,
                          g);
  }
  grid.sync();
  for (int64_t p0 = tid - lane; p0 < n_pts; p0 += stride) {
    const int cell = flat_cell(ids, p0, n_pts, P, hw);
    for (int g = 0; g < groups; ++g)
      grad_columns<PAIR>(counts, masks, grad_out, grad_feats, cell, p0, C, 64 * g,
                         groups, g);
  }
}


}  // namespace

extern "C" {

// pillar_features. points (B, P, F) float32 with 3 <= F <= 42 (a block's
// rows of F + 5 floats are staged in shared memory, within the 48 KB a
// block gets without opting in); mask (B, P)
// float32, > 0 = valid; ids (B, P) int32 and aug (B, P, F + 5) float32 are
// written; table is scratch of (B, H*W + 1) 32-byte records, zeroed here.
// rx, ry are the float32 reciprocals of the cell sizes sx, sy; every
// in-range x, y and z has a magnitude below 2^ex, 2^ey and 2^ez. One
// cooperative launch, at most as many blocks as fit on the card at once.
// Returns the cudaError_t of the launch (0 = success).
int pillar_features(const void* points, const void* mask, void* ids,
                    void* aug, void* table, int B, int P, int F, int H,
                    int W, float x0, float y0, float z0, float z1, float rx,
                    float ry, float sx, float sy, int ex, int ey, int ez,
                    void* stream) {
  int64_t n = static_cast<int64_t>(B) * P;
  // empty work launches nothing; the caller skips it, so 0 means launched
  if (n == 0 || F < 3 || F > 42 || H <= 0 || W <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * kThreads * (F + 5);
  static int cache[3] = {-1, -1, 0};
  const int most = coresident_blocks(pillar_features_kernel, smem, cache);
  if (most == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t want = (n + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(want < most ? want : most);
  // each point's term below 2^(62 - bits of P): P of them sum below 2^62
  int bits = 0;
  while ((P >> bits) != 0) ++bits;
  const int e[3] = {ex, ey, ez};
  Geometry g{x0, y0, z0, z1, rx, ry, sx, sy, {}, {}};
  for (int k = 0; k < 3; ++k) {
    const int scale = std::min(62 - bits - e[k], 100);
    g.fix[k] = ldexpf(1.f, scale);
    g.unfix[k] = ldexpf(1.f, -scale);
  }
  const float* pts = static_cast<const float*>(points);
  const float* msk = static_cast<const float*>(mask);
  int* id = static_cast<int*>(ids);
  float* rows = static_cast<float*>(aug);
  CellSums* tab = static_cast<CellSums*>(table);
  void* args[] = {&pts, &msk, &id, &rows, &tab, &n, &P, &F, &H, &W, &g};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(pillar_features_kernel), blocks, kThreads,
      args, smem, static_cast<cudaStream_t>(stream)));
}

// Kernel C. feats (B, P, C) float32, ids (B, P) int32 in [0, hw] (hw =
// trash), B * (hw + 1) < 2^31; out (B, hw, C) float32, 16-byte aligned (a
// fresh allocation), is written. One cooperative launch of as many blocks
// as the work wants and the card holds at once. Returns the cudaError_t of
// the launch.
int pillar_scatter_max(const void* feats, const void* ids, void* out, int B,
                       int P, int C, int hw, void* stream) {
  int64_t n_pts = static_cast<int64_t>(B) * P;
  int64_t cells = static_cast<int64_t>(B) * hw * C;
  if (cells == 0 || P < 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      static_cast<int64_t>(B) * (hw + 1) > std::numeric_limits<int>::max())
    return static_cast<int>(cudaErrorInvalidValue);
  static int cache[3] = {-1, -1, 0};
  const int most = coresident_blocks(scatter_max_kernel, 0, cache);
  if (most == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t work = std::max((n_pts + kThreads - 1) / kThreads,
                                (cells / 4 + kThreads - 1) / kThreads);
  const unsigned blocks = static_cast<unsigned>(
      std::max<int64_t>(1, std::min<int64_t>(work, most)));
  const float* f = static_cast<const float*>(feats);
  const int* id = static_cast<const int*>(ids);
  unsigned* keys = static_cast<unsigned*>(out);
  void* args[] = {&f, &id, &keys, &n_pts, &cells, &P, &C, &hw};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(scatter_max_kernel), blocks, kThreads,
      args, 0, static_cast<cudaStream_t>(stream)));
}

// Gradient of pillar_scatter_max for feats. feats (B, P, C) float32, ids
// (B, P) int32, out (B, hw, C) float32 the forward's result for them,
// grad_out (B, hw, C) float32; grad_feats (B, P, C) float32 is fully
// written; scratch, 16-byte aligned: B * hw * C uint32 winner counts
// (zeroed here), rounded up to an even count, then B * P * ceil(C / 64)
// pairs of uint32 winner masks. One cooperative launch. Returns the
// cudaError_t of the launch.
int pillar_scatter_max_backward(const void* feats, const void* ids,
                                const void* out, const void* grad_out,
                                void* grad_feats, void* scratch, int B, int P,
                                int C, int hw, void* stream) {
  int64_t n_pts = static_cast<int64_t>(B) * P;
  int64_t cells = static_cast<int64_t>(B) * hw * C;
  const bool pair = C % 2 == 0;
  const uintptr_t align = pair ? 8 : 4;
  if (n_pts == 0 || C == 0 || cells == 0 ||
      n_pts >= std::numeric_limits<int>::max() ||
      static_cast<int64_t>(B) * (hw + 1) > std::numeric_limits<int>::max() ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(feats) % align != 0 ||
      reinterpret_cast<uintptr_t>(out) % align != 0 ||
      reinterpret_cast<uintptr_t>(grad_out) % align != 0 ||
      reinterpret_cast<uintptr_t>(grad_feats) % align != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = pair ? reinterpret_cast<const void*>(scatter_max_backward_kernel<true>)
                            : reinterpret_cast<const void*>(scatter_max_backward_kernel<false>);
  static int cache_pair[3] = {-1, -1, 0}, cache_odd[3] = {-1, -1, 0};
  const int most = pair ? coresident_blocks(scatter_max_backward_kernel<true>, 0, cache_pair)
                        : coresident_blocks(scatter_max_backward_kernel<false>, 0, cache_odd);
  if (most == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t work = std::max((n_pts + kThreads - 1) / kThreads,
                                (cells / 4 + kThreads - 1) / kThreads);
  const unsigned blocks = static_cast<unsigned>(
      std::max<int64_t>(1, std::min<int64_t>(work, most)));
  const float* f = static_cast<const float*>(feats);
  const int* id = static_cast<const int*>(ids);
  const float* o = static_cast<const float*>(out);
  const float* g = static_cast<const float*>(grad_out);
  float* gf = static_cast<float*>(grad_feats);
  unsigned* counts = static_cast<unsigned*>(scratch);
  uint2* masks = reinterpret_cast<uint2*>(counts + cells + cells % 2);
  void* args[] = {&f, &id, &o, &g, &gf, &counts, &masks, &n_pts, &cells, &P, &C, &hw};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      kernel, blocks, kThreads, args, 0, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
