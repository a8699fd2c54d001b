// K6: pillar voxelization of a point cloud, forward. Hand-written for sm_90a.
//
// Replaces graph_detr4d_tpu/ops/voxelize.py: `pillar_indices` (:26),
// `pillar_center_offsets` (:77) and `pillar_scatter` (:52), the dense
// PointPillars pillar scatter that stands in for mmdet3d's hard voxelizer.
// Points are (B, P, F) float32 with xyz first; the BEV grid is (H, W) cells
// with x along the first axis; a point that is masked out or outside the
// range in x, y or z goes to a trash cell H*W of its own sample.
//
// pillar_features (kernels A and B):
//   A. one thread per point: the cell id, floor((x - x0) * (1 / sx)) with
//      the float32 reciprocal of the cell size (the JAX op divides by a
//      compile-time constant, which XLA turns into that multiplication, so
//      ids agree bit for bit at cell borders), the bound checks
//      (z0 <= z < z1, and the mask), the augmented row
//      [point..., x - cx, y - cy] with the pillar centre taken from the id,
//      and the per-cell xyz sums (float64 atomics) and point counts. The
//      trash cell's sums, which every masked point would hit, are first
//      reduced across the warp: one atomic per warp instead of one per
//      point on a single address;
//   B. one thread per point: the cluster offsets xyz - sum / max(count, 1)
//      (the sum rounded to float32 first, as the JAX op sums in float32),
//      written into the last three columns of the augmented row.
// pillar_scatter_max (kernel C): the grid filled with -inf, then one thread
// per (point, channel) folds its feature into its cell with a float
// atomic max (atomicMax on the int bits for a non-negative value,
// atomicMin on the unsigned bits for a negative one, so any float orders
// correctly), then every cell that is still not finite is set to 0, as the
// JAX op's `where(isfinite(out), out, 0)`.
//
// What bounds it on this card: bytes, and atomics where many points share
// a pillar. Each point is read once per kernel (20 B for F = 5), its row
// (40 B) written once; the scatter reads (P, C) features once and touches
// the (H*W, C) grid. Consecutive threads take consecutive channels of one
// point, so feature reads and the atomics into a cell's row coalesce, and
// a thread whose value cannot raise the cell's current maximum skips its
// atomic.

#include <cuda_runtime.h>
#include <cstdint>
#include <limits>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void pillar_ids_kernel(
    const float* __restrict__ points,  // (B, P, F)
    const uint8_t* __restrict__ mask,  // (B, P), 1 = valid
    int* __restrict__ ids,             // (B, P)
    float* __restrict__ aug,           // (B, P, F + 5)
    double* __restrict__ sums,         // (B, H*W + 1, 3), zeroed
    int* __restrict__ counts,          // (B, H*W + 1), zeroed
    int64_t n, int P, int F, int H, int W, float x0, float y0, float z0,
    float z1, float rx, float ry, float sx, float sy) {
  const int hw = H * W;
  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  // every lane of a warp runs the same number of iterations (stride and
  // the first index of a warp are multiples of 32), so the warp reduction
  // below sees all 32 lanes
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * blockDim.x;
       base < n; base += stride) {
    const int64_t i = base + threadIdx.x;
    const bool live = i < n;
    bool trash = false;
    double tx = 0.0, ty = 0.0, tz = 0.0;
    int64_t b = 0;
    if (live) {
      b = i / P;
      const float* p = points + i * F;
      const float x = p[0], y = p[1], z = p[2];
      const float fx = floorf((x - x0) * rx);
      const float fy = floorf((y - y0) * ry);
      // written with float comparisons so NaN and far-away points fail
      const bool inb = fx >= 0.f && fx < static_cast<float>(H) && fy >= 0.f &&
                       fy < static_cast<float>(W) && z >= z0 && z < z1 &&
                       mask[i] != 0;
      const int cell = inb ? static_cast<int>(fx) * W + static_cast<int>(fy)
                           : hw;
      ids[i] = cell;
      const float cx = x0 + (static_cast<float>(cell / W) + 0.5f) * sx;
      const float cy = y0 + (static_cast<float>(cell % W) + 0.5f) * sy;
      float* row = aug + i * (F + 5);
      for (int f = 0; f < F; ++f) row[f] = p[f];
      row[F] = x - cx;
      row[F + 1] = y - cy;
      if (inb) {
        double* s = sums + (b * (hw + 1) + cell) * 3;
        atomicAdd(s, static_cast<double>(x));
        atomicAdd(s + 1, static_cast<double>(y));
        atomicAdd(s + 2, static_cast<double>(z));
        atomicAdd(counts + b * (hw + 1) + cell, 1);
      } else {
        trash = true;
        tx = x;
        ty = y;
        tz = z;
      }
    }
    // the trash cell: one atomic per warp and sample present in the warp
    const int64_t b_first = __shfl_sync(0xffffffffu, b, 0);
    const bool one_sample = __all_sync(0xffffffffu, !live || b == b_first);
    if (one_sample) {
      const double sx_ = warp_sum(tx), sy_ = warp_sum(ty), sz_ = warp_sum(tz);
      const unsigned ballot = __ballot_sync(0xffffffffu, trash);
      if (lane == 0 && ballot != 0) {
        double* s = sums + (b_first * (hw + 1) + hw) * 3;
        atomicAdd(s, sx_);
        atomicAdd(s + 1, sy_);
        atomicAdd(s + 2, sz_);
        atomicAdd(counts + b_first * (hw + 1) + hw, __popc(ballot));
      }
    } else if (trash) {  // a warp across two samples: per point
      double* s = sums + (b * (hw + 1) + hw) * 3;
      atomicAdd(s, tx);
      atomicAdd(s + 1, ty);
      atomicAdd(s + 2, tz);
      atomicAdd(counts + b * (hw + 1) + hw, 1);
    }
  }
}

__global__ void pillar_cluster_kernel(const float* __restrict__ points,
                                      const int* __restrict__ ids,
                                      const double* __restrict__ sums,
                                      const int* __restrict__ counts,
                                      float* __restrict__ aug, int64_t n,
                                      int P, int F, int hw) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t seg = (i / P) * (hw + 1) + ids[i];
    const float c = fmaxf(static_cast<float>(counts[seg]), 1.f);
    const float* p = points + i * F;
    float* row = aug + i * (F + 5) + F + 2;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      row[k] = p[k] - static_cast<float>(sums[seg * 3 + k]) / c;
    }
  }
}

__global__ void fill_kernel(float* __restrict__ out, int64_t n, float v) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    out[i] = v;
  }
}

__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  if (!signbit(v)) {
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMin(reinterpret_cast<unsigned*>(addr), __float_as_uint(v));
  }
}

__global__ void scatter_max_kernel(const float* __restrict__ feats,  // (B, P, C)
                                   const int* __restrict__ ids,      // (B, P)
                                   float* __restrict__ out,  // (B, H*W, C)
                                   int64_t n, int P, int C, int hw) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t pt = i / C;
    const int c = static_cast<int>(i - pt * C);
    const int cell = ids[pt];
    if (cell >= hw) continue;  // the trash cell is not part of the grid
    float* dst = out + ((pt / P) * hw + cell) * C + c;
    const float v = feats[i];
    if (!(v <= *dst)) atomic_max_float(dst, v);  // skip what cannot raise it
  }
}

__global__ void zero_nonfinite_kernel(float* __restrict__ out, int64_t n) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    if (!isfinite(out[i])) out[i] = 0.f;
  }
}

unsigned blocks_for(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(b < (int64_t{1} << 20) ? b : (int64_t{1} << 20));
}

}  // namespace

extern "C" {

// Kernels A and B. points (B, P, F) float32, F >= 3; mask (B, P) uint8;
// ids (B, P) int32 and aug (B, P, F + 5) float32 are written; sums
// (B, H*W + 1, 3) float64 and counts (B, H*W + 1) int32 are scratch, zeroed
// here. rx, ry are the float32 reciprocals of the cell sizes sx, sy.
// Returns the cudaError_t of the launches (0 = success).
int pillar_features(const void* points, const void* mask, void* ids,
                    void* aug, void* sums, void* counts, int B, int P, int F,
                    int H, int W, float x0, float y0, float z0, float z1,
                    float rx, float ry, float sx, float sy, void* stream) {
  const int64_t n = static_cast<int64_t>(B) * P;
  // empty work launches nothing; the caller skips it, so 0 means launched
  if (n == 0 || F < 3 || H <= 0 || W <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t segs = static_cast<int64_t>(B) * (H * W + 1);
  cudaError_t err = cudaMemsetAsync(sums, 0, sizeof(double) * 3 * segs, s);
  if (err == cudaSuccess) err = cudaMemsetAsync(counts, 0, sizeof(int) * segs, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  pillar_ids_kernel<<<blocks_for(n), kThreads, 0, s>>>(
      static_cast<const float*>(points), static_cast<const uint8_t*>(mask),
      static_cast<int*>(ids), static_cast<float*>(aug),
      static_cast<double*>(sums), static_cast<int*>(counts), n, P, F, H, W,
      x0, y0, z0, z1, rx, ry, sx, sy);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pillar_cluster_kernel<<<blocks_for(n), kThreads, 0, s>>>(
      static_cast<const float*>(points), static_cast<const int*>(ids),
      static_cast<const double*>(sums), static_cast<const int*>(counts),
      static_cast<float*>(aug), n, P, F, H * W);
  return static_cast<int>(cudaGetLastError());
}

// Kernel C. feats (B, P, C) float32, ids (B, P) int32 in [0, hw] (hw =
// trash); out (B, hw, C) float32 is written. Returns the cudaError_t.
int pillar_scatter_max(const void* feats, const void* ids, void* out, int B,
                       int P, int C, int hw, void* stream) {
  const int64_t n = static_cast<int64_t>(B) * P * C;
  const int64_t cells = static_cast<int64_t>(B) * hw * C;
  if (cells == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fill_kernel<<<blocks_for(cells), kThreads, 0, s>>>(
      static_cast<float*>(out), cells,
      -std::numeric_limits<float>::infinity());
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    scatter_max_kernel<<<blocks_for(n), kThreads, 0, s>>>(
        static_cast<const float*>(feats), static_cast<const int*>(ids),
        static_cast<float*>(out), n, P, C, hw);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  zero_nonfinite_kernel<<<blocks_for(cells), kThreads, 0, s>>>(
      static_cast<float*>(out), cells);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
