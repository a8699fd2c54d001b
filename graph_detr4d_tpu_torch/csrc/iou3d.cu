// K7: rotated BEV / 3D IoU of box pairs. Hand-written for sm_90a.
//
// Replaces graph_detr4d_tpu/core/iou3d.py::rotated_overlap_bev (:143) and
// bbox_overlaps_3d (:159), the reference's iou3d_calculator, which
// upstream runs as a CUDA op. One thread per pair (i, j) of boxes1 (M, 7)
// x boxes2 (N, 7), each (cx, cy, cz, w, l, h, yaw):
//   * clip box i's counter-clockwise BEV quad by the four half-planes of
//     box j (Sutherland–Hodgman: per input edge, the current vertex if
//     side >= 0, then the edge's crossing with t = s_cur / (s_cur - s_nxt),
//     the denominator replaced by 1e-12 where its magnitude is below
//     that), keeping at most 8 vertices, in registers;
//   * shoelace area of the clipped polygon, summed in vertex order;
//   * times the z-extent overlap, over max(union, 1e-8): IoU (union = the
//     two volumes minus the intersection) or IoF (union = box i's
//     volume); mode 2 returns the BEV area alone.
// The corners come from the caller (the plain version's float32 corners),
// and every product and sum is written with the round-to-nearest
// intrinsics, which the compiler does not fuse into multiply-adds: the
// kernel repeats the plain version's arithmetic operation for operation.
//
// What bounds it on this card: operations. Each pair does ~4 x 8 edge
// tests and crossings plus an 8-term shoelace (~400 float operations)
// from 2 x 64 bytes of corners that stay in L1/L2, and writes 4 bytes.
// The design keeps the polygon in registers (no shared memory, no
// divergence beyond the vertex counts) and lets consecutive threads take
// consecutive boxes2 so the output row is written coalesced.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kVMax = 8;
constexpr int kThreads = 256;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__device__ float clipped_area(const float* __restrict__ c1,
                              const float* __restrict__ c2) {
  float px[kVMax], py[kVMax];
  int n = 4;
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    px[v] = c1[2 * v];
    py[v] = c1[2 * v + 1];
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float ax = c2[2 * e], ay = c2[2 * e + 1];
    const float bx = c2[2 * ((e + 1) & 3)], by = c2[2 * ((e + 1) & 3) + 1];
    const float ex = sub(bx, ax), ey = sub(by, ay);
    float ox[kVMax], oy[kVMax];
    int m = 0;
#pragma unroll
    for (int j = 0; j < kVMax; ++j) {
      if (j >= n) break;
      const float cx = px[j], cy = py[j];
      const float nx = j == n - 1 ? px[0] : px[j + 1];
      const float ny = j == n - 1 ? py[0] : py[j + 1];
      const float s_cur = sub(mul(ex, sub(cy, ay)), mul(ey, sub(cx, ax)));
      const float s_nxt = sub(mul(ex, sub(ny, ay)), mul(ey, sub(nx, ax)));
      const bool in_cur = s_cur >= 0.f, in_nxt = s_nxt >= 0.f;
      if (in_cur && m < kVMax) {
        ox[m] = cx;
        oy[m] = cy;
        ++m;
      }
      if (in_cur != in_nxt && m < kVMax) {
        const float denom = sub(s_cur, s_nxt);
        const float t = __fdiv_rn(s_cur, fabsf(denom) < 1e-12f ? 1e-12f : denom);
        ox[m] = add(cx, mul(t, sub(nx, cx)));
        oy[m] = add(cy, mul(t, sub(ny, cy)));
        ++m;
      }
    }
    n = m;
#pragma unroll
    for (int v = 0; v < kVMax; ++v) {
      px[v] = ox[v];
      py[v] = oy[v];
    }
  }
  if (n == 0) return 0.f;
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < kVMax; ++j) {
    if (j >= n) break;
    const float nx = j == n - 1 ? px[0] : px[j + 1];
    const float ny = j == n - 1 ? py[0] : py[j + 1];
    const float term = sub(mul(px[j], ny), mul(nx, py[j]));
    acc = j == 0 ? term : add(acc, term);
  }
  return mul(0.5f, fabsf(acc));
}

__global__ void box_overlaps_kernel(const float* __restrict__ b1,  // (M, 7)
                                    const float* __restrict__ b2,  // (N, 7)
                                    const float* __restrict__ c1,  // (M, 4, 2)
                                    const float* __restrict__ c2,  // (N, 4, 2)
                                    float* __restrict__ out,       // (M, N)
                                    int M, int N, int mode) {
  const int64_t total = static_cast<int64_t>(M) * N;
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       k < total; k += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int i = static_cast<int>(k / N);
    const int j = static_cast<int>(k - static_cast<int64_t>(i) * N);
    const float area = clipped_area(c1 + 8 * i, c2 + 8 * j);
    if (mode == 2) {
      out[k] = area;
      continue;
    }
    const float* p = b1 + 7 * i;
    const float* q = b2 + 7 * j;
    const float h1 = mul(p[5], 0.5f), h2 = mul(q[5], 0.5f);
    const float zo = fmaxf(sub(fminf(add(p[2], h1), add(q[2], h2)),
                               fmaxf(sub(p[2], h1), sub(q[2], h2))),
                           0.f);
    const float inter = mul(area, zo);
    const float v1 = mul(mul(p[3], p[4]), p[5]);
    const float union_ =
        mode == 0 ? sub(add(v1, mul(mul(q[3], q[4]), q[5])), inter) : v1;
    out[k] = __fdiv_rn(inter, fmaxf(union_, 1e-8f));
  }
}

}  // namespace

extern "C" {

// boxes1 (M, 7), boxes2 (N, 7), corners1 (M, 4, 2), corners2 (N, 4, 2),
// out (M, N), all float32. mode: 0 = IoU, 1 = IoF, 2 = BEV intersection
// area. Returns the cudaError_t of the launch (0 = success).
int box_overlaps_3d(const void* boxes1, const void* boxes2,
                    const void* corners1, const void* corners2, void* out,
                    int M, int N, int mode, void* stream) {
  const int64_t total = static_cast<int64_t>(M) * N;
  // empty work launches nothing; the caller skips it, so 0 means launched
  if (total == 0 || mode < 0 || mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > (int64_t{1} << 20)) blocks = int64_t{1} << 20;
  box_overlaps_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes1), static_cast<const float*>(boxes2),
      static_cast<const float*>(corners1), static_cast<const float*>(corners2),
      static_cast<float*>(out), M, N, mode);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
