// K7: rotated BEV / 3D IoU of box pairs. Hand-written for sm_90a.
//
// Replaces graph_detr4d_tpu/core/iou3d.py::rotated_overlap_bev (:143) and
// bbox_overlaps_3d (:159), the reference's iou3d_calculator, which
// upstream runs as a CUDA op. For each pair (i, j) of boxes1 (M, 7+) x
// boxes2 (N, 7+), each (cx, cy, cz, w, l, h, yaw):
//   * clip box i's counter-clockwise BEV quad by the four half-planes of
//     box j (Sutherland–Hodgman: per input edge, the current vertex if
//     side >= 0, then the edge's crossing with t = s_cur / (s_cur - s_nxt),
//     the denominator replaced by 1e-12 where its magnitude is below
//     that), keeping at most 8 vertices;
//   * shoelace area of the clipped polygon, summed in vertex order;
//   * times the z-extent overlap, over max(union, 1e-8): IoU (union = the
//     two volumes minus the intersection) or IoF (union = box i's
//     volume); mode 2 returns the BEV area alone.
// The kernel computes each box's corners itself (sincosf and the formula
// and order of core/iou3d.py::box_corners_bev), and every product and
// sum is written with the round-to-nearest intrinsics, which the compiler
// does not fuse into multiply-adds: it repeats the plain version's float
// operations one for one.
//
// What bounds it on this card: operations, ~400 float operations a
// clipped pair; a call writes M x N floats. The design:
//   * one launch a call: a block takes a tile of 32 boxes1 x 32 boxes2
//     and computes the tile's corners, z-extents, volumes and bounding
//     circles into shared memory once;
//   * a conservative pre-test: a pair of finite boxes whose bounding
//     circles lie apart by more than `margin` of the pair's coordinate
//     scale (the caller passes 1e-3; the clip's rounding is ~1e-6 of
//     it), or whose z-extents do not overlap (IoU / IoF), gets the exact
//     0 the clip would give, without clipping; where the caller asks, the
//     blocks add up how many pairs they settled so. Each thread tests one box2 against 4 boxes1 and
//     writes those (a warp, 32 consecutive floats of an output row); the
//     other pairs, under 1% of a scene's, go to a queue in shared memory
//     that the block's threads then clip together, so no warp clips for
//     one lane;
//   * the polygon in registers: the clip is unrolled with compile-time
//     vertex indices, each emit a predicated select into every slot it
//     can reach, so nothing is indexed at run time.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kTile = 32;              // boxes of each side in a block's tile
constexpr int kRowsPerThread = 4;      // boxes1 a thread, 8 thread rows
constexpr int kVMax = 8;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// Area of the quad (c1x, c1y) clipped by the half-planes left of the
// edges of the quad (qx, qy).
__device__ __forceinline__ float clipped_area(const float* c1x, const float* c1y,
                                              const float* qx, const float* qy) {
  float px[kVMax], py[kVMax];
#pragma unroll
  for (int v = 0; v < kVMax; ++v) {
    px[v] = v < 4 ? c1x[v] : 0.f;
    py[v] = v < 4 ? c1y[v] : 0.f;
  }
  int n = 4;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float ax = qx[e], ay = qy[e];
    const float ex = sub(qx[(e + 1) & 3], ax), ey = sub(qy[(e + 1) & 3], ay);
    const int n_in = e == 0 ? 4 : kVMax;  // input vertices at most
    float s[kVMax];
#pragma unroll
    for (int j = 0; j < kVMax; ++j)
      s[j] = sub(mul(ex, sub(py[j], ay)), mul(ey, sub(px[j], ax)));
    float ox[kVMax], oy[kVMax];
#pragma unroll
    for (int v = 0; v < kVMax; ++v) ox[v] = oy[v] = 0.f;
    int m = 0;
#pragma unroll
    for (int j = 0; j < n_in; ++j) {
      const bool valid = j < n, last = j == n - 1;
      const float cx = px[j], cy = py[j];
      const float nx = last || j == kVMax - 1 ? px[0] : px[(j + 1) % kVMax];
      const float ny = last || j == kVMax - 1 ? py[0] : py[(j + 1) % kVMax];
      const float s_cur = s[j];
      const float s_nxt = last || j == kVMax - 1 ? s[0] : s[(j + 1) % kVMax];
      const bool in_cur = s_cur >= 0.f, in_nxt = s_nxt >= 0.f;
      // at most 2 emits per earlier vertex: slot m <= 2j here
      const int slot1 = valid && in_cur && m < kVMax ? m : kVMax;
#pragma unroll
      for (int v = 0; v < kVMax && v <= 2 * j; ++v) {
        ox[v] = slot1 == v ? cx : ox[v];
        oy[v] = slot1 == v ? cy : oy[v];
      }
      m += slot1 < kVMax;
      const int slot2 = valid && in_cur != in_nxt && m < kVMax ? m : kVMax;
      const float denom = sub(s_cur, s_nxt);
      const float t = __fdiv_rn(s_cur, fabsf(denom) < 1e-12f ? 1e-12f : denom);
      const float ix = add(cx, mul(t, sub(nx, cx)));
      const float iy = add(cy, mul(t, sub(ny, cy)));
#pragma unroll
      for (int v = 0; v < kVMax && v <= 2 * j + 1; ++v) {
        ox[v] = slot2 == v ? ix : ox[v];
        oy[v] = slot2 == v ? iy : oy[v];
      }
      m += slot2 < kVMax;
    }
    n = m;
#pragma unroll
    for (int v = 0; v < kVMax; ++v) {
      px[v] = ox[v];
      py[v] = oy[v];
    }
  }
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < kVMax; ++j) {
    const bool last = j == n - 1;
    const float nx = last || j == kVMax - 1 ? px[0] : px[(j + 1) % kVMax];
    const float ny = last || j == kVMax - 1 ? py[0] : py[(j + 1) % kVMax];
    const float term = sub(mul(px[j], ny), mul(nx, py[j]));
    acc = j == 0 ? term : (j < n ? add(acc, term) : acc);
  }
  return n == 0 ? 0.f : mul(0.5f, fabsf(acc));
}

__global__ void __launch_bounds__(kTile * kTile / kRowsPerThread)
box_overlaps_kernel(const float* __restrict__ b1, int ld1,  // (M, ld1)
                    const float* __restrict__ b2, int ld2,  // (N, ld2)
                    float* __restrict__ out,                // (M, N)
                    int M, int N, int mode, float margin,
                    unsigned long long* __restrict__ skipped) {
  // the tile's boxes, [0] boxes1 and [1] boxes2: corners, z-extent,
  // volume, centre, bounding-circle radius, all seven values finite
  __shared__ float s_x[2][kTile][4], s_y[2][kTile][4];
  __shared__ float s_zlo[2][kTile], s_zhi[2][kTile], s_vol[2][kTile];
  __shared__ float s_cx[2][kTile], s_cy[2][kTile], s_rad[2][kTile];
  __shared__ bool s_ok[2][kTile];
  __shared__ int s_queue[kTile * kTile];  // pairs to clip, i * kTile + j
  __shared__ int s_count;

  // the z-extent overlap and the ratio of the tile's pair (i, j)
  auto z_overlap = [&](int i, int j) {
    return fmaxf(sub(fminf(s_zhi[0][i], s_zhi[1][j]), fmaxf(s_zlo[0][i], s_zlo[1][j])),
                 0.f);
  };
  auto pair_result = [&](float area, float zo, int i, int j) {
    if (mode == 2) return area;
    const float inter = mul(area, zo);
    const float v1 = s_vol[0][i];
    const float union_ = mode == 0 ? sub(add(v1, s_vol[1][j]), inter) : v1;
    return __fdiv_rn(inter, fmaxf(union_, 1e-8f));
  };

  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  const int t = threadIdx.y * kTile + threadIdx.x;
  if (t == 0) s_count = 0;
  if (t < 2 * kTile) {
    const int side = t / kTile, k = t % kTile;
    const int g = (side == 0 ? i0 : j0) + k;
    if (g < (side == 0 ? M : N)) {
      const float* b = side == 0 ? b1 + static_cast<int64_t>(g) * ld1
                                 : b2 + static_cast<int64_t>(g) * ld2;
      const float cx = b[0], cy = b[1], cz = b[2], w = b[3], l = b[4],
                  h = b[5], yaw = b[6];
      float sn, cs;
      sincosf(yaw, &sn, &cs);
      // box_corners_bev: dx = (w, -w, -w, w) / 2, dy = (l, l, -l, -l) / 2,
      // x = cx + dx c - dy s, y = cy + dx s + dy c
      const float hw = mul(w, 0.5f), hl = mul(l, 0.5f);
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const float dx = v == 0 || v == 3 ? hw : -hw;
        const float dy = v < 2 ? hl : -hl;
        s_x[side][k][v] = sub(add(cx, mul(dx, cs)), mul(dy, sn));
        s_y[side][k][v] = add(add(cy, mul(dx, sn)), mul(dy, cs));
      }
      const float hh = mul(h, 0.5f);
      s_zlo[side][k] = sub(cz, hh);
      s_zhi[side][k] = add(cz, hh);
      s_vol[side][k] = mul(mul(w, l), h);
      s_cx[side][k] = cx;
      s_cy[side][k] = cy;
      s_rad[side][k] = mul(0.5f, __fsqrt_rn(add(mul(w, w), mul(l, l))));
      s_ok[side][k] = isfinite(cx) && isfinite(cy) && isfinite(cz) &&
                      isfinite(w) && isfinite(l) && isfinite(h) && isfinite(yaw);
    }
  }
  __syncthreads();

  // pass 1: each thread tests its box2 against 4 boxes1; a pair the
  // pre-test settles is written here (a warp writes 32 consecutive
  // floats), the rest go to the block's queue
  const int j = threadIdx.x, jg = j0 + j;
  if (jg < N) {
    const float x2 = s_cx[1][j], y2 = s_cy[1][j], r2 = s_rad[1][j];
    const float e2 = fmaxf(fabsf(x2), fabsf(y2));
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const int i = threadIdx.y + r * (kTile / kRowsPerThread), ig = i0 + i;
      if (ig >= M) break;
      // the pre-test (chip_smoke.py::pretest_skips repeats it)
      const float x1 = s_cx[0][i], y1 = s_cy[0][i], r1 = s_rad[0][i];
      const float dx = sub(x1, x2), dy = sub(y1, y2);
      const float scale =
          add(add(fmaxf(fmaxf(fabsf(x1), fabsf(y1)), e2), r1), r2);
      const float reach = add(add(r1, r2), mul(margin, scale));
      const bool apart = add(mul(dx, dx), mul(dy, dy)) > mul(reach, reach);
      const float zo = z_overlap(i, j);
      if (s_ok[0][i] && s_ok[1][j] && (apart || (mode != 2 && zo == 0.f)))
        out[static_cast<int64_t>(ig) * N + jg] = pair_result(0.f, zo, i, j);
      else
        s_queue[atomicAdd(&s_count, 1)] = i * kTile + j;
    }
  }
  __syncthreads();
  // pass 2: the queued pairs, clipped by all threads together
  const int count = s_count;
  if (skipped != nullptr && t == 0)
    atomicAdd(skipped, static_cast<unsigned long long>(
                           min(kTile, M - i0) * min(kTile, N - j0) - count));
  for (int q = t; q < count; q += kTile * kTile / kRowsPerThread) {
    const int i = s_queue[q] / kTile, jq = s_queue[q] % kTile;
    const float area = clipped_area(s_x[0][i], s_y[0][i], s_x[1][jq], s_y[1][jq]);
    out[static_cast<int64_t>(i0 + i) * N + j0 + jq] =
        pair_result(area, z_overlap(i, jq), i, jq);
  }
}

}  // namespace

extern "C" {

// boxes1 (M, >= 7) with row stride ld1, boxes2 (N, >= 7) with row stride
// ld2, out (M, N), all float32. mode: 0 = IoU, 1 = IoF, 2 = BEV
// intersection area. margin: the pre-test's, a share of a pair's
// coordinate scale. skipped: null, or one uint64 on the device to which
// the launch adds the pairs its pre-test answered without clipping.
// Returns the cudaError_t of the launch (0 = success).
int box_overlaps_3d(const void* boxes1, int ld1, const void* boxes2, int ld2,
                    void* out, int M, int N, int mode, float margin,
                    void* skipped, void* stream) {
  // empty work launches nothing; the caller skips it, so 0 means launched
  const int64_t tiles_m = (static_cast<int64_t>(M) + kTile - 1) / kTile;
  if (M <= 0 || N <= 0 || mode < 0 || mode > 2 || tiles_m > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kTile - 1) / kTile, static_cast<unsigned>(tiles_m));
  const dim3 block(kTile, kTile / kRowsPerThread);
  box_overlaps_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes1), ld1, static_cast<const float*>(boxes2),
      ld2, static_cast<float*>(out), M, N, mode, margin,
      static_cast<unsigned long long*>(skipped));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
