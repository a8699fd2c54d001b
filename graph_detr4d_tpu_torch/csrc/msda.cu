// K1: multi-scale deformable attention, forward and backward. Hand-written
// for sm_90a.
//
// Replaces graph_detr4d_tpu/ops/msda.py::multi_scale_deformable_attention
// (its shift4h / pair / one-hot / corner-table XLA samplers, which exist
// because TPU gathers are row-count bound). On Hopper one kernel covers
// every level size.
//
// Computes, for each (bn, query r, head h) and channel c of the head:
//   out[bn, r, h*hd + c] = sum_{l, p} attn[bn, q, h, l, p] *
//       bilinear(value level l of bn, head h, channel c, at
//                (x * W_l - 0.5, y * H_l - 0.5)),  zero padding,
// with q = index[bn, r] when an index list is given (the cam_capacity
// compaction of models/attention.py), else q = r.
//
// What bounds it on this card: the gather. Every (query, head, level,
// point) reads up to four hd-wide rows of `value` at data-dependent
// addresses; the FLOPs (8 per corner and channel) are negligible, so the
// floor is the bytes of the value rows actually touched plus the loc /
// attn / out streams, over 3.35 TB/s. What the design does about it:
//   * values stay in the mmcv layout (BN, sum_l H_l*W_l, heads, hd), so
//     the 32 lanes of a warp (one head at hd = 32) read one contiguous
//     64-byte (bf16) row per corner;
//   * the corner indices and weights (attn folded in) of a query tile are
//     computed once into shared memory instead of once per channel;
//   * a corner whose weight is zero (outside the image, or a sample the
//     projection mask switched off) is not loaded at all: most samples of
//     a query fall outside a given camera;
//   * the index list is read in the kernel, so the compacted queries are
//     never copied into a gathered loc / attn tensor.
// Accumulation is fp32 whatever the value type.
//
// Backward (msda_backward): mmcv's col2im scheme. One warp per (bn, row,
// head); its lanes take the head's channels. For each (level, point) the
// lanes re-sample the four corners, scatter attn * w_corner * grad_out into
// grad_value with fp32 atomicAdd (the wrapper zeroes that fp32 buffer and
// casts it to value's dtype), and reduce across lanes the per-channel
// products that give grad_attn (grad_out . sample) and grad_loc
// (attn * grad_out . d sample / d(x, y), times W or H). A corner outside
// the image contributes nothing; grad_attn needs the sample even where
// attn is 0. What bounds it: the same gather as the forward, plus one
// atomic per touched value element; the scatter is the cost.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kQueryTile = 4;  // queries per block

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void msda_forward_kernel(
    const T* __restrict__ value,         // (BN, S, heads, hd)
    const float* __restrict__ loc,       // (BN, Q, heads, L, P, 2) as (x, y)
    const float* __restrict__ attn,      // (BN, Q, heads, L, P)
    const int64_t* __restrict__ index,   // (BN, R) or nullptr
    T* __restrict__ out,                 // (BN, R, heads * hd)
    int S, int Q, int R, int heads, int hd, int L, int P, Levels lv) {
  extern __shared__ unsigned char smem[];
  const int LP = L * P;
  const int HLP = heads * LP;
  int* s_row = reinterpret_cast<int*>(smem);                 // [tile][HLP][4]
  float* s_w = reinterpret_cast<float*>(s_row + kQueryTile * HLP * 4);

  const int bn = blockIdx.y;
  const int r0 = blockIdx.x * kQueryTile;
  const int nq = min(kQueryTile, R - r0);

  // Phase 1: corner rows and weights of every sample of the tile. A row
  // indexes `value` of this bn viewed as (S * heads, hd).
  for (int e = threadIdx.x; e < nq * HLP; e += blockDim.x) {
    const int t = e / HLP;
    const int hlp = e - t * HLP;
    const int h = hlp / LP;
    const int l = (hlp - h * LP) / P;
    const int64_t q =
        index ? index[static_cast<int64_t>(bn) * R + r0 + t] : (r0 + t);
    const int64_t src = (static_cast<int64_t>(bn) * Q + q) * HLP + hlp;
    const float a = attn[src];
    const int H = lv.h[l], W = lv.w[l];
    const float x = loc[2 * src] * W - 0.5f;
    const float y = loc[2 * src + 1] * H - 0.5f;
    int* rows = s_row + e * 4;
    float* ws = s_w + e * 4;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      rows[k] = h;
      ws[k] = 0.f;
    }
    // written so that NaN and far-away samples fall through to weight 0
    if (a != 0.f && x > -1.f && x < static_cast<float>(W) && y > -1.f &&
        y < static_cast<float>(H)) {
      const float x0f = floorf(x), y0f = floorf(y);
      const int x0 = static_cast<int>(x0f), y0 = static_cast<int>(y0f);
      const float fx = x - x0f, fy = y - y0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int dy = k >> 1, dx = k & 1;
        const int yy = y0 + dy, xx = x0 + dx;
        if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
          ws[k] = a * (dy ? fy : 1.f - fy) * (dx ? fx : 1.f - fx);
          rows[k] = (lv.start[l] + yy * W + xx) * heads + h;
        }
      }
    }
  }
  __syncthreads();

  // Phase 2: threads over (head, channel); a warp is one head at hd = 32.
  const int C = heads * hd;
  const T* vbase = value + static_cast<int64_t>(bn) * S * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int h = c / hd;
    const T* vch = vbase + (c - h * hd);
    for (int t = 0; t < nq; ++t) {
      const int off = ((t * heads) + h) * LP * 4;
      const int* rows = s_row + off;
      const float* ws = s_w + off;
      float acc = 0.f;
      for (int s = 0; s < LP * 4; ++s) {
        const float w = ws[s];
        if (w != 0.f) {
          acc += w * to_float(vch[static_cast<int64_t>(rows[s]) * hd]);
        }
      }
      out[(static_cast<int64_t>(bn) * R + r0 + t) * C + c] =
          from_float<T>(acc);
    }
  }
}

template <typename T>
cudaError_t launch(const void* value, const void* loc, const void* attn,
                   const void* index, void* out, int BN, int S, int Q, int R,
                   int heads, int hd, int L, int P, const Levels& lv,
                   cudaStream_t stream) {
  const int C = heads * hd;
  int threads = ((C + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const size_t smem =
      static_cast<size_t>(kQueryTile) * heads * L * P * 4 *
      (sizeof(int) + sizeof(float));
  const dim3 grid((R + kQueryTile - 1) / kQueryTile, BN);
  msda_forward_kernel<T><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(attn), static_cast<const int64_t*>(index),
      static_cast<T*>(out), S, Q, R, heads, hd, L, P, lv);
  return cudaGetLastError();
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

constexpr int kBwdWarps = 8;  // warps per block of the backward

template <typename T>
__global__ void msda_backward_kernel(
    const T* __restrict__ value,         // (BN, S, heads, hd)
    const float* __restrict__ loc,       // (BN, Q, heads, L, P, 2)
    const float* __restrict__ attn,      // (BN, Q, heads, L, P)
    const int64_t* __restrict__ index,   // (BN, R) or nullptr
    const T* __restrict__ grad_out,      // (BN, R, heads * hd)
    float* __restrict__ grad_value,      // (BN, S, heads, hd), zeroed
    float* __restrict__ grad_loc,        // (BN, Q, heads, L, P, 2), zeroed
    float* __restrict__ grad_attn,       // (BN, Q, heads, L, P), zeroed
    int BN, int S, int Q, int R, int heads, int hd, int L, int P, Levels lv) {
  const int lane = threadIdx.x & 31;
  const int64_t item =
      static_cast<int64_t>(blockIdx.x) * kBwdWarps + (threadIdx.x >> 5);
  if (item >= static_cast<int64_t>(BN) * R * heads) return;  // warp-uniform
  const int h = static_cast<int>(item % heads);
  const int64_t br = item / heads;  // bn * R + r
  const int bn = static_cast<int>(br / R);
  const int64_t q = index ? index[br] : (br - static_cast<int64_t>(bn) * R);
  const int C = heads * hd;
  const int LP = L * P;
  const T* go = grad_out + br * C + h * hd;
  const T* vbase = value + static_cast<int64_t>(bn) * S * C + h * hd;
  float* gvbase = grad_value + static_cast<int64_t>(bn) * S * C + h * hd;
  const int64_t src0 = ((static_cast<int64_t>(bn) * Q + q) * heads + h) * LP;

  for (int lp = 0; lp < LP; ++lp) {
    const int l = lp / P;
    const int64_t src = src0 + lp;
    const float a = attn[src];
    const int H = lv.h[l], W = lv.w[l];
    const float x = loc[2 * src] * W - 0.5f;
    const float y = loc[2 * src + 1] * H - 0.5f;
    // written so that NaN and far-away samples fall through to no gradient
    if (!(x > -1.f && x < static_cast<float>(W) && y > -1.f &&
          y < static_cast<float>(H)))
      continue;
    const float x0f = floorf(x), y0f = floorf(y);
    const int x0 = static_cast<int>(x0f), y0 = static_cast<int>(y0f);
    const float fx = x - x0f, fy = y - y0f;
    int64_t rows[4];  // element offset of the corner's row, -1 outside
    float w[4], dwx[4], dwy[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int dy = k >> 1, dx = k & 1;
      const int yy = y0 + dy, xx = x0 + dx;
      const bool in = yy >= 0 && yy < H && xx >= 0 && xx < W;
      const float wy = dy ? fy : 1.f - fy, wx = dx ? fx : 1.f - fx;
      w[k] = in ? wy * wx : 0.f;
      dwx[k] = in ? wy * (dx ? 1.f : -1.f) : 0.f;
      dwy[k] = in ? wx * (dy ? 1.f : -1.f) : 0.f;
      rows[k] = in ? static_cast<int64_t>(lv.start[l] + yy * W + xx) * C : -1;
    }
    float s_attn = 0.f, s_x = 0.f, s_y = 0.f;
    for (int c = lane; c < hd; c += 32) {
      const float g = to_float(go[c]);
      float sample = 0.f, dsx = 0.f, dsy = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (rows[k] < 0) continue;
        const float v = to_float(vbase[rows[k] + c]);
        sample += w[k] * v;
        dsx += dwx[k] * v;
        dsy += dwy[k] * v;
        if (a != 0.f && w[k] != 0.f) atomicAdd(gvbase + rows[k] + c, a * w[k] * g);
      }
      s_attn += g * sample;
      s_x += g * dsx;
      s_y += g * dsy;
    }
    s_attn = warp_sum(s_attn);
    s_x = warp_sum(s_x);
    s_y = warp_sum(s_y);
    if (lane == 0) {
      grad_attn[src] = s_attn;
      grad_loc[2 * src] = a * s_x * W;
      grad_loc[2 * src + 1] = a * s_y * H;
    }
  }
}

template <typename T>
cudaError_t launch_backward(const void* value, const void* loc,
                            const void* attn, const void* index,
                            const void* grad_out, void* grad_value,
                            void* grad_loc, void* grad_attn, int BN, int S,
                            int Q, int R, int heads, int hd, int L, int P,
                            const Levels& lv, cudaStream_t stream) {
  const int64_t items = static_cast<int64_t>(BN) * R * heads;
  const int64_t blocks = (items + kBwdWarps - 1) / kBwdWarps;
  msda_backward_kernel<T><<<static_cast<unsigned>(blocks), kBwdWarps * 32, 0,
                            stream>>>(
      static_cast<const T*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(attn), static_cast<const int64_t*>(index),
      static_cast<const T*>(grad_out), static_cast<float*>(grad_value),
      static_cast<float*>(grad_loc), static_cast<float*>(grad_attn), BN, S, Q,
      R, heads, hd, L, P, lv);
  return cudaGetLastError();
}

bool make_levels(const int* level_hw, int L, int S, Levels* lv) {
  if (L < 1 || L > kMaxLevels) return false;
  int start = 0;
  for (int l = 0; l < L; ++l) {
    lv->h[l] = level_hw[2 * l];
    lv->w[l] = level_hw[2 * l + 1];
    lv->start[l] = start;
    start += lv->h[l] * lv->w[l];
  }
  return start == S;
}

}  // namespace

extern "C" {

// Largest heads * L * P the kernel takes (its shared memory stays under
// the 48 KB a block gets without opting in).
int msda_max_hlp() {
  return static_cast<int>(48 * 1024 /
                          (kQueryTile * 4 * (sizeof(int) + sizeof(float))));
}

// level_hw: host array of 2 * L ints (H_0, W_0, H_1, W_1, ...).
// dtype: 0 = float32 values / output, 1 = bfloat16.
// Returns the cudaError_t of the launch (0 = success).
int msda_forward(const void* value, const void* loc, const void* attn,
                 const void* index, void* out, int BN, int S, int Q, int R,
                 int heads, int hd, int L, int P, const int* level_hw,
                 int dtype, void* stream) {
  if (heads * L * P > msda_max_hlp())
    return static_cast<int>(cudaErrorInvalidValue);
  // empty work launches nothing; the caller skips it, so 0 means launched
  if (R == 0 || BN == 0) return static_cast<int>(cudaErrorInvalidValue);
  Levels lv;
  if (!make_levels(level_hw, L, S, &lv))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(value, loc, attn, index, out, BN, S, Q, R, heads, hd,
                        L, P, lv, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(value, loc, attn, index, out, BN, S, Q, R,
                                heads, hd, L, P, lv, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Gradients of msda_forward for value, loc and attn, given grad_out
// (BN, R, heads * hd) in value's dtype. grad_value is float32 (BN, S,
// heads, hd), grad_loc and grad_attn float32 in the shapes of loc and attn;
// all three must be zeroed by the caller. With an index list, row r of bn
// writes grad_loc / grad_attn at query index[bn, r]; the indices of a row
// must be distinct. Returns the cudaError_t of the launch (0 = success).
int msda_backward(const void* value, const void* loc, const void* attn,
                  const void* index, const void* grad_out, void* grad_value,
                  void* grad_loc, void* grad_attn, int BN, int S, int Q,
                  int R, int heads, int hd, int L, int P,
                  const int* level_hw, int dtype, void* stream) {
  // empty work launches nothing; the caller skips it, so 0 means launched
  if (R == 0 || BN == 0 || heads == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Levels lv;
  if (!make_levels(level_hw, L, S, &lv))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_backward<float>(value, loc, attn, index, grad_out,
                                 grad_value, grad_loc, grad_attn, BN, S, Q, R,
                                 heads, hd, L, P, lv, s);
  } else if (dtype == 1) {
    err = launch_backward<__nv_bfloat16>(value, loc, attn, index, grad_out,
                                         grad_value, grad_loc, grad_attn, BN,
                                         S, Q, R, heads, hd, L, P, lv, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
