// K2: modulated deformable im2col (DCNv2 sampling), forward and backward.
// Hand-written for sm_90a.
//
// Replaces the tap sampling of graph_detr4d_tpu/ops/deform_conv.py::
// deform_conv2d (`_sample_taps_onehot` for small grids, the shift4
// `_deform_conv_gather` for large ones). The (9*Cin, Cout) contraction that
// follows stays a plain matrix product (torch.matmul), as the JAX package
// leaves its einsum to XLA.
//
// Computes, for NHWC x (B, H, W, Cin), per output pixel p = (b, ho, wo) and
// 3x3 tap k = (ky, kx):
//   py = ho*stride - pad + ky + offset[p, k, 0]   (dy)
//   px = wo*stride - pad + kx + offset[p, k, 1]   (dx)
//   cols[p, k*Cin + c] = mask[p, k] * bilinear(x[b, :, :, c], py, px)
// with zero padding outside the image: the column tile (B*Ho*Wo, 9*Cin),
// tap-major, in the working dtype.
//
// What bounds it on this card: bytes. Each output element takes 4 loads
// and ~10 FLOPs, far below the card's ~20 FLOP/byte fp32 balance, and the
// column tile it writes is 9x the size of the output feature map (about
// 221 MB for a stage-3 conv at 12 cameras in bf16), written here and read
// back by the matmul. What the design does about it:
//   * NHWC input: the threads of a warp take consecutive channels of one
//     sample, so every corner load and every column store is one
//     contiguous, coalesced segment;
//   * the corner indices and weights (mask folded in) of a block's pixels
//     are computed once into shared memory instead of once per channel;
//   * corners outside the image are not loaded.
// Folding the column tile into a tensor-core GEMM (implicit GEMM, the tile
// built in shared memory and never written out) is the next step; it
// removes the 2 x 221 MB round trip.
//
// Backward (deform_col2im): given grad_cols (B*Ho*Wo, 9*Cin), one warp per
// (output pixel, tap) re-samples the four corners across its lanes'
// channels and gives
//   grad_x[b, y, x, c]  += mask * w_corner * grad_col   (fp32 atomicAdd
//                          into a zeroed NHWC buffer the wrapper casts),
//   grad_offset[p, k]   =  mask * sum_c grad_col * d sample / d(dy, dx),
//   grad_mask[p, k]     =  sum_c grad_col * sample,
// the two sums reduced across the warp. The weight gradient is the plain
// matrix product cols^T . grad_out, outside this file: autograd keeps the
// forward's column tile for it (saved, not recomputed). What bounds it: the
// read of grad_cols (as large as the tile) and the atomics into grad_x.
//
// K3, the int8 variant (deform_im2col_int8): replaces
// graph_detr4d_tpu/ops/deform_conv.py::_deform_conv_int8 (the 'int8' table
// of `_deform_conv_gather`). Three kernels on one stream:
//   1. per-(image, channel) amax of |x| over (H, W): a thread per channel
//      walks a chunk of pixels (coalesced across channels) and folds its
//      max into a zeroed uint32 buffer with atomicMax on the float's bits
//      (non-negative floats order like their bit patterns);
//   2. the int8 NHWC table q = rint(x * (127 / s)), s = amax + 1e-12, in
//      fp32 with round-half-to-even, and the (B, C) dequantization scales
//      s / 127 rounded to the working dtype, as the JAX op orders it;
//   3. the im2col of K2 reading int8 corner rows and dequantizing per
//      channel after the gather (each corner value is q * scale rounded to
//      the working dtype, as the JAX op's `g.astype(dtype) * dequant`).
// What bounds it: bytes. The gather reads 1 byte per corner element
// instead of 2 (bf16), which is the variant's point; the column tile it
// writes is the same as K2's, and the quantize pass adds a read of x and
// a write of the table.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <algorithm>
#include <cstdint>

namespace {

constexpr int kTaps = 9;
constexpr int kPixTile = 4;  // output pixels per block

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
__global__ void deform_im2col_kernel(
    const T* __restrict__ x,       // (B, H, W, C)
    const T* __restrict__ offset,  // (B, Ho, Wo, 9, 2) as (dy, dx)
    const T* __restrict__ mask,    // (B, Ho, Wo, 9)
    T* __restrict__ cols,          // (B*Ho*Wo, 9*C)
    int H, int W, int C, int Ho, int Wo, int stride, int pad,
    int64_t npix) {
  __shared__ int s_pix[kPixTile * kTaps * 4];  // pixel index b*H*W + y*W + x
  __shared__ float s_w[kPixTile * kTaps * 4];

  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kPixTile;
  const int np = static_cast<int>(min(static_cast<int64_t>(kPixTile), npix - p0));

  for (int e = threadIdx.x; e < np * kTaps; e += blockDim.x) {
    const int t = e / kTaps;
    const int k = e - t * kTaps;
    const int64_t p = p0 + t;
    const int b = static_cast<int>(p / (static_cast<int64_t>(Ho) * Wo));
    const int rem = static_cast<int>(p - static_cast<int64_t>(b) * Ho * Wo);
    const int ho = rem / Wo, wo = rem - (rem / Wo) * Wo;
    const float m = to_float(mask[p * kTaps + k]);
    const float y = static_cast<float>(ho * stride - pad + k / 3) +
                    to_float(offset[(p * kTaps + k) * 2]);
    const float xf = static_cast<float>(wo * stride - pad + k % 3) +
                     to_float(offset[(p * kTaps + k) * 2 + 1]);
    int* pix = s_pix + e * 4;
    float* ws = s_w + e * 4;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      pix[c] = 0;
      ws[c] = 0.f;
    }
    // written so that NaN and far-away samples fall through to weight 0
    if (m != 0.f && y > -1.f && y < static_cast<float>(H) && xf > -1.f &&
        xf < static_cast<float>(W)) {
      const float y0f = floorf(y), x0f = floorf(xf);
      const int y0 = static_cast<int>(y0f), x0 = static_cast<int>(x0f);
      const float fy = y - y0f, fx = xf - x0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int dy = c >> 1, dx = c & 1;
        const int yy = y0 + dy, xx = x0 + dx;
        if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
          ws[c] = m * (dy ? fy : 1.f - fy) * (dx ? fx : 1.f - fx);
          pix[c] = (b * H + yy) * W + xx;
        }
      }
    }
  }
  __syncthreads();

  const int row = kTaps * C;
  for (int e = threadIdx.x; e < np * row; e += blockDim.x) {
    const int t = e / row;
    const int j = e - t * row;
    const int k = j / C;
    const int c = j - k * C;
    const int* pix = s_pix + (t * kTaps + k) * 4;
    const float* ws = s_w + (t * kTaps + k) * 4;
    float acc = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (ws[q] != 0.f) {
        acc += ws[q] * to_float(x[static_cast<int64_t>(pix[q]) * C + c]);
      }
    }
    cols[(p0 + t) * row + j] = from_float<T>(acc);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* offset, const void* mask,
                   void* cols, int B, int H, int W, int C, int Ho, int Wo,
                   int stride, int pad, cudaStream_t stream) {
  const int64_t npix = static_cast<int64_t>(B) * Ho * Wo;
  const int64_t blocks = (npix + kPixTile - 1) / kPixTile;
  deform_im2col_kernel<T><<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(offset),
      static_cast<const T*>(mask), static_cast<T*>(cols), H, W, C, Ho, Wo,
      stride, pad, npix);
  return cudaGetLastError();
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

constexpr int kBwdWarps = 8;  // warps per block of the backward

template <typename T>
__global__ void deform_col2im_kernel(
    const T* __restrict__ x,          // (B, H, W, C)
    const T* __restrict__ offset,     // (B, Ho, Wo, 9, 2) as (dy, dx)
    const T* __restrict__ mask,       // (B, Ho, Wo, 9)
    const T* __restrict__ grad_cols,  // (B*Ho*Wo, 9*C)
    float* __restrict__ grad_x,       // (B, H, W, C), zeroed
    float* __restrict__ grad_offset,  // (B, Ho, Wo, 9, 2)
    float* __restrict__ grad_mask,    // (B, Ho, Wo, 9)
    int H, int W, int C, int Ho, int Wo, int stride, int pad, int64_t items) {
  const int lane = threadIdx.x & 31;
  const int64_t e =
      static_cast<int64_t>(blockIdx.x) * kBwdWarps + (threadIdx.x >> 5);
  if (e >= items) return;  // warp-uniform: one (pixel, tap) per warp
  const int64_t p = e / kTaps;
  const int k = static_cast<int>(e - p * kTaps);
  const int b = static_cast<int>(p / (static_cast<int64_t>(Ho) * Wo));
  const int rem = static_cast<int>(p - static_cast<int64_t>(b) * Ho * Wo);
  const int ho = rem / Wo, wo = rem - (rem / Wo) * Wo;
  const float m = to_float(mask[e]);
  const float y = static_cast<float>(ho * stride - pad + k / 3) +
                  to_float(offset[2 * e]);
  const float xf = static_cast<float>(wo * stride - pad + k % 3) +
                   to_float(offset[2 * e + 1]);
  float s_mask = 0.f, s_y = 0.f, s_x = 0.f;
  // written so that NaN and far-away samples fall through to no gradient
  if (y > -1.f && y < static_cast<float>(H) && xf > -1.f &&
      xf < static_cast<float>(W)) {
    const float y0f = floorf(y), x0f = floorf(xf);
    const int y0 = static_cast<int>(y0f), x0 = static_cast<int>(x0f);
    const float fy = y - y0f, fx = xf - x0f;
    int64_t pix[4];  // element offset of the corner in x, -1 outside
    float w[4], dwy[4], dwx[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int dy = c >> 1, dx = c & 1;
      const int yy = y0 + dy, xx = x0 + dx;
      const bool in = yy >= 0 && yy < H && xx >= 0 && xx < W;
      const float wy = dy ? fy : 1.f - fy, wx = dx ? fx : 1.f - fx;
      w[c] = wy * wx;
      dwy[c] = wx * (dy ? 1.f : -1.f);
      dwx[c] = wy * (dx ? 1.f : -1.f);
      pix[c] = in ? (static_cast<int64_t>(b) * H * W +
                     static_cast<int64_t>(yy) * W + xx) * C
                  : -1;
    }
    const T* gc = grad_cols + p * kTaps * C + static_cast<int64_t>(k) * C;
    for (int ch = lane; ch < C; ch += 32) {
      const float g = to_float(gc[ch]);
      float sample = 0.f, dsy = 0.f, dsx = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (pix[c] < 0) continue;
        const float v = to_float(x[pix[c] + ch]);
        sample += w[c] * v;
        dsy += dwy[c] * v;
        dsx += dwx[c] * v;
        if (m != 0.f && w[c] != 0.f) atomicAdd(grad_x + pix[c] + ch, m * w[c] * g);
      }
      s_mask += g * sample;
      s_y += g * dsy;
      s_x += g * dsx;
    }
  }
  s_mask = warp_sum(s_mask);
  s_y = warp_sum(s_y);
  s_x = warp_sum(s_x);
  if (lane == 0) {
    grad_mask[e] = s_mask;
    grad_offset[2 * e] = m * s_y;
    grad_offset[2 * e + 1] = m * s_x;
  }
}

template <typename T>
cudaError_t launch_backward(const void* x, const void* offset,
                            const void* mask, const void* grad_cols,
                            void* grad_x, void* grad_offset, void* grad_mask,
                            int B, int H, int W, int C, int Ho, int Wo,
                            int stride, int pad, cudaStream_t stream) {
  const int64_t items = static_cast<int64_t>(B) * Ho * Wo * kTaps;
  const int64_t blocks = (items + kBwdWarps - 1) / kBwdWarps;
  deform_col2im_kernel<T><<<static_cast<unsigned>(blocks), kBwdWarps * 32, 0,
                            stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(offset),
      static_cast<const T*>(mask), static_cast<const T*>(grad_cols),
      static_cast<float*>(grad_x), static_cast<float*>(grad_offset),
      static_cast<float*>(grad_mask), H, W, C, Ho, Wo, stride, pad, items);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- K3 int8
constexpr int kAmaxPixels = 64;  // pixels per thread of the amax pass

template <typename T>
__global__ void channel_amax_kernel(const T* __restrict__ x,  // (B, HW, C)
                                    unsigned* __restrict__ amax,  // (B, C)
                                    int HW, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const int b = blockIdx.z;
  const int p0 = blockIdx.y * kAmaxPixels;
  const int p1 = min(HW, p0 + kAmaxPixels);
  const T* xb = x + static_cast<int64_t>(b) * HW * C + c;
  float m = 0.f;
  for (int p = p0; p < p1; ++p) {
    m = fmaxf(m, fabsf(to_float(xb[static_cast<int64_t>(p) * C])));
  }
  atomicMax(amax + b * C + c, __float_as_uint(m));
}

template <typename T>
__global__ void quantize_int8_kernel(const T* __restrict__ x,
                                     const unsigned* __restrict__ amax,
                                     int8_t* __restrict__ table,
                                     float* __restrict__ scale, int64_t n,
                                     int64_t hwc, int C) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t b = i / hwc;
    const int64_t r = i - b * hwc;
    const int c = static_cast<int>(r % C);
    const float s = __uint_as_float(amax[b * C + c]) + 1e-12f;
    const float inv = 127.f / s;  // IEEE division, then one multiply
    table[i] = static_cast<int8_t>(rintf(to_float(x[i]) * inv));
    if (r < C) scale[b * C + c] = to_float(from_float<T>(s / 127.f));
  }
}

template <typename T>
__global__ void deform_im2col_int8_kernel(
    const int8_t* __restrict__ table,  // (B, H, W, C)
    const float* __restrict__ scale,   // (B, C), working-dtype values
    const T* __restrict__ offset,      // (B, Ho, Wo, 9, 2) as (dy, dx)
    const T* __restrict__ mask,        // (B, Ho, Wo, 9)
    T* __restrict__ cols,              // (B*Ho*Wo, 9*C)
    int H, int W, int C, int Ho, int Wo, int stride, int pad,
    int64_t npix) {
  __shared__ int s_pix[kPixTile * kTaps * 4];
  __shared__ float s_w[kPixTile * kTaps * 4];
  __shared__ int s_b[kPixTile];

  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kPixTile;
  const int np = static_cast<int>(min(static_cast<int64_t>(kPixTile), npix - p0));

  for (int e = threadIdx.x; e < np * kTaps; e += blockDim.x) {
    const int t = e / kTaps;
    const int k = e - t * kTaps;
    const int64_t p = p0 + t;
    const int b = static_cast<int>(p / (static_cast<int64_t>(Ho) * Wo));
    const int rem = static_cast<int>(p - static_cast<int64_t>(b) * Ho * Wo);
    const int ho = rem / Wo, wo = rem - (rem / Wo) * Wo;
    if (k == 0) s_b[t] = b;
    const float m = to_float(mask[p * kTaps + k]);
    const float y = static_cast<float>(ho * stride - pad + k / 3) +
                    to_float(offset[(p * kTaps + k) * 2]);
    const float xf = static_cast<float>(wo * stride - pad + k % 3) +
                     to_float(offset[(p * kTaps + k) * 2 + 1]);
    int* pix = s_pix + e * 4;
    float* ws = s_w + e * 4;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      pix[c] = 0;
      ws[c] = 0.f;
    }
    if (m != 0.f && y > -1.f && y < static_cast<float>(H) && xf > -1.f &&
        xf < static_cast<float>(W)) {
      const float y0f = floorf(y), x0f = floorf(xf);
      const int y0 = static_cast<int>(y0f), x0 = static_cast<int>(x0f);
      const float fy = y - y0f, fx = xf - x0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int dy = c >> 1, dx = c & 1;
        const int yy = y0 + dy, xx = x0 + dx;
        if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
          ws[c] = m * (dy ? fy : 1.f - fy) * (dx ? fx : 1.f - fx);
          pix[c] = (b * H + yy) * W + xx;
        }
      }
    }
  }
  __syncthreads();

  const int row = kTaps * C;
  for (int e = threadIdx.x; e < np * row; e += blockDim.x) {
    const int t = e / row;
    const int j = e - t * row;
    const int k = j / C;
    const int c = j - k * C;
    const int* pix = s_pix + (t * kTaps + k) * 4;
    const float* ws = s_w + (t * kTaps + k) * 4;
    const float dq = scale[s_b[t] * C + c];
    float acc = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (ws[q] != 0.f) {
        const float v = static_cast<float>(
            table[static_cast<int64_t>(pix[q]) * C + c]);
        acc += ws[q] * to_float(from_float<T>(v * dq));
      }
    }
    cols[(p0 + t) * row + j] = from_float<T>(acc);
  }
}

template <typename T>
cudaError_t launch_int8(const void* x, const void* offset, const void* mask,
                        void* amax, void* table, void* scale, void* cols,
                        int B, int H, int W, int C, int Ho, int Wo, int stride,
                        int pad, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(
      amax, 0, sizeof(unsigned) * static_cast<size_t>(B) * C, stream);
  if (err != cudaSuccess) return err;
  const int HW = H * W;
  const int threads = C >= 128 ? 128 : ((C + 31) / 32) * 32;
  const dim3 grid_amax((C + threads - 1) / threads,
                       (HW + kAmaxPixels - 1) / kAmaxPixels, B);
  channel_amax_kernel<T><<<grid_amax, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<unsigned*>(amax), HW, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t n = static_cast<int64_t>(B) * HW * C;
  const int64_t qblocks = std::min<int64_t>((n + 255) / 256, int64_t{1} << 20);
  quantize_int8_kernel<T><<<static_cast<unsigned>(qblocks), 256, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const unsigned*>(amax),
      static_cast<int8_t*>(table), static_cast<float*>(scale), n,
      static_cast<int64_t>(HW) * C, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t npix = static_cast<int64_t>(B) * Ho * Wo;
  const int64_t blocks = (npix + kPixTile - 1) / kPixTile;
  deform_im2col_int8_kernel<T>
      <<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
          static_cast<const int8_t*>(table), static_cast<const float*>(scale),
          static_cast<const T*>(offset), static_cast<const T*>(mask),
          static_cast<T*>(cols), H, W, C, Ho, Wo, stride, pad, npix);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 for x, offset, mask and cols; 1 = bfloat16.
// Returns the cudaError_t of the launch (0 = success).
int deform_im2col(const void* x, const void* offset, const void* mask,
                  void* cols, int B, int H, int W, int C, int Ho, int Wo,
                  int stride, int pad, int dtype, void* stream) {
  // empty work launches nothing; the caller skips it, so 0 means launched
  if (static_cast<int64_t>(B) * Ho * Wo == 0 || C == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(x, offset, mask, cols, B, H, W, C, Ho, Wo, stride,
                        pad, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(x, offset, mask, cols, B, H, W, C, Ho, Wo,
                                stride, pad, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Gradients of deform_im2col for x, offset and mask, given grad_cols
// (B*Ho*Wo, 9*C) in x's dtype. grad_x is float32 NHWC and must be zeroed
// by the caller; grad_offset and grad_mask are float32 and fully written.
// Returns the cudaError_t of the launch (0 = success).
int deform_col2im(const void* x, const void* offset, const void* mask,
                  const void* grad_cols, void* grad_x, void* grad_offset,
                  void* grad_mask, int B, int H, int W, int C, int Ho, int Wo,
                  int stride, int pad, int dtype, void* stream) {
  // empty work launches nothing; the caller skips it, so 0 means launched
  if (static_cast<int64_t>(B) * Ho * Wo == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_backward<float>(x, offset, mask, grad_cols, grad_x,
                                 grad_offset, grad_mask, B, H, W, C, Ho, Wo,
                                 stride, pad, s);
  } else if (dtype == 1) {
    err = launch_backward<__nv_bfloat16>(x, offset, mask, grad_cols, grad_x,
                                         grad_offset, grad_mask, B, H, W, C,
                                         Ho, Wo, stride, pad, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// K3: int8-table im2col. x, offset, mask and cols as deform_im2col; amax
// (B*C uint32, zeroed here), table (B*H*W*C int8) and scale (B*C float32)
// are scratch and results the caller allocates. Returns the cudaError_t of
// the launches (0 = success).
int deform_im2col_int8(const void* x, const void* offset, const void* mask,
                       void* amax, void* table, void* scale, void* cols,
                       int B, int H, int W, int C, int Ho, int Wo, int stride,
                       int pad, int dtype, void* stream) {
  // empty work launches nothing; the caller skips it, so 0 means launched
  if (static_cast<int64_t>(B) * Ho * Wo == 0 || C == 0 ||
      static_cast<int64_t>(H) * W == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_int8<float>(x, offset, mask, amax, table, scale, cols, B, H,
                             W, C, Ho, Wo, stride, pad, s);
  } else if (dtype == 1) {
    err = launch_int8<__nv_bfloat16>(x, offset, mask, amax, table, scale,
                                     cols, B, H, W, C, Ho, Wo, stride, pad, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
