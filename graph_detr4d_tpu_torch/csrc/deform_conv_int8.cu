// K3: the int8-table variant of K2's modulated deformable im2col. Hand-
// written for sm_90a.
//
// Replaces graph_detr4d_tpu/ops/deform_conv.py::_deform_conv_int8 (the
// 'int8' table of `_deform_conv_gather`). For NHWC x (B, H, W, Cin), per
// output pixel p = (b, ho, wo) and 3x3 tap k = (ky, kx):
//   py = ho*stride - pad + ky + offset[p, k, 0]   (dy)
//   px = wo*stride - pad + kx + offset[p, k, 1]   (dx)
//   cols[p, k*Cin + c] = mask[p, k] * bilinear(table[b, :, :, c] * scale[b, c], py, px)
// with zero padding outside the image: the column tile (B*Ho*Wo, 9*Cin),
// tap-major, in the working dtype. The contraction with the weight stays a
// torch.matmul in ops/deform_conv.py.
//
// Three kernels on one stream:
//   1. per-(image, channel) amax of |x| over (H, W): a thread per channel
//      walks a chunk of pixels (coalesced across channels) and folds its
//      max into a zeroed uint32 buffer with atomicMax on the float's bits
//      (non-negative floats order like their bit patterns);
//   2. the int8 NHWC table q = rint(x * (127 / s)), s = amax + 1e-12, in
//      fp32 with round-half-to-even, and the (B, C) dequantization scales
//      s / 127 rounded to the working dtype, as the JAX op orders it;
//   3. the im2col reading int8 corner rows and dequantizing per channel
//      after the gather (each corner value is q * scale rounded to the
//      working dtype, as the JAX op's `g.astype(dtype) * dequant`).
// What bounds it: bytes. The gather reads 1 byte per corner element
// instead of 2 (bf16), which is the variant's point; the column tile it
// writes is 9x the output map, and the quantize pass adds a read of x and
// a write of the table. K2's fused kernel (deform_conv.cu) shows the way
// to drop the tile: gather the int8 rows into shared memory and feed the
// tensor cores from there.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <algorithm>
#include <cstdint>

namespace {

constexpr int kTaps = 9;
constexpr int kPixTile = 4;  // output pixels per block of the gather

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
  __shared__ int s_pix[kPixTile * kTaps * 4];  // pixel index b*H*W + y*W + x
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

// K3: int8-table im2col. x, offset, mask and cols in one dtype (0 =
// float32, 1 = bfloat16); amax (B*C uint32, zeroed here), table (B*H*W*C
// int8) and scale (B*C float32) are scratch and results the caller
// allocates. Returns the cudaError_t of the launches (0 = success).
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
