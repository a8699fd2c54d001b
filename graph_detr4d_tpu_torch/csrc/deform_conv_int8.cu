// K3: the int8-table variant of K2's modulated deformable 3x3 conv, as a
// fused implicit GEMM. Hand-written for sm_90a.
//
// Replaces graph_detr4d_tpu/ops/deform_conv.py::_deform_conv_int8 (:259):
// the forward of `_deform_conv_gather(..., "int8")` (:136), that is the
// quantization (:164-169), the gather and dequantization (:216-221) and
// the (9*Cin, Cout) contraction (:247). For NHWC x (B, H, W, Cin), output
// pixel p = (b, ho, wo) and 3x3 tap k = (ky, kx):
//   q = rint(x * (127 / s)), s = amax over (H, W) of |x[b, :, :, c]| + 1e-12
//   scale[b, c] = T(s / 127)
//   py = ho*stride - pad + ky + offset[p, k, 0]   (dy)
//   px = wo*stride - pad + kx + offset[p, k, 1]   (dx)
//   A[p, k*Cin + c] = T(mask[p, k] * bilinear(T(q[b, :, :, c] * scale[b, c]), py, px))
//   out[p, n] = sum_j A[p, j] * w[j, n]
// with align_corners=False, zero padding, corners outside the image
// skipped and NaN or far-away samples at weight 0, as K2.
//
// Three kernels on one stream:
//   1. per-(image, channel) amax of |x| over (H, W): a thread per channel
//      walks a chunk of pixels (coalesced across channels) and folds its
//      max into a zeroed uint32 buffer with atomicMax on the float's bits
//      (non-negative floats order like their bit patterns);
//   2. the int8 NHWC table q and the (B, C) dequantization scales, in fp32
//      with round-half-to-even, as the JAX op orders it;
//   3. deform_conv_fwd_kernel<T, Int8Gather<T>> of dcn_forward.cuh: K2's
//      fused forward (64 pixels x 256 output channels a block, the corner
//      table in shared memory, channel-chunk-major stages, the 128-byte-
//      swizzled A tile, the transposed weight by cp.async, wgmma
//      m64n128k16 in bf16, plain fp32 FMAs in fp32, the staged epilogue)
//      with another gather: one 16-byte load brings 16 int8 channels of a
//      corner (8 bytes, 8 channels, in fp32), where K2's brings 8 bf16.
//      Each corner value is dequantized as T(q * scale[b, c]) (the JAX
//      op's `g.astype(dtype) * dequant`), weighted by the mask-folded
//      bilinear weight, the 4 corners summed in fp32 and rounded once to T
//      into the shared A tile. A block of 64 pixels may straddle images,
//      so the scale row is looked up by each pixel's image.
// What bounds it: by operations, the contraction, 2*M*9*Cin*Cout (56.6
// GFLOP for each of the flagship's 7 int8 convs: ~0.40 ms a request at
// 989 TFLOP/s bf16); the bytes it must move (x read twice, the table
// written and read once, offsets, mask, weight, output) take less. The
// realistic floor is the gather's traffic through L2, which bounds K2's
// forward: here about half of K2's corner bytes, the point of the
// variant. No (M, 9*Cin) column tile is written: the A tile lives in
// shared memory only.
//
// Channels: Cin % 16 == 0 (the flagship has 256 and 512), so that every
// unit's 16 int8 channels are one aligned load, all inside or all outside
// Cin. Other widths would need a scalar tail in Int8Gather::load (as
// ChunkGather's `valid`) and byte-granular table rows.

#include "dcn_forward.cuh"

namespace {

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

// Four int8 values of a 32-bit word as exact floats, without the
// quarter-rate int-to-float conversions: each byte, offset by 128, goes
// into the low mantissa bits of 2^23 (one byte permute) and 2^23 + 128 is
// subtracted (one add).
__device__ __forceinline__ void int8x4_to_float(unsigned word, float (&f)[4]) {
  const unsigned u = word ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.f;
}

// The bf16 pair of the upper halves of two floats (exact for floats that
// are bf16 values, as small integers and the scales are).
__device__ __forceinline__ unsigned bf16x2_of(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// T(q * scale) of four channels, as floats: in bf16 two packed bf16
// multiplies (exact product, one rounding to nearest even, as the plain
// version's bf16 multiply) unpacked by byte permutes; in fp32 the product.
template <typename T>
__device__ __forceinline__ void dequant4(const float (&q)[4], const float* dq,
                                         const unsigned* dq2, float (&v)[4]) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const unsigned qq = bf16x2_of(q[2 * h], q[2 * h + 1]);
      const __nv_bfloat162 p = __hmul2(
          *reinterpret_cast<const __nv_bfloat162*>(&qq),
          *reinterpret_cast<const __nv_bfloat162*>(&dq2[h]));
      const unsigned pb = *reinterpret_cast<const unsigned*>(&p);
      v[2 * h] = __uint_as_float(__byte_perm(pb, 0u, 0x1044));
      v[2 * h + 1] = __uint_as_float(__byte_perm(pb, 0u, 0x3244));
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = q[e] * dq[e];
  }
}

// K3's gather for deform_conv_fwd_kernel: one unit is kUnitCh int8
// channels of a sampled A row (16 in bf16, one uint4 per corner; 8 in
// fp32, one uint2), written into the A tile as two 16-byte chunks of T.
template <typename T>
struct Int8Gather {
  struct Src {
    const int8_t* __restrict__ table;  // (B, H, W, C)
    const float* __restrict__ scale;   // (B, C), values rounded to T
  };
  static constexpr int E = 16 / sizeof(T);
  static constexpr int kUnitCh = 2 * E, kUnits = 1;
  static constexpr bool kPerImage = true;
  using Raw = typename std::conditional<kUnitCh == 16, uint4, uint2>::type;
  Raw raw[4];
  float w[4];
  float dq[kUnitCh];
  bool live;  // the unit's channels are below C (all or none: C % 16 == 0)

  __device__ __forceinline__ void load(const Src& s, const int* pix,
                                       const float* ws, int c, int C, bool,
                                       int b) {
    live = c < C && (ws[0] != 0.f || ws[1] != 0.f || ws[2] != 0.f ||
                     ws[3] != 0.f);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      w[q] = ws[q];
      raw[q] = Raw{};
      if (live && w[q] != 0.f)
        raw[q] = __ldg(reinterpret_cast<const Raw*>(
            s.table + static_cast<int64_t>(pix[q]) * C + c));
    }
    const float4* sc = reinterpret_cast<const float4*>(
        s.scale + static_cast<int64_t>(b) * C + c);
#pragma unroll
    for (int j = 0; j < kUnitCh / 4; ++j) {
      const float4 f = live ? __ldg(sc + j) : make_float4(0.f, 0.f, 0.f, 0.f);
      dq[4 * j] = f.x;
      dq[4 * j + 1] = f.y;
      dq[4 * j + 2] = f.z;
      dq[4 * j + 3] = f.w;
    }
  }

  // The unit's channels: each corner's value dequantized to T, weighted,
  // the 4 corners summed in fp32 (corner order 0..3), rounded once to T.
  __device__ __forceinline__ void store(T* tile, int row, int col) const {
    constexpr int CH = Stage<T>::BK / E;
    unsigned dq2[kUnitCh / 2];  // bf16: the scales as packed pairs
#pragma unroll
    for (int i = 0; i < kUnitCh / 2; ++i) dq2[i] = bf16x2_of(dq[2 * i], dq[2 * i + 1]);
    float acc[kUnitCh] = {};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (w[q] == 0.f) continue;
      const unsigned* words = reinterpret_cast<const unsigned*>(&raw[q]);
#pragma unroll
      for (int k = 0; k < kUnitCh / 4; ++k) {
        float f[4], v[4];
        int8x4_to_float(words[k], f);
        dequant4<T>(f, dq + 4 * k, dq2 + 2 * k, v);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[4 * k + e] += w[q] * v[e];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint4 out;
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int e = 0; e < E; ++e) o[e] = from_float<T>(acc[h * E + e]);
      *reinterpret_cast<uint4*>(tile + swz<T>(row, col + h * E, CH)) = out;
    }
  }
};

template <typename T>
cudaError_t launch_int8(const void* x, const void* offset, const void* mask,
                        const void* wt, void* amax, void* table, void* scale,
                        void* out, int B, int H, int W, int C, int Ho, int Wo,
                        int N, int stride, int pad, cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  if (C % 16 != 0 || !aligned(table, 16) || !aligned(scale, 16))
    return cudaErrorInvalidValue;
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
  const Vec vec{true, aligned(wt, 16), false, N % E == 0 && aligned(out, 16)};
  return launch_fwd_kernel<T, Int8Gather<T>>(
      {static_cast<const int8_t*>(table), static_cast<const float*>(scale)},
      offset, mask, wt, out, B, H, W, C, Ho, Wo, N, stride, pad, vec, stream);
}

}  // namespace

extern "C" {

// K3: out (B*Ho*Wo, N) = the int8-table deform_conv2d of x (B, H, W, C)
// with offset (B, Ho, Wo, 9, 2), mask (B, Ho, Wo, 9) and the weight given
// transposed, wt (N, 9*C) with tap-major columns, all in one dtype (0 =
// float32, 1 = bfloat16); C % 16 == 0. amax (B*C uint32, zeroed here),
// table (B*H*W*C int8) and scale (B*C float32), the latter two 16-byte
// aligned, are scratch and results the caller allocates. Three kernel
// launches and a memset. Returns the cudaError_t of the launches (0 =
// success).
int deform_conv_int8_forward(const void* x, const void* offset,
                             const void* mask, const void* wt, void* amax,
                             void* table, void* scale, void* out, int B,
                             int H, int W, int C, int Ho, int Wo, int N,
                             int stride, int pad, int dtype, void* stream) {
  // empty work launches nothing; the caller skips it, so 0 means launched
  if (static_cast<int64_t>(B) * Ho * Wo == 0 || C == 0 || N == 0 ||
      static_cast<int64_t>(H) * W == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_int8<float>(x, offset, mask, wt, amax, table, scale, out, B,
                             H, W, C, Ho, Wo, N, stride, pad, s);
  } else if (dtype == 1) {
    err = launch_int8<__nv_bfloat16>(x, offset, mask, wt, amax, table, scale,
                                     out, B, H, W, C, Ho, Wo, N, stride, pad,
                                     s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
