// The fused forward of the modulated deformable 3x3 conv (DCNv2) as an
// implicit GEMM on sm_90a, shared by K2 (deform_conv.cu, the A tile
// sampled from x) and K3 (deform_conv_int8.cu, sampled from an int8 table
// of x and dequantized). Also the device helpers K2's backward reuses:
// the swizzled shared tiles, cp.async, wgmma and the fp32 FMA path.
//
// deform_conv_fwd_kernel<T, G>: a block owns 64 output pixels x 256
// output channels (Cout 512 is two N tiles, run by neighbouring blocks so
// that the second gather hits L2). It computes the 4 corner offsets and
// mask-folded bilinear weights of its 64 x 9 (pixel, tap) samples once
// into shared memory, then walks the reduction in stages of 128 bytes of
// channels (64 bf16 / 32 fp32), channel-chunk-major. Per stage the 256
// threads gather the A tile [64 x BK] through the gather G into a
// 128-byte-swizzled shared tile, while cp.async brings the transposed
// weight tile [256 x BK]. Two stages ring: the next stage's corner loads
// and weight copies are in flight while this stage's MMAs run. bf16 runs
// wgmma (m64n128k16, fp32 accumulators, one per warpgroup, asynchronous);
// fp32 runs the same accumulator ownership in plain fp32 FMAs (no TF32).
// The epilogue stages the tile through shared memory and stores it with
// 16-byte coalesced writes.
//
// A gather G has: Src (its kernel argument), kUnitCh (channels one unit
// covers, a multiple of 16 bytes of T), kUnits (units per thread and
// stage; kUnits * 256 * kUnitCh = 64 * BK), kPerImage (whether load()
// needs the pixel's image index), load(src, pix, ws, c, C, vec, b) (the
// unit's 4 corners into registers) and store(tile, row, col) (the unit's
// channels, summed over the corners in fp32 and rounded once to T, into
// the swizzled A tile).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <algorithm>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kTaps = 9;
constexpr int kThreads = 256;  // 8 warps
constexpr int kBM = 64;        // forward: output pixels per block
constexpr int kBN = 256;       // output channels per block (fwd, wgrad)

// 128 bytes of T per reduction stage
template <typename T> struct Stage;
template <> struct Stage<float> { static constexpr int BK = 32; };
template <> struct Stage<__nv_bfloat16> { static constexpr int BK = 64; };

struct Vec {  // which 16-byte (dgrad: 4-channel) paths the pointers allow
  bool x, w, g, out;
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

// Element index of (row, col) in a shared tile whose rows are `chunks`
// 16-byte chunks long (a multiple of 8). The chunk's low 3 bits are XORed
// with the row's, so that the same logical chunk of 8 consecutive rows
// (what one ldmatrix phase, or the fp32 loop's 8 row groups, reads) falls
// in 8 distinct bank groups.
template <typename T>
__device__ __forceinline__ int swz(int row, int col, int chunks) {
  constexpr int E = 16 / sizeof(T);
  return (row * chunks + ((col / E) ^ (row & 7))) * E + (col % E);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The fp32 path's MMA: one stage of a warp's MI x NI grid of 16 x 8
// accumulator tiles at (m0, n0), acc += A(m, k) B(k, n) over k in [0,
// depth), in plain fp32 FMAs from K-major shared tiles: A(m, k) is element
// (m, a_k0 + k) of `As`, B(k, n) element (n, b_k0 + k) of `Bs`; a_chunks /
// b_chunks are their row lengths in 16-byte chunks. Thread (g, t) = (lane /
// 4, lane % 4) owns rows g, g + 8 and columns 2t, 2t + 1 of each tile: the
// ownership of the bf16 path's wgmma accumulators.
template <int MI, int NI>
__device__ __forceinline__ void warp_fma(float (&acc)[MI][NI][4],
                                         const float* As, int a_k0,
                                         int a_chunks, const float* Bs,
                                         int b_k0, int b_chunks, int m0,
                                         int n0, int depth) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int k = 0; k < depth; ++k) {
    float a[MI][2], b[NI][2];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        a[mi][h] = As[swz<float>(m0 + mi * 16 + g + h * 8, a_k0 + k, a_chunks)];
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        b[ni][h] = Bs[swz<float>(n0 + ni * 8 + 2 * t + h, b_k0 + k, b_chunks)];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        acc[mi][ni][0] += a[mi][0] * b[ni][0];
        acc[mi][ni][1] += a[mi][0] * b[ni][1];
        acc[mi][ni][2] += a[mi][1] * b[ni][0];
        acc[mi][ni][3] += a[mi][1] * b[ni][1];
      }
  }
}

// wgmma: the warpgroup's 64 x 128 fp32 tile d += A . B over one 64-deep
// bf16 stage, both operands in shared memory with the 128-byte swizzle of
// `swz` (rows of 128 bytes, 8-row groups 1024 bytes apart, tiles
// 1024-byte aligned). K-major operands (the forward: A [64 x 64], B^T
// [128 x 64]) step 32 bytes per 16-deep instruction; MN-major ones (the
// weight gradient: A^T [64 pixels x 64 channels], B [64 pixels x 128] as
// two 64-column blocks `mn_stride` bytes apart) step 16 rows = 2048 bytes
// and are read transposed. Accumulator element d[4j + e] of thread (warp w
// of the group, lane g*4 + t) is row 16w + g + 8(e / 2), column 8j + 2t +
// e % 2: the ownership of warp_fma<1, 16> at m0 = 16w.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, int mn_stride) {
  return ((smem_addr(p) & 0x3FFFFu) >> 4)                 // start address / 16
         | (static_cast<uint64_t>(mn_stride >> 4) << 16)   // MN-major: block stride
         | (uint64_t{1024 >> 4} << 32)                     // 8-row group stride
         | (uint64_t{1} << 62);                            // 128-byte swizzle
}

template <int TRANS>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TRANS));
}

// TRANS 0: K-major A and B; 1: MN-major A and B.
template <int TRANS>
__device__ __forceinline__ void wg_stage(float (&d)[64],
                                         const __nv_bfloat16* As,
                                         const __nv_bfloat16* Bs,
                                         int b_mn_stride) {
  const uint64_t da = sw128_desc(As, 16), db = sw128_desc(Bs, b_mn_stride);
  constexpr int step = TRANS ? 2048 >> 4 : 32 >> 4;  // descriptor units
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int k = 0; k < 4; ++k)
    wgmma_m64n128k16<TRANS>(d, da + step * k, db + step * k);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_wait(float (&d)[64]) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// shared-memory writes of this thread (st.shared, cp.async) made visible to
// the tensor cores' async proxy before the barrier that hands them over
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 1024-byte aligned start of the dynamic shared memory (wgmma's swizzle
// atoms); kernels ask for kSmemAlign bytes more than they use
constexpr int kSmemAlign = 1024;
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((kSmemAlign - (smem_addr(raw) & (kSmemAlign - 1))) & (kSmemAlign - 1));
}

// Row and column (within the warp's grid) of accumulator element e of
// tile (mi, ni).
__device__ __forceinline__ int acc_row(int mi, int e) {
  return mi * 16 + ((threadIdx.x & 31) >> 2) + (e >> 1) * 8;
}
__device__ __forceinline__ int acc_col(int ni, int e) {
  return ni * 8 + 2 * (threadIdx.x & 3) + (e & 1);
}

// Copies a rows x cols tile from the row-major matrix at `src` (leading
// dimension ld; valid_rows rows and valid_cols columns exist from src on)
// into the swizzled shared tile dst, zero elsewhere: cp.async 16-byte
// copies when vec (cols and ld multiples of 16 bytes, src aligned), plain
// loads otherwise.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src,
                                          int64_t ld, int rows, int cols,
                                          int valid_rows, int valid_cols,
                                          bool vec) {
  constexpr int E = 16 / sizeof(T);
  const int chunks = cols / E;
  for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
    const int r = i / chunks, c = (i - r * chunks) * E;
    T* d = dst + swz<T>(r, c, chunks);
    const T* s = src + r * ld + c;
    if (vec) {
      const bool ok = r < valid_rows && c < valid_cols;
      cp_async16(d, ok ? s : src, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e)
        d[e] = (r < valid_rows && c + e < valid_cols) ? s[e] : from_float<T>(0.f);
    }
  }
}

// The raw inputs of output pixel p's tap k: mask and (dy, dx) offset.
struct TapRaw {
  float m, dy, dx;
};

template <typename T>
__device__ __forceinline__ TapRaw tap_raw(const T* __restrict__ offset,
                                          const T* __restrict__ mask,
                                          int64_t p, int k) {
  return {to_float(mask[p * kTaps + k]), to_float(offset[(p * kTaps + k) * 2]),
          to_float(offset[(p * kTaps + k) * 2 + 1])};
}

// Corners of output pixel p's tap k for the gathers: pixel index
// (b*H + y)*W + x and bilinear weight times the mask, 0 / 0.0 outside.
// Written so that NaN and far-away samples fall through to weight 0.
__device__ __forceinline__ void tap_corners(const TapRaw& t, int64_t p, int k,
                                            int H, int W, int Ho, int Wo,
                                            int stride, int pad, int* pix,
                                            float* ws) {
  const int b = static_cast<int>(p / (static_cast<int64_t>(Ho) * Wo));
  const int rem = static_cast<int>(p - static_cast<int64_t>(b) * Ho * Wo);
  const int ho = rem / Wo, wo = rem - (rem / Wo) * Wo;
  const float m = t.m;
  const float y = static_cast<float>(ho * stride - pad + k / 3) + t.dy;
  const float xf = static_cast<float>(wo * stride - pad + k % 3) + t.dx;
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

// The gather of one 16-byte chunk (E channels from c on) of a sampled A
// row, in two halves: load() puts the 4 corners' chunks in registers,
// combine() sums them in fp32 (corner order 0..3) and rounds once to T;
// store() writes the chunk into a row of a
// shared tile. Split so that the next stage's loads are in flight during
// this stage's MMAs.
template <typename T>
struct ChunkGather {
  static constexpr int E = 16 / sizeof(T);
  uint4 raw[4];
  float w[4];
  int valid;  // channels of the chunk below C

  __device__ __forceinline__ void load(const T* __restrict__ x, const int* pix,
                                       const float* ws, int c, int C,
                                       bool vec) {
    valid = min(max(C - c, 0), E);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      w[q] = ws[q];
      raw[q] = make_uint4(0u, 0u, 0u, 0u);
      if (w[q] != 0.f && valid > 0) {
        const T* src = x + static_cast<int64_t>(pix[q]) * C + c;
        if (vec) {
          raw[q] = __ldg(reinterpret_cast<const uint4*>(src));
        } else {
          T* r = reinterpret_cast<T*>(&raw[q]);
#pragma unroll
          for (int e = 0; e < E; ++e)
            if (e < valid) r[e] = src[e];
        }
      }
    }
  }

  __device__ __forceinline__ uint4 combine() const {
    uint4 out;
    T* o = reinterpret_cast<T*>(&out);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (w[q] != 0.f)
          acc += w[q] * to_float(reinterpret_cast<const T*>(&raw[q])[e]);
      }
      o[e] = from_float<T>(e < valid ? acc : 0.f);
    }
    return out;
  }

  __device__ __forceinline__ void store(T* dst) const {
    *reinterpret_cast<uint4*>(dst) = combine();
  }
};

// K2's gather: the A tile sampled from x itself, two 16-byte chunks a
// thread and stage.
template <typename T>
struct XGather {
  using Src = const T*;
  static constexpr int kUnitCh = 16 / sizeof(T), kUnits = 2;
  static constexpr bool kPerImage = false;
  ChunkGather<T> g;

  __device__ __forceinline__ void load(Src x, const int* pix, const float* ws,
                                       int c, int C, bool vec, int) {
    g.load(x, pix, ws, c, C, vec);
  }
  __device__ __forceinline__ void store(T* tile, int row, int col) const {
    constexpr int CH = Stage<T>::BK / kUnitCh;
    g.store(tile + swz<T>(row, col, CH));
  }
};

// Shared memory of the forward: a 2-stage ring of A [64 x BK] and B^T
// [256 x BK] K-major tiles (the same bytes for both dtypes), then the
// corner table of its 64 x 9 (pixel, tap) samples (and, for a gather that
// needs it, each pixel's image index).
template <typename T>
__host__ __device__ constexpr size_t ring_bytes() {
  return 2 * (kBM + kBN) * Stage<T>::BK * sizeof(T);
}
constexpr size_t kTableBytes = kBM * kTaps * 4 * (sizeof(int) + sizeof(float));

template <typename T, typename G>
constexpr size_t fwd_smem_bytes() {
  return ring_bytes<T>() + kTableBytes + (G::kPerImage ? kBM * sizeof(int) : 0) +
         kSmemAlign;
}

// The block's 64 x 256 tile: 8 warps, warp w owns rows 16 (w % 4) .. + 15
// and columns 128 (w / 4) .. + 127 (bf16: the two warpgroups' wgmma
// tiles), as warp_fma<1, 16>.
__device__ __forceinline__ int tile_m0() { return ((threadIdx.x >> 5) & 3) * 16; }
__device__ __forceinline__ int tile_n0() { return (threadIdx.x >> 7) * 128; }

// acc += A[cur] . B[cur]^T of one stage on the block's 64 x 256 tile.
template <typename T>
__device__ __forceinline__ void block_stage(float (&acc)[1][16][4],
                                            const T* As, const T* Bs) {
  constexpr int BK = Stage<T>::BK, CH = BK / (16 / static_cast<int>(sizeof(T)));
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    wg_stage<0>(*reinterpret_cast<float(*)[64]>(&acc), As, Bs + tile_n0() * BK,
                16);
  } else {
    warp_fma<1, 16>(acc, As, 0, CH, Bs, 0, CH, tile_m0(), tile_n0(), BK);
  }
}

template <typename T>
__device__ __forceinline__ void block_stage_wait(float (&acc)[1][16][4]) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    wg_wait(*reinterpret_cast<float(*)[64]>(&acc));
    fence_async_proxy();
  }
}

template <typename T, typename G>
__global__ void __launch_bounds__(kThreads, 2) deform_conv_fwd_kernel(
    typename G::Src src,           // what G samples (x, or the int8 table)
    const T* __restrict__ offset,  // (B, Ho, Wo, 9, 2) as (dy, dx)
    const T* __restrict__ mask,    // (B, Ho, Wo, 9)
    const T* __restrict__ wt,      // (N, 9*C): the weight, transposed
    T* __restrict__ out,           // (B*Ho*Wo, N)
    int H, int W, int C, int Ho, int Wo, int stride, int pad, int N,
    int64_t npix, int n_tiles, Vec vec) {
  constexpr int BK = Stage<T>::BK, E = 16 / sizeof(T);
  constexpr int UPR = BK / G::kUnitCh;  // gather units per A row
  static_assert(G::kUnits * kThreads == kBM * UPR, "one stage, all threads");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  T* As = reinterpret_cast<T*>(smem);  // [2][kBM][BK]
  T* Bs = As + 2 * kBM * BK;           // [2][kBN][BK]
  int* s_pix = reinterpret_cast<int*>(smem + ring_bytes<T>());  // [kBM][9][4]
  float* s_w = reinterpret_cast<float*>(s_pix + kBM * kTaps * 4);
  int* s_b = reinterpret_cast<int*>(s_w + kBM * kTaps * 4);  // [kBM], kPerImage

  const int tid = threadIdx.x;
  const int n0 = (blockIdx.x % n_tiles) * kBN;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x / n_tiles) * kBM;

  for (int e = tid; e < kBM * kTaps; e += kThreads) {
    const int r = e / kTaps;
    if (p0 + r < npix) {
      const int k = e - r * kTaps;
      tap_corners(tap_raw(offset, mask, p0 + r, k), p0 + r, k, H, W, Ho, Wo,
                  stride, pad, s_pix + e * 4, s_w + e * 4);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        s_pix[e * 4 + q] = 0;
        s_w[e * 4 + q] = 0.f;
      }
    }
  }
  if constexpr (G::kPerImage) {
    for (int r = tid; r < kBM; r += kThreads)
      s_b[r] = static_cast<int>(min(p0 + r, npix - 1) /
                                (static_cast<int64_t>(Ho) * Wo));
  }
  __syncthreads();

  const int nc = (C + BK - 1) / BK, KT = kTaps * nc;
  const int64_t K9 = static_cast<int64_t>(kTaps) * C;
  G gat[G::kUnits];
  // stages kt = chunk * 9 + tap, channel-chunk-major: the blocks in flight
  // read one chunk of x at a time
  auto gather_load = [&](int kt) {
    const int tap = kt % kTaps, c0 = kt / kTaps * BK;
#pragma unroll
    for (int u = 0; u < G::kUnits; ++u) {
      const int i = tid + u * kThreads, r = i / UPR, uc = i - r * UPR;
      const int e = r * kTaps + tap;
      gat[u].load(src, s_pix + e * 4, s_w + e * 4, c0 + uc * G::kUnitCh, C,
                  vec.x, G::kPerImage ? s_b[r] : 0);
    }
  };
  auto gather_store = [&](int buf) {
#pragma unroll
    for (int u = 0; u < G::kUnits; ++u) {
      const int i = tid + u * kThreads, r = i / UPR, uc = i - r * UPR;
      gat[u].store(As + buf * kBM * BK, r, uc * G::kUnitCh);
    }
  };
  auto load_b = [&](int kt, int buf) {
    const int tap = kt % kTaps, c0 = kt / kTaps * BK;
    load_tile<T>(Bs + buf * kBN * BK, wt + n0 * K9 + tap * C + c0, K9, kBN,
                 BK, N - n0, C - c0, vec.w);
  };

  float acc[1][16][4] = {};
  load_b(0, 0);
  cp_async_commit();
  gather_load(0);
  gather_store(0);
  cp_async_wait_all();
  block_stage_wait<T>(acc);
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    const int cur = kt & 1;
    const bool next = kt + 1 < KT;
    if (next) {
      load_b(kt + 1, cur ^ 1);
      cp_async_commit();
      gather_load(kt + 1);
    }
    block_stage<T>(acc, As + cur * kBM * BK, Bs + cur * kBN * BK);
    if (next) gather_store(cur ^ 1);
    cp_async_wait_all();
    block_stage_wait<T>(acc);
    __syncthreads();
  }

  // epilogue: through shared memory, then 16-byte coalesced stores
  T* Cs = reinterpret_cast<T*>(smem);  // [kBM][kBN]
  constexpr int OC = kBN / E;
  const int m0 = tile_m0(), nb = tile_n0();
#pragma unroll
  for (int ni = 0; ni < 16; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      Cs[swz<T>(m0 + acc_row(0, e), nb + acc_col(ni, e), OC)] =
          from_float<T>(acc[0][ni][e]);
  __syncthreads();
  for (int i = tid; i < kBM * OC; i += kThreads) {
    const int r = i / OC, n = (i - r * OC) * E;
    const int64_t p = p0 + r;
    if (p >= npix || n0 + n >= N) continue;
    const T* src_c = Cs + swz<T>(r, n, OC);
    T* dst = out + p * N + n0 + n;
    if (vec.out) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src_c);
    } else {
      for (int e = 0; e < E && n0 + n + e < N; ++e) dst[e] = src_c[e];
    }
  }
}

bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

cudaError_t check_smem(size_t bytes) {
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  return bytes <= static_cast<size_t>(limit) ? cudaSuccess
                                             : cudaErrorInvalidValue;
}

// One launch of deform_conv_fwd_kernel<T, G> over B*Ho*Wo pixels and N
// output channels.
template <typename T, typename G>
cudaError_t launch_fwd_kernel(typename G::Src src, const void* offset,
                              const void* mask, const void* wt, void* out,
                              int B, int H, int W, int C, int Ho, int Wo,
                              int N, int stride, int pad, Vec vec,
                              cudaStream_t stream) {
  const int64_t npix = static_cast<int64_t>(B) * Ho * Wo;
  const int n_tiles = (N + kBN - 1) / kBN;
  const int64_t blocks = (npix + kBM - 1) / kBM * n_tiles;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  constexpr size_t smem = fwd_smem_bytes<T, G>();
  cudaError_t err = check_smem(smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(deform_conv_fwd_kernel<T, G>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  deform_conv_fwd_kernel<T, G><<<static_cast<unsigned>(blocks), kThreads, smem,
                                 stream>>>(
      src, static_cast<const T*>(offset), static_cast<const T*>(mask),
      static_cast<const T*>(wt), static_cast<T*>(out), H, W, C, Ho, Wo,
      stride, pad, N, npix, n_tiles, vec);
  return cudaGetLastError();
}

}  // namespace
