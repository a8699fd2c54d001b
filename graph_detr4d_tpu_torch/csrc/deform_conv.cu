// K2: modulated deformable 3x3 convolution (DCNv2), forward and backward,
// as fused implicit GEMMs. Hand-written for sm_90a.
//
// Replaces graph_detr4d_tpu/ops/deform_conv.py::deform_conv2d (:78): the
// tap sampling (`_sample_taps_onehot` for small grids, the shift4
// `_deform_conv_gather` for large ones) AND the (9*Cin, Cout) contraction
// of its einsums (:119, :247). For NHWC x (B, H, W, Cin), output pixel
// p = (b, ho, wo) and tap k = (ky, kx):
//   py = ho*stride - pad + ky + offset[p, k, 0]   (dy)
//   px = wo*stride - pad + kx + offset[p, k, 1]   (dx)
//   A[p, k*Cin + c] = mask[p, k] * bilinear(x[b, :, :, c], py, px)
//   out[p, n] = sum_j A[p, j] * w[j, n],   w = (9*Cin, Cout), tap-major
// with align_corners=False pixel centres and zero padding; corners outside
// the image are skipped, and a NaN or far-away sample gets weight 0.
//
// What bounds it on this card: by the count of operations, the
// contraction, 2*M*9*Cin*Cout FLOPs (about 57 GFLOP for each of the
// flagship's 9 convs: 0.52 ms per request at 989 TFLOP/s bf16) against
// about 0.5 GB of x, offsets, mask, weight and output (0.15 ms at 3.35
// TB/s). The column tile A (9x the output map, 221 MB for a stage-3 conv
// in bf16) is never written: each block gathers its A tile into shared
// memory and feeds the tensor cores from there. But the gather's corner
// reads are 4 x 2 bytes per A element, mostly hits in the 50 MB L2 (x is
// 25-98 MB per conv): about 0.9 GB of L2 traffic for a stage-3 conv, plus
// the weight tiles each block reads. So the realistic floor is the L2's
// bandwidth, above the 0.52 ms ops bound.
//
// Forward (deform_conv_fwd_kernel): a block owns 64 output pixels x 256
// output channels (the flagship's Cout 256 is one N tile, 512 two, run by
// neighbouring blocks so that the second gather hits L2). It computes the
// 4 corner offsets and mask-folded bilinear weights of its 64 x 9 (pixel,
// tap) samples once into shared memory, then walks the reduction in stages
// of 128 bytes of channels (64 bf16 / 32 fp32), channel-chunk-major (the
// blocks in flight read one chunk of x at a time). Per stage the 256
// threads gather the A tile [64 x BK] (16-byte loads of 8 NHWC bf16
// channels per corner, the 4-corner sum in fp32 rounded once to the
// working dtype, as `deform_im2col_plain`'s column tile rounds) into a
// 128-byte-swizzled shared tile, while cp.async brings the transposed
// weight tile [256 x BK]. Two stages ring: the next stage's corner loads
// and weight copies are in flight while this stage's MMAs run. bf16 runs
// wgmma (m64n128k16, fp32 accumulators, one per warpgroup, asynchronous:
// the next stage's gather is stored while it runs); fp32 runs the same
// accumulator ownership in plain fp32 FMAs (no TF32), so that the fp32
// path holds the plain version to 1e-4. 128 registers a thread, two
// blocks an SM. The epilogue stages the tile through shared memory and
// stores it with 16-byte coalesced writes.
//
// Backward, per call a memset of grad_x and four kernels:
//   * deform_conv_dgrad_kernel: a block owns 128 pixels (64 where Cout
//     does not fit) and keeps their grad_out rows resident in shared
//     memory. For each chunk of 64 input channels and each tap (the unit)
//     it computes G = grad_out . W_unit^T on the tensor cores (bf16:
//     wgmma m64n32k16; fp32: FMAs) into shared memory, never device
//     memory, then from G and the unit's 4 re-gathered corner rows:
//       grad_x[corner, c] += m * w_corner * G      (float4 atomics, 4
//                                                   channels per atomic)
//       grad_mask[p, k]    = sum_c G * sample
//       grad_offset[p, k]  = m * sum_c G * d sample / d(dy, dx)
//     The scatter of one unit runs while the asynchronous MMAs of the next
//     are in flight; its corner loads are all issued before any use. Four
//     threads own a pixel's channels; the unit's sums are reduced by warp
//     shuffles and added to the pixel's tap sums in chunk order, so
//     grad_mask / grad_offset are deterministic. Units run channel-chunk-
//     major so that the blocks in flight update one chunk of grad_x at a
//     time (it stays in L2). What bounds it: L2 traffic, the atomics
//     (1.8 GB for a stage-3 conv) and the corner reads.
//   * deform_conv_table_kernel: the mask-folded corners of every (tap,
//     pixel), for the weight gradient's gather.
//   * deform_conv_wgrad_kernel: grad_w = A^T . grad_out. A block owns a
//     (tap, 64-channel chunk) x 256 tile of grad_w and walks a slice of
//     the pixels, rebuilding A's chunk in shared memory as the forward
//     does (corners from the table, by cp.async two stages ahead); bf16
//     runs wgmma with both operands read transposed (MN-major). The
//     slices' count fills the card's block slots; each slice writes fp32
//     partials, and
//   * sum_slices_kernel adds them up in slice order, so no float atomics
//     go into grad_w and the result does not depend on the blocks' order.

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
constexpr int kBC = 64;        // dgrad: input channels per G tile
constexpr int kGtLd = kBC + 8; // dgrad: row stride of the G tile

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

// Shared memory of the forward: a 2-stage ring of A [64 x BK] and B^T
// [256 x BK] K-major tiles (the same bytes for both dtypes), then the
// corner table of its 64 x 9 (pixel, tap) samples.
template <typename T>
__host__ __device__ constexpr size_t ring_bytes() {
  return 2 * (kBM + kBN) * Stage<T>::BK * sizeof(T);
}
constexpr size_t kTableBytes = kBM * kTaps * 4 * (sizeof(int) + sizeof(float));

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

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) deform_conv_fwd_kernel(
    const T* __restrict__ x,       // (B, H, W, C)
    const T* __restrict__ offset,  // (B, Ho, Wo, 9, 2) as (dy, dx)
    const T* __restrict__ mask,    // (B, Ho, Wo, 9)
    const T* __restrict__ wt,      // (N, 9*C): the weight, transposed
    T* __restrict__ out,           // (B*Ho*Wo, N)
    int H, int W, int C, int Ho, int Wo, int stride, int pad, int N,
    int64_t npix, int n_tiles, Vec vec) {
  constexpr int BK = Stage<T>::BK, E = 16 / sizeof(T), CH = BK / E;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  T* As = reinterpret_cast<T*>(smem);  // [2][kBM][BK]
  T* Bs = As + 2 * kBM * BK;           // [2][kBN][BK]
  int* s_pix = reinterpret_cast<int*>(smem + ring_bytes<T>());  // [kBM][9][4]
  float* s_w = reinterpret_cast<float*>(s_pix + kBM * kTaps * 4);

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
  __syncthreads();

  const int nc = (C + BK - 1) / BK, KT = kTaps * nc;
  const int64_t K9 = static_cast<int64_t>(kTaps) * C;
  ChunkGather<T> gat[2];
  // stages kt = chunk * 9 + tap, channel-chunk-major: the blocks in flight
  // read one chunk of x at a time
  auto gather_load = [&](int kt) {
    const int tap = kt % kTaps, c0 = kt / kTaps * BK;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = tid + u * kThreads, r = i / CH, ch = i - r * CH;
      const int e = r * kTaps + tap;
      gat[u].load(x, s_pix + e * 4, s_w + e * 4, c0 + ch * E, C, vec.x);
    }
  };
  auto gather_store = [&](int buf) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = tid + u * kThreads, r = i / CH, ch = i - r * CH;
      gat[u].store(As + buf * kBM * BK + swz<T>(r, ch * E, CH));
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
    const T* src = Cs + swz<T>(r, n, OC);
    T* dst = out + p * N + n0 + n;
    if (vec.out) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < E && n0 + n + e < N; ++e) dst[e] = src[e];
    }
  }
}

// The data gradient's table of output pixel p's tap k: the corners' pixel
// indices (b*H + y)*W + x, -1 outside the image (all -1 where the sample is
// out of range or NaN, which gives no gradient), and the fractional
// position (fy, fx).
template <typename T>
__device__ __forceinline__ void tap_grad_entry(const T* __restrict__ offset,
                                               int64_t p, int k, int H, int W,
                                               int Ho, int Wo, int stride,
                                               int pad, int* pix, float* f) {
  const int b = static_cast<int>(p / (static_cast<int64_t>(Ho) * Wo));
  const int rem = static_cast<int>(p - static_cast<int64_t>(b) * Ho * Wo);
  const int ho = rem / Wo, wo = rem - (rem / Wo) * Wo;
  const float y = static_cast<float>(ho * stride - pad + k / 3) +
                  to_float(offset[(p * kTaps + k) * 2]);
  const float xf = static_cast<float>(wo * stride - pad + k % 3) +
                   to_float(offset[(p * kTaps + k) * 2 + 1]);
#pragma unroll
  for (int c = 0; c < 4; ++c) pix[c] = -1;
  f[0] = f[1] = 0.f;
  if (!(y > -1.f && y < static_cast<float>(H) && xf > -1.f &&
        xf < static_cast<float>(W)))
    return;
  const float y0f = floorf(y), x0f = floorf(xf);
  const int y0 = static_cast<int>(y0f), x0 = static_cast<int>(x0f);
  f[0] = y - y0f;
  f[1] = xf - x0f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int yy = y0 + (c >> 1), xx = x0 + (c & 1);
    if (yy >= 0 && yy < H && xx >= 0 && xx < W) pix[c] = (b * H + yy) * W + xx;
  }
}

// Four consecutive channels of x in registers: float4, or 4 bf16 in a uint2.
template <typename T> struct Quad;
template <> struct Quad<float> {
  float4 v;
  __device__ __forceinline__ void load(const float* p) {
    v = __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ __forceinline__ float operator[](int e) const {
    return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
  }
};
template <> struct Quad<__nv_bfloat16> {
  uint2 v;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    v = __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ __forceinline__ float operator[](int e) const {
    const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(
        e < 2 ? &v.x : &v.y);
    return (e & 1) ? __high2float(h) : __low2float(h);
  }
};

// grad_x, grad_mask and grad_offset terms of one pixel's tap over the
// channels [c0, c0 + kBC) that quarter j (0..3) of the pixel's threads
// owns: 4-channel groups j, j + 4, j + 8, j + 12 (vec4: C % 4 == 0 and x,
// grad_x aligned; a pixel's 4 threads cover 16 contiguous channels, one
// float4 atomic each), all 16 corner loads issued before any use; or
// channels j, j + 4, ... one at a time.
template <typename T>
__device__ __forceinline__ void scatter_tap(const T* __restrict__ x,
                                            float* __restrict__ grad_x,
                                            const T* g_row, const int* pix,
                                            float fy, float fx, float m, int c0,
                                            int C, int j, bool vec4, float& sm,
                                            float& sy, float& sx) {
  float w[4], dwy[4], dwx[4];
  int64_t base[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int dy = q >> 1, dx = q & 1;
    const float wy = dy ? fy : 1.f - fy, wx = dx ? fx : 1.f - fx;
    w[q] = wy * wx;
    dwy[q] = wx * (dy ? 1.f : -1.f);
    dwx[q] = wy * (dx ? 1.f : -1.f);
    base[q] = pix[q] < 0 ? -1 : static_cast<int64_t>(pix[q]) * C;
  }
  if (vec4) {
    constexpr int kG = kBC / 16;  // groups per thread
    Quad<T> v[kG][4];
#pragma unroll
    for (int i = 0; i < kG; ++i) {
      const int c = c0 + (j + 4 * i) * 4;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (c < C && base[q] >= 0) v[i][q].load(x + base[q] + c);
    }
#pragma unroll
    for (int i = 0; i < kG; ++i) {
      const int cl = (j + 4 * i) * 4, c = c0 + cl;
      if (c >= C) break;
      float g[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) g[e] = to_float(g_row[cl + e]);
      float s[4] = {}, ddy[4] = {}, ddx[4] = {};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (base[q] < 0) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[e] += w[q] * v[i][q][e];
          ddy[e] += dwy[q] * v[i][q][e];
          ddx[e] += dwx[q] * v[i][q][e];
        }
        if (m != 0.f && w[q] != 0.f) {
          const float a = m * w[q];
          atomicAdd(reinterpret_cast<float4*>(grad_x + base[q] + c),
                    make_float4(a * g[0], a * g[1], a * g[2], a * g[3]));
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sm += g[e] * s[e];
        sy += g[e] * ddy[e];
        sx += g[e] * ddx[e];
      }
    }
  } else {
    for (int cl = j; cl < kBC && c0 + cl < C; cl += 4) {
      const int c = c0 + cl;
      const float g = to_float(g_row[cl]);
      float s = 0.f, ddy = 0.f, ddx = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (base[q] < 0) continue;
        const float xv = to_float(x[base[q] + c]);
        s += w[q] * xv;
        ddy += dwy[q] * xv;
        ddx += dwx[q] * xv;
        if (m != 0.f && w[q] != 0.f) atomicAdd(grad_x + base[q] + c, m * w[q] * g);
      }
      sm += g * s;
      sy += g * ddy;
      sx += g * ddx;
    }
  }
}

// The data gradient's block: BM pixels, 4 threads each in the scatter;
// warpgroup (wm, wn) = (g / 2, g % 2) of the MMAs owns rows 64 wm .. + 63
// and columns 32 wn .. + 31 of the BM x 64 G tile (bf16: wgmma m64n32,
// fp32: the same ownership in warp_fma<1, 4>). grad_out rows stay
// resident (bf16: in 64-column blocks, wgmma's K-major atoms); the
// reduction over Cout runs in stages of KS columns (KS 256: one stage per
// unit up to Cout 256), whose W tiles [64 x KS] are double-buffered. G
// goes to shared memory in the working dtype once a unit's stages are
// done; the scatter of that unit runs while the asynchronous MMAs of the
// next one are in flight.
template <typename T, int BM, int KS>
size_t dgrad_smem_bytes(int n_pad) {
  return (static_cast<size_t>(BM) * n_pad + 2 * kBC * KS + BM * kGtLd) *
             sizeof(T) +
         BM * kTaps * (4 * sizeof(int) + 5 * sizeof(float)) + kSmemAlign;
}

__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

template <typename T, int BM, int KS>
__global__ void __launch_bounds__(BM * 4) deform_conv_dgrad_kernel(
    const T* __restrict__ x, const T* __restrict__ offset,
    const T* __restrict__ mask, const T* __restrict__ w,  // (9*C, N)
    const T* __restrict__ gout,      // (B*Ho*Wo, N)
    float* __restrict__ grad_x,      // (B, H, W, C), zeroed
    float* __restrict__ grad_offset, // (B, Ho, Wo, 9, 2)
    float* __restrict__ grad_mask,   // (B, Ho, Wo, 9)
    int H, int W, int C, int Ho, int Wo, int stride, int pad, int N,
    int n_pad, int64_t npix, Vec vec) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int E = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  T* Gs = reinterpret_cast<T*>(smem);  // resident grad_out, BM x n_pad
  T* Ws = Gs + BM * n_pad;             // [2][kBC x KS]
  T* Gt = Ws + 2 * kBC * KS;           // [BM][kGtLd]
  int* s_pix = reinterpret_cast<int*>(Gt + BM * kGtLd);           // [BM][9][4]
  float* s_f = reinterpret_cast<float*>(s_pix + BM * kTaps * 4);  // [BM][9][2]
  float* s_sum = s_f + BM * kTaps * 2;  // [BM][9][3]: the tap sums over chunks

  const int tid = threadIdx.x, wg = tid >> 7;
  const int wm0 = (wg >> 1) * 64, wn0 = (wg & 1) * 32;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int prow = static_cast<int>(min(static_cast<int64_t>(BM), npix - p0));
  if constexpr (kBf16) {
    for (int kb = 0; kb < n_pad / 64; ++kb)
      load_tile<T>(Gs + kb * BM * 64, gout + p0 * N + kb * 64, N, BM, 64, prow,
                   N - kb * 64, vec.g);
  } else {
    load_tile<T>(Gs, gout + p0 * N, N, BM, n_pad, prow, N, vec.g);
  }
  const int nc = (C + kBC - 1) / kBC, nk = n_pad / KS;
  const int total = kTaps * nc * nk;
  auto load_w = [&](int it) {  // bf16: in 64-column blocks
    if (it >= total) return;
    const int u = it / nk, kk = it - u * nk;
    const int ci = u / kTaps, tap = u - ci * kTaps;
    const T* src = w + (static_cast<int64_t>(tap) * C + ci * kBC) * N + kk * KS;
    T* dst = Ws + (it & 1) * kBC * KS;
    const int rows = min(kBC, C - ci * kBC);
    if constexpr (kBf16) {
#pragma unroll
      for (int kb = 0; kb < KS / 64; ++kb)
        load_tile<T>(dst + kb * kBC * 64, src + kb * 64, N, kBC, 64, rows,
                     N - kk * KS - kb * 64, vec.w);
    } else {
      load_tile<T>(dst, src, N, kBC, KS, rows, N - kk * KS, vec.w);
    }
  };
  load_w(0);
  cp_async_commit();
  for (int e = tid; e < BM * kTaps; e += blockDim.x) {
    const int r = e / kTaps;
    if (p0 + r < npix) {
      tap_grad_entry(offset, p0 + r, e - r * kTaps, H, W, Ho, Wo, stride, pad,
                     s_pix + e * 4, s_f + e * 2);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) s_pix[e * 4 + q] = -1;
      s_f[e * 2] = s_f[e * 2 + 1] = 0.f;
    }
    s_sum[e * 3] = s_sum[e * 3 + 1] = s_sum[e * 3 + 2] = 0.f;
  }

  const int sp = tid >> 2, sj = tid & 3;  // the scatter's pixel and quarter
  const int64_t pg = p0 + sp;
  // Units u = ci * 9 + tap run channel-chunk-major, so that the blocks in
  // flight touch one chunk of x and grad_x at a time (a quarter of them
  // at Cin 256: the atomics stay in L2). The scatter of unit u reads G
  // and adds the unit's sums, reduced over the pixel's 4 threads, to the
  // pixel's tap sums in a fixed (chunk) order.
  auto scatter = [&](int u) {
    const int ci = u / kTaps, tap = u - ci * kTaps;
    const int te = sp * kTaps + tap;
    const float m = pg < npix ? to_float(mask[pg * kTaps + tap]) : 0.f;
    float sm = 0.f, sy = 0.f, sx = 0.f;
    if (pg < npix && s_pix[te * 4] + s_pix[te * 4 + 1] + s_pix[te * 4 + 2] +
                             s_pix[te * 4 + 3] != -4)
      scatter_tap(x, grad_x, Gt + sp * kGtLd, s_pix + te * 4,
                  s_f[te * 2], s_f[te * 2 + 1], m, ci * kBC, C, sj, vec.x, sm,
                  sy, sx);
    sm += __shfl_xor_sync(0xffffffffu, sm, 1);
    sm += __shfl_xor_sync(0xffffffffu, sm, 2);
    sy += __shfl_xor_sync(0xffffffffu, sy, 1);
    sy += __shfl_xor_sync(0xffffffffu, sy, 2);
    sx += __shfl_xor_sync(0xffffffffu, sx, 1);
    sx += __shfl_xor_sync(0xffffffffu, sx, 2);
    if (sj == 0) {
      s_sum[te * 3] += sm;
      s_sum[te * 3 + 1] += sy;
      s_sum[te * 3 + 2] += sx;
    }
  };

  float acc[1][4][4] = {};
  float (&flat)[16] = *reinterpret_cast<float(*)[16]>(&acc);
  for (int it = 0; it < total; ++it) {
    cp_async_wait_all();  // stage it's W tile has landed
    if constexpr (kBf16) fence_async_proxy();
    __syncthreads();
    load_w(it + 1);  // into the buffer of stage it - 1, whose MMAs are done
    cp_async_commit();
    const int u = it / nk, kk = it - u * nk;
    const T* wt = Ws + (it & 1) * kBC * KS;
    if constexpr (kBf16) {  // acc += Gs[:, stage kk] . W^T, async
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kb = 0; kb < KS / 64; ++kb) {
        const uint64_t da =
            sw128_desc(Gs + ((kk * KS / 64 + kb) * BM + wm0) * 64, 16);
        const uint64_t db = sw128_desc(wt + (kb * kBC + wn0) * 64, 16);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          wgmma_m64n32k16(flat, da + 2 * k, db + 2 * k);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    } else {
      warp_fma<1, 4>(acc, Gs, kk * KS, n_pad / E, wt, 0, KS / E,
                     wm0 + ((tid >> 5) & 3) * 16, wn0, KS);
    }
    if (kk == 0 && u > 0) scatter(u - 1);  // overlaps the MMAs in flight
    if constexpr (kBf16) {
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(flat[i])::"memory");
    }
    if (kk == nk - 1) {  // G of unit u is complete: to shared memory, once
      __syncthreads();   // the scatter of unit u - 1 has read it
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          Gt[(wm0 + ((tid >> 5) & 3) * 16 + acc_row(0, e)) * kGtLd + wn0 +
             acc_col(ni, e)] = from_float<T>(acc[0][ni][e]);
          acc[0][ni][e] = 0.f;
        }
    }
  }
  __syncthreads();
  scatter(kTaps * nc - 1);
  __syncthreads();
  for (int e = tid; e < BM * kTaps; e += blockDim.x) {
    const int64_t p = p0 + e / kTaps;
    if (p >= npix) continue;
    const int64_t o = p * kTaps + e % kTaps;
    const float m = to_float(mask[o]);
    grad_mask[o] = s_sum[e * 3];
    grad_offset[o * 2] = m * s_sum[e * 3 + 1];
    grad_offset[o * 2 + 1] = m * s_sum[e * 3 + 2];
  }
}

// The corner table of every (tap, pixel) for the weight gradient:
// tap_corners' pixel indices and mask-folded weights, entry k * npix + p.
struct Corners {
  int pix[4];
  float w[4];
};

template <typename T>
__global__ void deform_conv_table_kernel(const T* __restrict__ offset,
                                         const T* __restrict__ mask,
                                         Corners* __restrict__ table, int H,
                                         int W, int Ho, int Wo, int stride,
                                         int pad, int64_t npix) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= kTaps * npix) return;
  const int k = static_cast<int>(i / npix);
  const int64_t p = i - k * npix;
  Corners c;
  tap_corners(tap_raw(offset, mask, p, k), p, k, H, W, Ho, Wo, stride, pad,
              c.pix, c.w);
  table[i] = c;
}

// The weight gradient's block: 64 channels of one tap x 256 output
// channels; warpgroup g owns columns 128 g .. + 127 (bf16: wgmma m64n128,
// fp32: the same ownership in FMAs). Both operands are MN-major in
// 64-column blocks: A^T as [BK pixels][64 channels], grad_out as
// [4][BK][64]. Corners come from the table through a 3-slot cp.async
// ring, two stages ahead.
constexpr int kWM = 64;

// fp32 stage: acc += At^T . B over BK pixels
__device__ __forceinline__ void wgrad_stage_f32(float (&acc)[1][16][4],
                                                const float* At,
                                                const float* Bs) {
  constexpr int BK = Stage<float>::BK, CHN = 64 / 4;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int m0 = tile_m0(), n0 = tile_n0();
#pragma unroll 2
  for (int k = 0; k < BK; ++k) {
    const float a0 = At[swz<float>(k, m0 + g, CHN)];
    const float a1 = At[swz<float>(k, m0 + g + 8, CHN)];
#pragma unroll
    for (int ni = 0; ni < 16; ++ni) {
      const int n = n0 + ni * 8 + 2 * t;  // n, n + 1: one 64-column block
      const float* blk = Bs + (n >> 6) * BK * 64;
      const float b0 = blk[swz<float>(k, n & 63, CHN)];
      const float b1 = blk[swz<float>(k, (n & 63) + 1, CHN)];
      acc[0][ni][0] += a0 * b0;
      acc[0][ni][1] += a0 * b1;
      acc[0][ni][2] += a1 * b0;
      acc[0][ni][3] += a1 * b1;
    }
  }
}

template <typename T>
__host__ __device__ constexpr size_t wgrad_smem() {
  return 2 * (kWM + kBN) * Stage<T>::BK * sizeof(T)      // A^T and B rings
         + 3 * Stage<T>::BK * sizeof(Corners)           // table ring
         + kSmemAlign;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) deform_conv_wgrad_kernel(
    const T* __restrict__ x, const Corners* __restrict__ table,
    const T* __restrict__ gout,      // (B*Ho*Wo, N)
    float* __restrict__ out,         // (9*C, N), or slice blockIdx.y's part
    int C, int N, int64_t npix, int64_t per_slice, int col_tiles, Vec vec) {
  constexpr int BK = Stage<T>::BK, E = 16 / sizeof(T), CH = kWM / E;
  constexpr int NB = kBN / 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  T* At = reinterpret_cast<T*>(smem);  // [2][BK pixels][64 channels]
  T* Bs = At + 2 * BK * kWM;           // [2][NB][BK pixels][64]
  Corners* s_tab = reinterpret_cast<Corners*>(Bs + 2 * NB * BK * 64);  // [3][BK]

  const int tid = threadIdx.x;
  const int rt = blockIdx.x / col_tiles;
  const int n0 = (blockIdx.x - rt * col_tiles) * kBN;
  const int nc = (C + kWM - 1) / kWM, tap = rt / nc, c0 = (rt - tap * nc) * kWM;
  const int64_t pb = static_cast<int64_t>(blockIdx.y) * per_slice;
  const int64_t pe = min(npix, pb + per_slice);
  const int nchunks = static_cast<int>((pe - pb + BK - 1) / BK);
  const Corners* tab = table + tap * npix;

  auto load_table = [&](int chunk) {  // zero entries past the slice
    if (chunk >= nchunks) return;
    const int64_t pc = pb + static_cast<int64_t>(chunk) * BK;
    Corners* dst = s_tab + (chunk % 3) * BK;
    for (int i = tid; i < 2 * BK; i += kThreads) {
      const int r = i >> 1;
      const bool ok = pc + r < pe;
      cp_async16(reinterpret_cast<char*>(dst + r) + 16 * (i & 1),
                 ok ? reinterpret_cast<const char*>(tab + pc + r) + 16 * (i & 1)
                    : reinterpret_cast<const char*>(tab),
                 ok ? 16 : 0);
    }
  };
  ChunkGather<T> gat[2];
  auto gather_load = [&](int chunk) {
    const Corners* slot = s_tab + (chunk % 3) * BK;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = tid + u * kThreads, r = i / CH, ch = i - r * CH;
      gat[u].load(x, slot[r].pix, slot[r].w, c0 + ch * E, C, vec.x);
    }
  };
  auto gather_store = [&](int buf) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = tid + u * kThreads, r = i / CH, ch = i - r * CH;
      gat[u].store(At + buf * BK * kWM + swz<T>(r, ch * E, CH));
    }
  };
  auto load_b = [&](int chunk, int buf) {
    const int64_t pc = pb + static_cast<int64_t>(chunk) * BK;
    const int rows = static_cast<int>(min(static_cast<int64_t>(BK), pe - pc));
#pragma unroll
    for (int a = 0; a < NB; ++a)
      load_tile<T>(Bs + (buf * NB + a) * BK * 64, gout + pc * N + n0 + 64 * a,
                   N, BK, 64, rows, N - n0 - 64 * a, vec.g);
  };
  auto stage = [&](float (&acc)[1][16][4], int buf) {
    const T* a = At + buf * BK * kWM;
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      wg_stage<1>(*reinterpret_cast<float(*)[64]>(&acc), a,
                  Bs + (buf * NB + tile_n0() / 64) * BK * 64,
                  BK * 64 * static_cast<int>(sizeof(T)));
    } else {
      wgrad_stage_f32(acc, a, Bs + buf * NB * BK * 64);
    }
  };

  float acc[1][16][4] = {};
  load_table(0);
  load_table(1);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  load_b(0, 0);
  cp_async_commit();
  gather_load(0);
  gather_store(0);
  cp_async_wait_all();
  block_stage_wait<T>(acc);
  __syncthreads();
  for (int it = 0; it < nchunks; ++it) {
    const int cur = it & 1;
    const bool next = it + 1 < nchunks;
    if (next) {
      load_b(it + 1, cur ^ 1);
      gather_load(it + 1);
    }
    load_table(it + 2);  // the slot chunk it - 1 read, two barriers ago
    cp_async_commit();
    stage(acc, cur);
    if (next) gather_store(cur ^ 1);
    cp_async_wait_all();
    block_stage_wait<T>(acc);
    __syncthreads();
  }

  float* dst = out + blockIdx.y * (static_cast<int64_t>(kTaps) * C * N);
  const int m0 = c0 + tile_m0(), nb = n0 + tile_n0();
#pragma unroll
  for (int ni = 0; ni < 16; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = m0 + acc_row(0, e), n = nb + acc_col(ni, e);
      if (c < C && n < N)
        dst[(static_cast<int64_t>(tap) * C + c) * N + n] = acc[0][ni][e];
    }
}

// grad_w = the sum of the slices' partials, in slice order
__global__ void sum_slices_kernel(const float* __restrict__ partial,
                                  float* __restrict__ out, int slices,
                                  int64_t n) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int q = 0; q < slices; ++q) s += partial[q * n + i];
    out[i] = s;
  }
}

bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

int device_sms() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
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

// The weight gradient's split of the pixels into slices: the fewest
// slices whose (tile, slice) blocks fill the card's resident block slots
// (`resident`, SMs x blocks per SM) to at least 90% in every wave, each
// slice at least 4 stages deep; pixels per slice a multiple of the stage
// depth.
struct Split {
  int tiles, col_tiles, slices;
  int64_t per_slice;
};

Split wgrad_split(int64_t npix, int C, int N, int bk, int resident) {
  Split s;
  s.col_tiles = (N + kBN - 1) / kBN;
  s.tiles = kTaps * ((C + kWM - 1) / kWM) * s.col_tiles;
  const int64_t most = std::max<int64_t>(1, std::min<int64_t>(npix / (4 * bk), 4096));
  double best = -1.0;
  for (int64_t want = 1; want <= most; ++want) {
    const int64_t per = ((npix + want - 1) / want + bk - 1) / bk * bk;
    const int64_t slices = (npix + per - 1) / per;
    const int64_t blocks = s.tiles * slices;
    const int64_t waves = (blocks + resident - 1) / resident;
    const double fill = static_cast<double>(blocks) / (waves * resident);
    if (fill > best + 1e-9) {
      best = fill;
      s.slices = static_cast<int>(slices);
      s.per_slice = per;
    }
    if (blocks >= resident && fill >= 0.9) break;
  }
  return s;
}

// Scratch of the weight gradient: the corner table, then (with more than
// one slice) the slices' partials, each 256-byte aligned.
size_t table_bytes(int64_t npix) {
  return (static_cast<size_t>(kTaps) * npix * sizeof(Corners) + 255) / 256 * 256;
}

size_t workspace_bytes(const Split& s, int64_t npix, int C, int N) {
  return table_bytes(npix) + (s.slices > 1 ? static_cast<size_t>(s.slices) *
                                                 kTaps * C * N * sizeof(float)
                                           : 0);
}

// blocks of the weight-gradient kernel resident on the card at once
template <typename T>
int wgrad_resident(size_t smem) {
  int per_sm = 1;
  if (cudaFuncSetAttribute(deform_conv_wgrad_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, deform_conv_wgrad_kernel<T>, kThreads, smem) != cudaSuccess)
    per_sm = 1;
  return std::max(1, per_sm) * device_sms();
}

template <typename T>
Split wgrad_split_for(int64_t npix, int C, int N) {
  return wgrad_split(npix, C, N, Stage<T>::BK, wgrad_resident<T>(wgrad_smem<T>()));
}

template <typename T>
cudaError_t launch_forward(const void* x, const void* offset, const void* mask,
                           const void* wt, void* out, int B, int H, int W,
                           int C, int Ho, int Wo, int N, int stride, int pad,
                           cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  const int64_t npix = static_cast<int64_t>(B) * Ho * Wo;
  const int n_tiles = (N + kBN - 1) / kBN;
  const int64_t blocks = (npix + kBM - 1) / kBM * n_tiles;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  constexpr size_t smem = ring_bytes<T>() + kTableBytes + kSmemAlign;
  cudaError_t err = check_smem(smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(deform_conv_fwd_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const Vec vec{C % E == 0 && aligned(x, 16), C % E == 0 && aligned(wt, 16),
                false, N % E == 0 && aligned(out, 16)};
  deform_conv_fwd_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem,
                              stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(offset),
      static_cast<const T*>(mask), static_cast<const T*>(wt),
      static_cast<T*>(out), H, W, C, Ho, Wo, stride, pad, N, npix, n_tiles,
      vec);
  return cudaGetLastError();
}

template <typename T, int BM, int KS>
cudaError_t launch_dgrad(const void* x, const void* offset, const void* mask,
                         const void* w, const void* gout, void* grad_x,
                         void* grad_offset, void* grad_mask, int H, int W,
                         int C, int Ho, int Wo, int N, int stride, int pad,
                         int64_t npix, cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  const int n_pad = (N + KS - 1) / KS * KS;
  const size_t smem = dgrad_smem_bytes<T, BM, KS>(n_pad);
  cudaError_t err = check_smem(smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(deform_conv_dgrad_kernel<T, BM, KS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int64_t blocks = (npix + BM - 1) / BM;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const Vec vec{C % 4 == 0 && aligned(x, 4 * sizeof(T)) && aligned(grad_x, 16),
                N % E == 0 && aligned(w, 16), N % E == 0 && aligned(gout, 16),
                false};
  deform_conv_dgrad_kernel<T, BM, KS><<<static_cast<unsigned>(blocks), BM * 4,
                                        smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(offset),
      static_cast<const T*>(mask), static_cast<const T*>(w),
      static_cast<const T*>(gout), static_cast<float*>(grad_x),
      static_cast<float*>(grad_offset), static_cast<float*>(grad_mask), H, W,
      C, Ho, Wo, stride, pad, N, n_pad, npix, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_backward(const void* x, const void* offset,
                            const void* mask, const void* w, const void* gout,
                            void* grad_x, void* grad_offset, void* grad_mask,
                            void* grad_w, void* workspace,
                            long long workspace_size, int B, int H, int W,
                            int C, int Ho, int Wo, int N, int stride, int pad,
                            cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  const int64_t npix = static_cast<int64_t>(B) * Ho * Wo;
  cudaError_t err = cudaMemsetAsync(
      grad_x, 0, static_cast<size_t>(B) * H * W * C * sizeof(float), stream);
  if (err != cudaSuccess) return err;
  // bf16: 128-pixel blocks (half the weight reads of 64) with the widest
  // reduction stage that fits beside the resident grad_out rows, else
  // 64-pixel blocks; fp32: 64 pixels, 64-column stages
  auto fits = [&](size_t bytes) { return check_smem(bytes) == cudaSuccess; };
  auto pad_to = [&](int ks) { return (N + ks - 1) / ks * ks; };
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (fits(dgrad_smem_bytes<T, 128, 256>(pad_to(256))))
      err = launch_dgrad<T, 128, 256>(x, offset, mask, w, gout, grad_x,
                                      grad_offset, grad_mask, H, W, C, Ho, Wo,
                                      N, stride, pad, npix, stream);
    else if (fits(dgrad_smem_bytes<T, 128, 128>(pad_to(128))))
      err = launch_dgrad<T, 128, 128>(x, offset, mask, w, gout, grad_x,
                                      grad_offset, grad_mask, H, W, C, Ho, Wo,
                                      N, stride, pad, npix, stream);
    else if (fits(dgrad_smem_bytes<T, 64, 128>(pad_to(128))))
      err = launch_dgrad<T, 64, 128>(x, offset, mask, w, gout, grad_x,
                                     grad_offset, grad_mask, H, W, C, Ho, Wo,
                                     N, stride, pad, npix, stream);
    else
      err = launch_dgrad<T, 64, 64>(x, offset, mask, w, gout, grad_x,
                                    grad_offset, grad_mask, H, W, C, Ho, Wo, N,
                                    stride, pad, npix, stream);
  } else {
    err = launch_dgrad<T, 64, 64>(x, offset, mask, w, gout, grad_x,
                                  grad_offset, grad_mask, H, W, C, Ho, Wo, N,
                                  stride, pad, npix, stream);
  }
  if (err != cudaSuccess || grad_w == nullptr) return err;

  const Split s = wgrad_split_for<T>(npix, C, N);
  if (workspace_size <
          static_cast<long long>(workspace_bytes(s, npix, C, N)) ||
      s.slices > 65535)
    return cudaErrorInvalidValue;
  Corners* table = static_cast<Corners*>(workspace);
  float* partial = reinterpret_cast<float*>(static_cast<char*>(workspace) +
                                            table_bytes(npix));
  const int64_t entries = kTaps * npix;
  deform_conv_table_kernel<T><<<static_cast<unsigned>((entries + 255) / 256),
                                256, 0, stream>>>(
      static_cast<const T*>(offset), static_cast<const T*>(mask), table, H, W,
      Ho, Wo, stride, pad, npix);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr size_t wsmem = wgrad_smem<T>();
  const Vec wvec{C % E == 0 && aligned(x, 16), false,
                 N % E == 0 && aligned(gout, 16), false};
  deform_conv_wgrad_kernel<T><<<dim3(s.tiles, s.slices), kThreads, wsmem,
                                stream>>>(
      static_cast<const T*>(x), table, static_cast<const T*>(gout),
      s.slices == 1 ? static_cast<float*>(grad_w) : partial, C, N, npix,
      s.per_slice, s.col_tiles, wvec);
  err = cudaGetLastError();
  if (err != cudaSuccess || s.slices == 1) return err;
  const int64_t n = static_cast<int64_t>(kTaps) * C * N;
  sum_slices_kernel<<<static_cast<unsigned>(std::min<int64_t>((n + 255) / 256,
                                                              8 * device_sms())),
                      256, 0, stream>>>(partial, static_cast<float*>(grad_w),
                                        s.slices, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out (B*Ho*Wo, N) = deform_conv2d of x (B, H, W, C) with offset (B, Ho,
// Wo, 9, 2), mask (B, Ho, Wo, 9) and the weight given transposed, wt (N,
// 9*C) with tap-major columns, all in one dtype (0 = float32, 1 =
// bfloat16). One kernel launch. Returns the cudaError_t of the launch (0 =
// success).
int deform_conv_forward(const void* x, const void* offset, const void* mask,
                        const void* wt, void* out, int B, int H, int W, int C,
                        int Ho, int Wo, int N, int stride, int pad, int dtype,
                        void* stream) {
  // empty work launches nothing; the caller skips it, so 0 means launched
  if (static_cast<int64_t>(B) * Ho * Wo == 0 || C == 0 || N == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_forward<float>(x, offset, mask, wt, out, B, H, W, C, Ho, Wo,
                                N, stride, pad, s);
  } else if (dtype == 1) {
    err = launch_forward<__nv_bfloat16>(x, offset, mask, wt, out, B, H, W, C,
                                        Ho, Wo, N, stride, pad, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Bytes of scratch deform_conv_backward needs for the weight gradient's
// corner table and per-slice partials at these sizes.
long long deform_conv_backward_workspace(int B, int Ho, int Wo, int C, int N,
                                         int dtype) {
  const int64_t npix = static_cast<int64_t>(B) * Ho * Wo;
  if (npix == 0 || C == 0 || N == 0) return 0;  // nothing is launched
  const Split s = dtype == 0 ? wgrad_split_for<float>(npix, C, N)
                             : wgrad_split_for<__nv_bfloat16>(npix, C, N);
  return static_cast<long long>(workspace_bytes(s, npix, C, N));
}

// Gradients of deform_conv_forward given grad_out (B*Ho*Wo, N) in x's
// dtype and the weight w (9*C, N): grad_x (B, H, W, C), grad_offset and
// grad_mask, and grad_w (9*C, N) unless it is null, all float32 and fully
// written here. Two kernel launches (one without grad_w) and two memsets.
// workspace: at least deform_conv_backward_workspace(...) bytes. Returns
// the cudaError_t of the launches (0 = success).
int deform_conv_backward(const void* x, const void* offset, const void* mask,
                         const void* w, const void* grad_out, void* grad_x,
                         void* grad_offset, void* grad_mask, void* grad_w,
                         void* workspace, long long workspace_size, int B,
                         int H, int W, int C, int Ho, int Wo, int N,
                         int stride, int pad, int dtype, void* stream) {
  // empty work launches nothing; the caller skips it, so 0 means launched
  if (static_cast<int64_t>(B) * Ho * Wo == 0 || C == 0 || N == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_backward<float>(x, offset, mask, w, grad_out, grad_x,
                                 grad_offset, grad_mask, grad_w, workspace,
                                 workspace_size, B, H, W, C, Ho, Wo, N,
                                 stride, pad, s);
  } else if (dtype == 1) {
    err = launch_backward<__nv_bfloat16>(
        x, offset, mask, w, grad_out, grad_x, grad_offset, grad_mask, grad_w,
        workspace, workspace_size, B, H, W, C, Ho, Wo, N, stride, pad, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
