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
// Backward (msda_backward): the gradients of the same function for value,
// loc and attn. It replaces mmcv's col2im scheme (one warp per (bn, row,
// head) scattering attn * w_corner * grad_out into a zeroed fp32 copy of
// value with fp32 atomics, then a cast to value's dtype: at the flagship's
// shapes a 261 MB buffer written by a memset, by ~30 M atomics and read
// back by the cast, before and after the kernel).
// What bounds it: bytes. grad_value written once, dense, in value's dtype
// (131 MB at the flagship's bf16 shapes), plus the value rows the
// in-image corners touch and the loc, attn, index and grad_out streams:
// about 0.063 ms a call at 3.35 TB/s. What the design does about it: no
// buffer of value's size beside grad_value, no cast pass, no global float
// atomic. Two parts:
//   (a) msda_sample_grad_kernel: grad_attn = grad_out . sample and
//       grad_loc = attn * grad_out . d sample / d(x, y) * (W, H). A warp
//       takes one (bn, row, head), 4 samples at a time, 8 lanes a sample
//       and 4 channels a lane (8-byte bf16 / 16-byte fp32 loads); 3
//       shuffles reduce a sample's sums and one lane writes them. A sample
//       needs its value even where attn is 0 (grad_attn). No atomics.
//   (b) grad_value by tiles: each (bn, head) map is cut, level by level,
//       into tiles whose fp32 accumulators fit in 64 KB of shared memory
//       (512 pixels at hd 32; bands of whole rows where they fit, at least
//       16 bands a level, coarse levels' tiles first). The samples are
//       binned by the tiles their in-image corners land in (a count pass,
//       an exclusive scan in one block, a fill pass; a few MB of 16-byte
//       entries where the fp32 buffer was 261 MB), then one block a tile
//       adds attn * w_corner * grad_out[row, head] of its entries into its
//       shared accumulators and writes the whole tile, zeros included,
//       once in value's dtype. Samples with attn == 0 add nothing and are
//       not binned.
// Determinism: grad_loc and grad_attn are summed in a fixed order and do
// not depend on the launch. grad_value is not deterministic: a tile's
// entries arrive in the fill pass's atomic order and are added with
// shared-memory atomics, so fp32 rounding may differ from run to run (as
// the old global atomics did).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <algorithm>
#include <cstdint>
#include <type_traits>

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

// ---------------------------------------------------------------------
// Backward: the per-sample kernel (grad_loc, grad_attn) and the tile
// kernels (grad_value), described in the head note.

constexpr int kBwdWarps = 8;          // warps per block of the per-sample kernel
constexpr int kGroup = 8;             // lanes per sample, 4 channels each
constexpr int kTileThreads = 256;     // threads per grad_value tile block
constexpr int kTileBytes = 64 * 1024; // fp32 accumulators of one tile
constexpr int kMinTiles = 16;         // row bands a level is cut into, at least
constexpr int kScanThreads = 1024;

// Channels [c, c + n) of a row, n <= 4, as floats (0 past n): one 8-byte
// (bf16) or 16-byte (fp32) load when vec and n == 4.
template <typename T>
__device__ __forceinline__ void load4(const T* __restrict__ p, int n, bool vec,
                                      float (&v)[4]) {
  if (vec && n == 4) {
    if constexpr (std::is_same<T, float>::value) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(p));
      v[0] = f.x;
      v[1] = f.y;
      v[2] = f.z;
      v[3] = f.w;
    } else {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
      const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
      const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
      v[0] = __low2float(lo);
      v[1] = __high2float(lo);
      v[2] = __low2float(hi);
      v[3] = __high2float(hi);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = e < n ? to_float(p[e]) : 0.f;
  }
}

template <typename T>
__device__ __forceinline__ void store4(T* __restrict__ p, const float* v,
                                       int n, bool vec) {
  if (vec && n == 4) {
    const float4 f = *reinterpret_cast<const float4*>(v);
    if constexpr (std::is_same<T, float>::value) {
      *reinterpret_cast<float4*>(p) = f;
    } else {
      __nv_bfloat162 lo = __floats2bfloat162_rn(f.x, f.y);
      __nv_bfloat162 hi = __floats2bfloat162_rn(f.z, f.w);
      uint2 u;
      u.x = *reinterpret_cast<const unsigned*>(&lo);
      u.y = *reinterpret_cast<const unsigned*>(&hi);
      *reinterpret_cast<uint2*>(p) = u;
    }
  } else {
    for (int e = 0; e < n; ++e) p[e] = from_float<T>(v[e]);
  }
}

// (a) grad_attn = grad_out . sample and grad_loc = attn * grad_out .
// d sample / d(x, y) * (W, H), per sample. A warp takes one (bn, row,
// head); its 4 groups of 8 lanes take 4 of the head's L*P samples at a
// time, a lane 4 channels (c = 4j, 4j + 32, ...). Each sample's 4 corner
// loads are issued before any use; its sums are reduced over the group's
// 8 lanes by 3 shuffles and written by the group's lane 0. The gathers
// are latency-bound: capped at 64 registers a thread (4 blocks an SM) the
// kernel hides them better than at the 112 it would take uncapped. No
// atomics: the result does not depend on the order the blocks run in.
template <typename T>
__global__ void __launch_bounds__(kBwdWarps * 32, 4) msda_sample_grad_kernel(
    const T* __restrict__ value,         // (BN, S, heads, hd)
    const float* __restrict__ loc,       // (BN, Q, heads, L, P, 2)
    const float* __restrict__ attn,      // (BN, Q, heads, L, P)
    const int64_t* __restrict__ index,   // (BN, R) or nullptr
    const T* __restrict__ grad_out,      // (BN, R, heads * hd)
    float* __restrict__ grad_loc,        // (BN, Q, heads, L, P, 2), zeroed
    float* __restrict__ grad_attn,       // (BN, Q, heads, L, P), zeroed
    int BN, int S, int Q, int R, int heads, int hd, int L, int P, Levels lv,
    bool vec) {
  const int lane = threadIdx.x & 31, grp = lane >> 3, j = lane & (kGroup - 1);
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
  const int64_t src0 = ((static_cast<int64_t>(bn) * Q + q) * heads + h) * LP;

  for (int lp0 = 0; lp0 < LP; lp0 += 4) {  // the same trip count in all lanes
    const int lp = lp0 + grp;
    float s_attn = 0.f, s_x = 0.f, s_y = 0.f, a = 0.f;
    int H = 0, W = 0;
    bool in = false;
    const int64_t src = src0 + lp;
    if (lp < LP) {
      const int l = lp / P;
      a = attn[src];
      H = lv.h[l];
      W = lv.w[l];
      const float x = loc[2 * src] * W - 0.5f;
      const float y = loc[2 * src + 1] * H - 0.5f;
      // written so that NaN and far-away samples fall through to no gradient
      in = x > -1.f && x < static_cast<float>(W) && y > -1.f &&
           y < static_cast<float>(H);
      if (in) {
        const float x0f = floorf(x), y0f = floorf(y);
        const int x0 = static_cast<int>(x0f), y0 = static_cast<int>(y0f);
        const float fx = x - x0f, fy = y - y0f;
        int64_t rows[4];  // element offset of the corner's row, -1 outside
        float w[4], dwx[4], dwy[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int dy = k >> 1, dx = k & 1;
          const int yy = y0 + dy, xx = x0 + dx;
          const bool ok = yy >= 0 && yy < H && xx >= 0 && xx < W;
          const float wy = dy ? fy : 1.f - fy, wx = dx ? fx : 1.f - fx;
          w[k] = ok ? wy * wx : 0.f;
          dwx[k] = ok ? wy * (dx ? 1.f : -1.f) : 0.f;
          dwy[k] = ok ? wx * (dy ? 1.f : -1.f) : 0.f;
          rows[k] = ok ? static_cast<int64_t>(lv.start[l] + yy * W + xx) * C : -1;
        }
        for (int c0 = 4 * j; c0 < hd; c0 += 4 * kGroup) {
          const int n = min(4, hd - c0);
          float g[4], v[4][4];
          load4(go + c0, n, vec, g);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (rows[k] >= 0) {
              load4(vbase + rows[k] + c0, n, vec, v[k]);
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e) v[k][e] = 0.f;
            }
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float sample = 0.f, dsx = 0.f, dsy = 0.f;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              sample += w[k] * v[k][e];
              dsx += dwx[k] * v[k][e];
              dsy += dwy[k] * v[k][e];
            }
            s_attn += g[e] * sample;
            s_x += g[e] * dsx;
            s_y += g[e] * dsy;
          }
        }
      }
    }
#pragma unroll
    for (int off = 1; off < kGroup; off <<= 1) {
      s_attn += __shfl_xor_sync(0xffffffffu, s_attn, off);
      s_x += __shfl_xor_sync(0xffffffffu, s_x, off);
      s_y += __shfl_xor_sync(0xffffffffu, s_y, off);
    }
    if (in && j == 0) {
      grad_attn[src] = s_attn;
      grad_loc[2 * src] = a * s_x * W;
      grad_loc[2 * src + 1] = a * s_y * H;
    }
  }
}

// (b) grad_value. Each (bn, head) value map is cut, level by level, into
// tiles of th x tw pixels whose fp32 accumulators fit in kTileBytes of
// shared memory (hd 32: 512 pixels), in bands of whole rows where they fit
// and in at least kMinTiles bands a level: every level takes about as many
// samples, so a coarse level's pixels take many more each, and thinner
// bands there keep the tiles' work alike (the flagship's levels give 40 +
// 14 + 10 + 10 tiles). Tiles are numbered coarsest level first, within a
// map and across maps (bin = tile * maps + map), so that the tiles with
// the most samples a pixel start first. first[l] and count[l]: level l's
// tiles within a map; per_map: the tiles of a map.
struct Tiling {
  int th[kMaxLevels];
  int tw[kMaxLevels];
  int nx[kMaxLevels];
  int first[kMaxLevels];
  int count[kMaxLevels];
  int per_map;
};

// One (sample, tile) pair of the bins: the sample's position in pixels of
// its level, its attention weight and its grad_out row bn * R + r.
struct __align__(16) Entry {
  float x, y, a;
  int br;
};

// Sample i of the (bn, row, head, level, point) enumeration: its grad_out
// row, head, level and flat index into loc / attn.
struct SampleRef {
  int64_t br, src;
  int bn, h, l;
};

__device__ __forceinline__ SampleRef sample_ref(int64_t i,
                                                const int64_t* __restrict__ index,
                                                int Q, int R, int heads,
                                                int L, int P) {
  const int LP = L * P;
  SampleRef s;
  const int lp = static_cast<int>(i % LP);
  const int64_t rest = i / LP;
  s.h = static_cast<int>(rest % heads);
  s.br = rest / heads;
  s.bn = static_cast<int>(s.br / R);
  s.l = lp / P;
  const int64_t q = index ? index[s.br] : (s.br - static_cast<int64_t>(s.bn) * R);
  s.src = ((static_cast<int64_t>(s.bn) * Q + q) * heads + s.h) * LP + lp;
  return s;
}

// The tiles (within its map) that a sample at pixel position (x, y) of
// level l adds to: the distinct tiles of its in-image corners of nonzero
// bilinear weight. Returns their count (at most 4). The count and fill
// passes call it on the same inputs, so they agree bit for bit.
__device__ __forceinline__ int sample_tiles(float x, float y, int l,
                                            const Levels& lv,
                                            const Tiling& tl, int (&t)[4]) {
  const int H = lv.h[l], W = lv.w[l];
  if (!(x > -1.f && x < static_cast<float>(W) && y > -1.f &&
        y < static_cast<float>(H)))
    return 0;
  const float x0f = floorf(x), y0f = floorf(y);
  const int x0 = static_cast<int>(x0f), y0 = static_cast<int>(y0f);
  const float fx = x - x0f, fy = y - y0f;
  int n = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int dy = k >> 1, dx = k & 1;
    const int yy = y0 + dy, xx = x0 + dx;
    const float w = (dy ? fy : 1.f - fy) * (dx ? fx : 1.f - fx);
    if (yy < 0 || yy >= H || xx < 0 || xx >= W || w == 0.f) continue;
    const int id = tl.first[l] + (yy / tl.th[l]) * tl.nx[l] + xx / tl.tw[l];
    bool seen = false;
    for (int m = 0; m < n; ++m) seen |= t[m] == id;
    if (!seen) t[n++] = id;
  }
  return n;
}

// Binning, pass 1 (FILL false): count each tile's (sample, tile) pairs;
// pass 2 (FILL true): write each pair's Entry at its tile's cursor. A
// thread per sample; samples with attn == 0 add nothing to grad_value and
// are left out.
template <bool FILL>
__global__ void msda_bin_kernel(const float* __restrict__ loc,
                                const float* __restrict__ attn,
                                const int64_t* __restrict__ index,
                                int* __restrict__ counts,  // or cursors
                                Entry* __restrict__ entries, int64_t n,
                                int maps, int Q, int R, int heads, int L,
                                int P, Levels lv, Tiling tl) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const SampleRef s = sample_ref(i, index, Q, R, heads, L, P);
  const float a = attn[s.src];
  if (a == 0.f) return;  // a NaN weight goes on, as in the forward's sum
  const float x = loc[2 * s.src] * lv.w[s.l] - 0.5f;
  const float y = loc[2 * s.src + 1] * lv.h[s.l] - 0.5f;
  int t[4];
  const int nt = sample_tiles(x, y, s.l, lv, tl, t);
  int* bins = counts + static_cast<int64_t>(s.bn) * heads + s.h;
  for (int m = 0; m < nt; ++m) {
    const int pos = atomicAdd(bins + static_cast<int64_t>(t[m]) * maps, 1);
    if constexpr (FILL) entries[pos] = Entry{x, y, a, static_cast<int>(s.br)};
  }
}

// offsets[i] = cursor[i] = sum of counts[0 .. i), offsets[n] = the total.
// One block.
__global__ void __launch_bounds__(kScanThreads) exclusive_scan_kernel(
    const int* __restrict__ counts, int* __restrict__ offsets,
    int* __restrict__ cursor, int n) {
  __shared__ int s_warp[kScanThreads / 32];
  __shared__ int s_carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_carry = 0;
  for (int base = 0; base < n; base += kScanThreads) {
    const int i = base + threadIdx.x;
    const int v = i < n ? counts[i] : 0;
    int incl = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int wv = s_warp[lane];
      int wi = wv;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, wi, off);
        if (lane >= off) wi += y;
      }
      s_warp[lane] = wi - wv;  // exclusive over the warps
    }
    __syncthreads();
    const int excl = s_carry + s_warp[warp] + incl - v;
    if (i < n) {
      offsets[i] = excl;
      cursor[i] = excl;
    }
    __syncthreads();  // every thread has read s_carry and s_warp
    if (threadIdx.x == kScanThreads - 1) s_carry = excl + v;
    __syncthreads();
  }
  if (threadIdx.x == 0) offsets[n] = s_carry;
}

// grad_value of one tile: a block zeroes the tile's fp32 accumulators in
// shared memory, adds attn * w_corner * grad_out[row, head] for every
// in-tile corner of its bin's entries (8 lanes an entry, 4 channels a
// lane, shared-memory float atomics; each lane starts its 4 channels at
// another offset, so that the 4 entries of a warp hit distinct banks; the
// next entry is loaded while this one is added), then writes the whole
// tile, zeros included, once in value's dtype.
template <typename T>
__global__ void __launch_bounds__(kTileThreads) msda_value_grad_kernel(
    const Entry* __restrict__ entries, const int* __restrict__ offsets,
    const T* __restrict__ grad_out,  // (BN, R, heads * hd)
    T* __restrict__ grad_value,      // (BN, S, heads, hd)
    int S, int heads, int hd, int L, Levels lv, Tiling tl, bool vec) {
  extern __shared__ float4 s_acc4[];
  float* s_acc = reinterpret_cast<float*>(s_acc4);  // [tile pixels][hd]
  const int maps = gridDim.x / tl.per_map;
  const int t = blockIdx.x;  // local * maps + bn * heads + h
  const int local = t / maps, bh = t - local * maps;
  const int bn = bh / heads, h = bh - bn * heads;
  int l = 0;
  for (int m = 0; m < L; ++m)
    if (local >= tl.first[m] && local < tl.first[m] + tl.count[m]) l = m;
  const int W = lv.w[l];
  const int k = local - tl.first[l], ty = k / tl.nx[l], tx = k - ty * tl.nx[l];
  const int y_lo = ty * tl.th[l], x_lo = tx * tl.tw[l];
  const int rows = min(tl.th[l], lv.h[l] - y_lo), cols = min(tl.tw[l], W - x_lo);
  const int npx = rows * cols;
  for (int i = threadIdx.x; i < npx * hd; i += kTileThreads) s_acc[i] = 0.f;
  __syncthreads();

  const int C = heads * hd;
  const int j = threadIdx.x & (kGroup - 1), rot = (threadIdx.x >> 3) & 3;
  constexpr int kStride = kTileThreads / kGroup;
  const int end = offsets[t + 1];
  int e = offsets[t] + (threadIdx.x >> 3);
  Entry next = e < end ? entries[e] : Entry{};
  for (; e < end; e += kStride) {
    const Entry en = next;  // the one after it is in flight meanwhile
    if (e + kStride < end) next = entries[e + kStride];
    const float x0f = floorf(en.x), y0f = floorf(en.y);
    const int x0 = static_cast<int>(x0f) - x_lo, y0 = static_cast<int>(y0f) - y_lo;
    const float fx = en.x - x0f, fy = en.y - y0f;
    int px[4];  // the corner's pixel in the tile, -1 outside it
    float aw[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int dy = q >> 1, dx = q & 1;
      const int yy = y0 + dy, xx = x0 + dx;
      const float w = (dy ? fy : 1.f - fy) * (dx ? fx : 1.f - fx);
      px[q] = (yy >= 0 && yy < rows && xx >= 0 && xx < cols && w != 0.f)
                  ? yy * cols + xx : -1;
      aw[q] = en.a * w;
    }
    const T* go = grad_out + static_cast<int64_t>(en.br) * C + h * hd;
    for (int c0 = 4 * j; c0 < hd; c0 += 4 * kGroup) {
      const int n = min(4, hd - c0);
      float g[4];
      load4(go + c0, n, vec, g);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int e4 = (s + rot) & 3;
        const float ge = e4 == 0 ? g[0] : e4 == 1 ? g[1] : e4 == 2 ? g[2] : g[3];
        if (e4 >= n) continue;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (px[q] >= 0) atomicAdd(s_acc + px[q] * hd + c0 + e4, aw[q] * ge);
      }
    }
  }
  __syncthreads();

  T* gv = grad_value + (static_cast<int64_t>(bn) * S + lv.start[l]) * C + h * hd;
  const int nch = (hd + 3) / 4;
  for (int i = threadIdx.x; i < npx * nch; i += kTileThreads) {
    const int p = i / nch, c0 = (i - p * nch) * 4;
    const int yy = y_lo + p / cols, xx = x_lo + p % cols;
    store4(gv + static_cast<int64_t>(yy * W + xx) * C + c0, s_acc + p * hd + c0,
           min(4, hd - c0), vec);
  }
}

// The backward's plan: the tiling and the workspace it needs (the bins'
// counts, offsets and cursors, then room for every (sample, tile) pair the
// samples could form: 1, 2 or 4 tiles a sample, as a level is cut in
// neither, one or both directions).
struct Plan {
  Tiling tl;
  int64_t n_tiles, capacity;
  size_t smem;
  size_t bytes() const {
    const size_t ints = (3 * n_tiles + 1) * sizeof(int);
    return (ints + 15) / 16 * 16 + capacity * sizeof(Entry);
  }
};

bool make_plan(const Levels& lv, int L, int BN, int R, int heads, int hd,
               int P, Plan* plan) {
  const int tile_px = kTileBytes / (hd * static_cast<int>(sizeof(float)));
  if (hd < 1 || tile_px < 1) return false;
  Tiling& tl = plan->tl;
  int next = 0;
  int64_t per_sample = 0;  // sum over levels of a sample's most tiles
  plan->smem = sizeof(float4);
  for (int l = L - 1; l >= 0; --l) {  // coarsest level first
    const int H = lv.h[l], W = lv.w[l];
    tl.first[l] = next;
    tl.count[l] = 0;
    if (H <= 0 || W <= 0) {  // no pixel, no sample inside
      tl.th[l] = tl.tw[l] = tl.nx[l] = 1;
      continue;
    }
    tl.tw[l] = std::min(W, tile_px);
    tl.th[l] = std::max(1, std::min({H, tile_px / tl.tw[l],
                                     (H + kMinTiles - 1) / kMinTiles}));
    tl.nx[l] = (W + tl.tw[l] - 1) / tl.tw[l];
    const int ny = (H + tl.th[l] - 1) / tl.th[l];
    tl.count[l] = tl.nx[l] * ny;
    next += tl.count[l];
    per_sample += (tl.nx[l] > 1 ? 2 : 1) * (ny > 1 ? 2 : 1);
    plan->smem = std::max(plan->smem, static_cast<size_t>(tl.th[l]) * tl.tw[l] *
                                          hd * sizeof(float));
  }
  tl.per_map = next;
  plan->n_tiles = static_cast<int64_t>(BN) * heads * next;
  plan->capacity = static_cast<int64_t>(BN) * R * heads * P * per_sample;
  return plan->n_tiles < 0x7fffffff && plan->capacity < 0x7fffffff;
}

template <typename T>
cudaError_t launch_backward(const void* value, const void* loc,
                            const void* attn, const void* index,
                            const void* grad_out, void* grad_value,
                            void* grad_loc, void* grad_attn, void* workspace,
                            const Plan& plan, int BN, int S, int Q, int R,
                            int heads, int hd, int L, int P, const Levels& lv,
                            cudaStream_t stream) {
  const int64_t* idx = static_cast<const int64_t*>(index);
  const bool vec =
      hd % 4 == 0 &&
      reinterpret_cast<uintptr_t>(value) % (4 * sizeof(T)) == 0 &&
      reinterpret_cast<uintptr_t>(grad_out) % (4 * sizeof(T)) == 0 &&
      reinterpret_cast<uintptr_t>(grad_value) % (4 * sizeof(T)) == 0;
  cudaError_t err;
  if (plan.n_tiles > 0) {
    int* counts = static_cast<int*>(workspace);
    int* offsets = counts + plan.n_tiles;
    int* cursor = offsets + plan.n_tiles + 1;
    Entry* entries = reinterpret_cast<Entry*>(
        static_cast<char*>(workspace) +
        (plan.bytes() - plan.capacity * sizeof(Entry)));
    err = cudaMemsetAsync(counts, 0, plan.n_tiles * sizeof(int), stream);
    if (err != cudaSuccess) return err;
    const int64_t n = static_cast<int64_t>(BN) * R * heads * L * P;
    const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
    msda_bin_kernel<false><<<blocks, 256, 0, stream>>>(
        static_cast<const float*>(loc), static_cast<const float*>(attn), idx,
        counts, nullptr, n, BN * heads, Q, R, heads, L, P, lv, plan.tl);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    exclusive_scan_kernel<<<1, kScanThreads, 0, stream>>>(
        counts, offsets, cursor, static_cast<int>(plan.n_tiles));
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    msda_bin_kernel<true><<<blocks, 256, 0, stream>>>(
        static_cast<const float*>(loc), static_cast<const float*>(attn), idx,
        cursor, entries, n, BN * heads, Q, R, heads, L, P, lv, plan.tl);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(msda_value_grad_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(plan.smem));
    if (err != cudaSuccess) return err;
    msda_value_grad_kernel<T><<<static_cast<unsigned>(plan.n_tiles),
                                kTileThreads, plan.smem, stream>>>(
        entries, offsets, static_cast<const T*>(grad_out),
        static_cast<T*>(grad_value), S, heads, hd, L, lv, plan.tl, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int64_t items = static_cast<int64_t>(BN) * R * heads;
  const int64_t blocks = (items + kBwdWarps - 1) / kBwdWarps;
  msda_sample_grad_kernel<T><<<static_cast<unsigned>(blocks), kBwdWarps * 32,
                               0, stream>>>(
      static_cast<const T*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(attn), idx, static_cast<const T*>(grad_out),
      static_cast<float*>(grad_loc), static_cast<float*>(grad_attn), BN, S, Q,
      R, heads, hd, L, P, lv, vec);
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

// Bytes of workspace msda_backward needs at these sizes (0 where it
// refuses them: hd beyond the tile's shared memory, or more bins than an
// int counts).
long long msda_backward_workspace(int BN, int S, int R, int heads, int hd,
                                  int L, int P, const int* level_hw) {
  Levels lv;
  Plan plan;
  if (!make_levels(level_hw, L, S, &lv) ||
      !make_plan(lv, L, BN, R, heads, hd, P, &plan))
    return 0;
  return static_cast<long long>(plan.bytes());
}

// Gradients of msda_forward for value, loc and attn, given grad_out
// (BN, R, heads * hd) in value's dtype. grad_value (BN, S, heads, hd) in
// value's dtype is fully written here; grad_loc and grad_attn, float32 in
// the shapes of loc and attn, must be zeroed by the caller. With an index
// list, row r of bn writes grad_loc / grad_attn at query index[bn, r]; the
// indices of a row must be distinct. workspace: at least
// msda_backward_workspace(...) bytes. Five kernel launches and a memset.
// Returns the cudaError_t of the launches (0 = success).
int msda_backward(const void* value, const void* loc, const void* attn,
                  const void* index, const void* grad_out, void* grad_value,
                  void* grad_loc, void* grad_attn, void* workspace,
                  long long workspace_size, int BN, int S, int Q, int R,
                  int heads, int hd, int L, int P, const int* level_hw,
                  int dtype, void* stream) {
  // empty work launches nothing; the caller skips it, so 0 means launched
  if (R == 0 || BN == 0 || heads == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Levels lv;
  Plan plan;
  if (!make_levels(level_hw, L, S, &lv) ||
      !make_plan(lv, L, BN, R, heads, hd, P, &plan) ||
      workspace_size < static_cast<long long>(plan.bytes()))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_backward<float>(value, loc, attn, index, grad_out,
                                 grad_value, grad_loc, grad_attn, workspace,
                                 plan, BN, S, Q, R, heads, hd, L, P, lv, s);
  } else if (dtype == 1) {
    err = launch_backward<__nv_bfloat16>(
        value, loc, attn, index, grad_out, grad_value, grad_loc, grad_attn,
        workspace, plan, BN, S, Q, R, heads, hd, L, P, lv, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
