// K5: sigmoid focal loss with its gradient, every decoder layer in one
// launch. Hand-written for sm_90a.
//
// Replaces graph_detr4d_tpu/ops/focal_loss.py::sigmoid_focal_loss as
// core/losses.py vmaps it over the decoder layers. For layer l, query n
// and class c, with t = (label[l, n] == c) (label C is background) and
// x = logits[l, n, c]:
//   p    = sigmoid(x)
//   bce  = max(x, 0) - x * t + log1p(exp(-|x|))
//   q    = t ? 1 - p : p                       (= 1 - p_t)
//   loss = alpha_t * q^gamma * bce * weight[l, n]
//   loss_sum[l] = sum_{n, c} loss / avg_factor[l]
// and, in the same pass, d loss_sum[l] / d x:
//   alpha_t * (gamma * q^(gamma - 1) * dq/dx * bce + q^gamma * (p - t))
//   * weight / avg_factor,   dq/dx = (t ? -1 : 1) * p * (1 - p).
//
// What bounds it: latency, not bytes or operations. The work is 6 x 900 x
// 10 logits, a few hundred kilobytes (0.15 us at the card's memory rate),
// so its time is the launch, the dependent loads and the reduction's
// critical path; the host's time to issue a call exceeds all of them. So
// the work is spread over the card: a block takes kRows query rows of one
// layer (15 blocks a layer at 900 queries), a thread a row of C classes
// (its label and weight loaded once, its logits kChunk at a time, all
// loads issued before the math), gamma = 2 squares instead of powf, and
// exp(-|x|) gives both sigmoid and the log term. The sum is
// deterministic across blocks: each block writes its fixed-order partial,
// and the last block to finish (a fence, then a ticket) adds each layer's
// partials in tile order and resets the ticket for the next call.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kRows = 64;   // query rows (threads) a block
constexpr int kChunk = 16;  // logits a thread loads at once

template <bool kGamma2>
__global__ void __launch_bounds__(kRows) focal_loss_kernel(
    const float* __restrict__ logits, const int64_t* __restrict__ labels,
    const float* __restrict__ weights, const float* __restrict__ avg_factor,
    float* __restrict__ loss, float* __restrict__ grad,
    unsigned* __restrict__ ticket, float* __restrict__ partials, int N, int C,
    float alpha, float gamma) {
  const int l = blockIdx.y, tiles = gridDim.x;
  const int n = blockIdx.x * kRows + threadIdx.x;
  const float inv_avg = 1.f / avg_factor[l];
  float acc = 0.f;
  if (n < N) {
    const int64_t row = static_cast<int64_t>(l) * N + n;
    const int64_t label = labels[row];
    const float w = weights[row];
    const float* x_row = logits + row * C;
    float* g_row = grad + row * C;
    for (int c0 = 0; c0 < C; c0 += kChunk) {
      float xs[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) xs[j] = c0 + j < C ? x_row[c0 + j] : 0.f;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (c0 + j >= C) break;
        const float x = xs[j];
        const bool t = label == c0 + j;
        const float e = expf(-fabsf(x));
        const float r = 1.f / (1.f + e);
        const float p = x >= 0.f ? r : e * r;
        const float bce = fmaxf(x, 0.f) - (t ? x : 0.f) + log1pf(e);
        const float q = t ? 1.f - p : p;
        const float a = t ? alpha : 1.f - alpha;
        // q^gamma and its derivative gamma * q^(gamma - 1)
        const float qg = kGamma2 ? q * q : powf(q, gamma);
        const float dqg = kGamma2 ? 2.f * q : gamma * powf(q, gamma - 1.f);
        acc += a * qg * bce * w;
        const float dq = (t ? -1.f : 1.f) * p * (1.f - p);
        g_row[c0 + j] =
            a * (dqg * dq * bce + qg * (p - (t ? 1.f : 0.f))) * w * inv_avg;
      }
    }
  }
  // the block's partial: a fixed tree in each warp, then the warps in order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  __shared__ float warp_sums[kRows / 32];
  __shared__ bool last;
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int i = 0; i < kRows / 32; ++i) s += warp_sums[i];
    partials[static_cast<int64_t>(l) * tiles + blockIdx.x] = s;
    __threadfence();  // the partial is visible before the ticket is taken
    last = atomicAdd(ticket, 1u) == gridDim.x * gridDim.y - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block: every layer's partials in tile order
  __threadfence();
  for (int layer = threadIdx.x; layer < gridDim.y; layer += kRows) {
    float s = 0.f;
    for (int i = 0; i < tiles; ++i)
      s += __ldcg(partials + static_cast<int64_t>(layer) * tiles + i);
    loss[layer] = s * (1.f / avg_factor[layer]);
  }
  if (threadIdx.x == 0) *ticket = 0u;  // ready for the next call
}

}  // namespace

extern "C" {

// The scratch a call needs: the ticket (one uint32) and layers *
// ceil(N / kRows) float partials, in bytes after the ticket's 16.
int64_t focal_loss_scratch_bytes(int layers, int N) {
  const int64_t tiles = N > 0 ? (static_cast<int64_t>(N) + kRows - 1) / kRows : 1;
  return 16 + 4 * static_cast<int64_t>(layers) * tiles;
}

// logits (layers, N, C) float32; labels (layers, N) int64 in [0, C];
// weights (layers, N) and avg_factor (layers,) float32. Writes loss
// (layers,) and grad (layers, N, C), float32, every element. scratch:
// focal_loss_scratch_bytes(layers, N) bytes, its first uint32 (the
// ticket) 0 before the first call; each call leaves it 0. Calls that share
// a scratch must not run concurrently. Returns the cudaError_t of the
// launch (0 = success).
int focal_loss(const void* logits, const void* labels, const void* weights,
               const void* avg_factor, void* loss, void* grad, void* scratch,
               int layers, int N, int C, float alpha, float gamma,
               void* stream) {
  // empty work launches nothing; the caller skips it, so 0 means launched
  if (layers <= 0 || layers > 65535 || N < 0 || C <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(N > 0 ? (N + kRows - 1) / kRows : 1, layers);
  auto* ticket = static_cast<unsigned*>(scratch);
  auto* partials = reinterpret_cast<float*>(static_cast<char*>(scratch) + 16);
  auto kernel = gamma == 2.f ? focal_loss_kernel<true> : focal_loss_kernel<false>;
  kernel<<<grid, kRows, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const int64_t*>(labels),
      static_cast<const float*>(weights),
      static_cast<const float*>(avg_factor), static_cast<float*>(loss),
      static_cast<float*>(grad), ticket, partials, N, C, alpha, gamma);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
