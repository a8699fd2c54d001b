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
// What bounds it: nothing on this card. The work is 6 x 900 x 10 logits,
// a few hundred kilobytes, so the launch and one block's serial
// reduction set its time (latency). The design keeps it to one launch and
// makes the sums deterministic: one block per layer, each thread sums a
// fixed stride of elements, then a fixed-shape tree in shared memory.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 512;

__global__ void focal_loss_kernel(const float* __restrict__ logits,
                                  const int64_t* __restrict__ labels,
                                  const float* __restrict__ weights,
                                  const float* __restrict__ avg_factor,
                                  float* __restrict__ loss,
                                  float* __restrict__ grad, int N, int C,
                                  float alpha, float gamma) {
  __shared__ float partial[kThreads];
  const int l = blockIdx.x;
  const int64_t base = static_cast<int64_t>(l) * N * C;
  const float inv_avg = 1.f / avg_factor[l];
  float acc = 0.f;
  for (int64_t e = threadIdx.x; e < static_cast<int64_t>(N) * C;
       e += kThreads) {
    const int n = static_cast<int>(e / C);
    const int c = static_cast<int>(e - static_cast<int64_t>(n) * C);
    const float x = logits[base + e];
    const bool t = labels[static_cast<int64_t>(l) * N + n] == c;
    const float w = weights[static_cast<int64_t>(l) * N + n];
    const float p = 1.f / (1.f + expf(-x));
    const float bce = fmaxf(x, 0.f) - (t ? x : 0.f) + log1pf(expf(-fabsf(x)));
    const float q = t ? 1.f - p : p;
    const float a = t ? alpha : 1.f - alpha;
    const float qg = powf(q, gamma);
    acc += a * qg * bce * w;
    const float dq = (t ? -1.f : 1.f) * p * (1.f - p);
    grad[base + e] =
        a * (gamma * powf(q, gamma - 1.f) * dq * bce + qg * (p - (t ? 1.f : 0.f))) *
        w * inv_avg;
  }
  partial[threadIdx.x] = acc;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) partial[threadIdx.x] += partial[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) loss[l] = partial[0] * inv_avg;
}

}  // namespace

extern "C" {

// logits (layers, N, C) float32; labels (layers, N) int64 in [0, C];
// weights (layers, N) and avg_factor (layers,) float32. Writes loss
// (layers,) and grad (layers, N, C), float32. Returns the cudaError_t of
// the launch (0 = success).
int focal_loss(const void* logits, const void* labels, const void* weights,
               const void* avg_factor, void* loss, void* grad, int layers,
               int N, int C, float alpha, float gamma, void* stream) {
  // empty work launches nothing; the caller skips it, so 0 means launched
  if (layers == 0) return static_cast<int>(cudaErrorInvalidValue);
  focal_loss_kernel<<<layers, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const int64_t*>(labels),
      static_cast<const float*>(weights),
      static_cast<const float*>(avg_factor), static_cast<float*>(loss),
      static_cast<float*>(grad), N, C, alpha, gamma);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
