// K4: exact rectangular linear-sum assignment, a batch of problems in one
// launch. Hand-written for sm_90a.
//
// Replaces graph_detr4d_tpu/ops/hungarian.py::hungarian_assignment (and
// its `_solve_row`), as core/losses.py vmaps it over decoder layers and
// images. The same Jonker-Volgenant shortest-augmenting-path algorithm,
// step for step, so that it assigns exactly as the JAX op does:
//   * for each of the first min(num_valid, R) rows, a Dijkstra search over
//     the columns with reduced costs min_val + cost[i, j] - u[i] - v[j],
//     each step taking the unscanned column of least path cost, ties to
//     the lowest column index (jnp.argmin's rule), until it reaches an
//     unassigned column; then the dual updates and the augmentation;
//   * nan and +inf costs count as 100, -inf as -100 (the reference's clamp
//     before scipy); rows past num_valid stay unsolved (-1).
// The float arithmetic is the JAX op's, in its order, so the two agree bit
// for bit on the reduced costs and hence on every choice.
//
// Layout: one thread block per problem; the threads own columns (thread t
// the columns t, t + blockDim, ...). Per-column state (v, path costs,
// predecessors, row4col, scanned flags) and per-row state (u, col4row,
// scanned flags) live in shared memory; each Dijkstra step reads one cost
// row and ends in a block-wide argmin (warp shuffles, then one warp over
// the warps' results). The augmentation walks the predecessor chain on one
// thread.
//
// What bounds it: latency. A Dijkstra step moves C floats and needs three
// block barriers; the steps of one problem are strictly sequential, so the
// time is the number of steps times the latency of one step, far above
// what the bytes (about C * 4 per step) would take at the card's bandwidth.
// The batch of problems runs in parallel, one per SM, which is what the
// design can do about it. There is no host sync: num_valid is read on the
// device.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr float kInf = 1e18f;  // the JAX op's _INF

__device__ __forceinline__ float clamp_cost(float c) {
  if (isnan(c)) return 100.f;
  if (isinf(c)) return c > 0.f ? 100.f : -100.f;
  return c;
}

__global__ void lsa_kernel(const float* __restrict__ cost,
                           const int* __restrict__ num_valid,
                           int* __restrict__ col4row_out, int R, int C) {
  extern __shared__ unsigned char smem[];
  float* v = reinterpret_cast<float*>(smem);
  float* spc = v + C;
  int* path = reinterpret_cast<int*>(spc + C);
  int* row4col = path + C;
  float* u = reinterpret_cast<float*>(row4col + C);
  int* col4row = reinterpret_cast<int*>(u + R);
  unsigned char* sc = reinterpret_cast<unsigned char*>(col4row + R);
  unsigned char* sr = sc + C;
  __shared__ float red_val[kThreads / 32];
  __shared__ int red_idx[kThreads / 32];
  __shared__ int s_j, s_i, s_sink;
  __shared__ float s_min;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* cp = cost + static_cast<int64_t>(blockIdx.x) * R * C;
  for (int j = tid; j < C; j += kThreads) {
    v[j] = 0.f;
    row4col[j] = -1;
  }
  for (int r = tid; r < R; r += kThreads) {
    u[r] = 0.f;
    col4row[r] = -1;
  }
  int n = R;
  if (num_valid != nullptr) n = min(num_valid[blockIdx.x], R);
  __syncthreads();

  for (int cur = 0; cur < n; ++cur) {
    for (int j = tid; j < C; j += kThreads) {
      spc[j] = kInf;
      path[j] = -1;
      sc[j] = 0;
    }
    for (int r = tid; r < R; r += kThreads) sr[r] = 0;
    __syncthreads();

    int i = cur;
    float min_val = 0.f;
    int sink = -1;
    while (sink < 0) {
      if (tid == 0) sr[i] = 1;
      const float ui = u[i];
      const float* row = cp + static_cast<int64_t>(i) * C;
      float best = INFINITY;
      int bj = C;
      for (int j = tid; j < C; j += kThreads) {
        float masked = kInf;
        if (!sc[j]) {
          const float reduced = min_val + clamp_cost(row[j]) - ui - v[j];
          if (reduced < spc[j]) {
            spc[j] = reduced;
            path[j] = i;
          }
          masked = spc[j];
        }
        if (masked < best) {  // j rises: ties keep the lower column
          best = masked;
          bj = j;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, best, off);
        const int oj = __shfl_down_sync(0xffffffffu, bj, off);
        if (ov < best || (ov == best && oj < bj)) {
          best = ov;
          bj = oj;
        }
      }
      if (lane == 0) {
        red_val[warp] = best;
        red_idx[warp] = bj;
      }
      __syncthreads();
      if (warp == 0) {
        best = lane < kThreads / 32 ? red_val[lane] : INFINITY;
        bj = lane < kThreads / 32 ? red_idx[lane] : C;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const float ov = __shfl_down_sync(0xffffffffu, best, off);
          const int oj = __shfl_down_sync(0xffffffffu, bj, off);
          if (ov < best || (ov == best && oj < bj)) {
            best = ov;
            bj = oj;
          }
        }
        if (lane == 0) {
          s_j = bj;
          s_min = best;
          sc[bj] = 1;
          const int r = row4col[bj];
          s_sink = r < 0 ? bj : -1;
          s_i = r < 0 ? i : r;
        }
      }
      __syncthreads();
      min_val = s_min;
      sink = s_sink;
      i = s_i;
    }

    // dual updates (the JAX op's order of operations)
    for (int r = tid; r < R; r += kThreads) {
      if (r == cur) {
        u[r] = u[r] + min_val;
      } else if (sr[r]) {
        const int j = col4row[r];
        u[r] = u[r] + min_val - (j >= 0 ? spc[j] : 0.f);
      }
    }
    for (int j = tid; j < C; j += kThreads) {
      if (sc[j]) v[j] = v[j] - (min_val - spc[j]);
    }
    __syncthreads();
    // augment along the predecessor chain
    if (tid == 0) {
      int j = sink;
      while (true) {
        const int r = path[j];
        row4col[j] = r;
        const int prev = col4row[r];
        col4row[r] = j;
        if (r == cur) break;
        j = prev;
      }
    }
    __syncthreads();
  }
  for (int r = tid; r < R; r += kThreads)
    col4row_out[static_cast<int64_t>(blockIdx.x) * R + r] = col4row[r];
}

// shared memory per column (v, spc, path, row4col, sc) and per row (u,
// col4row, sr)
constexpr size_t kColBytes = 2 * sizeof(float) + 2 * sizeof(int) + 1;
constexpr size_t kRowBytes = sizeof(float) + sizeof(int) + 1;

size_t smem_bytes(int R, int C) {
  return static_cast<size_t>(C) * kColBytes + static_cast<size_t>(R) * kRowBytes;
}

}  // namespace

extern "C" {

// Largest column count the kernel takes for R rows (its shared memory
// stays under the 48 KB a block gets without opting in).
int lsa_max_cols(int R) {
  const size_t rows = static_cast<size_t>(R) * kRowBytes;
  if (rows >= 48 * 1024) return 0;
  return static_cast<int>((48 * 1024 - rows) / kColBytes);
}

// cost: (problems, R, C) float32, R <= C; num_valid: (problems,) int32 or
// null (every row). Writes col4row (problems, R) int32, -1 for unsolved
// rows. Returns the cudaError_t of the launch (0 = success).
int lsa_solve(const void* cost, const void* num_valid, void* col4row,
              int problems, int R, int C, void* stream) {
  // empty work launches nothing; the caller skips it, so 0 means launched
  if (problems == 0 || R == 0 || R > C || C > lsa_max_cols(R))
    return static_cast<int>(cudaErrorInvalidValue);
  lsa_kernel<<<problems, kThreads, smem_bytes(R, C),
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cost), static_cast<const int*>(num_valid),
      static_cast<int*>(col4row), R, C);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
