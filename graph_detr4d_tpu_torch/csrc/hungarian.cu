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
// What bounds it: latency. The Dijkstra steps of a problem are strictly
// sequential (each step's row is the previous step's argmin), so a
// problem takes (its steps) x (the latency of one step); the bytes, C
// floats a step, would take a fraction of a microsecond at the card's
// bandwidth. The design shortens the step and drops the per-row work:
//   * one block per problem, each thread owning K = 4 columns (t, t + T,
//     ...; 256 threads at C = 900),
//     whose v, path cost, predecessor, assigned row and that row's dual u
//     stay in registers (a row's u moves with its column). A scanned
//     column's path cost becomes NaN, which neither improves nor wins, so
//     a step costs ~13 instructions a column;
//   * one barrier a step: each warp reduces its (order-preserving float
//     key, column) with two redux.sync, its winning lane writes key,
//     column, assigned row, predecessor and u to a double-buffered slot,
//     and after the barrier every warp reduces the slots itself;
//   * no barrier a row: every thread knows each step's winner, so the
//     dual updates are done by the columns' owners in registers, and the
//     augmenting chain is walked by every thread from a log of the row's
//     steps in shared memory (column, predecessor, u and path cost of each
//     step, and the step that reached each row);
//   * the cost rows resident in shared memory: only rows 0..n-1 are read
//     (Dijkstra visits `cur` and rows already assigned), copied with
//     cp.async 8 rows ahead of `cur`, as many rows as the opt-in shared
//     memory holds (55 at C = 900); past that, a ring of 8 slots holds the
//     rows ahead, and revisited rows are read from L2.
// There is no host sync: num_valid is read on the device.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kSmemMax = 232448;   // opt-in shared memory of a block, sm_90
constexpr int kRedBytes = 2 * 32 * 16;  // the double-buffered warp slots
constexpr int K = 4;               // columns a thread
constexpr int kMaxThreads = 1024;
constexpr int kMaxCols = K * kMaxThreads;
constexpr int kAhead = 8;          // cost rows in flight ahead of `cur`
constexpr float kInf = 1e18f;      // the JAX op's _INF

__device__ __forceinline__ float clamp_cost(float c) {
  return fabsf(c) <= 3.402823466e38f ? c : (c == -INFINITY ? -100.f : 100.f);
}

// Order-preserving map of a float onto uint32 (no path cost is ever -0:
// the reduced costs start from +0).
__device__ __forceinline__ unsigned key_of(float f) {
  const unsigned b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}
__device__ __forceinline__ float float_of(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// Copy this thread's columns of a cost row into shared memory, as one
// cp.async group (an empty group where `copy` is false, so that every row
// commits one and the wait below counts rows).
__device__ __forceinline__ void prefetch_row(float* dst, const float* src,
                                             bool copy, int tid, int T, int C) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = tid + k * T;
    if (copy && j < C) {
      const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst + j));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                   "l"(src + j));
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void __launch_bounds__(kMaxThreads, 1)
lsa_kernel(const float* __restrict__ cost, const int* __restrict__ num_valid,
           int* __restrict__ col4row_out, int R, int C, int cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, T = blockDim.x, Cp = K * T;
  int4* red = reinterpret_cast<int4*>(smem);                  // [2][32]
  float* rows = reinterpret_cast<float*>(smem + kRedBytes);   // [cap][Cp]
  // the log of a row's Dijkstra steps (at most R + 1)
  int* log_col = reinterpret_cast<int*>(rows + static_cast<size_t>(cap) * Cp);
  int* log_path = log_col + R + 1;  // the column's predecessor row
  float* log_u = reinterpret_cast<float*>(log_path + R + 1);  // its row's u
  float* log_min = log_u + R + 1;   // its path cost
  int* row_step = reinterpret_cast<int*>(log_min + R + 1);    // [R]

  const int lane = tid & 31, warp = tid >> 5, nwarps = T >> 5;
  const float* cp = cost + static_cast<int64_t>(blockIdx.x) * R * C;
  int n = R;
  if (num_valid != nullptr) n = min(num_valid[blockIdx.x], R);
  // rows 0..nres-1 stay resident; past that, when n exceeds the
  // capacity, the last kAhead slots are a ring for the rows cur..cur+7
  const int nres = n <= cap ? n : cap - kAhead;
  auto slot = [&](int r) {
    return rows + static_cast<size_t>(r < nres ? r : nres + (r - nres) % kAhead) * Cp;
  };
  // the thread owning column j, and its slot k: j = thread + k * T
  auto owner = [&](int j, int& k) {
    int t = j;
    k = 0;
#pragma unroll
    for (int q = 1; q < K; ++q) {
      if (t >= T) {
        t -= T;
        k = q;
      }
    }
    return t;
  };

  float v[K], ur[K];
  int r4c[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    v[k] = 0.f;
    ur[k] = 0.f;
    r4c[k] = -1;
  }
#pragma unroll 1
  for (int r = 0; r < kAhead - 1; ++r)
    prefetch_row(slot(r), cp + static_cast<int64_t>(r) * C, r < n, tid, T, C);

  int parity = 0;
  for (int cur = 0; cur < n; ++cur) {
    // row cur + 7 goes to the ring slot row cur - 1 has left
    const int ahead = cur + kAhead - 1;
    prefetch_row(slot(ahead), cp + static_cast<int64_t>(ahead) * C,
                    ahead < n, tid, T, C);
    cp_async_wait<kAhead - 1>();  // row cur has landed (this thread's columns)
    // spc: path costs, NaN for a scanned or padding column; ss: a scanned
    // column's path cost
    float spc[K], ss[K];
    int path[K];
    unsigned sc = 0;  // scanned bits of this thread's columns
#pragma unroll
    for (int k = 0; k < K; ++k) {
      spc[k] = tid + k * T < C ? kInf : __int_as_float(0x7fffffff);
      ss[k] = 0.f;
      path[k] = -1;
    }
    // u[cur] is 0 here: a row's dual changes only once it is scanned
    int i = cur, step = 0, sink, sink_path;
    float ui = 0.f, min_val = 0.f;
    const float* cur_row = slot(cur) + tid;
    while (true) {
      float c[K];
      if (i == cur || i < nres) {  // in the ring, or resident
        const float* src = i == cur ? cur_row : rows + static_cast<size_t>(i) * Cp + tid;
#pragma unroll
        for (int k = 0; k < K; ++k) c[k] = src[k * T];
      } else {
        const float* src = cp + static_cast<int64_t>(i) * C + tid;
#pragma unroll
        for (int k = 0; k < K; ++k)
          c[k] = tid + k * T < C ? __ldg(src + k * T) : 0.f;
      }
      float best = INFINITY;
      int bk = 0;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float reduced = min_val + clamp_cost(c[k]) - ui - v[k];
        const bool better = reduced < spc[k];  // false against NaN
        spc[k] = better ? reduced : spc[k];
        path[k] = better ? i : path[k];
        const bool wins = spc[k] < best;  // k rises: ties keep the lower column
        best = wins ? spc[k] : best;
        bk = wins ? k : bk;
      }
      // the warp's least key, ties to the least column
      const unsigned key = key_of(best);
      const unsigned bcol = tid + bk * T;
      const unsigned wkey = __reduce_min_sync(0xffffffffu, key);
      const unsigned wcol =
          __reduce_min_sync(0xffffffffu, key == wkey ? bcol : 0xffffffffu);
      if (bcol == wcol) {
        int brow = r4c[0], bpath = path[0];
        float bu = ur[0];
#pragma unroll
        for (int k = 1; k < K; ++k) {
          brow = bk == k ? r4c[k] : brow;
          bpath = bk == k ? path[k] : bpath;
          bu = bk == k ? ur[k] : bu;
        }
        // rows fit 16 bits (R <= kMaxCols), offset by 1 for -1
        red[parity * 32 + warp] = make_int4(
            static_cast<int>(wkey), static_cast<int>(bcol),
            (brow + 1) | ((bpath + 1) << 16), __float_as_int(bu));
      }
      __syncthreads();
      // every warp reduces the warps' slots the same way
      const int4 e = lane < nwarps ? red[parity * 32 + lane]
                                   : make_int4(-1, -1, 0, 0);
      parity ^= 1;
      const unsigned ekey = static_cast<unsigned>(e.x), ecol = static_cast<unsigned>(e.y);
      const unsigned gkey = __reduce_min_sync(0xffffffffu, ekey);
      const unsigned gcol = __reduce_min_sync(
          0xffffffffu, ekey == gkey ? ecol : 0xffffffffu);
      const int src = __ffs(__ballot_sync(0xffffffffu, ecol == gcol)) - 1;
      const int j = static_cast<int>(gcol);
      const int rows_of = __shfl_sync(0xffffffffu, e.z, src);
      const float unext = __int_as_float(__shfl_sync(0xffffffffu, e.w, src));
      const int next = (rows_of & 0xffff) - 1, pred = (rows_of >> 16) - 1;
      min_val = float_of(gkey);
      int kj;
      if (tid == owner(j, kj)) {  // the winner is scanned
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (k == kj) {
            sc |= 1u << k;
            ss[k] = spc[k];
            spc[k] = __int_as_float(0x7fffffff);
          }
        }
      }
      if (next < 0) {
        sink = j;
        sink_path = pred;
        break;
      }
      if (tid == 0) {
        log_col[step] = j;
        log_path[step] = pred;
        log_u[step] = unext;
        log_min[step] = min_val;
        row_step[next] = step;
      }
      ++step;
      i = next;
      ui = unext;
    }

    // dual updates (the JAX op's order of operations), by the owners of
    // the scanned columns: v, and the u of a scanned row other than cur,
    // which is the row of a scanned column
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if ((sc >> k) & 1u) {
        v[k] = v[k] - (min_val - ss[k]);
        if (r4c[k] >= 0) ur[k] = ur[k] + min_val - ss[k];
      }
    }
    // augment along the predecessor chain: each of its columns takes its
    // predecessor row, whose updated u follows from the step that reached
    // it (u[cur] = 0 + min_val). Every thread walks the chain from the log.
    int jj = sink, pp = sink_path;
    while (true) {
      int t = 0;
      float unew = 0.f + min_val;
      if (pp != cur) {
        t = row_step[pp];
        unew = log_u[t] + min_val - log_min[t];
      }
      int kj;
      if (tid == owner(jj, kj)) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (k == kj) {
            r4c[k] = pp;
            ur[k] = unew;
          }
        }
      }
      if (pp == cur) break;
      jj = log_col[t];
      pp = log_path[t];
    }
  }
  cp_async_wait<0>();
  for (int r = max(n, 0) + tid; r < R; r += T)
    col4row_out[static_cast<int64_t>(blockIdx.x) * R + r] = -1;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (r4c[k] >= 0)
      col4row_out[static_cast<int64_t>(blockIdx.x) * R + r4c[k]] = tid + k * T;
}

// shared memory besides the cost rows: the warp slots and the step log
size_t fixed_bytes(int R) {
  return kRedBytes + static_cast<size_t>(R + 1) * 16 + static_cast<size_t>(R) * 4;
}

// max_rows: cost rows kept in shared memory, 0 for as many as fit (the
// card tests set a few, to drive the ring at small sizes)
cudaError_t launch(const float* cost, const int* nv, int* out, int P, int R,
                   int C, int max_rows, cudaStream_t stream) {
  const int T = ((C + K - 1) / K + 31) / 32 * 32;
  const size_t row_bytes = static_cast<size_t>(K) * T * 4;
  const size_t fixed = fixed_bytes(R);
  // row slots: as many as fit, or fewer where asked, never fewer than the
  // ring's kAhead (lsa_max_cols leaves room for them)
  size_t cap = std::min<size_t>(R, (kSmemMax - fixed) / row_bytes);
  if (max_rows > 0) cap = std::min<size_t>(cap, std::max(max_rows, kAhead));
  if (cap < static_cast<size_t>(std::min(R, kAhead)))
    return cudaErrorInvalidValue;
  const size_t bytes = fixed + cap * row_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      lsa_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  lsa_kernel<<<P, T, bytes, stream>>>(cost, nv, out, R, C,
                                      static_cast<int>(cap));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest column count the kernel takes for R rows: K columns for each of
// at most 1024 threads, and the step log beside the ring's 8 rows within
// the opt-in shared memory.
int lsa_max_cols(int R) {
  if (fixed_bytes(R) + static_cast<size_t>(kAhead) * kMaxCols * 4 >
      static_cast<size_t>(kSmemMax))
    return 0;
  return kMaxCols;
}

// cost: (problems, R, C) float32, R <= C; num_valid: (problems,) int32 or
// null (every row). Writes col4row (problems, R) int32, -1 for unsolved
// rows. max_rows: cost rows kept in shared memory, 0 for as many as fit
// (a test hook). Returns the cudaError_t of the launch (0 = success).
int lsa_solve(const void* cost, const void* num_valid, void* col4row,
              int problems, int R, int C, int max_rows, void* stream) {
  // empty work launches nothing; the caller skips it, so 0 means launched
  if (problems == 0 || R == 0 || R > C || C > lsa_max_cols(R))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch(
      static_cast<const float*>(cost), static_cast<const int*>(num_valid),
      static_cast<int*>(col4row), problems, R, C, max_rows,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
