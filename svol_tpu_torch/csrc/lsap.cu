// Batched exact linear sum assignment (Jonker-Volgenant shortest augmenting
// path, the algorithm scipy's linear_sum_assignment implements): W problems
// of (R, C) float32 costs, R <= C <= 32 -> (W, R) int32 col4row.
//
// Replaces the Pallas kernel svol_tpu/ops/hungarian.py::_solve_dense_pallas
// (body `_solve_dense_t`). On the TPU the whole batch rides the vector
// lanes and every per-problem index operation is dense one-hot arithmetic
// over the batch. On Hopper one warp owns one problem: lane c holds column
// c's state (dual v, shortest path length, predecessor row, row4col, the
// visited flag) and lane r the row state (dual u, col4row, visited); the
// cost matrix sits in shared memory, and each Dijkstra trip is one
// warp-shuffle argmin. Row lookups (u[i], row4col[j], path[j], col4row[i])
// are shuffles from a data-dependent lane; every loop condition is
// computed from shuffled values, so it is uniform across the warp.
//
// Exactness: the arithmetic is the JAX solver's, term for term and in the
// same order (reduced = ((min_val + cost[i]) - u[i]) - v; the dual updates
// likewise), in f32 with round-to-nearest adds and no contraction, and the
// argmin breaks ties towards the LOWEST column index, as jnp.argmin does:
// the assignments are the JAX solver's and scipy's. A NaN cost counts as
// the least value (jnp.argmin's rule), which also keeps the warp's
// reduction a total order.
//
// What bounds it on the H100: nothing the roofline sees. A step's two
// calls read W * R * C * 4 = 205 KB each (W = 512, 10 x 10) and do
// O(R * C * R) adds per problem; the time is the serial chain of ~R^2
// dependent shuffle reductions in one warp, i.e. latency, and 512 warps
// use a fraction of the card.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarps = 4;            // problems per block
constexpr int kMaxN = 32;            // columns per problem: one lane each
constexpr float kBig = 1e30f;        // the JAX solver's finite "infinity"
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarps * 32)
lsap_kernel(const float* __restrict__ cost, int* __restrict__ out, int W,
            int R, int C) {
  __shared__ float sc[kWarps][kMaxN * kMaxN];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int w = blockIdx.x * kWarps + warp;
  if (w >= W) return;  // the whole warp leaves together
  float* c = sc[warp];
  const float* src = cost + (size_t)w * R * C;
  for (int e = lane; e < R * C; e += 32) c[(e / C) * kMaxN + e % C] = src[e];
  __syncwarp();

  const bool col_lane = lane < C;
  const bool row_lane = lane < R;
  float v = 0.f;      // column dual (lane = column)
  int row4col = -1;
  float u = 0.f;      // row dual (lane = row)
  int col4row = -1;

  for (int cur = 0; cur < R; ++cur) {
    float shortest = kBig;
    int path = -1;
    bool vcol = false, vrow = false;
    int i = cur, sink = -1;
    float min_val = 0.f;
    // Dijkstra: each trip visits one new column; an unassigned one is met
    // within cur + 1 trips, so C trips always suffice
    for (int trip = 0; trip < C && sink < 0; ++trip) {
      if (lane == i) vrow = true;
      const float u_i = __shfl_sync(kFull, u, i);
      if (col_lane && !vcol) {
        const float reduced =
            __fsub_rn(__fsub_rn(__fadd_rn(min_val, c[i * kMaxN + lane]), u_i), v);
        if (reduced < shortest) {
          shortest = reduced;
          path = i;
        }
      }
      float best = col_lane ? (vcol ? kBig : shortest) : CUDART_INF_F;
      if (isnan(best)) best = -CUDART_INF_F;
      int bidx = lane;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(kFull, best, off);
        const int oi = __shfl_xor_sync(kFull, bidx, off);
        if (ob < best || (ob == best && oi < bidx)) {
          best = ob;
          bidx = oi;
        }
      }
      const int j = bidx;
      min_val = best;
      if (lane == j) vcol = true;
      const int r4c_j = __shfl_sync(kFull, row4col, j);
      if (r4c_j < 0) sink = j;
      else i = r4c_j;
    }

    // dual updates (scipy rectangular_lsap.cpp), before the augmentation
    // moves col4row: visited rows other than cur are assigned
    const float sh_c4r = __shfl_sync(kFull, shortest, col4row < 0 ? 0 : col4row);
    if (lane == cur) u = __fadd_rn(u, min_val);
    else if (row_lane && vrow) u = __fadd_rn(u, __fsub_rn(min_val, sh_c4r));
    if (col_lane && vcol) v = __fsub_rn(v, __fsub_rn(min_val, shortest));

    // augment along the alternating path back to cur (at most R edges)
    int j = sink;
    for (int trip = 0; trip < R && j >= 0; ++trip) {
      const int pi = __shfl_sync(kFull, path, j);
      if (lane == j) row4col = pi;
      const int nxt = __shfl_sync(kFull, col4row, pi < 0 ? 0 : pi);
      if (lane == pi) col4row = j;
      j = pi == cur ? -1 : nxt;
    }
  }
  if (row_lane) out[(size_t)w * R + lane] = col4row;
}

}  // namespace

extern "C" {

// cost: (W, R, C) float32, contiguous; out: (W, R) int32.
int svol_lsap(const void* cost, void* out, int W, int R, int C, void* stream) {
  if (W <= 0 || R <= 0 || R > C || C > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + kWarps - 1) / kWarps);
  lsap_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cost), static_cast<int*>(out), W, R, C);
  return static_cast<int>(cudaGetLastError());
}

const char* svol_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
