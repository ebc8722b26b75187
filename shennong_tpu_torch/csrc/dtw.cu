// DTW divergences normalized by the realized path length, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the recursion of shennong_tpu/eval/abx.py:65, dtw_divergences,
// which is a lax.scan over rows with a lax.associative_scan inside each
// row, not a Pallas kernel. The wrapper is dtw_divergences in
// shennong_tpu_torch/ops/dtw.py.
//
// For each pair b, with n = nx[b] in [1, Ta], m = ny[b] in [1, Tb] (the
// wrapper checks both) and c = costs[b] ([Ta, Tb] row-major), over cells
// i < n, j < m:
//   D[0, 0] = (c[0, 0], 1)
//   D[i, j] = (c[i, j] + best.cost, best.len + 1), best the lexicographic
//             (cost, length) minimum of D[i-1, j], D[i-1, j-1], D[i, j-1]
//             (the ones that exist)
//   div[b]  = D[n-1, m-1].cost / D[n-1, m-1].len
// Adding (c, 1) keeps the lexicographic order, so this is the JAX
// package's minimum over all paths with ties in cost to the shortest.
// Cells past (n, m) are never read.
//
// Rounding: one __fadd_rn per cell, __fdiv_rn at the end, and the file is
// built with -fmad=false. The plain version sums each row with cumsum and
// subtracts, so on real-valued costs the two differ by ulps; on
// integer-valued costs every sum is exact and they are equal.
//
// What bounds it: the bytes of costs, read once (4 bytes a valid cell),
// beside a chain of n + m - 1 dependent anti-diagonal steps per pair
// (about 4 operations a cell: one add, two lexicographic compares, one
// length add). At the ABX benchmark's [4096, 24, 24] the bytes take
// 2.8 us of HBM time; one pair's chain of 47 steps is a few microseconds
// of latency. The design hides that latency behind the other pairs:
// one warp per pair and four pairs a block, so the whole batch is
// resident at once; each lane owns one row of a 32-row strip and walks
// the anti-diagonals, taking the cell above from its left neighbour lane
// by __shfl_up_sync (the diagonal is the previous step's cell above, the
// cell to the left its own previous cell), so a step costs one shuffle,
// two compares and an add, and touches no shared memory. The next
// step's cost is loaded one step ahead. Pairs with more than 32 rows run
// the strips in turn; the last row of a strip reaches the next strip's
// lane 0 through a scratch row in device memory (two rows a pair,
// alternating), so no on-chip storage grows with Tb.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool lex_less(float cost_a, int len_a,
                                         float cost_b, int len_b) {
  return cost_a < cost_b || (cost_a == cost_b && len_a < len_b);
}

__global__ void dtw_kernel(const float* __restrict__ costs,
                           const int32_t* __restrict__ nx,
                           const int32_t* __restrict__ ny, int B, int Ta,
                           int Tb, float* __restrict__ edge_cost,
                           int32_t* __restrict__ edge_len,
                           float* __restrict__ div) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int b = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (b >= B) return;  // the whole warp leaves together
  const int n = nx[b];
  const int m = ny[b];
  const float* c = costs + static_cast<size_t>(b) * Ta * Tb;
  const float inf = CUDART_INF_F;

  for (int s = 0; s * kWarp < n; ++s) {
    const int i = s * kWarp + lane;
    const int rows = min(kWarp, n - s * kWarp);
    const bool active = lane < rows;
    const bool pass_on = n > (s + 1) * kWarp;  // a next strip exists
    const float* row = c + static_cast<size_t>(i) * Tb;
    // strip s reads the row strip s-1 wrote and writes the other one
    const size_t edge = static_cast<size_t>(b) * 2 * Tb;
    const float* above_cost = edge_cost + edge + ((s + 1) & 1) * Tb;
    const int32_t* above_len = edge_len + edge + ((s + 1) & 1) * Tb;
    float* below_cost = edge_cost + edge + (s & 1) * Tb;
    int32_t* below_len = edge_len + edge + (s & 1) * Tb;
    const bool from_edge = lane == 0 && s > 0;

    // this lane's cell at the previous step (the cell to the left), and
    // the cell above at the previous step (the diagonal)
    float left_cost = inf, diag_cost = inf;
    int left_len = 0, diag_len = 0;
    // operands of the first step, then always one step ahead
    float next_c = (active && lane == 0) ? row[0] : 0.f;
    float next_up_cost = from_edge ? above_cost[0] : inf;
    int next_up_len = from_edge ? above_len[0] : 0;

    const int steps = m + rows - 1;
    for (int t = 0; t < steps; ++t) {
      const int j = t - lane;
      const bool live = active && j >= 0 && j < m;
      const float cij = next_c;
      float up_cost = __shfl_up_sync(kFull, left_cost, 1);
      int up_len = __shfl_up_sync(kFull, left_len, 1);
      if (lane == 0) {
        up_cost = next_up_cost;
        up_len = next_up_len;
      }
      const int jn = j + 1;
      if (active && jn >= 0 && jn < m) next_c = row[jn];
      if (from_edge && jn < m) {
        next_up_cost = above_cost[jn];
        next_up_len = above_len[jn];
      }
      if (live) {
        if (j == 0) {
          diag_cost = inf;
          left_cost = inf;
        }
        float best_cost = up_cost;
        int best_len = up_len;
        if (lex_less(diag_cost, diag_len, best_cost, best_len)) {
          best_cost = diag_cost;
          best_len = diag_len;
        }
        if (lex_less(left_cost, left_len, best_cost, best_len)) {
          best_cost = left_cost;
          best_len = left_len;
        }
        float cost = cij;
        int len = 1;
        if (i > 0 || j > 0) {
          cost = __fadd_rn(cij, best_cost);
          len = best_len + 1;
        }
        left_cost = cost;
        left_len = len;
        if (pass_on && lane == kWarp - 1) {
          below_cost[j] = cost;
          below_len[j] = len;
        }
        if (i == n - 1 && j == m - 1) {
          div[b] = __fdiv_rn(cost, static_cast<float>(len));
        }
      }
      diag_cost = up_cost;
      diag_len = up_len;
    }
    // the strip's last row is written before the next strip reads it
    __syncwarp();
  }
}

}  // namespace

extern "C" {

// costs [B, Ta, Tb] float32, nx, ny [B] int32 -> div [B] float32;
// edge_cost [B, 2, Tb] float32 and edge_len [B, 2, Tb] int32 are scratch,
// read only when Ta > 32. Launches on `stream`; returns the CUDA error
// code of the launch.
int shennong_dtw(const float* costs, const int32_t* nx, const int32_t* ny,
                 int B, int Ta, int Tb, float* edge_cost, int32_t* edge_len,
                 float* div, void* stream) {
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  dtw_kernel<<<blocks, kWarpsPerBlock * kWarp, 0,
               static_cast<cudaStream_t>(stream)>>>(
      costs, nx, ny, B, Ta, Tb, edge_cost, edge_len, div);
  return static_cast<int>(cudaGetLastError());
}

const char* shennong_dtw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
