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
// integer-valued costs every sum is exact and they are equal. D is
// symmetric in the roles of i and j, so walking the transposed matrix
// gives the same bits.
//
// What bounds it: the bytes of costs, read once (4 bytes a valid cell),
// take 2.8 us of HBM time at the ABX benchmark's [4096, 24, 24]; beside
// them, each pair is a chain of n + m - 1 dependent anti-diagonal steps,
// and a step is about 20 instructions a lane, most of them compares,
// selects and minima that issue at half rate. Only n of the lanes hold
// rows and the wavefront fills and drains, so 38% of the lane-steps of a
// 24 x 24 pair do work. The design (dtw_kernel_staged):
// - a warp stages its pair's valid rows into shared memory with coalesced
//   16-byte cp.async copies (cell by cell where rows are not whole 16-byte
//   units) and walks the anti-diagonals there, so no step loads from
//   device memory;
// - the warp walks the smaller side on its lanes (the transposed matrix
//   when Tb < Ta); a row's cost sits s - 1 words from the next lane's with
//   an even row stride s, which puts the lanes of a step on distinct banks;
// - a step takes the cell above with one shuffle of (cost, length); with
//   fewer than 32 rows lane 0 takes it from lane 31, which holds no row
//   and keeps (inf, 0), so the top row needs no select;
// - the lexicographic minimum of the three cells is the least cost (two
//   fminf), then the least length among the cells of that cost, and a cell
//   outside the pair is computed and dropped by selects, so a step has no
//   branch; the pair's last cell is read after the walk;
// - the grid is persistent: a warp takes every total-warps-th group of
//   pairs and copies the next group into its second buffer while it
//   walks the current one.
// A lane may hold R consecutive rows, skewed by one column each, and the
// lanes then split into segments of a power of two, one pair a segment
// (each pair's block an odd number of words long, so the segments do not
// collide on banks): 2 to 4 rows a lane are variants, slower at 24 x 24
// than one (PERF.md). Pairs whose smaller side needs more than 32 lanes at
// 4 rows a lane, or whose staged block outgrows shared memory, walk strips
// of 32 rows from device memory (dtw_kernel_strip, the first design): the
// last row of a strip reaches the next strip's lane 0 through a scratch
// row in device memory.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxRowsPerLane = 4;
// a length no path reaches (the candidates of another cost take it)
constexpr int kNoLength = 1 << 30;
// shared memory of a staged block, small enough for two blocks an SM
constexpr size_t kStagedSmem = 96 * 1024;
// the rows a lane of the staged kernel holds by default: one, so that a
// warp holds one pair (fastest at the ABX benchmark's 24 x 24 pairs)
constexpr int kDefaultRowsPerLane = 1;

__device__ __forceinline__ bool lex_less(float cost_a, int len_a,
                                         float cost_b, int len_b) {
  return cost_a < cost_b || (cost_a == cost_b && len_a < len_b);
}

__device__ __forceinline__ uint32_t smem_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void copy_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_address(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_address(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit_async() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The staged plan of a launch: a lane holds R rows of the walked side,
// a segment of `seg` lanes holds a pair, a pair's block in shared memory
// is `words` floats (rows of `stride`), a block has `warps` warps.
struct Plan {
  int R, flip, seg, stride, words, warps;
  size_t smem;
};

// Copies the valid cells of a warp's pairs of group g into buf: the first
// n rows whole, in 16-byte chunks, when the warp holds one pair whose rows
// are whole chunks (the block then keeps the rows' layout); else the n x m
// cells one by one.
__device__ __forceinline__ void stage(const float* __restrict__ costs,
                                      const int32_t* __restrict__ nx,
                                      const int32_t* __restrict__ ny, int B,
                                      int Ta, int Tb, int g, int per_warp,
                                      int stride, int words, bool chunks16,
                                      float* buf, int lane) {
  if (chunks16) {
    const float4* src = reinterpret_cast<const float4*>(
        costs + static_cast<size_t>(g) * Ta * Tb);
    float4* dst = reinterpret_cast<float4*>(buf);
    const int chunks = nx[g] * Tb / 4;
    for (int c = lane; c < chunks; c += kWarp) copy_async16(dst + c, src + c);
    commit_async();
    return;
  }
  for (int p = 0; p < per_warp; ++p) {
    const int pair = g * per_warp + p;
    if (pair >= B) break;
    const int n = nx[pair];
    const int m = ny[pair];
    const float* src = costs + static_cast<size_t>(pair) * Ta * Tb;
    float* dst = buf + p * words;
    // element e = lane + 32 q of the pair's n x m cells, row-major
    int i = lane / m, j = lane - (lane / m) * m;
    for (int e = lane; e < n * m; e += kWarp) {
      copy_async4(dst + i * stride + j, src + i * Tb + j);
      j += kWarp;
      while (j >= m) {
        j -= m;
        ++i;
      }
    }
  }
  commit_async();
}

// kIdleTop: one pair a warp with fewer than 32 rows on its lanes, so lane
// 31 never holds a row and its cell stays (inf, 0): lane 0 reads the cell
// above its row from there, with no select.
template <int R, bool kIdleTop>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
    dtw_kernel_staged(const float* __restrict__ costs,
                      const int32_t* __restrict__ nx,
                      const int32_t* __restrict__ ny, int B, int Ta, int Tb,
                      int flip, int seg, int stride, int words,
                      int chunks16, float* __restrict__ div) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int per_warp = kWarp / seg;
  const int groups = (B + per_warp - 1) / per_warp;
  const int total = gridDim.x * (blockDim.x / kWarp);
  int g = blockIdx.x * (blockDim.x / kWarp) + warp;
  if (g >= groups) return;  // the whole warp leaves together
  float* mine = smem + static_cast<size_t>(warp) * 2 * per_warp * words;
  const int sigma = lane / seg;  // this lane's pair in the group
  const int l = lane - sigma * seg;
  // the walked matrix: rows on lanes; (i, j) at i * row_step + j * col_step
  const int row_step = flip ? 1 : stride;
  const int col_step = flip ? stride : 1;
  const float inf = CUDART_INF_F;

  stage(costs, nx, ny, B, Ta, Tb, g, per_warp, stride, words, chunks16, mine,
        lane);
  for (int k = 0; g < groups; g += total, ++k) {
    const int next = g + total;
    if (next < groups) {
      stage(costs, nx, ny, B, Ta, Tb, next, per_warp, stride, words, chunks16,
            mine + ((k + 1) & 1) * per_warp * words, lane);
      wait_async<1>();
    } else {
      wait_async<0>();
    }
    __syncwarp();

    const int pair = g * per_warp + sigma;
    const bool has = pair < B;
    const int n = has ? nx[pair] : 0;
    const int m = has ? ny[pair] : 0;
    const int rows = flip ? m : n;
    const int cols = flip ? n : m;
    const float* c = mine + (k & 1) * per_warp * words + sigma * words;
    float left_cost[R], diag_cost[R];
    int left_len[R], diag_len[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      left_cost[r] = inf;
      diag_cost[r] = inf;
      left_len[r] = 0;
      diag_len[r] = 0;
    }
    // step 0 is the cell (0, 0) alone: D = (c[0, 0], 1)
    if (l == 0 && has) {
      left_cost[0] = c[0];
      left_len[0] = 1;
    }
    const int steps = has ? rows + cols - 1 : 0;
    const int warp_steps =
        static_cast<int>(__reduce_max_sync(kFull, static_cast<unsigned>(steps)));
    // row r is live at steps [first[r], first[r] + span[r])
    int first[R], span[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      first[r] = R * l + r;
      span[r] = first[r] < rows ? cols : 0;
    }
    for (int t = 1; t < warp_steps; ++t) {
      float up_cost;
      int up_len;
      if constexpr (kIdleTop) {
        const int above = (lane + kWarp - 1) & (kWarp - 1);
        up_cost = __shfl_sync(kFull, left_cost[R - 1], above);
        up_len = __shfl_sync(kFull, left_len[R - 1], above);
      } else {
        up_cost = __shfl_up_sync(kFull, left_cost[R - 1], 1, seg);
        up_len = __shfl_up_sync(kFull, left_len[R - 1], 1, seg);
        if (l == 0) {  // above the top row
          up_cost = inf;
          up_len = 0;
        }
      }
      // rows in descending order: row r reads row r - 1's previous cell.
      // Every cell is computed and kept only where it lies in the pair
      // (selects, no branch), from an address that stays in the block.
#pragma unroll
      for (int r = R - 1; r >= 0; --r) {
        const float above_cost = r == 0 ? up_cost : left_cost[r > 0 ? r - 1 : 0];
        const int above_len = r == 0 ? up_len : left_len[r > 0 ? r - 1 : 0];
        const int i = first[r];
        const int j = t - i;
        const bool live =
            static_cast<unsigned>(j) < static_cast<unsigned>(span[r]);
        // the lexicographic (cost, length) minimum: the least cost, then
        // the least length among the cells of that cost
        const float best_cost =
            fminf(fminf(above_cost, diag_cost[r]), left_cost[r]);
        const int best_len =
            min(min(above_cost == best_cost ? above_len : kNoLength,
                    diag_cost[r] == best_cost ? diag_len[r] : kNoLength),
                left_cost[r] == best_cost ? left_len[r] : kNoLength);
        const float cost =
            __fadd_rn(c[live ? i * row_step + j * col_step : 0], best_cost);
        left_cost[r] = live ? cost : left_cost[r];
        left_len[r] = live ? best_len + 1 : left_len[r];
        diag_cost[r] = above_cost;
        diag_len[r] = above_len;
      }
    }
    // the last row's last cell is its final left cell
    const int last = rows - 1 - R * l;
    if (has && last >= 0 && last < R) {
      float cost = left_cost[0];
      int len = left_len[0];
#pragma unroll
      for (int r = 1; r < R; ++r) {
        if (r == last) {
          cost = left_cost[r];
          len = left_len[r];
        }
      }
      div[pair] = __fdiv_rn(cost, static_cast<float>(len));
    }
    // the buffer is walked before the next group's copies land in it
    __syncwarp();
  }
}

__global__ void dtw_kernel_strip(const float* __restrict__ costs,
                                 const int32_t* __restrict__ nx,
                                 const int32_t* __restrict__ ny, int B,
                                 int Ta, int Tb, float* __restrict__ edge_cost,
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

using Staged = void (*)(const float*, const int32_t*, const int32_t*, int,
                        int, int, int, int, int, int, int, float*);

Staged staged(int R, bool idle_top) {
  switch (R) {
    case 1: return idle_top ? dtw_kernel_staged<1, true>
                            : dtw_kernel_staged<1, false>;
    case 2: return dtw_kernel_staged<2, false>;
    case 3: return dtw_kernel_staged<3, false>;
    case 4: return dtw_kernel_staged<4, false>;
  }
  return nullptr;
}

// The staged plan for [Ta, Tb] pairs with R rows a lane (0: the
// default); false when the pairs take the strip kernel.
bool plan(int Ta, int Tb, int R, Plan* out) {
  const int flip = Tb < Ta;
  const int walked = flip ? Tb : Ta;
  const int fewest = (walked + kWarp - 1) / kWarp;
  if (fewest > kMaxRowsPerLane) return false;
  if (R == 0) R = kDefaultRowsPerLane < walked ? kDefaultRowsPerLane : walked;
  if (R < fewest) R = fewest;
  if (R > kMaxRowsPerLane) return false;
  int seg = 1;
  while (seg * R < walked) seg *= 2;
  const int stride = Tb + (Tb & 1);       // even: lanes on distinct banks
  // odd when a warp holds several pairs: segments on distinct banks
  const int words = Ta * stride + (seg < kWarp ? 1 : 0);
  const size_t warp_bytes = 2 * static_cast<size_t>(kWarp / seg) * words * 4;
  int warps = static_cast<int>(kStagedSmem / warp_bytes);
  if (warps < 1) return false;
  if (warps > kWarpsPerBlock) warps = kWarpsPerBlock;
  *out = {R, flip, seg, stride, words, warps, warps * warp_bytes};
  return true;
}

}  // namespace

extern "C" {

// The rows a lane holds for [Ta, Tb] pairs with R requested (0: the
// default), or 0 when they take the strip kernel, which needs the edge
// scratch.
int shennong_dtw_rows_per_lane(int Ta, int Tb, int R) {
  Plan p;
  return plan(Ta, Tb, R, &p) ? p.R : 0;
}

// costs [B, Ta, Tb] float32, nx, ny [B] int32 -> div [B] float32, with R
// rows a lane (0: the default). edge_cost [B, 2, Tb] float32 and edge_len
// [B, 2, Tb] int32 are scratch, read only by the strip kernel
// (shennong_dtw_rows_per_lane gives 0). Launches on `stream`; returns the
// CUDA error code of the launch.
int shennong_dtw(const float* costs, const int32_t* nx, const int32_t* ny,
                 int B, int Ta, int Tb, int R, float* edge_cost,
                 int32_t* edge_len, float* div, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Plan p;
  if (!plan(Ta, Tb, R, &p)) {
    if (!edge_cost || !edge_len) return static_cast<int>(cudaErrorInvalidValue);
    const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
    dtw_kernel_strip<<<blocks, kWarpsPerBlock * kWarp, 0, s>>>(
        costs, nx, ny, B, Ta, Tb, edge_cost, edge_len, div);
    return static_cast<int>(cudaGetLastError());
  }
  const int walked = p.flip ? Tb : Ta;
  Staged kernel = staged(p.R, p.R == 1 && p.seg == kWarp && walked < kWarp);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(p.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // persistent: no more blocks than the card holds at once
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, p.warps * kWarp, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = (B + kWarp / p.seg - 1) / (kWarp / p.seg);
  int blocks = (groups + p.warps - 1) / p.warps;
  const int resident = sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > resident) blocks = resident;
  // whole rows in 16-byte chunks: one pair a warp, rows of whole chunks
  const int chunks16 = p.seg == kWarp && Tb % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(costs) % 16 == 0;
  kernel<<<blocks, p.warps * kWarp, p.smem, s>>>(
      costs, nx, ny, B, Ta, Tb, p.flip, p.seg, p.stride, p.words, chunks16,
      div);
  return static_cast<int>(cudaGetLastError());
}

const char* shennong_dtw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
